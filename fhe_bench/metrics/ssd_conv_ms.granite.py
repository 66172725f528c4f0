"""ssd_conv_ms.granite: Host ms per request (Granite 4.0-H's Mamba-2 mixer
core) in the port's ``mamba.conv`` span: the causal depthwise conv over
tokens (its three shifted taps gathered with masks) and the SiLU of xBC. The
card is not synchronized at the span's edges, so the span holds the host's
dispatch time and the waits inside it."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_per_request(run, "mamba.conv")
