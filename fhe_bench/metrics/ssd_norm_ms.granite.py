"""ssd_norm_ms.granite: Host ms per request (Granite 4.0-H's Mamba-2 mixer
core) in the port's ``mamba.gate_norm`` span: the SiLU gate and the gated
RMSNorm over 4096 (its Newton rsqrt and the refresh before it). The card is
not synchronized at the span's edges, so the span holds the host's dispatch
time and the waits inside it."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_per_request(run, "mamba.gate_norm")
