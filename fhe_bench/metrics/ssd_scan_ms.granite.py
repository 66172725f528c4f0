"""ssd_scan_ms.granite: Host ms per request (Granite 4.0-H's Mamba-2 mixer
core) in the port's ``mamba.scan`` span: the SSD sum: dt⊙x and B gathered
per Δ, C·B folded over the state, the products with the decays, the sum over
Δ and the D skip. The card is not synchronized at the span's edges, so the
span holds the host's dispatch time and the waits inside it."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_per_request(run, "mamba.scan")
