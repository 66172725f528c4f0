"""ssd_decay_ms.granite: Host ms per request (Granite 4.0-H's Mamba-2 mixer
core) in the port's ``mamba.decay`` span: the softplus step, A·dt, the
causal prefix sums and the per-Δ decay exp(Σ A·dt) (exp_scaled). The card is
not synchronized at the span's edges, so the span holds the host's dispatch
time and the waits inside it."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_per_request(run, "mamba.decay")
