"""NTT kernel wrappers: the Hopper counterpart of ``fhe_gpt2_tpu/core/tntt.py``,
and the thread-block-cluster geometry that every kernel of ``csrc/`` shares.

The TPU package runs a four-step NTT as a Pallas kernel (``_fwd_kernel``,
``_inv_kernel``) shaped by the TPU's (R, 128) lane tiling. On the card the
same transform is ``csrc/ntt.cu``: one launch per transform, one
thread-block cluster of C CTAs per (batch, limb) row holding the row in the
cluster's shared memory (``csrc/ntt_cluster.cuh``), which runs the radix-2
network of ``ntt._ntt_stages``/``_intt_stages`` with the port's
``roots``/``inv_roots`` tables, so its output order is the plain version's
by construction. It covers N = 2^11 ... 2^16 and any row count.
``cluster_for`` picks C; ``cluster=`` forces it. The operand may be the limbs
[a, a+L) of a contiguous [..., L', N] tensor, read in place
(``lead_stride``); the output is a new contiguous [..., L, N].

Route: by word first, then by device. An int64 tensor (the u64 engine,
which has no kernel, as the JAX package's has no Pallas path) runs the
plain stage loop on any device; an int32 CUDA tensor launches the kernel
(or the wrapper raises); an int32 CPU tensor runs the plain stage loop.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ntt import NttTables, _intt_stages, _ntt_stages


# ---------------------------------------------------------------------------
# Cluster geometry (the NTT, key-switch and mod-down kernels)
# ---------------------------------------------------------------------------

MAX_CLUSTER = 8            # portable thread-block cluster size
CLUSTER_THREADS = 512      # most threads per CTA (the kernels' launch bound)
CLUSTER_WORDS = 16         # most words per thread: the key switch keeps two
                           # accumulators and the digit's words in registers


def cluster_sizes(logn: int) -> tuple[int, ...]:
    """The cluster sizes C the kernels take at N = 2^logn: powers of two
    up to 8 whose N/C words fit CLUSTER_THREADS threads of at most
    CLUSTER_WORDS words each (and so at most 32 KB of shared memory)."""
    if not 2 <= logn <= 16:
        raise ValueError(f"the cluster kernels cover logN 2..16, not {logn}")
    n = 1 << logn
    return tuple(c for c in (1, 2, 4, MAX_CLUSTER)
                 if 4 <= n // c <= CLUSTER_THREADS * CLUSTER_WORDS)


def cluster_threads(logn: int, c: int) -> int:
    """Threads per CTA for N/C words: CLUSTER_THREADS, or N/(2C) (two words
    per thread) for small limbs; N/C is always a multiple of it."""
    return min(CLUSTER_THREADS, ((1 << logn) // c) // 2)


def ctas_per_sm(words: int) -> int:
    """CTAs of a cluster kernel that one SM holds at `words` words per
    thread: the minimum of their ``__launch_bounds__``, which caps their
    registers to fit (``cluster_ctas_per_sm`` in csrc/ntt_cluster.cuh)."""
    return 2 if words <= 8 else 1


def cluster_for(logn: int, clusters: int, sms: int) -> int:
    """Cluster size for `clusters` independent limbs of N = 2^logn words on
    `sms` SMs. Each thread's work is W = N/(C·threads) words: pick the C
    that minimises waves x W, waves = ceil(clusters·C / (sms ·
    ctas_per_sm(W))); ties go to the smaller C (fewer cluster barriers)."""
    def cost(c):
        w = (1 << logn) // c // cluster_threads(logn, c)
        return -(-clusters * c // (sms * ctas_per_sm(w))) * w, c
    return min(cluster_sizes(logn), key=cost)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cluster(logn: int, cluster: int | None) -> None:
    if cluster is not None and cluster not in cluster_sizes(logn):
        raise ValueError(f"cluster {cluster} not in {cluster_sizes(logn)} "
                         f"for logN={logn}")


def _check_aligned(x: torch.Tensor, name: str) -> None:
    # The kernels move each thread's words with 8- and 16-byte accesses.
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def _geometry(logn: int, clusters: int, x: torch.Tensor,
              cluster: int | None) -> tuple[int, int]:
    """(log2 C, threads per CTA) of one launch."""
    c = cluster or cluster_for(logn, clusters, _sms(x.device))
    return c.bit_length() - 1, cluster_threads(logn, c)


# ---------------------------------------------------------------------------
# NTT
# ---------------------------------------------------------------------------

def lead_stride(x: torch.Tensor) -> int:
    """L' when x[..., L, N] is the limbs [a, a+L) of a contiguous
    [..., L', N] tensor (L' = L when x itself is contiguous): the kernels
    read row (m, j) at limb m·L' + j after x's first word. Raises for any
    other layout."""
    *lead, L, n = x.shape
    if x.is_contiguous():
        return L
    ok = x.stride(-1) == 1 and (L == 1 or x.stride(-2) == n)
    lp, span = L, None              # span: words per step of the lead dim
    for size, stride in zip(reversed(lead), reversed(x.stride()[:-2])):
        if size == 1:
            continue
        if span is None:
            lp, span = stride // n, stride
            ok = ok and stride % n == 0 and lp >= L
        ok = ok and stride == span
        span = stride * size
    if not ok:
        raise ValueError(f"NTT operand of shape {tuple(x.shape)} and strides "
                         f"{x.stride()} is neither contiguous nor a limb "
                         f"slice of a contiguous tensor")
    return lp


def ntt_args(x: torch.Tensor, t: NttTables, out: torch.Tensor, inverse: bool,
             log_c: int, threads: int) -> tuple:
    """The arguments of the C entry ``ntt_inverse`` (or ``ntt_forward``)
    but the stream, in its order; out is the contiguous [..., L, N]
    result."""
    tabs = ((t.inv_roots, t.inv_roots_shoup, t.q, t.n_inv, t.n_inv_shoup)
            if inverse else (t.roots, t.roots_shoup, t.q))
    return (x, out, *tabs, out.numel() // t.n, t.q.shape[0], lead_stride(x),
            t.logn, log_c, threads)


def _transform(x: torch.Tensor, t: NttTables, cluster: int | None,
               inverse: bool) -> torch.Tensor:
    _check_cluster(t.logn, cluster)
    if x.shape[-2] == 0:
        # A mesh position that holds no limb at this level.
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.dtype == torch.int64 or x.device.type == "cpu":
        return (_intt_stages if inverse else _ntt_stages)(x, t)
    *lead, L, n = x.shape
    if n != t.n or L != t.q.shape[0]:
        raise ValueError(f"NTT operand [..., {L}, {n}] does not match tables "
                         f"[{t.q.shape[0]}, {t.n}]")
    _cuda.check_operand(x, "x", contiguous=False)
    for name in ("q", "roots", "inv_roots"):
        tab = getattr(t, name)
        if tab.device != x.device:
            raise ValueError(f"tables.{name} on {tab.device}, x on {x.device}")
    _check_aligned(x, "x")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    log_c, threads = _geometry(t.logn, out.numel() // n, x, cluster)
    _cuda.call("ntt", "ntt_inverse" if inverse else "ntt_forward",
               *ntt_args(x, t, out, inverse, log_c, threads))
    _cuda.count("ntt_inv" if inverse else "ntt_fwd")
    return out


def ntt_forward(x: torch.Tensor, t: NttTables,
                cluster: int | None = None) -> torch.Tensor:
    """Forward negacyclic NTT over [..., L, N]; equals ``_ntt_stages``.
    ``cluster`` forces the kernel's cluster size (one of ``cluster_sizes``)."""
    return _transform(x, t, cluster, inverse=False)


def ntt_inverse(x: torch.Tensor, t: NttTables,
                cluster: int | None = None) -> torch.Tensor:
    """Inverse negacyclic NTT over [..., L, N]; equals ``_intt_stages``.
    ``cluster`` forces the kernel's cluster size (one of ``cluster_sizes``)."""
    return _transform(x, t, cluster, inverse=True)
