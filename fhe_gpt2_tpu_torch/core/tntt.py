"""NTT kernel wrappers: the Hopper counterpart of ``fhe_gpt2_tpu/core/tntt.py``.

The TPU package runs a four-step NTT as a Pallas kernel (``_fwd_kernel``,
``_inv_kernel``) shaped by the TPU's (R, 128) lane tiling. On the card the
same transform is ``csrc/ntt.cu``: the radix-2 network of
``ntt._ntt_stages``/``_intt_stages`` with segments of each row held in
shared memory (see the source note there). It reads the port's
``roots``/``inv_roots`` tables, so its output order is the plain version's
by construction, and covers every N from 2048 to 65536.

Route: a CUDA tensor launches the kernel (or the wrapper raises); a CPU
tensor runs the plain stage loop.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ntt import NttTables, _intt_stages, _ntt_stages

MAX_SEG_LOG = 15          # 2^15 words = 128 KB of shared memory per block
MIN_SEG_LOG = 11


def seg_log_for(logn: int, rows: int, sms: int) -> int:
    """Largest shared-memory segment (<= 2^15 words) that still puts at
    least one block on every SM; never below 2^11 words (a block of 1024
    threads with one butterfly each per stage)."""
    s = min(logn, MAX_SEG_LOG)
    while s > min(logn, MIN_SEG_LOG) and (rows << (logn - s)) < sms:
        s -= 1
    return s


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, t: NttTables) -> tuple[int, int]:
    *lead, L, n = x.shape
    if n != t.n or L != t.q.shape[0]:
        raise ValueError(f"NTT operand [..., {L}, {n}] does not match tables "
                         f"[{t.q.shape[0]}, {t.n}]")
    _cuda.check_operand(x, "x")
    for name in ("q", "roots", "inv_roots"):
        tab = getattr(t, name)
        if tab.device != x.device:
            raise ValueError(f"tables.{name} on {tab.device}, x on {x.device}")
    rows = x.numel() // n
    return rows, L


def ntt_forward(x: torch.Tensor, t: NttTables,
                seg_log: int | None = None) -> torch.Tensor:
    """Forward negacyclic NTT over [..., L, N]; equals ``_ntt_stages``."""
    if x.device.type == "cpu":
        return _ntt_stages(x, t)
    rows, L = _check(x, t)
    s = seg_log if seg_log is not None else seg_log_for(t.logn, rows,
                                                        _sms(x.device))
    if not (1 <= s <= min(t.logn, MAX_SEG_LOG)):
        raise ValueError(f"seg_log {s} out of range for logN={t.logn}")
    out = torch.empty_like(x)
    _cuda.call("ntt", "ntt_forward", x, out, t.roots, t.roots_shoup, t.q,
               rows, L, t.logn, s)
    _cuda.LAUNCHES["ntt_fwd"] += 1
    return out


def ntt_inverse(x: torch.Tensor, t: NttTables,
                seg_log: int | None = None) -> torch.Tensor:
    """Inverse negacyclic NTT over [..., L, N]; equals ``_intt_stages``."""
    if x.device.type == "cpu":
        return _intt_stages(x, t)
    rows, L = _check(x, t)
    s = seg_log if seg_log is not None else seg_log_for(t.logn, rows,
                                                        _sms(x.device))
    if not (1 <= s <= min(t.logn, MAX_SEG_LOG)):
        raise ValueError(f"seg_log {s} out of range for logN={t.logn}")
    out = torch.empty_like(x)
    _cuda.call("ntt", "ntt_inverse", x, out, t.inv_roots, t.inv_roots_shoup,
               t.q, t.n_inv, t.n_inv_shoup, rows, L, t.logn, s)
    _cuda.LAUNCHES["ntt_inv"] += 1
    return out
