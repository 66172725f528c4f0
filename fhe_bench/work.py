"""Work counts: bytes and 32-bit multiplies of the port's kernels and of its
homomorphic operations, and the least time one H100 needs for them.

``bound`` and ``ntt_cost`` are frozen copies of ``chip_smoke.py``'s (the
key-switch and mod-down formulas below are its phase-2 formulas with the
batch rows ``M`` made explicit; at ``M = 1`` and ``M = 2`` they give its
numbers). The benchmark keeps them here so that a later change to the
program cannot move its yardstick.

A kernel call's least time is ``kernel_time``: the larger of its bytes at
the card's memory rate and its multiplies at the multiply rate, counting
each input word read once, each output word written once and each table
of an NTT once. An operation's least time (``Work``) counts what the
operation must touch at least: each ciphertext and plaintext operand read
once, each result written once, each key read once per key switch.
"""

from __future__ import annotations

from dataclasses import dataclass

MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
MUL_RATE = 33.5e12        # 32-bit multiplies/s: the fp32 FMA issue rate
                          # (67 TFLOP/s / 2), an upper bound on the card's
                          # int32 multiply rate
SHOUP_MULS, BARRETT_MULS = 3, 7   # 32-bit multiplies per modular product
WORD = 4                  # bytes of one residue word (the uint32 chains)


def bound(nbytes: float, muls: float) -> tuple[float, str]:
    """Least milliseconds for nbytes and muls, and which of them binds."""
    t_bytes, t_ops = nbytes / MEM_RATE, muls / MUL_RATE
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ntt_cost(rows: int, L: int, n: int) -> tuple[float, float]:
    """Bytes (rows in and out, twiddle + Shoup table of L limbs) and
    multiplies of one (i)NTT of rows x n words."""
    logn = n.bit_length() - 1
    return 4.0 * (2 * rows * n + 2 * L * n), rows * (n // 2) * logn * SHOUP_MULS


def keyswitch_cost(M: int, l: int, D: int, A: int, J: int,
                   n: int) -> tuple[float, float]:
    """``fused_switch_key`` of c[M rows of l limbs] against a key of D
    digits over J key limbs (A source limbs in the widest digit): the iNTT
    of c, then the digits' base conversion, NTT and key product. Reads c
    and the key, writes [2, M, J, N]."""
    b_i, m_i = ntt_cost(M * l, l, n)                 # iNTT of c
    b_f, m_f = ntt_cost(M * D * J, J, n)             # NTT of the digits
    words_io = M * l * n + 2 * D * J * n + 2 * M * J * n
    muls = (m_i + m_f + M * D * A * n * SHOUP_MULS
            + M * (D * J * A + 2 * D * J) * n * BARRETT_MULS)
    return (WORD * words_io + (b_i - 8.0 * M * l * n)
            + (b_f - 8.0 * M * D * J * n), muls)


def moddown_cost(M: int, l: int, k: int, n: int) -> tuple[float, float]:
    """``fused_mod_down`` of x[M rows of l + k limbs] to l limbs: the iNTT
    of the k dropped limbs, their conversion, the NTT and the subtraction.
    Reads x, writes [M, l, N]."""
    b_i, m_i = ntt_cost(M * k, k, n)
    b_f, m_f = ntt_cost(M * l, l, n)
    muls = (m_i + m_f + M * k * n * SHOUP_MULS
            + M * l * n * (k + 1) * BARRETT_MULS + M * l * n * SHOUP_MULS)
    return (WORD * (M * (l + k) * n + M * l * n) + (b_i - 8.0 * M * k * n)
            + (b_f - 8.0 * M * l * n), muls)


def kernel_time(nbytes: float, muls: float) -> float:
    """Least seconds of a kernel call (or of an operation)."""
    return max(nbytes / MEM_RATE, muls / MUL_RATE)


def digits(level: int, alpha: int, k_sp: int) -> tuple[int, int, int]:
    """(D, A, J) of a key switch at `level` limbs: hybrid key switching in
    digits of alpha limbs (alpha = the special primes' count) over the data
    limbs below the level and the k_sp special limbs."""
    D = -(-level // alpha)
    return D, min(alpha, level), level + k_sp


@dataclass
class Work:
    """Bytes and multiplies of a stretch of operations."""

    nbytes: float = 0.0
    muls: float = 0.0
    ops: int = 0

    def add(self, nbytes: float = 0.0, muls: float = 0.0) -> None:
        self.nbytes += nbytes
        self.muls += muls

    def merge(self, other: "Work", times: int = 1) -> None:
        self.nbytes += other.nbytes * times
        self.muls += other.muls * times
        self.ops += other.ops * times

    def seconds(self) -> float:
        """Least seconds on the card: bytes or multiplies, whichever
        binds over the whole stretch."""
        return kernel_time(self.nbytes, self.muls)
