"""Packed-matrix slot layouts and LT-spec builders.

Generalizes the reference's packing model (SURVEY §2.5; plain_approx/pack.py,
attn.py:60-73) to arbitrary (slots, rows, cols, heads) so kernels are testable
at small shapes. Layouts:

  * TightLayout — row-major dense across ciphertexts (the reference's
    bootstrap-efficient "pack_tight" format, pack.cpp:10-150). This is the
    *canonical* activation format here: matmuls on it have the fewest
    rotation amounts (d = k - c mod slots only), unlike the reference which
    keeps activations in the 2·p2(cols)-strided "prefold" format.
  * StridedLayout — row r at slot (r % rpc)·stride + c: covers the
    reference's prefold (stride 2·p2(cols)), per-head Q/K (stride 2·p2(dh)),
    and attention-score (stride 2·p2(seq)) formats.

Rectangular matmuls decompose into square hidden×hidden blocks over column
groups (e.g. 768→3072 = four 768×768 blocks), keeping every block's LT
few-diagonal.

The port's copy of ``fhe_gpt2_tpu/nn/formats.py``: numpy host code,
unchanged, so both packages build the same diagonals.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .linear import LTSpec, lt_from_triples


def p2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


@dataclass(frozen=True)
class TightLayout:
    rows: int
    cols: int
    slots: int

    @property
    def n_cts(self) -> int:
        return -(-self.rows * self.cols // self.slots)

    def place(self, r, c):
        """(ct, slot) of element (r, c); r/c may be numpy arrays."""
        g = r * self.cols + c
        return g // self.slots, g % self.slots

    def pack(self, A: np.ndarray) -> np.ndarray:
        """Host: matrix -> [n_cts, slots] slot values."""
        flat = np.zeros(self.n_cts * self.slots)
        flat[: A.size] = A.ravel()
        return flat.reshape(self.n_cts, self.slots)

    def unpack(self, x: np.ndarray) -> np.ndarray:
        return x.ravel()[: self.rows * self.cols].reshape(self.rows, self.cols)


@dataclass(frozen=True)
class StridedLayout:
    rows: int
    cols: int
    slots: int
    stride: int           # slots between consecutive rows within a ct

    @property
    def rows_per_ct(self) -> int:
        return self.slots // self.stride

    @property
    def n_cts(self) -> int:
        return -(-self.rows // self.rows_per_ct)

    def place(self, r, c):
        rpc = self.rows_per_ct
        return r // rpc, (r % rpc) * self.stride + c

    def pack(self, A: np.ndarray) -> np.ndarray:
        out = np.zeros((self.n_cts, self.slots))
        r = np.repeat(np.arange(self.rows), self.cols)
        c = np.tile(np.arange(self.cols), self.rows)
        ct, sl = self.place(r, c)
        out[ct, sl] = A.ravel()
        return out

    def unpack(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x))
        A = np.zeros((self.rows, self.cols))
        r = np.repeat(np.arange(self.rows), self.cols)
        c = np.tile(np.arange(self.cols), self.rows)
        ct, sl = self.place(r, c)
        A[r, c] = x[ct, sl]
        return A


def prefold_layout(rows: int, cols: int, slots: int) -> StridedLayout:
    """The reference's fold-format (plain_approx/pack.py:55-75)."""
    return StridedLayout(rows, cols, slots, stride=2 * p2(cols))


# ---------------------------------------------------------------------------
# Spec builders
# ---------------------------------------------------------------------------

def matmul_spec(W: np.ndarray, layout, name: str = "matmul") -> LTSpec:
    """A @ W for A [rows, d] in `layout` (Tight or same-stride Strided),
    W [d, d] plaintext; output in the same layout.

    Analytic diagonal construction: for both layout families the rotation
    amount of entry (k -> c) is (k - c) mod slots, independent of the row —
    in the strided case rows never cross ct boundaries, in the tight case
    boundary rows just split across (src_ct, dst_ct) pairs. This is the
    LT-engine replacement for the reference's fold matmul
    (row_matrix_multiplication_seal / generic_matrix_mul)."""
    d = layout.cols
    rows = layout.rows
    slots = layout.slots
    assert W.shape == (d, d)
    diagonals: dict = {}
    r_idx = np.arange(rows)
    for delta in range(-(d - 1), d):
        c = np.arange(max(0, -delta), min(d, d - delta))
        if len(c) == 0:
            continue
        k = c + delta
        w = W[k, c]                                  # [nc]
        dct, dsl = layout.place(r_idx[:, None], c[None, :])
        sct, ssl = layout.place(r_idx[:, None], k[None, :])
        dsl = np.broadcast_to(dsl, (rows, len(c)))
        dct = np.broadcast_to(dct, dsl.shape)
        sct = np.broadcast_to(sct, dsl.shape)
        ssl = np.broadcast_to(ssl, dsl.shape)
        rho = int((ssl.ravel()[0] - dsl.ravel()[0]) % slots)
        # (ssl - dsl) is delta for every entry in both layout families.
        for s_ct in np.unique(sct):
            for d_ct in np.unique(dct):
                sel = (sct == s_ct) & (dct == d_ct)
                if not sel.any():
                    continue
                key = (rho, int(s_ct), int(d_ct))
                mask = diagonals.get(key)
                if mask is None:
                    mask = np.zeros(slots)
                    diagonals[key] = mask
                np.add.at(mask, dsl[sel], np.broadcast_to(w, dsl.shape)[sel])
    return LTSpec(slots=slots, n_src=layout.n_cts, n_dst=layout.n_cts,
                  diagonals=diagonals, name=name)


def matmul_tight_spec(W: np.ndarray, rows: int, slots: int,
                      name: str = "matmul") -> LTSpec:
    return matmul_spec(W, TightLayout(rows, W.shape[0], slots), name)


def blocks_matmul_specs(W: np.ndarray, layout, name: str = "mm"):
    """Rectangular [K, C] matmul as square d×d blocks over column groups in
    `layout` (d = layout.cols): specs[ko][co] maps input group ko to output
    group co; outputs are summed over ko by the caller."""
    d = layout.cols
    K, C = W.shape
    assert K % d == 0 and C % d == 0
    out = []
    for ko in range(K // d):
        row = []
        for co in range(C // d):
            blk = W[ko * d:(ko + 1) * d, co * d:(co + 1) * d]
            row.append(matmul_spec(blk, layout, name=f"{name}[{ko},{co}]"))
        out.append(row)
    return out


def _grid(rows, cols):
    r = np.repeat(np.arange(rows), cols)
    c = np.tile(np.arange(cols), rows)
    return r, c


def repack_spec(lin, lout, name: str = "repack") -> LTSpec:
    """Pure format conversion (identity weights) between two layouts of the
    same logical matrix — the generalization of pack_tight/unpack_tight."""
    assert lin.rows == lout.rows and lin.cols == lout.cols
    r, c = _grid(lin.rows, lin.cols)
    sct, ssl = lin.place(r, c)
    dct, dsl = lout.place(r, c)
    return lt_from_triples(lin.slots, lin.n_cts, lout.n_cts,
                           dct, dsl, sct, ssl, np.ones_like(r, float), name)


def head_split_spec(rows: int, d: int, heads: int, slots: int,
                    lin=None, name: str = "head_split"):
    """[rows, d] (tight or strided `lin`) -> per-head StridedLayout cts
    (head h = dst ct h).

    Head ct layout: row r at r·2·p2(dh) + c, dh = d // heads — the
    reference's Q/K per-head format (MatrixMul.cpp attn_proj_row)."""
    dh = d // heads
    lin = lin or TightLayout(rows, d, slots)
    lhead = StridedLayout(rows, dh, slots, stride=2 * p2(dh))
    assert lhead.n_cts == 1, "head format must fit one ct"
    r, c = _grid(rows, dh)
    trip = {k: [] for k in ("dct", "dsl", "sct", "ssl")}
    for h in range(heads):
        sct, ssl = lin.place(r, h * dh + c)
        _, dsl = lhead.place(r, c)
        trip["dct"].append(np.full_like(r, h))
        trip["dsl"].append(dsl)
        trip["sct"].append(sct)
        trip["ssl"].append(ssl)
    return lt_from_triples(
        slots, lin.n_cts, heads,
        np.concatenate(trip["dct"]), np.concatenate(trip["dsl"]),
        np.concatenate(trip["sct"]), np.concatenate(trip["ssl"]),
        np.ones(rows * dh * heads), name), lhead


def head_merge_spec(rows: int, d: int, heads: int, slots: int,
                    src_stride: int, src_cols: int, lout=None,
                    name: str = "head_merge") -> LTSpec:
    """Per-head strided cts (src ct h holds [rows, src_cols]) -> [rows, d]
    (tight or strided `lout`) with head h at columns [h·sc, (h+1)·sc)."""
    lout = lout or TightLayout(rows, d, slots)
    lhead = StridedLayout(rows, src_cols, slots, stride=src_stride)
    r, c = _grid(rows, src_cols)
    dcts, dsls, scts, ssls = [], [], [], []
    for h in range(heads):
        dct, dsl = lout.place(r, h * src_cols + c)
        _, ssl = lhead.place(r, c)
        dcts.append(dct)
        dsls.append(dsl)
        scts.append(np.full_like(r, h))
        ssls.append(ssl)
    return lt_from_triples(
        slots, heads, lout.n_cts,
        np.concatenate(dcts), np.concatenate(dsls),
        np.concatenate(scts), np.concatenate(ssls),
        np.ones(rows * src_cols * heads), name)
