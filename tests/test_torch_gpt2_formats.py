"""The port's packed-matrix layouts and LT-spec builders (nn/formats.py)
held against the JAX package's, on tight and strided layouts.

Tolerance: exact. Both are the same numpy host code, so every layout
placement, packing and every spec's diagonal set and masks are equal.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import formats as jF

from fhe_gpt2_tpu_torch.nn import formats as F
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend
from fhe_gpt2_tpu_torch.nn.linear import apply_lt_unplanned

from torch_gpt2_common import same_array, same_spec

SLOTS = 1024


def _layouts(mod, kind, rows, cols):
    if kind == "tight":
        return mod.TightLayout(rows, cols, SLOTS)
    if kind == "prefold":
        return mod.prefold_layout(rows, cols, SLOTS)
    return mod.StridedLayout(rows, cols, SLOTS, stride=2 * mod.p2(cols) * 2)


@pytest.mark.parametrize("kind", ["tight", "prefold", "strided"])
@pytest.mark.parametrize("rows,cols", [(16, 32), (12, 24), (40, 48)])
def test_layouts_equal_reference(kind, rows, cols):
    lay, jlay = _layouts(F, kind, rows, cols), _layouts(jF, kind, rows, cols)
    assert lay == type(lay)(**jlay.__dict__)
    assert lay.n_cts == jlay.n_cts
    A = np.random.default_rng(rows).standard_normal((rows, cols))
    same_array(lay.pack(A), jlay.pack(A), "pack")
    same_array(lay.unpack(lay.pack(A)), A, "roundtrip")
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    for got, want in zip(lay.place(r, c), jlay.place(r, c)):
        same_array(got, want, "place")


@pytest.mark.parametrize("kind", ["tight", "prefold", "strided"])
@pytest.mark.parametrize("rows,d", [(16, 32), (12, 24)])
def test_matmul_spec_equals_reference(kind, rows, d):
    W = np.random.default_rng(d).standard_normal((d, d))
    spec = F.matmul_spec(W, _layouts(F, kind, rows, d), "w")
    same_spec(spec, jF.matmul_spec(W, _layouts(jF, kind, rows, d), "w"))
    # And the spec computes A @ W.
    lay = _layouts(F, kind, rows, d)
    A = np.random.default_rng(1).standard_normal((rows, d))
    got = lay.unpack(np.stack(apply_lt_unplanned(
        PlainBackend(SLOTS), spec, list(lay.pack(A)))))
    assert np.abs(got - A @ W).max() < 1e-12


def test_matmul_tight_spec_equals_reference():
    W = np.random.default_rng(3).standard_normal((24, 24))
    same_spec(F.matmul_tight_spec(W, 20, SLOTS, "t"),
              jF.matmul_tight_spec(W, 20, SLOTS, "t"))


@pytest.mark.parametrize("kind", ["tight", "prefold"])
@pytest.mark.parametrize("K,C", [(32, 128), (128, 32)])
def test_blocks_matmul_specs_equal_reference(kind, K, C):
    W = np.random.default_rng(K).standard_normal((K, C))
    specs = F.blocks_matmul_specs(W, _layouts(F, kind, 16, 32), "fc")
    jspecs = jF.blocks_matmul_specs(W, _layouts(jF, kind, 16, 32), "fc")
    assert len(specs) == len(jspecs) == K // 32
    for row, jrow in zip(specs, jspecs):
        assert len(row) == len(jrow) == C // 32
        for s, js in zip(row, jrow):
            same_spec(s, js)


@pytest.mark.parametrize("src,dst", [("tight", "prefold"),
                                     ("prefold", "tight"),
                                     ("strided", "prefold")])
def test_repack_spec_equals_reference(src, dst):
    specs = [mod.repack_spec(_layouts(mod, src, 16, 24),
                             _layouts(mod, dst, 16, 24), "re")
             for mod in (F, jF)]
    same_spec(*specs)


@pytest.mark.parametrize("lin", [None, "prefold"])
def test_head_split_spec_equals_reference(lin):
    spec, lhead = F.head_split_spec(
        16, 32, 4, SLOTS, lin=lin and _layouts(F, lin, 16, 32))
    jspec, jlhead = jF.head_split_spec(
        16, 32, 4, SLOTS, lin=lin and _layouts(jF, lin, 16, 32))
    same_spec(spec, jspec)
    assert lhead == type(lhead)(**jlhead.__dict__)


@pytest.mark.parametrize("lout", [None, "prefold"])
def test_head_merge_spec_equals_reference(lout):
    specs = [mod.head_merge_spec(16, 32, 4, SLOTS, src_stride=16, src_cols=8,
                                 lout=lout and _layouts(mod, lout, 16, 32))
             for mod in (F, jF)]
    same_spec(*specs)
