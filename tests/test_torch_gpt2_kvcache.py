"""The port's KV-cache decode (nn/kvcache.py) held against the JAX
package's, on both packages' plain backends: tests/test_decode.py's case
(two random tiny blocks, six tokens fed one at a time) on each package,
from the same plans' weights.

Tolerance: exact against the JAX package (the same numpy code over the
backend protocol: masks, cache contents and decoded rows are equal); 1e-6
between the decoded rows and the full causal forward, as
tests/test_decode.py holds the JAX package.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import kvcache as jKV
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend
from fhe_gpt2_tpu.nn.backend import RecordingBackend as JRecordingBackend
from fhe_gpt2_tpu.nn.model import GPT2ModelPlans as JGPT2ModelPlans

from fhe_gpt2_tpu_torch.nn import kvcache as KV
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend
from fhe_gpt2_tpu_torch.nn.model import GPT2ModelPlans

from torch_gpt2_common import JSH, SH, same_array, same_block_plans, \
    same_ln_plans, same_values
from test_decode import _tiny_plans

N_TOK = 6


@pytest.fixture(scope="module")
def both():
    """(tokens, port plans, JAX plans): tests/test_decode.py's _tiny_plans
    run once as it is and once over the port's layers, from the same seed."""
    import test_decode

    out = []
    for mods in ((L, GPT2ModelPlans, SH), None):
        rng = np.random.default_rng(11)
        X = rng.standard_normal((N_TOK, SH.hidden)) * 0.5
        with pytest.MonkeyPatch.context() as mp:
            if mods:
                for name, mod in zip(("L", "GPT2ModelPlans", "SH"), mods):
                    mp.setattr(test_decode, name, mod)
            out.append((X, _tiny_plans(rng, X)))
    (X, plans), (jX, jplans) = out
    assert np.array_equal(X, jX)
    return X, plans, jplans


def test_plans_equal_reference(both):
    _, plans, jplans = both
    assert isinstance(jplans, JGPT2ModelPlans)
    assert len(plans.blocks) == len(jplans.blocks) == 2
    for bp, jbp in zip(plans.blocks, jplans.blocks):
        same_block_plans(bp, jbp)
    same_ln_plans(plans.ln_f, jplans.ln_f)


@pytest.mark.parametrize("row", [0, 5, 15])
def test_masks_equal_reference(row):
    for got, want in zip(KV.row_masks(SH, row), jKV.row_masks(JSH, row)):
        same_array(got, want, "row mask")
    same_array(KV.active_mask(SH, row), jKV.active_mask(JSH, row), "active")
    # Memoized: the same arrays (the backend's encoding cache keys on id).
    assert KV.row_masks(SH, row)[0] is KV.row_masks(SH, row)[0]
    assert KV.active_mask(SH, row) is KV.active_mask(SH, row)


def test_augment_equals_reference():
    rng = np.random.default_rng(3)
    cache = list(rng.standard_normal((SH.act.n_cts, SH.slots)))
    new = list(rng.standard_normal((SH.act.n_cts, SH.slots)))
    B, JB = PlainBackend(SH.slots), JPlainBackend(JSH.slots)
    same_values(KV.augment(B, cache, new, SH, 7),
                jKV.augment(JB, cache, new, JSH, 7))


def test_decode_equals_reference_and_full_forward(both):
    X, plans, jplans = both
    B, JB = PlainBackend(SH.slots), JPlainBackend(JSH.slots)
    caches = KV.KVCaches.empty(B, SH, len(plans.blocks))
    jcaches = jKV.KVCaches.empty(JB, JSH, len(jplans.blocks))
    rows = []
    for t in range(N_TOK):
        row = KV.decode_step(B, plans, caches, X[t], t)
        same_array(row, jKV.decode_step(JB, jplans, jcaches, X[t], t),
                   f"row {t}")
        for layer in range(len(plans.blocks)):
            same_values(caches.k[layer], jcaches.k[layer], f"k {t}")
            same_values(caches.v[layer], jcaches.v[layer], f"v {t}")
        rows.append(row)
    act = np.zeros((SH.seq, SH.hidden))
    act[:N_TOK] = X
    xs = list(SH.act.pack(act))
    for bp in plans.blocks:
        xs = L.block(B, xs, SH, bp)
    full = SH.act.unpack(np.stack(L.layer_norm(B, xs, SH, plans.ln_f)))
    assert np.abs(np.stack(rows) - full[:N_TOK]).max() < 1e-6


def test_decode_key_steps_equal_reference(both):
    """The rotation set of the decode steps (run_gpt2 --decode generates
    these keys)."""
    X, plans, jplans = both
    rec, jrec = RecordingBackend(SH.slots), JRecordingBackend(JSH.slots)
    rc = KV.KVCaches.empty(rec, SH, len(plans.blocks))
    jrc = jKV.KVCaches.empty(jrec, JSH, len(jplans.blocks))
    for t in range(N_TOK):
        KV.decode_step(rec, plans, rc, X[t], t)
        jKV.decode_step(jrec, jplans, jrc, X[t], t)
    assert rec.key_steps() == jrec.key_steps()
