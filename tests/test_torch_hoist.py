"""The port's hoisted rotations (CPU, plain versions) held against the JAX
package on both uint32 chains at logN=11.

Tolerance: exact. Every comparison is ``array_equal`` on the words and
``==`` on the scales. Both packages draw their keys from the same seed, and
every ciphertext is the JAX package's, carried over with ``carry.py``
(fixture ``run`` in tests/torch_port_common.py). The JAX side runs its CPU
path (``_decompose_core`` + ``_ks_mac_core`` + ``_mod_down_core``); with
two special primes the float32 estimate of the mod-down sums two terms, so
its order cannot differ from the port's. The reduced-error ops and
stack/unstack on the same fixture: tests/test_torch_reduced*.py.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu_torch.core.evaluator import Decryptor

from torch_port_common import ref_plain, run  # noqa: F401
from torch_port_common import same_words as _same
from torch_port_common import single_torch_thread  # noqa: F401
from torch_port_common import to_port as _port

# 0 (no rotation), single hops 1 and 5, and 3 = 2 + 1 (no exact key: the
# multi-hop branches).
ROT_STEPS = [0, 1, 3, 5]


def test_context_tables_equal_reference(run):
    jctx, ctx = run["jctx"], run["ctx"]
    assert ctx.q0_int == jctx.q0_int and ctx.q0_float == jctx.q0_float
    for level in range(ctx.base_limbs, ctx.L + 1):
        if level - ctx.rescale_limbs >= 0:
            assert ctx.rescale_divisor(level) == jctx.rescale_divisor(level)
        for got, want in zip(ctx.p_residues(level), jctx.p_residues(level)):
            _same(got, want, f"p_residues({level})")


@pytest.mark.parametrize("which", ["a", "stacked"])
def test_rotate_hoisted_equals_reference(run, which):
    jev, ev = run["ref"][1], run["got"][1]
    ref = jev.rotate_hoisted(run[which], ROT_STEPS)
    got = ev.rotate_hoisted(_port(run[which]), ROT_STEPS)
    assert len(got) == len(ROT_STEPS)
    for s, g, r in zip(ROT_STEPS, got, ref):
        _same(g, r, f"step {s}")


@pytest.mark.parametrize("which", ["a", "stacked"])
def test_hoisted_rotations_ext_and_mod_down_equal_reference(run, which):
    """The extended-basis rotations, and each one divided by P."""
    jev, ev = run["ref"][1], run["got"][1]
    jct = run[which]
    ref = jev.hoisted_rotations_ext(jct, ROT_STEPS)
    got = ev.hoisted_rotations_ext(_port(jct), ROT_STEPS)
    for s, g, r in zip(ROT_STEPS, got, ref):
        _same(g, r, f"ext step {s}")
        _same(ev.mod_down_ext(g, jct.level, jct.scale),
              jev.mod_down_ext(r, jct.level, jct.scale), f"mod_down {s}")


def test_hoisted_rotations_decrypt(run):
    """The hoisted rotations are rotations: each decrypts to the rolled
    slots (w32 budget at Δ = 2^25: 1e-3, as tests/test_torch_cuda.py)."""
    kg, ev = run["got"]
    dec = Decryptor(run["ctx"], kg.secret)
    x = run["x"][0]
    a = _port(run["a"])
    exts = ev.hoisted_rotations_ext(a, ROT_STEPS)
    for s, r, e in zip(ROT_STEPS, ev.rotate_hoisted(a, ROT_STEPS), exts):
        want = np.roll(x, -s)
        assert np.max(np.abs(dec.decrypt(r) - want)) < 1e-3, s
        back = ev.mod_down_ext(e, a.level, a.scale)
        assert np.max(np.abs(dec.decrypt(back) - want)) < 1e-3, s


def test_make_plain_ext_equals_reference(run):
    """Against the body of the JAX package's make_plain_ext over the key
    limbs (``ref_plain``: the same encoding, its NTT loop jitted)."""
    jctx, ev = run["jctx"], run["got"][1]
    x, scale = run["x"][2], jctx.params.scale
    level = run["ctx"].L
    _same(ev.make_plain_ext(x, scale, level),
          ref_plain(jctx, x, scale, jctx.key_limbs(level)).data)
