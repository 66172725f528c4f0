"""The port's reduced-error scale matching, stack/unstack and
fake_bootstrap (CPU, plain versions) held against the JAX package on both
uint32 chains at logN=11, on the shared fixture ``run`` of
tests/torch_port_common.py: ``set_scale_exact`` and
``add``/``sub_reduced_error`` with off-scale operands (the multiply and the
rescale to a scale: tests/test_torch_reduced_mul.py; the hoisted
rotations: tests/test_torch_hoist.py). fake_bootstrap re-encrypts at the
full level, as set_scale_exact encodes, so both share the JAX side's
compiles here.

Tolerance: exact. Every comparison is ``array_equal`` on the words and
``==`` on the scales; every ciphertext is the JAX package's, carried over
with ``carry.py``.
"""

import pytest

from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import fake_bootstrap as jfake_bootstrap
from fhe_gpt2_tpu.core.evaluator import stack_cts as jstack_cts
from fhe_gpt2_tpu.core.evaluator import unstack_cts as junstack_cts

from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
    fake_bootstrap, stack_cts, unstack_cts

from torch_port_common import run  # noqa: F401
from torch_port_common import same_words as _same
from torch_port_common import single_torch_thread  # noqa: F401
from torch_port_common import to_port as _port

REDUCED = {
    "set_scale_exact": lambda ev, a, b, c: ev.set_scale_exact(a, a.scale * 1.1),
    "add_reduced_error": lambda ev, a, b, c: ev.add_reduced_error(a, b),
    "add_reduced_error_int": lambda ev, a, b, c: ev.add_reduced_error(c, a),
    "sub_reduced_error": lambda ev, a, b, c: ev.sub_reduced_error(a, b),
    "sub_reduced_error_int": lambda ev, a, b, c: ev.sub_reduced_error(c, a),
}


@pytest.mark.parametrize("op", sorted(REDUCED))
def test_reduced_error_op_equals_reference(run, op):
    jev, ev = run["ref"][1], run["got"][1]
    args = [run[k] for k in "abc"]
    ref = REDUCED[op](jev, *args)
    got = REDUCED[op](ev, *[_port(x) for x in args])
    _same(got, ref, op)


def test_stack_unstack_fake_bootstrap_equal_reference(run):
    jev, ev = run["ref"][1], run["got"][1]
    a, b = run["a"], run["stacked"]
    _same(stack_cts([_port(a), _port(a)], axis=0), jstack_cts([a, a]))
    for g, r in zip(unstack_cts(_port(b)), junstack_cts(b)):
        assert g.data.is_contiguous()
        _same(g, r, "unstack")
    jctx, ctx = run["jctx"], run["ctx"]
    jkg, kg = run["ref"][0], run["got"][0]
    ref = jfake_bootstrap(b, JDecryptor(jctx, jkg.secret),
                          JEncryptor(jctx, secret=jkg.secret, seed=9), jev,
                          jctx.L)
    got = fake_bootstrap(_port(b), Decryptor(ctx, kg.secret),
                         Encryptor(ctx, secret=kg.secret, seed=9), ev, ctx.L)
    _same(got, ref, "fake_bootstrap")
