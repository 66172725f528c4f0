"""The port's reduced-error multiply and rescale to a scale (CPU, plain
versions) held against the JAX package on both uint32 chains at logN=11,
on the shared fixture ``run`` of tests/torch_port_common.py (the
scale-matching ops, stack/unstack and fake_bootstrap on it:
tests/test_torch_reduced.py).

Tolerance: exact. Every comparison is ``array_equal`` on the words and
``==`` on the scales; every ciphertext is the JAX package's, carried over
with ``carry.py``.
"""

import pytest

from torch_port_common import run  # noqa: F401
from torch_port_common import same_words as _same
from torch_port_common import single_torch_thread  # noqa: F401
from torch_port_common import to_port as _port

REDUCED = {
    "multiply_reduced_error": lambda ev, a, b, c: ev.multiply_reduced_error(
        a, c),
    "rescale_to_scale": lambda ev, a, b, c: ev.rescale_to_scale(
        ev.multiply(a, a), a.scale),
}


@pytest.mark.parametrize("op", sorted(REDUCED))
def test_reduced_error_op_equals_reference(run, op):
    jev, ev = run["ref"][1], run["got"][1]
    args = [run[k] for k in "abc"]
    ref = REDUCED[op](jev, *args)
    got = REDUCED[op](ev, *[_port(x) for x in args])
    _same(got, ref, op)
