"""The plain reference's own pieces: the composite sign it works out, and
the served-block plans the ResNet session is built from.

    python -m pytest fhe_bench -q -p no:cacheprovider
"""

import json

import numpy as np

from fhe_bench import harness, inputs, session
from fhe_bench.reference import resnet as ref

CFG = json.loads((harness.HERE / "configs" / "resnet20-cifar10.json")
                 .read_text())


def _sign(stages, x):
    s = x
    for c, lo, hi in stages:
        s = ref._cheb(c, lo, hi, s)
    return s


def test_the_reference_sign_reaches_the_stated_error():
    spec = CFG["sign"]
    x = np.linspace(2.0 ** spec["eps_log2"], 1.0, 200001)
    s = _sign(ref.sign_stages(spec), np.concatenate([x, -x]))
    assert np.abs(s - np.sign(np.concatenate([x, -x]))).max() \
        <= 2.0 ** spec["err_log2"]


def test_the_reference_relu_agrees_with_the_programs():
    """A witness, not the check: the port's composite for the configured
    flags and the reference's, worked out apart, give the same ReLU to far
    below the cells' limits (both are the minimax stages, to their Remez
    tolerances)."""
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    spec = CFG["sign"]
    port = dp_schedule(target_err=2.0 ** spec["err_log2"],
                       eps=2.0 ** spec["eps_log2"])
    assert [p.degree for p in port.stages] == spec["degrees"]
    x = np.linspace(-1.0, 1.0, 200001)
    mine = ref.relu(x, ref.sign_stages(spec))
    theirs = x * (1.0 + port(x)) / 2.0
    assert np.abs(mine - theirs).max() < 1e-5


def test_exact_relu_without_a_composite():
    x = np.linspace(-1.0, 1.0, 11)
    assert np.array_equal(ref.relu(x, None), np.maximum(x, 0.0))


def test_served_blocks_keep_the_whole_networks_plans():
    """Plans built over ``served_weights`` hold, for the served blocks,
    the diagonals of the plans over the whole weight set."""
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.nn import kernels as K
    sign = K.SignPlans.from_composite(dp_schedule(target_err=2.0 ** -10,
                                                  eps=2.0 ** -8))
    w = inputs.resnet_weights(inputs.rng(5, 1), 20, 10, 0.24)
    whole = R.build_resnet_plans(w, 20, 1024, h=8, relu_bound=10.0,
                                 sign=sign)
    served = R.build_resnet_plans(session.served_weights(w, 20, [1, 4]), 20,
                                  1024, h=8, relu_bound=10.0, sign=sign)

    def diagonals(plan):
        return {(jg, dst, i, src): m for jg, g in plan.groups.items()
                for dst, terms in g.items() for i, src, m in terms}

    for b in (1, 4):
        for key in ("plan1", "plan2"):
            a = diagonals(whole.blocks[b][key])
            c = diagonals(served.blocks[b][key])
            assert a.keys() == c.keys()
            assert all(np.array_equal(a[k], c[k]) for k in a)
        assert np.array_equal(whole.blocks[b]["bias1"],
                              served.blocks[b]["bias1"])
    assert len(diagonals(served.blocks[0]["plan1"])) == 1
