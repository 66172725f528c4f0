"""The port's CNN layer (cnn/conv.py, cnn/resnet.py) held against the JAX
package and the float oracle, on the plain simulator.

Tolerance: exact against the JAX package (the same numpy code: specs,
diagonals, plans, biases, forward values and rotation sets are equal);
1e-10 against the numpy convolution oracle, as tests/test_cnn.py holds the
JAX package.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.approx import minimax as jminimax
from fhe_gpt2_tpu.cnn import conv as jC
from fhe_gpt2_tpu.cnn import resnet as jR
from fhe_gpt2_tpu.nn import kernels as jK
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend
from fhe_gpt2_tpu.nn.backend import RecordingBackend as JRecordingBackend

from fhe_gpt2_tpu_torch.approx import minimax
from fhe_gpt2_tpu_torch.cnn import conv as C
from fhe_gpt2_tpu_torch.cnn import resnet as R
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend
from fhe_gpt2_tpu_torch.nn.linear import apply_lt

from test_cnn_encrypted import synthetic_weights as jsynthetic_weights

SIGN = dict(target_err=2.0 ** -10, eps=2.0 ** -8)


def _same_spec(spec, jspec):
    assert (spec.slots, spec.n_src, spec.n_dst, spec.name) == \
        (jspec.slots, jspec.n_src, jspec.n_dst, jspec.name)
    assert sorted(spec.diagonals) == sorted(jspec.diagonals)
    for k in spec.diagonals:
        assert np.array_equal(spec.diagonals[k], jspec.diagonals[k]), k


def _same_plan(plan, jplan):
    if plan is None or jplan is None:
        assert plan is None and jplan is None
        return
    _same_spec(plan.spec, jplan.spec)
    assert plan.giant == jplan.giant
    assert sorted(plan.groups) == sorted(jplan.groups)
    for jg in plan.groups:
        g, jgg = plan.groups[jg], jplan.groups[jg]
        assert sorted(g) == sorted(jgg)
        for dst in g:
            assert len(g[dst]) == len(jgg[dst])
            for (i, s, m), (ji, js, jm) in zip(g[dst], jgg[dst]):
                assert (i, s) == (ji, js) and np.array_equal(m, jm)


def _conv_case(stride):
    rng = np.random.default_rng(stride - 1)
    cout, hout = (6, 8) if stride == 1 else (8, 4)
    x = rng.standard_normal((4, 8, 8))
    w = rng.standard_normal((cout, 4, 3, 3)) * 0.2
    return x, w, (4, 8, 8, 512), (cout, hout, hout, 512)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_spec_equals_reference_and_oracle(stride):
    """tests/test_cnn.py's convolution cases: the port's spec and plan equal
    the JAX package's, and the plain run matches the numpy oracle."""
    x, w, lin_s, lout_s = _conv_case(stride)
    lin, lout = C.PlanarLayout(*lin_s), C.PlanarLayout(*lout_s)
    spec = C.conv2d_spec(w, lin, lout, stride)
    jspec = jC.conv2d_spec(w, jC.PlanarLayout(*lin_s),
                           jC.PlanarLayout(*lout_s), stride)
    _same_spec(spec, jspec)
    _same_plan(spec.bsgs_plan(), jspec.bsgs_plan())
    assert np.array_equal(lin.pack(x), jC.PlanarLayout(*lin_s).pack(x))
    out = apply_lt(PlainBackend(512), spec.bsgs_plan(), list(lin.pack(x)))
    got = lout.unpack(np.stack(out))
    assert np.abs(got - R._conv2d_np(x, w, stride)).max() < 1e-10
    assert np.array_equal(R._conv2d_np(x, w, stride),
                          jR._conv2d_np(x, w, stride))


def test_avgpool_and_fc_equal_reference_and_oracle():
    rng = np.random.default_rng(2)
    lin = C.PlanarLayout(8, 4, 4, 256)
    x = rng.standard_normal((8, 4, 4))
    w = rng.standard_normal((8, 5))
    pool = C.avgpool_spec(lin, 256)
    fc = C.fc_spec(w, 8, 256)
    _same_spec(pool, jC.avgpool_spec(jC.PlanarLayout(8, 4, 4, 256), 256))
    _same_spec(fc, jC.fc_spec(w, 8, 256))
    B = PlainBackend(256)
    pooled = apply_lt(B, pool.bsgs_plan(), list(lin.pack(x)))
    assert np.allclose(pooled[0][:8], x.mean((1, 2)), atol=1e-12)
    out = apply_lt(B, fc.bsgs_plan(), pooled)
    assert np.allclose(out[0][:5], x.mean((1, 2)) @ w, atol=1e-10)


def test_fold_bn_and_bias_equal_reference_and_oracle():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 4, 3, 3))
    gamma, beta = rng.uniform(0.5, 1.5, 6), rng.standard_normal(6) * 0.1
    mean, var = rng.standard_normal(6) * 0.2, rng.uniform(0.5, 2.0, 6)
    x = rng.standard_normal((4, 8, 8))
    wf, bf = C.fold_bn(w, np.zeros(6), gamma, beta, mean, var)
    jwf, jbf = jC.fold_bn(w, np.zeros(6), gamma, beta, mean, var)
    assert np.array_equal(wf, jwf) and np.array_equal(bf, jbf)
    s = gamma / np.sqrt(var + 1e-5)
    want = R._conv2d_np(x, w) * s[:, None, None] + \
        (beta - mean * s)[:, None, None]
    got = R._conv2d_np(x, wf) + bf[:, None, None]
    assert np.abs(got - want).max() < 1e-10
    lout = C.PlanarLayout(6, 8, 8, 512)
    assert np.array_equal(C.bias_vector(lout, bf),
                          jC.bias_vector(jC.PlanarLayout(6, 8, 8, 512), bf))
    assert np.array_equal(lout.unpack(lout.pack(x[:1].repeat(6, 0))),
                          x[:1].repeat(6, 0))


@pytest.mark.parametrize("depth", [8, 14])
def test_synthetic_weights_equal_the_reference_tests(depth):
    """The port's generator is the JAX tests' one, draw for draw."""
    got = R.synthetic_weights(np.random.default_rng(0), depth)
    want = jsynthetic_weights(np.random.default_rng(0), depth=depth)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k]), k


# depth, image side, slots, block-conv scale: ResNet-8 at 8x8 and
# ResNet-20 at 16x16, one ciphertext each. At depth 20 the tests' 0.4 drives
# the pre-ReLU values past the sign's domain (and the plain run to NaN).
PLAN_CASES = [(8, 8, 1024, 0.4), (20, 16, 4096, 0.24)]


@pytest.fixture(scope="module", params=PLAN_CASES, ids=["d8", "d20"])
def nets(request):
    depth, h, slots, scale = request.param
    w = R.synthetic_weights(np.random.default_rng(depth), depth,
                            block_scale=scale)
    sp = K.SignPlans.from_composite(minimax.dp_schedule(**SIGN))
    jsp = jK.SignPlans.from_composite(jminimax.dp_schedule(**SIGN))
    rp = R.build_resnet_plans(w, depth, slots, h=h, relu_bound=10.0, sign=sp)
    jrp = jR.build_resnet_plans(w, depth, slots, h=h, relu_bound=10.0,
                                sign=jsp)
    img = np.random.default_rng(1).uniform(-1, 1, (3, h, h))
    return w, rp, jrp, img


def test_resnet_plans_equal_reference(nets):
    """Every block's conv plans, folded biases, shortcuts and layouts, the
    stem, pool and FC, and the ReLU depth."""
    _, rp, jrp, _ = nets
    assert (rp.depth, rp.slots, rp.relu_bound, rp.normalized, rp.relu_need) \
        == (jrp.depth, jrp.slots, jrp.relu_bound, jrp.normalized,
            jrp.relu_need)
    assert rp.relu_need == 16
    _same_plan(rp.stem[0], jrp.stem[0])
    assert np.array_equal(rp.stem[1], jrp.stem[1])
    assert len(rp.blocks) == len(jrp.blocks) == 3 * ((rp.depth - 2) // 6)
    for b, jb in zip(rp.blocks, jrp.blocks):
        for k in ("plan1", "plan2", "short"):
            _same_plan(b[k], jb[k])
        for k in ("bias1", "bias2"):
            assert np.array_equal(b[k], jb[k])
        assert b["short_bias"] is None and jb["short_bias"] is None
        assert (b["lin"], b["lout"]) == (
            C.PlanarLayout(*vars(jb["lin"]).values()),
            C.PlanarLayout(*vars(jb["lout"]).values()))
    _same_plan(rp.pool, jrp.pool)
    _same_plan(rp.fc, jrp.fc)
    assert np.array_equal(rp.fc_bias, jrp.fc_bias)


def test_plain_forward_and_rotation_set_equal_reference(nets):
    w, rp, jrp, img = nets
    xs, jxs = R.pack_input(rp, img), jR.pack_input(jrp, img)
    assert all(np.array_equal(a, b) for a, b in zip(xs, jxs))
    out = R.forward(PlainBackend(rp.slots), xs, rp, boot_between=False)
    jout = jR.forward(JPlainBackend(rp.slots), jxs, jrp, boot_between=False)
    assert np.array_equal(out[0], jout[0])
    got = R.logits_from_slots(rp, out[0])
    assert np.array_equal(got, jR.logits_from_slots(jrp, jout[0]))
    want = R.forward_float(w, rp.depth, img)
    assert np.array_equal(want, jR.forward_float(w, rp.depth, img))
    assert np.argmax(got) == np.argmax(want)
    assert np.abs(got - want).max() < 0.05
    rec, jrec = RecordingBackend(rp.slots), JRecordingBackend(rp.slots)
    R.forward(rec, xs, rp, boot_between=False)
    jR.forward(jrec, jxs, jrp, boot_between=False)
    assert rec.key_steps() == jrec.key_steps()
    assert len(rec.key_steps()) > 0


def test_forward_jit_equals_reference(nets):
    """The segment driver (jit=True) on the plain simulator, where a
    refresh is the identity and a segment runs as it is: the JAX package's
    eager forward, value for value."""
    _, rp, jrp, img = nets
    xs = R.pack_input(rp, img)
    jout = jR.forward(JPlainBackend(rp.slots), jR.pack_input(jrp, img), jrp)
    for boot_between in (True, False):
        out = R.forward(PlainBackend(rp.slots), list(xs), rp,
                        boot_between=boot_between, jit=True)
        assert len(out) == len(jout)
        assert all(np.array_equal(a, b) for a, b in zip(out, jout))


def _write_weights(root, w, folder):
    d = root / folder
    d.mkdir()
    for k, v in w.items():
        np.savetxt(d / f"{k}.txt", np.asarray(v).ravel())


def _reference_files(w, depth, cifar100):
    """The reference's file names for a weight dict in the loader's
    layout."""
    n = (depth - 2) // 6
    files = {"conv1_weight": w["conv1"], "linear_weight": w["linear_weight"],
             "linear_bias": w["linear_bias"]}
    for k in ("weight", "bias", "running_mean", "running_var"):
        files[f"bn1_{k}"] = w[f"bn1_{k}"]
    for s in range(1, 4):
        for b in range(n):
            p = f"layer{s}_{b}_"
            files[p + "conv1_weight"] = w[p + "conv1"]
            files[p + "conv2_weight"] = w[p + "conv2"]
            for bn in ("bn1", "bn2"):
                for k in ("weight", "bias", "running_mean", "running_var"):
                    files[f"{p}{bn}_{k}"] = w[f"{p}{bn}_{k}"]
            if cifar100 and s > 1 and b == 0:
                rng = np.random.default_rng(s)
                cw, cin = (32, 16) if s == 2 else (64, 32)
                files[p + "shortcut_0_weight"] = rng.standard_normal(
                    (cw, cin, 1, 1))
                for k in ("weight", "bias", "running_mean", "running_var"):
                    files[f"{p}shortcut_1_{k}"] = rng.uniform(0.5, 1.5, cw)
    return files


@pytest.mark.parametrize("depth,dataset", [(20, "cifar10"),
                                           (32, "cifar100")])
def test_load_reference_weights_equals_reference(tmp_path, depth, dataset):
    """Both loaders read the same text files (written here in the
    reference's format) into the same dict."""
    classes = 100 if dataset == "cifar100" else 10
    w = R.synthetic_weights(np.random.default_rng(3), depth,
                            n_classes=classes)
    folder = "resnet32_cifar100" if dataset == "cifar100" else \
        f"resnet{depth}_new"
    _write_weights(tmp_path, _reference_files(w, depth,
                                              dataset == "cifar100"), folder)
    got = R.load_reference_weights(depth, dataset, root=str(tmp_path))
    want = jR.load_reference_weights(depth, dataset, root=str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and np.array_equal(got[k],
                                                                want[k]), k
    for k in w:
        assert np.array_equal(got[k], w[k]), k
    if dataset == "cifar100":
        assert got["layer2_0_shortcut_conv"].shape == (32, 16, 1, 1)
        assert got["linear_weight"].shape == (100, 64)
