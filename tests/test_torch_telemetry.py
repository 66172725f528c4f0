"""The port's span-and-counter recorder (fhe_gpt2_tpu_torch/utils/
telemetry.py) and its sites, on the CPU.

The recorder is off unless ``enable()`` holds or a torch.profiler session
runs; its spans nest per thread; the evaluator counts key switches and its
outermost ops by level; the mask cache counts its lookups and hits; the
refresh is a span with its parts as children; a sealed program keeps its warm
pass's counts; ``export`` writes a Chrome trace; ``run_resnet``'s session
times its bootstraps from the recorder's spans and leaves the backend's
``bootstrap`` method alone.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import (
    Decryptor, Encryptor, Evaluator, fake_bootstrap, stack_cts)
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, jit_sealed
from fhe_gpt2_tpu_torch.nn.linear import LTSpec, apply_lt
from fhe_gpt2_tpu_torch.utils import telemetry

KEY_STEPS = [1, 2, 5]


@pytest.fixture(scope="module")
def unit():
    """A composite chain at logN=10 (3 level pairs), its keys, evaluator,
    encryptor, decryptor and backend, and one ciphertext at the top."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = CkksParams.create_composite(logn=10, num_levels=3, num_special=2,
                                    hamming_weight=16)
    ctx = CkksContext(p, device="cpu")
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(KEY_STEPS, conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    dec = Decryptor(ctx, kg.secret)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=dec, default_level=ctx.L)
    x = np.random.default_rng(0).uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(x, p.scale, ctx.L))
    yield dict(ctx=ctx, ev=ev, enc=enc, dec=dec, B=B, x=x, ct=ct)
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean():
    telemetry.reset()
    yield
    while telemetry.recording():
        telemetry.disable()
    telemetry.reset()


def _ops(u):
    ev, ct = u["ev"], u["ct"]
    ev.rotate(ct, 1)
    ev.rescale(ev.multiply(ct, ct))
    u["B"].add_plain(ct, np.ones(u["ctx"].params.slots))
    fake_bootstrap(ct, u["dec"], u["enc"], ev, u["ctx"].L)


def test_off_by_default_records_nothing(unit, monkeypatch, capsys):
    """Off, the sites record no span or counter, synchronize nothing and
    print nothing."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    assert not telemetry.recording()
    _ops(unit)
    s = telemetry.snapshot()
    assert s.spans == [] and s.counters == {} and s.dropped == 0
    assert syncs == [] and capsys.readouterr().out == ""


@pytest.mark.parametrize("how", ["context", "call", "profiler"])
def test_on_inside_enable_and_the_profiler_only(unit, how):
    from torch.profiler import ProfilerActivity, profile
    if how == "context":
        with telemetry.enable():
            assert telemetry.recording()
            _ops(unit)
    elif how == "call":
        telemetry.enable()
        assert telemetry.recording()
        _ops(unit)
        telemetry.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert telemetry.recording()
            _ops(unit)
    assert not telemetry.recording()
    s = telemetry.snapshot()
    names = {sp.name for sp in s.spans}
    assert {"op.rotate", "op.multiply", "op.rescale", "refresh"} <= names
    assert s.counters[f"op.rotate@{unit['ctx'].L}"] == 1
    assert s.counters["ks"] == 2
    n = len(s.spans)
    _ops(unit)
    assert len(telemetry.snapshot().spans) == n


def test_stamps_and_ids(unit):
    with telemetry.enable():
        before = time.perf_counter_ns()
        with telemetry.span("outer"):
            with telemetry.span("inner", level=4, index=2):
                unit["ev"].add(unit["ct"], unit["ct"])
        with telemetry.span("second"):
            pass
        after = time.perf_counter_ns()
    by = {s.name: s for s in telemetry.snapshot().spans}
    outer, inner, add, second = (by[k] for k in ("outer", "inner", "op.add",
                                                 "second"))
    for s in by.values():
        assert before <= s.t0 <= s.t1 <= after
    assert len({s.id for s in by.values()}) == 4
    assert outer.parent == 0 and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert add.parent == inner.id and add.root == outer.id
    assert second.parent == 0 and second.root == second.id
    assert (inner.level, inner.index) == (4, 2)
    assert add.level == unit["ctx"].L
    assert outer.t0 <= inner.t0 <= add.t0 <= add.t1 <= inner.t1 <= outer.t1


def test_worker_threads_keep_separate_stacks():
    both = threading.Barrier(2, timeout=30)

    def work(i):
        with telemetry.span(f"outer{i}"):
            both.wait()             # both outer spans are open
            with telemetry.span(f"inner{i}"):
                both.wait()

    with telemetry.enable():
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in telemetry.snapshot().spans}
    for i in (0, 1):
        outer, inner = by[f"outer{i}"], by[f"inner{i}"]
        assert outer.parent == 0 and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id
        assert inner.thread == outer.thread
    assert by["outer0"].thread != by["outer1"].thread


@pytest.mark.parametrize("op", ["rotate", "multiply", "rotate_hoisted"])
def test_ks_counts_each_key_read(unit, monkeypatch, op):
    """``ks`` is the number of ``_switch_key`` and ``_hoisted_mac`` calls:
    a rotation by 3 takes two hops (keys 2 and 1), a multiply one
    relinearization, a hoisted rotation one key product per step."""
    ev, ct = unit["ev"], unit["ct"]
    calls = []
    for name in ("_switch_key", "_hoisted_mac"):
        fn = getattr(ev, name)
        monkeypatch.setattr(ev, name, lambda *a, fn=fn, **k: (
            calls.append(1), fn(*a, **k))[1])
    with telemetry.enable():
        if op == "rotate":
            ev.rotate(ct, 3)
        elif op == "multiply":
            ev.multiply(ct, ct)
        else:
            ev.rotate_hoisted(ct, KEY_STEPS)
    c = telemetry.snapshot().counters
    assert c["ks"] == len(calls) == {"rotate": 2, "multiply": 1,
                                     "rotate_hoisted": 3}[op]
    assert c.get("ks.decompose", 0) == (op == "rotate_hoisted")


def test_op_counts_carry_the_level_and_sum_to_outermost_calls(unit):
    ev, ct, ctx = unit["ev"], unit["ct"], unit["ctx"]
    top, g = ctx.L, ctx.rescale_limbs
    with telemetry.enable():
        m = ev.multiply_reduced_error(ct, ct)    # multiply, relinearize
        r = ev.rescale(m)
        ev.rotate(r, 1)                          # apply_galois inside
        half = ev.rescale_to_scale(ev.mul_const(r, 0.5), r.scale)
        ev.add_reduced_error(half, ct)           # mod_switch_drop, add
    s = telemetry.snapshot()
    ops = {k: v for k, v in s.counters.items() if k.startswith("op.")}
    assert ops == {f"op.multiply_reduced_error@{top}": 1,
                   f"op.rescale@{top}": 1, f"op.rotate@{top - g}": 1,
                   f"op.mul_const@{top - g}": 1,
                   f"op.rescale_to_scale@{top - g}": 1,
                   f"op.add_reduced_error@{top - 2 * g}": 1}
    assert sum(ops.values()) == 6
    assert len([sp for sp in s.spans if sp.name.startswith("op.")]) == 6


def test_mask_cache_hits_and_fresh_views_miss(unit):
    """A second ``apply_lt`` over the same plan finds every mask; a mask
    indexed from a 2-D array anew per call is a fresh numpy view, keyed by
    its id(), and misses every time."""
    B, ct, slots = unit["B"], unit["ct"], unit["ctx"].params.slots
    rng = np.random.default_rng(1)
    diags = {r: rng.uniform(-1, 1, slots) for r in (0, 1, 2, 5)}
    plan = LTSpec(slots=slots, n_src=1, n_dst=1, diagonals={
        (r, 0, 0): v for r, v in diags.items()}).bsgs_plan()
    with telemetry.enable():
        apply_lt(B, plan, [ct])
        first = dict(telemetry.snapshot().counters)
        apply_lt(B, plan, [ct])
        second = telemetry.snapshot().counters
    n = first["mask.lookups"]
    assert n >= 4 and first.get("mask.hits", 0) < n
    assert second["mask.lookups"] == 2 * n
    assert second["mask.hits"] - first.get("mask.hits", 0) == n
    telemetry.reset()
    masks = rng.uniform(-1, 1, (2, slots))
    with telemetry.enable():
        B.add_plain(ct, masks[0])
        B.add_plain(ct, masks[0])
    s = telemetry.snapshot()
    assert s.counters["mask.lookups"] == 2
    assert s.counters.get("mask.hits", 0) == 0
    assert [sp.name for sp in s.spans].count("encode") == 2


# Decryptor.decrypt's spans, make_plain's, encrypt_symmetric's.
PARTS = ["decrypt.device", "decrypt.decode", "refresh.encode",
         "encrypt.sample", "encrypt.device", "encrypt.sample",
         "encrypt.device"]


@pytest.mark.parametrize("batch", [1, 2])
def test_refresh_parts_nest_under_it(unit, batch):
    ev, ct = unit["ev"], unit["ct"]
    x = stack_cts([ct] * batch) if batch > 1 else ct
    with telemetry.enable():
        out = fake_bootstrap(x, unit["dec"], unit["enc"], ev, unit["ctx"].L)
    spans = telemetry.snapshot().spans
    [refresh] = [s for s in spans if s.name == "refresh"]
    kids = [s for s in spans if s.parent == refresh.id]
    assert [s.name for s in kids] == PARTS * batch
    assert sum(s.t1 - s.t0 for s in kids) <= refresh.t1 - refresh.t0
    assert refresh.synced and refresh.root == refresh.id
    got = unit["B"].to_slots(out)
    assert np.abs(got - unit["x"]).max() < 1e-6


def test_refresh_is_decrypt_then_encrypt_symmetric(unit):
    """Recorded, the refresh is still ``make_plain(dec.decrypt(ct))``
    then ``encrypt_symmetric``: the same words."""
    ctx, ev, ct, dec = unit["ctx"], unit["ev"], unit["ct"], unit["dec"]
    kg = KeyGenerator(ctx, seed=3)
    pt = ev.make_plain(dec.decrypt(ct), ctx.params.scale, ctx.L)
    want = Encryptor(ctx, secret=kg.secret, seed=9).encrypt_symmetric(pt)
    with telemetry.enable():
        got = fake_bootstrap(ct, dec, Encryptor(ctx, secret=kg.secret,
                                                seed=9), ev, ctx.L)
    assert torch.equal(got.data, want.data) and got.scale == want.scale


def test_sealed_program_keeps_its_warm_pass_counts(unit):
    """With the recorder off, a sealed call's warm pass still counts its
    ops and key switches into its program (each card replay adds them);
    its masks' lookups are not kept (a replay looks up none)."""
    B, ct = unit["B"], unit["ct"]
    mask = np.random.default_rng(2).uniform(-1, 1, unit["ctx"].params.slots)

    def fn(xs):
        return [B.rotate(B.mul_plain(xs[0], mask), 1)]

    with telemetry.enable():
        fn([ct])
    eager = {k: v for k, v in telemetry.snapshot().counters.items()
             if k.startswith(telemetry.REPLAYED)}
    telemetry.reset()
    jf = jit_sealed(B, fn, [ct])
    [prog] = jf.programs.values()
    assert prog.counts == eager and eager["ks"] == 1
    assert not any(k.startswith("mask.") for k in prog.counts)
    assert telemetry.snapshot().counters == {}
    with telemetry.enable(), telemetry.muted():
        fn([ct])
    assert telemetry.snapshot().counters == {}


def test_export_writes_a_chrome_trace(unit, tmp_path):
    path = tmp_path / "trace.json"
    with telemetry.trace(path) as summary:
        _ops(unit)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert events and all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert {e["name"] for e in events} >= {"op.rotate", "refresh"}
    assert doc["counters"]["ks"] == 2 and doc["dropped"] == 0
    assert doc["idle_by_span"] == summary["idle_by_span"] == []
    assert not telemetry.recording()


def _span(name, t0, t1):
    return telemetry.Span(name, t0, t1)


def test_idle_gaps_go_to_the_innermost_span():
    spans = [_span("outer", 0, 100), _span("inner", 12, 18),
             _span("late", 150, 160)]
    busy = [(0, 10), (20, 30), (120, 130)]
    got = dict(telemetry.idle_by_span(spans, busy, 0, 200))
    # (10, 20) mid 15: inner; (30, 120) mid 75: outer; (130, 200) mid
    # 165: no span.
    assert got == pytest.approx({"inner": 10e-9, "outer": 90e-9,
                                 "python": 70e-9})


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_SPANS", 3)
    with telemetry.enable():
        for i in range(5):
            with telemetry.span(f"s{i}"):
                pass
    s = telemetry.snapshot()
    assert [sp.name for sp in s.spans] == ["s0", "s1", "s2"]
    assert s.dropped == 2


def test_resnet_session_times_bootstraps_from_the_recorder():
    """``run_resnet.build_session`` leaves the backend's ``bootstrap``
    method alone; a bootstrap with the recorder off leaves
    ``Session.boot_times`` empty, one with it on adds its synchronized
    wall, with its ten stages (and the entry's ops) as children."""
    from fhe_gpt2_tpu_torch import run_resnet
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.nn import kernels as K

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        w = R.synthetic_weights(np.random.default_rng(0), 8)
        sign = K.SignPlans.from_composite(dp_schedule(2.0 ** -10,
                                                      2.0 ** -8))
        rp = R.build_resnet_plans(w, 8, 512, h=4, relu_bound=10.0,
                                  sign=sign)
        a = run_resnet.parse_args([
            "--composite", "--logn", "10", "--levels", "24",
            "--log-scale", "50", "--nsp", "4", "--hamming", "16",
            "--real-boot", "--digit-keys", "--boot-factors", "3", "--cpu"])
        img = np.random.default_rng(1).uniform(-1, 1, (3, 4, 4))
        ses = run_resnet.build_session(a, rp, img)
        B = ses.B
        assert B.boot is not None and "bootstrap" not in vars(B)
        v = np.random.default_rng(2).uniform(-0.5, 0.5, B.slots)
        ct = B.from_slots(v, level=B.ctx.base_limbs + 2)
        B.bootstrap(ct)
        assert ses.boot_times == [] and telemetry.snapshot().spans == []
        with telemetry.enable():
            out = B.bootstrap(ct)
    finally:
        torch.set_num_threads(threads)
    [wall] = ses.boot_times
    spans = telemetry.snapshot().spans
    [boot] = [s for s in spans if s.name == "bootstrap"]
    assert wall == boot.ms / 1e3 > 0 and boot.level == ct.level
    stages = [s for s in spans
              if s.parent == boot.id and s.name.startswith("boot.")]
    assert [s.name for s in stages] == list(B.boot.stage_spans)
    assert [s.index for s in stages] == list(range(len(stages)))
    assert len(stages) == 10
    assert telemetry.snapshot().counters["ks"] > 0
    assert np.abs(B.to_slots(out) - v).max() < 1e-3
    ses.clear_boot_times()
    assert ses.boot_times == []


def test_only_records_the_named_spans(unit):
    """``enable(only=...)`` records those spans alone: no op span, no
    counter, no marker; a full ``enable()`` inside it records all."""
    with telemetry.enable(only=("bootstrap", "refresh")):
        assert not telemetry.recording()
        _ops(unit)
        with telemetry.span("bootstrap", sync=True):
            unit["ev"].add(unit["ct"], unit["ct"])
        inner = len(telemetry.snapshot().spans)
        with telemetry.enable():
            unit["ev"].add(unit["ct"], unit["ct"])
    s = telemetry.snapshot()
    assert [sp.name for sp in s.spans[:inner]] == ["refresh", "bootstrap"]
    assert [sp.name for sp in s.spans[inner:]] == ["op.add"]
    assert s.counters == {"op.add@%d" % unit["ctx"].L: 1, "dyadic.calls": 1}
    assert s.spans[1].synced and s.spans[1].device_ms is None
    n = len(s.spans)
    with telemetry.span("bootstrap"):
        pass
    assert len(telemetry.snapshot().spans) == n


def test_boot_times_are_the_sessions_own(monkeypatch):
    """``Session.boot_times`` holds the synchronized ``bootstrap`` spans of
    its own thread since its mark: not another thread's, not an unsynced
    one, and still its own after a ``reset()``; it raises once spans were
    dropped."""
    from fhe_gpt2_tpu_torch.run_resnet import Session

    def boot(sync=True):
        with telemetry.span("bootstrap", sync=sync):
            time.sleep(0.001)

    with telemetry.enable(only=("bootstrap",)):
        boot()
        ses = Session(ctx=None, kg=None, B=None, dec=None, keygen_s=0.0,
                      galois_keys=0)
        ses.clear_boot_times()
        boot()
        boot(sync=False)
        other = threading.Thread(target=boot)
        other.start()
        other.join(timeout=60)
        assert len(ses.boot_times) == 1 and ses.boot_times[0] >= 1e-3
        telemetry.reset()
        assert ses.boot_times == []
        boot()
        assert len(ses.boot_times) == 1
        ses.clear_boot_times()
        assert ses.boot_times == []
    telemetry.reset()
    monkeypatch.setattr(telemetry, "MAX_SPANS", 0)
    with telemetry.enable(only=("bootstrap",)):
        boot()
    with pytest.raises(RuntimeError, match="dropped 1"):
        ses.boot_times
