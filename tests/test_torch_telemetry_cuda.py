"""The recorder (fhe_gpt2_tpu_torch/utils/telemetry.py) over a sealed
bootstrap on the card.

A graph replay calls no Python, so its op, key-switch, MAC and dyadic
counts are the ones its stages' warm passes recorded (every MAC and dyadic
call on the card launching its kernel): a replayed bootstrap must add
exactly what one eager bootstrap counts. Its stages' CUDA events must
resolve, and their device ms must cover the synchronized host wall of the
bootstrap. Skips without a card; imports neither jax nor fhe_gpt2_tpu:

    python -m pytest tests/test_torch_telemetry_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
from fhe_gpt2_tpu_torch.utils import telemetry

pytestmark = pytest.mark.cuda

# The composite chain of the port's CPU bootstrap tests: logN=10, 22 level
# pairs, two special primes, h=16, 64 sparse slots, K=12 / degree 45.
NS = 64
PARAMS = dict(logn=10, num_levels=22, log_scale=50, log_q0=55, log_special=31,
              num_special=2, hamming_weight=16, sparse_slots=NS)


@pytest.fixture(scope="module")
def boot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    params = CkksParams.create_composite(**PARAMS)
    ctx = CkksContext(params, device="cuda")
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=None, default_level=ctx.L)
    eps = params.scale / ctx.q0_float
    B.boot = Bootstrapper(B, num_slots=NS, evalmod=make_evalmod(
        K=12, eps=max(eps * 1.05, 2 ** -5), degree=45, arcsin_degree=3,
        prec_dps=60))
    ev.galois_keys = kg.galois_keys(steps=B.boot.required_steps(),
                                    conjugate=True)
    x = np.random.default_rng(5).uniform(-1, 1, NS)
    ct = enc.encrypt(ev.make_plain(x, params.scale, ctx.base_limbs))
    return B, ct, Decryptor(ctx, kg.secret), x


def _counts():
    return {k: v for k, v in telemetry.snapshot().counters.items()
            if k.startswith(telemetry.REPLAYED)}


def test_sealed_replay_counts_and_times_one_bootstrap(boot):
    B, ct, dec, x = boot
    telemetry.reset()
    B.bootstrap(ct)                    # warm passes and captures, unrecorded
    torch.cuda.synchronize()
    assert telemetry.snapshot().spans == []
    with telemetry.enable():
        B.boot.bootstrap(ct)           # eager
        torch.cuda.synchronize()
    eager = _counts()
    telemetry.reset()
    with telemetry.enable():
        out = B.bootstrap(ct)          # sealed: every stage replayed
    replayed = _counts()
    assert eager["ks"] > 0 and replayed == eager
    assert eager["mac.kernel"] == eager["mac.calls"] > 0, eager
    assert eager["dyadic.kernel"] == eager["dyadic.calls"] > 0, eager
    spans = telemetry.snapshot().spans
    [whole] = [s for s in spans if s.name == "bootstrap"]
    stages = [s for s in spans if s.name.startswith("boot.")]
    assert whole.synced and [s.name for s in stages] == list(
        B.boot.stage_spans)
    assert all(s.parent == whole.id and s.device_ms > 0 for s in stages)
    device = sum(s.device_ms for s in stages)
    assert device <= whole.device_ms * 1.001
    assert abs(device - whole.ms) <= 0.1 * whole.ms, (device, whole.ms)
    got = np.real(dec.decrypt(out, NS))
    assert np.abs(got - x).mean() < 1e-2
    telemetry.reset()
