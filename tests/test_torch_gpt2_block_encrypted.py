"""The port's encrypted GPT-2 block and ln_f (nn/model.py forward on the
CkksBackend) held against the JAX package's eager run on the CPU, end to
end: the whole-block comparison of which tests/test_torch_gpt2_{ln,attn,
attn_back,mlp}_encrypted.py hold the parts in tier-1.

``slow``: the JAX package runs the block op by op and compiles every op at
every new level and batch shape, which takes it several minutes on a CPU
host; the parts each take under a minute and a half.

The model is the card tests' toy GPT-2 (tests/test_torch_cuda.py
GPT2_TOY: run_gpt2 --weights synthetic --newton-inits rowmax at 32 wide, 4
heads, seq 16, 4 Newton iterations) on both packages' plans, on
torch_gpt2_common's encrypted set-up with 10 level pairs. Tolerance:
exact (``array_equal`` ciphertexts, equal scales and refresh levels); the
decrypts within 1e-3 of the plain run.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import model as jM

from fhe_gpt2_tpu_torch import run_gpt2
from fhe_gpt2_tpu_torch.nn import model as M
from fhe_gpt2_tpu_torch.nn.backend import RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, count_refreshes, \
    encrypted_backends
from torch_port_common import same_cts, single_torch_thread  # noqa: F401

TOY = ["--layers", "1", "--logn", "10", "--ln-iters", "4", "--weights",
       "synthetic", "--newton-inits", "rowmax", "--cpu"]


@pytest.mark.slow
def test_whole_block_equals_reference():
    m = run_gpt2.load_model(run_gpt2.parse_args(TOY))
    assert m.sh == ENC_SH
    kw = dict(newton_inits=M.rowmax_newton_inits(m.weights, m.ids, 1, 4),
              attn_overrides=m.knobs.as_overrides(), ln_iters=4)
    jplans = jM.build_gpt2_plans(ENC_JSH, m.weights, 1, **kw)
    rec = RecordingBackend(ENC_SH.slots)
    M.forward(rec, list(ENC_SH.act.pack(m.emb)), m.plans)
    B, jB = encrypted_backends(rec.key_steps(), num_levels=10)
    xs = [B.from_slots(v) for v in ENC_SH.act.pack(m.emb)]
    jxs = [jB.from_slots(v) for v in ENC_SH.act.pack(m.emb)]
    seen, jseen = count_refreshes(B), count_refreshes(jB)
    out = M.forward(B, xs, m.plans)
    jout = jM.forward(jB, jxs, jplans)
    same_cts(out, jout, "block + ln_f")
    assert seen == jseen and len(seen) > 0
    got = ENC_SH.act.unpack(np.stack([B.to_slots(o) for o in out]))
    assert np.abs(got - run_gpt2.plain_forward(m)).max() < 1e-3
