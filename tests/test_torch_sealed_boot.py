"""The port's staged sealed bootstrap (boot/bootstrap.py
``Bootstrapper.bootstrap_jitted``) held against its eager bootstrap on the
CPU, on the smallest bootstrap of the port's CPU tests (torch_port_common
``build_port``: logN=10, 46 limbs, 64 sparse slots), which
tests/test_torch_boot*.py hold stage by stage against the JAX package.

The first call is every stage's warm pass; the second, on another
ciphertext, runs every stage sealed over its own caches (what the card
replays as CUDA graphs). Tolerance: exact (``torch.equal`` words, equal
scales and levels), and the decrypt within the bootstrap's bounds.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.nn.backend import SealedCall

from torch_port_common import NS, build_port, \
    single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port():
    return build_port()


def _entry(ctx, ev, enc, seed):
    z = np.random.default_rng(seed).uniform(-1, 1, NS)
    return z, enc.encrypt(ev.make_plain(z, ctx.params.scale,
                                        ctx.base_limbs))


def test_bootstrap_jitted_equals_bootstrap(port):
    ctx, ev, enc, dec, boot = port
    z, ct = _entry(ctx, ev, enc, 5)
    want = boot.bootstrap(ct)
    got = boot.bootstrap_jitted(ct)
    assert (got.scale, got.level) == (want.scale, want.level)
    assert torch.equal(got.data, want.data)
    stages = boot._staged_jit
    assert len(stages) == len(boot.stages())
    assert all(isinstance(c, SealedCall) and len(c.programs) == 1
               and not c.seq_keys for c in stages)
    # Another ciphertext through the sealed stages.
    z2, ct2 = _entry(ctx, ev, enc, 6)
    got = boot.bootstrap_jitted(ct2)
    want = boot.bootstrap(ct2)
    assert (got.scale, got.level) == (want.scale, want.level)
    assert torch.equal(got.data, want.data)
    assert all(len(c.programs) == 1 for c in stages)
    err = np.abs(np.real(dec.decrypt(got, num_slots=NS)) - z2)
    assert err.mean() < 5e-4 and err.max() < 2e-3, (err.mean(), err.max())
    # EvalMod's constants are the stage's own, made by its warm pass.
    evalmod = dict(zip([n for n, _ in boot.stages()], stages))["evalmod"]
    [prog] = evalmod.programs.values()
    assert len(prog.seal.consts) > 0 and prog.seal.sealed


def test_backend_bootstrap_stays_eager_on_the_cpu(port):
    """CkksBackend.bootstrap takes bootstrap_jitted for a ciphertext on the
    card only: on the CPU it calls the eager bootstrap. A copy of the
    Bootstrapper on another backend (a mesh position's) does not inherit
    the sealed stages."""
    ctx, ev, enc, dec, boot = port
    _, ct = _entry(ctx, ev, enc, 7)
    calls = []
    B = boot.B
    B.boot = boot
    boot.bootstrap = lambda c, **kw: calls.append("eager") or c
    boot.bootstrap_jitted = lambda c: calls.append("sealed") or c
    try:
        assert B.bootstrap(ct) is ct
    finally:
        del boot.bootstrap, boot.bootstrap_jitted
        B.boot = None
    assert calls == ["eager"]
    assert hasattr(boot, "_staged_jit")
    assert not hasattr(boot.on(B), "_staged_jit")


class _OnCard:
    """Stands for a tensor on the card: all that CkksBackend's choice of
    bootstrap reads."""
    is_cuda = True


def test_mesh_position_bootstraps_eagerly(port):
    """A backend whose bootstrapper is a mesh position's copy
    (``Bootstrapper.on``) takes the eager bootstrap even for a ciphertext
    on the card, where the bootstrapper it was copied from takes the
    sealed one; the copy's bootstrap_jitted refuses."""
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    ctx, ev, enc, dec, boot = port
    _, ct = _entry(ctx, ev, enc, 8)
    card = Ciphertext(_OnCard(), ct.scale, ct.level)
    B = boot.B
    pB = CkksBackend(ctx=ctx, ev=ev, default_level=ctx.L)
    pB.boot = boot.on(pB)
    B.boot = boot
    try:
        assert B._boot_sealed(card) and not B._boot_sealed(ct)
        assert pB.boot.eager_only and not pB._boot_sealed(card)
        calls = []
        pB.boot.bootstrap = lambda c, **kw: calls.append("eager") or c
        pB.boot.bootstrap_jitted = lambda c: calls.append("sealed") or c
        assert pB.bootstrap(card) is card
        assert calls == ["eager"]
        del pB.boot.bootstrap_jitted
        with pytest.raises(ValueError, match="mesh position"):
            pB.boot.bootstrap_jitted(ct)
    finally:
        B.boot = None
