"""Shared set-up of the port's Granite 4.0-H tests
(tests/test_torch_granite_*.py).

``CFG`` is the published configuration at width 32 (``small_config``):
two inner groups of 32, 8 Mamba heads of 8, state 8, 4 query heads of 8
over 1 K/V head, a SwiGLU of 128, and the published period M×9, A as its
10 layer types. ``case`` draws its weights and an embedded sequence of
``SEQ`` tokens; ``backend`` builds the port's CkksBackend on a composite
uint32 chain at logN = 9 (256 slots: rows of 32 at a stride of 64, 4 a
ciphertext, so 8 tokens are 2 ciphertexts), short (10 pairs) so that the
decrypt/re-encrypt refresh runs on the way, as on the card's 39.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.nn import granite as G
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend

SEQ = 8
LOGN = 9
SLOTS = 1 << (LOGN - 1)
CFG = G.small_config(32, 10)
CFG["layer_types"] = G.PUBLISHED["layer_types"][6:16]       # M×9, A
CHAIN = dict(logn=LOGN, num_levels=10, log_scale=54, log_q0=59,
             log_special=31, num_special=4, hamming_weight=16)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def case(seed: int = 0, cfg: dict = CFG) -> tuple:
    """(weights, embedded input [SEQ, hidden]) from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    w = G.synthetic_weights(rng, cfg)
    ids = rng.integers(0, cfg["vocab_size"], SEQ)
    x = G.get(w, "embed_tokens.weight")[ids] * cfg["embedding_multiplier"]
    return w, x


def backend(key_steps, **chain) -> CkksBackend:
    """The port's CkksBackend on CHAIN (updated by ``chain``): keys from
    seed 1 (relinearization, the Galois steps, conjugation), encryptions
    from seed 2, the decrypt/re-encrypt refresh to the chain top."""
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator

    ctx = CkksContext(CkksParams.create_composite(**dict(CHAIN, **chain)),
                      device="cpu")
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(sorted(key_steps),
                                              conjugate=True))
    return CkksBackend(ctx=ctx, ev=ev, enc=Encryptor(ctx, secret=kg.secret,
                                                     seed=2),
                       dec=Decryptor(ctx, kg.secret), default_level=ctx.L)


def decrypt_all(B, ct) -> np.ndarray:
    """Slot values of a ciphertext with any number of batch axes."""
    if ct.data.ndim <= 3:
        return B.to_slots(ct)
    return np.stack([decrypt_all(B, c) for c in B.unstack(ct)])
