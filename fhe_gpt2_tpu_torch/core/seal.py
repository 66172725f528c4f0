"""The state of one sealed call while its function runs.

``nn/backend.py`` ``jit_sealed`` runs a function three ways: once eagerly
(the warm pass, which fills its caches), once under CUDA-graph capture on
the card, and on the CPU again eagerly on every later call. In the last two
nothing may come from the host: a graph bakes in the address of every
tensor it reads, and a host copy inside a capture fails. So while a sealed
call runs, every cache that a host copy could fill answers through its
``Seal``:

  * in the warm pass (``sealed`` False) a miss builds and stores the entry;
  * afterwards (``sealed`` True) a miss raises ``SealedCacheMiss``.

The seal holds the call's own device constants (``consts``: the residues of
``add_const``/``mul_const_int`` keyed by ``(m, level)``, gather indices by
content; ``device_constant``), its evaluator-level
encodings (``encodes``, in call order), its masks (``plains``, the
backend's cache keys), and references to the key slices its program reads
(``keep``), so that no cache eviction frees a tensor a graph reads. Under
sequential keys it counts the call's mask keys (``seq``), so that a call
on one thread leaves the keys of another thread's masks alone.

``current()`` is the seal of this thread's running sealed call, or None.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class SealedCacheMiss(RuntimeError):
    """A sealed call asked for a host-made tensor its warm pass did not
    make: on the card that would be a host copy inside a graph."""


class Seal:
    def __init__(self):
        self.sealed = False
        self.consts: dict = {}          # key -> device constant
        self.encodes: dict = {}         # (kind, n, level, scale) -> Plaintext
        self.plains: dict = {}          # the backend's mask keys -> Plaintext
        self.keep: dict = {}            # id -> tensor the program reads
        self.n_encodes = 0
        self.seq: list | None = None    # the mask-key counter (seq_keys)

    def start(self, sealed: bool, seq_keys: bool = False) -> None:
        """Begin one run of the function: the warm pass or a sealed run,
        its mask keys sequential (counted here) or by array identity."""
        self.sealed = sealed
        self.n_encodes = 0
        self.seq = [0] if seq_keys else None

    def miss(self, what: str) -> None:
        if self.sealed:
            raise SealedCacheMiss(
                f"sealed call: {what} was not made by the warm pass (a host "
                f"copy inside the sealed program)")

    def hold(self, t) -> None:
        self.keep[id(t)] = t


_local = threading.local()


def host_copy(what: str) -> None:
    """Raise if a sealed call is running sealed: the host copy `what` would
    fail inside a capture (on the CPU the sealed run raises the same)."""
    s = current()
    if s is not None and s.sealed:
        raise SealedCacheMiss(f"sealed call: {what} copies between the host "
                              f"and the device inside the sealed program")


def current() -> Seal | None:
    return getattr(_local, "seal", None)


def device_constant(key, what: str, build):
    """build(), a tensor copied from the host; inside a sealed call the
    call's own copy under key (which must determine its value), made by the
    warm pass."""
    s = current()
    if s is None:
        return build()
    t = s.consts.get(key)
    if t is None:
        s.miss(what)
        t = s.consts[key] = build()
    return t


@contextmanager
def using(seal: Seal | None):
    """Run the body with `seal` as this thread's current seal (None: no
    sealed call, as outside any)."""
    prev = current()
    _local.seal = seal
    try:
        yield seal
    finally:
        _local.seal = prev
