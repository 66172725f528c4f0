"""A mesh position's share of the RNS limbs: its view of the context, its
key rows, and the exchanges among the positions of one data row.

The JAX package leaves the limb axis to XLA's SPMD partitioner
(``fhe_gpt2_tpu/parallel/mesh.py``). Here every position runs the port's
own eager program (evaluator, backend, LT engine, bootstrapper, unchanged)
in a thread of its own against a ``LimbView``: the context restricted to
the limbs it holds. Limb i lies at limb position i % n_limb (round robin),
so a rescale only removes rows where the dropped limbs lie, no limb ever
moves between positions, and every level stays balanced.

Three places cross limbs, and the view answers each with one exchange
among the positions of its data row (``LimbGroup``):

  * the key switch (relinearize, rotations) and the hoisted decomposition
    read every limb below the level for the base conversion:
    ``gather_limbs``, an all-gather of c, after which each position
    switches into its own key rows (its data limbs and the k specials);
  * a rescale divides by the trailing limb or pair: ``with_trailing``, a
    broadcast from the positions that hold them;
  * ModRaise reads the base limbs: ``with_trailing`` at the base level.

Everything else is per limb and runs on the position's rows alone.
"""

from __future__ import annotations

import threading
from dataclasses import fields, replace

import torch

from ..core.context import CkksContext
from ..core.keys import KSwitchKey
from ..core.ntt import NttTables


def record(device: torch.device):
    """An event on this thread's current stream of a card (None on the
    CPU, where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def after(ev, *devices: torch.device) -> None:
    """Make this thread's current stream of each device wait for ev."""
    if ev is not None:
        for d in set(devices):
            torch.cuda.current_stream(d).wait_event(ev)


class LimbGroup:
    """The positions of one data row, which exchange limbs.

    In an exchange every position publishes a tensor, reads what it needs
    of the others', and goes on only when every reader is done. On a card
    each position runs on its own stream: a reader's streams wait on an
    event the publisher recorded after making its tensor (the reads of a
    tensor on another card run on that card's current stream of the
    reader's thread, ``Tensor.copy_``), and the publisher's stream waits on
    an event each reader recorded after its reads, so no later kernel of
    the publisher's can reuse the tensor's memory before they are done.
    A failed position aborts the barrier, and every wait on it then
    raises ``threading.BrokenBarrierError`` in place of hanging."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: list = [None] * n
        self.done: list = [None] * n

    def abort(self) -> None:
        self.barrier.abort()

    def exchange(self, pos: int, x: torch.Tensor, take):
        """Publish x as position pos's and return take(peers), where
        peers[p] is position p's tensor, ready to read on this thread's
        streams. take must copy what it keeps."""
        dev = x.device
        self.slots[pos] = (x, record(dev))
        self.barrier.wait()
        peers = []
        for p, (y, ev) in enumerate(self.slots):
            if p != pos:
                after(ev, dev, y.device)
            peers.append(y)
        out = take(peers)
        self.done[pos] = record(dev)
        self.barrier.wait()
        for p, ev in enumerate(self.done):
            if p != pos:
                after(ev, dev)
        return out


def tables_on(t: NttTables, device: torch.device) -> NttTables:
    """NTT tables with every tensor on device (t itself if they are)."""
    if t.device == device:
        return t
    return replace(t, **{f.name: getattr(t, f.name).to(device)
                         for f in fields(t)
                         if isinstance(getattr(t, f.name), torch.Tensor)})


class LimbView(CkksContext):
    """The context of one mesh position on a limb axis of n_limb
    positions: the chain's host state (moduli, levels, digit groups,
    slot maps), and tables over the data limbs i = position (mod n_limb)
    and the special limbs on its device. Every accessor that takes a
    level answers for those limbs (``data_limbs``): the NTT, key-switch,
    mod-down, rescale and lift tables, the key rows and the constants.
    ``shared`` is (full NTT tables, level tables, cache), held by every
    view of the same device and limb position: two data rows on one card
    build and hold them once. ``group`` is the position's data row, set
    by ``MeshEvaluator.run``."""

    def __init__(self, ctx: CkksContext, device: torch.device, position: int,
                 n_limb: int, shared: tuple):
        vars(self).update(vars(ctx))
        self.device = device
        self.position, self.n_limb = position, n_limb
        self.ntt_all, self._level_tables, self._cache = shared
        self.group: LimbGroup | None = None

    def data_limbs(self, level: int) -> tuple[int, ...]:
        return tuple(range(self.position, level, self.n_limb))

    def gather_limbs(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if self.n_limb == 1:
            return x
        n = self.n_limb

        def take(peers):
            full = x.new_empty((*x.shape[:-2], level, x.shape[-1]))
            for p, y in enumerate(peers):
                full[..., p::n, :].copy_(y)
            return full
        return self.group.exchange(self.position, x, take)

    def with_trailing(self, x: torch.Tensor, level: int,
                      g: int) -> torch.Tensor:
        if self.n_limb == 1:
            return x
        n = self.n_limb
        keep = x[..., :len(self.data_limbs(level - g)), :]

        def take(peers):
            # Limb i is row i // n of position i % n.
            rows = [peers[i % n][..., i // n:i // n + 1, :].to(x.device)
                    for i in range(level - g, level)]
            return torch.cat([keep, *rows], dim=-2)
        return self.group.exchange(self.position, x, take)


def limb_key(key: KSwitchKey, limbs: tuple, device: torch.device) -> KSwitchKey:
    """The rows of a whole key-switching key [D, 2, L+k, N] for the chain
    limbs `limbs` (a view's ``key_limbs(L)``), on device."""
    if key.limbs is not None:
        raise ValueError("limb_key takes a whole key")
    idx = torch.as_tensor(limbs, dtype=torch.long, device=key.data.device)
    return KSwitchKey(key.data.index_select(2, idx).to(device), limbs=limbs)
