"""Multi-device sharding for CKKS evaluation over a (data, limb) mesh of
torch devices: the counterpart of ``fhe_gpt2_tpu/parallel/mesh.py``, with
the collectives that XLA's SPMD partitioner inserts there written out.

  * ``data`` — the ciphertext batch axis (images, sequences, packed
    groups): pure data parallelism, no traffic between data rows.
  * ``limb`` — the RNS limb axis, limb i at limb position i % n_limb
    (``parallel/limbs.py``): a key switch gathers c across the limb axis
    and switches into each position's own key rows; a rescale broadcasts
    the dropped limb or pair. Keys and tables are held per limb position,
    so a card holds the key rows of its own data limbs and the k specials.

The JAX module's ``coeff`` axis has no counterpart: the NTT kernels keep a
limb's N words in one thread-block cluster.

``MeshEvaluator.run`` runs a function of an Evaluator and ciphertexts on
every position at once, one thread each (SPMD by thread): each position
runs the port's unchanged eager program against its ``LimbView``, on its
own device and stream (kernels and torch ops release the interpreter
lock). A mesh may name a device several times (a virtual mesh: the CPU
tests use repeated ``cpu`` devices; one card can hold several positions);
positions of one device and limb position share their tables and key
rows, and every position shares the host's canonical-embedding rounding
of a mask (``HostCoeffs``). Gathered results are the single-device
program's words.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..core.context import CkksContext, resolve_device
from ..core.evaluator import Ciphertext, Evaluator
from ..core.keys import GaloisKeys, KSwitchKey
from .limbs import LimbGroup, LimbView, after, limb_key, record, tables_on

# Seconds a position waits at an exchange for the others of its data row
# before the run fails (a position that raises fails it at once).
TIMEOUT = 600.0


class Mesh:
    """A [n_data, n_limb] array of torch devices, axes ("data", "limb")."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def n_data(self) -> int:
        return self.devices.shape[0]

    @property
    def n_limb(self) -> int:
        return self.devices.shape[1]

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "limb": self.n_limb}

    def positions(self) -> list[tuple[int, int, torch.device]]:
        """(data row, limb position, device) of every position, row-major:
        position i is (i // n_limb, i % n_limb)."""
        return [(d, p, self.devices[d, p]) for d in range(self.n_data)
                for p in range(self.n_limb)]


def make_mesh(n_data: int = 1, n_limb: int = 1, devices=None) -> Mesh:
    """The first n_data·n_limb of `devices` (default: every CUDA card,
    which raises where there is none) as a [n_data, n_limb] mesh. A device
    may be named several times."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    assert n_data * n_limb <= len(devices)
    if len({d.type for d in devices}) != 1:
        raise ValueError("a mesh holds devices of one type")
    dev = np.empty(n_data * n_limb, dtype=object)
    dev[:] = devices[: n_data * n_limb]
    return Mesh(dev.reshape(n_data, n_limb))


@dataclass(frozen=True)
class Layout:
    """Where the words [k, *batch, l, N] of a ciphertext lie on a mesh:
    the first batch axis split over ``data`` (else every data row holds
    the whole batch), the limbs over ``limb`` by round robin (else every
    limb position holds every limb), the coefficients local."""

    mesh: Mesh
    data: bool
    limb: bool


def ct_sharding(mesh: Mesh, batch_ndim: int = 1) -> Layout:
    """Ciphertext layout: batch over 'data', limbs over 'limb',
    coefficients local (an unbatched ciphertext is whole on every data
    row)."""
    return Layout(mesh, data=batch_ndim > 0, limb=True)


def replicated(mesh: Mesh) -> Layout:
    """Every position holds the whole ciphertext."""
    return Layout(mesh, data=False, limb=False)


@dataclass
class ShardedCiphertext:
    """A ciphertext as per-position shards (row-major, ``Mesh.positions``)
    in `layout`; each shard is a Ciphertext at the chain level `level`."""

    shards: list
    layout: Layout
    scale: float
    level: int

    @property
    def mesh(self) -> Mesh:
        return self.layout.mesh


def _shard(data: torch.Tensor, layout: Layout, d: int, p: int) -> torch.Tensor:
    """Position (d, p)'s part of whole words in layout."""
    mesh = layout.mesh
    if layout.data:
        data = data.tensor_split(mesh.n_data, dim=1)[d]
    if layout.limb:
        data = data[..., p::mesh.n_limb, :]
    return data


def shard_ciphertext(ct: Ciphertext, mesh: Mesh,
                     layout: Layout | None = None) -> ShardedCiphertext:
    """Place a Ciphertext's data according to the default layout
    (``ct_sharding``), or `layout`."""
    if ct.data.shape[-2] != ct.level:
        raise ValueError("shard_ciphertext takes a whole ciphertext")
    layout = layout or ct_sharding(mesh, ct.data.ndim - 3)
    shards = [Ciphertext(_shard(ct.data, layout, d, p).to(dev).contiguous(),
                         ct.scale, ct.level)
              for d, p, dev in mesh.positions()]
    return ShardedCiphertext(shards, layout, ct.scale, ct.level)


def gather_ciphertext(sct: ShardedCiphertext,
                      device: torch.device | None = None) -> Ciphertext:
    """The whole ciphertext on `device` (default: position 0's): the
    inverse of ``shard_ciphertext``."""
    mesh, lay = sct.mesh, sct.layout
    device = device or sct.shards[0].data.device
    rows = []
    for d in range(mesh.n_data if lay.data else 1):
        parts = [sct.shards[d * mesh.n_limb + p].data
                 for p in range(mesh.n_limb if lay.limb else 1)]
        if not lay.limb:
            rows.append(parts[0].to(device))
            continue
        x = parts[0]
        full = torch.empty((*x.shape[:-2], sct.level, x.shape[-1]),
                           dtype=x.dtype, device=device)
        for p, y in enumerate(parts):
            full[..., p::mesh.n_limb, :] = y.to(device)
        rows.append(full)
    data = torch.cat(rows, dim=1) if lay.data else rows[0]
    return Ciphertext(data, sct.scale, sct.level)


class HostCoeffs:
    """Host encodings shared by the positions of a mesh. Every position
    reduces the same integer coefficients of a slot vector modulo its own
    limbs, so the canonical-embedding rounding, the host's part of an
    encoding, runs once per (vector, scale) and not once per position.
    Keyed by the vector's identity, which the entry pins (a recycled id
    can never hit it); the positions encode in near lockstep, so the
    latest `size` entries are kept. The first position to ask computes;
    the others wait for its result."""

    def __init__(self, size: int = 256):
        self.size = size
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def get(self, values, scale: float, make) -> np.ndarray:
        key = (id(values), float(scale))
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                fut = Future()
                self._entries[key] = (values, fut)
                while len(self._entries) > self.size:
                    self._entries.popitem(last=False)
            else:
                self._entries.move_to_end(key)
                fut = hit[1]
        if hit is None:
            try:
                fut.set_result(make())
            except BaseException as e:
                fut.set_exception(e)
                raise
        return fut.result()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class PositionEvaluator(Evaluator):
    """An Evaluator over a mesh position's LimbView, whose host encodings
    come from the mesh's shared HostCoeffs."""

    def __init__(self, ctx: LimbView, coeffs: HostCoeffs, **keys):
        super().__init__(ctx, **keys)
        self.coeffs = coeffs

    def _host_coeffs(self, values, scale: float) -> np.ndarray:
        return self.coeffs.get(values, scale,
                               lambda: super(PositionEvaluator, self)
                               ._host_coeffs(values, scale))


class MeshEvaluator:
    """One PositionEvaluator per position of a mesh, over one whole
    context and its keys (``evaluators``, row-major), and ``run`` to drive
    them together. Each (device, limb position) gets the tables and the
    key rows of its limbs once."""

    def __init__(self, mesh: Mesh, ctx: CkksContext,
                 relin_key: KSwitchKey | None = None,
                 galois_keys: GaloisKeys | None = None,
                 timeout: float = TIMEOUT):
        self.mesh, self.ctx, self.timeout = mesh, ctx, timeout
        self.coeffs = HostCoeffs()
        held: dict = {}
        self.evaluators: list[PositionEvaluator] = []
        self._streams = []
        for _, p, dev in mesh.positions():
            if (dev, p) not in held:
                shared = (tables_on(ctx.ntt_all, dev), {}, {})
                limbs = LimbView(ctx, dev, p, mesh.n_limb,
                                 shared).key_limbs(ctx.L)
                keys = dict(
                    relin_key=relin_key and limb_key(relin_key, limbs, dev),
                    galois_keys=galois_keys and GaloisKeys(keys={
                        e: limb_key(k, limbs, dev)
                        for e, k in galois_keys.keys.items()}))
                held[dev, p] = shared, keys
            shared, keys = held[dev, p]
            view = LimbView(ctx, dev, p, mesh.n_limb, shared)
            self.evaluators.append(PositionEvaluator(view, self.coeffs,
                                                     **keys))
            self._streams.append(torch.cuda.Stream(device=dev)
                                 if dev.type == "cuda" else None)

    def run(self, fn, *inputs, on: list | None = None):
        """fn(ev, *local inputs) on every position at once, where ev is the
        position's PositionEvaluator (or on[i], any per-position object,
        such as a CkksBackend over it) and every ShardedCiphertext input is
        the position's shard in the ct_sharding layout (other inputs are
        passed as they are). Returns what fn returns, a Ciphertext or a
        list or tuple of them, as ShardedCiphertexts in the ct_sharding
        layout; other results as the list of the positions'. The first
        exception of any position aborts the others' exchanges and is
        raised here."""
        mesh = self.mesh
        on = self.evaluators if on is None else on
        groups = [LimbGroup(mesh.n_limb, self.timeout)
                  for _ in range(mesh.n_data)]
        positions = mesh.positions()
        for (d, _, _), ev in zip(positions, self.evaluators):
            ev.ctx.group = groups[d]
        local = [[_local(x, d, p) for x in inputs] for d, p, _ in positions]
        devices = {dev for _, _, dev in positions}
        start = {dev: record(dev) for dev in devices}
        results = [None] * len(positions)
        ends = [None] * len(positions)
        errors = []
        lock = threading.Lock()

        def body(i):
            dev = positions[i][2]
            try:
                with _on(dev, self._streams[i]):
                    after(start[dev], dev)
                    results[i] = fn(on[i], *local[i])
                    ends[i] = record(dev)
            except BaseException as e:
                with lock:
                    errors.append(e)
                for g in groups:
                    g.abort()

        threads = [threading.Thread(target=body, args=(i,), daemon=True)
                   for i in range(len(positions))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.coeffs.clear()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        for (_, _, dev), ev in zip(positions, ends):
            after(ev, dev)
        return self._collect(results)

    def _collect(self, outs: list):
        first = outs[0]
        if isinstance(first, Ciphertext):
            if any(o.level != first.level or o.scale != first.scale
                   for o in outs):
                raise RuntimeError("mesh positions returned ciphertexts at "
                                   "different levels or scales")
            return ShardedCiphertext(
                list(outs), ct_sharding(self.mesh, first.data.ndim - 3),
                first.scale, first.level)
        if isinstance(first, (list, tuple)):
            return type(first)(self._collect([o[j] for o in outs])
                               for j in range(len(first)))
        return outs


def _on(dev: torch.device, stream):
    """Make dev and its position's stream this thread's current ones."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def _local(x, d: int, p: int):
    """Position (d, p)'s shard of a ShardedCiphertext input, in the
    ct_sharding layout; any other input as it is."""
    if not isinstance(x, ShardedCiphertext):
        return x
    mesh = x.mesh
    sh = x.shards[d * mesh.n_limb + p]
    want = ct_sharding(mesh, sh.data.ndim - 3)
    data = sh.data
    if want.data and not x.layout.data:
        data = data.tensor_split(mesh.n_data, dim=1)[d]
    if not x.layout.limb:
        data = data[..., p::mesh.n_limb, :]
    return Ciphertext(data.contiguous(), x.scale, x.level)
