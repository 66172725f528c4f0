"""Dual-backend slot-vector abstraction for the encrypted kernel library.

Counterpart of ``fhe_gpt2_tpu/nn/backend.py``. Kernels (the LT engine of
``nn/linear.py``, the Chebyshev evaluator of ``approx/chebeval.py``, the
bootstrap) are written once against this small protocol and run on:

  * PlainBackend: numpy float64 arrays shaped [batch, slots]; rotations are
    np.roll. The correctness oracle.
  * CkksBackend: batched Ciphertexts ([k, B, l, N]); rotations are Galois
    key switches, masks are plaintext multiplies, bootstrap is real (or the
    fake decrypt/re-encrypt during bring-up).

Mask operands are host numpy arrays; the CkksBackend encodes them on demand
and caches them by (array identity, level, scale), or, under sequential
keys, by (call rank, level, scale).

Ops run eagerly, each issued as it is called. ``jit_sealed`` is the
counterpart of the JAX package's program caching: it seals a function
over ciphertexts into a CUDA graph on the card (``torch.cuda.CUDAGraph``),
captured after one eager warm pass that makes every mask, constant and
table the function reads, and replayed with no Python in the loop.
``rebind_sealed`` points a sealed call at another function of the same
structure, which gets its own warm pass and graph.
``CkksBackend.bootstrap`` takes ``Bootstrapper.bootstrap_jitted`` (each
bootstrap stage a sealed call) for a ciphertext on the card, as the JAX
package takes it for a concrete one. On the CPU a sealed call runs its
function eagerly over its own caches, where a miss raises as a host copy
inside a capture would (``core/seal.py``).
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core import seal, tdyadic, tks
from ..core.context import CkksContext
from ..core.evaluator import (
    Ciphertext, Decryptor, Encryptor, Evaluator, Plaintext, _scales_close,
    fake_bootstrap, stack_cts, unstack_cts)
from ..utils import telemetry

# Bound on id()-keyed plaintext cache entries: numpy arrays take no weak
# references, so each entry pins its source array (a recycled id must never
# hit a stale entry), and an LRU cap bounds the pins.
MAX_ID_CACHE = 4096
# Bound on the bytes those plaintexts hold on the device: a mask at 96 limbs
# of logN=15 is 12.6 MB, so 4096 of them (a GPT-2 block at GPT-2 small's
# width encodes 36,840) would hold 51 GB.
MAX_CACHE_BYTES = 16 << 30


class PlainBackend:
    """Numpy float64 simulator. Values: np.ndarray [..., slots]."""

    def __init__(self, slots: int):
        self.slots = slots

    # -- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return -a

    def mul(self, a, b):
        return a * b

    def square(self, a):
        return a * a

    def mul_plain(self, a, v, out_scale=None):
        return a * v

    def add_plain(self, a, v):
        return a + v

    def add_const(self, a, c):
        return a + c

    def mul_const(self, a, c, out_scale=None):
        return a * c

    def scale_of(self, a):
        """Exact tracked scale of a value; None on the plain backend (scale
        targeting is a no-op there)."""
        return None

    def rotate(self, a, steps: int):
        return np.roll(a, -steps, axis=-1)

    def rotate_many(self, a, steps):
        return [self.rotate(a, s) for s in steps]

    def mul_plain_many_sum(self, values: list, masks: list):
        """Σ_t values[t] ⊙ masks[t] (fused masked accumulation)."""
        acc = values[0] * masks[0]
        for v, m in zip(values[1:], masks[1:]):
            acc = acc + v * m
        return acc

    def conjugate(self, a):
        return np.conj(a) if np.iscomplexobj(a) else a

    # -- batch-axis ops -----------------------------------------------------
    def stack(self, values: list):
        """Stack same-shape values along a NEW leading batch axis."""
        return np.stack(values)

    def unstack(self, a) -> list:
        return [a[i] for i in range(a.shape[0])]

    def take_batch(self, a, idx: tuple):
        """Advanced-index the leading batch axes (gather)."""
        return a[idx]

    def reduce_sum_batch(self, a, axis: int = 0):
        """Sum over one batch axis (additions only: no level/scale cost)."""
        return a.sum(axis=axis)

    # -- level management (no-ops in plaintext) -----------------------------
    def level(self, a) -> int:
        return 1 << 30

    def rescale(self, a):
        return a

    def bootstrap(self, a, **kw):
        return a

    def maybe_bootstrap(self, a, need_levels: int):
        return a

    # -- I/O ----------------------------------------------------------------
    def from_slots(self, arr: np.ndarray):
        return np.asarray(arr, dtype=np.float64)

    def to_slots(self, a) -> np.ndarray:
        return np.asarray(a)


class RecordingBackend(PlainBackend):
    """PlainBackend that records every rotation amount used: run a kernel
    once on host data to learn the Galois key set it needs."""

    def __init__(self, slots: int):
        super().__init__(slots)
        self.steps: set[int] = set()

    def rotate(self, a, steps: int):
        self.steps.add(steps % self.slots)
        return super().rotate(a, steps)

    def key_steps(self) -> list[int]:
        return sorted(s for s in self.steps if s)


@dataclass
class _ExtValue:
    """A rotated ciphertext held in the extended QP basis (double-hoisting
    intermediate): data words [2, ..., l+k, N] = P·(rotated ct)."""

    data: torch.Tensor
    scale: float
    level: int


def _masked_sum(values: list[torch.Tensor], pts: list[torch.Tensor],
                t) -> torch.Tensor:
    """Σ_t values[t]·pts[t] mod q over [2, *B, l, N] operands and [l, N]
    plaintexts, with q and its Barrett words from the NTT tables t: the JAX
    package's stacked ``mul_mod`` + ``mod_sum`` over the term axis
    (``tks.masked_sum``: the MAC kernel for int32 words on the card, the
    torch ops elsewhere)."""
    return tks.masked_sum(values, pts, t)


@dataclass
class CkksBackend:
    """Encrypted backend over the evaluator; values are Ciphertexts.

    Scale discipline: every value is kept at the context scale; mul and
    mul_plain rescale immediately (reduced-error relabelling)."""

    ctx: CkksContext
    ev: Evaluator
    enc: Optional[Encryptor] = None
    dec: Optional[Decryptor] = None          # only for fake bootstrap / debug
    boot: Optional[object] = None            # boot.Bootstrapper once built
    default_level: int = 0
    min_level_headroom: int = 3
    _plain_cache: dict = field(default_factory=dict)
    _keepalive: dict = field(default_factory=dict)
    _cache_bytes: int = 0
    # Take the single-hoisted LT path (a mod-down per baby rotation) in
    # place of the double-hoisted one.
    no_ext_hoist: bool = False
    # The memory pool every CUDA graph of this backend captures into (they
    # replay one after another), and the segment drivers' sealed calls by
    # model (cnn/resnet.py, nn/model.py), kept for the next forward.
    _graph_pool: object = None
    _segments: dict = field(default_factory=dict)
    # Held across every sealed call's warm pass, capture and replay, and
    # across a staged bootstrap: a graph's static tensors and the pool are
    # shared state, so two threads (the service's workers) take turns. The
    # event marks the end of the last replay, which the next one waits for
    # on its own stream.
    _seal_lock: object = field(default_factory=threading.RLock, init=False,
                               repr=False, compare=False)
    _replayed: object = field(default=None, init=False, repr=False,
                              compare=False)

    @property
    def slots(self) -> int:
        return self.ctx.params.slots

    # -- plaintext encoding cache ------------------------------------------
    def _store(self, key, v, pt: Plaintext) -> Plaintext:
        """Cache pt under an id()-keyed key, pinning its source array v, and
        evict the oldest entries beyond MAX_ID_CACHE entries or
        MAX_CACHE_BYTES of plaintext (entry and pin together, so a recycled
        id can never alias)."""
        self._keepalive[key] = v
        self._plain_cache[key] = pt
        self._cache_bytes += pt.data.numel() * pt.data.element_size()
        while (len(self._keepalive) > MAX_ID_CACHE
               or self._cache_bytes > MAX_CACHE_BYTES):
            old = next(iter(self._keepalive))
            del self._keepalive[old]
            gone = self._plain_cache.pop(old)
            self._cache_bytes -= gone.data.numel() * gone.data.element_size()
            telemetry.count("mask.evictions")
        return pt

    def _key(self, kind: str, v, level: int, scale: float) -> tuple:
        # Homogeneous tuples, kind first, as the JAX package's keys: by the
        # mask's rank in a seq-keyed sealed call (its Seal counts, per
        # thread), so two kernels of the same structure key their masks
        # alike, else by the array's identity.
        s = seal.current()
        if s is not None and s.seq is not None:
            s.seq[0] += 1
            return (kind, s.seq[0], level, scale)
        return (kind, id(v), level, scale)

    def _cached_plain(self, kind: str, v, level: int, scale: float,
                      encode) -> Plaintext:
        """The mask v at (level, scale), encoded by encode() on a miss.
        Inside a sealed call the call's own masks answer first, and a miss
        raises once the call is sealed; its warm pass records every mask
        it reads (an id()-keyed one with its source array pinned).
        Counted as ``mask.lookups`` and ``mask.hits``; an encoding is an
        ``encode`` span."""
        telemetry.count("mask.lookups")
        key = self._key(kind, v, level, scale)
        s = seal.current()
        if s is not None:
            out = s.plains.get(key)
            if out is not None:
                telemetry.count("mask.hits")
                return out
            s.miss(f"mask {key}")
        # Encoded outside the seal: a mask is held here, not among the
        # evaluator's own encodings (Evaluator._sealed_encode), whose ranks
        # must run alike in the warm pass and in every later run.
        if s is not None and s.seq is not None:
            # Sequential keys: the call's own cache, and no other.
            with seal.using(None), telemetry.span("encode", level=level):
                out = s.plains[key] = encode()
            return out
        out = self._plain_cache.get(key)
        if out is None:
            with seal.using(None), telemetry.span("encode", level=level):
                out = encode()
            self._store(key, v, out)
        else:
            telemetry.count("mask.hits")
        if s is not None:
            s.plains[key] = out
            s.hold(v)
        return out

    def _plain(self, v: np.ndarray, level: int, scale: float) -> Plaintext:
        def encode():
            a = np.asarray(v)
            if a.ndim > 1 and a.shape[-1] == self.slots:
                # Batched mask [batch..., slots]: one plaintext per row,
                # stacked into [batch..., l, N] to broadcast against a
                # batched ciphertext.
                pts = [self.ev.make_plain(r, scale, level)
                       for r in a.reshape(-1, self.slots)]
                data = torch.stack([p.data for p in pts]).reshape(
                    *a.shape[:-1], *pts[0].data.shape)
                return Plaintext(data=data, scale=scale, level=level)
            return self.ev.make_plain(a.ravel(), scale, level)
        return self._cached_plain("q", v, level, scale, encode)

    def _plain_ext(self, v: np.ndarray, level: int, scale: float) -> Plaintext:
        return self._cached_plain("ext", v, level, scale, lambda: (
            self.ev.make_plain_ext(np.asarray(v).ravel(), scale, level)))

    def release_masks(self, masks) -> None:
        """Drop the cached plaintexts of the mask arrays `masks` (at every
        level, scale and basis), giving their device memory back: for masks
        read once, such as a projection block's (``granite.BlockMatmul``)."""
        ids = {id(v) for v in masks}
        for key in [k for k, v in self._keepalive.items() if id(v) in ids]:
            del self._keepalive[key]
            gone = self._plain_cache.pop(key)
            self._cache_bytes -= gone.data.numel() * gone.data.element_size()

    def release_caches(self) -> None:
        """Drop every cached plaintext, every per-level key slice of the
        evaluator's keys and the sealed programs of the segment drivers and
        of the Bootstrapper's stages (with their graphs), giving their
        device memory back; what is dropped is made again on its next
        use."""
        self._plain_cache.clear()
        self._keepalive.clear()
        self._cache_bytes = 0
        self._segments.clear()
        if self.boot is not None:
            vars(self.boot).pop("_staged_jit", None)
        ev = self.ev
        keys = list(ev.galois_keys.keys.values()) if ev.galois_keys else []
        for key in keys + [ev.relin_key]:
            if key is not None:
                key._sliced.clear()

    # -- arithmetic ---------------------------------------------------------
    def _add_guard(self, a, b):
        """A reduced-error add with a non-integer scale ratio needs one
        corrective multiply: refresh the operands first when at the level
        floor. Close or integer-ratio scales are free."""
        if _scales_close(a.scale, b.scale):
            return a, b
        f = max(a.scale, b.scale) / min(a.scale, b.scale)
        if abs(f - round(f)) < 1e-6 * f:
            return a, b
        return self._ab(a), self._ab(b)

    def add(self, a, b):
        a, b = self._add_guard(a, b)
        return self.ev.add_reduced_error(a, b)

    def sub(self, a, b):
        a, b = self._add_guard(a, b)
        return self.ev.sub_reduced_error(a, b)

    def neg(self, a):
        return self.ev.negate(a)

    @property
    def _floor(self) -> int:
        """Level floor below which multiplicative ops refresh first:
        min_level_headroom logical levels above the bootstrap base."""
        ctx = self.ctx
        return (ctx.base_limbs - 1
                + self.min_level_headroom * ctx.rescale_limbs)

    def _ab(self, a):
        """Auto-bootstrap when level headroom is exhausted: a
        multiplicative op refreshes its operand first at the level floor,
        through the real Bootstrapper, or else the fake decrypt/re-encrypt
        when a decryptor and an encryptor are bound."""
        if a.level > self._floor:
            return a
        if self.boot is not None:
            return self.bootstrap(a)
        # The fake refresh decrypts on the host: not inside a sealed call,
        # as the JAX package skips it under a trace.
        if (self.dec is not None and self.enc is not None
                and seal.current() is None):
            return self.bootstrap(a)
        return a

    def _ab_rot(self, a):
        """Level guard for level-free ops (rotations, stacking): refresh only
        under a real Bootstrapper."""
        if self.boot is not None and a.level <= self._floor:
            return self.bootstrap(a)
        return a

    def mul(self, a, b):
        """ct×ct multiply + rescale with exact scale tracking: the result
        scale is a.scale·b.scale/q_last, never relabelled."""
        a, b = self._ab(a), self._ab(b)
        return self.ev.rescale(self.ev.multiply_reduced_error(a, b))

    def square(self, a):
        a = self._ab(a)
        return self.ev.rescale(self.ev.square(a))

    def mul_plain(self, a, v, out_scale: float = None):
        """Scale-targeted plain multiply: the plaintext scale is chosen so
        that the rescaled product lands exactly at out_scale (default: the
        context scale)."""
        a = self._ab(a)
        delta = out_scale or self.ctx.params.scale
        cs = delta * self.ctx.rescale_divisor(a.level) / a.scale
        out = self.ev.mul_plain(a, self._plain(v, a.level, cs))
        return self.ev.rescale_to_scale(out, delta)

    def add_plain(self, a, v):
        return self.ev.add_plain(a, self._plain(v, a.level, a.scale))

    def add_const(self, a, c):
        return self.ev.add_const(a, float(c))

    def mul_const(self, a, c, out_scale: float = None):
        c = float(c)
        if out_scale is None and c == int(c) and abs(c) < 2 ** 40:
            # Exact integer multiply: free (no level, no scale change).
            return self.ev.mul_const_int(a, int(c))
        a = self._ab(a)
        delta = out_scale or self.ctx.params.scale
        cs = delta * self.ctx.rescale_divisor(a.level) / a.scale
        out = self.ev.mul_const(a, c, const_scale=cs)
        return self.ev.rescale_to_scale(out, delta)

    def scale_of(self, a) -> float:
        return a.scale

    def rotate(self, a, steps: int):
        return self.ev.rotate(self._ab_rot(a), steps)

    def rotate_many(self, a, steps):
        """Hoisted multi-rotation (one digit decomposition); the source is
        refreshed once when the level floor is hit."""
        return self.ev.rotate_hoisted(self._ab_rot(a), list(steps))

    def mul_plain_many_sum(self, values: list, masks: list):
        """Σ_t values[t] ⊙ masks[t] as batched dyadic products, one modular
        reduction and a single rescale: the LT engine's inner MAC."""
        a0 = values[0]
        lvl = min(v.level for v in values)
        delta = self.ctx.params.scale
        cs = delta * self.ctx.rescale_divisor(lvl) / a0.scale
        t = self.ctx.tables(lvl)
        rows = t.q.shape[0]                 # the limbs below lvl held here
        acc = _masked_sum([v.data[..., :rows, :] for v in values],
                          [self._plain(m, lvl, cs).data for m in masks], t)
        return self.ev.rescale_to_scale(Ciphertext(acc, a0.scale * cs, lvl),
                                        delta)

    def conjugate(self, a):
        return self.ev.conjugate(a)

    # -- batch-axis ops -----------------------------------------------------
    def stack(self, values: list):
        vals = [self._ab_rot(v) for v in values]
        lvl = min(v.level for v in vals)
        return stack_cts([self.ev.mod_switch_to(v, lvl) for v in vals])

    def unstack(self, a) -> list:
        return unstack_cts(a)

    def take_batch(self, a, idx: tuple):
        """Gather over the batch axes (component axis 0 untouched). Index
        arrays go to the device once per sealed call (``_device_index``)."""
        idx = tuple(self._device_index(i, a.data.device) for i in idx)
        return Ciphertext(a.data[(slice(None),) + idx].contiguous(),
                          a.scale, a.level)

    @staticmethod
    def _device_index(i, device):
        """A numpy index array as an int64 tensor on device: copied per call,
        or inside a sealed call its own copy keyed by the array's contents,
        made by the warm pass. Slices and integers pass as they are."""
        if not isinstance(i, np.ndarray):
            return i
        a = np.ascontiguousarray(i, dtype=np.int64)
        return seal.device_constant(
            ("index", a.shape, a.tobytes()), f"index of shape {a.shape}",
            lambda: torch.from_numpy(a).to(device))

    def reduce_sum_batch(self, a, axis: int = 0):
        return Ciphertext(tdyadic.mod_sum(a.data, self.ctx.tables(a.level),
                                          axis=1 + axis), a.scale, a.level)

    # -- double-hoisted LT path (see Evaluator.hoisted_rotations_ext) --------

    def lt_hoist_ext(self, xs: list, needed: dict):
        """Baby-rotate each source in the extended QP basis.

        needed: {src_index: sorted rotation amounts}. Returns
        {(src, amount): _ExtValue}. Sources are aligned to a common level
        first; sources sharing an amount set are stacked and decomposed as
        one batched ciphertext."""
        srcs = {s: self._ab_rot(xs[s]) for s in needed}
        lvl = min(v.level for v in srcs.values())
        by_amounts: dict = {}
        for src, amounts in needed.items():
            by_amounts.setdefault(tuple(amounts), []).append(src)
        out = {}
        for amounts, group in by_amounts.items():
            cts = [self.ev.mod_switch_to(srcs[s], lvl) for s in group]
            uniform = (len({c.batch for c in cts}) == 1
                       and all(_scales_close(c.scale, cts[0].scale)
                               for c in cts))
            if len(group) == 1 or not uniform:
                for src, c in zip(group, cts):
                    exts = self.ev.hoisted_rotations_ext(c, list(amounts))
                    for i, e in zip(amounts, exts):
                        out[(src, i)] = _ExtValue(e, c.scale, lvl)
                continue
            stacked = stack_cts(cts)
            exts = self.ev.hoisted_rotations_ext(stacked, list(amounts))
            for i, e in zip(amounts, exts):
                for bi, src in enumerate(group):
                    out[(src, i)] = _ExtValue(e[:, bi], stacked.scale, lvl)
        return out

    def rotate_same_batched(self, values: list, steps: int):
        """Rotate several same-shape values by the same amount as one
        batched key switch (stack → rotate → unstack): the LT engine's giant
        step across destination accumulators."""
        if (len(values) == 1
                or len({(v.level, v.batch) for v in values}) != 1
                or not all(_scales_close(v.scale, values[0].scale)
                           for v in values)):
            return [self.rotate(v, steps) for v in values]
        return unstack_cts(self.rotate(stack_cts(values), steps))

    def lt_mask_sum_ext(self, exts: list, masks: list):
        """Σ_t masks[t] ⊙ exts[t] accumulated in the QP basis, then one
        mod-down and rescale: one mod-down per destination accumulator in
        place of one per rotation."""
        e0 = exts[0]
        lvl = e0.level
        assert all(e.level == lvl for e in exts)
        assert all(_scales_close(e.scale, e0.scale) for e in exts), \
            "lt_mask_sum_ext: mixed ext scales would be mis-weighted"
        delta = self.ctx.params.scale
        cs = delta * self.ctx.rescale_divisor(lvl) / e0.scale
        kt = self.ctx.tables(self.ctx.key_limbs(lvl))
        acc = _masked_sum([e.data for e in exts],
                          [self._plain_ext(m, lvl, cs).data for m in masks],
                          kt)
        out = self.ev.mod_down_ext(acc, lvl, e0.scale * cs)
        return self.ev.rescale_to_scale(out, delta)

    # -- level management ---------------------------------------------------
    def level(self, a) -> int:
        return a.level

    def rescale(self, a):
        return self.ev.rescale(a)

    def bootstrap(self, a, **kw):
        """Refresh a: the Bootstrapper's, or else the fake decrypt/
        re-encrypt. Keywords are accepted and ignored, as in the JAX
        package. A real bootstrap is a ``bootstrap`` span (with device
        events on the card), which synchronizes the card at its end
        outside a sealed call, where nothing may synchronize."""
        if self.boot is not None:
            with telemetry.span("bootstrap", level=a.level,
                                events=a.data.is_cuda,
                                sync=seal.current() is None):
                # Entry normalisation happens inside the Bootstrapper.
                if self._boot_sealed(a):
                    return self.boot.bootstrap_jitted(a)
                return self.boot.bootstrap(a, **kw)
        # Bring-up path: decrypt/re-encrypt.
        assert self.dec is not None and self.enc is not None
        return fake_bootstrap(a, self.dec, self.enc, self.ev,
                              self.default_level or self.ctx.L)

    def maybe_bootstrap(self, a, need_levels: int):
        # need_levels counts logical levels (multiplicative depth); convert
        # to limbs above the bootstrap base.
        ctx = self.ctx
        if a.level <= need_levels * ctx.rescale_limbs + ctx.base_limbs:
            return self.bootstrap(a)
        return a

    # -- I/O ----------------------------------------------------------------
    def _boot_sealed(self, a) -> bool:
        """Whether bootstrap takes the staged sealed pipeline (each stage a
        CUDA graph, captured once and replayed): for a ciphertext on the
        card, outside a sealed call (inside one the pipeline runs in the
        caller's program), with a bootstrapper that is not a mesh
        position's (``Bootstrapper.on``; the mesh runs eagerly)."""
        return (a.data.is_cuda and not self.boot.eager_only
                and seal.current() is None)

    def from_slots(self, arr: np.ndarray, level: Optional[int] = None):
        level = level or self.default_level or self.ctx.L
        arr = np.asarray(arr, dtype=np.float64)
        scale = self.ctx.params.scale
        if arr.ndim == 1:
            return self.enc.encrypt(self.ev.make_plain(arr, scale, level))
        return stack_cts([self.enc.encrypt(self.ev.make_plain(r, scale, level))
                          for r in arr])

    def to_slots(self, a) -> np.ndarray:
        assert self.dec is not None
        if a.batch:
            return np.stack([np.real(self.dec.decrypt(c))
                             for c in unstack_cts(a)])
        return np.real(self.dec.decrypt(a))


# ---------------------------------------------------------------------------
# Sealed calls: jit_sealed / rebind_sealed on CUDA graphs
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list):
    """The structure of x (Ciphertexts and other values in lists and
    tuples) with the Ciphertexts' tensors appended to leaves; a
    Ciphertext's scale and level are part of the structure."""
    if isinstance(x, Ciphertext):
        leaves.append(x.data)
        return ("ct", x.scale, x.level)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return ("v", x)


def _unflatten(d, it):
    if d[0] == "ct":
        return Ciphertext(next(it), d[1], d[2])
    if d[0] == "v":
        return d[1]
    return d[0](_unflatten(c, it) for c in d[1])


def _signature(args) -> tuple:
    """(structure, tensors, key): key is the input signature (levels,
    scales, shapes, words) a sealed call keys its programs by."""
    leaves: list = []
    d = _flatten(args, leaves)
    return d, leaves, (d, tuple((tuple(t.shape), t.dtype) for t in leaves))


class _Graph:
    """One captured graph and the static tensors it reads and writes."""

    def __init__(self, graph, static_in, static_out):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out


class _Program:
    """A sealed call's program for one input signature: its seal (masks,
    constants, encodings, held tensors), its input and output structure,
    and on the card its graph."""

    def __init__(self, s: seal.Seal, in_def, out_def):
        self.seal = s
        self.in_def = in_def
        self.out_def = out_def
        self.graph: _Graph | None = None
        self.warm_s = 0.0
        self.capture_s = 0.0
        # The op and key-switch counts of the warm pass, which each replay
        # adds to the recorder (utils/telemetry.py).
        self.counts: dict = {}


class SealedCall:
    """``jit_sealed``'s callable: fn's signature, one program per input
    signature. See ``jit_sealed``. Calls from several threads take turns
    (the backend's ``_seal_lock``)."""

    def __init__(self, B: "CkksBackend", fn, example_args: tuple,
                 seq_keys: bool):
        self._B = B
        self.fn = fn
        self.seq_keys = seq_keys
        self.programs: dict = {}
        self._first = None
        with B._seal_lock:
            self._make(example_args)

    def _run(self, s: seal.Seal, args: tuple, sealed: bool):
        """fn(*args) with s as this thread's running seal (warm or sealed),
        counting sequential keys in s when the call has them."""
        s.start(sealed, self.seq_keys)
        try:
            with seal.using(s):
                return self.fn(*args)
        finally:
            s.sealed = True

    def _make(self, args: tuple):
        """Warm pass over args, then, on the card, the capture. Returns the
        warm pass's output, the first call's result."""
        in_def, leaves, sig = _signature(args)
        s = seal.Seal()
        t0 = time.perf_counter()
        with telemetry.collect() as counts:
            out = self._run(s, args, sealed=False)
        prog = _Program(s, in_def, _flatten(out, []))
        prog.counts = {k: n for k, n in counts.items()
                       if k.startswith(telemetry.REPLAYED)}
        cuda = bool(leaves) and leaves[0].is_cuda
        if cuda:
            torch.cuda.synchronize(leaves[0].device)
        prog.warm_s = time.perf_counter() - t0
        if cuda:
            t0 = time.perf_counter()
            prog.graph = self._capture(prog, leaves)
            prog.capture_s = time.perf_counter() - t0
        self.programs[sig] = prog
        self._first = (args, out)
        return out

    def _capture(self, prog: _Program, leaves: list) -> _Graph:
        """Capture fn over static copies of the inputs into a CUDA graph in
        the backend's pool. Whatever fails in the capture raises."""
        B = self._B
        dev = leaves[0].device
        static_in = [t.clone() for t in leaves]
        args = _unflatten(prog.in_def, iter(static_in))
        if B._graph_pool is None:
            B._graph_pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        # torch.cuda.graph captures on a side stream, and collects garbage
        # and empties the allocator's cache first, which also frees a pool
        # whose graphs are all gone (after a failed capture, or
        # release_caches) before the pool is taken again. No collection
        # may run inside the capture: a CUDA object freed there would
        # invalidate it.
        collecting = gc.isenabled()
        try:
            with torch.cuda.device(dev), telemetry.muted():
                with torch.cuda.graph(g, pool=B._graph_pool,
                                      capture_error_mode="thread_local"):
                    gc.disable()
                    out = self._run(prog.seal, args, sealed=True)
        finally:
            if collecting:
                gc.enable()
        static_out: list = []
        if _flatten(out, static_out) != prog.out_def:
            raise RuntimeError("sealed call: the captured function's output "
                               "structure differs from its warm pass's")
        return _Graph(g, static_in, static_out)

    def __call__(self, *args):
        with self._B._seal_lock:
            return self._call(args)

    def _call(self, args: tuple):
        first, self._first = self._first, None
        if (first is not None and len(first[0]) == len(args)
                and all(a is b for a, b in zip(first[0], args))):
            return first[1]
        in_def, leaves, sig = _signature(args)
        prog = self.programs.get(sig)
        if prog is None:
            out = self._make(args)
            self._first = None
            return out
        if prog.graph is None:
            return self._run(prog.seal, args, sealed=True)
        gr, B = prog.graph, self._B
        with torch.cuda.device(leaves[0].device):
            # The graphs share the pool: wait for the last replay, which
            # may have run on another stream.
            stream = torch.cuda.current_stream()
            if B._replayed is not None:
                stream.wait_event(B._replayed)
            for buf, t in zip(gr.static_in, leaves):
                buf.copy_(t)
            gr.graph.replay()
            telemetry.add(prog.counts)
            outs = [t.clone() for t in gr.static_out]
            B._replayed = torch.cuda.Event()
            B._replayed.record(stream)
        return _unflatten(prog.out_def, iter(outs))


def jit_sealed(B: "CkksBackend", fn, *example_args, seq_keys: bool = False):
    """Seal fn, a function of ciphertexts on backend B, into a program: the
    counterpart of the JAX package's jit with the keys and the masks as
    arguments. Returns a callable with fn's signature.

      1. Warm pass: fn runs eagerly over example_args, making every mask
         (under ``seq_keys`` in the call's own cache, keyed ("q"/"ext",
         rank, level, scale) as the JAX package's), every constant and
         encoding (``core/seal.py``) and every table it reads. Its output
         is the first call's result.
      2. On the card, fn is captured into a CUDA graph over static input
         copies, in the backend's graph pool, keyed by the input signature
         (levels, scales, shapes); the call holds the masks, constants and
         key slices the graph reads.
      3. A call copies its inputs into the static tensors, replays the
         graph and returns copies of the outputs. On the CPU it runs fn
         eagerly over the call's caches, where a miss raises
         (``SealedCacheMiss``), as a host copy in a capture would.

    A new input signature makes a new program (warm pass and capture). A
    capture that fails raises: nothing falls back to eager."""
    return SealedCall(B, fn, example_args, seq_keys)


def rebind_sealed(call: SealedCall, fn_other, *example_args) -> SealedCall:
    """``call`` re-targeted at fn_other, a function of the same structure
    (the next block of a stage: the same rotations, other weights): a warm
    pass of fn_other under sequential keys makes its masks, and on the card
    a graph of its own reads them. The JAX package shares the base's
    compiled program, its masks passed as arguments; on the card a capture
    costs about a second once, while a shared graph would copy the
    function's masks into the graph's on every switch and keep the base's
    a second time (``PERF.md``, PR 11), so every function keeps its own
    graph, and with it its own constants (a GPT-2 layer's Newton seed)."""
    return SealedCall(call._B, fn_other, example_args, True)


def graph_pool_bytes(B: "CkksBackend") -> int:
    """Bytes the CUDA caching allocator holds in B's graph pool (0 before
    the first capture)."""
    if B._graph_pool is None:
        return 0
    pool = tuple(B._graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def segment_runner(B, kind: str, model):
    """run(name, fn, vs, part=None) of a segment driver (cnn/resnet.py,
    nn/model.py ``_forward_jit``): the JAX package's two-level cache. The
    exact key (name, part, signature) holds one sealed call per part (a
    block's or a layer's weights) at one signature; the structural key
    (name, signature) holds the first, which later parts rebind to
    (``rebind_sealed``). Both live on the backend, by model, so that a
    second forward replays what the first captured. A backend with no
    device program (the plain simulator) runs each fn as it is. Each call
    is a ``segment.<name>`` span (``utils/telemetry.py``), its index the
    part."""
    if not isinstance(B, CkksBackend):
        return lambda name, fn, vs, part=None: fn(vs)
    _, jcache, struct_cache = B._segments.setdefault(
        (kind, id(model)), (model, {}, {}))
    spans: dict = {}                # segment name -> its span's name

    def run(name, fn, vs, part=None):
        sig = (tuple(v.level for v in vs), tuple(v.scale for v in vs),
               tuple(v.data.shape for v in vs))
        key = (name, part, sig)
        label = spans.get(name)
        if label is None:
            label = spans[name] = "segment." + (
                name if isinstance(name, str) else name[0])
        with telemetry.span(label, index=part):
            jf = jcache.get(key)
            if jf is None:
                base = struct_cache.get((name, sig))
                if base is None:
                    jf = jit_sealed(B, fn, vs, seq_keys=True)
                    struct_cache[(name, sig)] = jf
                else:
                    jf = rebind_sealed(base, fn, vs)
                jcache[key] = jf
            return jf(vs)
    return run
