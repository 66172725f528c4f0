"""Counters and spans that a traced run wraps around the port's calls.

Nothing here edits the port: ``Probe.install`` replaces attributes of one
session's evaluator and backend and of the kernel wrapper modules with
recorders that call what they replace, and ``uninstall`` puts them back.
They record, for the traced window:

* the homomorphic operations' work (``work.Work``): each evaluator
  operation at the outermost call (the backend's masked sums count as
  one), with every ciphertext, plaintext and tensor it reads or writes
  counted once, the key it reads per key switch, and its multiplies;
* each call of the four CUDA kernel wrappers (``tntt.ntt_forward``,
  ``tntt.ntt_inverse``, ``tks.fused_switch_key``, ``tks.fused_mod_down``;
  an NTT inside a key switch or mod-down belongs to it) with its least
  time from its shapes;
* ``CkksBackend.bootstrap`` calls, timed with the device synchronized at
  both edges: real bootstraps, or, where the session has no Bootstrapper,
  the decrypt/re-encrypt refreshes;
* mask encodings (the backend cache's misses) and their host seconds;
* a host span for each of these, for the idle gaps' attribution.

A sealed bootstrap replays CUDA graphs, which call no Python: a bootstrap
adds the work and kernel calls of one eager bootstrap that
``record_bootstrap`` counts in set-up.
"""

from __future__ import annotations

import time
import types
from collections import defaultdict

from . import work as W

KINDS = ("ntt_fwd", "ntt_inv", "keyswitch", "moddown")
# Evaluator operations; the value is the modular products per word of the
# first ciphertext operand.
OPS = {"add": 0, "sub": 0, "negate": 0, "add_plain": 0, "sub_plain": 0,
       "add_const": 0, "mul_const_int": 1, "mul_const": 1, "mul_plain": 1,
       "multiply": 2, "square": 2, "relinearize": 0, "rescale": 0,
       "mod_switch_drop": 0, "apply_galois": 0, "rotate": 0,
       "rotate_hoisted": 0, "hoisted_rotations_ext": 0, "mod_down_ext": 0,
       "conjugate": 0, "set_scale_exact": 1, "add_reduced_error": 0,
       "sub_reduced_error": 0, "multiply_reduced_error": 2,
       "rescale_to_scale": 0}


_MISSING = object()


def _words(obj, seen: set) -> int:
    """Words of the tensors in obj (ciphertexts, plaintexts, ext values,
    tensors, and lists, tuples and dicts of them), each storage once."""
    import torch
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel())
        if key in seen or obj.dtype not in (torch.int32, torch.int64):
            return 0
        seen.add(key)
        return obj.numel()
    if isinstance(obj, (list, tuple)):
        return sum(_words(x, seen) for x in obj)
    if isinstance(obj, dict):
        return sum(_words(x, seen) for x in obj.values())
    data = getattr(obj, "data", None)
    if isinstance(data, torch.Tensor):
        return _words(data, seen)
    return 0


def _first_ct_words(args) -> int:
    for a in args:
        if hasattr(a, "data") and hasattr(a, "level"):
            return a.data.numel()
    return 0


def _lead(shape) -> int:
    m = 1
    for s in shape:
        m *= int(s)
    return m


class Probe:
    def __init__(self, session, sync):
        self.s = session
        self.sync = sync
        ctx = session.ctx
        self.n = ctx.n
        self.k_sp = ctx.k_sp
        self.g = ctx.rescale_limbs
        self.reset()
        self._saved = []
        self.boot_work = W.Work()
        self.boot_kernels = {k: [0, 0.0] for k in KINDS}

    def reset(self) -> None:
        self.work = W.Work()
        self.kernels = {k: [0, 0.0] for k in KINDS}
        self.counts = defaultdict(float)
        self.spans = []
        self.depth = 0
        self.kdepth = 0
        self.suppress = 0
        self.cur = None

    # -- installation -------------------------------------------------------
    def _set(self, obj, name, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)
                            if isinstance(obj, types.ModuleType)
                            else obj.__dict__.get(name, _MISSING)))
        setattr(obj, name, value)

    def install(self) -> None:
        from fhe_gpt2_tpu_torch.core import tks, tntt
        from fhe_gpt2_tpu_torch.nn import backend as NB

        B = self.s.B
        ev = B.ev
        for name in OPS:
            if name != "rescale":
                self._set(ev, name, self._op(name, getattr(ev, name)))
        self._set(ev, "_switch_key", self._hook(ev._switch_key, self._ks))
        self._set(ev, "_hoisted_mac", self._hook(ev._hoisted_mac, self._mac))
        self._set(ev, "_decompose", self._hook(ev._decompose, self._dec))
        self._set(ev, "_mod_down_special",
                  self._hook(ev._mod_down_special, self._md))
        self._set(ev, "rescale", self._op("rescale",
                                          self._hook(ev.rescale, self._rs)))
        self._set(NB, "_masked_sum", self._masked(NB._masked_sum))
        self._set(B, "_cached_plain", self._encode(B._cached_plain))
        self._set(B, "bootstrap", self._boot(B.bootstrap))
        for mod in (tntt, tks):
            self._set(mod, "ntt_forward", self._kernel(
                "ntt_fwd", mod.ntt_forward, self._ntt_cost))
            self._set(mod, "ntt_inverse", self._kernel(
                "ntt_inv", mod.ntt_inverse, self._ntt_cost))
        self._set(tks, "fused_switch_key", self._kernel(
            "keyswitch", tks.fused_switch_key, self._ks_cost))
        self._set(tks, "fused_mod_down", self._kernel(
            "moddown", tks.fused_mod_down, self._md_cost))

    def uninstall(self) -> None:
        while self._saved:
            obj, name, old = self._saved.pop()
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)

    # -- operations ---------------------------------------------------------
    def _op(self, name, fn):
        per_word = OPS.get(name, 0)

        def call(*args, **kw):
            if self.depth or self.suppress:
                return fn(*args, **kw)
            self.depth += 1
            self.cur = W.Work()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                self.depth -= 1
            t1 = time.perf_counter()
            seen: set = set()
            words = _words(args, seen) + _words(kw, seen) + _words(out, seen)
            muls = per_word * _first_ct_words(args) * W.BARRETT_MULS
            self.work.add(W.WORD * words + self.cur.nbytes,
                          muls + self.cur.muls)
            self.work.ops += 1
            self.cur = None
            self.spans.append((name, t0, t1))
            return out
        return call

    def _masked(self, fn):
        def call(values, pts, t):
            if self.suppress:
                return fn(values, pts, t)
            t0 = time.perf_counter()
            out = fn(values, pts, t)
            seen: set = set()
            vw = _words(values, seen)
            words = vw + _words(pts, seen) + _words(out, seen)
            self.work.add(W.WORD * words, vw * W.BARRETT_MULS)
            self.work.ops += 1
            self.spans.append(("masked_sum", t0, time.perf_counter()))
            return out
        return call

    def _hook(self, fn, cost):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if not self.suppress:
                nbytes, muls = cost(*args, **kw)
                (self.cur or self.work).add(nbytes, muls)
            return out
        return call

    def _digits(self, level):
        return W.digits(level, self.k_sp, self.k_sp)

    def _ks(self, c, level, ksk):
        """A key switch: the key read once, the switch's multiplies."""
        D, A, J = self._digits(level)
        M = _lead(c.shape[:-2])
        _, muls = W.keyswitch_cost(M, level, D, A, J, self.n)
        return W.WORD * 2 * D * J * self.n, muls

    def _dec(self, a):
        """The shared digit decomposition of hoisted rotations: the iNTT of
        c1 and the NTT of its digits."""
        level = a.level
        D, A, J = self._digits(level)
        M = _lead(a.data.shape[1:-2])
        _, m_i = W.ntt_cost(M * level, level, self.n)
        _, m_f = W.ntt_cost(M * D * J, J, self.n)
        return 0.0, m_i + m_f + M * D * J * A * self.n * W.BARRETT_MULS

    def _mac(self, tpoly, kt, elt, level, D):
        """One hoisted rotation's key product: its key read once."""
        _, _, J = self._digits(level)
        M = _lead(tpoly.shape[:-3])
        return (W.WORD * 2 * D * J * self.n,
                2 * M * D * J * self.n * W.BARRETT_MULS)

    def _md(self, x, level):
        _, muls = W.moddown_cost(_lead(x.shape[:-2]), level, self.k_sp,
                                 self.n)
        return 0.0, muls

    def _rs(self, a):
        if self.g == 1:
            return 0.0, 0.0
        _, muls = W.moddown_cost(_lead(a.data.shape[:-2]), a.level - self.g,
                                 self.g, self.n)
        return 0.0, muls

    # -- kernel wrappers ----------------------------------------------------
    def _kernel(self, kind, fn, cost):
        def call(*args, **kw):
            if self.kdepth or self.suppress:
                return fn(*args, **kw)
            self.kdepth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self.kdepth -= 1
            k = self.kernels[kind]
            k[0] += 1
            k[1] += W.kernel_time(*cost(*args))
            return out
        return call

    def _ntt_cost(self, x, t, *rest):
        return W.ntt_cost(_lead(x.shape[:-1]), int(t.q.shape[0]),
                          int(x.shape[-1]))

    def _ks_cost(self, c, kdata, lt, kt, ft, *rest):
        return W.keyswitch_cost(_lead(c.shape[:-2]), int(c.shape[-2]), ft.D,
                                ft.A, int(kt.q.shape[0]), int(c.shape[-1]))

    def _md_cost(self, x, t_sp, t_q, ft, *rest):
        return W.moddown_cost(_lead(x.shape[:-2]), ft.l, ft.k,
                              int(x.shape[-1]))

    # -- encodings and bootstraps --------------------------------------------
    def _encode(self, fn):
        def call(kind, v, level, scale, encode):
            def timed():
                t0 = time.perf_counter()
                out = encode()
                t1 = time.perf_counter()
                if not self.suppress:
                    self.counts["encodes"] += 1
                    self.counts["encode_s"] += t1 - t0
                    self.spans.append(("encode", t0, t1))
                return out
            return fn(kind, v, level, scale, timed)
        return call

    def _boot(self, fn):
        def call(a, **kw):
            if self.suppress:
                return fn(a, **kw)
            real = self.s.B.boot is not None
            self.sync()
            t0 = time.perf_counter()
            self.suppress += real
            try:
                out = fn(a, **kw)
            finally:
                self.suppress -= real
            self.sync()
            t1 = time.perf_counter()
            self.counts["boots" if real else "refreshes"] += 1
            self.counts["boot_s" if real else "refresh_s"] += t1 - t0
            self.spans.append(("bootstrap" if real else "refresh", t0, t1))
            if real:
                self.work.merge(self.boot_work)
                for k in KINDS:
                    self.kernels[k][0] += self.boot_kernels[k][0]
                    self.kernels[k][1] += self.boot_kernels[k][1]
            return out
        return call

    def record_bootstrap(self, ct) -> None:
        """Count one eager bootstrap of ct (the work and kernel calls each
        sealed bootstrap replays), then clear every counter."""
        self.reset()
        self.s.B.boot.bootstrap(ct)
        self.sync()
        self.boot_work = self.work
        self.boot_kernels = self.kernels
        self.reset()
