"""Coefficient-wise modular arithmetic of the evaluator on the card: the
wrappers of ``csrc/dyadic.cu``, beside ``tntt.py`` and ``tks.py``.

The JAX package leaves this arithmetic to XLA (``core/modmath.py``'s
``mul_mod``, ``add_mod``, ``sub_mod``, ``neg_mod`` and ``mod_sum`` as its
``core/evaluator.py`` and ``nn/backend.py`` call them), so no Pallas kernel
is replaced. On the int32 word the plain torch route widens every word to
int64, multiplies and takes an int64 remainder; the kernel keeps residues
in 32-bit registers and reduces each 64-bit product or sum once with the
NTT tables' Barrett words. Entries:

* ``tensor_product(a, b, t)``: the [3, *B, l, N] tensor product of two
  ciphertexts in one launch (``Evaluator.multiply``; a square reads each
  component once);
* ``mul_mod(a, b, t)``: products by a ciphertext, a plaintext or a
  per-limb constant (``mul_plain``, ``mul_const_int``, the lift of
  ``hoisted_rotations_ext``);
* ``add_mod``/``sub_mod``/``neg_mod``: one entry with an op code; given
  ``rest``, the sum is a ciphertext's c0 and ``rest`` its other components,
  written in the same launch (``add_plain``, ``sub_plain``, ``add_const``,
  ``apply_galois``, ``rotate_hoisted``);
* ``mod_sum(x, t, axis)``: a batch axis summed (``reduce_sum_batch``).

Route, by word and device: int32 CUDA operands launch the kernel, or the
wrapper raises on a layout the kernel does not take; int32 CPU tensors and
int64 words (the u64 engine) on any device run the ``*_plain`` versions,
which are the ``core/modmath.py`` calls the evaluator made before this
module. Both give the canonical residues, bit for bit.

Layouts. ``t`` is the NTT tables of the operands' rows (their ``q``,
``ratio0``, ``ratio1``, [l, 1] on the card). Row operands are [*B, l, N]
with rows of N contiguous words starting on 16 bytes (limb-prefix views
and component slices are read in place); their batch axes must merge, once
broadcast against the other operand's, into at most GROUPS strided groups
(a ciphertext's components and batch axes, with a plaintext [l, N] or a
batched mask broadcast over some of them). A per-limb constant is [l, 1]. The outputs are new contiguous tensors; the wrappers copy nothing
from the host, so they run inside a sealed call's capture.

Every call counts ``dyadic.calls`` and each that launched ``dyadic.kernel``
(``utils/telemetry.py``) and ``_cuda.LAUNCHES["dyadic"]``.
"""

from __future__ import annotations

import struct

import torch

from . import _cuda, modmath
from ..utils import telemetry

MUL, ADD, SUB, NEG = 0, 1, 2, 3      # dyadic_binary's op codes
THREADS = 256                        # most threads a CTA (csrc kThreads)
WORDS = 8                            # words a thread (csrc kWords)

GROUPS = 4                           # batch groups a launch takes (csrc
                                     # kGroups)
_OPERAND = GROUPS + 2                # an operand's words: p, strides, sj
# The host words of each entry, as int64s: packed in one call, their bytes
# passed to the C entry as a pointer.
_Binary = struct.Struct(f"{3 * _OPERAND + 6 + GROUPS + 2}q")
_Tensor = struct.Struct(f"{2 * _OPERAND + 6 + GROUPS + 2}q")
_Sum = struct.Struct("13q")


def _plain_route(x: torch.Tensor) -> bool:
    return x.dtype == torch.int64 or x.device.type == "cpu"


def _threads(n: int) -> int:
    """Threads of a CTA over rows of n words: WORDS words a thread and at
    most THREADS, so that a CTA's block divides the row."""
    threads = min(THREADS, n // WORDS)
    if threads < 1 or n & (n - 1):
        raise ValueError(f"dyadic kernels: rows of {n} words (want a power "
                         "of two of at least 8)")
    return threads


def _check(x: torch.Tensor, dev: torch.device, name: str):
    """(shape, strides) of an int32 operand on dev."""
    if x.dtype != torch.int32:
        raise TypeError(f"dyadic: {name} is {x.dtype}, not torch.int32")
    if x.device != dev:
        raise ValueError(f"dyadic: {name} on {x.device}, not {dev}")
    return x.shape, x.stride()


def _rows(ptr: int, shape, stride, name: str, l: int, n: int) -> None:
    """The operand at ptr holds rows of n contiguous words that start on
    16 bytes."""
    if (shape[-2] != l or shape[-1] != n or stride[-1] != 1 or stride[-2] & 3
            or ptr & 15):
        raise ValueError(
            f"dyadic: {name} of shape {tuple(shape)} and strides {stride} "
            f"does not hold [.., {l}, {n}] rows of contiguous words on "
            "16-byte boundaries")


def _broadcast(ba, bb) -> tuple:
    """The broadcast of two batch shapes (right-aligned)."""
    if ba == bb or not bb:
        return tuple(ba)
    if not ba:
        return tuple(bb)
    k = max(len(ba), len(bb))
    pa, pb = (1,) * (k - len(ba)) + tuple(ba), (1,) * (k - len(bb)) + tuple(bb)
    out = []
    for x, y in zip(pa, pb):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"dyadic: batches {tuple(ba)} and {tuple(bb)} "
                             "do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _groups(batch, operands) -> tuple:
    """((M_0, ..), [(s_0, ..) per operand]): the batch axes, broadcast,
    merged into GROUPS strided groups. operands: (shape, strides) of each
    operand's batch axes, right-aligned to `batch`; a missing or size-1
    axis has stride 0. Raises where more groups remain."""
    nb = len(batch)
    aligned = []
    odd = 0
    for shape, stride in operands:
        row = [0] * (nb - len(shape))
        for sz, st in zip(shape, stride):
            row.append(0 if sz == 1 else st)
            odd |= st
        aligned.append(row)
    sizes, strides = [], []
    for d in range(nb):
        size = batch[d]
        if size == 1:
            continue
        st = [x[d] for x in aligned]
        if sizes:
            last = strides[-1]
            for p, q in zip(last, st):
                if p != q * size:
                    break
            else:
                sizes[-1] *= size
                strides[-1] = st
                continue
        sizes.append(size)
        strides.append(st)
    if len(sizes) > GROUPS:
        raise ValueError(f"dyadic: batch {tuple(batch)} with strides "
                         f"{[s for _, s in operands]} does not merge into "
                         f"{GROUPS} strided groups")
    if odd & 3:
        raise ValueError("dyadic: batch strides must be multiples of 4 words")
    pad = GROUPS - len(sizes)
    return ((1,) * pad + tuple(sizes),
            list(zip(*([[0] * len(operands)] * pad + strides)))
            if operands else [])


def _tables(t, l: int, dev: torch.device) -> tuple:
    q = t.q
    if q.shape[0] != l or q.device != dev:
        raise ValueError(f"dyadic: tables of {q.shape[0]} rows on "
                         f"{q.device} for {l} rows on {dev}")
    return q.data_ptr(), t.ratio0.data_ptr(), t.ratio1.data_ptr()


def _launch(fn: str, words: bytes, *args, dev: torch.device) -> None:
    _cuda.call("dyadic", fn, words, *args, device=dev)
    _cuda.count("dyadic")
    telemetry.count("dyadic.kernel")


# ---------------------------------------------------------------------------
# Plain versions: the torch ops of core/modmath.py (the CPU and int64 route)
# ---------------------------------------------------------------------------

def tensor_product_plain(a, b, t):
    q = t.q

    def mm(x, y):
        return modmath.mul_mod(x, y, q, t.ratio0, t.ratio1)

    d0 = mm(a[0], b[0])
    d1 = modmath.add_mod(mm(a[0], b[1]), mm(a[1], b[0]), q)
    d2 = mm(a[1], b[1])
    return torch.stack([d0, d1, d2])


def mul_mod_plain(a, b, t, b_shoup=None):
    if b_shoup is not None:
        return modmath.mul_mod_shoup(a, b, b_shoup, t.q)
    return modmath.mul_mod(a, b, t.q, t.ratio0, t.ratio1)


def _with_rest(c0, rest):
    return c0 if rest is None else torch.cat([c0[None], rest])


def add_mod_plain(a, b, t, rest=None):
    return _with_rest(modmath.add_mod(a, b, t.q), rest)


def sub_mod_plain(a, b, t, rest=None):
    return _with_rest(modmath.sub_mod(a, b, t.q), rest)


def neg_mod_plain(a, t):
    return modmath.neg_mod(a, t.q)


def mod_sum_plain(x, t, axis: int = 0):
    return modmath.mod_sum(x, t.q, axis)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def tensor_product(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """d0 = a0·b0, d1 = a0·b1 + a1·b0, d2 = a1·b1 mod q of the first two
    components of ciphertext words a [k, *Ba, l, N] and b [k, *Bb, l, N]
    (batches that broadcast): [3, *B, l, N]. ``a is b`` (or the same
    words) reads each component once."""
    telemetry.count("dyadic.calls")
    if _plain_route(a):
        return tensor_product_plain(a, b, t)
    dev = a.device
    sa, ta = _check(a, dev, "a")
    sb, tb = _check(b, dev, "b")
    if len(sa) < 3 or len(sb) < 3 or sa[0] < 2 or sb[0] < 2:
        raise ValueError("tensor_product: operands [k >= 2, *B, l, N]")
    l, n = sa[-2], sa[-1]
    pa, pb = a.data_ptr(), b.data_ptr()
    _rows(pa, sa, ta, "a", l, n)
    _rows(pb, sb, tb, "b", l, n)
    if ta[0] & 3 or tb[0] & 3:
        raise ValueError("tensor_product: component strides must be "
                         "multiples of 4 words")
    square = b is a or (pb == pa and sb == sa and tb == ta)
    ba, bb = sa[1:-2], sb[1:-2]
    batch = _broadcast(ba, bb)
    ms, (ga, gb) = _groups(batch, ((ba, ta[1:-2]), (bb, tb[1:-2])))
    q, r0, r1 = _tables(t, l, dev)
    out = torch.empty((3, *batch, l, n), dtype=torch.int32, device=dev)
    words = _Tensor.pack(pa, *ga, ta[-2], ta[0], pb, *gb, tb[-2], tb[0],
                         out.data_ptr(), q, r0, r1, *ms, l, n)
    _launch("dyadic_tensor", words, int(square), _threads(n), dev=dev)
    return out


def _binary(op: int, a: torch.Tensor, b, t, rest=None) -> torch.Tensor:
    """out = a op b over a's rows (b: rows of a's or a broadcast batch, or
    a per-limb constant [l, 1]; None for NEG); with ``rest``
    [K-1, *B, l, N], out = [K, *B, l, N] with rest as components 1.."""
    dev = a.device
    sa, ta = _check(a, dev, "a")
    l, n = sa[-2], sa[-1]
    pa = a.data_ptr()
    _rows(pa, sa, ta, "a", l, n)
    batch = sa[:-2]
    ops = [(batch, ta[:-2])]
    const = False
    if b is not None:
        sb, tb = _check(b, dev, "b")
        pb = b.data_ptr()
        const = sb[-1] == 1 and sb[-2] == l and b.numel() == l
        if not const:
            _rows(pb, sb, tb, "b", l, n)
            batch = _broadcast(batch, sb[:-2])
            ops.append((sb[:-2], tb[:-2]))
    K = 1
    if rest is not None:
        sr, tr = _check(rest, dev, "rest")
        K = 1 + sr[0]
        if tuple(sr[1:-2]) != tuple(batch):
            raise ValueError(f"dyadic: rest {tuple(sr)} against components "
                             f"{(*batch, l, n)}")
        pr = rest.data_ptr()
        _rows(pr, sr, tr, "rest", l, n)
        if tr[0] & 3:
            raise ValueError("dyadic: rest's component stride must be a "
                             "multiple of 4 words")
        ops.append((sr[1:-2], tr[1:-2]))
    ms, st = _groups(batch, ops)
    q, r0, r1 = _tables(t, l, dev)
    out = torch.empty((*batch, l, n) if K == 1 else (K, *batch, l, n),
                      dtype=torch.int32, device=dev)
    zero = (0,) * _OPERAND
    words = [pa, *st[0], ta[-2]]
    if b is None:
        words += zero
    elif const:
        words += (pb, *(0,) * GROUPS, tb[-2])
    else:
        words += (pb, *st[1], tb[-2])
    if rest is None:
        words += zero
        words.append(0)
    else:
        words += (pr, *st[-1], tr[-2], tr[0])
    words += (out.data_ptr(), q, r0, r1, K, *ms, l, n)
    _launch("dyadic_binary", _Binary.pack(*words), op, int(const),
            _threads(n), dev=dev)
    return out


def mul_mod(a: torch.Tensor, b: torch.Tensor, t, b_shoup=None) -> torch.Tensor:
    """a·b mod q: b of a's rows, a plaintext broadcast over a's batch, or a
    per-limb constant [l, 1] (``b_shoup``, its Shoup words, is read by the
    plain version alone: the kernel's Barrett product gives the same
    canonical words)."""
    telemetry.count("dyadic.calls")
    if _plain_route(a):
        return mul_mod_plain(a, b, t, b_shoup)
    return _binary(MUL, a, b, t)


def add_mod(a: torch.Tensor, b: torch.Tensor, t, rest=None) -> torch.Tensor:
    """a + b mod q (b as for ``mul_mod``); with ``rest``, [a + b, *rest]:
    the sum as c0 of a ciphertext whose other components are rest."""
    telemetry.count("dyadic.calls")
    if _plain_route(a):
        return add_mod_plain(a, b, t, rest)
    return _binary(ADD, a, b, t, rest)


def sub_mod(a: torch.Tensor, b: torch.Tensor, t, rest=None) -> torch.Tensor:
    """a - b mod q (b as for ``mul_mod``); ``rest`` as for ``add_mod``."""
    telemetry.count("dyadic.calls")
    if _plain_route(a):
        return sub_mod_plain(a, b, t, rest)
    return _binary(SUB, a, b, t, rest)


def neg_mod(a: torch.Tensor, t) -> torch.Tensor:
    """-a mod q."""
    telemetry.count("dyadic.calls")
    if _plain_route(a):
        return neg_mod_plain(a, t)
    return _binary(NEG, a, None, t)


def _merge(sizes, strides):
    """(size, stride) of axes merged into one (outer to inner; size-1 axes
    skipped), or None where they do not merge."""
    size, stride = 1, 0
    for sz, st in zip(sizes, strides):
        if sz == 1:
            continue
        if size == 1:
            size, stride = sz, st
        elif stride == st * sz:
            size, stride = size * sz, st
        else:
            return None
    return size, stride


def mod_sum(x: torch.Tensor, t, axis: int = 0) -> torch.Tensor:
    """Σ over the batch axis `axis` of residues x [.., l, N] mod q: the
    axes before it must merge into one strided group, those after it with
    the limb rows into uniform rows."""
    telemetry.count("dyadic.calls")
    if _plain_route(x):
        return mod_sum_plain(x, t, axis)
    dev = x.device
    sx, tx = _check(x, dev, "x")
    l, n = sx[-2], sx[-1]
    axis %= len(sx)
    if axis >= len(sx) - 2:
        raise ValueError(f"mod_sum: axis {axis} is not a batch axis of "
                         f"{tuple(sx)}")
    px = x.data_ptr()
    _rows(px, sx, tx, "x", l, n)
    pre = _merge(sx[:axis], tx[:axis])
    post = _merge(sx[axis + 1:-1], tx[axis + 1:-1])
    if pre is None or post is None:
        raise ValueError(f"mod_sum: x of shape {tuple(sx)} and strides "
                         f"{tx} does not merge around axis {axis}")
    (O, so), (R, sr), ss = pre, post, tx[axis]
    if so & 3 or ss & 3 or sr & 3:
        raise ValueError("mod_sum: strides must be multiples of 4 words")
    q, r0, r1 = _tables(t, l, dev)
    out = torch.empty((*sx[:axis], *sx[axis + 1:]), dtype=torch.int32,
                      device=dev)
    words = _Sum.pack(px, so, ss, sr, sx[axis], out.data_ptr(), q,
                      r0, r1, O, R, l, n)
    _launch("dyadic_sum", words, _threads(n), dev=dev)
    return out
