"""ctypes bindings for the native host runtime (libckksrt.so).

Counterpart of ``fhe_gpt2_tpu/runtime/native.py``, with the same functions
(``available``, ``encode_evals_to_rns``, ``crt_compose``, ``compress``,
``decompress``) over the port's copy of ``ckksrt.cpp``, and
``coeff_transform``, the transform alone, for ``core/embedding.py``.

The JAX package runs ``make`` in its source directory. The port writes
nothing into its own tree: at first use ``build`` compiles
``native/ckksrt.cpp`` with g++ into ``build/native/<hash>/libckksrt.so``
beside the package, where the hash covers the source, the flags, the
machine and the host CPU's feature flags (``-march=native`` code runs only
on a CPU with those features), as ``core/_cuda.py`` keys
``build/kernels/<hash>/``. The flags are the JAX Makefile's, with GCC's C++
default ``-ffp-contract=fast`` spelled out: numpy's complex multiply fuses
its products where the host has FMA (numpy 2.0 on an AVX-512 host gives
``(u - v) * w`` through fused multiply-adds), and so must the native
butterflies. Built with ``-ffp-contract=off`` instead, the transform at
logN=15 and Δ = 2^54 (an ulp of 4 in a coefficient) rounds 269 of 32768
coefficients of a uniform slot vector differently from numpy's
``coeff_transform``; built as here, the native and numpy routes give the
same words (``tests/test_torch_native.py`` holds them equal).

``available()`` is False where the library cannot be built or loaded (no
g++, no zlib headers); the callers then take the numpy route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "ckksrt.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=fast", "-fPIC",
             "-std=c++17", "-shared")
LIBS = ("-lz",)


def _cpu_flags() -> str:
    """The first "flags" line of /proc/cpuinfo, or "" where there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def library_path() -> Path:
    """Where the library for this source, these flags and this host lives
    (built or not)."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libckksrt.so"


def build() -> Path:
    """Compile the library unless it is there; return its path. Raises
    OSError when there is no g++ and RuntimeError on a compiler error."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # One temporary per process and thread: concurrent first uses each
    # build, and the atomic rename keeps one.
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}-{threading.get_ident()}")
    try:
        p = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp),
                            *LIBS], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ {SRC.name} failed ({p.returncode}):\n"
                               f"{p.stdout}{p.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@lru_cache(maxsize=1)
def _lib():
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        return None
    lib.ckksrt_coeff_transform.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.ckksrt_coeff_transform.restype = None
    lib.ckksrt_round_to_rns.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ckksrt_round_to_rns.restype = None
    lib.ckksrt_crt_compose.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]
    lib.ckksrt_crt_compose.restype = None
    lib.ckksrt_compress_bound.restype = ctypes.c_int64
    lib.ckksrt_compress.restype = ctypes.c_int64
    lib.ckksrt_decompress.restype = ctypes.c_int64
    for f in (lib.ckksrt_compress, lib.ckksrt_decompress):
        f.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ckksrt_compress_bound.argtypes = [ctypes.c_int64]
    return lib


def available() -> bool:
    return _lib() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _bp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


@lru_cache(maxsize=8)
def _twiddle_tables(n: int) -> tuple:
    """Flat stage-indexed twiddle table (entry i at offset i matches the
    _stage_twiddles layout of core/embedding.py: stage s entries at
    [2^s, 2^{s+1}))."""
    from ..core.ntt import bit_reverse
    logn = n.bit_length() - 1
    tw = np.zeros(n, dtype=np.complex128)
    zeta = np.exp(-1j * np.pi / n)   # inverse-direction twiddles
    for s in range(logn):
        m = 1 << s
        for i in range(m):
            tw[m + i] = zeta ** bit_reverse(m + i, logn)
    return (np.ascontiguousarray(tw.real), np.ascontiguousarray(tw.imag))


def coeff_transform(evals: np.ndarray) -> np.ndarray:
    """evals complex128[n] -> the real parts of ``embedding.coeff_transform``
    (float64[n]), computed natively."""
    n = len(evals)
    re = np.array(np.real(evals), dtype=np.float64)     # fresh copies: the
    im = np.array(np.imag(evals), dtype=np.float64)     # transform is in place
    twr, twi = _twiddle_tables(n)
    _lib().ckksrt_coeff_transform(_dp(re), _dp(im), n, _dp(twr), _dp(twi))
    return re


def encode_evals_to_rns(evals: np.ndarray, moduli: list[int]) -> np.ndarray:
    """evals complex128[n] (slot-mapped evaluation vector, already scaled) ->
    uint64[k, n] RNS coefficients: the JAX package's native encode."""
    n = len(evals)
    re = coeff_transform(evals)
    if np.max(np.abs(re)) >= 2 ** 62:
        raise ValueError("encoded coefficient too large")
    mods = np.asarray(moduli, dtype=np.uint64)
    out = np.empty((len(moduli), n), dtype=np.uint64)
    _lib().ckksrt_round_to_rns(_dp(re), n, _up(mods), len(moduli), _up(out))
    return out


def crt_compose(residues: np.ndarray, moduli: list[int],
                scale: float) -> np.ndarray:
    """[k, n] residues (uint32, or the port's int32 words) -> centered
    float64 coefficients / scale."""
    res = np.asarray(residues)
    if res.dtype == np.int32:
        res = res.view(np.uint32)
    res = np.ascontiguousarray(res, dtype=np.uint64)
    k, n = res.shape
    mods = np.asarray(moduli, dtype=np.uint64)
    out = np.empty(n, dtype=np.float64)
    _lib().ckksrt_crt_compose(_up(res), k, n, _up(mods), float(scale),
                              _dp(out))
    return out


def compress(data: bytes) -> bytes:
    """zlib stream of data at level 6."""
    lib = _lib()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = int(lib.ckksrt_compress_bound(len(src)))
    dst = np.empty(cap, dtype=np.uint8)
    out = int(lib.ckksrt_compress(_bp(src), len(src), _bp(dst), cap))
    if out <= 0:
        raise RuntimeError("zlib compress failed")
    return dst[:out].tobytes()


def decompress(data: bytes, raw_size: int) -> bytes:
    """The raw_size bytes of a zlib stream; raises unless the stream holds
    exactly that many."""
    lib = _lib()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(raw_size, dtype=np.uint8)
    out = int(lib.ckksrt_decompress(_bp(src), len(src), _bp(dst), raw_size))
    if out != raw_size:
        raise ValueError(f"zlib stream gave {out} bytes, the header says "
                         f"{raw_size}")
    return dst.tobytes()
