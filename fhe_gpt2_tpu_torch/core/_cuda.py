"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

The output directory is keyed by a hash of every source and header, so an
edit rebuilds and an unchanged tree reuses what is there. Libraries are
loaded with ctypes; every pointer and the stream are ``c_void_p``, every
C entry returns ``cudaGetLastError()`` and ``check`` raises if it is not 0.

Nothing here runs at import: the first kernel launch builds and loads.
``LAUNCHES`` counts, per kernel, the calls that launched it on the card
(``count``, under a lock: a mesh launches from one thread per position);
the plain versions never touch it. ``mac`` counts the wrapper calls that
launched an entry of ``csrc/mac.cu`` (``tks.hoisted_mac``,
``tks.add_lifted``, ``tks.masked_sum``: a masked sum of many terms is one
call of several launches); ``dyadic`` the wrapper calls that launched an
entry of ``csrc/dyadic.cu`` (``core/tdyadic.py``: the evaluator's tensor
products, products, adds and batch sums).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ntt", "keyswitch", "moddown", "mac", "dyadic")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# The C entries and their argument kinds: "p" pointer/stream, "i" int,
# "l" 64-bit int.
_ENTRIES = {
    "ntt": {
        "ntt_forward": "ppppp" + "l" + "i" * 5 + "p",
        "ntt_inverse": "ppppppp" + "l" + "i" * 5 + "p",
    },
    "keyswitch": {
        "ks_fused": "p" * 16 + "i" * 8 + "p",
    },
    "moddown": {
        "md_fused": "p" * 18 + "i" * 6 + "p",
    },
    "mac": {
        "hoisted_mac": "p" * 7 + "i" * 5 + "p",
        "add_lifted": "p" * 6 + "i" * 5 + "p",
        "masked_sum": "pi" + "p" * 4 + "i" * 5 + "p",
    },
    "dyadic": {
        "dyadic_binary": "piiip",
        "dyadic_tensor": "piip",
        "dyadic_sum": "pip",
    },
}

LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "keyswitch": 0, "moddown": 0,
            "mac": 0, "dyadic": 0}

_libs: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()      # LAUNCHES and the first build and load


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(kernel: str) -> None:
    """Add one launch of `kernel` to LAUNCHES."""
    with _LOCK:
        LAUNCHES[kernel] += 1


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (set CUDA_HOME)")


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The nvcc command that builds src (its headers beside it) into the
    shared library out."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
            str(src)]


def build() -> dict[str, Path]:
    """Compile every source that is not yet built for this hash, in
    parallel; returns {name: library path}. Raises on any compiler error."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    if todo:
        procs = []
        for name in todo:
            tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
            cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n{out}")
            else:
                os.replace(tmp, libs[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def load(path: Path, name: str) -> ctypes.CDLL:
    """Load a library built from csrc/<name>.cu and type its C entries."""
    lib = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
    for fn, sig in _ENTRIES[name].items():
        f = getattr(lib, fn)
        f.argtypes = [kinds[c] for c in sig]
        f.restype = ctypes.c_int
    return lib


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _libs:
            _libs[name] = load(build()[name], name)
        return _libs[name]


def call(lib: str, fn: str, *args, cdll: ctypes.CDLL | None = None,
         device: torch.device | None = None) -> None:
    """Launch one C entry on the device of its first tensor argument (or
    ``device``, where the arguments hold no tensor), made the current
    device for the launch, and on this thread's current stream of that
    device; raise if it reports an error. Tensors are passed by data
    pointer, the stream last. ``cdll`` takes the entry from another build of
    csrc/<lib>.cu than this tree's.

    Under CUDA-graph capture (``nn/backend.py`` ``jit_sealed``) the capture
    stream is the current one, so the cluster launch is recorded as a
    kernel node with its cluster dimension. What must not happen inside a
    capture happens at the first launch, which a sealed call's warm pass
    makes before capturing: the nvcc build, the library load and each
    instantiation's module load."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    dev = device or next(a.device for a in args
                         if isinstance(a, torch.Tensor))
    entry = getattr(cdll or _libs.get(lib) or _lib(lib), fn)
    here = torch.cuda.current_device()
    idx = here if dev.index is None else dev.index
    if idx == here:
        rc = entry(*conv, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = entry(*conv, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {lib}.{fn} failed: error {rc}")


def check_operand(x: torch.Tensor, name: str, shape=None,
                  contiguous: bool = True) -> None:
    """What every wrapper checks before it hands a pointer to a kernel;
    ``contiguous=False`` leaves the layout to the caller."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32, got {x.dtype}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
