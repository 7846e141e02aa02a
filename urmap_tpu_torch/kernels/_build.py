"""Build and load the CUDA kernels: nvcc → one shared library → ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``), one nvcc per
source side by side, and linked into one shared library with a plain C
interface, at first use, into
``build/urmap_tpu_torch/`` at the repository root, keyed by a hash of
the sources (a changed source builds anew; a stale library is never
loaded). Pointers and the CUDA stream cross as ``c_void_p``. Every C
entry point returns ``cudaGetLastError()``; ``check`` raises if it is
not 0, so a refused launch is reported where it happened.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "urmap_tpu_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = {"seconds": None, "ptxas": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point → argument types (pointers, ints, then the stream)
_SIGNATURES = {
    "urmap_seed_slots": [_P] * 6 + [_I] * 6 + [_P],
    "urmap_vote": [_P, _P, _P] + [_I] * 3 + [_P],
    "urmap_banded_dp": [_P] * 7 + [_I] * 9 + [_P],
    "urmap_tb_dp": [_P] * 7 + [_I] * 8 + [_P],
    "urmap_row128_fetch": [_P, _L, _I, _P, _P, _L, _I, _I, _P],
    "urmap_rotate_narrow": [_P, _P, _P, _L, _I, _I, _P],
    "urmap_banded_semiglobal": [_P, _L, _P, _P, _P] + [_P] * 4 + [_I] * 9
    + [_P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"urmap_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. ``build_log`` keeps the compile time and the
    ptxas register/spill report."""
    so = library_path()
    if os.path.exists(so):
        build_log["path"] = so
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-c", "-o", obj, src], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[1] for p in procs]
    for src, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({p.returncode}):\n{log}")
    res = subprocess.run([nvcc, ARCH, "-shared", "-o", tmp] + objs,
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so)
    build_log.update(seconds=time.perf_counter() - t0,
                     ptxas="".join(logs), path=so)
    return so


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t, name: str, dtype, ndim: int) -> None:
    """Validate a kernel argument: CUDA, dtype, rank, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
