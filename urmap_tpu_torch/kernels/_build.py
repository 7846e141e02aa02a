"""Build and load the CUDA kernels: nvcc → one shared library →
``torch.ops.urmap``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) with a plain C
interface and no torch header (the prototypes stand once, in
``csrc/urmap_kernels.h``); ``csrc/ops.cpp`` binds those entry points to
PyTorch as operators of the ``urmap`` namespace (checks, outputs from
``at::empty``, PyTorch's current stream) and is the one source compiled
against torch's headers. One nvcc per source, all side by side, then one
link against torch's libraries, at first use, into
``build/urmap_tpu_torch/`` at the repository root, keyed by a hash of
the sources and the torch version (a changed source builds anew; a
library built against another torch is never loaded).
``torch.ops.load_library`` registers the operators; the wrappers in this
package call ``torch.ops.urmap.<name>`` after ``load()``.
"""

from __future__ import annotations

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
TORCH_LIBS = ("c10", "c10_cuda", "torch_cpu", "torch_cuda", "torch")

_lock = threading.Lock()
_loaded = False
# seconds: the whole build; by_source: each compile's and the link's
build_log = {"seconds": None, "by_source": {}, "ptxas": "", "path": None}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh"))
                  + glob.glob(os.path.join(CSRC, "*.h"))
                  + glob.glob(os.path.join(CSRC, "*.cpp")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    import torch

    h = hashlib.sha256(torch.__version__.encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"urmap_kernels_{h.hexdigest()[:16]}.so")


def _compile_cmd(nvcc: str, src: str, obj: str) -> list[str]:
    cmd = [nvcc, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c", "-o", obj]
    if src.endswith(".cu"):
        return cmd + [ARCH, "-Xptxas", "-v", src]
    # the binding: host code only, against torch's headers
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return cmd + [f"-D_GLIBCXX_USE_CXX11_ABI={abi}"] \
        + [f"-I{p}" for p in cpp_extension.include_paths()] + [src]


def build() -> str:
    """Compile the kernels and their binding if the library for these
    sources is missing; returns its path. ``build_log`` keeps the times
    and the ptxas register/spill report."""
    so = library_path()
    if os.path.exists(so):
        build_log["path"] = so
        return so
    from torch.utils import cpp_extension

    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if not s.endswith((".cuh", ".h"))]
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen(_compile_cmd(nvcc, src, obj),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for src, obj in zip(srcs, objs)]
    done = {}

    def wait(src, p):
        log = p.communicate()[1]
        done[src] = (log, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=sp)
               for sp in zip(srcs, procs)]
    for th in waiters:
        th.start()
    for th in waiters:
        th.join()
    for src, p in zip(srcs, procs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({p.returncode}):\n{done[src][0]}")
    t1 = time.perf_counter()
    lib_dirs = cpp_extension.library_paths()
    res = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", tmp] + objs
        + [f"-L{d}" for d in lib_dirs] + [f"-l{name}" for name in TORCH_LIBS]
        + [a for d in lib_dirs for a in ("-Xlinker", "-rpath", "-Xlinker", d)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so)
    by_source = {os.path.basename(s): done[s][1] for s in srcs}
    by_source["link"] = time.perf_counter() - t1
    build_log.update(seconds=time.perf_counter() - t0, by_source=by_source,
                     ptxas="".join(done[s][0] for s in srcs
                                   if s.endswith(".cu")), path=so)
    return so


def load() -> None:
    """Register ``torch.ops.urmap``: the kernel library, built on first
    use."""
    global _loaded
    if _loaded:
        return
    import torch

    with _lock:
        if not _loaded:
            torch.ops.load_library(build())
            _loaded = True
