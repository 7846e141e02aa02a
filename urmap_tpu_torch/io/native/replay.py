"""ctypes binding of replay.cpp: the host replay of the clip traceback's
records (map/clip_tb.py).

Built with g++ at first use, as codecs.cpp is (io/native/__init__.py),
into the same build directory, keyed on a content hash of the source.
``lib()`` returns None when no compiler is available; callers then run
the host DP.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from urmap_tpu_torch.io import native

_SRC = os.path.join(native._DIR, "replay.cpp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(native._BUILD_DIR, exist_ok=True)
    return os.path.join(native._BUILD_DIR, f"_replay_{h}.so")


def _build(so: str) -> bool:
    try:
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        print(f"urmap_tpu_torch: clip replay build failed ({e}); the host "
              "DP serves the clip-rescued rows", file=sys.stderr)
        return False


def lib() -> ctypes.CDLL | None:
    """The replay library, building it on first use; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lb = ctypes.CDLL(so)
        except OSError as e:
            print(f"urmap_tpu_torch: clip replay load failed ({e})",
                  file=sys.stderr)
            return None
        lb.urmap_clip_replay_batch.restype = native.c_i64
        lb.urmap_clip_replay_batch.argtypes = [
            native.p_i32, native.c_i64, native.c_i64, native.p_i32,
            native.p_i32, native.p_u8, native.c_i64, native.p_i64,
            native.p_u8, native.c_i64, native.c_i64, ctypes.c_void_p,
            native.c_i64, native.p_i64, native.p_i32, native.p_i32,
            native.p_u8]
        _lib = lb
        return _lib


def clip_replay_batch(recs: np.ndarray, cols: np.ndarray,
                      lengths: np.ndarray, genome: np.ndarray,
                      starts: np.ndarray, reads: np.ndarray):
    """Replay the clip traceback's records of ``len(cols)`` rows →
    ((blob, offsets int64[n+1]), nm int32[n], span int32[n], ok
    bool[n]), or None without the library. ``reads``: STRAND-APPLIED
    codes [n, >= L]; ``starts``: the rows' POS. Rows with ok False have
    empty entries and go to the host DP."""
    lb = lib()
    if lb is None:
        return None
    n = cols.shape[0]
    L = reads.shape[1] if n else 0
    recs = np.ascontiguousarray(recs, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    lens32 = np.ascontiguousarray(lengths, np.int32)
    genome = np.ascontiguousarray(genome, np.uint8)
    starts64 = np.ascontiguousarray(starts, np.int64)
    reads = np.ascontiguousarray(reads, np.uint8)
    cap = n * (6 * L + 32) + 64
    while True:
        cig = np.empty(cap, np.uint8)
        cig_off = np.empty(n + 1, np.int64)
        nm = np.empty(n, np.int32)
        span = np.empty(n, np.int32)
        ok = np.empty(n, np.uint8)
        rc = lb.urmap_clip_replay_batch(
            recs.ctypes.data_as(native.p_i32), recs.shape[0], recs.shape[1],
            cols32.ctypes.data_as(native.p_i32),
            lens32.ctypes.data_as(native.p_i32),
            genome.ctypes.data_as(native.p_u8), genome.shape[0],
            starts64.ctypes.data_as(native.p_i64),
            reads.ctypes.data_as(native.p_u8), L, n,
            cig.ctypes.data_as(ctypes.c_void_p), cap,
            cig_off.ctypes.data_as(native.p_i64),
            nm.ctypes.data_as(native.p_i32),
            span.ctypes.data_as(native.p_i32),
            ok.ctypes.data_as(native.p_u8))
        if rc == 0:
            return ((cig[: cig_off[n]].tobytes(), cig_off), nm, span,
                    ok.astype(bool))
        cap *= 2
