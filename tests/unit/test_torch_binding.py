"""The operator binding and its wrappers, held together by text.

The kernels reach PyTorch through ``torch.ops.urmap`` (csrc/ops.cpp,
built and loaded by kernels/_build.py). No compiler runs here, so the
two sides are compared as text: every operator the binding defines is
implemented for the CUDA key and called by a wrapper in kernels/*.py, and the wrappers call
no operator the binding lacks; the C entry points are declared in one
header that both sides include. No module of the port loads a kernel
library through ctypes any more (the g++ codec library under io/native
is another thing).
"""

import glob
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "urmap_tpu_torch")


def _read(path):
    with open(path) as f:
        return f.read()


OPS_CPP = _read(os.path.join(PKG, "csrc", "ops.cpp"))
DEFINED = re.findall(r'm\.def\(\s*"(\w+)\(', OPS_CPP)
WRAPPERS = {os.path.basename(p): _read(p)
            for p in glob.glob(os.path.join(PKG, "kernels", "*.py"))}
CALLED = {name for text in WRAPPERS.values()
          for name in re.findall(r"torch\.ops\.urmap\.(\w+)\(", text)}


def test_binding_defines_the_eleven_operators():
    """The eleven operators of the mapping kernels (B1-B7), B8's, the
    micro-benchmark's (tools/bench_microvpu.py), and the clip
    traceback's (no TPU kernel: the reference's host clip DP)."""
    assert len(DEFINED) == len(set(DEFINED)) == 11 + 1 + 1
    assert {"window_codes", "window_mismatches", "tb_dops", "tb_bits",
            "row128_fetch", "row128_window_fetch", "rotate_narrow",
            "seed_front", "vote", "banded_dp",
            "banded_semiglobal"} | {"micro_passes", "clip_tb"} \
        == set(DEFINED)


@pytest.mark.parametrize("name", DEFINED)
def test_operator_has_impl_and_wrapper(name):
    assert re.search(rf'm\.impl\("{name}", &{name}\)', OPS_CPP), \
        f"{name}: no CUDA implementation registered"
    assert name in CALLED, f"{name}: no wrapper calls torch.ops.urmap.{name}"


def test_wrappers_call_only_defined_operators():
    assert CALLED == set(DEFINED)
    # each wrapper that launches loads the library first and counts
    for fname, text in WRAPPERS.items():
        n_calls = len(re.findall(r"torch\.ops\.urmap\.\w+\(", text))
        if n_calls:
            assert text.count("_build.load()") == n_calls, fname
            assert len(re.findall(r"\.launched\(", text)) == n_calls, fname


def test_entry_points_are_declared_and_defined():
    """The prototypes of the C entry points stand once, in
    csrc/urmap_kernels.h, which the binding and every kernel source
    include: the compiler holds each definition to its prototype. Every
    prototype is defined by one kernel source and called by the binding,
    which declares none itself."""
    header = _read(os.path.join(PKG, "csrc", "urmap_kernels.h"))
    declared = re.findall(r"^int (urmap_\w+)\(", header, re.M)
    assert len(declared) == len(set(declared)) == 10 + 1 + 1  # B8, clip
    include = '#include "urmap_kernels.h"'
    assert include in OPS_CPP and 'extern "C"' not in OPS_CPP
    defined = []
    for path in glob.glob(os.path.join(PKG, "csrc", "*.cu")):
        text = _read(path)
        assert include in text, os.path.basename(path)
        defined += re.findall(r'extern "C" int (urmap_\w+)\(', text)
    assert sorted(defined) == sorted(declared)
    for name in declared:
        assert re.search(rf"\b{name}\(", OPS_CPP), name
    # the header is part of the build's key
    assert '"*.h"' in WRAPPERS["_build.py"]


def test_no_ctypes_kernel_library_left():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        text = _read(path)
        rel = os.path.relpath(path, PKG)
        if rel.startswith(os.path.join("kernels", "")):
            assert "ctypes" not in text, rel
        assert "urmap_kernels" not in text or rel == os.path.join(
            "kernels", "_build.py"), rel
    build = WRAPPERS["_build.py"]
    assert "torch.ops.load_library" in build and "CDLL" not in build
    # the build is keyed by the sources and the torch version
    assert "torch.__version__" in build
    for text in list(WRAPPERS.values()) + [OPS_CPP]:
        assert not re.search(r"^\s*try\s*:", text, re.M)


def test_mapper_runs_on_the_card_by_default():
    """``Mapper(index)`` asks for "cuda": without a card it raises with
    require_device's message and never falls back to the CPU."""
    import inspect

    from urmap_tpu_torch.map import Mapper

    assert inspect.signature(Mapper.__init__).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError,
                       match=r"torch\.cuda\.is_available\(\) is False"):
        Mapper(index=None)
