"""No JAX and no JAX package: top-level names compared whole."""

import subprocess
import sys

from benchmark.harness.guard import forbidden_loaded
from benchmark.tests.conftest import ROOT


def test_whole_top_level_names():
    mods = ["urmap_tpu_torch", "urmap_tpu_torch.map.pipeline", "jaxtyping",
            "torch", "numpy", "urmap_tpu_torchx"]
    assert forbidden_loaded(mods) == []
    assert forbidden_loaded(mods + ["urmap_tpu.map"]) == ["urmap_tpu"]
    assert forbidden_loaded(["jax.numpy", "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_harness_and_port_load_neither():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.readings\n"
            "from benchmark.harness import cell_run, window, trace\n"
            "from benchmark.reference import judge\n"
            "import urmap_tpu_torch.cli, urmap_tpu_torch.map.pair\n"
            "from benchmark.harness.guard import forbidden_loaded\n"
            "print(forbidden_loaded(list(sys.modules)))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
