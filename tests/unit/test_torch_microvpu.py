"""Kernel B8's plain version and its tool against tools/bench_microvpu.py,
on the CPU.

The source is read, not imported: its ``PASSES`` and the ``body``
nested in its ``main`` are taken from the file by ``ast`` and ``body``
runs eagerly on jnp uint32 arrays, its ``f_jnp`` without the jit. That
is the source's plain reference; its Pallas program needs a TPU. The
port's ``kernels.micro.plain_passes`` on the int32 view must give the
same bits, ``u32_sum`` the same uint32 sum, and the port's tool
(``urmap_tpu_torch.tools.bench_microvpu``) with ``--cpu`` the source's
lines and that sum from both of its computing rows. Integers: tolerance
0. The kernel itself runs on the card only (test_torch_cuda.py,
chip_smoke.py phases 3 and 17).
"""

import ast
import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu_torch import kernels
from urmap_tpu_torch.kernels import micro
from urmap_tpu_torch.tools import bench_microvpu as tool

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "tools", "bench_microvpu.py")


def _source():
    """(PASSES, body) of tools/bench_microvpu.py, ``body`` compiled from
    its own lines with ``jnp`` and ``PASSES`` as its globals."""
    with open(SOURCE) as f:
        tree = ast.parse(f.read())
    passes = next(ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and [t.id for t in n.targets] == ["PASSES"])
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "body")
    ns = {"jnp": jnp, "PASSES": passes}
    exec(compile(ast.Module(body=[node], type_ignores=[]), SOURCE, "exec"),
         ns)
    return passes, ns["body"]


PASSES, BODY = _source()


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _reference(x):
    """body(x) and jnp.sum(body(x), dtype=uint32), as numpy uint32."""
    h = BODY(jnp.asarray(x))
    return np.asarray(h), int(jnp.sum(h, dtype=jnp.uint32))


@pytest.mark.parametrize("shape", [(2048, 128), (7, 3)])
def test_plain_passes_equal_source_body(shape):
    assert PASSES == micro.PASSES == 24
    x = _words(int(np.prod(shape)), shape)
    want, want_sum = _reference(x)
    got = micro.plain_passes(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert int(micro.u32_sum(got)) == want_sum
    # a word changes in every round: the rounds are not the identity
    assert (want != x).mean() > 0.99


@pytest.mark.parametrize("shape", [(2048, 128), (7, 3)])
def test_smoke_numpy_body_equals_source_body(shape):
    """chip_smoke.py phase 17(e) holds the tool's sums on the card to a
    numpy uint32 computation of body: that one against the source."""
    import chip_smoke

    x = _words(3, shape)
    np.testing.assert_array_equal(chip_smoke.micro_numpy(x, PASSES),
                                  _reference(x)[0])


def test_passes_wrapper_runs_the_plain_version_on_a_cpu_tensor():
    x = torch.from_numpy(_words(5, (64, 8)).view(np.int32))
    micro.counter.reset()
    got = micro.passes(x)
    assert (micro.counter.plain_calls, micro.counter.launches) == (1, 0)
    assert torch.equal(got, micro.plain_passes(x))
    # counted with the kernels, and off every mapping path
    assert micro.counter in kernels.counters()
    assert "micro_passes" in kernels.OFF_PATH
    assert "micro_passes" in kernels.OFF_PATH_END_CLIP


def test_tool_on_the_cpu_prints_the_source_lines():
    argv = ["--cpu", "--n", "2048", "--w", "16", "--iters", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tool.run(argv)
    lines = out.getvalue().splitlines()
    assert lines[0] == ("[2048x16] u32, 24 passes of mul/xor/add "
                        "(2 M vector ops)")
    assert [ln.split()[0] for ln in lines[1:4]] == ["null", "torch",
                                                    "kernel"]
    assert all(ln.startswith("  ") and ln.endswith(" ms")
               for ln in lines[1:4])
    assert lines[4].startswith("marginal: torch ") and \
        ", kernel " in lines[4] and lines[4].endswith(" ms)")
    assert len(lines) == 5
    # the source's operands: four arrays from default_rng(0), the last
    # call on operand (iters - 1) % 4
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 1 << 32, size=(2048, 16), dtype=np.uint32)
          for _ in range(4)]
    x = xs[res["last_operand"]]
    want = _reference(x)[1]
    assert res["sums"]["torch"] == res["sums"]["kernel"] == want
    assert res["sums"]["null"] == (int(x[0, 0]) + 1) & 0xFFFF_FFFF
    assert res["device"] == "cpu" and set(res["ms"]) == {"null", "torch",
                                                         "kernel"}


def test_tool_bound_is_the_cards():
    """The card's bound at the source's defaults: 8,388,608 words, 48
    int32 ALU instructions each over 16.75e12 a second (0.024 ms) against
    67,108,864 bytes over 3.35 TB/s (0.020 ms)."""
    b, by = tool.bound_ms(65536, 128, 24)
    assert by == "operations"
    assert b == pytest.approx(65536 * 128 * 48 / 16.75e12 * 1e3, rel=1e-12)
    b, by = tool.bound_ms(65536, 128, 8)
    assert by == "bytes"
    assert b == pytest.approx(65536 * 128 * 8 / 3.35e12 * 1e3, rel=1e-12)


def test_tool_raises_without_a_card_before_any_work(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool runs on it")

    def no_work(*args, **kwargs):
        raise AssertionError("operands made before the device check")

    monkeypatch.setattr(tool, "operands", no_work)
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available"):
        tool.main(["--n", "8", "--w", "4", "--iters", "1"])
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available"):
        tool.main([])
