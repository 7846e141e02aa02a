"""Unfused elementwise ops against one hand kernel, on the same work.

The port of tools/bench_microvpu.py. Three programs over the same
operands, each call forced by a fetch to the host:

  null    — one element and one add: the fixed cost of a call
  torch   — PASSES rounds of uint32 multiply / xor-shift / add as
            separate torch ops (kernels.micro.plain_passes, some five
            launches a round), then the uint32 sum
  kernel  — the same rounds as one launch of kernel B8
            (kernels.micro.passes, csrc/micro_passes.cu), then the sum

If (torch - null) >> (kernel - null), launches and the unfused passes
over memory, not the arithmetic, set the pace of such work on the card.

Same flags, operands (``default_rng(0)``, 4 arrays of [n, w] uint32
words, here int32 tensors with the same bits), warm-up, iteration order
and printed lines as the source, with these departures:
- ``--cpu`` runs on the CPU (for the tests); without it the tool runs on
  the CUDA card and raises before any work when there is none;
- the rows are labelled ``torch`` and ``kernel`` (the source's ``jnp``
  and ``pallas``), and the ``torch`` row runs the plain version on the
  card's tensors on purpose, as the source times its jnp twin;
- the ``marginal:`` line's roofline is this card's bound (below), not
  the TPU's;
- every word is computed: the source's grid of N // 2048 blocks leaves
  the rows past the last whole block unwritten when N is not a multiple
  of 2,048.

    python -m urmap_tpu_torch.tools.bench_microvpu [--n 65536] [--w 128]
        [--iters 10] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# The card's peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s of float32 = 16.75e12 int32 ALU instructions a second (64 of
# the SM's 128 lanes, one instruction a lane and clock). The bound is the
# larger of the bytes (each word read once and written once) and the ALU
# instructions (two a round and word, the shift and the xor; the multiply
# and the add fold into one IMAD on the FMA pipe), as chip_smoke.py counts.
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4


def bound_ms(n: int, w: int, passes: int) -> tuple[float, str]:
    """The least ms the card could take for ``passes`` rounds over an
    [n, w] array, and what sets it ("bytes" or "operations")."""
    by_bytes = 2 * 4 * n * w / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * passes * n * w / INT32_INSTR_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else \
        "operations"


def operands(n: int, w: int, device):
    """The source's four operands: uint32 [n, w] from default_rng(0), as
    int32 tensors on ``device``."""
    import torch

    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, 1 << 32, size=(n, w),
                                          dtype=np.uint32).view(np.int32))
            .to(device) for _ in range(4)]


def run(argv=None) -> dict:
    """Time the three programs and print the source's lines; returns the
    times, the card's bound and each program's last result (as uint32)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--w", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the "
                         "CUDA card")
    args = ap.parse_args(argv)

    from urmap_tpu_torch.device import require_device
    from urmap_tpu_torch.kernels import micro

    # the card unless --cpu: raises here, before any work, without one
    device = require_device("cpu" if args.cpu else "cuda")
    xs = operands(args.n, args.w, device)

    def f_null(x):
        return x[0, 0] + 1

    def f_torch(x):
        return micro.u32_sum(micro.plain_passes(x))

    def f_kernel(x):
        return micro.u32_sum(micro.passes(x))

    def timeit(fn, label):
        fn(xs[0]).cpu()  # build + warm
        fn(xs[1]).cpu()
        t0 = time.perf_counter()
        for i in range(args.iters):
            last = fn(xs[i % len(xs)]).cpu()
        dt = (time.perf_counter() - t0) / args.iters
        print(f"  {label:8s} {dt * 1e3:8.2f} ms", flush=True)
        return dt, int(last) & 0xFFFF_FFFF

    elems = args.n * args.w
    bound, bound_by = bound_ms(args.n, args.w, micro.PASSES)
    print(f"[{args.n}x{args.w}] u32, {micro.PASSES} passes of mul/xor/add "
          f"({3 * micro.PASSES * elems / 1e6:.0f} M vector ops)")
    t_null, s_null = timeit(f_null, "null")
    t_torch, s_torch = timeit(f_torch, "torch")
    t_kern, s_kern = timeit(f_kernel, "kernel")
    print(f"marginal: torch {1e3 * (t_torch - t_null):.2f} ms, "
          f"kernel {1e3 * (t_kern - t_null):.2f} ms "
          f"(roofline ~{bound:.2f} ms)")
    return {"n": args.n, "w": args.w, "passes": micro.PASSES,
            "iters": args.iters, "device": str(device),
            "ms": {"null": 1e3 * t_null, "torch": 1e3 * t_torch,
                   "kernel": 1e3 * t_kern},
            "bound_ms": bound, "bound_by": bound_by,
            "sums": {"null": s_null, "torch": s_torch, "kernel": s_kern},
            "last_operand": (args.iters - 1) % len(xs)}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
