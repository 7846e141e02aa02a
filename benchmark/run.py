"""The benchmark of urmap_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell names a configuration
(``benchmark/configs/``) and a read mix (``benchmark/traffic/``) in
``BENCHMARK.json``. Set-up builds the genome, the index and the read
pool from the seed and warms the stream up; the window then runs the
port's streaming map loop for ``--seconds``; the check judges a sample
of the window's SAM records with the plain reference. The last line of
standard output is the result as one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
the device's busy time and the breakdown. Without a CUDA card it exits
1 and prints no result; so it does if JAX or the JAX package got loaded.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_lines(torch) -> None:
    """The card, its power limit, the host CPU and torch, on stderr."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cpu = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), cpu)
    except OSError:
        pass
    print(f"card {torch.cuda.get_device_name(0)}; nvidia-smi "
          f"{smi.stdout.strip()!r}; host {cpu} x {os.cpu_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # transformers and friends must not bring JAX in on their own
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    from benchmark.harness import mallopt, manifest

    cell = manifest.load_cell(ROOT, a.workload)
    mallopt.apply(cell.config.get("mallopt", {}))
    import torch

    from benchmark.harness import cell_run, guard

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    host_lines(torch)
    result, checks = cell_run.run(ROOT, a.workload, a.seed % (1 << 63),
                                  a.seconds, bool(a.trace),
                                  torch.device("cuda", 0), T_PROC0)
    bad = guard.forbidden_loaded(list(sys.modules))
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    result["check"] = {name: {"value": value, "limit": limit}
                       for name, value, limit in checks}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
