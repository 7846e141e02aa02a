"""Kernels: ``csrc/banded_dp.cu`` (B1, both modes). The sum of each
traced ``urmap::banded_dp`` call's bound (harness/bounds.py, over the
candidates, window and read widths of its recorded input shapes, the
traffic's read length and the configuration's band) over the sum of the
device time of its kernels, in %."""

from benchmark.harness.bounds import banded_dp_bound_s


def read(run):
    d = run["trace"]
    if d is None:
        return None
    hw = run["config"]["map_overrides"].get("band_halfwidth", 16)
    L = run["traffic"]["params"]["read_len"]
    bound = dev = 0.0
    for op in d.ops:
        if op["name"] != "urmap::banded_dp" or not op["kernels"]:
            continue
        (n, win), (_, pad) = op["shapes"][0], op["shapes"][1]
        name = op["kernels"][0][0]
        bound += banded_dp_bound_s(n, win, pad, L, hw, name)
        dev += sum(us for _, us in op["kernels"]) / 1e6
    return 100.0 * bound / dev if dev > 0 else None
