"""Kernels: ``csrc/tb_dp.cu`` (B6). The sum of each traced
``urmap::tb_dops`` call's bound (harness/bounds.py, over the winners,
window and read widths of its recorded input shapes, the traffic's read
length and the configuration's band) over the sum of the device time of
its kernels, in %."""

from benchmark.harness.bounds import tb_dp_bound_s


def read(run):
    d = run["trace"]
    if d is None:
        return None
    hw = run["config"]["map_overrides"].get("band_halfwidth", 16)
    L = run["traffic"]["params"]["read_len"]
    bound = dev = 0.0
    for op in d.ops:
        if op["name"] != "urmap::tb_dops" or not op["kernels"]:
            continue
        (n, win), (_, pad) = op["shapes"][0], op["shapes"][1]
        bound += tb_dp_bound_s(n, win, pad, L, hw)
        dev += sum(us for _, us in op["kernels"]) / 1e6
    return 100.0 * bound / dev if dev > 0 else None
