"""The card's peaks and the least time a kernel call can take: the
roofline arithmetic of chip_smoke.py's phase 3, frozen here so that the
yardstick does not move with the program.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s
of float32 outside the tensor cores; an SM has 64 lanes of int32 ALU
(min and max, compare, select, logic) against 128 of FMA, so 67e12 / 4
such instructions a second. A call's bound is the larger of its bytes
(inputs read once, outputs written once) over the HBM rate and the
int32 ALU instructions its inputs need at the least over that rate.
"""

from __future__ import annotations

import re

# chip_smoke.py:HBM_BYTES_PER_S, INT32_INSTR_PER_S
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 67e12 / 4


def bound_s(nbytes: float, instr: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, instr / INT32_INSTR_PER_S)


# chip_smoke.py:phase_kernels, B1: per band cell and read row E (add+max),
# the substitution (compare, select), T (add+max), the running max
# (add+max), H over F (add+max): 6, plus 3 a row; clip mode adds the
# fresh start and its share of the row maximum: 7.5; the 16-bit body
# takes two cells an instruction: 3.
def banded_dp_per_cell(kernel_name: str) -> float:
    """Instructions a band cell from the name of the B1 body that ran
    (csrc/banded_dp.cu: banded_dp16_kernel, or banded_dp_kernel<HW,
    CLIP, ...>)."""
    if "banded_dp16_kernel" in kernel_name:
        return 3.0
    m = re.search(r"banded_dp_kernel<\s*\d+\s*,\s*(true|false)", kernel_name)
    if m is None:
        raise ValueError(f"not a B1 body: {kernel_name!r}")
    return 7.5 if m.group(1) == "true" else 6.0


def banded_dp_bound_s(n: int, win_len: int, read_pad: int, read_len: int,
                      hw: int, kernel_name: str) -> float:
    """B1 over ``n`` candidates: windows uint8[n, win_len], reads
    uint8[n, read_pad] of ``read_len`` bases, lengths int32[n]; outputs
    four int32[n] (scores, d0, d1, ungapped)."""
    rows = n * min(read_len, read_pad)
    instr = rows * ((2 * hw + 1) * banded_dp_per_cell(kernel_name) + 3)
    nbytes = n * (win_len + read_pad + 4) + 4 * 4 * n
    return bound_s(nbytes, instr)


# chip_smoke.py:phase_kernels, B6: per band cell and read row 15 (E and
# the ee compare 2, the substitution 2, T 1, the running max and H 2,
# the fe compare 1, hc 4, the nibble 3); its walk ~12 more a row
def tb_dp_bound_s(n: int, win_len: int, read_pad: int, read_len: int,
                  hw: int) -> float:
    """B6 over ``n`` winners: windows uint8[n, win_len], reads uint8[n,
    read_pad] of ``read_len`` bases, lengths int32[n]; outputs the score
    int32[n], one byte a read row of records, walk_ok bool[n]."""
    rows = n * min(read_len, read_pad)
    instr = rows * ((2 * hw + 1) * 15 + 12)
    nbytes = n * (win_len + read_pad + 4) + n * (4 + read_pad + 1)
    return bound_s(nbytes, instr)
