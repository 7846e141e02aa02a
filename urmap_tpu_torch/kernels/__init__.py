"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

Each wrapper takes tensors on one device. On a CUDA tensor it launches
its kernel or raises; on a CPU tensor it runs the kernel's plain PyTorch
version. There is no other fallback: no preflight that swaps a failed
kernel for its plain version, no environment switch, no ``try`` around
a build or a launch. Each wrapper counts what it ran (``Counter``), so a
run can show that the main path went through the kernels.
"""

from __future__ import annotations


class Counter:
    """Launches of a kernel and calls of its plain version. ``widths``
    splits the launches by output width, for the wrappers that record
    it (the window fetches: one kernel each, the verify, DP and rescue
    shapes)."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.widths: dict[int, int] = {}

    def launched(self, width: int | None = None) -> None:
        self.launches += 1
        if width is not None:
            self.widths[width] = self.widths.get(width, 0) + 1


def counters() -> list[Counter]:
    """Every kernel's counter, in main-path order. The last four have
    no caller on the mapping path: B1' in both modes (the byte-genome
    DP; the mapper aligns from the packed genome), the literal rotate of
    B5 (the fetch entries never gather whole rows) and B7's bits mode.
    B5's plain window entry serves the classic layout's positions only:
    no launch on the aligned and row128 layouts."""
    from urmap_tpu_torch.kernels import (banded_dp, lane_rotate, seed_slots,
                                         tb_dp, vote)

    return [seed_slots.counter, lane_rotate.fetch_counter, vote.counter,
            lane_rotate.mismatch_counter, lane_rotate.codes_counter,
            banded_dp.counter, banded_dp.clip_counter, tb_dp.counter,
            lane_rotate.window_counter, banded_dp.semiglobal_counter,
            banded_dp.semiglobal_clip_counter, lane_rotate.rotate_counter,
            tb_dp.bits_counter]


# counters of kernels that the aligned and row128 mapping paths never
# launch
OFF_PATH = ("row128_window_fetch", "banded_semiglobal",
            "banded_semiglobal_clip", "rotate_narrow", "tb_bits")
