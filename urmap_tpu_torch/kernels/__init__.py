"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

Each wrapper takes tensors on one device. On a CUDA tensor it launches
its kernel or raises; on a CPU tensor it runs the kernel's plain PyTorch
version. There is no other fallback: no preflight that swaps a failed
kernel for its plain version, no environment switch, no ``try`` around
a build or a launch. Each wrapper counts what it ran (``Counter``), so a
run can show that the main path went through the kernels.

The one map that runs on the CPU by design beside a card's (the wide
second pass, map.pipeline.WideSecondPass, as the reference runs it on
its host) counts its plain calls apart, under ``host_pass()``: a card
run's ``plain_calls`` stay 0 with the second pass on.
"""

from __future__ import annotations

import threading

_scope = threading.local()


class host_pass:
    """``with host_pass():`` plain calls made in this thread inside the
    block count as ``host_pass_calls``, not ``plain_calls``."""

    def __enter__(self):
        self._prev = getattr(_scope, "host", False)
        _scope.host = True

    def __exit__(self, *exc):
        _scope.host = self._prev


class Counter:
    """Launches of a kernel and calls of its plain version (outside and
    inside ``host_pass()``). ``widths`` splits the launches by a size
    the wrapper records: the fetches' output width (the window entries:
    the verify, DP and rescue shapes; the row entry: the tiered
    gather's narrow and full-width passes, and positions_per_seed), B1's
    candidate count, B4's candidates a read (seeds_per_read x
    positions_per_seed)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.host_pass_calls = 0
        self.widths: dict[int, int] = {}

    def plain(self) -> None:
        with self._lock:
            if getattr(_scope, "host", False):
                self.host_pass_calls += 1
            else:
                self.plain_calls += 1

    def launched(self, width: int | None = None) -> None:
        self.launches += 1
        if width is not None:
            self.widths[width] = self.widths.get(width, 0) + 1


class Rounds:
    """Calls of a loop on the mapping path that reads its condition
    back from the device each round, and the rounds they ran. Every
    thread's calls count here."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.rounds = 0

    def add(self, rounds: int) -> None:
        with self._lock:
            self.calls += 1
            self.rounds += rounds


# the tiered gather's overflow rounds (map.seed.gather_runs ``tier``)
tier_rounds = Rounds()


def counters() -> list[Counter]:
    """Every kernel's counter, in main-path order (the seed front's
    slots mode beside the front: the sharded routes run it in the
    front's place). The last five have
    no caller on the mapping path: B1' in both modes (the byte-genome
    DP; the mapper aligns from the packed genome), the literal rotate of
    B5 (the fetch entries never gather whole rows), B7's bits mode and
    B8 (the micro-benchmark's kernel, tools/bench_microvpu.py's alone).
    B5's plain window entry serves the classic layout's positions only:
    no launch on the aligned and row128 layouts."""
    from urmap_tpu_torch.kernels import (banded_dp, lane_rotate, micro,
                                         seed_slots, tb_dp, vote)

    return [seed_slots.counter, seed_slots.slots_counter,
            lane_rotate.fetch_counter, vote.counter,
            lane_rotate.mismatch_counter, lane_rotate.codes_counter,
            banded_dp.counter, banded_dp.clip_counter, tb_dp.counter,
            lane_rotate.window_counter, banded_dp.semiglobal_counter,
            banded_dp.semiglobal_clip_counter, lane_rotate.rotate_counter,
            tb_dp.bits_counter, micro.counter]


# counters of kernels that the aligned and row128 mapping paths on one
# card never launch (the slots mode of the seed front runs on the sharded
# routes only, dist/sharded.py; B8 runs in its micro-benchmark tool only)
OFF_PATH = ("seed_front_slots", "row128_window_fetch", "banded_semiglobal",
            "banded_semiglobal_clip", "rotate_narrow", "tb_bits",
            "micro_passes")
# under end_clip every DP runs in clip mode (the clip-rescue lane is off)
# and the device traceback is off (map.pipeline.tb_enabled)
OFF_PATH_END_CLIP = OFF_PATH + ("banded_dp", "tb_dops")
