"""The traced run's profile: torch.profiler (host ops and the card's
activity, with input shapes) over ``batches`` batches of the window,
started on the dispatch thread as the first batch to leave the reader
``after_s`` into the window does, and stopped ``batches`` batches (or ``max_s``) later. The dispatch thread's phases
are marked (``bench.wait_format``, ``bench.wait_input``,
``bench.start_batch``, ``bench.finish_batch``) so that an idle gap of the card can be named by
what that thread was doing.

``digest`` reduces the profile to what the per-layer readers take:
the device operations (name, start, duration), the urmap operators with
their input shapes and the device time and kernel names under them,
the traced window's length and batches, and the breakdown.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

MARKS = ("bench.wait_format", "bench.wait_input", "bench.start_batch",
         "bench.finish_batch")


@dataclass
class Digest:
    window_us: float
    batches: int
    device_ops: list                 # (name, start_us, dur_us)
    ops: list = field(default_factory=list)   # urmap operator records
    marks: list = field(default_factory=list)  # (name, start_us, end_us)


class Tracer:
    def __init__(self, after_s: float, batches: int, max_s: float):
        self.after_s, self.batches, self.max_s = after_s, batches, max_s
        self.first = -1
        self.t_done = float("inf")
        self.active = False
        self.prof = None
        self.last = -1
        self.t0 = self.t1 = 0.0
        self.digest: Digest | None = None

    def span(self, name: str):
        import torch

        if self.active:
            return torch.profiler.record_function(name)
        return nullcontext()

    def at_batch(self, seq: int, now: float, t_open: float | None) -> None:
        """Start with the first batch to leave the reader ``after_s``
        into the window; stop ``batches`` batches or ``max_s`` later."""
        self.last = seq
        if self.first < 0:
            if t_open is not None and now >= t_open + self.after_s:
                self.first = seq
                self._start()
        elif self.active and (seq == self.first + self.batches
                              or now - self.t0 >= self.max_s):
            self.batches = seq - self.first
            self._stop()

    def overlaps(self, t0: float, t1: float) -> bool:
        """Whether [t0, t1] (host clock) meets the profiled interval,
        the profiler's own stop included."""
        return self.first >= 0 and t0 <= self.t_done and t1 >= self.t0

    def close(self) -> None:
        if self.active:
            # cut short: the window closed first
            self.batches = max(self.last - self.first + 1, 1)
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=True)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.active = True

    def _stop(self) -> None:
        self.t1 = time.perf_counter()
        self.active = False
        self.prof.stop()
        self.digest = digest(self.prof, (self.t1 - self.t0) * 1e6,
                             self.batches)
        self.prof = None
        self.t_done = time.perf_counter()


def _kernels(evt) -> list:
    """(name, duration µs) of the device work under a host op."""
    out = [(k.name, k.duration) for k in getattr(evt, "kernels", [])]
    for c in evt.cpu_children:
        out += _kernels(c)
    return out


def digest(prof, window_us: float, batches: int) -> Digest:
    from torch.autograd import DeviceType

    evts = prof.events()
    dev, ops, marks = [], [], []
    for e in evts:
        if e.device_type == DeviceType.CUDA and (e.name in MARKS
                                                 or e.name.startswith(
                                                     "ProfilerStep")):
            continue      # a host annotation mirrored on the device line
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, e.time_range.start,
                        e.time_range.end - e.time_range.start))
        elif e.name.startswith("urmap::"):
            ops.append({"name": e.name, "shapes": e.input_shapes,
                        "kernels": _kernels(e)})
        elif e.name in MARKS:
            marks.append((e.name, e.time_range.start, e.time_range.end))
    t0 = min([d[1] for d in dev] + [m[1] for m in marks], default=0.0)
    dev = [(n, s - t0, d) for n, s, d in dev]
    marks = [(n, s - t0, e - t0) for n, s, e in marks]
    return Digest(window_us=window_us, batches=batches, device_ops=dev,
                  ops=ops, marks=marks)


def busy_intervals(d: Digest) -> list:
    """The union of the device operations' intervals, sorted."""
    iv = sorted((s, s + dur) for _, s, dur in d.device_ops)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(d: Digest) -> float:
    return sum(e - s for s, e in busy_intervals(d))


def breakdown(d: Digest, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps between device operations, each named by the
    dispatch thread's phase at the gap's start (``between`` where it
    was in none: run_stream's own bookkeeping)."""
    by = {}
    for n, _, dur in d.device_ops:
        key = n.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0][:80]
        by[key] = by.get(key, 0.0) + dur
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    iv = busy_intervals(d)
    gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t):
        for n, s, e in d.marks:
            if s <= t < e:
                return n
        return "between"

    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[label(s), (e - s) / 1e6] for s, e in gaps[:top]]}
