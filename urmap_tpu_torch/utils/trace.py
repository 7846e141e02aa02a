"""Spans and counters inside the map loop, off unless a caller turns them on.

A span is a named interval of one thread's work on one batch: the
dispatch thread's ``urmap.start_batch`` and ``urmap.finish_batch`` with
their host reads of device state (``urmap.sync``, one ``site`` each), a
worker's ``urmap.second_pass``, ``urmap.cigars`` (and its replay, host DP,
clip DP and compose) and ``urmap.sam``. A count adds to a named counter
of the batch (``host_syncs``, ``rounds.*``, ``rows.*``).

``start_batch`` mints the batch id (``new_batch``) and ``finish_batch``
leaves it on the MapResult(s) it returns; a worker's span takes it from
the result it formats (``batch_of``). Spans and counts opened inside a
span take its batch, and a span's parent is the innermost span open on
its thread (None for a thread's outermost span: the batch itself).

Off (the default), ``span`` and ``sync`` return one shared no-op object
after a check of the module flag, and ``count`` and ``new_batch`` return
at once: nothing is allocated, no clock is read and torch is not touched.
On (``enable``), each span records its host-clock interval
(``time.perf_counter_ns``, the clock the benchmark's spans use) and its
thread's CPU time (``time.thread_time_ns``: wall time well above CPU time
is a thread blocked, on the card or on the GIL). While a torch profiler
runs, each span also enters ``torch.profiler.record_function`` under its
label, so that it lies on the profiler's host timeline beside the
device's operations. Records go to per-thread lists, without a lock on
the hot path, and stay in memory until ``drain`` takes them.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from dataclasses import dataclass

_on = False                 # the flag every span and count checks first
_torch = None               # torch, imported by enable()
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_local = threading.local()
_threads: list = []         # every thread's _Thread, for drain()
_threads_lock = threading.Lock()


@dataclass(frozen=True, slots=True)
class Span:
    name: str
    batch: int | None
    id: int
    parent: int | None      # the enclosing span's id on this thread
    thread: int             # threading.get_ident()
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    cpu_ns: int             # time.thread_time_ns() spent inside
    site: str | None = None

    @property
    def label(self) -> str:
        return self.name if self.site is None else f"{self.name}[{self.site}]"

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass(frozen=True, slots=True)
class Count:
    name: str
    batch: int | None
    n: int
    thread: int


class _Thread:
    """One thread's open spans and records."""

    __slots__ = ("thread", "ident", "stack", "records")

    def __init__(self):
        self.thread = threading.current_thread()
        self.ident = threading.get_ident()
        self.stack: list = []
        self.records: list = []


def _state() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        st = _local.state = _Thread()
        with _threads_lock:
            _threads.append(st)
        return st


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "batch", "site", "id", "parent", "t0", "c0", "rf",
                 "st")

    def __init__(self, name: str, batch, site):
        self.name, self.batch, self.site = name, batch, site

    def __enter__(self):
        st = self.st = _state()
        if st.stack:
            top = st.stack[-1]
            self.parent = top.id
            if self.batch is None:
                self.batch = top.batch
        else:
            self.parent = None
        self.id = next(_span_ids)
        st.stack.append(self)
        self.rf = None
        if _torch.autograd.profiler._is_profiler_enabled:
            self.rf = _torch.profiler.record_function(
                self.name if self.site is None
                else f"{self.name}[{self.site}]")
            self.rf.__enter__()
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        st = self.st
        st.stack.pop()
        st.records.append(Span(self.name, self.batch, self.id, self.parent,
                               st.ident, self.t0, t1, c1 - self.c0,
                               self.site))
        if self.site is not None:
            st.records.append(Count("host_syncs", self.batch, 1, st.ident))
        return False


def enable() -> None:
    """Turn spans and counts on, for every thread."""
    global _on, _torch
    import torch

    _torch = torch
    _on = True


def disable() -> None:
    """Turn them off; what was recorded stays until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, batch: int | None = None):
    """``with span(name[, batch]):`` one span; ``batch`` where the span
    starts one (else the enclosing span's)."""
    if not _on:
        return NO_SPAN
    return _OpenSpan(name, batch, None)


def sync(site: str):
    """``with sync(site):`` around one host read of device state (the
    thread blocks until the card has run what it was given): a
    ``urmap.sync`` span with its ``site``, and +1 ``host_syncs``."""
    if not _on:
        return NO_SPAN
    return _OpenSpan("urmap.sync", None, site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the batch of this thread's
    innermost open span."""
    if not _on:
        return
    st = _state()
    st.records.append(Count(name, st.stack[-1].batch if st.stack else None,
                            n, st.ident))


def new_batch() -> int | None:
    """A new batch id (None while off)."""
    if not _on:
        return None
    return next(_batch_ids)


def batch_of(result) -> int | None:
    """The batch id a MapResult carries (a PairResult's: its first
    mate's, which both mates share)."""
    return getattr(getattr(result, "m1", result), "batch", None)


def spanned(name: str, result_arg: int):
    """Decorator: each call of the function is a span of the batch of
    its positional argument ``result_arg`` (a MapResult or PairResult)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _on:
                return fn(*args, **kw)
            with _OpenSpan(name, batch_of(args[result_arg]), None):
                return fn(*args, **kw)
        return call
    return wrap


def drain() -> list:
    """Every thread's finished spans and counts so far, taken out of
    the lists (threads keep appending while this runs)."""
    out = []
    with _threads_lock:
        states = list(_threads)
    for st in states:
        n = len(st.records)
        out += st.records[:n]
        del st.records[:n]
        if not st.thread.is_alive() and not st.records:
            with _threads_lock:
                _threads.remove(st)
    return out


def totals(records) -> dict:
    """Records of one batch → {"span_ms": {label: ms summed},
    "counts": {name: n summed}}."""
    ms, counts = {}, {}
    for r in records:
        if isinstance(r, Span):
            ms[r.label] = ms.get(r.label, 0.0) + r.ms
        else:
            counts[r.name] = counts.get(r.name, 0) + r.n
    return {"span_ms": ms, "counts": counts}


class BatchTotals:
    """Drained records held by batch until their batch is asked for
    (``take``): one caller thread, for a log line a batch."""

    def __init__(self):
        self._held: dict = {}

    def take(self, batch: int | None) -> dict:
        for r in drain():
            if r.batch is not None:     # a mapper that mints no batch ids
                self._held.setdefault(r.batch, []).append(r)
        return totals(self._held.pop(batch, []))
