"""Spans and counters of one run, on one clock.

Port of ``soapdenovo_trans_tpu/utils/profiling.py``.  The reference
prints wall-clock deltas per phase (pregraph.c:61-110, prlRead2path.c
per-signal t0..t6, main.c:408 total); this module keeps the same habit
as a structured record.  The record belongs to an object the caller
makes (the CLI makes one a run and makes it the active recorder for the
run, so that code deep in the port reaches it without a parameter), not
to the module.

A span adds its seconds (``time.perf_counter``) and one call under its
name.  While a ``torch.profiler`` is recording, it also enters
``torch.profiler.record_function("soap/<name>")``, so the span sits in
the exported trace beside the device's intervals, on the trace's clock;
otherwise it enters none.  A span never synchronizes a device: the
callers' phase laps do, inside the span, where they always did.  A
``record_function`` entered on a thread other than the profiler's does
not reach its trace, so work on a background thread is a counter.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import torch

PREFIX = "soap/"


class Span:
    """One timed interval; ``seconds`` holds its duration once closed."""

    __slots__ = ("_rec", "name", "_stage", "_rf", "_t0", "seconds")

    def __init__(self, rec: "StageTimings", name: str, stage: bool = False):
        self._rec, self.name, self._stage = rec, name, stage
        self.seconds = 0.0

    def __enter__(self) -> "Span":
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._rec._add(self)
        return False


class StageTimings:
    """The per-run record: span seconds and calls by name, counter
    totals by name (or a counter's largest value, through
    ``counter_max``), and the stages' seconds in first-use order (a name
    timed twice accumulates).  Counters may be added from any thread."""

    def __init__(self):
        self.seconds: "OrderedDict[str, float]" = OrderedDict()
        self.spans: Dict[str, list] = {}   # name -> [seconds, calls]
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def span(self, name: str) -> Span:
        return Span(self, name)

    def stage_timer(self, name: str) -> Span:
        """A span that is also a row of ``timing_table``."""
        return Span(self, name, stage=True)

    def counter(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def counter_max(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = max(self.counters.get(name, value), value)

    def _add(self, sp: Span) -> None:
        with self._lock:
            tot = self.spans.setdefault(sp.name, [0.0, 0])
            tot[0] += sp.seconds
            tot[1] += 1
            if sp._stage:
                self.seconds[sp.name] = self.seconds.get(sp.name, 0.0) + \
                    sp.seconds

    def span_totals(self) -> Dict[str, Tuple[float, int]]:
        """name -> (seconds, calls) of every span closed so far."""
        with self._lock:
            return {n: (s, c) for n, (s, c) in self.spans.items()}

    def timing_table(self) -> str:
        if not self.seconds:
            return ""
        total = sum(self.seconds.values())
        lines = ["stage timing:"]
        for name, dt in self.seconds.items():
            share = 100 * dt / total if total else 0.0
            lines.append(f"  {name:<12s} {dt:8.1f}s  {share:5.1f}%")
        lines.append(f"  {'total':<12s} {total:8.1f}s")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.spans.clear()
            self.counters.clear()


_ACTIVE: Optional[StageTimings] = None


def recorder() -> StageTimings:
    """The active recorder, or with none a fresh one that no one reads
    (so spans and counters cost the same and go nowhere)."""
    return _ACTIVE if _ACTIVE is not None else StageTimings()


def span(name: str) -> Span:
    """A span of the active recorder."""
    return recorder().span(name)


def counter(name: str, value: float) -> None:
    """Add ``value`` to the active recorder's counter ``name``."""
    recorder().counter(name, value)


def counter_max(name: str, value: float) -> None:
    """Keep the larger of ``value`` and the active recorder's counter
    ``name``."""
    recorder().counter_max(name, value)


@contextlib.contextmanager
def phase(seconds: Dict[str, float], stage: str, name: str,
          sync=None) -> Iterator[Span]:
    """The span ``<stage>.<name>`` of the active recorder, ended by
    ``sync()`` where given (the phase lap's device synchronize); its
    seconds are added to ``seconds[name]``."""
    with span(stage + "." + name) as sp:
        yield sp
        if sync is not None:
            sync()
    seconds[name] = seconds.get(name, 0.0) + sp.seconds


@contextlib.contextmanager
def active(rec: StageTimings) -> Iterator[StageTimings]:
    """Make ``rec`` the active recorder until the block ends."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = prev
