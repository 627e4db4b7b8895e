"""Stage timing.

Port of ``soapdenovo_trans_tpu/utils/profiling.py``.  The reference
prints wall-clock deltas per phase (pregraph.c:61-110, prlRead2path.c
per-signal t0..t6, main.c:408 total); this module keeps the same habit
as a structured table.  The timings belong to an object the caller
makes (the CLI makes one a run), not to the module.  The JAX package's
``device_trace`` wraps a JAX profiler trace and has no counterpart
here.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Iterator


class StageTimings:
    """Seconds by stage name, in first-use order; a name timed twice
    accumulates."""

    def __init__(self):
        self.seconds: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage_timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t0

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
        self.seconds.clear()
