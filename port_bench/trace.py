"""Reading one traced assembly: spans around the port's calls, the
profiler's device intervals, and the arithmetic the per-layer metrics
share.

* ``interval_union`` is the device's busy time: the union of every
  interval in which a kernel, a copy or a memset ran.  It replaces
  ``tools/profsum.device_summary``'s sum of kernel times (which counts
  overlap twice and leaves out copies and memsets); the idea, not the
  code, is that tool's.
* ``merge_bytes`` is ``chip_smoke.py`` phase 3's byte model of the merge
  kernel, copied: 20 B a row (16 B of key lanes, 4 B of count) read
  and 20 B written.
* ``PEAKS`` is the table of peaks: one H100 SXM, NVIDIA's data sheet.
* ``Spans`` wraps a fixed list of the port's functions in
  ``torch.profiler.record_function`` for the traced assembly (for the
  read batches, each step of the iterator: the wait for a decoded
  batch), and counts the rows of each merge-kernel call.  Nothing here
  changes what the port computes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from typing import Dict, List, Optional, Tuple

PEAKS = {"hbm_bytes_per_s": 3.35e12}  # H100 SXM, 80 GB HBM3, 700 W

SPAN_PREFIX = "port_bench/"
# (module, function) of the port wrapped in a span of the same name
SPANNED = (
    ("soapdenovo_trans_tpu_torch.cli", "run_pregraph_cmd"),
    ("soapdenovo_trans_tpu_torch.cli", "run_contig_cmd"),
    ("soapdenovo_trans_tpu_torch.cli", "run_map_cmd"),
    ("soapdenovo_trans_tpu_torch.cli", "run_scaff_cmd"),
    ("soapdenovo_trans_tpu_torch.stages.pregraph", "count_reads"),
    ("soapdenovo_trans_tpu_torch.io.graph_files", "write_pregraph_files"),
    ("soapdenovo_trans_tpu_torch.kernels.merge_path", "merge_sorted_rows"),
    ("soapdenovo_trans_tpu_torch.io.fastx", "config_read_batches"),
)
# functions that return an iterator: the span is each step of it
ITERATORS = ("config_read_batches",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]  # (start, end), in microseconds


def interval_union(intervals: List[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def merge_bytes(rows: int) -> int:
    """Bytes one merge of ``rows`` rows (both runs) must move."""
    return 40 * rows


def roofline_share(bytes_moved: float, seconds: float,
                   peak: float = PEAKS["hbm_bytes_per_s"]) -> Optional[float]:
    """Percent of the byte bound: (bytes / peak) / seconds."""
    if seconds <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bytes_moved / peak / seconds


@dataclasses.dataclass
class Trace:
    """One traced assembly: its device intervals and host spans (all in
    the profiler's microseconds), the window, and what the spans
    counted.  ``result`` is the port's ``AllResult``."""

    device: List[Tuple[str, float, float]]   # (name, start, duration)
    spans: List[Tuple[str, float, float]]    # (name, start, duration)
    window: Interval
    merge_rows: List[int]
    result: object = None

    def busy_us(self) -> float:
        u = interval_union([(s, s + d) for _, s, d in self.device])
        return sum(e - s for s, e in clip(u, *self.window))

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, pattern: str) -> float:
        """Device time of the operations whose name matches
        ``pattern`` (a regular expression searched in the name)."""
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.device if rx.search(n))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, d in self.device:
            key = kernel_name(name)
            by[key] = by.get(key, 0.0) + d
        top = sorted(by.items(), key=lambda x: -x[1])[:n]
        return [[k, v / 1e6] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps of the device inside the window, each
        named by the innermost span open at its middle."""
        lo, hi = self.window
        busy = clip(interval_union(
            [(s, s + d) for _, s, d in self.device]), lo, hi)
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at((g[0] + g[1]) / 2), (g[1] - g[0]) / 1e6]
                for g in gaps[:n]]

    def span_at(self, t: float) -> str:
        best, width = "outside any span", float("inf")
        for name, s, d in self.spans:
            if s <= t < s + d and d < width:
                best, width = name, d
        return best


def kernel_name(name: str) -> str:
    """A device operation's name without its template and argument
    lists (``void merge_kernel<...>(...)`` -> ``merge_kernel``); a copy
    or a memset keeps its kind (``Memcpy DtoH``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)::", "")
    head = re.sub(r"<.*", "", name.split("(")[0]).strip()
    return head.split()[-1] if head else name


def read_chrome_trace(path: str, window_span: str) -> Tuple[
        List[Tuple[str, float, float]], List[Tuple[str, float, float]],
        Interval]:
    """Device operations, spans and the window from a trace that
    ``torch.profiler`` exported."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, spans = [], []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, s, d))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name, s, d))
            if name == window_span:
                window = (s, s + d)
    if window is None:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    return device, spans, window


class Spans:
    """Context manager: while open, each function of ``SPANNED`` runs
    inside a span named ``port_bench/<function>``, and each call of the
    merge kernel's entry adds its rows to ``merge_rows``."""

    def __init__(self):
        self.merge_rows: List[int] = []
        self._saved = []

    def __enter__(self):
        import torch

        for mod_name, attr in SPANNED:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(torch, attr, fn))
        return self

    def _wrap(self, torch, attr, fn):
        label = SPAN_PREFIX + attr
        rows = self.merge_rows if attr == "merge_sorted_rows" else None

        def wrapped(*args, **kwargs):
            if rows is not None:
                rows.append(int(args[0].shape[0]) + int(args[2].shape[0]))
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        def steps(*args, **kwargs):
            it = iter(fn(*args, **kwargs))
            while True:
                with torch.profiler.record_function(label):
                    item = next(it, steps)
                if item is steps:
                    return
                yield item
        return steps if attr in ITERATORS else wrapped

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False
