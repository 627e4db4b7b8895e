"""What the profiling tools share: the card's name and power limit, and
the device summary of a ``torch.profiler`` run (kernels by device time,
the device-busy share).  Run from ``tools/`` scripts, which put the
repository's root on ``sys.path``."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile

import torch

from port_bench import trace


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def device_intervals(prof) -> list:
    """(start, end), in microseconds, of every kernel, copy and memset
    in the trace ``prof`` exports."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
            for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in trace.DEVICE_CATS]


def device_summary(prof, wall: float, top: int = 12) -> dict:
    """The CUDA kernels of ``prof`` by device time: the device-busy
    seconds and share of ``wall`` seconds (the union of every kernel,
    copy and memset interval, so that overlap counts once, over wall
    time), the kernel launches, and the ``top`` kernels with the most
    device time (name, seconds, launches)."""
    rows = [(e.key, e.device_time_total / 1e6, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(e - s for s, e in trace.interval_union(
        device_intervals(prof))) / 1e6
    return {"device_busy_s": busy, "device_busy_share": busy / wall,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": n[:80], "seconds": s, "launches": c}
                            for n, s, c in rows[:top]]}


def kernel_time(prof, name: str) -> tuple:
    """(device seconds, launches) of the kernels of ``prof`` whose name
    holds ``name``."""
    rows = [e for e in prof.key_averages() if name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in rows) / 1e6,
            sum(e.count for e in rows))


def runtime_calls(prof, name: str) -> int:
    """Host calls of the CUDA runtime function ``name`` (such as
    ``cudaGraphLaunch``) in ``prof``."""
    return sum(e.count for e in prof.key_averages() if e.key == name)


def print_top(tag: str, summary: dict) -> None:
    for row in summary["top_kernels"]:
        print(f"[{tag}] {row['seconds']:8.3f}s {row['launches']:7d}x "
              f"{row['name']}")
