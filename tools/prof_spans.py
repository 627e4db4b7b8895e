#!/usr/bin/env python3
"""Where the card waits, named by the port's own spans: benchmark cells
of ``BENCHMARK.json`` assembled with and without ``torch.profiler``.

    python3 tools/prof_spans.py [--cells a,b] [--seed N] [--rounds R]
        [--device cuda] [--pairs N --warmup-pairs N --transcripts N]

For each cell (default: every cell the visible cards can run), on the
cell's dataset made from ``--seed`` as ``port_bench/run.py`` makes it,
after its warm-up: R rounds of one assembly without the profiler and one
under it (CPU and CUDA activities, ``cli.main(["all", ...])`` inside a
window span).  From each traced assembly's exported trace: the device's
busy time (the union of every kernel, copy and memset interval) and its
idle gaps inside the window; the ten longest gaps, each named by the
innermost ``soap/`` span open at its middle; the idle seconds by
innermost span; the Tour-Bus wave kernels' device seconds and launches
by name (the names that ``port_bench/metrics/wave.roofline.py`` reads;
none at ``-M 0``); the copies' device seconds, events and bytes by kind
(``Memcpy PtoP``: from one card to another); and the share of the idle
time that lies inside a span below the stage level (a span whose name
has a dot, such as ``pregraph.write`` or ``reads.wait``).  From each
assembly: the stage seconds, spans and counters the port recorded, and
the spans an assembly enters; on a mesh, the split of its exchanges
(``mesh``: the route and exchange spans, the peer copies' device seconds
and bytes beside the port's ``mesh.peer_bytes``, their share of NVLink
as ``port_bench/metrics/mesh.exchange.roofline.py`` reads it, and every
card's peak).  A cell of one chip runs on one card
(``SOAPDENOVO_TORCH_NO_SHARD``), as ``port_bench/run.py`` runs it; a
cell of four on the mesh over every visible card.  Then, with no
profiler, the host nanoseconds a span and a counter cost.  One JSON line
a cell; the same goes to ``chiprun_out/prof_spans.jsonl``.  ``--device
cpu`` (``cpu,cpu,cpu,cpu`` for a mesh) with small ``--pairs`` rehearses
the path on the CPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from port_bench import run as bench  # noqa: E402
from port_bench import synth  # noqa: E402
from port_bench import trace as tr  # noqa: E402
from soapdenovo_trans_tpu_torch.utils import profiling  # noqa: E402

WINDOW = "prof_spans/assembly"


def read_trace(path: str, wave_kernels=frozenset()):
    """(device intervals, soap spans as (name, start, end), window, the
    [device seconds, launches] of each of ``wave_kernels`` by name, the
    [device seconds, events, bytes] of the copies by kind) of an exported
    trace, in microseconds but for the kernels' and copies' seconds."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, spans, window, wave, copies = [], [], None, {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, s = ev.get("name", ""), float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if ev.get("cat") in tr.DEVICE_CATS:
            device.append((s, e))
            kernel = tr.kernel_name(name)
            if kernel in wave_kernels:
                tot = wave.setdefault(kernel, [0.0, 0])
                tot[0] += (e - s) / 1e6
                tot[1] += 1
            if ev.get("cat") == "gpu_memcpy":
                tot = copies.setdefault(kernel, [0.0, 0, 0])
                tot[0] += (e - s) / 1e6
                tot[1] += 1
                tot[2] += int(ev.get("args", {}).get("bytes", 0))
        elif name.startswith(profiling.PREFIX):
            spans.append((name[len(profiling.PREFIX):], s, e))
        elif name == WINDOW:
            window = (s, e)
    return device, spans, window, wave, copies


def overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_report(device, spans, window) -> dict:
    lo, hi = window
    busy = tr.clip(tr.interval_union(device), lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))

    def innermost(t):
        best, width = "outside any span", float("inf")
        for name, s, e in spans:
            if s <= t < e and e - s < width:
                best, width = name, e - s
        return best

    idle = sum(e - s for s, e in gaps)
    by_span = {}
    for s, e in gaps:
        name = innermost((s + e) / 2)
        by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e6
    sub = tr.interval_union([(s, e) for name, s, e in spans
                             if "." in name])
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "idle_s": idle / 1e6,
        "idle_share": idle / (hi - lo) if hi > lo else None,
        "idle_in_substage_span_share": overlap(gaps, sub) / idle
        if idle else None,
        "longest_gaps": [[innermost((s + e) / 2), (e - s) / 1e6]
                         for s, e in top],
        "idle_s_by_span": dict(sorted(by_span.items(),
                                      key=lambda x: -x[1])[:12]),
    }


def span_cost_ns(n: int = 200_000) -> dict:
    """Host nanoseconds a span and a counter cost with no profiler, with
    a recorder active and with none."""
    out = {}
    for label, rec in (("active", profiling.StageTimings()), ("none", None)):
        with profiling.active(rec) if rec else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(n):
                with profiling.span("x"):
                    pass
            t1 = time.perf_counter()
            for _ in range(n):
                profiling.counter("x", 1)
            t2 = time.perf_counter()
        out[f"span_ns_{label}"] = 1e9 * (t1 - t0) / n
        out[f"counter_ns_{label}"] = 1e9 * (t2 - t1) / n
    return out


def mesh_split(spans, counters, copies) -> dict:
    """A mesh run's exchanges: the route and exchange spans (seconds,
    calls), the peer copies' device seconds, events and bytes beside the
    port's count of the bytes, their share of NVLink, and every card's
    peak; empty without a mesh."""
    if "mesh.shards" not in counters:
        return {}
    peer = copies.get("Memcpy PtoP", [0.0, 0, 0])
    roof = bench.load_metric("mesh.exchange.roofline")
    return {
        "route": spans.get("mesh.route"),
        "exchange": spans.get("mesh.exchange"),
        "peer_copy_s": peer[0], "peer_copy_events": peer[1],
        "peer_copy_bytes": peer[2],
        **{k[len("mesh."):]: v for k, v in counters.items()
           if k.startswith("mesh.")},
        "roofline": tr.roofline_share(counters.get("mesh.peer_bytes", 0),
                                      peer[0], roof.NVLINK_BYTES_PER_S)}


def one_cell(name: str, args) -> dict:
    cell, config, mix, _, _ = bench.cell_spec(name)
    mix = {**mix, "transcripts": args.transcripts or mix["transcripts"]}
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = args.device
    # as port_bench/run.py: one card for a cell of one chip
    if cell["chips"] == 1:
        os.environ["SOAPDENOVO_TORCH_NO_SHARD"] = "1"
    else:
        os.environ.pop("SOAPDENOVO_TORCH_NO_SHARD", None)
    from soapdenovo_trans_tpu_torch import cli

    device = torch.device(args.device.split(",")[0])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pairs = args.pairs or synth.n_pairs(config,
                                        config["lib"]["max_rd_len"])
    workdir = tempfile.mkdtemp(prefix="prof_spans_")
    try:
        cfg, _ = bench.make_dataset(os.path.join(workdir, "data"), config,
                                    mix, args.seed, pairs)
        wcfg, _ = bench.make_dataset(
            os.path.join(workdir, "warm"), config, mix, [args.seed, 1],
            args.warmup_pairs or config["warmup_pairs"])
        warm = bench.Assembler(cli, config, wcfg, workdir, sync)
        warm.run()
        bench.warm_counting_merge(torch, device, config["K"])
        shutil.rmtree(os.path.dirname(warm.prefix))
        warm.close()
        asm = bench.Assembler(cli, config, cfg, workdir, sync)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        wave_kernels = bench.load_metric("wave.roofline").KERNELS
        rounds = []
        for _ in range(args.rounds):
            t0 = time.time()
            res = asm.run()
            plain = {"assembly_s": time.time() - t0,
                     "stage_s": dict(res.stage_seconds),
                     "spans": res.spans, "counters": res.counters,
                     "mesh": mesh_split(res.spans, res.counters, {})}
            res = None
            gc.collect()
            t0 = time.time()
            with profile(activities=acts) as prof:
                with record_function(WINDOW):
                    res = asm.run()
            traced_s = time.time() - t0
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            device_iv, spans, window, wave, copies = read_trace(
                path, wave_kernels)
            os.remove(path)
            rounds.append({
                "untraced": plain,
                "traced": {"assembly_s": traced_s,
                           "stage_s": dict(res.stage_seconds),
                           "spans": res.spans, "counters": res.counters,
                           "trace_spans": len(spans),
                           "wave_kernels": wave,
                           "wave_kernels_s": sum(v[0] for v in
                                                 wave.values()),
                           "copies": copies,
                           "mesh": mesh_split(res.spans, res.counters,
                                              copies),
                           **idle_report(device_iv, spans, window)},
                "spans_per_assembly": sum(c for _, c in res.spans.values())})
            res = prof = None
            gc.collect()
        asm.close()
        out = {"cell": name, "seed": args.seed, "pairs": pairs,
               "device": torch.cuda.get_device_name(device) if cuda
               else "cpu", "rounds": rounds, **span_cost_ns()}
        if cuda:
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            import profsum

            out["card"] = profsum.card()
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--warmup-pairs", type=int, default=0)
    ap.add_argument("--transcripts", type=int, default=0)
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("prof_spans: torch sees no CUDA device", file=sys.stderr)
        return 1
    # by default every cell the visible cards can run
    cards = torch.cuda.device_count() if args.device.startswith("cuda") \
        else float("inf")
    names = [c for c in args.cells.split(",") if c] or [
        w["name"] for w in bench.load_json(
            os.path.join(bench.ROOT, "BENCHMARK.json"))["workloads"]
        if w["chips"] <= cards]
    os.makedirs(os.path.join(bench.ROOT, "chiprun_out"), exist_ok=True)
    for name in names:
        line = json.dumps(one_cell(name, args))
        print(line, flush=True)
        with open(os.path.join(bench.ROOT, "chiprun_out",
                               "prof_spans.jsonl"), "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
