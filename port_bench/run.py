"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for.  A cell is a configuration (``port_bench/configs/<name>.json``:
the assembler's command line, the library, the dataset's scale) under a
traffic mix (``port_bench/mixes/<name>.json``: transcripts, isoforms,
errors, expression law); both are found by the names in
``BENCHMARK.json``, and each per-layer metric by its name in
``port_bench/metrics/<name>.py``.

Set-up (``setup_s``, from process start): the reads and ``lib.config``
are made from ``--seed`` under ``TMPDIR``, and one assembly of
``warmup_pairs`` pairs of the same configuration loads the CUDA context,
the allocator and the port's built kernels (building them on a
checkout's first run), and two tables of the cell's K are merged once
through the program's own dispatch (``warm_counting_merge``), which
loads the merge kernel where the cell's K-mer rows take it.
With ``--trace 0`` the window then runs the user's command,
``soapdenovo_trans_tpu_torch.cli.main(["all", ...])`` on the dataset,
back to back: it starts no assembly after ``--seconds`` and ends when
the last one it started has finished, each ending in a device
synchronize, each one's files and state dropped before the next starts.
``assembly_s`` is the window over the assemblies; ``peak_device_bytes``
the allocator's peak over the window, which the benchmark reads itself
(``PeakProbe``: an end-to-end metric is the benchmark's own reading,
not one the program reports).  With ``--trace 1`` one assembly runs under
``torch.profiler`` with spans around the port's stage calls, and the
line carries the per-layer metrics, ``busy_s``, ``window_s`` and a
breakdown.  Either way the files of the last assembly are then judged
by ``port_bench/reference.py`` against the reads; every number compared
is printed beside its limit, on standard error and as the result line's
last key, ``checks``.  The last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "soapdenovo_trans_tpu")
BENCH_DIR = os.path.join(ROOT, "port_bench")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(workload: str, bench: dict | None = None):
    """(cell, configuration, mix, per-layer metrics) of a cell, each
    read from the file its name points to."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(os.path.join(BENCH_DIR, "configs",
                                    cell["config"] + ".json"))
    mix = load_json(os.path.join(BENCH_DIR, "mixes",
                                 cell["traffic"] + ".json"))
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return cell, config, mix, end_to_end, per_layer


def load_metric(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's own name only begins with the latter)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def make_dataset(workdir: str, config: dict, mix: dict, seed,
                 pairs: int):
    """The reads of one dataset, written as the assembler reads them;
    returns (lib.config path, the reads in read-number order)."""
    from port_bench import synth

    lib = config["lib"]
    reads = synth.make_reads(
        seed, mix["transcripts"], pairs, lib["max_rd_len"], lib["avg_ins"],
        tx_len=mix["tx_len"], isoform_share=mix["isoform_share"],
        err=mix["err"], expression=mix["expression"], sigma=mix["sigma"])
    cfg = synth.write_dataset(workdir, reads, lib["max_rd_len"],
                              lib["avg_ins"])
    return cfg, reads.interleaved()


def assembly_argv(config: dict, cfg: str, prefix: str) -> list:
    return [config["command"], "-s", cfg, "-K", str(config["K"]),
            *config["flags"], "-o", prefix]


class Assembler:
    """Runs the user's command in this process, its printing sent to a
    log file, and keeps each assembly's files until the next starts."""

    def __init__(self, cli, config: dict, cfg: str, workdir: str, sync):
        self.cli, self.config, self.cfg = cli, config, cfg
        self.workdir, self.sync = workdir, sync
        self.log = open(os.path.join(workdir, "program.log"), "w")
        self.n = 0
        self.prefix = None
        self.seconds = []  # of each assembly of the window
        self.stages = []   # and its stages' seconds, as the port times them

    def run(self):
        if self.prefix is not None:
            shutil.rmtree(os.path.dirname(self.prefix))
        out = os.path.join(self.workdir, f"asm{self.n}")
        os.makedirs(out)
        self.prefix = os.path.join(out, "out")
        with contextlib.redirect_stdout(self.log):
            res = self.cli.main(assembly_argv(self.config, self.cfg,
                                              self.prefix))
        self.sync()
        self.n += 1
        return res

    def close(self):
        self.log.close()


class PeakProbe:
    """The allocator's peak, read by the benchmark itself: opening it
    resets the peak, so that set-up's is not counted; while open, every
    reset of the peak first records the peak it ends, and ``read``
    records the current one.  (The port resets the peak at each stage,
    so one reading at the end would see only the last.)"""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.peaks = [0]

    def __enter__(self):
        cuda = self.torch.cuda
        self._reset = cuda.reset_peak_memory_stats
        self._reset(self.device)

        def reset(*args, **kwargs):
            self.read()
            return self._reset(*args, **kwargs)
        cuda.reset_peak_memory_stats = reset
        return self

    def read(self) -> None:
        self.peaks.append(self.torch.cuda.max_memory_allocated(self.device))

    def __exit__(self, *exc):
        self.read()
        self.torch.cuda.reset_peak_memory_stats = self._reset
        return False


def warm_counting_merge(torch, device, k: int) -> None:
    """Two tables of a few K-mers merged as counting merges its build
    units: where the cell's K-mer rows take the merge kernel, a
    checkout's first run builds it here and no run loads it in the
    window.  (The warm-up assembly is one build unit and merges
    nothing.)"""
    from soapdenovo_trans_tpu_torch.ops import dictionary

    seqs = (torch.arange(128, device=device).view(2, 64) * 7 % 4).to(
        torch.uint8)
    lens = torch.full((1,), 64, dtype=torch.int64, device=device)
    dictionary.merge_packed(
        dictionary.build_packed_from_reads(seqs[:1], lens, k),
        dictionary.build_packed_from_reads(seqs[1:], lens, k))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device_name: str = "cuda", pairs: int | None = None,
             warmup_pairs: int | None = None, transcripts: int | None = None,
             workroot: str | None = None) -> dict:
    """One run of a cell; returns the result line as a dict.  The
    tests call it on the CPU with small ``pairs`` over few
    ``transcripts``; ``main`` alone looks for the card."""
    import torch

    from port_bench import reference
    from port_bench import synth
    from port_bench import trace as tr

    cell, config, mix, end_to_end, per_layer = cell_spec(workload)
    mix = {**mix, "transcripts": transcripts or mix["transcripts"]}
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = device_name
    if cell["chips"] == 1:
        os.environ["SOAPDENOVO_TORCH_NO_SHARD"] = "1"
    from soapdenovo_trans_tpu_torch import cli

    device = torch.device(device_name)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pairs = pairs or synth.n_pairs(config, config["lib"]["max_rd_len"])
    workdir = tempfile.mkdtemp(prefix="port_bench_", dir=workroot)
    try:
        cfg, reads = make_dataset(os.path.join(workdir, "data"), config,
                                  mix, seed, pairs)
        wcfg, _ = make_dataset(
            os.path.join(workdir, "warm"), config, mix, [seed, 1],
            warmup_pairs or config["warmup_pairs"])
        warm = Assembler(cli, config, wcfg, workdir, sync)
        warm.run()
        warm_counting_merge(torch, device, config["K"])
        sync()
        shutil.rmtree(os.path.dirname(warm.prefix))
        warm.close()
        setup_s = time.time() - T_START

        asm = Assembler(cli, config, cfg, workdir, sync)
        probe = PeakProbe(torch, device) if cuda else None
        breakdown = None
        with probe or contextlib.nullcontext():
            if trace:
                res, trc = _traced_assembly(torch, tr, asm, cuda, workdir)
                stage_peaks = dict(res.peak_bytes)
                window_s = trc.window_us() / 1e6
            else:
                t0 = time.time()
                while True:
                    res = asm.run()
                    asm.seconds.append(time.time() - t0 - sum(asm.seconds))
                    asm.stages.append(dict(res.stage_seconds))
                    stage_peaks = dict(res.peak_bytes)
                    # the next assembly starts with none of this one's
                    # state, as the user's next command would
                    res = None
                    gc.collect()
                    if time.time() - t0 >= seconds:
                        break
                window_s = time.time() - t0
        asm.close()
        memory_peak = max(probe.peaks) if probe else 0

        metrics = {}
        if trace:
            trc.result = res
            for m in per_layer:
                v = load_metric(m["name"]).read(trc)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            breakdown = {"device_ops": trc.top_ops(),
                         "idle_gaps": trc.idle_gaps()}
        else:
            values = {"setup_s": setup_s, "assembly_s": window_s / asm.n,
                      "peak_device_bytes": float(memory_peak)}
            for m in end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

        # the port's state goes before the reference runs on the card
        prefix = asm.prefix
        res = None
        if trace:
            trc.result = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = reference.check(prefix, reads, config["K"], device)
        checks = {name: {"value": v, "limit": reference.LIMITS[name]}
                  for name, v in numbers.items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        found = forbidden_modules()
        if found:
            print(f"loaded in the benchmark's process: {', '.join(found)}",
                  file=sys.stderr)
            raise SystemExit(3)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda
               else "cpu", "count": cell["chips"] if cuda else 0,
               "memory_peak_bytes": int(memory_peak)}
        if trace:
            dev["busy_s"] = trc.busy_us() / 1e6
            dev["window_s"] = window_s
        out = {"correct": correct, "attempted": asm.n,
               "failed": 0 if correct else 1, "metrics": metrics,
               "device": dev, "stage_peak_bytes": stage_peaks,
               "assembly_seconds": asm.seconds,
               "stage_seconds": asm.stages}
        if breakdown is not None:
            out["breakdown"] = breakdown
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _traced_assembly(torch, tr, asm: Assembler, cuda: bool, workdir: str):
    """One assembly under the profiler, with spans; returns (the
    port's result, the trace read back)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    window = tr.SPAN_PREFIX + "assembly"
    with tr.Spans() as spans:
        with profile(activities=acts) as prof:
            with record_function(window):
                res = asm.run()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    device, span_list, win = tr.read_chrome_trace(path, window)
    os.remove(path)
    return res, tr.Trace(device, span_list, win, spans.merge_rows)


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cell_spec(args.workload)[0]
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch "
              f"sees {cards}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace))
    print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
