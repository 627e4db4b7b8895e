#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``soapdenovo_trans_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device and environment: the card's name and power limit (from
   ``nvidia-smi``), torch and CUDA versions; no card is an error;
2. build the merge-path kernel from ``soapdenovo_trans_tpu_torch/csrc``;
3. kernel against its plain PyTorch version on the card: the five cases
   of ``tests/test_merge_path.py`` and two sorted 32M-row runs (one
   counting build unit each); rows and counts must be equal position by
   position; median CUDA-event times of both at 32M + 32M rows;
4. the port's ``pregraph`` on a small simulated fixture on ``cpu`` and on
   ``cuda`` (K = 23 through the kernel, K = 31 through the three-lane
   sort) must write byte-identical stage files;
5. the slice at real size: ``pregraph -K 23`` on 1,000,000 simulated
   read pairs (2x100 bp, insert 300, 10,000 transcripts of 1,500 bp,
   half with SNP isoforms, 0.2% errors, seed 0) through the CLI entry
   point, with the kernel's launch count reset just before; the table
   must count every valid K-window, the .kmerFreq histogram must sum to
   the distinct k-mers, and edges and preArcs must exist.

The second-to-last line is a JSON object describing the kernel; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX and
nothing of the JAX package (``soapdenovo_trans_tpu``); the reads come
from ``perf_e2e.synth``, which imports neither.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 23
SMOKE_PAIRS = 1_000_000
SMOKE_TX = 10_000
UNIT_ROWS = 32_000_000
STAGE_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
               ".peGrads", ".edge.gz")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median CUDA-event time of fn() in milliseconds, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sorted_rows(rng: np.random.Generator, n: int, dup: bool, dev):
    """(n, 2) ascending int64 lanes (uint32 values, never the sentinel)
    with int32 counts; ``dup`` draws from a tiny key space."""
    hi = rng.integers(0, 50 if dup else 2**32 - 1, n, dtype=np.int64)
    lo = rng.integers(0, 20 if dup else 2**32, n, dtype=np.int64)
    order = np.lexsort((lo, hi))
    rows = np.stack([hi[order], lo[order]], 1)
    cnt = rng.integers(1, 100, n).astype(np.int32)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(cnt).to(dev)


def check_merge(merge_path, a, ac, b, bc, n: int, m: int) -> int:
    """Kernel vs plain version on one case; returns the max abs error."""
    dev = a.device
    n_t = torch.tensor(n, device=dev)
    m_t = torch.tensor(m, device=dev)
    rows, cnt = merge_path.merge_sorted_rows(a, ac, b, bc, n_t, m_t)
    want_rows, want_cnt = merge_path.merge_sorted_rows_plain(
        a, ac, b, bc, n_t, m_t)
    torch.cuda.synchronize()
    if rows.shape != want_rows.shape or cnt.shape != want_cnt.shape:
        raise AssertionError(f"merge shape {tuple(rows.shape)} != "
                             f"{tuple(want_rows.shape)}")
    err = max(int((rows - want_rows).abs().max()),
              int((cnt - want_cnt).abs().max()))
    if err:
        raise AssertionError(f"merge kernel differs from plain version "
                             f"(n={n}, m={m}): max abs err {err}")
    return err


def phase_kernel(merge_path, dev) -> dict:
    t0 = time.time()
    merge_path._load()
    log(f"[build] merge_path.cu -> sm_90a in {time.time() - t0:.2f}s")

    err = 0
    for n, m, dup in [(5000, 3000, False), (4096, 4096, True),
                      (1, 7000, False), (6000, 0, False),
                      (2048, 2048, True)]:
        rng = np.random.default_rng(42 + n + m)
        a, ac = sorted_rows(rng, max(n, 1), dup, dev)
        b, bc = sorted_rows(rng, max(m, 1), dup, dev)
        err = max(err, check_merge(merge_path, a, ac, b, bc, n, m))
        log(f"[kernel] n={n} m={m} dup={dup}: equal to plain version "
            f"(exact, tolerance 0)")

    rng = np.random.default_rng(7)
    a, ac = sorted_rows(rng, UNIT_ROWS, False, dev)
    b, bc = sorted_rows(rng, UNIT_ROWS, False, dev)
    err = max(err, check_merge(merge_path, a, ac, b, bc, UNIT_ROWS,
                               UNIT_ROWS))
    n_t = torch.tensor(UNIT_ROWS, device=dev)
    ms = cuda_ms(lambda: merge_path.merge_sorted_rows(a, ac, b, bc, n_t, n_t))
    plain_ms = cuda_ms(lambda: merge_path.merge_sorted_rows_plain(
        a, ac, b, bc, n_t, n_t))
    moved = 2 * 2 * UNIT_ROWS * (16 + 4)  # each row read once, written once
    log(f"[kernel] {UNIT_ROWS}+{UNIT_ROWS} rows: kernel {ms:.3f} ms "
        f"({moved / ms / 1e9:.3f} TB/s), plain sort {plain_ms:.3f} ms")
    del a, ac, b, bc
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def run_cli(cli, cfg: str, out: str, k: int, device: str):
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = device
    return cli.main(["pregraph", "-s", cfg, "-K", str(k), "-o", out])


def read_stage_file(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def phase_cpu_gpu(cli, pg_stage, perf_e2e, tmp: str) -> None:
    cfg = perf_e2e.synth(tmp, n_tx=40, n_pairs=3000, seed=1)
    default_rows = pg_stage.TARGET_BUILD_ROWS
    pg_stage.TARGET_BUILD_ROWS = 1  # 4096-read units: several merges
    try:
        for k in (K, 31):
            outs = {}
            for device in ("cpu", "cuda"):
                outs[device] = os.path.join(tmp, f"small_k{k}_{device}")
                run_cli(cli, cfg, outs[device], k, device)
            for ext in STAGE_FILES:
                if read_stage_file(outs["cpu"] + ext) != \
                        read_stage_file(outs["cuda"] + ext):
                    raise AssertionError(f"K={k}: cpu and cuda {ext} differ")
            log(f"[parity] K={k}: cpu and cuda stage files identical")
    finally:
        pg_stage.TARGET_BUILD_ROWS = default_rows


def valid_windows(cfg_path: str, k: int) -> int:
    """In-range K-windows without an N, counted with numpy from the
    reads."""
    from soapdenovo_trans_tpu_torch.io import fastx, libconfig

    total = 0
    for codes, lens, _ in fastx.config_read_batches(
            libconfig.parse_config(cfg_path), 131072):
        r, l = codes.shape
        p = l - k + 1
        n_pre = np.zeros((r, l + 1), np.int32)
        np.cumsum(codes >= 4, axis=1, out=n_pre[:, 1:])
        ok = ((n_pre[:, k:] - n_pre[:, :p]) == 0) & \
            ((np.arange(p)[None, :] + k) <= lens[:, None])
        total += int(ok.sum())
    return total


def phase_slice(cli, merge_path, perf_e2e, tmp: str) -> int:
    t0 = time.time()
    cfg = perf_e2e.synth(tmp, n_tx=SMOKE_TX, n_pairs=SMOKE_PAIRS, seed=0)
    log(f"[slice] simulated {SMOKE_PAIRS} pairs in {time.time() - t0:.1f}s")
    out = os.path.join(tmp, "slice")
    torch.cuda.reset_peak_memory_stats()
    merge_path.LAUNCHES = 0
    t0 = time.time()
    res = run_cli(cli, cfg, out, K, "cuda")
    torch.cuda.synchronize()
    stage_s = time.time() - t0
    launches = merge_path.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("main path never launched the merge kernel")

    want = valid_windows(cfg, K)
    got = int(res.table.count[:res.table.n].sum())
    if got != want:
        raise AssertionError(f"table counts {got} k-mers, reads hold "
                             f"{want} valid windows")
    with open(out + ".kmerFreq") as fh:
        hist_sum = sum(int(x) for x in fh)
    if hist_sum != res.table.n:
        raise AssertionError(f".kmerFreq sums to {hist_sum}, table has "
                             f"{res.table.n} distinct k-mers")
    if res.edges.n_edges <= 0 or res.arcs.n <= 0:
        raise AssertionError("no edges or no preArcs")
    log(f"[slice] {got} k-mer windows, {res.table.n} distinct, "
        f"{res.edges.n_edges} edges, {res.arcs.n} preArcs; "
        f"merge launches {launches}")
    log("[slice] " + json.dumps({
        "pairs": SMOKE_PAIRS, "stage_s": stage_s,
        "phase_s": res.phase_seconds, "peak_bytes": peak}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    import perf_e2e
    from soapdenovo_trans_tpu_torch import cli
    from soapdenovo_trans_tpu_torch.kernels import merge_path
    from soapdenovo_trans_tpu_torch.stages import pregraph as pg_stage

    dev = torch.device("cuda")
    timing = phase_kernel(merge_path, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cpu_gpu(cli, pg_stage, perf_e2e, tmp)
        launches = phase_slice(cli, merge_path, perf_e2e, tmp)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "soapdenovo_trans_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded JAX modules: {foreign[:5]}")

    log(json.dumps({"kernels": [{
        "name": "merge_path", "route": "cuda",
        "source": "soapdenovo_trans_tpu_torch/csrc/merge_path.cu",
        "replaces": "soapdenovo_trans_tpu/kernels/merge_path.py:284",
        "launches": launches, **timing}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
