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
4. the port's ``pregraph``, ``contig -g``, ``map -g`` and ``scaff -g``,
   and then ``all`` on a fresh prefix, on a small simulated fixture on
   ``cpu`` and on ``cuda`` (K = 23 through the kernel, K = 31 through the
   three-lane sort) must write identical files, stage by stage and
   under ``all`` (.scafStatistics with the output prefix replaced, since
   the report names its own path);
5. pregraph at real size: ``pregraph -K 23`` on 1,000,000 simulated
   read pairs (2x100 bp, insert 300, 10,000 transcripts of 1,500 bp,
   half with SNP isoforms, 0.2% errors, seed 0) through the CLI entry
   point, with the kernel's launch count reset just before; the table
   must count every valid K-window, the .kmerFreq histogram must sum to
   the distinct k-mers, and edges and preArcs must exist;
6. the main path: ``all -K 23`` through ``cli.main`` on 600,000 pairs
   of the same simulation (6,000 transcripts, seed 0), with the launch
   count reset just before (``all`` resets the peak-memory statistics
   before each stage).  The contig stage at 1,000,000 pairs takes about
   950 s on an H100 (31,426 Tour-Bus waves of 30 ms), more than this
   script's time allows.  Checks: the .contig headers and sequence
   lengths agree with .ContigIndex; .updated.edge declares as many
   edges as there are ids; the sequences are ACGT only; every K-window
   of every contig made of one pregraph edge is a k-mer of the pregraph
   table (looked up on the card); the read ids of .readOnContig and
   .ctg2Read ascend within [1, reads] and their contig ids lie within
   [1, contigs], with at least half of the reads mapped; every ``C<row>``
   singleton of .scafSeq is contig ``row`` of .contig; every N-free
   K-window of every scaffold is a K-window of some contig (both
   strands; the contig k-mers are sorted and looked up on the card);
   the .scafStatistics totals agree with .scafSeq.

The line before the last two is a JSON object of the main path's
numbers; the second-to-last describes the kernel; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing
of the JAX package (``soapdenovo_trans_tpu``); the reads come from
``perf_e2e.synth``, which imports neither.
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
CONTIG_PAIRS = 600_000
CONTIG_TX = 6_000
UNIT_ROWS = 32_000_000
STAGE_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
               ".peGrads", ".edge.gz")
CONTIG_FILES = (".contig", ".ContigIndex", ".updated.edge", ".Arc")
MAP_FILES = (".readOnContig", ".ctg2Read")  # and .peGrads, rewritten
SCAFF_FILES = (".links", ".scaf", ".scaf_gap", ".contigPosInscaff", ".agp",
               ".scafSeq", ".gapSeq")
ALL_FILES = STAGE_FILES + CONTIG_FILES + MAP_FILES + SCAFF_FILES
DEVICES = ("cpu", "cuda")
WINDOW_BUDGET = 1 << 24  # K-windows chopped on the card at a time


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


def run_stage(cli, argv, device: str):
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = device
    return cli.main(argv)


def run_cli(cli, cfg: str, out: str, k: int, device: str):
    return run_stage(cli, ["pregraph", "-s", cfg, "-K", str(k), "-o", out],
                     device)


def read_stage_file(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def assert_same_files(a: str, b: str, exts, what: str) -> None:
    """Files of prefixes a and b are equal; .scafStatistics, which names
    its own path, after each prefix is replaced."""
    for ext in exts:
        if read_stage_file(a + ext) != read_stage_file(b + ext):
            raise AssertionError(f"{what}: {ext} differs")
    stats = [read_stage_file(p + ".scafStatistics").replace(
        p.encode() + b".", b"P.") for p in (a, b)]
    if stats[0] != stats[1]:
        raise AssertionError(f"{what}: .scafStatistics differs")


def phase_cpu_gpu(cli, pg_stage, perf_e2e, tmp: str) -> None:
    cfg = perf_e2e.synth(tmp, n_tx=40, n_pairs=3000, seed=1)
    default_rows = pg_stage.TARGET_BUILD_ROWS
    pg_stage.TARGET_BUILD_ROWS = 1  # 4096-read units: several merges
    try:
        for k in (K, 31):
            staged = {d: os.path.join(tmp, f"small_k{k}_{d}") for d in DEVICES}
            whole = {d: os.path.join(tmp, f"all_k{k}_{d}") for d in DEVICES}
            for d in DEVICES:
                run_cli(cli, cfg, staged[d], k, d)
            for argv in (["contig", "-g"], ["map", "-s", cfg, "-g"],
                         ["scaff", "-g"]):
                for d in DEVICES:
                    run_stage(cli, argv + [staged[d]], d)
            for d in DEVICES:
                run_stage(cli, ["all", "-s", cfg, "-K", str(k), "-o",
                                whole[d]], d)
            assert_same_files(staged["cpu"], staged["cuda"],
                              ALL_FILES + (".newContigIndex",),
                              f"K={k}, stage by stage, cpu vs cuda")
            assert_same_files(whole["cpu"], whole["cuda"], ALL_FILES,
                              f"K={k}, all, cpu vs cuda")
            log(f"[parity] K={k}: cpu and cuda files of pregraph, contig, "
                f"map and scaff identical, stage by stage and under all")
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


def read_contig_fasta(path: str):
    """[(id, declared length, sequence)] of a .contig file."""
    recs = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                f = line[1:].split()
                recs.append([int(f[0]), int(f[2]), []])
            else:
                recs[-1][2].append(line)
    return [(i, n, "".join(parts)) for i, n, parts in recs]


def check_contig_files(out: str, n_contigs: int):
    """Checks 1-3 of phase 6; returns the .contig records."""
    recs = read_contig_fasta(out + ".contig")
    for cid, n, seq in recs:
        if len(seq) != n:
            raise AssertionError(f"contig {cid}: header length {n}, "
                                 f"sequence {len(seq)}")
        if seq.strip("ACGT"):
            raise AssertionError(f"contig {cid} holds a non-ACGT base")
    with open(out + ".ContigIndex") as fh:
        n_ids = int(fh.readline().split()[1])
        fh.readline()
        index = [tuple(int(x) for x in line.split()[:2]) for line in fh]
    if index != [(cid, n) for cid, n, _ in recs]:
        raise AssertionError(".contig headers and .ContigIndex disagree")
    with open(out + ".updated.edge") as fh:
        declared = int(fh.readline().split()[1])
        records = sum(1 for line in fh if line.startswith(">"))
    if not declared == records == n_ids == n_contigs:
        raise AssertionError(
            f".updated.edge declares {declared} edges and holds {records}; "
            f".ContigIndex has {n_ids} ids; the stage made {n_contigs}")
    return recs


def window_kmers(kmer, seqs, k: int, dev):
    """Canonical k-mers of the N-free K-windows of seqs, chopped on the
    card in chunks of about WINDOW_BUDGET windows; yields one (M, W)
    tensor a chunk."""
    from soapdenovo_trans_tpu_torch.ops import bits

    seqs = sorted((s for s in seqs if len(s) >= k), key=len)
    lo = 0
    while lo < len(seqs):
        hi = lo + 1
        while hi < len(seqs) and (hi + 1 - lo) * len(seqs[hi]) <= \
                WINDOW_BUDGET:
            hi += 1
        chunk = seqs[lo:hi]
        codes = np.full((len(chunk), len(chunk[-1])), 4, np.uint8)
        for i, s in enumerate(chunk):
            codes[i, :len(s)] = bits.encode_seq(s)
        lens = torch.tensor([len(s) for s in chunk], device=dev)
        stream = kmer.chop_reads(torch.from_numpy(codes).to(dev), lens, k)
        yield stream.kmers[stream.valid]
        lo = hi


def table_windows(kmer, dictionary, keys, seqs, k: int, dev):
    """(windows, windows found among the sorted k-mer rows ``keys``) over
    the N-free K-windows of seqs, looked up on the card."""
    total = found = 0
    for kmers in window_kmers(kmer, seqs, k, dev):
        total += kmers.shape[0]
        found += int((dictionary.lookup(keys, kmers) >= 0).sum())
    return total, found


def distinct_kmers(kmer, dictionary, seqs, k: int, dev):
    """The sorted distinct canonical k-mers of seqs' K-windows, as rows
    for ``dictionary.lookup``."""
    (keys,) = dictionary.sort_rows(torch.cat(list(
        window_kmers(kmer, seqs, k, dev))))
    keep = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
    keep[1:] = (keys[1:] != keys[:-1]).any(-1)
    return keys[keep]


def n50(lengths) -> int:
    acc = 0
    for n in sorted(lengths, reverse=True):
        acc += n
        if 2 * acc >= sum(lengths):
            return n
    return 0


def read_fasta(path: str):
    """[(header, sequence)] of a FASTA file."""
    recs = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                recs.append((line[1:], []))
            elif line:
                recs[-1][1].append(line)
    return [(h, "".join(parts)) for h, parts in recs]


def check_placements(pelinks, out: str, n_reads: int, n_contigs: int):
    """Check 5 of phase 6; returns the reads of .readOnContig (one row a
    mapped read) and the rows of .ctg2Read."""
    rows = {}
    for ext in (".readOnContig", ".ctg2Read"):
        read, ctg, _pos = pelinks._load_rows(out + ext)
        if not read.size:
            raise AssertionError(f"{ext} is empty")
        step = np.diff(read)
        if (step <= 0 if ext == ".readOnContig" else step < 0).any():
            raise AssertionError(f"{ext}: read ids do not ascend")
        if read[0] < 1 or read[-1] > n_reads:
            raise AssertionError(f"{ext}: read ids {read[0]}..{read[-1]} "
                                 f"outside [1, {n_reads}]")
        if ctg.min() < 1 or ctg.max() > n_contigs:
            raise AssertionError(f"{ext}: contig ids {ctg.min()}.."
                                 f"{ctg.max()} outside [1, {n_contigs}]")
        rows[ext] = read.size
    if 2 * rows[".readOnContig"] < n_reads:
        raise AssertionError(f"only {rows['.readOnContig']} of {n_reads} "
                             f"reads mapped")
    return rows[".readOnContig"], rows[".ctg2Read"]


def check_scaffolds(out: str, contig_recs):
    """Checks 6 and 8 of phase 6; returns the .scafSeq records."""
    scaf = read_fasta(out + ".scafSeq")
    by_id = {cid: seq for cid, _, seq in contig_recs}
    for head, seq in scaf:
        if head.startswith("C") and by_id.get(int(head[1:]) + 1) != seq:
            raise AssertionError(f"singleton {head} is not contig "
                                 f"{int(head[1:]) + 1} of .contig")
    kept = [s for _, s in scaf if len(s) >= 100]
    want = {"Size_includeN": sum(map(len, kept)),
            "Size_withoutN": sum(len(s) - s.count("N") for s in kept),
            "Scaffold_Num": len(kept),
            "Singleton_Num": sum(1 for h, s in scaf
                                 if h.startswith("C") and len(s) >= 100)}
    got = {}
    with open(out + ".scafStatistics") as fh:
        for line in fh:
            f = line.split("\t")
            if f[0] in want and f[0] not in got:  # the scaffold section
                got[f[0]] = int(f[1])
    if got != want:
        raise AssertionError(f".scafStatistics says {got}, .scafSeq holds "
                             f"{want}")
    return scaf


def phase_all(cli, merge_path, perf_e2e, smi: str, tmp: str):
    from soapdenovo_trans_tpu_torch.graph import contig_merge
    from soapdenovo_trans_tpu_torch.ops import dictionary, kmer
    from soapdenovo_trans_tpu_torch.stages import pelinks

    t0 = time.time()
    cfg = perf_e2e.synth(tmp, n_tx=CONTIG_TX, n_pairs=CONTIG_PAIRS, seed=0)
    log(f"[all] simulated {CONTIG_PAIRS} pairs in {time.time() - t0:.1f}s")
    out = os.path.join(tmp, "all")
    dev = torch.device("cuda")
    merge_path.LAUNCHES = 0
    t0 = time.time()
    res = run_stage(cli, ["all", "-s", cfg, "-K", str(K), "-o", out], "cuda")
    all_s = time.time() - t0
    launches = merge_path.LAUNCHES
    if launches < 1:
        raise AssertionError("the main path never launched the merge "
                             "kernel")

    # the contig stage
    result, table, k = res.contig, res.pregraph.table, K
    ctg = result.contigs
    recs = check_contig_files(out, ctg.n)
    seqs = contig_merge.contig_sequences(ctg, table, k)
    members = torch.bincount(result.edge_contig[result.edge_contig >= 0],
                             minlength=ctg.n)
    single = [seqs[i] for i in
              torch.nonzero(members == 1)[:, 0].tolist()]
    n_single, hit_single = table_windows(kmer, dictionary, table.keys,
                                         single, k, dev)
    if n_single == 0 or hit_single != n_single:
        raise AssertionError(f"{n_single - hit_single} of {n_single} "
                             f"K-windows of single-edge contigs are not "
                             f"pregraph k-mers")
    n_all, hit_all = table_windows(kmer, dictionary, table.keys, seqs, k,
                                   dev)
    lengths = [n for _, n, _ in recs]
    tb = result.tourbus
    log(f"[all] {ctg.n} contigs ({len(recs)} in .contig), {len(single)} of "
        f"one pregraph edge: all their {n_single} K-windows are table "
        f"k-mers; {hit_all} of {n_all} K-windows of all contigs are")

    # the map stage
    n_reads = 2 * CONTIG_PAIRS
    mapped, ctg2read = check_placements(pelinks, out, n_reads, ctg.n)
    if mapped != res.map.mapped or ctg2read != res.map.groups:
        raise AssertionError("the map stage's counts and files disagree")
    log(f"[all] map: {mapped} of {n_reads} reads mapped "
        f"({100.0 * mapped / n_reads:.2f}%), {ctg2read} .ctg2Read rows")

    # the scaff stage
    scaf = check_scaffolds(out, recs)
    scaffolds = [s for h, s in scaf if h.startswith("scaffold")]
    rc = str.maketrans("ACGT", "TGCA")
    twin = ctg.twin.tolist()
    asym = sum(1 for i in range(ctg.n) if twin[i] > i
               and seqs[twin[i]] != seqs[i].translate(rc)[::-1])
    n_win, hit_win = table_windows(
        kmer, dictionary, distinct_kmers(kmer, dictionary, seqs, k, dev),
        scaffolds, k, dev)
    if n_win == 0 or hit_win != n_win:
        raise AssertionError(f"{n_win - hit_win} of {n_win} N-free "
                             f"K-windows of scaffolds are no contig k-mer")
    log(f"[all] scaff: {len(scaffolds)} transcripts, "
        f"{len(scaf) - len(scaffolds)} singletons; all {n_win} N-free "
        f"K-windows of the transcripts are contig k-mers; {asym} twin "
        f"pairs whose sequences are not reverse complements")

    sres = res.scaff
    numbers = {
        "card": smi, "pairs": CONTIG_PAIRS, "all_s": all_s,
        "stage_s": res.stage_seconds, "peak_bytes": res.peak_bytes,
        "edges": res.pregraph.edges.n_edges, "pre_arcs": res.pregraph.arcs.n,
        "contig_phase_s": result.phase_seconds, "laps": result.laps,
        "waves": tb["waves"], "productive_waves": tb["productive"],
        "merged": tb["merged"], "s_per_wave": tb["s_per_wave"],
        "contigs": len(recs), "total_len": sum(lengths),
        "n50": n50(lengths), "table_window_share": hit_all / max(n_all, 1),
        "asymmetric_twins": asym,
        "map": {"reads": res.map.reads, "mapped": mapped,
                "mapped_share": mapped / n_reads, "ctg2read_rows": ctg2read,
                "index_kmers": res.map.index_kmers,
                "phase_s": res.map.phase_seconds},
        "scaff": {"connections": sres.connections,
                  "transcripts": len(scaffolds),
                  "singletons": len(scaf) - len(scaffolds),
                  "n50": sres.stats.get("N50", 0),
                  "transcript_n50": n50([len(s) for s in scaffolds]),
                  "phase_s": sres.phase_seconds},
        "merge_launches": launches}
    peaks = ", ".join(f"{s} {b / 1e9:.2f}" for s, b in res.peak_bytes.items())
    log(f"[all] {all_s:.1f}s: " + ", ".join(
        f"{s} {t:.1f}s" for s, t in res.stage_seconds.items()) +
        f"; peak GB {peaks}; {tb['waves']} Tour-Bus waves of "
        f"{tb['s_per_wave'] * 1e3:.2f} ms on {smi}")
    return launches, numbers


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
        phase_slice(cli, merge_path, perf_e2e, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        launches, numbers = phase_all(cli, merge_path, perf_e2e,
                                      smi.splitlines()[0], tmp)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "soapdenovo_trans_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded JAX modules: {foreign[:5]}")

    log("[all] " + json.dumps(numbers))
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
