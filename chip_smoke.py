#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``soapdenovo_trans_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device and environment: the card's name and power limit (from
   ``nvidia-smi``), torch and CUDA versions; no card is an error;
2. build the three sources of ``soapdenovo_trans_tpu_torch/csrc``, the
   merge-path kernel, the Tour-Bus identity check (``lcs.cu``) and the
   wave around it (``wave.cu``: the front and the back), one ``nvcc``
   each, started together; each build's seconds are printed;
3. each kernel against its plain PyTorch version on the card.  The
   kernels of ``kernels/wave``, on the cases of
   ``tests/test_torch_wave_kernels_gpu.py`` (loaded by path): the front
   on every front case (equal and extreme coverages, duplicate and
   padded rows, no candidate, fewer, as many and more than cand_cap; 8
   and 1,024 candidates, m = 3, 9 and 30), the back on each with ok rows
   and without (its E- and A-sized outputs compared where it merged),
   and both on the wave cases (the front on each case's arc table, the
   back with its ok rows; C = 64 at m = 3, 9 and 30, random and mixed
   ones at C = 1,024), all exact; both timed (CUDA events, host us, the
   plain versions, the bounds, and for the front the library call
   ``torch.topk`` of the candidates' packed keys) on the mixed and
   random front cases at 1,024 candidates, m = 3.  The
   identity kernel (``kernels/lcs.identity_check``, the wave's path
   lengths, gate, LCS and verdict in one launch): the identity cases of
   ``tests/test_torch_lcs_gpu.py`` (loaded by path), all five outputs
   exact, and the median CUDA-event times of the kernel and the plain
   version, with the host time of a call and the bound, at a real
   wave's shape (12 of 1,024 rows compared, paths of 24 bases) and at
   1,024 x 384 with full paths.  The merge kernel:
   the five cases
   of ``tests/test_merge_path.py`` and two sorted 32M-row runs (one
   counting build unit each); rows and counts must be equal position by
   position; median CUDA-event times of both at 32M + 32M rows, and of
   the library call that orders the same rows, ``torch.sort(keys,
   stable=True)`` on their folded int64 keys, alone.  Then
   its two other callers, ``dictionary.merge_packed`` and
   ``merge_finalize``, on two ``PackedTable``s of 16,777,216 rows each
   (a quarter of the rows shared) at K = 23: each must launch the kernel
   once and equal the concat + sort path on the same CUDA tensors (rows,
   counts and every ``KmerTable`` field), and the times of both paths
   and of the merge alone (``merge_rows_ms``: the rest is the dedup, or
   ``_finalize``, after it).  Last, the two uploads of one 32M-row
   build unit of 100 bp reads: raw uint8 codes against the 2-bit packed
   form of ``ops/readpack.py`` (host pack, upload, unpack on the card),
   which must build the same sorted run;
4. the port's ``pregraph -R``, ``contig -R -g``, ``map -f -r -g``,
   ``scaff -F -R -g`` and ``scaff -S -F -g`` (they write the files of the
   plain stages and more), and then ``all`` and ``all -F -f -R`` on
   fresh prefixes, on a small simulated fixture on ``cpu`` and on
   ``cuda`` (K = 23 through the kernel, K = 31 through the three-lane
   sort) must write identical files, stage by stage and under ``all``
   (.scafStatistics with the output prefix replaced, since the report
   names its own path; ``.gz`` files decompressed); and ``all`` on a
   mesh of two logical shards of each device (``cpu,cpu`` and
   ``cuda:0,cuda:0``) must write the files of the one-device ``all``;
   the cuda runs must execute the front, identity and back kernels
   once each a Tour-Bus wave of their contig stages, and run each pinch
   as a wave program (``graph/tourbus.WaveProgram``): one CUDA graph
   captured a pinch of two waves or more, every wave after the first a
   replay;
5. pregraph at real size: ``pregraph -K 23`` on 500,000 simulated
   read pairs (2x100 bp, insert 300, 5,000 transcripts of 1,500 bp,
   half with SNP isoforms, 0.2% errors, seed 0; 1,000,000 pairs until
   the mesh path's phase took its seconds) through the CLI entry
   point, with the kernels' launch counts reset just before; the table
   must count every valid K-window, the .kmerFreq histogram must sum to
   the distinct k-mers, and edges and preArcs must exist;
6. the main path: ``all -K 23`` through ``cli.main`` on the same
   500,000 pairs, with the launch
   counts reset just before (``all`` resets the peak-memory statistics
   before each stage).  The front, identity and back kernels must
   execute once each a Tour-Bus wave, the pinch be captured once
   and every later wave be a replay (the captures, the replays and the
   host microseconds of a replay are printed, ``WaveRecorder``); the
   identity
   inputs of every 512th wave are kept (16 waves: copies of their node
   lists and found flags, and the graph's tensors, which every wave
   shares; the peak bytes of contig, map and scaff then include them,
   and the script prints their bytes), and the front and back inputs
   of the same waves and of every 64th productive one, copied to the
   host (``failed`` as the wave found it); after the run the front and
   the back are each held against their plain version and timed on
   them (the kernels on the waves the main path gives them; the front
   beside ``torch.topk`` of its candidates' keys, the back on the waves
   that merged and those that did not apart), and their coverage must
   lie in [0, 16,000].  Until the
   LCS kernel the contig stage at 1,000,000 pairs took about 950 s on an
   H100 (31,426 waves of 30 ms), more than this script's time allows.
   Checks: the .contig headers and sequence lengths agree with
   .ContigIndex; .updated.edge declares as many
   edges as there are ids; the sequences are ACGT only; every K-window
   of every contig made of one pregraph edge is a k-mer of the pregraph
   table (looked up on the card); the read ids of .readOnContig and
   .ctg2Read ascend within [1, reads] and their contig ids lie within
   [1, contigs], with at least half of the reads mapped; every ``C<row>``
   singleton of .scafSeq is contig ``row`` of .contig; every N-free
   K-window of every scaffold is a K-window of some contig (both
   strands; the contig k-mers are sorted and looked up on the card);
   the .scafStatistics totals agree with .scafSeq;
7. the options at full width, with the launch counts reset just before:
   on copies of phase 6's contig files, ``map -f -r -g`` and ``scaff -F
   -R -g -s cfg`` (gap filling from the 1,000,000 reads), then ``scaff
   -S -F`` on a copy, which must give the same .scafSeq.  Checks: gaps
   are filled; at least 90% of the N-free K-windows of the filled
   sequences, and of the -F scaffolds, are k-mers of the pregraph table
   (a fill is built from read k-mers); .scafSeq holds fewer N bases than
   phase 6's; the hits of .RPKM.Stat sum to its Total_unique_reads_num;
   .readInGap holds as many records as .shortreadInGap.gz.  Then
   ``pregraph -R`` and ``contig -R -g`` on 220,000 pairs (2,200
   transcripts, seed 0: two counting build units, so one launch of the
   merge kernel; at 300,000 pairs Tour-Bus after splitting runs 4,792
   waves, 123-159 s, too long beside phase 6): .path holds as many
   records as the recorder counted, .markOnEdge one line per edge, the
   repeat edges split are reported, and the front, identity and back
   kernels executed once each a Tour-Bus wave of ``contig -R``, its
   pinch captured once and
   replayed (captures, replays and host microseconds a replay printed).
   Seconds of every part and peak bytes are printed;
8. the mesh path at full width, on four logical shards of the one
   card (``SOAPDENOVO_TORCH_DEVICE=cuda:0,cuda:0,cuda:0,cuda:0``; no
   multi-card measurement), with the launch counts reset just before:
   ``pregraph -K 23`` through ``cli.main`` on phase 6's 500,000 pairs.
   Against phase 6's one-device pregraph files: .kmerFreq byte for
   byte; the same number of distinct k-mers, edges and preArcs; the same
   set of .edge.gz records (length, end k-mers, coverage, sequence); the
   merge kernel launched at least once.  Then ``map -g`` on the mesh on
   a copy of phase 6's contig files: .readOnContig, .ctg2Read and
   .peGrads byte for byte those of phase 7's one-device ``map -f -r -g``
   on the same files.  Seconds by phase, peak bytes and the number and
   bytes of the exchanges between shards are printed;
9. the JAX package's end-to-end fixtures: the six fixtures of
   ``tests/test_torch_e2e.py`` (the twin of ``tests/test_e2e.py``; K =
   21, the gap-fill one K = 23 with ``-F -f -L 100`` and a ``scaff -S``
   resume), loaded by path without pytest, each run through ``cli.main``
   on ``cpu`` and on ``cuda``.  On ``cuda`` the JAX suite's recovery
   checks must hold, every output file must equal the ``cpu`` run's
   byte for byte (``.gz`` files decompressed, the prefix replaced), and
   the pregraph edges must decode to the same sequences.  Each fixture
   is one counting build unit, so the merge kernel is not launched here;
   the front, identity and back kernels execute once each a wave of
   their contig stages, and a pinch of two waves or more is
   captured once and replayed.

The lines before the last two are JSON objects of phase 9's, phase 8's,
phase 7's and the main path's numbers, last to first; the
second-to-last describes the four hand-kernel entries (merge_path,
identity, front, back); the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing
of the JAX package (``soapdenovo_trans_tpu``), which it checks after
phase 9; the reads come from ``perf_e2e.synth`` and the fixtures of
phase 9, which import neither.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 23
MESH_SHARDS = 4
CONTIG_PAIRS = 500_000
CONTIG_TX = 5_000
REPS_PAIRS = 220_000
REPS_TX = 2_200
UNIT_ROWS = 32_000_000
PACKED_ROWS = 1 << 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the CUDA cores' 32-bit integer rate: the data sheet's 67 TFLOP/s of
# float32 counts an FMA as two, and an SM has 64 INT32 lanes to 128 FP32
INT32_OPS_PER_S = 67e12 / 4
STAGE_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
               ".peGrads", ".edge.gz")
CONTIG_FILES = (".contig", ".ContigIndex", ".updated.edge", ".Arc")
MAP_FILES = (".readOnContig", ".ctg2Read")  # and .peGrads, rewritten
SCAFF_FILES = (".links", ".scaf", ".scaf_gap", ".contigPosInscaff", ".agp",
               ".scafSeq", ".gapSeq")
ALL_FILES = STAGE_FILES + CONTIG_FILES + MAP_FILES + SCAFF_FILES
PATH_FILES = (".path", ".markOnEdge")
GAP_READ_FILES = (".readInGap", ".shortreadInGap.gz", ".PEreadOnContig.gz")
READ_TABLES = (".readInformation", ".readOnScaf", ".RPKM.Stat")
RESUME_INPUTS = (".preGraphBasic",) + CONTIG_FILES
DEVICES = ("cpu", "cuda")
WINDOW_BUDGET = 1 << 24  # K-windows chopped on the card at a time
REPO = os.path.dirname(os.path.abspath(__file__))


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of fn() (kernels that a CUDA graph can capture)
    takes without the host's launch cost: one call captured into a CUDA
    graph (on a side stream, without ``torch.cuda.graph``'s garbage
    collection), ``reps`` replays between two CUDA events, over
    ``reps``."""
    fn()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_build(kernels) -> dict:
    """Builds every kernel's source at once, one nvcc each, all started
    together (the script's time limit does not grow with the kernels),
    then loads them; returns each build's seconds by source file."""
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(module):
        t0 = time.time()
        module.build()
        return time.time() - t0

    with ThreadPoolExecutor(len(kernels)) as pool:
        seconds = list(pool.map(timed_build, kernels))
    for module, sec in zip(kernels, seconds):
        module._load()
        log(f"[build] {os.path.relpath(module.SOURCE, REPO)} -> sm_90a in "
            f"{sec:.2f}s")
    return {os.path.basename(m.SOURCE): sec
            for m, sec in zip(kernels, seconds)}


def bound_of(moved: int, ops: int) -> tuple:
    """(bound ms, what sets it): the larger of ``moved`` bytes over the
    memory rate and ``ops`` 32-bit integer operations over the CUDA
    cores' integer rate."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call of fn() takes to return (the enqueue,
    the device not waited for), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def identity_bound_ms(inputs, outputs) -> tuple:
    """(bound ms, what sets it) of one identity-check call on this call's
    inputs and plain outputs.  The bytes it must move: the two node
    lists, found, a length for each listed node (an id in 0..E-1) and an
    offset for each listed node of a compared row, the compared rows'
    bases, and the outputs (three int64 and two bool a row), over the
    memory rate.  The operations: the LCS's word steps, sum(len_a ·
    ceil(len_b/64)) over the compared rows, each four 64-bit operations
    (and, add, and-not, or) done as eight 32-bit ones, over the CUDA
    cores' integer rate."""
    maj, mnr, found, length, _seq_off, _pool, _diff, _cap = inputs
    len_a, len_b, compared = outputs[:3]
    (c, m), e = maj.shape, length.shape[0]
    listed = ((maj >= 0) & (maj < e)).sum(1) + ((mnr >= 0) & (mnr < e)).sum(1)
    moved = (16 * c * m + c + 8 * int(listed.sum())
             + 8 * int(listed[compared].sum())
             + int((len_a + len_b)[compared].sum()) + 26 * c)
    steps = int((len_a * ((len_b + 63) // 64))[compared].sum())
    return bound_of(moved, 8 * steps)


def check_identity(lcs, inputs) -> tuple:
    """The identity kernel vs its plain version on one call's inputs;
    returns (max abs error, which must be 0, and the plain outputs)."""
    got = lcs.identity_check(*inputs)
    want = lcs.identity_check_plain(*inputs)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("len_a", "len_b", "compared", "ok", "lcs"), got,
                          want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"identity {name}: {tuple(g.shape)} "
                                 f"{g.dtype} != {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"identity kernel differs from plain version "
                             f"(C={inputs[0].shape[0]}, m="
                             f"{inputs[0].shape[1]}, seq_cap={inputs[7]}): "
                             f"max abs err {err}")
    return err, want


def time_identity(lcs, inputs, want, reps: int = 10) -> dict:
    bound, by = identity_bound_ms(inputs, want)
    compared = want[2]
    return {"c": inputs[0].shape[0], "m": inputs[0].shape[1],
            "seq_cap": inputs[7], "compared_rows": int(compared.sum()),
            "mean_len_a": float(want[0][compared].float().mean())
            if compared.any() else 0.0,
            "ms": cuda_ms(lambda: lcs.identity_check(*inputs), reps),
            "host_us": host_us(lambda: lcs.identity_check(*inputs)),
            "plain_ms": cuda_ms(lambda: lcs.identity_check_plain(*inputs),
                                reps=3, warm=1),
            "bound_ms": bound, "bound_by": by}


def phase_identity(lcs, dev) -> dict:
    """The identity kernel against its plain version on the card test's
    cases, and timed at a real wave's shape (12 of 1,024 rows compared,
    paths of 24 bases) and at 1,024 x 384 with full paths."""
    cases = load_test("test_torch_lcs_gpu.py")
    err = 0
    for i, (name, c, m, cap, diff) in enumerate(cases.IDENTITY_CASES):
        xs = cases.identity_to_device(
            cases.identity_case(name, c, m, cap, diff, 200 + i), dev)
        err = max(err, check_identity(lcs, (*xs, diff, cap))[0])
        log(f"[identity] {name} C={c} m={m} seq_cap={cap} diff={diff}: "
            f"equal to plain version (exact, tolerance 0)")
    times = {}
    c, m, cap, diff = cases.WAVE_P, 3, cases.WAVE_CAP, 2
    for name in ("wave", "full"):
        inputs = (*cases.identity_to_device(
            cases.identity_case(name, c, m, cap, diff, 7), dev), diff, cap)
        e, want = check_identity(lcs, inputs)
        err = max(err, e)
        times[f"{name}_{c}x{cap}"] = time_identity(lcs, inputs, want)
    log("[identity] " + json.dumps(times))
    return {"max_abs_err": err, "synthetic": times}


def in_range(x, e: int) -> int:
    return int(((x >= 0) & (x < e)).sum())


def claim_work(inputs) -> tuple:
    """(bytes, operations) a productive back's claims, apply and arc rows
    (``claim_apply_plain``'s part) must move and do on these inputs.  The
    bytes: ok (1 B a row) and each ok row's four node lists, ends, len_a
    and len_b (32·m + 48 B); cvg and deleted (9 B an edge) and the arc
    rows (24 B a row); a length for each node in 0..E-1 of an ok row's
    two paths and a twin for each of its cover nodes, at most one a
    minority node (8 B each); the outputs, cvg2 and deleted2 (9 B an
    edge), the new arc rows (24 B a row) and the count.  The operations:
    each ok row's claims (4m + 4) and spans (m² for the covers), two
    32-bit operations each."""
    maj, mnr, ok, cvg, from_ed = inputs[0], inputs[1], inputs[5], \
        inputs[8], inputs[12]
    (c, m), e, a = maj.shape, cvg.shape[0], from_ed.shape[0]
    n_ok = int(ok.sum())
    nodes = in_range(maj[ok], e) + 2 * in_range(mnr[ok], e)
    moved = c + n_ok * (32 * m + 48) + 18 * e + 48 * a + 8 * nodes + 8
    return moved, 2 * n_ok * (4 * m + 4 + m * m)


def front_bound_ms(inputs, outputs) -> tuple:
    """(bound ms, what sets it) of one front call on this call's inputs
    and plain outputs.  The bytes it must move: the arc rows, mult and
    failed (25 B a row); deleted for each edge in 0..E-1 a row names (1
    B) and the coverage of each from-edge of a live arc (8 B); a twin for
    each path node, fork and t0 in 0..E-1 (8 B); the outputs, cid_arc, u,
    t0, cmask, the four (C, m) lists, ends and found (58 + 32·m B a row)
    and the two counts.  The operations: (m + 2)(m + 1) int64 compares a
    row for the meeting point and 2m(2m + 4) for the clash test, two
    32-bit operations each; the forest's and the select's few operations
    a row are fewer than the bytes."""
    n_edges, deleted, cvg, _twin, from_ed, to_ed, mult, _failed, m, _cap = \
        inputs
    _cid, _cmask, _u, t0, maj, mnr, _tw_maj, _tw_mnr, ends = outputs[:9]
    e, a, c = cvg.shape[0], from_ed.shape[0], t0.shape[0]
    named = torch.cat([from_ed, to_ed])
    named = named[(named >= 0) & (named < e)]
    live = (torch.arange(e, device=cvg.device) < n_edges) & ~deleted
    ok_f = (from_ed >= 0) & (from_ed < e)
    ok_t = (to_ed >= 0) & (to_ed < e)
    varc = (mult > 0) & ok_f & ok_t & live[from_ed.clamp(0, e - 1)] & \
        live[to_ed.clamp(0, e - 1)]
    twins = sum(in_range(x, e) for x in (maj, mnr, ends[:, 0], t0))
    moved = (25 * a + torch.unique(named).numel()
             + 8 * torch.unique(from_ed[varc]).numel() + 8 * twins
             + c * (58 + 32 * m) + 16)
    return bound_of(moved, 2 * c * ((m + 2) * (m + 1) + 2 * m * (2 * m + 4)))


def back_bound_ms(inputs, counts) -> tuple:
    """(bound ms, what sets it) of one back call on this call's inputs
    and counts.  When it merged: what its claims, apply and arc rows move
    and do (``claim_work``), with compared and cmask (2 B a row) and the counts
    read and written (48 B).  When nothing merged: ok, compared and cmask
    (3 B a row), the cid_arc entry and the failed byte of each row it
    marks (9 B), and the counts (48 B)."""
    ok, cmask = inputs[5], inputs[18]
    c = ok.shape[0]
    if int(counts[0]):
        moved, ops = claim_work(inputs[:17])
        return bound_of(moved + 2 * c + 48, ops)
    return bound_of(3 * c + 9 * int((cmask & ~ok).sum()) + 48, 0)


def front_topk_ms(wave, inputs, want, reps: int = 10) -> float:
    """The library call that computes the front's candidate order:
    ``torch.topk(keys, min(cand_cap, n_cand), largest=False,
    sorted=True)`` on the candidates' packed (coverage << 32) + row keys
    (built outside the timing; the port never calls it); its rows must
    be cid_arc's head.  Median CUDA-event ms."""
    n_edges, deleted, cvg, _twin, from_ed, to_ed, mult, failed, _m, cap = \
        inputs
    _prev, order, cmask, *_ = wave.candidates_plain(
        n_edges, deleted, cvg, from_ed, to_ed, mult, failed,
        from_ed.shape[0])
    rows = order[cmask]
    keys = (cvg[from_ed[rows]] << 32) + rows
    k = min(cap, keys.numel())
    top = torch.topk(keys, k, largest=False, sorted=True).values
    if not torch.equal(top & 0xFFFFFFFF, want[0][:k]):
        raise AssertionError("torch.topk's order differs from the front's")
    return cuda_ms(lambda: torch.topk(keys, k, largest=False, sorted=True),
                   reps)


def check_front(wave, cases, inputs) -> tuple:
    """The front against its plain version on one call's inputs; returns
    (max abs error, which must be 0, the plain outputs)."""
    got, want = wave.front(*inputs), wave.front_plain(*inputs)
    torch.cuda.synchronize()
    err = cases.max_abs_err(got, want)
    if err:
        raise AssertionError(f"front kernels differ from the plain version "
                             f"(max abs err {err}; A={inputs[4].shape[0]}, "
                             f"E={inputs[2].shape[0]}, m={inputs[8]}, "
                             f"cand_cap={inputs[9]})")
    return err, want


def check_back(wave, cases, inputs) -> tuple:
    """The back against its plain version on one call's inputs, each on
    its own copy of failed: the counts and failed, and the other outputs
    where it merged; returns (max abs error, which must be 0, the plain
    outputs)."""
    mine, plain = inputs[-1].clone(), inputs[-1].clone()
    got = wave.back(*inputs[:-1], mine)
    want = wave.back_plain(*inputs[:-1], plain)
    torch.cuda.synchronize()
    err = cases.back_err(got, want, mine, plain)
    if err:
        raise AssertionError(f"back kernels differ from the plain version "
                             f"(max abs err {err}; merged {int(want[0][0])}, "
                             f"A={inputs[12].shape[0]}, "
                             f"E={inputs[8].shape[0]})")
    return err, want


def check_entries(wave, cases, front_in, back_in) -> tuple:
    """The two entries of csrc/wave.cu against their plain versions on
    one wave's front and back inputs; the back's cid_arc, cmask and
    n_cand must be the plain front's.  Returns (max abs error, which must
    be 0, each entry's inputs, the plain outputs of the front and the
    back)."""
    err_f, want_f = check_front(wave, cases, front_in)
    err_b, want_b = check_back(wave, cases, back_in)
    # the back's inputs hold the rows the front gave on its inputs
    if not (torch.equal(want_f[0], back_in[19])
            and torch.equal(want_f[1], back_in[18])
            and int(want_f[11]) == int(back_in[20])):
        raise AssertionError("the back's cid_arc, cmask or n_cand differ "
                             "from the plain front's on the same wave")
    return (max(err_f, err_b), {"front": front_in, "back": back_in},
            {"front": want_f, "back": want_b})


def time_entries(wave, inputs, outs, reps: int = 10) -> dict:
    """The two entries and their plain versions timed on one wave's
    inputs (median CUDA-event ms of a wrapper call, its Python included;
    device ms of its kernels replayed from a CUDA graph, ``graph_ms``;
    host us of a call), with the bounds, and the front's library call
    (``front_topk_ms``).  The back's calls mark a copy of failed."""
    back_in = inputs["back"]
    (c, m), e = back_in[0].shape, back_in[8].shape[0]
    out = {"c": c, "m": m, "e": e, "a": back_in[12].shape[0],
           "ok_rows": int(back_in[5].sum()),
           "merged": int(outs["back"][0][0]),
           "n_cand": int(outs["front"][11])}
    calls = {
        "front": (wave.front, wave.front_plain, inputs["front"],
                  front_bound_ms(inputs["front"], outs["front"])),
        "back": (wave.back, wave.back_plain,
                 (*back_in[:-1], back_in[-1].clone()),
                 back_bound_ms(back_in, outs["back"][0]))}
    for name, (fn, plain, xs, bound) in calls.items():
        out[name] = {"ms": cuda_ms(lambda: fn(*xs), reps),
                     "device_ms": graph_ms(lambda: fn(*xs)),
                     "host_us": host_us(lambda: fn(*xs)),
                     "plain_ms": cuda_ms(lambda: plain(*xs), reps=3, warm=1),
                     "bound_ms": bound[0], "bound_by": bound[1]}
    out["front"]["library_ms"] = front_topk_ms(wave, inputs["front"],
                                               outs["front"], reps)
    return out


def phase_wave(wave, dev) -> dict:
    """The kernels of csrc/wave.cu against their plain versions on the
    card test's cases (``tests/test_torch_wave_kernels_gpu.py``): the
    front on every front case (cand_cap 8 and 1,024; m = 3, 9 and 30),
    the back on each with ok rows and without, and both on every named
    wave case at m = 3, 9 and 30 and random and mixed ones at C = 1,024
    (the front on the case's arc table, the back with its ok rows); all
    outputs exact (the back's E- and A-sized ones where it merged).  Then
    both timed on the ``mixed`` and ``random`` front cases at cand_cap
    1,024, m = 3, the back with ok rows."""
    cases = load_test("test_torch_wave_kernels_gpu.py")
    err = 0
    for i, (name, c, m) in enumerate(cases.GPU_CASES):
        front_in = cases.case_front_inputs(cases.wave_case(name, c, m,
                                                           300 + i), dev)
        err = max(err, check_front(wave, cases, (*front_in, m, 1024))[0],
                  check_back(wave, cases, cases.claim_back_inputs(
                      name, c, m, 400 + i, dev))[0])
    for i, (name, cap, m) in enumerate(cases.FRONT_GPU_CASES):
        case = cases.front_case(name, cap, m, i)
        e, want = check_front(wave, cases,
                              (*cases.front_inputs(case, dev), m, cap))
        cases.check_front_case(name, cap, int(want[11]))
        err = max(err, e)
    merged = 0
    for i, (name, cap, m, productive) in enumerate(cases.BACK_GPU_CASES):
        e, want = check_back(wave, cases, cases.back_inputs(
            cases.front_case(name, cap, m, i // 2), m, cap, i, productive,
            dev))
        merged += int(want[0][0]) > 0
        err = max(err, e)
    log(f"[wave] front {len(cases.FRONT_GPU_CASES)} cases, back "
        f"{len(cases.BACK_GPU_CASES)} ({merged} merged), both on "
        f"{len(cases.GPU_CASES)} wave cases: equal to their plain versions "
        f"(exact, tolerance 0)")
    times = {}
    for name in ("mixed", "random"):
        case = cases.front_case(name, 1024, 3, 7)
        e, inputs, outs = check_entries(
            wave, cases, (*cases.front_inputs(case, dev), 3, 1024),
            cases.back_inputs(case, 3, 1024, 7, True, dev))
        err = max(err, e)
        times[f"{name}_1024x3"] = time_entries(wave, inputs, outs)
    log("[wave] " + json.dumps(times))
    return {"max_abs_err": err, "synthetic": times}


def wave_on_kept_inputs(wave, kept, dev) -> dict:
    """The kernels of csrc/wave.cu on the front and back inputs kept from
    the main path's waves (host copies, moved back to the card one wave at
    a time): each of the two entries held against its plain version, the
    coverage checked to lie in [0, 16,000] (the claim key's ranks need
    it), both and their plain versions timed on each; medians and
    maxima, and the back's medians over the waves that merged and those
    that did not."""
    cases = load_test("test_torch_wave_kernels_gpu.py")
    err, rows = 0, []
    for call in kept:
        front_in, back_in = (tuple(x.to(dev) if isinstance(
            x, torch.Tensor) else x for x in xs) for xs in call)
        cvg = back_in[8]
        if int(cvg.min()) < 0 or int(cvg.max()) > cases.MAX_COV:
            raise AssertionError(f"a wave's coverage lies outside [0, "
                                 f"{cases.MAX_COV}]: {int(cvg.min())}, "
                                 f"{int(cvg.max())}")
        e, inputs, outs = check_entries(wave, cases, front_in, back_in)
        err = max(err, e)
        rows.append(time_entries(wave, inputs, outs, reps=5))
        del front_in, back_in, inputs, outs
    out = {"calls_kept": len(kept), "max_abs_err": err,
           "coverage_in_range": True,
           "merged_calls": sum(r["merged"] > 0 for r in rows),
           "ok_rows_max": max(r["ok_rows"] for r in rows),
           "n_cand_median": statistics.median(r["n_cand"] for r in rows),
           "e": rows[0]["e"], "a": rows[0]["a"], "c": rows[0]["c"],
           "m": rows[0]["m"]}
    for name in ("front", "back"):
        got = [r[name] for r in rows]
        bound = sorted((g["bound_ms"], g["bound_by"]) for g in got)
        out[name] = {
            "ms": statistics.median(g["ms"] for g in got),
            "ms_max": max(g["ms"] for g in got),
            "device_ms": statistics.median(g["device_ms"] for g in got),
            "device_ms_max": max(g["device_ms"] for g in got),
            "host_us": statistics.median(g["host_us"] for g in got),
            "plain_ms": statistics.median(g["plain_ms"] for g in got),
            "bound_ms": bound[len(bound) // 2][0],
            "bound_by": bound[len(bound) // 2][1]}
    out["front"]["library_ms"] = statistics.median(
        r["front"]["library_ms"] for r in rows)
    for merged in (True, False):
        got = [r["back"] for r in rows if (r["merged"] > 0) == merged]
        if got:
            out["back"]["merged" if merged else "unproductive"] = {
                key: statistics.median(g[key] for g in got)
                for key in ("ms", "device_ms", "host_us", "plain_ms",
                            "bound_ms")}
    return out


class WaveRecorder:
    """Wraps the Tour-Bus wave program (``graph/tourbus.WaveProgram``)
    while a path runs: counts the waves it launches, times the host's
    part of each launch (the device not waited for: the eager first
    wave's launches, the capture, a graph replay), and keeps the
    identity-check inputs of every ``every``-th wave (0: none) and the
    inputs of the wave's front and back of every ``every``-th wave and
    every ``every_productive``-th productive one (0: none).  A wave's
    inputs are the tensors of the last call of each wrapper, the eager
    wave's or the one captured into the graph, which each replay
    refills.  A kept wave's identity node lists and found flags are
    copied on the card right after its launch (in stream order), the
    graph tensors, which every wave of a pinch shares, kept by
    reference; they stay allocated until the run ends, so the stages'
    peak bytes hold them.  The front and back inputs are copied to the
    host (a blocking copy after the launch; at a productive wave, before
    ``apply`` overwrites the buffers), which the peak bytes do not see,
    with ``failed`` as the wave found it: copied on the card before the
    launch of every ``every``-th wave (the back marks it in place when
    nothing merges), as it is after a productive one."""

    def __init__(self, lcs, wave, tourbus, every: int = 0,
                 every_productive: int = 0):
        self.lcs, self.wave, self.tourbus = lcs, wave, tourbus
        self.every, self.every_productive = every, every_productive
        self.waves, self.productive, self.kept, self.last = 0, 0, [], None
        self.kept_wave, self.last_wave = [], {}
        self.host_s = {"eager": [], "capture": [], "replay": []}
        self.real = {"identity": lcs.identity_check, "front": wave.front,
                     "back": wave.back,
                     "launch": tourbus.WaveProgram.launch,
                     "apply": tourbus.WaveProgram.apply}

    def keep_wave(self, failed) -> None:
        """The last wave's front and back inputs, ``failed`` as the wave
        found it, copied to the host."""
        front_in = (*self.last_wave["front"][:7], failed,
                    *self.last_wave["front"][8:])
        back_in = (*self.last_wave["back"][:-1], failed)
        self.kept_wave.append(tuple(
            tuple(x.to("cpu", copy=True) if isinstance(x, torch.Tensor)
                  else x for x in xs)
            for xs in (front_in, back_in)))

    def __enter__(self):
        real = self.real

        def identity(*inputs):
            self.last = inputs
            return real["identity"](*inputs)

        def front(*inputs):
            self.last_wave["front"] = inputs
            return real["front"](*inputs)

        def back(*inputs):
            self.last_wave["back"] = inputs
            return real["back"](*inputs)

        def launch(prog):
            kind = ("eager", "capture", "replay")[min(prog.waves, 2)]
            keep = self.every and self.waves % self.every == 0
            failed = prog.failed.clone() if keep else None
            t0 = time.perf_counter()
            counts = real["launch"](prog)
            self.host_s[kind].append(time.perf_counter() - t0)
            if keep:
                maj, mnr, found, *rest = self.last
                self.kept.append((maj.clone(), mnr.clone(), found.clone(),
                                  *rest))
                self.keep_wave(failed)
            self.waves += 1
            return counts

        def apply(prog):
            if self.every_productive and \
                    self.productive % self.every_productive == 0:
                # a productive wave leaves failed as it found it
                self.keep_wave(prog.failed)
            self.productive += 1
            return real["apply"](prog)

        self.lcs.identity_check = identity
        self.wave.front, self.wave.back = front, back
        self.tourbus.WaveProgram.launch = launch
        self.tourbus.WaveProgram.apply = apply
        return self

    def __exit__(self, *exc):
        self.lcs.identity_check = self.real["identity"]
        self.wave.front = self.real["front"]
        self.wave.back = self.real["back"]
        self.tourbus.WaveProgram.launch = self.real["launch"]
        self.tourbus.WaveProgram.apply = self.real["apply"]

    def numbers(self) -> dict:
        """Waves, captures and replays, and the host microseconds of a
        launch of each kind (median; the capture's total)."""
        us = {kind: 1e6 * statistics.median(t) if t else None
              for kind, t in self.host_s.items()}
        return {"waves": self.waves, "captures": self.tourbus.CAPTURES,
                "replays": self.tourbus.REPLAYS,
                "host_us_replay": us["replay"], "host_us_eager": us["eager"],
                "host_us_capture": us["capture"]}


# the entries of the Tour-Bus wave's kernels, in the order of
# ``wave_executions``
WAVE_ENTRIES = ("identity", "front", "back")


def wave_executions(lcs, wave) -> tuple:
    """Executions of the three kernel entries of a Tour-Bus wave: the
    identity check, the front and the back."""
    return lcs.IDENTITY_LAUNCHES, wave.FRONT_LAUNCHES, wave.BACK_LAUNCHES


def launch_numbers(launches) -> dict:
    """A path's launches (merge, then ``wave_executions``) by name."""
    return {"merge_launches": launches[0],
            **{f"{name}_launches": n
               for name, n in zip(WAVE_ENTRIES, launches[1:])}}


def reset_counts(merge_path, lcs, wave, tourbus) -> None:
    """Every kernel's launch count and the wave programs' captures and
    replays to 0."""
    merge_path.LAUNCHES = lcs.IDENTITY_LAUNCHES = 0
    wave.FRONT_LAUNCHES = wave.BACK_LAUNCHES = 0
    tourbus.CAPTURES = tourbus.REPLAYS = 0


def check_wave_programs(tourbus, lcs, wave, waves, what: str) -> None:
    """The card's pinches ran as wave programs: one capture a pinch of two
    waves or more, every later wave a replay, and one execution of each
    kernel entry of the wave (identity, front, back) a wave.  ``waves``:
    the Tour-Bus waves of each pinch on the card."""
    n = sum(waves)
    want = (sum(w >= 2 for w in waves), sum(max(w - 1, 0) for w in waves),
            n, n, n)
    got = (tourbus.CAPTURES, tourbus.REPLAYS, *wave_executions(lcs, wave))
    if got != want:
        raise AssertionError(f"{what}: captures, replays, identity, front "
                             f"and back executions {got}, not {want} for "
                             f"pinches of {list(waves)} waves")


def identity_on_wave_inputs(lcs, kept) -> dict:
    """The identity kernel on the inputs kept from the main path's waves:
    each held against the plain version, the kernel timed on each, the
    plain version and the host time of a call on the one with the most
    compared bases."""
    err, ms, bounds, compared, lengths, bases = 0, [], [], [], [], []
    for inputs in kept:
        e, want = check_identity(lcs, inputs)
        err = max(err, e)
        ms.append(cuda_ms(lambda: lcs.identity_check(*inputs), reps=5))
        bounds.append(identity_bound_ms(inputs, want))
        cmp_ = want[2]
        compared.append(int(cmp_.sum()))
        lengths.extend(want[0][cmp_].tolist())
        bases.append(int((want[0] + want[1])[cmp_].sum()))
    top = kept[max(range(len(kept)), key=bases.__getitem__)]
    plain_ms = cuda_ms(lambda: lcs.identity_check_plain(*top), reps=3,
                       warm=1)
    bound_ms, bound_by = sorted(bounds)[len(bounds) // 2]
    tensors = {x.data_ptr(): x.nbytes for call in kept for x in call
               if isinstance(x, torch.Tensor)}
    return {"calls_kept": len(kept), "kept_bytes": sum(tensors.values()),
            "max_abs_err": err,
            "ms": statistics.median(ms), "ms_max": max(ms),
            "host_us": host_us(lambda: lcs.identity_check(*top)),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "compared_rows_median": statistics.median(compared),
            "compared_rows_max": max(compared),
            "la_median": statistics.median(lengths) if lengths else 0,
            "la_max": max(lengths, default=0)}


def tourbus_waves(res) -> int:
    """The Tour-Bus waves of a CLI result: a contig stage's (result,
    table, k) or ``all``'s AllResult; 0 for the other stages."""
    contig = res[0] if isinstance(res, tuple) else getattr(res, "contig",
                                                             None)
    return contig.tourbus.get("waves", 0) if contig is not None else 0


def phase_kernel(merge_path, dev) -> dict:
    from soapdenovo_trans_tpu_torch.ops import bits

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
    # the library call that orders the same rows: the plain version's
    # stable sort of the folded int64 keys (kernels/merge_path.py:119),
    # without the masking, concatenation and count gather around it
    keys = torch.cat([bits.fold2(a), bits.fold2(b)])
    library_ms = cuda_ms(lambda: torch.sort(keys, stable=True))
    del keys
    moved = 2 * 2 * UNIT_ROWS * (16 + 4)  # each row read once, written once
    log(f"[kernel] {UNIT_ROWS}+{UNIT_ROWS} rows: kernel {ms:.3f} ms "
        f"({moved / ms / 1e9:.3f} TB/s), plain sort {plain_ms:.3f} ms, "
        f"torch.sort of the folded keys alone {library_ms:.3f} ms")
    del a, ac, b, bc
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms, **phase_packed(merge_path, dev),
            "upload": phase_upload(dev)}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of fn() in milliseconds, the device
    synchronized before and after (fn is run once first)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_upload(dev) -> dict:
    """One counting build unit of 100 bp reads (UNIT_ROWS K-windows,
    0.1% N bases) uploaded raw and 2-bit packed: the same sorted run,
    and the milliseconds of each step."""
    from soapdenovo_trans_tpu_torch.ops import dictionary, readpack

    read_len = 100
    reads = -(-UNIT_ROWS // (read_len - K + 1) // 4096) * 4096
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(reads, read_len), dtype=np.uint8)
    codes[rng.random((reads, read_len)) < 0.001] = 4
    lengths = np.full(reads, read_len, np.int32)

    packed = dictionary.pack_host_reads(codes, lengths)
    if packed[0] != "packed":
        raise AssertionError("the build unit was not packed")
    raw_run = dictionary.sorted_run_from_reads(
        torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev), K)
    run = dictionary.sorted_run_from_prepped(
        dictionary.put_prepped(packed, dev), K)
    if not (torch.equal(run.rows, raw_run.rows)
            and torch.equal(run.count, raw_run.count)):
        raise AssertionError("the packed upload builds another run than "
                             "the raw upload")
    del run, raw_run
    on_card = dictionary.put_prepped(packed, dev)
    times = {
        "reads": reads, "raw_bytes": int(codes.nbytes),
        "packed_bytes": int(packed[1].nbytes + packed[2].nbytes),
        "raw_upload_ms": host_ms(
            lambda: torch.from_numpy(codes).to(dev)),
        "pack_host_ms": host_ms(
            lambda: dictionary.pack_host_reads(codes, lengths), reps=3),
        "packed_upload_ms": host_ms(
            lambda: dictionary.put_prepped(packed, dev)),
        "unpack_ms": cuda_ms(lambda: readpack.unpack_reads(
            on_card[1], on_card[2], read_len), reps=5)}
    times["packed_total_ms"] = times["pack_host_ms"] + \
        times["packed_upload_ms"] + times["unpack_ms"]
    log("[upload] one build unit, raw against 2-bit packed (the same "
        "sorted run): " + json.dumps(times))
    del on_card
    torch.cuda.empty_cache()
    return times


def packed_table(dictionary, gen: torch.Generator, extra, dev):
    """A PackedTable of PACKED_ROWS distinct K = 23 rows (53-bit values:
    key << 7 | payload) with counts in 1..99, made on the card; it
    holds every value of ``extra``."""
    draw = torch.randint(0, 1 << 53, (PACKED_ROWS + (1 << 20),),
                         generator=gen, device=dev)
    vals = torch.unique(torch.cat([extra, draw]))[:PACKED_ROWS]
    if vals.shape[0] != PACKED_ROWS:
        raise AssertionError("too few distinct rows drawn")
    rows = torch.stack([vals >> 32, vals & 0xFFFFFFFF], 1)
    cnt = torch.randint(1, 100, (PACKED_ROWS,), generator=gen,
                        device=dev).to(torch.int32)
    return dictionary.PackedTable(rows, cnt, PACKED_ROWS), vals


def phase_packed(merge_path, dev) -> dict:
    """merge_packed and merge_finalize on the card: the kernel path
    against concat + sort on the same tensors."""
    from soapdenovo_trans_tpu_torch.ops import dictionary

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    a, a_vals = packed_table(dictionary, gen, torch.zeros(
        0, dtype=torch.int64, device=dev), dev)
    b, _ = packed_table(dictionary, gen, a_vals[::4], dev)
    del a_vals

    before = merge_path.LAUNCHES
    got = dictionary.merge_packed(a, b)
    want = dictionary.merge_packed_plain(a, b)
    table = dictionary.merge_finalize(a, b, K)
    want_table = dictionary.merge_finalize_plain(a, b, K)
    torch.cuda.synchronize()
    if merge_path.LAUNCHES != before + 2:
        raise AssertionError(
            f"merge_packed and merge_finalize launched the kernel "
            f"{merge_path.LAUNCHES - before} times, not once each")
    shared = 2 * PACKED_ROWS - got.n
    if not (got.n == want.n and torch.equal(got.rows, want.rows)
            and torch.equal(got.count, want.count)) or shared <= 0:
        raise AssertionError("merge_packed differs from concat + sort")
    for name, x, y in zip(table._fields, table, want_table):
        if not (torch.equal(x, y) if torch.is_tensor(x) else x == y):
            raise AssertionError(f"merge_finalize differs from concat + "
                                 f"sort in {name}")
    if int(table.count.sum()) != int(a.count.sum()) + int(b.count.sum()):
        raise AssertionError("merge_finalize lost counts")
    del got, want, want_table
    times = {
        "merge_rows_ms": cuda_ms(
            lambda: dictionary._merge_rows(a, b), reps=5),
        "merge_packed_ms": cuda_ms(
            lambda: dictionary.merge_packed(a, b), reps=5),
        "merge_packed_plain_ms": cuda_ms(
            lambda: dictionary.merge_packed_plain(a, b), reps=5),
        "merge_finalize_ms": cuda_ms(
            lambda: dictionary.merge_finalize(a, b, K), reps=5),
        "merge_finalize_plain_ms": cuda_ms(
            lambda: dictionary.merge_finalize_plain(a, b, K), reps=5)}
    log(f"[kernel] PackedTable {PACKED_ROWS}+{PACKED_ROWS} rows ({shared} "
        f"shared, {table.n} keys): merge_packed and merge_finalize launch "
        f"the kernel once each and equal concat + sort (exact); " +
        ", ".join(f"{name} {ms:.3f}" for name, ms in times.items()))
    del a, b, table
    torch.cuda.empty_cache()
    return times


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


def copy_prefix(src: str, dst: str, exts=None) -> None:
    """Copy the stage files of prefix src (all of them, or those with
    the given extensions) to prefix dst."""
    folder, name = os.path.split(src)
    for f in os.listdir(folder):
        if f.startswith(name + ".") and (exts is None
                                         or f[len(name):] in exts):
            shutil.copy(os.path.join(folder, f), dst + f[len(name):])


def phase_cpu_gpu(cli, merge_path, lcs, wave, tourbus, pg_stage, perf_e2e,
                  tmp: str) -> tuple:
    cfg = perf_e2e.synth(tmp, n_tx=40, n_pairs=3000, seed=1)
    default_rows = pg_stage.TARGET_BUILD_ROWS
    reset_counts(merge_path, lcs, wave, tourbus)
    pinches = []

    def stage(argv, device):  # the card's Tour-Bus waves, a pinch each
        res = run_stage(cli, argv, device)
        if device.startswith("cuda"):
            pinches.append(tourbus_waves(res))
        return res

    pg_stage.TARGET_BUILD_ROWS = 1  # 4096-read units: several merges
    try:
        for k in (K, 31):
            staged = {d: os.path.join(tmp, f"small_k{k}_{d}") for d in DEVICES}
            whole = {d: os.path.join(tmp, f"all_k{k}_{d}") for d in DEVICES}
            flagged = {d: os.path.join(tmp, f"flags_k{k}_{d}")
                       for d in DEVICES}
            resumed = {d: os.path.join(tmp, f"resumed_k{k}_{d}")
                       for d in DEVICES}
            meshed = {d: os.path.join(tmp, f"mesh_k{k}_{d}")
                      for d in DEVICES}
            for d in DEVICES:
                stage(["pregraph", "-s", cfg, "-K", str(k), "-R", "-o",
                       staged[d]], d)
            for argv in (["contig", "-R", "-g"],
                         ["map", "-s", cfg, "-f", "-r", "-g"],
                         ["scaff", "-s", cfg, "-F", "-R", "-g"]):
                for d in DEVICES:
                    stage(argv + [staged[d]], d)
            for d in DEVICES:
                copy_prefix(staged[d], resumed[d])
                stage(["scaff", "-s", cfg, "-S", "-F", "-g", resumed[d]], d)
                stage(["all", "-s", cfg, "-K", str(k), "-o", whole[d]], d)
                stage(["all", "-s", cfg, "-K", str(k), "-F", "-f", "-R",
                       "-o", flagged[d]], d)
                # two logical shards of the same device
                stage(["all", "-s", cfg, "-K", str(k), "-o", meshed[d]],
                      "cpu,cpu" if d == "cpu" else "cuda:0,cuda:0")
            extras = GAP_READ_FILES + READ_TABLES
            assert_same_files(staged["cpu"], staged["cuda"],
                              ALL_FILES + (".newContigIndex",) + PATH_FILES
                              + extras,
                              f"K={k}, stage by stage with -R -f -r -F, "
                              f"cpu vs cuda")
            assert_same_files(resumed["cpu"], resumed["cuda"], SCAFF_FILES,
                              f"K={k}, scaff -S -F, cpu vs cuda")
            assert_same_files(resumed["cuda"], staged["cuda"], (".scafSeq",),
                              f"K={k}, scaff -S -F vs scaff -F")
            assert_same_files(whole["cpu"], whole["cuda"], ALL_FILES,
                              f"K={k}, all, cpu vs cuda")
            assert_same_files(flagged["cpu"], flagged["cuda"],
                              ALL_FILES + extras,
                              f"K={k}, all -F -f -R, cpu vs cuda")
            for d in DEVICES:
                assert_same_files(meshed[d], whole[d], ALL_FILES,
                                  f"K={k}, all on a mesh of 2 {d} shards "
                                  f"vs one device")
            log(f"[parity] K={k}: cpu and cuda files of pregraph -R, "
                f"contig -R, map -f -r, scaff -F -R and scaff -S -F "
                f"identical stage by stage, and under all and all -F -f -R; "
                f"all on two logical shards of either device writes the "
                f"one-device files")
    finally:
        pg_stage.TARGET_BUILD_ROWS = default_rows
    waves = sum(pinches)
    if waves < 1 or lcs.IDENTITY_LAUNCHES != waves:
        raise AssertionError(f"the cuda runs launched the identity kernel "
                             f"{lcs.IDENTITY_LAUNCHES} times over {waves} "
                             f"Tour-Bus waves")
    check_wave_programs(tourbus, lcs, wave, pinches, "the cuda runs")
    log(f"[parity] the cuda runs executed the identity, front and back "
        f"kernels {wave_executions(lcs, wave)} times, once each a Tour-Bus "
        f"wave; {tourbus.CAPTURES} wave captures and {tourbus.REPLAYS} "
        f"replays over pinches of {pinches} waves")
    return (merge_path.LAUNCHES, *wave_executions(lcs, wave))


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


def phase_slice(cli, merge_path, lcs, wave, tourbus, cfg: str, tmp: str):
    out = os.path.join(tmp, "slice")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(merge_path, lcs, wave, tourbus)
    t0 = time.time()
    res = run_cli(cli, cfg, out, K, "cuda")
    torch.cuda.synchronize()
    stage_s = time.time() - t0
    launches = (merge_path.LAUNCHES, *wave_executions(lcs, wave))
    peak = torch.cuda.max_memory_allocated()
    if launches[0] < 1:
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
        f"merge launches {launches[0]}")
    log("[slice] " + json.dumps({
        "pairs": CONTIG_PAIRS, "stage_s": stage_s,
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


def phase_all(cli, merge_path, lcs, wave, tourbus, smi: str, tmp: str,
              cfg: str):
    from soapdenovo_trans_tpu_torch.graph import contig_merge
    from soapdenovo_trans_tpu_torch.ops import dictionary, kmer
    from soapdenovo_trans_tpu_torch.stages import pelinks

    out = os.path.join(tmp, "all")
    dev = torch.device("cuda")
    reset_counts(merge_path, lcs, wave, tourbus)
    t0 = time.time()
    with WaveRecorder(lcs, wave, tourbus, every=512,
                      every_productive=64) as recorder:
        res = run_stage(cli, ["all", "-s", cfg, "-K", str(K), "-o", out],
                        "cuda")
    all_s = time.time() - t0
    launches = (merge_path.LAUNCHES, *wave_executions(lcs, wave))
    if launches[0] < 1:
        raise AssertionError("the main path never launched the merge "
                             "kernel")
    waves = res.contig.tourbus["waves"]
    if not launches[1] == launches[2] == launches[3] == recorder.waves \
            == waves:
        raise AssertionError(
            f"the identity, front and back kernels executed "
            f"{launches[1:]} times in {recorder.waves} launched waves over "
            f"{waves} Tour-Bus waves, not once each a wave")
    check_wave_programs(tourbus, lcs, wave, [waves], "all's contig stage")
    program = recorder.numbers()
    log(f"[all] identity, front and back kernel executions "
        f"{launches[1:]} = Tour-Bus waves; the wave program: "
        + json.dumps(program))
    id_wave = identity_on_wave_inputs(lcs, recorder.kept)
    log("[all] the identity kernel on the inputs of every 512th wave: "
        + json.dumps(id_wave))
    wave_real = wave_on_kept_inputs(wave, recorder.kept_wave, dev)
    del recorder
    log("[all] the front and back kernels on the inputs of every 512th "
        "wave and every 64th productive one: "
        + json.dumps(wave_real))

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
        "wave_program": program,
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
        **launch_numbers(launches)}
    peaks = ", ".join(f"{s} {b / 1e9:.2f}" for s, b in res.peak_bytes.items())
    log(f"[all] {all_s:.1f}s: " + ", ".join(
        f"{s} {t:.1f}s" for s, t in res.stage_seconds.items()) +
        f"; peak GB {peaks}; {tb['waves']} Tour-Bus waves of "
        f"{tb['s_per_wave'] * 1e3:.2f} ms ({program['captures']} capture, "
        f"{program['replays']} replays of {program['host_us_replay']:.1f} "
        f"host us) on {smi}")
    return (launches, id_wave, wave_real), numbers, res, out


def timed_stage(cli, argv, seconds: dict, peaks: dict, name: str):
    """One CLI call on the card, its seconds (device synchronized) and
    peak bytes recorded under ``name``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_stage(cli, argv, "cuda")
    torch.cuda.synchronize()
    seconds[name] = time.time() - t0
    peaks[name] = torch.cuda.max_memory_allocated()
    return res


def read_in_gap_records(path: str) -> int:
    """Records of a binary .readInGap: int32 len, contig, pos, then
    len // 4 + 1 bytes of 2-bit bases."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = n = 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<i", data, pos)
        pos += 12 + ln // 4 + 1
        n += 1
    if pos != len(data):
        raise AssertionError(".readInGap ends inside a record")
    return n


def phase_flags(cli, merge_path, lcs, wave, tourbus, perf_e2e, smi: str,
                tmp: str, all_res, cfg: str, all_out: str):
    """Phase 7: the options at full width."""
    from soapdenovo_trans_tpu_torch.io import stagefiles
    from soapdenovo_trans_tpu_torch.ops import dictionary, kmer

    dev = torch.device("cuda")
    seconds, peaks = {}, {}
    table = all_res.pregraph.table
    base_n = sum(s.count("N") for _, s in all_res.scaff.recs)
    reset_counts(merge_path, lcs, wave, tourbus)
    t_phase = time.time()

    # gap reads, read tables and gap filling on phase 6's contigs
    out = os.path.join(tmp, "fill")
    copy_prefix(all_out, out, RESUME_INPUTS)
    mres = timed_stage(cli, ["map", "-s", cfg, "-f", "-r", "-g", out],
                       seconds, peaks, "map -f -r")
    sres = timed_stage(cli, ["scaff", "-s", cfg, "-F", "-R", "-g", out],
                       seconds, peaks, "scaff -F -R")
    resumed = os.path.join(tmp, "resume")
    copy_prefix(out, resumed)
    timed_stage(cli, ["scaff", "-s", cfg, "-S", "-F", "-g", resumed],
                seconds, peaks, "scaff -S -F")
    assert_same_files(out, resumed, (".scafSeq", ".gapSeq"),
                      "scaff -S -F after scaff -F")

    kinds = {}
    for _idx, _ji, kind, _seq in sres.gap_report:
        kinds[kind] = kinds.get(kind, 0) + 1
    junctions = sum(len(t.contigs) - 1 for t in sres.transcripts)
    if not kinds.get("localasm", 0) + kinds.get("overlap", 0):
        raise AssertionError(f"no gap filled of {junctions}: {kinds}")
    fills = [seq for _i, _j, kind, seq in sres.gap_report
             if kind == "localasm"]
    n_fill, hit_fill = table_windows(kmer, dictionary, table.keys, fills, K,
                                     dev)
    scaffolds = [s for h, s in sres.recs if h.startswith("scaffold")]
    n_win, hit_win = table_windows(kmer, dictionary, table.keys, scaffolds,
                                   K, dev)
    for what, n, hit in (("filled sequences", n_fill, hit_fill),
                         ("-F scaffolds", n_win, hit_win)):
        if n and hit < 0.9 * n:
            raise AssertionError(f"only {hit} of {n} N-free K-windows of "
                                 f"the {what} are read k-mers")
    fill_n = sum(s.count("N") for _, s in sres.recs)
    if not fill_n < base_n:
        raise AssertionError(f".scafSeq holds {fill_n} N bases with -F, "
                             f"{base_n} without")
    with open(out + ".RPKM.Stat") as fh:
        lines = fh.read().splitlines()
    total = int(lines[1].split("=")[1])
    hits = sum(int(line.split("\t")[2]) for line in lines[3:])
    if not 0 < total == hits <= mres.mapped:
        raise AssertionError(f".RPKM.Stat: hits sum to {hits}, "
                             f"Total_unique_reads_num={total}, "
                             f"{mres.mapped} reads mapped")
    in_gap = read_in_gap_records(out + ".readInGap")
    short = read_stage_file(out + ".shortreadInGap.gz").count(b">read_")
    if not in_gap == short == mres.gap_reads:
        raise AssertionError(f".readInGap holds {in_gap} records, "
                             f".shortreadInGap.gz {short}, the map stage "
                             f"counted {mres.gap_reads}")
    log(f"[flags] {junctions} junctions: {kinds}; {hit_fill} of {n_fill} "
        f"K-windows of the {len(fills)} local assemblies and {hit_win} of "
        f"{n_win} of the scaffolds are read k-mers; N bases {base_n} -> "
        f"{fill_n}; {in_gap} gap reads, {mres.pe_rows} PE rows; RPKM hits "
        f"{hits}")

    # read paths and repeat splitting on a smaller simulation
    t0 = time.time()
    reps_dir = os.path.join(tmp, "reps")
    os.makedirs(reps_dir)
    reps_cfg = perf_e2e.synth(reps_dir, n_tx=REPS_TX, n_pairs=REPS_PAIRS,
                              seed=0)
    seconds["simulate reps"] = time.time() - t0
    reps = os.path.join(reps_dir, "reps")
    pres = timed_stage(cli, ["pregraph", "-s", reps_cfg, "-K", str(K), "-R",
                             "-o", reps], seconds, peaks, "pregraph -R")
    recs = stagefiles.read_path_bin(reps + ".path")
    with open(reps + ".markOnEdge") as fh:
        marks = sum(1 for _ in fh)
    if len(recs) != pres.path_reads or pres.path_reads <= 0 or \
            marks != pres.edges.n_edges:
        raise AssertionError(
            f".path holds {len(recs)} records, the recorder counted "
            f"{pres.path_reads}; .markOnEdge has {marks} lines for "
            f"{pres.edges.n_edges} edges")
    n_path_edges = sum(map(len, recs))
    del recs
    with WaveRecorder(lcs, wave, tourbus) as recorder:
        cres, _table, _k = timed_stage(cli, ["contig", "-R", "-g", reps],
                                       seconds, peaks, "contig -R")
    if cres.reps_split is None:
        raise AssertionError("contig -R did not read .path")
    check_contig_files(reps, cres.contigs.n)
    launches = (merge_path.LAUNCHES, *wave_executions(lcs, wave))
    if launches[0] < 1:
        raise AssertionError("phase 7 never launched the merge kernel")
    waves = cres.tourbus["waves"]
    if not launches[1] == launches[2] == launches[3] == recorder.waves \
            == waves:
        raise AssertionError(
            f"the identity, front and back kernels executed "
            f"{launches[1:]} times in {recorder.waves} launched waves over "
            f"{waves} Tour-Bus waves of contig -R")
    check_wave_programs(tourbus, lcs, wave, [waves], "contig -R")
    program = recorder.numbers()
    numbers = {
        "card": smi, "pairs": CONTIG_PAIRS, "phase_s": time.time() - t_phase,
        "seconds": seconds, "peak_bytes": peaks,
        "map": {"gap_reads": in_gap, "pe_rows": mres.pe_rows,
                "phase_s": mres.phase_seconds},
        "scaff": {"junctions": junctions, "closed": kinds,
                  "fill_windows": n_fill, "fill_window_share":
                  hit_fill / max(n_fill, 1), "scaffold_window_share":
                  hit_win / max(n_win, 1), "n_bases_before": base_n,
                  "n_bases_after": fill_n, "rpkm_hits": hits,
                  "phase_s": sres.phase_seconds},
        "reps": {"pairs": REPS_PAIRS, "path_reads": pres.path_reads,
                 "path_edges": n_path_edges, "edges": pres.edges.n_edges,
                 "split": cres.reps_split, "contigs": cres.contigs.n,
                 "pregraph_phase_s": pres.phase_seconds,
                 "contig_phase_s": cres.phase_seconds,
                 "waves": cres.tourbus["waves"],
                 "s_per_wave": cres.tourbus["s_per_wave"],
                 "wave_program": program},
        **launch_numbers(launches)}
    log(f"[flags] {numbers['phase_s']:.1f}s: " + ", ".join(
        f"{name} {sec:.1f}s" for name, sec in seconds.items()) +
        f"; {pres.path_reads} read paths, {cres.reps_split} repeat edges "
        f"split; contig -R {cres.tourbus['waves']} Tour-Bus waves of "
        f"{cres.tourbus['s_per_wave'] * 1e3:.2f} ms ({program['captures']} "
        f"capture, {program['replays']} replays of "
        f"{program['host_us_replay']:.1f} host us) on {smi}; identity, "
        f"front and back kernel executions {launches[1:]}")
    return launches, numbers, out


def edge_records(path: str) -> list:
    """The sorted records of an .edge.gz: each a header (length, end
    k-mers, coverage, twin flag) with its sequence."""
    recs = []
    for line in read_stage_file(path).decode().splitlines():
        if line.startswith(">"):
            recs.append([line])
        else:
            recs[-1].append(line)
    return sorted("\n".join(r) for r in recs)


def phase_mesh(cli, merge_path, lcs, wave, tourbus, smi: str, tmp: str,
               all_res, cfg: str, all_out: str, map_out: str):
    """Phase 8: pregraph and map on MESH_SHARDS logical shards of the
    card, against the one-device files of phases 6 and 7."""
    spec = ",".join(["cuda:0"] * MESH_SHARDS)
    dense = all_res.pregraph
    seconds, peaks = {}, {}
    t_phase = time.time()

    out = os.path.join(tmp, "mesh")
    reset_counts(merge_path, lcs, wave, tourbus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_stage(cli, ["pregraph", "-s", cfg, "-K", str(K), "-o", out],
                    spec)
    torch.cuda.synchronize()
    seconds["pregraph"] = time.time() - t0
    peaks["pregraph"] = torch.cuda.max_memory_allocated()
    launches = merge_path.LAUNCHES
    if launches < 1:
        raise AssertionError("the mesh path never launched the merge kernel")
    if res.freq_hist is None or res.exchanges is None:
        raise AssertionError("pregraph did not take the mesh path")
    if read_stage_file(out + ".kmerFreq") != \
            read_stage_file(all_out + ".kmerFreq"):
        raise AssertionError("mesh: .kmerFreq differs from the one-device "
                             "run's")
    got = (res.n_distinct, res.edges.n_edges, res.arcs.n)
    want = (dense.table.n, dense.edges.n_edges, dense.arcs.n)
    if got != want:
        raise AssertionError(f"mesh: (distinct k-mers, edges, preArcs) "
                             f"{got}, one device {want}")
    if edge_records(out + ".edge.gz") != edge_records(all_out + ".edge.gz"):
        raise AssertionError("mesh: the edge records differ from the "
                             "one-device run's")
    same_bytes = [ext for ext in STAGE_FILES if read_stage_file(out + ext)
                  == read_stage_file(all_out + ext)]
    log(f"[mesh] pregraph on {MESH_SHARDS} logical shards of one card: "
        f"{got[0]} distinct k-mers, {got[1]} edges, {got[2]} preArcs and "
        f"the edge records as on one device; byte-identical files: "
        f"{' '.join(same_bytes)}; merge launches {launches}")

    mapped = os.path.join(tmp, "mesh_map")
    copy_prefix(all_out, mapped, RESUME_INPUTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mres = run_stage(cli, ["map", "-s", cfg, "-g", mapped], spec)
    torch.cuda.synchronize()
    seconds["map"] = time.time() - t0
    peaks["map"] = torch.cuda.max_memory_allocated()
    if mres.exchanges is None:
        raise AssertionError("map did not take the mesh path")
    for ext in MAP_FILES + (".peGrads",):
        if read_stage_file(mapped + ext) != read_stage_file(map_out + ext):
            raise AssertionError(f"mesh: map's {ext} differs from the "
                                 f"one-device run's")
    numbers = {
        "card": smi, "shards": MESH_SHARDS,
        "what": f"{MESH_SHARDS} logical shards on one card",
        "pairs": CONTIG_PAIRS, "phase_s": time.time() - t_phase,
        "seconds": seconds, "peak_bytes": peaks,
        "pregraph_phase_s": res.phase_seconds,
        "one_device_pregraph_phase_s": dense.phase_seconds,
        "distinct_kmers": got[0], "edges": got[1], "pre_arcs": got[2],
        "byte_identical": same_bytes,
        "exchanges": res.exchanges, "exchange_bytes": res.exchange_bytes,
        "map": {"mapped": mres.mapped, "groups": mres.groups,
                "phase_s": mres.phase_seconds, "exchanges": mres.exchanges,
                "exchange_bytes": mres.exchange_bytes},
        **launch_numbers((launches, *wave_executions(lcs, wave)))}
    log(f"[mesh] {numbers['phase_s']:.1f}s: pregraph "
        f"{seconds['pregraph']:.1f}s (" + ", ".join(
            f"{n} {t:.1f}" for n, t in res.phase_seconds.items()) +
        f"), peak {peaks['pregraph'] / 1e9:.2f} GB, {res.exchanges} "
        f"exchanges of {res.exchange_bytes / 1e9:.2f} GB; map "
        f"{seconds['map']:.1f}s, its three files as on one device, "
        f"{mres.exchanges} exchanges of {mres.exchange_bytes / 1e9:.2f} GB; "
        f"{MESH_SHARDS} logical shards on one card, {smi}")
    return (launches, *wave_executions(lcs, wave)), numbers


def load_test(name: str):
    """A file of tests/ loaded by path (no pytest run, no conftest.py,
    which imports jax): its fixtures and helpers."""
    path = os.path.join(REPO, "tests", name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_" + name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_e2e(cli, merge_path, lcs, wave, tourbus, smi: str, tmp: str):
    """Phase 9: the six fixtures of the JAX end-to-end suite (K = 21; the
    gap-fill one K = 23) through the CLI on the card: the suite's
    recovery checks, and every file equal to the port's CPU run's."""
    from soapdenovo_trans_tpu_torch.graph import unitigs

    e2e = load_test("test_torch_e2e.py")
    reset_counts(merge_path, lcs, wave, tourbus)
    t_phase = time.time()
    fixtures = {}
    pinches = []
    for name in e2e.FIXTURES:
        folder = os.path.join(tmp, name)
        os.makedirs(folder)
        fx = e2e.build(name, folder)
        outs, results, seconds = {}, {}, {}
        for d in DEVICES:
            os.environ["SOAPDENOVO_TORCH_DEVICE"] = d
            outs[d] = os.path.join(folder, d, "asm")
            torch.cuda.synchronize()
            results[d], scafs, seconds[d] = e2e.run(cli, fx, outs[d])
            torch.cuda.synchronize()
        fx.check(outs["cuda"], scafs)
        n_files = e2e.assert_same_outputs(outs["cpu"], outs["cuda"])
        pre = {d: results[d][0].pregraph for d in DEVICES}
        edges = [unitigs.edge_sequences(p.edges, p.table, fx.k)
                 for p in pre.values()]
        if edges[0] != edges[1]:
            raise AssertionError(f"{name}: the edges decode differently on "
                                 f"cuda and cpu")
        res = results["cuda"][0]
        pinches.append(res.contig.tourbus["waves"])
        fixtures[name] = {
            "k": fx.k, "seconds": sum(seconds["cuda"]),
            "stage_s": {**res.stage_seconds,
                        **{"scaff -S": s for s in seconds["cuda"][1:]}},
            "cpu_seconds": sum(seconds["cpu"]),
            "edges": pre["cuda"].edges.n_edges,
            "transcripts": sum(1 for h, _ in res.scaff.recs
                               if h.startswith("scaffold")),
            "records": len(res.scaff.recs),
            "n50": res.scaff.stats.get("N50", 0), "files_compared": n_files}
        log(f"[e2e] {name}: K={fx.k}, recovered on cuda in "
            f"{sum(seconds['cuda']):.2f}s; {n_files} files equal to the cpu "
            f"run's")
    check_wave_programs(tourbus, lcs, wave, pinches,
                        "the e2e fixtures on cuda")
    log(f"[e2e] identity, front and back kernel executions "
        f"{wave_executions(lcs, wave)} = Tour-Bus waves ({pinches} a "
        f"fixture; {tourbus.CAPTURES} captures, {tourbus.REPLAYS} "
        f"replays)")
    return {"card": smi, "phase_s": time.time() - t_phase,
            "fixtures": fixtures,
            **launch_numbers((merge_path.LAUNCHES,
                              *wave_executions(lcs, wave)))}


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
    from soapdenovo_trans_tpu_torch.graph import tourbus
    from soapdenovo_trans_tpu_torch.kernels import lcs, merge_path, wave
    from soapdenovo_trans_tpu_torch.stages import pregraph as pg_stage

    dev = torch.device("cuda")
    clock = [time.time()]
    script_s = {}

    def lap(name):
        clock.append(time.time())
        script_s[name] = clock[-1] - clock[-2]

    build_s = phase_build((merge_path, lcs, wave))
    lap("build")
    id_timing = phase_identity(lcs, dev)
    wave_timing = phase_wave(wave, dev)
    timing = phase_kernel(merge_path, dev)
    lap("kernel")
    card = smi.splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        parity = phase_cpu_gpu(cli, merge_path, lcs, wave, tourbus,
                               pg_stage, perf_e2e, tmp)
        lap("cpu_gpu")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=CONTIG_TX, n_pairs=CONTIG_PAIRS,
                             seed=0)
        lap("simulate")
        slice_launches = phase_slice(cli, merge_path, lcs, wave, tourbus,
                                     cfg, tmp)
        lap("pregraph")
        (launches, id_wave, wave_real), numbers, res, out = phase_all(
            cli, merge_path, lcs, wave, tourbus, card, tmp, cfg)
        lap("all")
        flag_launches, flag_numbers, map_out = phase_flags(
            cli, merge_path, lcs, wave, tourbus, perf_e2e, card, tmp, res,
            cfg, out)
        lap("options")
        mesh_launches, mesh_numbers = phase_mesh(
            cli, merge_path, lcs, wave, tourbus, card, tmp, res, cfg, out,
            map_out)
        lap("mesh")
        del res
    with tempfile.TemporaryDirectory() as tmp:
        e2e_numbers = phase_e2e(cli, merge_path, lcs, wave, tourbus, card,
                                tmp)
        lap("e2e")
    log("[script] seconds of each phase, simulation and checks included: "
        + json.dumps(script_s))
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "soapdenovo_trans_tpu",
                                            "pandas"))
    if foreign:
        raise AssertionError(f"the port loaded JAX modules or pandas: "
                             f"{foreign[:5]}")

    log("[all] " + json.dumps(numbers))
    log("[flags] " + json.dumps(flag_numbers))
    log("[mesh] " + json.dumps(mesh_numbers))
    log("[e2e] " + json.dumps(e2e_numbers))
    by_path = {"cpu_gpu_parity": parity, "pregraph_500k": slice_launches,
               "all_500k": launches, "options_500k_220k": flag_launches,
               "mesh_4_shards_500k": mesh_launches}
    e2e_launches = [e2e_numbers[f"{k}_launches"] for k in (
        "merge", *WAVE_ENTRIES)]
    log(json.dumps({"kernels": [{
        "name": "merge_path", "route": "cuda",
        "source": "soapdenovo_trans_tpu_torch/csrc/merge_path.cu",
        "replaces": "soapdenovo_trans_tpu/kernels/merge_path.py:284",
        "launches": launches[0],
        "launches_by_path": {path: n[0] for path, n in by_path.items()},
        "build_s": build_s["merge_path.cu"], **timing}, {
        "name": "identity", "route": "cuda",
        "source": "soapdenovo_trans_tpu_torch/csrc/lcs.cu",
        "entry": "identity_launch",
        "replaces": "soapdenovo_trans_tpu/graph/tourbus.py:116",
        "replaces_what": "the identity-check block of the jitted _wave: "
                         "_path_seq (:116-133) for each path, the length "
                         "gate (:221-225), the LCS scan (:77-96) and the "
                         "verdict (:230); XLA device code, not a Pallas "
                         "kernel",
        "launches": launches[1],
        "launches_by_path": {
            **{path: n[1] for path, n in by_path.items()},
            "e2e_fixtures": e2e_launches[1]},
        "max_abs_err": max(id_timing["max_abs_err"], id_wave["max_abs_err"]),
        "ms": id_wave["ms"], "plain_ms": id_wave["plain_ms"],
        "bound_ms": id_wave["bound_ms"], "bound_by": id_wave["bound_by"],
        "library_ms": None, "host_us": id_wave["host_us"],
        "build_s": build_s["lcs.cu"], "wave_inputs": id_wave,
        "synthetic": id_timing["synthetic"]}, *({
        "name": name, "route": "cuda",
        "source": "soapdenovo_trans_tpu_torch/csrc/wave.cu",
        "entry": f"{name}_launch", "replaces": replaces,
        "replaces_what": what, "kernels_an_execution": parts,
        "launches": launches[i],
        "launches_by_path": {
            **{path: n[i] for path, n in by_path.items()},
            "e2e_fixtures": e2e_launches[i]},
        "max_abs_err": max(wave_timing["max_abs_err"],
                           wave_real["max_abs_err"]),
        **{key: wave_real[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "host_us")},
        "library_ms": wave_real[name].get("library_ms"),
        "build_s": build_s["wave.cu"],
        "wave_inputs": {**{k: v for k, v in wave_real.items()
                           if not isinstance(v, dict)},
                        **wave_real[name]},
        "synthetic": {case: {**t[name], **{k: t[k] for k in (
            "c", "m", "e", "a", "ok_rows", "merged", "n_cand")}}
            for case, t in wave_timing["synthetic"].items()}}
        for name, replaces, what, parts, i in (
            ("front", "soapdenovo_trans_tpu/graph/tourbus.py:140",
             "steps 1-4 of the jitted _wave up to the identity check "
             "(:140-219): the live arcs, the majority forest (a three-key "
             "sort), the candidates and their order (a two-key sort, of "
             "which the wave reads cand_cap rows), the walks, the meeting "
             "point, the paths, their twins and the clash test; XLA device "
             "code, not a Pallas kernel; library_ms is torch.topk of the "
             "candidates' packed keys, the candidate order alone",
             "front_forest_kernel, front_cand_kernel, front_select_kernel "
             "(twice), front_count_kernel, front_scatter_kernel, "
             "front_sort_kernel and chains_kernel", 2),
            ("back", "soapdenovo_trans_tpu/graph/tourbus.py:221",
             "the rest of the jitted _wave from the verdicts on "
             "(:221-325): the counts, the claim arbitration, the positional "
             "cover, the deletes, the coverage adds, the remap and the arc "
             "rows' rewrite; and the pinch's failed update (:349-356); XLA "
             "device code, not a Pallas kernel",
             "back_head_kernel, then claim_kernel, apply_kernel and "
             "arcs_kernel, which return at once when no row is ok", 3)))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
