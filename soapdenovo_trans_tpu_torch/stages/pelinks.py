"""Scaffold-side link building from the map stage's FILES.

A host copy of ``soapdenovo_trans_tpu/stages/pelinks.py``: that module
is numpy host code, but it belongs to the JAX package, which the port
may not import (the machine that runs the port on the GPU has no jax).
Two changes: the placement tables are parsed by numpy alone (the JAX
package parses them with pandas when it can import it; the GPU machine
has no pandas); and ``build_connections`` takes the port's contigs and
aggregates the candidate links with the port's
``connections.aggregate`` on the contigs' device.

The reference scaffold stage is resumable from map outputs alone:
loadPEgrads reads `.peGrads` (src/attachPEinfo.c:63-168), PE2Links
re-scans `.readOnContig` once per insert-size grad pairing
consecutive read numbers (orderContig.c:3989-4056 ->
connectByPE_grad/attach1PE, attachPEinfo.c:269-423), writes `.links`,
and Links2Scaf folds the links back into CONNECTs computing the
per-rank weakPE cutoff (orderContig.c:4183-4306); transcriptome's
singleRead2connection adds single-read links from `.ctg2Read`
(transcriptome.c:256-310).

This module is that file contract, vectorized: the whole
`.readOnContig` is parsed into arrays once, each grad is a mask, and
candidate links go through graph/connections.aggregate.  Notes on
fidelity:

* weakPE (3; 5 for insert>1000; max'd with the mean pair_num_cut of
  the rank's libs) is computed and reported exactly like
  Links2Scaf (orderContig.c:4251-4285) — and, exactly like the
  TRANS flow of the reference, NOT applied as a filter: the
  transcript pipeline's only weak-link cutoff is deleteWeakCnt(3)
  (transcriptome.c:2236); the enforcement sites for weakPE live in
  the classic genome scaffolder that scaffold.c bypasses.
* the insert-size estimate from same-contig pairs (calcuIS,
  attachPEinfo.c:425-461) is computed per grad over ALL its pairs
  (the reference's exact behavior) and reported; gap arithmetic uses
  the grad's configured insert size, as attach1PE does.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np


class PEGrad(NamedTuple):
    insert_s: int
    bound: int        # cumulative read-number boundary (1-based ids)
    rank: int
    pair_num_cut: int


def assign_ranks(grads: List[PEGrad]) -> List[PEGrad]:
    """Reference rank auto-assignment when the file carries none
    (attachPEinfo.c:105-168): insert-size bands 300/800/3000/7000."""
    out: List[PEGrad] = []
    last_rank = 0
    bands = [300, 800, 3000, 7000]

    def band(ins):
        for bi, b in enumerate(bands):
            if ins < b:
                return bi
        return len(bands)

    for i, g in enumerate(grads):
        if i == 0:
            last_rank += 1
        elif band(g.insert_s) != band(grads[i - 1].insert_s):
            last_rank += 1
        out.append(g._replace(rank=last_rank))
    return out


def load_pe_grads(prefix: str):
    """Parse `.peGrads` (loadPEgrads, attachPEinfo.c:63-103).
    Returns (grads, n_reads, max_read_len) or ([], 0, 0) if absent."""
    path = prefix + ".peGrads"
    if not os.path.exists(path):
        return [], 0, 0
    grads: List[PEGrad] = []
    n_reads = 0
    max_len = 0
    with open(path) as fh:
        header_seen = False
        for line in fh:
            if not header_seen:
                if line.startswith("grads&num:"):
                    parts = line.split(":", 1)[1].split()
                    n_reads = int(parts[1])
                    max_len = int(parts[2]) if len(parts) > 2 else 0
                    header_seen = True
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            ins, bound = int(parts[0]), int(parts[1])
            rank = int(parts[2]) if len(parts) > 2 else 0
            cut = int(parts[3]) if len(parts) > 3 else 3
            grads.append(PEGrad(ins, bound, rank, cut))
    if grads and any(g.rank < 1 for g in grads):
        grads = assign_ranks(grads)
    grads.sort(key=lambda g: g.insert_s)
    return grads, n_reads, max_len


def _load_rows(path: str):
    """Parse a read-placement table ('read contig pos [orien]' rows
    after one header line) into three int64 arrays.  numpy's loadtxt is
    a C parser since numpy 1.23 (0.27 s for 1.2M rows on one CPU core)."""
    if not os.path.exists(path):
        return (np.zeros(0, np.int64),) * 3
    with open(path) as fh:
        if not (fh.readline() and fh.readline()):  # header only
            return (np.zeros(0, np.int64),) * 3
    rows = np.loadtxt(path, skiprows=1, usecols=(0, 1, 2), dtype=np.int64,
                      ndmin=2)
    return rows[:, 0], rows[:, 1], rows[:, 2]


def _calcu_is(sizes: np.ndarray) -> Tuple[int, int]:
    """calcuIS (attachPEinfo.c:425-461): mean, then mean over the
    samples within 1.5 SD of it."""
    if sizes.size == 0:
        return 0, 0
    avg = int(sizes.sum() // sizes.size)
    sd = int(np.sqrt(np.maximum(
        ((sizes - avg) ** 2).sum() // max(sizes.size - 1, 1), 0)))
    if sd == 0:
        return avg, sd
    keep = sizes[np.abs(sizes - avg) <= 1.5 * sd]
    if keep.size == 0:
        return avg, sd
    return int(keep.sum() // keep.size), sd


def build_pe_candidates(prefix: str, length_ex: np.ndarray,
                        twin: np.ndarray, k: int,
                        grads: List[PEGrad]):
    """PE2Links over `.readOnContig`: per-grad consecutive-readno
    pairing -> symmetric link candidates + per-grad .links rows.

    Returns (f, t, gap_phys, valid, links_by_grad, report_lines,
    read_ctg, read_pos) with contig ids as 0-based rows; read_ctg and
    read_pos are each read's placement (int32, -1 / 0 when unplaced;
    None when no read is placed), for gap filling and the read tables."""
    readno, ctg1, pos = _load_rows(prefix + ".readOnContig")
    n_ctg = length_ex.shape[0]
    ctg0 = (ctg1 - 1).astype(np.int64)
    ok_row = (ctg0 >= 0) & (ctg0 < n_ctg)
    # palindrome rows are invisible (continue before pre_* update,
    # attachPEinfo.c:387-390)
    ok_row &= twin[np.clip(ctg0, 0, n_ctg - 1)] != ctg0
    readno, ctg0, pos = readno[ok_row], ctg0[ok_row], pos[ok_row]

    read_ctg = read_pos = None
    if readno.size:
        n_reads = int(readno.max())
        read_ctg = np.full(n_reads, -1, np.int32)
        read_pos = np.zeros(n_reads, np.int32)
        read_ctg[readno - 1] = ctg0
        read_pos[readno - 1] = pos

    f_all, t_all, g_all = [], [], []
    links_by_grad = []
    report = []
    if readno.size >= 2 and grads:
        is_pair = (readno[1:] % 2 == 0) & (readno[1:] == readno[:-1] + 1)
        pi = np.nonzero(is_pair)[0]  # index of the first (odd) row
        e1 = ctg0[pi]
        p1 = pos[pi]
        bal_e2 = ctg0[pi + 1]
        p2 = pos[pi + 1]
        even_no = readno[pi + 1]
        bounds = np.asarray([g.bound for g in grads], np.int64)
        grad_of = np.searchsorted(bounds, even_no, side="left")
        grad_of = np.clip(grad_of, 0, len(grads) - 1)
        ins_of = np.asarray([g.insert_s for g in grads], np.int64)[grad_of]

        ok = e1 != bal_e2                      # orientation guard
        e2 = twin[bal_e2]
        bal_e1 = twin[e1]
        same_ctg = ok & (e1 == e2)
        link = ok & (e1 != e2)
        len1 = length_ex[e1]
        len2 = length_ex[np.clip(e2, 0, n_ctg - 1)]
        gap_ref = ins_of - k + p1 + p2 - len1 - len2
        link &= (gap_ref >= -(ins_of // 10)) & (gap_ref <= ins_of)

        for gi, g in enumerate(grads):
            sel = link & (grad_of == gi)
            # same-contig insert estimate (attach1PE's isStack:
            # contigs longer than the insert size only)
            sc = same_ctg & (grad_of == gi)
            real = len1[sc] + k - p1[sc] - p2[sc]
            real = real[(real > 0) & (len1[sc] > g.insert_s)]
            est, sd = _calcu_is(real.astype(np.int64))
            report.append(
                f"grad {gi} (ins {g.insert_s}): {int(sel.sum())} pairs "
                f"linked, {int(sc.sum())} on one contig, insert size "
                f"estimated {est} (sd {sd}, {real.size} pairs)")
            # aggregated .links rows for this grad (outputLinks,
            # orderContig.c:3954-3986: one direction per twin family)
            if sel.any():
                lf = np.concatenate([e1[sel], bal_e2[sel]])
                lt = np.concatenate([e2[sel], bal_e1[sel]])
                lg = np.concatenate([gap_ref[sel], gap_ref[sel]])
                keep = lf <= twin[np.clip(lt, 0, n_ctg - 1)]
                order = np.lexsort((lt[keep], lf[keep]))
                lf2, lt2, lg2 = (lf[keep][order], lt[keep][order],
                                 lg[keep][order])
                head = np.concatenate(
                    [[True], (lf2[1:] != lf2[:-1]) | (lt2[1:] != lt2[:-1])])
                seg = np.cumsum(head) - 1
                wt = np.bincount(seg)
                gap0 = lg2[head]  # first-seen gap, like add1Connect
                links_by_grad.append(
                    (g.insert_s,
                     np.stack([lf2[head], lt2[head], gap0, wt], axis=1)))
            else:
                links_by_grad.append(
                    (g.insert_s, np.zeros((0, 4), np.int64)))
            f_all.append(np.concatenate([e1[sel], bal_e2[sel]]))
            t_all.append(np.concatenate([e2[sel], bal_e1[sel]]))
            g_all.append(np.concatenate(
                [gap_ref[sel] - k, gap_ref[sel] - k]))  # store physical

    if f_all:
        f = np.concatenate(f_all).astype(np.int32)
        t = np.concatenate(t_all).astype(np.int32)
        g = np.concatenate(g_all).astype(np.int32)
    else:
        f = np.full(1, -1, np.int32)
        t = np.full(1, -1, np.int32)
        g = np.zeros(1, np.int32)
    v = f >= 0
    return f, t, g, v, links_by_grad, report, read_ctg, read_pos


def build_se_candidates(prefix: str, length_ex: np.ndarray,
                        twin: np.ndarray, k: int,
                        unique: np.ndarray):
    """singleRead2connection over `.ctg2Read`
    (transcriptome.c:256-310): consecutive rows of the same read on
    different unique contigs; gap = pos2 - pos1 - len1 (K-exclusive),
    negative rejected."""
    readno, ctg1, pos = _load_rows(prefix + ".ctg2Read")
    n_ctg = length_ex.shape[0]
    ctg0 = (ctg1 - 1).astype(np.int64)
    ok_row = (ctg0 >= 0) & (ctg0 < n_ctg)
    c = np.clip(ctg0, 0, n_ctg - 1)
    ok_row &= unique[c] & (twin[c] != ctg0)
    readno, ctg0, pos = readno[ok_row], ctg0[ok_row], pos[ok_row]
    if readno.size < 2:
        z = np.full(1, -1, np.int32)
        return z, z.copy(), np.zeros(1, np.int32), z < 0
    pair = (readno[1:] == readno[:-1]) & (ctg0[1:] != ctg0[:-1])
    pi = np.nonzero(pair)[0]
    c1, c2 = ctg0[pi], ctg0[pi + 1]
    gap_ref = pos[pi + 1] - pos[pi] - length_ex[c1]
    keep = gap_ref >= 0
    c1, c2, gap_ref = c1[keep], c2[keep], gap_ref[keep]
    f = np.concatenate([c1, twin[c2]]).astype(np.int32)
    t = np.concatenate([c2, twin[c1]]).astype(np.int32)
    g = np.concatenate([gap_ref - k, gap_ref - k]).astype(np.int32)
    return f, t, g, f >= 0


def write_links(prefix: str, links_by_grad) -> None:
    """`.links` in the reference format: '%-10d %-10d\\tgap\\twt\\tins'
    per aggregated connection, grads in ascending insert order
    (outputLinks, orderContig.c:3954-3986), 1-based contig ids."""
    with open(prefix + ".links", "w") as fh:
        for ins, rows in links_by_grad:
            for fr, to, gap, wt in rows:
                fh.write(f"{fr + 1:<10d} {to + 1:<10d}\t{int(gap)}\t"
                         f"{int(wt)}\t{ins}\n")


def weak_pe_report(grads: List[PEGrad], links_by_grad) -> List[str]:
    """Per-rank weakPE cutoffs (Links2Scaf, orderContig.c:4251-4285).
    Computed and REPORTED like the reference; the transcript flow's
    only enforced cutoff is deleteWeakCnt(3) (transcriptome.c:2236)."""
    out = []
    weak_pe = 3
    lib_n = 0
    cutoff_sum = 0
    for i, g in enumerate(grads):
        has_links = i < len(links_by_grad) and len(links_by_grad[i][1]) > 0
        if has_links:
            lib_n += 1
            cutoff_sum += g.pair_num_cut
        if i == len(grads) - 1 or grads[i + 1].rank != g.rank:
            if g.insert_s > 1000:
                weak_pe = 5
            if lib_n > 0:
                weak_pe = max(weak_pe, cutoff_sum // lib_n)
                lib_n = cutoff_sum = 0
            out.append(f"rank {g.rank}: pair-number cutoff for a "
                       f"reliable connection: {weak_pe}")
    return out


def build_connections(prefix: str, ctg, k: int, min_unique_len: int):
    """Full scaff-side link rebuild from files.  Returns (ConnSet on the
    contigs' device, extras): extras carries the read placements for gap
    filling and the read tables (read_ctg / read_pos 0-based-row arrays,
    read_ins the insert size of each read's library), n_reads and
    ins_size_var."""
    import torch

    from ..graph import connections

    length_ex = ctg.length.cpu().numpy().astype(np.int64)
    twin = ctg.twin.cpu().numpy().astype(np.int64)
    n_rows = length_ex.shape[0]
    full_len = length_ex + k
    unique = (np.arange(n_rows) < ctg.n) & (full_len >= min_unique_len)

    grads, n_reads, _ = load_pe_grads(prefix)
    pf, pt, pg, pv, links_by_grad, report, read_ctg, read_pos = \
        build_pe_candidates(prefix, length_ex, twin, k, grads)
    for line in report:
        print(f"[scaff] {line}")
    write_links(prefix, links_by_grad)
    for line in weak_pe_report(grads, links_by_grad):
        print(f"[scaff] {line}")
    sf, st, sg, sv = build_se_candidates(
        prefix, length_ex, twin, k, unique)

    def dev(parts):
        return torch.from_numpy(np.concatenate(parts)).to(ctg.length.device)

    conn = connections.aggregate(
        dev([pf, sf]), dev([pt, st]), dev([pg, sg]),
        dev([np.zeros(pf.shape[0], bool), np.ones(sf.shape[0], bool)]),
        dev([pv, sv]))
    read_ins = None
    if read_ctg is not None and grads:
        bounds = np.asarray([g_.bound for g_ in grads], np.int64)
        ins_arr = np.asarray([g_.insert_s for g_ in grads], np.int64)
        rn = np.arange(1, read_ctg.shape[0] + 1, dtype=np.int64)
        gi = np.clip(np.searchsorted(bounds, rn, side="left"),
                     0, len(grads) - 1)
        read_ins = ins_arr[gi].astype(np.int32)
    # ins_size_var as Links2Scaf sets it per grad in ascending insert
    # order (orderContig.c:4255-4269) — the largest grad's value is
    # what linearization sees
    ins_size_var = 20
    for g_ in grads:
        if g_.insert_s >= 1000:
            ins_size_var = 50
        elif g_.insert_s >= 300:
            ins_size_var = 30
        else:
            ins_size_var = 20
    return conn, {"read_ctg": read_ctg, "read_pos": read_pos,
                  "read_ins": read_ins, "n_reads": n_reads,
                  "ins_size_var": ins_size_var}
