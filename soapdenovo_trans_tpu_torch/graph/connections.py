"""Contig-level connections (CONNECTs) from read placements.

Port of ``soapdenovo_trans_tpu/graph/connections.py``, the device-side
equivalents of the scaffold stage's link builders:

* pe_link_candidates — connectByPE_grad/attach1PE (reference
  src/attachPEinfo.c:269-423): mate pairs are consecutive read rows;
  gap = ins - K + pos1 + pos2 - len1 - len2, accepted in [-ins/10, ins];
  emits (e1 -> e2) plus the twin connection.
* se_link_candidates — singleRead2connection (src/transcriptome.c:256-310):
  consecutive distinct unique contigs hit by the same read, ordered by
  position in the read; gap = ctgOff2 - ctgOff1 - len1, negative
  rejected; emits connection + twin with an SE support count.
* aggregate — add1Connect's weight accumulation (connect.c) as a sort +
  boundary reduction; gap estimates are floor means (the JAX package's
  choice; the reference keeps the first-seen gap).

Sums run in int64 where the JAX package sums in int32; the results agree
while no int32 sum wraps.  Capacities are exact: a ConnSet holds ``n``
rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.index import gather_or

BIG = 2**30  # sorts after every real contig row


class ConnSet(NamedTuple):
    """COO connection table over directed contig rows."""

    from_ctg: torch.Tensor  # (N,) int64
    to_ctg: torch.Tensor    # (N,) int64
    gap: torch.Tensor       # (N,) int64 mean gap estimate (physical)
    weight: torch.Tensor    # (N,) int64 total supporting observations
    se_count: torch.Tensor  # (N,) int64 single-read supports
    n: int


def pe_link_candidates(ctg, pos, twin, ctg_len, insert_size: int, k: int):
    """(from, to, gap, valid) from consecutive-pair placements.
    ctg/pos: (R,) best placements (R even; pairs are (2i, 2i+1)).

    ctg_len holds FULL lengths (K + tail).  The reference's gap
    (attachPEinfo.c:303, K-exclusive lengths) equals physical_gap + K;
    the acceptance window [-ins/10, ins] applies to that convention, but
    the physical gap is stored."""
    e1, p1 = ctg[0::2], pos[0::2]
    bal_e2, p2 = ctg[1::2], pos[1::2]
    ok = (e1 >= 0) & (bal_e2 >= 0) & (e1 != bal_e2)
    e2 = gather_or(twin, bal_e2, -1)
    bal_e1 = gather_or(twin, e1, -1)
    ok &= (e2 >= 0) & (e1 != e2)  # same-contig pairs only re-estimate IS
    len1 = gather_or(ctg_len, e1, 0)
    len2 = gather_or(ctg_len, e2, 0)
    gap_ref = insert_size + k + p1 + p2 - len1 - len2
    ok &= (gap_ref >= -(insert_size // 10)) & (gap_ref <= insert_size)
    gap = gap_ref - k  # physical
    f = torch.cat([torch.where(ok, e1, -1), torch.where(ok, bal_e2, -1)])
    t = torch.cat([torch.where(ok, e2, -1), torch.where(ok, bal_e1, -1)])
    return f, t, torch.cat([gap, gap]), torch.cat([ok, ok])


def se_link_candidates(g_ctg, g_off, g_read_off, g_valid, r: int,
                       groups_per_read: int, k: int, twin=None,
                       ctg_len=None, unique=None):
    """(from, to, gap, valid) from per-read multi-contig hit groups.

    Group arrays are (R * P) flat, P = groups_per_read slots per read.
    ctg_len holds FULL lengths (K + tail).  The .ctg2Read "pos" column
    is readOffset - contigOffset (prlRead2Ctg.c:573), and
    singleRead2connection's gapLen = pos2 - pos1 - len1 uses K-exclusive
    lengths, i.e. physical_gap + K; the >= 0 acceptance follows that
    convention and the physical gap is stored.  A slot that is not valid
    carries an unspecified gap."""
    p = groups_per_read
    off = g_read_off.reshape(r, p)
    ctg = g_ctg.reshape(r, p)
    coff = g_off.reshape(r, p)
    valid = g_valid.reshape(r, p)
    if unique is not None:
        valid = valid & gather_or(unique, ctg.reshape(-1),
                                  False).reshape(r, p)
    # skip self-twin (palindromic) contigs, like isSameAsTwin
    valid = valid & (gather_or(twin, ctg.reshape(-1), -1).reshape(r, p)
                     != ctg)

    key = torch.where(valid, off, BIG)
    order = torch.sort(key, dim=1, stable=True).indices
    skey = key.gather(1, order)
    sctg = ctg.gather(1, order)
    srel = (off - coff).gather(1, order)  # readOffset - contigOffset
    v = skey < BIG
    c1, c2 = sctg[:, :-1], sctg[:, 1:]
    ok = v[:, :-1] & v[:, 1:] & (c1 != c2)
    c1s = c1.reshape(-1).clamp(min=0)
    len1 = gather_or(ctg_len, c1s, 0).reshape(r, p - 1)
    gap_ref = srel[:, 1:] - srel[:, :-1] - (len1 - k)
    ok &= gap_ref >= 0
    gap = (gap_ref - k).reshape(-1)
    tw1 = gather_or(twin, c1s, -1).reshape(r, p - 1)
    tw2 = gather_or(twin, c2.reshape(-1).clamp(min=0), -1).reshape(r, p - 1)
    f = torch.cat([torch.where(ok, c1, -1).reshape(-1),
                   torch.where(ok, tw2, -1).reshape(-1)])
    t = torch.cat([torch.where(ok, c2, -1).reshape(-1),
                   torch.where(ok, tw1, -1).reshape(-1)])
    return f, t, torch.cat([gap, gap]), torch.cat([ok.reshape(-1)] * 2)


def aggregate(f, t, g, is_se, valid) -> ConnSet:
    """Sum candidate links per (from, to): weight = candidates, se_count
    = single-read candidates, gap = floor mean of the gaps (JAX
    ``_aggregate_device``, connections.py:126-177).  Rows come out in
    (from, to) order.  One host sync (the connection count)."""
    fk = torch.where(valid, f.to(torch.int64), BIG)
    tk = torch.where(valid, t.to(torch.int64), BIG)
    # (from, to) is one folded int64 key; the sums are order-free, so
    # the sort need not be stable
    order = torch.sort(fk * (BIG + 1) + tk).indices
    sf, st = fk[order], tk[order]
    sg = torch.where(valid, g, 0)[order].to(torch.int64)
    sse = (valid & is_se)[order].to(torch.int64)
    real = sf < BIG
    first = torch.ones_like(real)
    first[1:] = (sf[1:] != sf[:-1]) | (st[1:] != st[:-1])
    heads = torch.nonzero(first & real)[:, 0]
    end = torch.cat([heads[1:], real.sum().reshape(1)])[:heads.shape[0]]
    weight = end - heads
    zero = sg.new_zeros(1)
    pg = torch.cat([zero, torch.cumsum(sg, 0)])
    pse = torch.cat([zero, torch.cumsum(sse, 0)])
    gmean = torch.div(pg[end] - pg[heads], weight, rounding_mode="floor")
    return ConnSet(sf[heads], st[heads], gmean, weight,
                   pse[end] - pse[heads], int(heads.shape[0]))


def same_contig_fragments(ctg, pos, twin, ctg_len):
    """Fragment sizes of pairs whose mates land on the same contig
    (reference attach1PE's e1 == e2 branch + calcuIS,
    attachPEinfo.c:283-300, 425): realpeSize = full_len - p1 - p2.
    Returns (sizes, valid) per pair."""
    e1, p1 = ctg[0::2], pos[0::2]
    bal_e2, p2 = ctg[1::2], pos[1::2]
    e2 = gather_or(twin, bal_e2, -1)
    ok = (e1 >= 0) & (bal_e2 >= 0) & (e1 == e2) & (e1 != bal_e2)
    size = gather_or(ctg_len, e1, 0) - p1 - p2
    ok &= size > 0
    return torch.where(ok, size, 0), ok


def estimate_insert_size(ctg, pos, twin, ctg_len, declared: int,
                         min_pairs: int = 100):
    """Mean observed fragment size on contigs longer than the declared
    insert; falls back to the declared avg_ins below min_pairs
    observations.  Returns (estimate, observations)."""
    size, ok = same_contig_fragments(ctg, pos, twin, ctg_len)
    ok = ok & (gather_or(ctg_len, ctg[0::2], 0) > declared)
    n, total = torch.stack([ok.sum(), torch.where(ok, size, 0).sum()]).tolist()
    if n < min_pairs:
        return declared, n
    return total // n, n
