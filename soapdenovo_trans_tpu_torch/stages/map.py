"""Stage 3 — map: place reads on contigs by k-mer voting.

Port of ``soapdenovo_trans_tpu/stages/map.py`` (reference call_align,
src/map.c:64):

* build_contig_index — prlContig2nodes (src/prlHashCtg.c:287-425): chop
  every twin-pair representative contig (>= K+2 bp) into canonical
  k-mers; each k-mer stores (contig, position, orientation); k-mers
  occurring more than once are ambiguous and dropped (prlHashCtg.c:116-144).
* map_reads — prlRead2Ctg (src/prlRead2Ctg.c:656-1086, parse1read
  :233-354): per read, look up all k-mers, vote by contig, require
  >= multi = max(5, min(len, map_len) - K + 1) agreeing k-mers; every
  qualifying (read, contig) group is kept for the .ctg2Read stream;
  reads qualifying on >= 2 contigs get the gap-spanning footprint flag.

The JAX package votes with one flat (read, contig, window) sort over
all R*P slots.  Each read's P slots are already contiguous in the
(R, P) layout, so the port sorts each row on one folded
(contig, window) key instead, which gives the same order; the best
group of a read is then the row maximum of a score that is unique among
qualifying groups (the JAX package's second, (read, -score) sort).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..graph import contig_merge
from ..ops import bits, dictionary, kmer

BIG = 2**30  # contig key of a window without a hit
INDEX_WINDOWS = 1 << 24  # contig windows chopped at a time


class ContigIndex(NamedTuple):
    """Sorted canonical k-mer -> unique (contig, pos, orient).  Rows
    [0, n) are real; an empty index holds one sentinel row."""

    keys: torch.Tensor     # (max(n, 1), W) int64 lanes ascending
    ctg: torch.Tensor      # (max(n, 1),) int64 contig row (twin-pair rep)
    pos: torch.Tensor      # (max(n, 1),) int64 kmer start within contig seq
    is_rc: torch.Tensor    # (max(n, 1),) bool — canonical kmer is revcomp
                           # of the contig-oriented window
    n: int
    ctg_len: torch.Tensor  # (C,) int64 full contig lengths (K + tail)
    twin: torch.Tensor     # (C,) int64


class ReadPlacements(NamedTuple):
    """Per read: best contig placement (reference .readOnContig) and the
    >= multi hit groups (reference .ctg2Read), flat over R*P slots in
    (read, contig, window) order; only ``g_valid`` slots are groups."""

    ctg: torch.Tensor        # (R,) int64 contig row or -1
    pos: torch.Tensor        # (R,) int64 read start on contig (0-based,
                             # may be negative)
    reverse: torch.Tensor    # (R,) bool mapped to twin strand
    footprint: torch.Tensor  # (R,) bool qualified on >= 2 contigs
    g_read: torch.Tensor     # (R*P,) int64
    g_ctg: torch.Tensor      # (R*P,) int64 (orientation-resolved)
    g_ctg_off: torch.Tensor  # (R*P,) int64 contig offset of first kmer hit
    g_read_off: torch.Tensor  # (R*P,) int64 1-based read offset of that kmer
    g_align: torch.Tensor    # (R*P,) int64 number of agreeing kmers
    g_valid: torch.Tensor    # (R*P,) bool
    # raw (index-stored, twin-pair representative) coordinates
    # (prlRead2Ctg.c:530-614):
    g_raw_ctg: torch.Tensor  # (R*P,) int64 rep contig row (BIG: no hit)
    g_raw_off: torch.Tensor  # (R*P,) int64 kmer offset in rep orientation
    g_same: torch.Tensor     # (R*P,) bool '+' (True) / '-' (False)


def contig_code_matrix(ctg: contig_merge.Contigs, table, k: int):
    """(C, Lmax) uint8 base-code matrix of the twin-pair representative
    contigs of >= K+2 bp, their lengths and rows (host side)."""
    n = ctg.n
    twin = ctg.twin[:n].cpu().numpy()
    lengths = ctg.length[:n].cpu().numpy() + k
    rep = np.flatnonzero((np.arange(n) <= twin) & (lengths >= k + 2))
    if not rep.size:
        return np.zeros((0, k + 2), np.uint8), np.zeros(0, np.int64), []
    seqs = contig_merge.contig_sequences(ctg, table, k)
    codes = np.full((rep.size, int(lengths[rep].max())), 4, np.uint8)
    for i, c in enumerate(rep.tolist()):
        codes[i, :lengths[c]] = bits.encode_seq(seqs[c])
    return codes, lengths[rep].astype(np.int64), rep.tolist()


def _index_rows(codes, lens, k: int, rep_ids):
    """Valid (key, contig, pos, is_rc) windows of a contig code batch."""
    s = kmer.chop_reads(codes, lens, k)
    v = s.valid
    return s.kmers[v], rep_ids[s.read_id[v]], s.pos[v], s.is_rc[v]


def build_contig_index(ctg: contig_merge.Contigs, table, k: int
                       ) -> ContigIndex:
    """The contig k-mer index on the contigs' device (JAX
    ``_index_device``).  Contigs are chopped in length-sorted chunks of
    about INDEX_WINDOWS windows; the chunk order does not matter, since
    the index keeps only k-mers that occur exactly once."""
    dev = ctg.length.device
    codes, lens, rep = contig_code_matrix(ctg, table, k)
    w = bits.words_for_k(k)
    parts: List[tuple] = []
    by_len = np.argsort(lens, kind="stable")
    lo = 0
    while lo < by_len.size:
        hi = lo + 1
        while hi < by_len.size and \
                (hi + 1 - lo) * int(lens[by_len[hi]]) <= INDEX_WINDOWS:
            hi += 1
        rows = by_len[lo:hi]
        width = int(lens[rows[-1]])
        parts.append(_index_rows(
            torch.from_numpy(codes[rows, :width]).to(dev),
            torch.from_numpy(lens[rows]).to(dev), k,
            torch.as_tensor(np.asarray(rep, np.int64)[rows], device=dev)))
        lo = hi
    n = 0
    if sum(x[0].shape[0] for x in parts):
        keys, c, p, rz = dictionary.sort_rows(
            *(torch.cat(x) for x in zip(*parts)))
        diff = (keys[1:] != keys[:-1]).any(-1)
        one = torch.ones(1, dtype=torch.bool, device=dev)
        unique = torch.cat([one, diff]) & torch.cat([diff, one])
        keys, c, p, rz = keys[unique], c[unique], p[unique], rz[unique]
        n = keys.shape[0]
    if n == 0:  # one sentinel row keeps lookup's gathers in range
        keys = torch.full((1, w), dictionary.SENTINEL, dtype=torch.int64,
                          device=dev)
        c = p = torch.full((1,), -1, dtype=torch.int64, device=dev)
        rz = torch.zeros(1, dtype=torch.bool, device=dev)
    return ContigIndex(keys, c, p, rz, n, ctg.length + k, ctg.twin)


def map_reads(seqs, lengths, index: ContigIndex, k: int,
              map_len: int = 32) -> ReadPlacements:
    """Vectorized parse1read voting over a padded read batch."""
    r, l = seqs.shape
    p = l - k + 1
    stream = kmer.chop_reads(seqs, lengths, k)
    row = dictionary.lookup(index.keys, stream.kmers)
    hit = (row >= 0) & stream.valid
    g = row.clamp(min=0)
    ctg_of = torch.where(hit, index.ctg[g], -1).reshape(r, p)
    kpos = torch.where(hit, index.pos[g], 0).reshape(r, p)
    stored_rc = (hit & index.is_rc[g]).reshape(r, p)
    win_rc = stream.is_rc.reshape(r, p)
    return vote(ctg_of, kpos, stored_rc, win_rc, lengths,
                index.ctg_len, index.twin, k, map_len)


def vote(ctg_of, kpos, stored_rc, win_rc, lengths, ctg_len_all,
         twin_all, k: int, map_len: int) -> ReadPlacements:
    """parse1read's per-read voting given resolved k-mer hits, on
    (R, P) matrices of the hits of each read window."""
    r, p = ctg_of.shape
    dev = ctg_of.device
    # one folded key per slot: (contig or BIG, window), unique in a row
    if (BIG + 1) * p >= 2**63:
        raise ValueError(f"{p} windows a read overflow the vote sort key")
    col = torch.arange(p, device=dev).expand(r, p)
    ctgm = torch.where(ctg_of >= 0, ctg_of.to(torch.int64), BIG)
    swidx = torch.sort(ctgm * p + col, dim=1).indices
    sctg = ctgm.gather(1, swidx)
    skpos = kpos.to(torch.int64).gather(1, swidx)
    same = stored_rc.gather(1, swidx) == win_rc.gather(1, swidx)
    valid = sctg < BIG
    head = torch.ones_like(valid)
    head[:, 1:] = sctg[:, 1:] != sctg[:, :-1]
    # votes per group = run length = next head's column - head's column
    # (the JAX package's reverse associative min-scan)
    nxt = torch.where(head, col, p).flip(1).cummin(1).values.flip(1)
    nxt = torch.cat([nxt[:, 1:], torch.full((r, 1), p, device=dev)], 1)
    votes = torch.where(head, nxt - col, 0)

    # threshold (reference: multi = max(5, min(len, map_len) - K + 1))
    eff = torch.clamp(lengths.to(torch.int64), max=map_len)
    multi = torch.clamp(eff - k + 1, min=5)[:, None]
    qual = head & valid & (votes >= multi)

    # orientation resolution at each group head (parse1read:311-327);
    # swidx at a head is the group's first-in-read window
    cg = sctg.clamp(0, ctg_len_all.shape[0] - 1)
    ctg_len_g = ctg_len_all[cg]
    i1 = swidx + 1  # 1-based kmer offset in read
    o_ctg = torch.where(same, sctg, twin_all[cg])
    o_pos = torch.where(same, skpos - i1 + 1, ctg_len_g - skpos - k - i1 + 1)
    o_off = torch.where(same, skpos, ctg_len_g - skpos - k)

    # best group per read: max votes among qualifying; ties go to the
    # group first encountered in the read (parse1read keeps the earliest
    # winner, prlRead2Ctg.c:285-290).  The score is unique among a read's
    # qualifying groups and positive, so the row maximum decides.
    p2 = 1 << int(p).bit_length()
    score = torch.where(qual, votes * (2 * p2) + (p2 - 1 - swidx), -1)
    best, at = score.max(1, keepdim=True)
    has = best[:, 0] > 0
    ctg_best = torch.where(has, o_ctg.gather(1, at)[:, 0], -1)
    pos_best = torch.where(has, o_pos.gather(1, at)[:, 0], 0)
    rev_best = has & ~same.gather(1, at)[:, 0]

    # footprint: >= 2 contigs hit by >= 2 kmers each (counter2,
    # prlRead2Ctg.c:277-300) — gap-spanning candidates
    footprint = (head & valid & (votes >= 2)).sum(1) >= 2

    srid = torch.arange(r, device=dev).repeat_interleave(p)
    return ReadPlacements(
        ctg_best, pos_best, rev_best, footprint, srid,
        o_ctg.reshape(-1), o_off.reshape(-1), i1.reshape(-1),
        votes.reshape(-1), qual.reshape(-1), sctg.reshape(-1),
        skpos.reshape(-1), same.reshape(-1))
