"""Batched local gap assembly (-F).

Port of ``soapdenovo_trans_tpu/graph/gapfill.py`` (reference
src/localAsm.c: readsInGap2DBgraph :321, searchFgap :739,
traceAlongDBgraph :564, driven by prlReadFillGap.c check1scaf :707 and
fill1scaf :739; single-read fallback readsCrossGap :2035).  All gaps are
assembled at once:

* the reads of every gap and its two flanking contig ends are chopped
  into k-mers, each tagged with its gap id;
* one sort of (gap id, k-mer) builds every per-gap k-mer table (the gap
  id is the leading key lane, so each gap's rows are contiguous and one
  search answers per-gap lookups);
* every table row is two directed nodes (canonical row x orientation);
  one batched lookup resolves all successors, so no edge crosses gaps;
* two breadth-first searches (from each gap's start k-mer, and from the
  twin of its target) give the start->target distance and every node's
  distance to the target; a gap is accepted when the distance lands in
  the gap window, and its sequence is traced by descending distance to
  the target (coverage breaks ties, the lower base code after that);
* negative and zero gaps are first tried on the host by direct overlap
  of the flanks (reference contigCatch, prlReadFillGap.c:1008).

Differences from the JAX package, none of which changes a result: table
sizes are exact (no power-of-two padding); successors resolve in chunks
of rows, which bounds memory at full width; the searches keep a frontier
instead of scanning every node each step, and both loops stop once no
gap is active, which costs one host read a step.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import bits, dictionary, kmer
from ..utils import profiling

MAX_MISMATCH_PCT = 10  # overlap-merge tolerance (contigCatch allows ~10%)
CHOP_ROWS = 1 << 16    # read rows chopped into k-mers at a time
GRAPH_ROWS = 1 << 20   # table rows whose successors resolve at a time
TRACE_CHECK = 16       # trace steps between host reads of "all done"


class LocalTables(NamedTuple):
    """All per-gap k-mer tables in one sorted array.

    keys: (n, 1+W) int64 lanes — [gap id, k-mer...] ascending, distinct;
    count: (n,) int32 occurrences.  A table with no k-mer holds one
    all-ones sentinel row of count 0."""

    keys: torch.Tensor
    count: torch.Tensor


def build_local_tables(gap_id: torch.Tensor, kmers: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> LocalTables:
    """Sort the valid (gap id, k-mer) pairs (all of them when ``valid``
    is None), dedup, count."""
    keys = torch.cat([gap_id.to(torch.int64)[:, None], kmers], -1)
    if valid is not None:
        keys = keys[valid]
    if keys.shape[0] == 0:
        return LocalTables(
            keys.new_full((1, keys.shape[1]), dictionary.SENTINEL),
            torch.zeros(1, dtype=torch.int32, device=keys.device))
    keys = keys[bits.lex_order(keys)]
    head = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    head[1:] = (keys[1:] != keys[:-1]).any(-1)
    start = torch.nonzero(head)[:, 0]
    count = torch.diff(start, append=start.new_tensor([keys.shape[0]]))
    return LocalTables(keys[head], count.to(torch.int32))


def _lookup_rows(tables: LocalTables, queries: torch.Tensor) -> torch.Tensor:
    """(M, 1+W) queries -> (M,) table row or -1."""
    return dictionary.lookup(tables.keys, queries)


def _local_graph(tables: LocalTables, k: int):
    """Directed successor grid over the batched tables: table row r gives
    the directed nodes 2r (canonical) and 2r+1 (reverse complement).
    Returns (succ (2n, 4) int64 directed node or -1, ncount (2n, 4)
    int32 occurrence count of the successor's row).  Lookups are scoped
    by the gap id, the leading key lane."""
    n = tables.keys.shape[0]
    dev = tables.keys.device
    base4 = torch.arange(4, device=dev)
    succ, ncount = [], []
    for lo in range(0, n, GRAPH_ROWS):
        rows = tables.keys[lo:lo + GRAPH_ROWS]
        c, w = rows.shape[0], rows.shape[1] - 1
        km = rows[:, 1:]
        oriented = torch.stack([km, bits.reverse_complement(km, k)],
                               1).reshape(2 * c, w)
        ext = bits.next_kmer(oriented[:, None, :].expand(2 * c, 4, w),
                             base4, k)
        can, use_rc = bits.canonical(ext.reshape(-1, w), k)
        hit = _lookup_rows(tables, torch.cat(
            [rows[:, :1].repeat_interleave(8, 0), can], -1))
        succ.append(torch.where(hit >= 0, 2 * hit + use_rc.to(torch.int64),
                                -1).view(2 * c, 4))
        ncount.append(torch.where(hit >= 0, tables.count[hit.clamp(min=0)],
                                  0).view(2 * c, 4))
    return torch.cat(succ), torch.cat(ncount)


def _bfs(succ: torch.Tensor, start_nodes: torch.Tensor,
         max_steps: int) -> torch.Tensor:
    """Lock-step breadth-first search over the directed grid: (2n,)
    int64 distance from the start nodes (-1: inactive gap), -1 where
    unreachable within ``max_steps``.  All gaps advance together."""
    dist = torch.full((succ.shape[0],), -1, dtype=torch.int64,
                      device=succ.device)
    front = torch.unique(start_nodes[start_nodes >= 0])
    dist[front] = 0
    for t in range(max_steps):
        if front.numel() == 0:   # host read: the frontier's size
            break
        nxt = succ[front].reshape(-1)
        nxt = nxt[nxt >= 0]
        front = torch.unique(nxt[dist[nxt] < 0])
        dist[front] = t + 1
    return dist


def _trace(succ, ncount, dist_to_target, start_nodes, target_nodes,
           max_steps: int):
    """Per gap, walk from the start node along strictly decreasing
    distance to the target (coverage breaks ties; among equal coverage
    the lowest base: ``argmax`` returns the first maximum).  Returns
    (bases (max_steps, G) uint8, 255 where nothing was emitted;
    ok (G,) bool)."""
    n = succ.shape[0]
    g = start_nodes.shape[0]
    bases = torch.full((max_steps, g), 255, dtype=torch.uint8,
                       device=succ.device)
    cur = start_nodes
    done = start_nodes == target_nodes
    for step in range(max_steps):
        if step % TRACE_CHECK == 0 and bool(done.all()):
            break
        at = cur.clamp(0, n - 1)
        d = torch.where(cur >= 0, dist_to_target[at], -1)
        vs = succ[at]                                  # (G, 4)
        dv = torch.where(vs >= 0, dist_to_target[vs.clamp(min=0)], -1)
        ok_b = (dv == d[:, None] - 1) & (dv >= 0)
        score = torch.where(ok_b, ncount[at], -1)
        best = torch.argmax(score, -1)
        stop = done | (score.max(-1).values <= -1)
        bases[step] = torch.where(stop, 255, best).to(torch.uint8)
        cur = torch.where(stop, cur, vs.gather(1, best[:, None])[:, 0])
        done = stop | (cur == target_nodes)
    return bases, cur == target_nodes


def try_overlap_merge(left: str, right: str, gap: int,
                      max_overlap: int = 200) -> Optional[int]:
    """Negative/zero gap: find an overlap ov such that the last ov bases
    of ``left`` match the first ov bases of ``right`` within 10%
    mismatches (reference contigCatch, prlReadFillGap.c:1008), trying
    the overlaps nearest the estimate first.  Returns ov or None."""
    want = -gap if gap < 0 else 0
    cands = sorted(range(1, min(max_overlap, len(left), len(right)) + 1),
                   key=lambda ov: abs(ov - want))
    for ov in cands:
        mism = sum(1 for x, y in zip(left[-ov:], right[:ov]) if x != y)
        if mism * 100 <= ov * MAX_MISMATCH_PCT:
            return ov
    return None


class GapFillResult(NamedTuple):
    filled: np.ndarray     # (G,) bool
    fill_seq: List[str]    # per gap: inserted sequence ('' when
    #                        overlap-merged); meaningful iff filled
    overlap: np.ndarray    # (G,) int32 bases of the right contig's start
    #                        already covered (for splicing)
    # seconds of each part: overlap, tables, graph, bfs, trace, fallback
    phase_seconds: Optional[dict] = None


def _chop_tagged(codes: np.ndarray, lens: np.ndarray, gid: np.ndarray,
                 k: int, device):
    """(gap id, k-mer) of every valid window of the rows, chopped in
    chunks of CHOP_ROWS rows."""
    p = codes.shape[1] - k + 1
    gids, kmers = [], []
    for lo in range(0, codes.shape[0], CHOP_ROWS):
        hi = lo + CHOP_ROWS
        stream = kmer.chop_reads(
            torch.from_numpy(codes[lo:hi]).to(device),
            torch.from_numpy(lens[lo:hi]).to(device), k)
        tag = torch.from_numpy(gid[lo:hi]).to(device).repeat_interleave(p)
        gids.append(tag[stream.valid])
        kmers.append(stream.kmers[stream.valid])
    return torch.cat(gids), torch.cat(kmers)


def fill_gaps(junctions: List[Tuple[str, str, int]],
              gap_reads: List[List[np.ndarray]], k: int,
              device: torch.device, max_steps: int = 0,
              tol: int = 50) -> GapFillResult:
    """Assemble every junction gap.

    junctions: (left_seq, right_seq, gap_estimate) per gap — the full
    contig sequences adjoining the gap.  gap_reads: per gap, the uint8
    code rows of the reads assigned to it (``stages/scaff``'s
    ``collect_gap_reads``).  tol is -G (reference GLDiff, default 50).
    """
    g_n = len(junctions)
    seconds = {}
    if g_n == 0:
        return GapFillResult(np.zeros(0, bool), [], np.zeros(0, np.int32),
                             seconds)
    w = bits.words_for_k(k)
    max_gap = max(j[2] for j in junctions)
    if max_steps <= 0:
        max_steps = int(min(max(2 * k + 2 * max(max_gap, 0) + 8, 64), 2048))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def phase(name):  # scaff's fill phase calls this: scaff.fill.<name>
        return profiling.phase(seconds, "scaff.fill", name, sync)

    # --- host: negative/zero gaps first (overlap merge) ---
    with phase("overlap"):
        filled = np.zeros(g_n, bool)
        fill_seq = [""] * g_n
        overlap = np.zeros(g_n, np.int32)
        need_asm = []
        for gi, (left, right, gap) in enumerate(junctions):
            if gap <= 0:
                ov = try_overlap_merge(left, right, gap)
                if ov is not None:
                    filled[gi] = True
                    overlap[gi] = ov
                    continue
            if len(left) >= k and len(right) >= k:
                need_asm.append(gi)
    if not need_asm:
        return GapFillResult(filled, fill_seq, overlap, seconds)

    # --- device: batched local assembly for the rest ---
    with phase("tables"):
        flank = 2 * k
        read_rows, read_gid = [], []
        for slot, gi in enumerate(need_asm):
            left, right, _ = junctions[gi]
            rows = [bits.encode_seq(left[-min(len(left), flank + k):]),
                    bits.encode_seq(right[:min(len(right), flank + k)])]
            rows.extend(gap_reads[gi] if gi < len(gap_reads) else ())
            read_rows.extend(rows)
            read_gid.extend([slot] * len(rows))
        lens = np.fromiter((len(r) for r in read_rows), np.int64,
                           len(read_rows))
        lmax = max(int(lens.max()), k)
        codes = np.full((len(read_rows), lmax), 4, np.uint8)
        codes[np.repeat(np.arange(lens.size), lens),
              np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens,
                                                lens)] = \
            np.concatenate(read_rows).astype(np.uint8)

        tables = build_local_tables(*_chop_tagged(
            codes, lens, np.asarray(read_gid, np.int64), k, device))
    with phase("graph"):
        succ, ncount = _local_graph(tables, k)

    g_slots = len(need_asm)
    gap_ids = torch.arange(g_slots, device=device)[:, None]

    def node_of(strings):
        km = torch.from_numpy(np.stack(
            [bits.kmer_from_string(s)[:w] for s in strings])).to(device)
        can, use_rc = bits.canonical(km, k)
        rows = _lookup_rows(tables, torch.cat([gap_ids, can], -1))
        return torch.where(rows >= 0, 2 * rows + use_rc.to(torch.int64), -1)

    with phase("bfs"):
        node_s = node_of([junctions[gi][0][-k:] for gi in need_asm])
        node_t = node_of([junctions[gi][1][:k] for gi in need_asm])
        ds = _bfs(succ, node_s, max_steps)
        # distance to the target = distance from the target's twin over
        # the same graph, read at the twin node (de Bruijn graph duality)
        dt = _bfs(succ, torch.where(node_t >= 0, node_t ^ 1, -1),
                  max_steps).view(-1, 2).flip(1).reshape(-1)
        # shortest walk length, start -> target
        l0 = torch.where(node_t >= 0, ds[node_t.clamp(min=0)],
                         -1).cpu().numpy()
    with phase("trace"):
        bases, traced_ok = _trace(succ, ncount, dt, node_s, node_t,
                                  max_steps)
        bases = bases.cpu().numpy()      # (max_steps, slots)
        traced_ok = traced_ok.cpu().numpy()

    with phase("fallback"):
        lut = np.frombuffer(bits.BASE_CHARS.encode(), np.uint8)
        for slot, gi in enumerate(need_asm):
            length = int(l0[slot])
            gap = junctions[gi][2]
            ins_len = length - k
            if length < 0 or not traced_ok[slot] or \
                    abs(max(ins_len, -k) - gap) > tol + k:
                continue  # unreachable or outside the distance window
            filled[gi] = True
            if ins_len >= 0:
                fill_seq[gi] = lut[bases[:ins_len, slot]].tobytes().decode()
            else:
                # the walk met right's head early: the contigs overlap
                overlap[gi] = -ins_len

        # --- readsCrossGap fallback (localAsm.c:2035): a single read
        # anchored by exact K-mers on both flanks bridges the gap ---
        for gi in need_asm:
            if filled[gi] or gi >= len(gap_reads):
                continue
            left, right, gap = junctions[gi]
            ins = _read_across(gap_reads[gi], left[-k:], right[:k], gap,
                               tol + k)
            if ins is not None:
                filled[gi] = True
                fill_seq[gi] = ins
    return GapFillResult(filled, fill_seq, overlap, seconds)


def _read_across(reads, anchor_l: str, anchor_r: str, gap: int,
                 slack: int) -> Optional[str]:
    """The bases between the two anchors in the first read (either
    strand, forward first) that holds both, the right one after the
    left, at a distance within ``slack`` of the gap estimate."""
    k = len(anchor_l)
    for rd in reads:
        s = bits.decode_seq(rd)
        for seq in (s, bits.revcomp_str(s)):
            i = seq.find(anchor_l)
            if i < 0:
                continue
            j = seq.find(anchor_r, i + 1)
            if j >= 0 and abs(len(seq[i + k:j]) - gap) <= slack:
                return seq[i + k:j]
    return None
