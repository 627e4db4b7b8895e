"""Read -> edge-path threading and preArc accumulation.

Port of ``soapdenovo_trans_tpu/graph/arcs.py`` (reference
prlRead2edge/parse1read, src/prlRead2path.c:617-789, and add1Arc,
src/loadPreGraph.c:563-627).  A whole read batch threads at once: one
batched dictionary lookup per k-mer window gives the directed node and
its owning edge; adjacent vertex k-mers resolve through a (K+1)-mer
patch table to length-1 edges; the previous path entry of every slot
comes from a running maximum instead of a serial walk; missing or
deleted k-mers are barriers no arc crosses.

preArcs are symmetrized like add1Arc: every observed (f, t) also counts
(twin(t), twin(f)); a self-twin arc therefore counts twice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bits, dictionary, kmer
from ..ops.index import gather_or
from . import unitigs

_NO_EDGE = 2**30          # sorts after every real edge id
_LVS_SENT = -(2**31) + 1  # "no earlier entry" marker of the scans


class PatchTable(NamedTuple):
    """Canonical (K+1)-mer -> length-1 edge (reference KmerSetsPatch,
    src/node2edge.c:419-462)."""

    keys: torch.Tensor   # (P, W1) int64 lanes, sorted canonical (K+1)-mers
    edge: torch.Tensor   # (P,) int64 edge walked in canonical orientation
    n: int


class ArcSet(NamedTuple):
    """COO preArc table: from-edge, to-edge, multiplicity, sorted by
    (from, to)."""

    from_ed: torch.Tensor  # (A,) int64
    to_ed: torch.Tensor    # (A,) int64
    mult: torch.Tensor     # (A,) int64
    n: int


def build_patch(eg: unitigs.EdgeGraph, table: dictionary.KmerTable,
                k: int) -> PatchTable:
    """(K+1)-mers of the length-1 edges.  The edges' key rows are
    gathered first and oriented after, so no oriented copy of the whole
    table is made."""
    e_cap = eg.length.shape[0]
    dev = eg.length.device
    is_len1 = (eg.length == 1) & (torch.arange(e_cap, device=dev)
                                  < eg.n_edges)
    u = eg.from_node.clamp(min=0)
    km = table.keys[u >> 1]
    from_km = torch.where(((u & 1) == 1)[:, None],
                          bits.reverse_complement(km, k), km)
    first = eg.seq_pool[eg.seq_off.clamp(0, eg.seq_pool.shape[0] - 1)]
    can, use_rc = bits.canonical(
        bits.append_base(from_km, first.to(torch.int64), k), k + 1)
    can = torch.where(is_len1[:, None], can, dictionary.SENTINEL)
    val = torch.where(use_rc, eg.twin, torch.arange(e_cap, device=dev))
    val = torch.where(is_len1, val, -1)
    skeys, sval = dictionary.sort_rows(can, val)
    n = int(is_len1.sum())
    cap = max(n, 1)
    return PatchTable(skeys[:cap], sval[:cap], n)


def thread_reads(seqs: torch.Tensor, lengths: torch.Tensor,
                 table: dictionary.KmerTable, eg: unitigs.EdgeGraph,
                 patch: PatchTable, k: int):
    """Thread a padded read batch through the edge graph.

    Returns flat arc candidates (from_ed, to_ed, valid) of shape
    (R * 2 * num_windows,): one potential arc per path slot.
    """
    r, l = seqs.shape
    p = l - k + 1  # kmer windows per read
    lengths = lengths.to(torch.int64)

    stream = kmer.chop_reads(seqs, lengths, k)
    rows = dictionary.lookup(table.keys, stream.kmers)
    node_live = (rows >= 0) & ~gather_or(table.deleted, rows, True)
    u = torch.where(node_live, 2 * rows + stream.is_rc.to(torch.int64), -1)
    eid = gather_or(eg.node_edge, u, -1)
    eid = torch.where(stream.valid & node_live, eid, -1)

    interior = (eid >= 0).view(r, p)
    vertexish = (stream.valid & node_live & (eid < 0)).view(r, p)
    # Any in-read window that does not resolve to a live node breaks
    # the path: deleted/missing kmers AND N-containing windows.
    in_read = (torch.arange(p, device=seqs.device)[None, :] + k) <= \
        lengths[:, None]
    barrier = in_read & ~(stream.valid & node_live).view(r, p)
    eid = eid.view(r, p)

    # (K+1)-mer patch lookups for adjacent vertex pairs
    stream1 = kmer.chop_reads(seqs, lengths, k + 1)
    pedge = gather_or(patch.edge,
                      dictionary.lookup(patch.keys, stream1.kmers), -1)
    pedge = torch.where((pedge >= 0) & stream1.is_rc,
                        gather_or(eg.twin, pedge.clamp(min=0), -1), pedge)
    pedge = torch.where(stream1.valid, pedge, -1).view(r, p - 1)
    pair_ok = vertexish[:, :-1] & vertexish[:, 1:] & (pedge >= 0)
    pair_eid = torch.where(pair_ok, pedge, -1)

    # interior entry only where a new traversal starts (dedup runs)
    prev_same = torch.zeros_like(interior)
    prev_same[:, 1:] = interior[:, :-1] & (eid[:, :-1] == eid[:, 1:])
    return _path_slots(torch.where(interior & ~prev_same, eid, -1),
                       pair_eid, barrier)


def _last_value_scan(flag, value):
    """Inclusive 'value at the last flagged position' scan; _LVS_SENT
    before the first flag."""
    pos = torch.cummax(torch.where(
        flag, torch.arange(flag.shape[0], device=flag.device), -1), 0).values
    return torch.where(pos >= 0, value[pos.clamp(min=0)], _LVS_SENT)


def _shift1(x, fill):
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _path_slots(pos_e, pair_e, barrier):
    """Path-slot adjacency, flat over all r*2p slots: even slot 2j is
    the position entry, odd slot 2j+1 the (K+1)-mer pair entry.  Scans
    run over the flat array; a same-read guard masks carries across
    reads."""
    r, p = pos_e.shape
    two_p = 2 * p
    pair_full = torch.cat([pair_e, pair_e.new_full((r, 1), -1)], 1)
    flat_e = torch.stack([pos_e, pair_full], -1).reshape(-1)
    flat_bar = torch.stack([barrier, torch.zeros_like(barrier)],
                           -1).reshape(-1)
    s = torch.arange(r * two_p, device=pos_e.device)
    entry = flat_e >= 0

    prev_slot = _shift1(torch.cummax(torch.where(entry, s, -1), 0).values,
                        -1)
    prev_val = _shift1(_last_value_scan(entry, flat_e), _LVS_SENT)
    bar_prefix = torch.cumsum(flat_bar, 0)
    bar_at_prev = _shift1(_last_value_scan(entry, bar_prefix), _LVS_SENT)

    prev_ok = entry & (prev_slot >= (s // two_p) * two_p)
    # no barrier in (prev_slot, this_slot]
    clean = (bar_prefix - bar_at_prev) == 0
    # an arc joins every adjacent entry pair, including A->A from a read
    # that leaves and re-enters the same edge (prlRead2path.c:200-236)
    return prev_val, flat_e, prev_ok & clean


def leading_paths(to_ed: torch.Tensor, valid: torch.Tensor, rows: int,
                  min_len: int):
    """Per read of a ``thread_reads`` batch of ``rows`` reads, its
    leading unbroken edge path: the path entries from the first on, up
    to the first one that does not continue its predecessor (``valid``
    false).  Returns (lengths (n,) of the paths of at least ``min_len``
    edges, in read order; their edge rows (sum,), read-major) — what
    the repsTie recorder writes (recordPathBin, reference
    prlRead2path.c:507-573)."""
    slots = to_ed.view(rows, -1)
    entry = slots >= 0
    rank = torch.cumsum(entry, 1) - 1  # index of an entry in its read
    broken = entry & (rank >= 1) & ~valid.view(rows, -1)
    first_break = torch.where(broken, rank, slots.shape[1]).min(1).values
    n_run = torch.minimum(first_break, entry.sum(1))
    rec = n_run >= min_len
    take = entry & (rank < n_run[:, None]) & rec[:, None]
    return n_run[rec], slots[take]


def _fold_pair(f, t):
    """(from, to) edge ids in [-1, 2**31 - 2] -> one int64 in the same
    lexicographic order."""
    return (f + 1) * (1 << 32) + (t + 1)


def _arcs_from_keys(keys, mult) -> ArcSet:
    """Sorted folded (from, to) keys with multiplicities -> ArcSet
    (equal keys summed).  One host sync for the arc count."""
    uniq, inv = torch.unique_consecutive(keys, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64,
                        device=keys.device).index_add_(0, inv, mult)
    return ArcSet((uniq >> 32) - 1, (uniq & bits.LANE_MASK) - 1, total,
                  uniq.shape[0])


def count_arcs(from_ed, to_ed, valid, twin) -> ArcSet:
    """Symmetrize (add1Arc semantics), then sort + count equal arcs."""
    f = torch.cat([from_ed, gather_or(twin, to_ed, _NO_EDGE)])
    t = torch.cat([to_ed, gather_or(twin, from_ed, _NO_EDGE)])
    keep = valid.repeat(2) & (f < _NO_EDGE)
    keys = torch.sort(_fold_pair(f[keep], t[keep])).values
    return _arcs_from_keys(keys, torch.ones_like(keys))


def count_arcs_many(cands, twin) -> ArcSet:
    """count_arcs over several thread_reads outputs at once."""
    return count_arcs(*(torch.cat([c[i] for c in cands]) for i in range(3)),
                      twin)


class ArcForest:
    """Binary-counter accumulation of per-batch ArcSets: equal-rank sets
    merge pairwise, so each arc is re-sorted O(log n_batches) times."""

    def __init__(self, twin):
        self.twin = twin
        self.levels: list = []

    def insert(self, aset: ArcSet) -> None:
        i = 0
        while True:
            if i == len(self.levels):
                self.levels.append(aset)
                return
            if self.levels[i] is None:
                self.levels[i] = aset
                return
            aset = merge_arcs(self.levels[i], aset, self.twin)
            self.levels[i] = None
            i += 1

    def finish(self) -> ArcSet | None:
        out = None
        for t in self.levels:
            if t is None:
                continue
            out = t if out is None else merge_arcs(out, t, self.twin)
        return out


def merge_arcs(a: ArcSet, b: ArcSet, twin) -> ArcSet:
    """Combine arc sets from two read batches (already symmetrized:
    re-sort and add)."""
    keep = torch.cat([a.from_ed, b.from_ed]) >= 0
    keys = torch.cat([_fold_pair(a.from_ed, a.to_ed),
                      _fold_pair(b.from_ed, b.to_ed)])[keep]
    srt = torch.sort(keys)
    return _arcs_from_keys(
        srt.values, torch.cat([a.mult, b.mult])[keep][srt.indices])
