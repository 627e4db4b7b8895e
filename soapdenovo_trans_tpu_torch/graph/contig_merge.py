"""Edge-graph linear concatenation -> contigs.

Port of ``soapdenovo_trans_tpu/graph/contig_merge.py`` (reference
linearConcatenate, src/concatenateEdge.c:227-296, and compactEdgeArray,
src/compactEdge.c:94).  The whole transitive chain collapses in one
list-ranking pass:

An edge e chains into its unique successor t when
  e has exactly one out-arc (to t), t has exactly one in-arc,
  t != twin(t), e != twin(e), t not in {e, twin(e)}
— the conditions of concatenateEdge.c:253-277.  Merged attributes
follow allpathUpdateEdge: length = sum, coverage = length-weighted mean
(>= 1), sequence = concatenation; surviving arcs are remapped onto chain
ids and re-aggregated.  Compaction (dropping deleted edges and
renumbering) happens in the same pass.

The members of a chain are ordered by an int64 key, chain * (E + 1) +
rank.  The JAX package forms that key in int32 (contig_merge.py:134),
so it builds wrong sequences for every contig whose id is at least
2**30 / (E + 1); the port does not copy that fault.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..ops import bits, ranking
from ..ops.index import gather_or, scatter, segment_sum
from . import arcs as arcs_mod
from .edge_clean import rebuild_arcs

_BASE_LUT = np.frombuffer(bits.BASE_CHARS.encode(), np.uint8)


class Contigs(NamedTuple):
    """Contig array after concatenation (also the 'updated edge' graph
    the scaffold stage consumes)."""

    from_node: torch.Tensor   # (C,) int64 directed kmer-node of first vertex
    to_node: torch.Tensor     # (C,) int64
    length: torch.Tensor      # (C,) int64 appended bases (full = K + length)
    cvg: torch.Tensor         # (C,) int64 10x mean kmer coverage
    twin: torch.Tensor        # (C,) int64
    seq_off: torch.Tensor     # (C,) int64
    seq_pool: torch.Tensor    # (S,) uint8
    n: int
    edge2contig: torch.Tensor  # (E,) int64 member edge -> contig id
    arcs: arcs_mod.ArcSet     # remapped surviving arcs


def _edge_degrees(aset: arcs_mod.ArcSet, e_cap: int, deleted):
    """Per-edge out-degree and unique out-target, ignoring arcs that
    touch deleted edges (zero-multiplicity arcs count, as in the JAX
    package)."""
    live_arc = (aset.from_ed >= 0) & \
        ~gather_or(deleted, aset.from_ed, True) & \
        ~gather_or(deleted, aset.to_ed, True)
    f = torch.where(live_arc, aset.from_ed, e_cap)
    out_deg = segment_sum(live_arc.long(), f, e_cap)
    only_to = torch.full((e_cap + 1,), -1, dtype=torch.int64, device=f.device)
    only_to[f] = torch.where(live_arc, aset.to_ed, -1)
    return out_deg, only_to[:e_cap], live_arc


def _chain_pointers(eg, aset: arcs_mod.ArcSet):
    e_cap = eg.length.shape[0]
    me = torch.arange(e_cap, device=eg.length.device)
    deleted = eg.deleted
    out_deg, t, live_arc = _edge_degrees(aset, e_cap, deleted)
    in_deg = gather_or(out_deg, eg.twin, 0)  # in_deg(e) = out_deg(twin(e))
    self_twin = eg.twin == me

    ok = (out_deg == 1) & ~deleted & ~self_twin & (t >= 0)
    ok &= ~gather_or(deleted, t, True)
    ok &= gather_or(in_deg, t, 0) == 1
    ok &= ~gather_or(self_twin, t, True)
    ok &= (t != me) & (t != eg.twin)
    nxt = torch.where(ok, t, -1)

    # backward pointer: prev[t] = e iff nxt[e] == t (unique by in_deg)
    exists = ~deleted & (me < eg.n_edges)
    prev = torch.where(exists, scatter(e_cap, torch.where(ok, t, e_cap),
                                       me, -1), -1)
    head, rank, is_head = ranking.list_rank(prev, exists)
    return head, rank, is_head, live_arc, nxt, exists


def _merge(eg, aset: arcs_mod.ArcSet, pointers, c_cap: int, s_cap: int):
    e_cap = eg.length.shape[0]
    dev = eg.length.device
    me = torch.arange(e_cap, device=dev)
    head, rank, is_head, live_arc, nxt, exists = pointers

    cid_at_head = torch.cumsum(is_head, 0) - 1
    chain_of = torch.where(exists, cid_at_head[head], c_cap)
    chain_or_neg = torch.where(exists, chain_of, -1)

    length = segment_sum(torch.where(exists, eg.length, 0), chain_of, c_cap)
    cvg_w = segment_sum(torch.where(exists, eg.cvg * eg.length, 0),
                        chain_of, c_cap)
    cvg = torch.maximum(cvg_w // length.clamp(min=1),
                        torch.ones_like(cvg_w))

    n_members = segment_sum(exists.long(), chain_of, c_cap)
    from_node = scatter(c_cap, torch.where(is_head, chain_of, c_cap),
                        eg.from_node, -1)
    is_last = exists & (rank == gather_or(n_members, chain_or_neg, 0) - 1)
    last_idx = torch.where(is_last, chain_of, c_cap)
    to_node = scatter(c_cap, last_idx, eg.to_node, -1)
    last_edge = scatter(c_cap, last_idx, me, -1)

    # twin chain: headed by twin(last edge of this chain)
    twin_head_edge = gather_or(eg.twin, last_edge, -1)
    twin_cid = torch.where(
        twin_head_edge >= 0,
        cid_at_head[head[twin_head_edge.clamp(0, e_cap - 1)]], -1)

    # ---- sequence pool rebuild ----
    # prefix length of each edge within its chain: order members by
    # (chain, rank) on an int64 key, exclusive running sum of lengths
    order_key = torch.where(exists, chain_of * (e_cap + 1) + rank,
                            torch.iinfo(torch.int64).max)
    sort_edge = torch.sort(order_key, stable=True).indices
    s_exists = exists[sort_edge]
    sorted_len = torch.where(s_exists, eg.length[sort_edge], 0)
    run = torch.cumsum(sorted_len, 0) - sorted_len
    sorted_chain = torch.where(s_exists, chain_of[sort_edge], -1)
    chain_first = torch.ones_like(s_exists)
    chain_first[1:] = sorted_chain[1:] != sorted_chain[:-1]
    chain_base = torch.cummax(torch.where(chain_first, run, 0), 0).values
    prefix = torch.zeros_like(run)
    prefix[sort_edge] = run - chain_base

    contig_off = torch.cumsum(length, 0) - length
    # every base of a live edge moves to its contig's offset + the
    # edge's prefix within the chain
    copy_len = torch.where(exists, eg.length, 0)
    owner = torch.repeat_interleave(me, copy_len, output_size=s_cap)
    within = torch.arange(s_cap, device=dev) - \
        (torch.cumsum(copy_len, 0) - copy_len)[owner]
    dst = contig_off[chain_of[owner]] + prefix[owner] + within
    seq_pool = torch.zeros(s_cap, dtype=torch.uint8, device=dev)
    seq_pool[dst] = eg.seq_pool[eg.seq_off[owner] + within]

    # ---- arc remap ----
    consumed = live_arc & (gather_or(nxt, aset.from_ed, -2) == aset.to_ed)
    keep = live_arc & ~consumed
    arcs = arcs_mod.ArcSet(
        torch.where(keep, gather_or(chain_of, aset.from_ed, -1), -1),
        torch.where(keep, gather_or(chain_of, aset.to_ed, -1), -1),
        torch.where(keep, aset.mult, 0), 0)
    return Contigs(from_node, to_node, length, cvg, twin_cid, contig_off,
                   seq_pool, c_cap, chain_or_neg, arcs)


def concatenate(eg, aset: arcs_mod.ArcSet) -> Contigs:
    """Concatenation + compaction.  Two host syncs size the result."""
    pointers = _chain_pointers(eg, aset)
    is_head, exists = pointers[2], pointers[5]
    n_chains = int(is_head.sum())
    if n_chains == 0:  # every edge deleted: one empty row, like every
        def one(fill):  # other capacity
            return eg.length.new_full((1,), fill)
        none = eg.length.new_zeros(0)
        return Contigs(one(-1), one(-1), one(0), one(0), one(-1), one(0),
                       eg.seq_pool.new_zeros(1), 0,
                       torch.full_like(eg.length, -1),
                       arcs_mod.ArcSet(none, none, none, 0))
    total_len = int(torch.where(exists, eg.length, 0).sum())
    ctg = _merge(eg, aset, pointers, n_chains, total_len)
    # re-aggregate remapped arcs (multiplicities of parallel old arcs add)
    a = ctg.arcs
    return ctg._replace(arcs=rebuild_arcs(a.from_ed, a.to_ed, a.mult,
                                          ctg.twin))


def contig_sequences(ctg: Contigs, table, k: int) -> List[str]:
    """Decode full contig sequences to host strings (K-mer prefix +
    appended bases)."""
    n = ctg.n
    if n == 0:
        return []
    fn = ctg.from_node[:n]
    km = table.keys[fn >> 1]
    km = torch.where(((fn & 1) == 1)[:, None],
                     bits.reverse_complement(km, k), km).cpu().numpy()
    w = km.shape[1]
    pos = 2 * (k - 1 - np.arange(k))
    head = (km[:, w - 1 - pos // 32] >> (pos % 32)) & 3     # (n, K)
    head = _BASE_LUT[head]
    pool = _BASE_LUT[ctg.seq_pool.cpu().numpy()]
    length = ctg.length[:n].cpu().numpy()
    off = ctg.seq_off[:n].cpu().numpy()
    return [head[c].tobytes().decode() +
            pool[off[c]:off[c] + length[c]].tobytes().decode()
            for c in range(n)]


def contig_file_perm(ctg: Contigs, k: int) -> List[int]:
    """The .contig/.ContigIndex id assignment (output_contig.c:135-170):
    contigs sorted by full length ascending (stable on row), each twin
    pair claiming consecutive ids with the representative first.
    Returns perm: new id - 1 -> contig row."""
    n = ctg.n
    lengths = ctg.length[:n].cpu().numpy() + k
    twin = ctg.twin[:n].cpu().numpy()
    printed = np.zeros(n, bool)
    perm: List[int] = []
    for row in np.argsort(lengths, kind="stable").tolist():
        if printed[row]:
            continue
        printed[row] = True
        perm.append(row)
        t = int(twin[row])
        if 0 <= t < n and t != row:
            printed[t] = True
            perm.append(t)
    return perm


def reorder_contigs(ctg: Contigs, perm) -> Contigs:
    """Permute contig rows into the .contig/.ContigIndex file order so
    internal row i == file id i+1 everywhere downstream (the reference
    keeps an index_array to translate between the map-stage and
    scaff-stage numberings, loadGraph.c:309; this renumbers once).
    Arc rows are renumbered in place, not re-sorted."""
    n = ctg.n
    cap = ctg.length.shape[0]
    dev = ctg.length.device
    perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    old2new = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    old2new[perm] = torch.arange(n, device=dev)

    def permute(a):
        out = a.clone()
        out[:n] = a[perm]
        return out

    def remap_ids(a):
        return torch.where(a >= 0, old2new[a.clamp(0, cap - 1)], a)

    new_twin = torch.where(ctg.twin >= 0,
                           old2new[ctg.twin.clamp(0, cap - 1)], -1)
    aset = ctg.arcs._replace(from_ed=remap_ids(ctg.arcs.from_ed),
                             to_ed=remap_ids(ctg.arcs.to_ed))
    return Contigs(
        permute(ctg.from_node), permute(ctg.to_node),
        permute(ctg.length), permute(ctg.cvg), permute(new_twin),
        permute(ctg.seq_off), ctg.seq_pool, n,
        remap_ids(ctg.edge2contig), aset)
