"""Unitig condensation: k-mer graph -> edge (unitig) graph.

Port of ``soapdenovo_trans_tpu/graph/unitigs.py`` (reference
kmer2edges, src/node2edge.c:46-589, by parallel list ranking):

1. every existing k-mer arc gets a backward pointer to its unique
   predecessor arc when its tail node is linear (1-in-1-out);
2. pointer doubling gives each arc's chain head and rank (cycles of
   linear nodes are broken at their minimum arc id);
3. per-edge fields fall out of segment reductions keyed by chain head.

Edge coverage follows the reference (src/node2edge.c:500-536): 10x mean
interior-node left coverage for length > 1, 10x the from-node count for
length-1 edges, capped at MaxEdgeCov=16000 (src/inc/def.h:37).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.wave import MAX_EDGE_COV
from ..ops import bits, dictionary, ranking
from ..ops.index import gather_or, scatter
from . import dbg as dbg_mod


class EdgeGraph(NamedTuple):
    """Condensed edge (unitig) graph, struct-of-arrays; every edge's
    reverse complement is its own row, ``twin[e]`` (palindromes:
    twin[e] == e)."""

    from_node: torch.Tensor  # (E,) int64 directed kmer-node id
    to_node: torch.Tensor    # (E,) int64
    length: torch.Tensor     # (E,) int64 — appended bases; full seq = K + length
    cvg: torch.Tensor        # (E,) int64 — 10x mean kmer coverage
    twin: torch.Tensor       # (E,) int64
    seq_off: torch.Tensor    # (E,) int64 offset into seq_pool
    seq_pool: torch.Tensor   # (S,) uint8 appended bases, edge-major
    n_edges: int
    node_edge: torch.Tensor  # (2cap,) int64 edge owning this interior node, or -1
    node_pos: torch.Tensor   # (2cap,) int64 1-based position within edge
    deleted: torch.Tensor    # (E,) bool — removed by a cleaning pass


def _arc_prev(graph: dbg_mod.DBG) -> torch.Tensor:
    """Backward pointer of every arc: the unique in-arc of its tail
    node when that node is linear (the twin of the twin node's unique
    out-arc)."""
    exists = graph.exists
    two_cap = graph.out_deg.shape[0]
    nodes = torch.arange(two_cap, device=exists.device)
    tw_n = dbg_mod.twin(nodes)
    e = exists.view(-1, 4)[tw_n]
    tb = torch.where(e[:, 0], 0, torch.where(
        e[:, 1], 1, torch.where(e[:, 2], 2, 3)))
    node_in_arc = dbg_mod.twin_arc(graph, dbg_mod.arc_id(tw_n, tb))
    arc_prev = torch.where(
        exists & graph.linear.repeat_interleave(4),
        node_in_arc.repeat_interleave(4), -1)
    # a predecessor pointer must reference an existing arc
    return torch.where(gather_or(exists, arc_prev, False), arc_prev, -1)


def _extract_edges(graph: dbg_mod.DBG, table: dictionary.KmerTable,
                   head, rank, is_head, n_edges: int,
                   n_arcs: int) -> EdgeGraph:
    exists = graph.exists
    succ = graph.succ
    a_total = exists.shape[0]
    two_cap = graph.out_deg.shape[0]
    e_cap, s_cap = max(n_edges, 1), max(n_arcs, 1)
    dev = exists.device
    arc_ids = torch.arange(a_total, device=dev)
    tail = arc_ids >> 2
    base = (arc_ids & 3).to(torch.uint8)

    # edge id at each head arc; every arc inherits via its chain head
    eid_at_arc = torch.cumsum(is_head, 0) - 1
    edge_of = torch.where(exists, eid_at_arc[head], e_cap)  # pad bucket
    edge_or_neg = torch.where(exists, edge_of, -1)

    length = torch.zeros(e_cap + 1, dtype=torch.int64,
                         device=dev).scatter_reduce_(
        0, edge_of, torch.where(exists, rank + 1, 0), "amax")[:e_cap]

    from_node = scatter(e_cap, torch.where(is_head, edge_of, e_cap),
                        tail, -1)
    is_last = exists & (rank == gather_or(length, edge_or_neg, 0) - 1)
    last_idx = torch.where(is_last, edge_of, e_cap)
    to_node = scatter(e_cap, last_idx, succ, -1)
    last_arc = scatter(e_cap, last_idx, arc_ids, -1)

    # twin edge: chain of twin arcs, headed by twin(last arc)
    twin_head_arc = dbg_mod.twin_arc(graph, last_arc.clamp(0, a_total - 1))
    twin_eid = torch.where(
        (last_arc >= 0) & (twin_head_arc >= 0),
        eid_at_arc[head[twin_head_arc.clamp(0, a_total - 1)]], -1)

    # sequence pool: arc with rank r in edge e writes base at off[e] + r
    seq_off = torch.cumsum(length, 0) - length
    pool_idx = torch.where(
        exists, gather_or(seq_off, edge_or_neg, 0) + rank, s_cap)
    seq_pool = scatter(s_cap, pool_idx, base, 0)

    # coverage (reference: src/node2edge.c:500-536)
    l_cov_sum = table.l_cov.sum(1)  # per canonical row
    interior = exists & (rank + 1 < gather_or(length, edge_or_neg, 0))
    symbol = torch.zeros(e_cap + 1, dtype=torch.int64,
                         device=dev).index_add_(
        0, edge_of, torch.where(interior, l_cov_sum[succ.clamp(min=0) >> 1],
                                0))[:e_cap]
    from_count = gather_or(table.count, from_node.clamp(min=-1) >> 1, 0)
    cvg = torch.where(
        length > 1, symbol // (length - 1).clamp(min=1) * 10,
        from_count * 10).clamp(0, MAX_EDGE_COV)

    # interior-node -> (edge, pos) map for read threading
    # (reference: l_links/r_links reuse, src/node2edge.c:493-519)
    node_idx = torch.where(interior, succ, two_cap)
    node_edge = scatter(two_cap, node_idx, edge_or_neg, -1)
    node_pos = scatter(two_cap, node_idx, rank + 1, -1)

    live_e = torch.arange(e_cap, device=dev) < n_edges
    return EdgeGraph(
        torch.where(live_e, from_node, -1),
        torch.where(live_e, to_node, -1),
        torch.where(live_e, length, 0),
        torch.where(live_e, cvg, 0),
        torch.where(live_e, twin_eid, -1),
        seq_off, seq_pool, n_edges, node_edge, node_pos,
        torch.zeros(e_cap, dtype=torch.bool, device=dev))


def condense(graph: dbg_mod.DBG,
             table: dictionary.KmerTable) -> EdgeGraph:
    """Rank arc chains, read the sizes once, extract the edges."""
    head, rank, is_head = ranking.list_rank(_arc_prev(graph), graph.exists)
    n_edges = int(is_head.sum())
    n_arcs = int(graph.exists.sum())
    return _extract_edges(graph, table, head, rank, is_head, n_edges,
                          n_arcs)


def edge_sequences(eg: EdgeGraph, table: dictionary.KmerTable,
                   k: int) -> list:
    """Decode full edge sequences (the from-node's K-mer, reverse
    complemented on the odd strand, then the appended bases) to a host
    list of strings, for FASTA output and tests.  Tensors on a card are
    read back with blocking copies."""
    n = eg.n_edges
    keys = table.keys.cpu().numpy()
    pool = eg.seq_pool.cpu().numpy()
    out = []
    for fn, ln, off in zip(*(x[:n].cpu().tolist() for x in (
            eg.from_node, eg.length, eg.seq_off))):
        km = bits.kmer_to_string(keys[fn >> 1], k)
        if fn & 1:
            km = bits.revcomp_str(km)
        out.append(km + bits.decode_seq(pool[off:off + ln]))
    return out
