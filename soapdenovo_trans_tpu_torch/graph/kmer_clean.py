"""K-mer-level graph cleaning (pregraph stage).

Port of ``soapdenovo_trans_tpu/graph/kmer_clean.py``, the equivalents of
cutTipPreGraph.c:

* minor_out  — removeMinorOut (:1012): at branching nodes, delete
  neighbour k-mers below dd% of the strongest sibling's count;
* single_tips — removeSingleTips (:339): clip dead-end chains of
  count-1 k-mers shorter than 2K nodes;
* minor_tips — removeMinorTips (:372): clip dead-end chains shorter
  than 2K nodes unless they carry the strongest link into their join;
  iterated to fixpoint.

Each pass finds all tips at once with list ranking and deletes whole
chains.
"""

from __future__ import annotations

import torch

from ..ops import dictionary, ranking
from ..ops.index import gather_or, scatter_true
from . import dbg as dbg_mod

DEFAULT_MINOR_PCT = 5   # reference -i dd, global.h:110
TIP_FACTOR = 2          # cut_len = 2 * K (cutTipPreGraph.c:347)


def _unique_out_base(exists: torch.Tensor) -> torch.Tensor:
    """Per node: first base with an existing out-arc (3 if none)."""
    e = exists.view(-1, 4)
    return torch.where(e[:, 0], 0, torch.where(
        e[:, 1], 1, torch.where(e[:, 2], 2, 3)))


def _minor_out(table: dictionary.KmerTable, graph, pct: int):
    cap = table.capacity
    succ_row = graph.succ.clamp(min=0) >> 1
    ncount = torch.where(graph.exists, table.count[succ_row], 0)
    max_n = ncount.view(-1, 4).amax(1).repeat_interleave(4)
    branchy = (graph.out_deg > 1).repeat_interleave(4)
    # delete neighbour when count/max < pct/100 <=> 100*count < pct*max
    weak = graph.exists & branchy & (ncount > 0) & \
        (100 * ncount < pct * max_n)
    hits = scatter_true(cap, torch.where(weak, succ_row, cap))
    return table.deleted | hits, int((hits & ~table.deleted).sum())


def minor_out(table: dictionary.KmerTable, k: int,
              pct: int = DEFAULT_MINOR_PCT) -> dictionary.KmerTable:
    deleted, n = _minor_out(table, dbg_mod.build_dbg(table, k), pct)
    print(f"[kmer_clean] minor-out: {n} kmers removed")
    return table._replace(deleted=deleted)


def _tip_prev(table: dictionary.KmerTable, graph, thin: bool):
    """Tip pass step 1: eligibility + backward chain pointers."""
    nodes = torch.arange(2 * table.capacity, device=graph.live.device)
    in_deg = graph.out_deg[nodes ^ 1]   # in_deg(u) = out_deg(twin)
    single = table.count[nodes >> 1] == 1

    elig = graph.linear & graph.live
    head_cand = graph.live & (in_deg == 0) & (graph.out_deg == 1)
    if thin:
        elig &= single
        head_cand &= single

    xr = nodes ^ 1
    tb = _unique_out_base(graph.exists)[xr]
    in_arc = dbg_mod.twin_arc(graph, dbg_mod.arc_id(xr, tb))
    pred = torch.where(in_deg == 1, in_arc >> 2, -1)

    member = elig | head_cand
    prev = torch.where(
        elig & (pred >= 0) & gather_or(member, pred, False) &
        (gather_or(graph.out_deg, pred, 0) == 1), pred, -1)
    prev = torch.where(member, prev, -1)
    return prev, member, head_cand, in_deg


def _tip_chains(head, rank, member, head_cand):
    """Tip pass step 3: chain membership + per-chain length."""
    two_cap = head.shape[0]
    on_tip = member & gather_or(head_cand, head, False)
    chain_len = torch.zeros(two_cap + 1, dtype=torch.int64,
                            device=head.device).scatter_reduce_(
        0, torch.where(on_tip, head, two_cap),
        torch.where(on_tip, rank + 1, 0), "amax")[:two_cap]
    return on_tip, chain_len


def _tip_clip(table, graph, head, rank, on_tip, chain_len, in_deg,
              k: int, thin: bool):
    """Tip pass step 4: join inspection + chain deletion."""
    cap = table.capacity
    two_cap = 2 * cap
    dev = head.device
    nodes = torch.arange(two_cap, device=dev)
    len_at_head = gather_or(chain_len, head, 0)

    is_last = on_tip & (rank == len_at_head - 1)
    arc = 4 * nodes + _unique_out_base(graph.exists)
    join = torch.where(is_last, graph.succ[arc], -1)
    join_cov = torch.where(is_last, graph.out_cov[arc], 0)
    # join's max in-cov = max out_cov of twin(join)
    join_tw = dbg_mod.twin(join.clamp(min=0))
    join_max_in = graph.out_cov.view(-1, 4)[join_tw].amax(1)
    join_in_deg = gather_or(in_deg, join, 0)
    join_out_deg = gather_or(graph.out_deg, join, 0)
    # reference: sum of join's branches == 1 -> the whole component
    # dangles; clip unconditionally (and the join dies too)
    join_dangling = is_last & (join >= 0) & \
        (join_in_deg + join_out_deg == 1)
    if thin:
        clip_here = is_last & (join >= 0)
    else:
        clip_here = is_last & (join >= 0) & \
            (join_dangling | (join_cov < join_max_in))
    # a tip with no join at all (isolated chain) — clip it too
    clip_here = clip_here | (is_last & (join < 0))

    clip_at_head = scatter_true(two_cap,
                                torch.where(clip_here, head, two_cap))
    ok_head = clip_at_head & (chain_len <= TIP_FACTOR * k)
    head_ok = gather_or(ok_head, head, False)
    doomed = on_tip & head_ok
    # joins of dangling single-link components die with the chain
    join_doomed_at = torch.where(join_dangling & head_ok, join, -1)

    hits = scatter_true(cap, torch.cat([
        torch.where(doomed, nodes >> 1, cap),
        torch.where(join_doomed_at >= 0, join_doomed_at >> 1, cap)]))
    return table.deleted | hits, int((hits & ~table.deleted).sum())


def _tip_pass(table: dictionary.KmerTable, graph, k: int, thin: bool):
    """One tip-clipping pass."""
    prev, member, head_cand, in_deg = _tip_prev(table, graph, thin)
    head, rank, _is_head = ranking.list_rank(prev, member)
    on_tip, chain_len = _tip_chains(head, rank, member, head_cand)
    return _tip_clip(table, graph, head, rank, on_tip, chain_len, in_deg,
                     k, thin)


def single_tips(table: dictionary.KmerTable,
                k: int) -> dictionary.KmerTable:
    deleted, n = _tip_pass(table, dbg_mod.build_dbg(table, k), k, True)
    print(f"[kmer_clean] single-cov tips: {n} kmers removed")
    return table._replace(deleted=deleted)


def minor_tips(table: dictionary.KmerTable, k: int,
               max_rounds: int = 32) -> dictionary.KmerTable:
    total = 0
    for _ in range(max_rounds):
        deleted, n = _tip_pass(table, dbg_mod.build_dbg(table, k), k,
                               False)
        table = table._replace(deleted=deleted)
        total += n
        if n == 0:
            break
    print(f"[kmer_clean] minor tips: {total} kmers removed")
    return table


def clip_tip_kmers(table: dictionary.KmerTable, k: int,
                   minor_pct: int = DEFAULT_MINOR_PCT,
                   skip_single: bool = False) -> dictionary.KmerTable:
    """Full pregraph cleaning sequence (reference pregraph.c:69-89):
    minor-out, then single tips (unless -d already filtered), then
    minor tips to fixpoint."""
    table = minor_out(table, k, minor_pct)
    if not skip_single:
        table = single_tips(table, k)
    return minor_tips(table, k)
