"""Edge-level graph cleaning (contig stage).

Port of ``soapdenovo_trans_tpu/graph/edge_clean.py`` (reference
cutTip_graph.c):

* delete_weak_edges — deleteWeakEdge (:993): drop edges with
  cvg < cutoff (cutoff capped at 30, i.e. real coverage 3).
* cut_tips — cutTipsInGraph/isUnreliableTip (:439/:208): drop tip
  chains (no in-arcs, walked while 1-in-1-out) shorter than 2K bp
  unless they carry the dominant link into their join.
* delete_unlike_arcs — deleteUnlikeArc (:674): arc multiplicity
  < max(cvg_from, cvg_to)/25 or < 3 -> dropped.
* delow_high_arc — delowHighArc (:491): clamp anomalously heavy arcs
  to max(in_flow, out_flow).
* delete_simple_loops — deleteSimpleLoop (:1079): kill self-arcs and
  reciprocal 2-edge loops.
* delete_light_arcs — deleteLightArc (:635) = deleteLightOutArc(da%)
  + deleteLightFlowArc(dA%).
* delete_short_components — deleteShortContig(48)/extern_contig
  (:947/:849): connected components (arcs + twin pairing) whose total
  length is below the cutoff are dropped entirely.

Arcs are a sorted COO table; the (from, to) pair doubles as a 2-lane
dictionary key, so twin-arc partners resolve with the k-mer lookup.
All passes mutate multiplicities or deleted masks; ``compact_arcs``
drops dead rows.  Sizes are exact, so no padding row ever carries
meaning; a dropped scatter goes to one extra slot past the end.
"""

from __future__ import annotations

import torch

from ..ops import dictionary, ranking
from ..ops.index import gather_or, scatter_true, segment_sum
from . import arcs as arcs_mod

MAX_WEAK_CVG = 30      # deleteWeakEdge caps cutoff at 30 (cvg x10 units)
UNLIKE_DIV = 25        # deleteUnlikeArc: mult < cvg/25
UNLIKE_MIN = 3         # deleteUnlikeArc: mult < 3
SHORT_COMPONENT = 48   # cut_length default, reference global.h
MAX_ROUNDS = 64        # cut_tips / delete_short_components round caps
_NO_KEY = 2**30        # key lane of a -1 arc row (sorts after real ids)
_NO_QUERY = 2**29      # query lane of a missing twin (matches no row)
_INT32_MIN = -(2**31)  # jax.ops.segment_max's empty-segment value


def _empty_arcs(like) -> arcs_mod.ArcSet:
    none = like.new_zeros(0)
    return arcs_mod.ArcSet(none, none, none, 0)


def rebuild_arcs(from_ed, to_ed, mult, twin) -> arcs_mod.ArcSet:
    """Re-sort and re-aggregate an arc table (rows with from == -1
    drop; zero-multiplicity rows stay)."""
    return arcs_mod.merge_arcs(arcs_mod.ArcSet(from_ed, to_ed, mult, 0),
                               _empty_arcs(from_ed), twin)


def _arc_keys(aset: arcs_mod.ArcSet):
    """(A, 2) key lanes of the sorted (from, to) pairs."""
    real = aset.from_ed >= 0
    return torch.stack([torch.where(real, aset.from_ed, _NO_KEY),
                        torch.where(real, aset.to_ed, _NO_KEY)], -1)


def _pair_lookup(aset: arcs_mod.ArcSet, f, t):
    """Row of arc (f, t) or -1; f or t == -1 finds nothing."""
    q = torch.stack([torch.where(f >= 0, f, _NO_QUERY),
                     torch.where(t >= 0, t, _NO_QUERY)], -1)
    return dictionary.lookup(_arc_keys(aset), q)


def twin_arc_index(aset: arcs_mod.ArcSet, twin):
    """Row index of each arc's bal (twin) arc."""
    return _pair_lookup(aset, gather_or(twin, aset.to_ed, -1),
                        gather_or(twin, aset.from_ed, -1))


def _sym_drop(aset: arcs_mod.ArcSet, drop, twin):
    """Extend a drop mask to bal arcs (reference always zeroes both)."""
    ti = twin_arc_index(aset, twin)
    a = aset.from_ed.shape[0]
    return drop | scatter_true(a, torch.where(drop & (ti >= 0), ti, a))


def out_weights(aset: arcs_mod.ArcSet, e_cap: int):
    """Total out-arc multiplicity per edge (in-flow = out of twin)."""
    return segment_sum(aset.mult, torch.where(
        aset.from_ed >= 0, aset.from_ed, e_cap), e_cap)


def _live(eg):
    return torch.arange(eg.length.shape[0], device=eg.length.device) \
        < eg.n_edges


def delete_weak_edges(eg, cutoff: int):
    cutoff = min(cutoff, MAX_WEAK_CVG)
    weak = _live(eg) & (eg.cvg < cutoff)
    weak = weak | gather_or(weak, eg.twin, False)
    n = int((weak & ~eg.deleted).sum())
    print(f"[edge_clean] weak edges (<{cutoff/10:.1f}x): {n} removed")
    return eg._replace(deleted=eg.deleted | weak)


def delete_unlike_arcs(aset: arcs_mod.ArcSet, eg) -> arcs_mod.ArcSet:
    mx = torch.maximum(gather_or(eg.cvg, aset.from_ed, 0),
                       gather_or(eg.cvg, aset.to_ed, 0))
    drop = (aset.mult > 0) & (
        (aset.mult * UNLIKE_DIV < mx) | (aset.mult < UNLIKE_MIN))
    drop = _sym_drop(aset, drop, eg.twin)
    return aset._replace(mult=torch.where(drop, 0, aset.mult))


def delow_high_arc(aset: arcs_mod.ArcSet, eg, multi: int) -> arcs_mod.ArcSet:
    out_w = out_weights(aset, eg.length.shape[0])
    in_w = gather_or(out_w, eg.twin, 0)  # in-flow of e = out-flow of twin
    f_in = gather_or(in_w, aset.from_ed, 0)
    t_out = gather_or(out_w, aset.to_ed, 0)
    heavy = (aset.mult > 0) & (f_in > 0) & \
        (aset.mult > f_in * multi) & (aset.mult > t_out * multi)
    return aset._replace(mult=torch.where(
        heavy, torch.maximum(f_in, t_out), aset.mult))


def delete_simple_loops(aset: arcs_mod.ArcSet, eg) -> arcs_mod.ArcSet:
    self_loop = (aset.from_ed >= 0) & (aset.from_ed == aset.to_ed)
    # reciprocal: does (to, from) exist with mult > 0?
    rev = _pair_lookup(aset, aset.to_ed, aset.from_ed)
    recip = (rev >= 0) & (gather_or(aset.mult, rev, 0) > 0) & \
        (aset.mult > 0) & (aset.from_ed != aset.to_ed)
    drop = _sym_drop(aset, self_loop | recip, eg.twin)
    return aset._replace(mult=torch.where(drop, 0, aset.mult))


def delete_light_arcs(aset: arcs_mod.ArcSet, eg,
                      da: int = 5, dA: int = 2):
    """Returns (new_arcs, changed?).  da: % of node out-weight;
    dA: % of in-flow / coverage (deleteLightOutArc/-FlowArc)."""
    out_w = out_weights(aset, eg.length.shape[0])
    # out-rate filter
    tot = gather_or(out_w, aset.from_ed, 0)
    drop1 = (aset.mult > 0) & (aset.mult * 100 <= tot * da)
    # flow filter: vs in-flow of from-edge, and vs coverage
    f_in = gather_or(gather_or(out_w, eg.twin, 0), aset.from_ed, 0)
    cov = gather_or(eg.cvg, aset.from_ed, 0) // 10
    drop2 = (aset.mult > 0) & (
        (aset.mult * 100 <= f_in * dA) | (aset.mult * 100 <= cov * dA))
    drop = _sym_drop(aset, drop1 | drop2, eg.twin)
    n = int((drop & (aset.mult > 0)).sum())
    return aset._replace(mult=torch.where(drop, 0, aset.mult)), n > 0


def _live_arcs(eg, aset: arcs_mod.ArcSet):
    return (aset.from_ed >= 0) & (aset.mult > 0) & \
        ~gather_or(eg.deleted, aset.from_ed, True) & \
        ~gather_or(eg.deleted, aset.to_ed, True)


def _edge_chain_state(eg, aset: arcs_mod.ArcSet):
    """(out_deg, in_deg, only_to, only_mult, max_in_mult) over live
    arcs; only_to/only_mult are meaningful where out_deg == 1, and
    max_in_mult is the int32 minimum for an edge with no live in-arc."""
    e_cap = eg.length.shape[0]
    live_arc = _live_arcs(eg, aset)
    f = torch.where(live_arc, aset.from_ed, e_cap)
    out_deg = segment_sum(live_arc.long(), f, e_cap)
    only_to = torch.full((e_cap + 1,), -1, dtype=torch.int64,
                         device=f.device)
    only_to[f] = torch.where(live_arc, aset.to_ed, -1)
    only_mult = torch.zeros_like(only_to)
    only_mult[f] = torch.where(live_arc, aset.mult, 0)
    in_deg = gather_or(out_deg, eg.twin, 0)
    max_in_mult = torch.full_like(only_to, _INT32_MIN).scatter_reduce_(
        0, torch.where(live_arc, aset.to_ed, e_cap),
        torch.where(live_arc, aset.mult, 0), "amax", include_self=True)
    return out_deg, in_deg, only_to[:e_cap], only_mult[:e_cap], \
        max_in_mult[:e_cap]


def _cut_tips_once(eg, aset: arcs_mod.ArcSet, cut_len: int):
    """One tip-clipping round: (new deleted mask, edges clipped as a
    device scalar)."""
    e_cap = eg.length.shape[0]
    me = torch.arange(e_cap, device=eg.length.device)
    live = _live(eg) & ~eg.deleted
    out_deg, in_deg, only_to, only_mult, max_in_mult = \
        _edge_chain_state(eg, aset)

    # chain membership: edges walked while in<=1 & out<=1
    walkable = live & (in_deg <= 1) & (out_deg <= 1) & (eg.twin != me)
    head_cand = walkable & (in_deg == 0)
    # prev pointer along unique-arc linkage within walkable set
    nxt = torch.where(walkable & (out_deg == 1), only_to, -1)
    nxt = torch.where(gather_or(walkable, nxt, False), nxt, -1)
    prev = torch.full((e_cap + 1,), -1, dtype=torch.int64, device=me.device)
    prev[torch.where(nxt >= 0, nxt, e_cap)] = me
    prev = torch.where(walkable & (in_deg == 1), prev[:e_cap], -1)
    head, rank, _ = ranking.list_rank(prev, walkable)

    on_tip = walkable & gather_or(head_cand, head, False)
    tip_head = torch.where(on_tip, head, e_cap)
    tip_len = segment_sum(torch.where(on_tip, eg.length, 0), tip_head, e_cap)
    n_members = segment_sum(on_tip.long(), tip_head, e_cap)
    short = gather_or(tip_len, head, 1 << 30) < cut_len

    is_last = on_tip & (rank == gather_or(n_members, head, 0) - 1)
    join = torch.where(is_last & (out_deg == 1), only_to, -1)
    join_mult = torch.where(is_last, only_mult, 0)
    # dominance at the join: the tip survives if its arc into the join
    # is the unique strongest in-arc (isUnreliableTip caseD/E)
    jmax = gather_or(max_in_mult, join, 0)
    join_in = gather_or(in_deg, join, 0)
    clip = is_last & short & (
        (join < 0)                      # dangles into nothing (caseB)
        | (join_in < 2)                 # joins a non-branch (caseC-ish)
        | (join_mult == 1)              # caseD
        | (jmax > join_mult)            # caseE
    )
    clip_at_head = scatter_true(e_cap, torch.where(clip, head, e_cap))
    doomed = on_tip & gather_or(clip_at_head, head, False)
    doomed = doomed | gather_or(doomed, eg.twin, False)
    return eg.deleted | doomed, (doomed & ~eg.deleted).sum()


def cut_tips(eg, aset: arcs_mod.ArcSet, k: int,
             cut_len: int = 0, max_rounds: int = MAX_ROUNDS):
    """cutTipsInGraph(0, 0): fixpoint tip clipping, cut_len = 2K."""
    cut_len = cut_len or 2 * k
    total = 0
    for _ in range(max_rounds):
        deleted, n = _cut_tips_once(eg, aset, cut_len)
        n = int(n)
        eg = eg._replace(deleted=deleted)
        total += n
        if n == 0:
            break
    print(f"[edge_clean] tips: {total} edges removed")
    return eg


def delete_short_components(eg, aset: arcs_mod.ArcSet,
                            cutoff: int = SHORT_COMPONENT,
                            max_rounds: int = MAX_ROUNDS):
    """deleteShortContig: drop whole weakly-connected components whose
    total edge length (counting each twin pair once) is < cutoff."""
    e_cap = eg.length.shape[0]
    me = torch.arange(e_cap, device=eg.length.device)
    live = _live(eg) & ~eg.deleted
    label = torch.where(live, me, e_cap)
    live_arc = _live_arcs(eg, aset)
    f = torch.where(live_arc, aset.from_ed, 0)
    t = torch.where(live_arc, aset.to_ed, 0)
    f_or_drop = torch.where(live_arc, f, e_cap)
    t_or_drop = torch.where(live_arc, t, e_cap)
    drop_slot = label.new_full((1,), e_cap)

    def propagate(label):
        # min-label over arc neighbors (both directions) and twin
        lt = torch.where(live_arc, label[t], e_cap)
        lf = torch.where(live_arc, label[f], e_cap)
        new = torch.cat([label, drop_slot])
        new.scatter_reduce_(0, f_or_drop, lt, "amin", include_self=True)
        new.scatter_reduce_(0, t_or_drop, lf, "amin", include_self=True)
        new = new[:e_cap]
        tw_lab = torch.where(live, gather_or(new, eg.twin, e_cap), e_cap)
        return torch.where(live, torch.minimum(new, tw_lab), e_cap)

    for _ in range(max_rounds):
        new = propagate(label)
        if bool((new == label).all()):
            break
        label = new

    # component length, counting each twin pair once
    counted = live & (me <= eg.twin)
    comp_len = segment_sum(torch.where(counted, eg.length, 0),
                           torch.where(live, label, e_cap), e_cap)
    doomed = live & (gather_or(comp_len, label, 1 << 30) < cutoff)
    n = int(doomed.sum())
    print(f"[edge_clean] short components (<{cutoff}bp): {n} edges removed")
    return eg._replace(deleted=eg.deleted | doomed)


def compact_arcs(aset: arcs_mod.ArcSet, eg) -> arcs_mod.ArcSet:
    """removeArc/removeDeadArcs: drop zero-mult arcs and arcs touching
    deleted edges (the table is re-sorted without them)."""
    dead = (aset.mult <= 0) | (aset.from_ed < 0) | \
        gather_or(eg.deleted, aset.from_ed, True) | \
        gather_or(eg.deleted, aset.to_ed, True)
    return rebuild_arcs(torch.where(dead, -1, aset.from_ed),
                        torch.where(dead, -1, aset.to_ed),
                        torch.where(dead, 0, aset.mult), eg.twin)
