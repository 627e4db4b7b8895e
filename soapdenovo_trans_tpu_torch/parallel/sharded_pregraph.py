"""Mesh-resident pregraph passes: DBG build, k-mer cleaning, unitig
condensation and read -> preArc threading over the SHARDED k-mer table.

Port of ``soapdenovo_trans_tpu/parallel/sharded_pregraph.py``: the
sharded twins of graph/dbg.py, graph/kmer_clean.py, graph/unitigs.py
and graph/arcs.thread_reads — same semantics, but the table never
leaves the mesh (parallel/sharded_count.py keeps it resident).
Cross-shard access goes through the routed primitives of
parallel/sharded_graph.py.

Id spaces (shard s of D; ``cap`` rows a shard, ``ShardedTable.cap``):

* global row      g = s*cap + i
* directed node   u = 2*g + orient       (twin(u) = u^1, same shard)
* node arrays     a list of D (2*cap, ...) tensors — node u is entry
                  u % (2cap) of shard u // (2cap)
* arc             a = (u // 2cap)*8cap + (u % 2cap)*4 + b — arcs live
                  on their tail node's shard

All ids are int64.  No output depends on ``cap``: edge ids come from
the shard-major order of the head arcs and the mini table from the
ascending global row, which is key order, so a table padded to a larger
``cap`` condenses to the same edge graph.

The outputs that are small beside the table (the condensed edge graph,
its sequence pool, the preArc candidates) are gathered to ONE device,
the first shard's; everything table-sized stays sharded.  The
O(edges) bookkeeping of ``condense_sharded`` is numpy on the host, as
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph import arcs as arcs_mod
from ..graph import dbg as dbg_mod
from ..graph import unitigs
from ..ops import bits, dictionary, kmer
from ..ops.index import gather_or
from . import sharded_graph
from .mesh import Mesh, Sharded
from .sharded_count import ShardedTable


class ShardedDBG(NamedTuple):
    """Directed-node de Bruijn view, sharded by node (twin-colocated).

    The fields of graph/dbg.DBG as (2cap, ...) tensors a shard, with
    ``succ`` holding GLOBAL directed ids (or -1 for missing or dead
    successors: the routed lookup filters dead rows, which folds
    dbg.py's succ_live check in)."""

    out_cov: Sharded     # (2cap, 4) int32
    succ: Sharded        # (2cap, 4) int64 global directed id or -1
    exists: Sharded      # (2cap, 4) bool
    out_deg: Sharded     # (2cap,) int64
    in_deg: Sharded      # (2cap,) int64
    linear: Sharded      # (2cap,) bool
    first_base: Sharded  # (2cap,) int64
    live: Sharded        # (2cap,) bool


class Routers(NamedTuple):
    row: sharded_graph.Router
    node: sharded_graph.Router
    arc: sharded_graph.Router
    cap: int

    @classmethod
    def build(cls, mesh: Mesh, cap: int) -> "Routers":
        return cls(sharded_graph.Router(mesh, cap),
                   sharded_graph.Router(mesh, 2 * cap),
                   sharded_graph.Router(mesh, 8 * cap), cap)


def _w(cond: Sharded, a, b) -> Sharded:
    """Per-shard ``torch.where``; ``a`` and ``b`` are sharded or plain
    scalars."""
    def pick(x, s):
        return x[s] if isinstance(x, (list, tuple)) else x

    return [torch.where(c, pick(a, s), pick(b, s))
            for s, c in enumerate(cond)]


def _swap_orient(x: torch.Tensor) -> torch.Tensor:
    """Node array (2cap, ...) with every node's entry replaced by its
    twin's: the two orientations of a row are neighbours."""
    return x.view((-1, 2) + x.shape[1:]).flip(1).reshape(x.shape)


def _first_set(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return mask.to(torch.int8).argmax(-1)


def _take(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, col[..., None])[..., 0]


# ---------------------------------------------------------------------------
# DBG build
# ---------------------------------------------------------------------------


def _out_cov(l_cov, r_cov) -> torch.Tensor:
    """(2cap, 4) coverage of every arc slot: slot (2i, b) <- r_cov[i, b]
    (fwd node), (2i+1, b) <- l_cov[i, comp(b)] (rc node); comp(b) =
    b^2."""
    return torch.stack([r_cov, l_cov[:, [2, 3, 0, 1]]], 1).reshape(-1, 4)


def _local_candidates(keys, live_row, l_cov, r_cov, k: int):
    """Successor-candidate queries of a block of table rows: orient
    (fwd + revcomp), extend by every base, canonicalize.  Dead sources
    and arc slots without coverage need no successor (no arc can
    exist there): their queries are sentinels, which go to no shard."""
    w = keys.shape[-1]
    ori = torch.stack([keys, bits.reverse_complement(keys, k)],
                      1).reshape(-1, w)
    m = ori.shape[0]
    base4 = torch.arange(4, device=keys.device).expand(m, 4)
    ext = bits.next_kmer(ori[:, None, :].expand(m, 4, w), base4, k)
    can, use_rc = bits.canonical(ext.reshape(-1, w), k)
    ask = live_row.repeat_interleave(8) & \
        (_out_cov(l_cov, r_cov).reshape(-1) > 0)
    return torch.where(ask[:, None], can, dictionary.SENTINEL), use_rc


def build_dbg_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                      deleted: Sharded, k: int) -> ShardedDBG:
    """Sharded twin of dbg.build_dbg: routed lookups resolve the
    2*cap*4 successor candidates of every shard, a block of table rows
    at a time (which bounds the queries' memory, as in the dense
    path)."""
    cap = routers.cap
    live_row = mesh.map(
        lambda s, d_s: (torch.arange(cap, device=d_s.device) < st.n[s])
        & ~d_s, deleted)
    rows, use_rc = [[] for _ in range(mesh.d)], [[] for _ in range(mesh.d)]
    for off in range(0, cap, dbg_mod._CHUNK_ROWS):
        blk = slice(off, off + dbg_mod._CHUNK_ROWS)
        can, rc = zip(*mesh.map(
            lambda s, keys, live, l_cov, r_cov: _local_candidates(
                keys[blk], live[blk], l_cov[blk], r_cov[blk], k),
            st.keys, live_row, st.l_cov, st.r_cov))
        got = routers.row.lookup(st.keys, st.n, deleted, list(can), k=k)
        for s in range(mesh.d):
            rows[s].append(got[s])
            use_rc[s].append(rc[s])

    def assemble(s, keys, l_cov, r_cov, live_r):
        r = torch.cat(rows[s])
        succ = torch.where(r >= 0, 2 * r + torch.cat(use_rc[s]), -1)
        succ = succ.view(2 * cap, 4)
        live = live_r.repeat_interleave(2)
        out_cov = _out_cov(l_cov, r_cov)
        exists = (out_cov > 0) & (succ >= 0) & live[:, None]
        succ = torch.where(exists, succ, -1)
        out_deg = exists.sum(-1)
        in_deg = _swap_orient(out_deg)
        linear = (out_deg == 1) & (in_deg == 1) & live
        oriented = torch.stack([keys, bits.reverse_complement(keys, k)],
                               1).reshape(2 * cap, -1)
        fb = bits.first_base(oriented, k).to(torch.int64)
        return out_cov, succ, exists, out_deg, in_deg, linear, fb, live

    return ShardedDBG(*(list(x) for x in zip(*mesh.map(
        assemble, st.keys, st.l_cov, st.r_cov, live_row))))


# ---------------------------------------------------------------------------
# arc-id arithmetic over the sharded layout
# ---------------------------------------------------------------------------


def arc_of(u_global, b, cap: int):
    """Global arc id of (global directed node, base)."""
    s = u_global // (2 * cap)
    loc = u_global % (2 * cap)
    return s * (8 * cap) + loc * 4 + b


def arc_tail(a_global, cap: int):
    """Global directed node owning arc a (its tail)."""
    s = a_global // (8 * cap)
    return s * (2 * cap) + (a_global % (8 * cap)) // 4


def twin_arc_local(dbg: ShardedDBG, cap: int) -> Sharded:
    """(2cap, 4) global twin-arc ids a shard — local arithmetic only:
    twin(succ(u,b)) --comp(first_base(u))--> (dbg.twin_arc)."""
    return [torch.where(v >= 0, arc_of(v ^ 1, fb[:, None] ^ 2, cap), -1)
            for v, fb in zip(dbg.succ, dbg.first_base)]


# ---------------------------------------------------------------------------
# k-mer cleaning (sharded kmer_clean)
# ---------------------------------------------------------------------------


def _mark_deleted(mesh: Mesh, deleted: Sharded, hits: Sharded):
    """(deleted | hits, number of rows newly deleted)."""
    fresh = mesh.to_host([(h & ~d_s).sum() for h, d_s in zip(hits, deleted)])
    return [d_s | h for d_s, h in zip(deleted, hits)], \
        int(sum(int(x) for x in fresh))


def minor_out_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                      deleted: Sharded, k: int, pct: int):
    """Sharded removeMinorOut (kmer_clean.minor_out)."""
    dbg = build_dbg_sharded(mesh, routers, st, deleted, k)
    succ_row = [torch.where(v >= 0, v >> 1, -1).reshape(-1)
                for v in dbg.succ]
    ncount = routers.row.gather1(st.count, succ_row)

    def weak_rows(s, nc, exists, out_deg, srow):
        nc = torch.where(exists, nc.view(-1, 4), 0)
        max_n = nc.amax(-1, keepdim=True)
        weak = exists & (out_deg > 1)[:, None] & (nc > 0) & \
            (100 * nc < pct * max_n)
        return torch.where(weak.reshape(-1), srow, -1)

    del_rows = mesh.map(weak_rows, ncount, dbg.exists, dbg.out_deg, succ_row)
    hits = routers.row.scatter1(
        del_rows, [torch.ones_like(x) for x in del_rows], op="or")
    return _mark_deleted(mesh, deleted, [h > 0 for h in hits])


def _tip_pass_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                      deleted: Sharded, k: int, thin: bool):
    """Sharded twin of kmer_clean._tip_pass."""
    cap = routers.cap
    node = routers.node
    dbg = build_dbg_sharded(mesh, routers, st, deleted, k)

    def chain_links(s, count, exists, succ, out_deg, in_deg, linear, live):
        single = count.repeat_interleave(2) == 1
        elig = linear & live
        head_cand = live & (in_deg == 0) & (out_deg == 1)
        if thin:
            elig = elig & single
            head_cand = head_cand & single
        # predecessor: twin of the twin node's unique out-arc
        tb = _first_set(_swap_orient(exists))
        v = _take(_swap_orient(succ), tb)
        pred = torch.where((in_deg == 1) & (v >= 0), v ^ 1, -1)
        member = elig | head_cand
        return elig, head_cand, member, pred, \
            torch.stack([member.to(torch.int64), out_deg], -1)

    elig, head_cand, member, pred, member_deg = zip(*mesh.map(
        chain_links, st.count, dbg.exists, dbg.succ, dbg.out_deg,
        dbg.in_deg, dbg.linear, dbg.live))
    pm = node.gather(list(member_deg), list(pred))
    prev = [torch.where(e & (p >= 0) & (g[:, 0] > 0) & (g[:, 1] == 1) & m,
                        p, -1)
            for e, p, g, m in zip(elig, pred, pm, member)]
    head, rank, _is_head = sharded_graph.sharded_list_rank(
        node, prev, list(member))

    head_of_member = _w(member, head, -1)
    chain_ok = node.gather1([h.to(torch.int64) for h in head_cand],
                            head_of_member)
    on_tip = [m & (c > 0) for m, c in zip(member, chain_ok)]
    tip_head = _w(on_tip, head, -1)
    chain_len = node.scatter1(
        tip_head, [torch.where(t, r + 1, 0) for t, r in zip(on_tip, rank)],
        op="max")
    chain_len = [c.clamp(min=0) for c in chain_len]
    len_at_head = node.gather1(chain_len, tip_head)

    def join_of(s, t, r, ln, exists, succ, out_cov):
        is_last = t & (r == ln - 1)
        lb = _first_set(exists)
        join = torch.where(is_last, _take(succ, lb), -1)
        join_cov = torch.where(is_last, _take(out_cov, lb).to(torch.int64),
                               0)
        return is_last, join, join_cov

    is_last, join, join_cov = zip(*mesh.map(
        join_of, on_tip, rank, len_at_head, dbg.exists, dbg.succ,
        dbg.out_cov))
    jg = node.gather(
        [torch.stack(x, -1) for x in zip(dbg.in_deg, dbg.out_deg)],
        list(join))
    join_max_in = node.gather1(
        [c.amax(-1).to(torch.int64) for c in dbg.out_cov],
        [torch.where(j >= 0, j ^ 1, -1) for j in join])

    def clip(s, last, j, jcov, g, jmax):
        has = j >= 0
        join_dangling = last & has & \
            (torch.where(has, g[:, 0] + g[:, 1], 0) == 1)
        if thin:
            clip_here = last & has
        else:
            clip_here = last & has & (join_dangling | (jcov < jmax))
        # a tip with no join at all (isolated chain) — clip it too
        return clip_here | (last & ~has), join_dangling

    clip_here, join_dangling = zip(*mesh.map(
        clip, is_last, join, join_cov, jg, join_max_in))
    clip_at_head = node.scatter1(
        _w(clip_here, head, -1), [torch.ones_like(h) for h in head],
        op="or")
    ok_head = [((c > 0) & (ln <= 2 * k)).to(torch.int64)
               for c, ln in zip(clip_at_head, chain_len)]
    head_ok = node.gather1(ok_head, tip_head)
    doomed = [t & (h > 0) for t, h in zip(on_tip, head_ok)]
    ok_at_me = node.gather1(ok_head, _w(is_last, head, -1))
    # joins of dangling single-link components die with the chain
    join_rows = [torch.where(jd & (ok > 0) & (j >= 0), j >> 1, -1)
                 for jd, ok, j in zip(join_dangling, ok_at_me, join)]
    join_hits = routers.row.scatter1(
        join_rows, [torch.ones_like(x) for x in join_rows], op="or")
    # node doom -> row deletion (a local fold over the two orientations)
    hits = [dm.view(cap, 2).any(-1) | (jh > 0)
            for dm, jh in zip(doomed, join_hits)]
    return _mark_deleted(mesh, deleted, hits)


def clip_tip_kmers_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                           deleted: Sharded, k: int, minor_pct: int = 5,
                           skip_single: bool = False,
                           max_rounds: int = 32) -> Sharded:
    """Sharded kmer_clean.clip_tip_kmers (pregraph.c:69-89 order)."""
    deleted, n = minor_out_sharded(mesh, routers, st, deleted, k, minor_pct)
    print(f"[kmer_clean] minor-out: {n} kmers removed")
    if not skip_single:
        deleted, n = _tip_pass_sharded(mesh, routers, st, deleted, k, True)
        print(f"[kmer_clean] single-cov tips: {n} kmers removed")
    total = 0
    for _ in range(max_rounds):
        deleted, n = _tip_pass_sharded(mesh, routers, st, deleted, k, False)
        total += n
        if n == 0:
            break
    print(f"[kmer_clean] minor tips: {total} kmers removed")
    return deleted


# ---------------------------------------------------------------------------
# condensation (sharded unitigs.condense) -> EdgeGraph + mini table
# ---------------------------------------------------------------------------


def _host_ids(mesh: Mesh, xs: Sharded, n: int) -> np.ndarray:
    """The first n entries of the shard-major concatenation, on the
    host."""
    return mesh.gather_rows(xs, "cpu").numpy()[:n]


def condense_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                     deleted: Sharded, k: int,
                     dbg: ShardedDBG | None = None):
    """Sharded unitigs.condense.  Returns (EdgeGraph on the first
    shard's device with node ids into a mini endpoint table, the mini
    KmerTable, node_edge and node_pos: (2cap,) a shard, the global edge
    and the 1-based position of every interior node) — the last two
    stay sharded for read threading.

    All table-sized reductions (per-edge length, endpoints, coverage
    and the sequence-pool scatter) run on the mesh through edge-sharded
    and pool-sharded Routers; what comes to the host is O(edges), and
    the sequence pool (one byte a base)."""
    cap = routers.cap
    d = mesh.d
    if dbg is None:
        dbg = build_dbg_sharded(mesh, routers, st, deleted, k)
    two_cap, m_arc = 2 * cap, 8 * cap

    exists = [e.reshape(-1) for e in dbg.exists]
    succ = [v.reshape(-1) for v in dbg.succ]
    twin_arcs = twin_arc_local(dbg, cap)

    def backward(s, ex, ex_flat, tw_arcs, linear):
        # unique in-arc per node (local, as in the tip pass)
        tb = _first_set(_swap_orient(ex))
        node_in_arc = _take(_swap_orient(tw_arcs), tb)
        return torch.where(ex_flat & linear.repeat_interleave(4),
                           node_in_arc.repeat_interleave(4), -1)

    arc_prev = mesh.map(backward, dbg.exists, exists, twin_arcs, dbg.linear)
    # a predecessor pointer must reference an existing arc
    prev_exists = routers.arc.gather1(
        [e.to(torch.int64) for e in exists], arc_prev)
    arc_prev = [torch.where(pe > 0, p, -1)
                for pe, p in zip(prev_exists, arc_prev)]
    head, rank, is_head = sharded_graph.sharded_list_rank(
        routers.arc, arc_prev, exists)

    # global edge ids: local cumsum + exclusive shard prefix
    local_counts = [int(x) for x in mesh.to_host(
        [h.sum() for h in is_head])]
    prefix = np.concatenate([[0], np.cumsum(local_counts)[:-1]])
    n_edges = int(sum(local_counts))
    e_cap = max(n_edges, 1)
    eid_here = [torch.where(h, torch.cumsum(h, 0) - 1 + int(prefix[s]), -1)
                for s, h in enumerate(is_head)]
    edge_of = routers.arc.gather1(eid_here, _w(exists, head, -1))
    edge_of = _w(exists, edge_of, -1)

    # edge-level reductions ride the mesh: edges get their own
    # contiguously sharded id space (global edge e lives on shard
    # e // e_loc), and every per-edge statistic is one routed
    # segment-scatter
    e_loc = -(-e_cap // d)
    edge_router = sharded_graph.Router(mesh, e_loc)

    def to_host(acc, fill):
        return np.maximum(_host_ids(mesh, acc, e_cap), fill)

    length_sh = [x.clamp(min=0) for x in edge_router.scatter1(
        edge_of, [r + 1 for r in rank], op="max")]
    length = to_host(length_sh, 0)

    tail_u = mesh.map(lambda s, ex: s * two_cap + torch.arange(
        m_arc, device=ex.device) // 4, exists)
    arc_ids = mesh.map(lambda s, ex: s * m_arc + torch.arange(
        m_arc, device=ex.device), exists)
    from_node = to_host(edge_router.scatter1(
        _w(is_head, edge_of, -1), tail_u, op="max"), -1)
    len_at_arc = edge_router.gather1(length_sh, edge_of)
    is_last = [e & (r == ln - 1)
               for e, r, ln in zip(exists, rank, len_at_arc)]
    last_edge = _w(is_last, edge_of, -1)
    to_node = to_host(edge_router.scatter1(last_edge, succ, op="max"), -1)
    last_arc = to_host(edge_router.scatter1(last_edge, arc_ids, op="max"),
                       -1)

    # twin edge: eid at the head of the twin arc of the last arc
    def routed(router, x, ids):
        return _host_ids(mesh, router.gather1(x, mesh.split_rows(ids)),
                         ids.shape[0])

    la_tail = arc_tail(np.maximum(last_arc, 0), cap)
    la_succ = routed(routers.arc, succ, last_arc)
    la_fb = routed(routers.node, dbg.first_base,
                   np.where(last_arc >= 0, la_tail, -1))
    twin_head_arc = np.where(
        (last_arc >= 0) & (la_succ >= 0),
        arc_of(la_succ ^ 1, la_fb ^ 2, cap), -1)
    th_head = routed(routers.arc, head, twin_head_arc)
    twin_eid = routed(routers.arc, eid_here,
                      np.where(twin_head_arc >= 0, th_head, -1))

    # sequence pool: routed scatter into a pool-sharded array — pool
    # slot seq_off[edge] + rank is written exactly once per arc, so a
    # max-scatter is a plain store
    seq_off = np.cumsum(length) - length
    s_cap = max(int(length.sum()), 1)
    pool_router = sharded_graph.Router(mesh, -(-s_cap // d))
    off_pad = np.full(d * e_loc, -1, np.int64)
    off_pad[:e_cap] = np.where(length > 0, seq_off, -1)
    off_at_arc = edge_router.gather1(mesh.split_rows(off_pad), edge_of)
    pool_idx = [torch.where(e & (eo >= 0) & (oa >= 0), oa + r, -1)
                for e, eo, oa, r in zip(exists, edge_of, off_at_arc, rank)]
    base = mesh.map(lambda s, ex: torch.arange(
        m_arc, device=ex.device) & 3, exists)
    pool_sh = pool_router.scatter1(pool_idx, base, op="max")
    # one byte a base on the way to the first device
    seq_pool = mesh.gather_rows(
        [x.clamp(min=0).to(torch.uint8) for x in pool_sh])[:s_cap]

    # coverage: interior-node l_cov sums routed per arc
    interior = [e & (r + 1 < ln)
                for e, r, ln in zip(exists, rank, len_at_arc)]
    int_cov = routers.row.gather1(
        [x.sum(-1, dtype=torch.int64) for x in st.l_cov],
        [torch.where(i, v >> 1, -1) for i, v in zip(interior, succ)])
    int_edge = _w(interior, edge_of, -1)
    symbol = to_host(edge_router.scatter1(
        int_edge, _w(interior, int_cov, 0), op="add"), 0)
    from_count = routed(routers.row, [c.to(torch.int64) for c in st.count],
                        np.where(from_node >= 0, from_node >> 1, -1))
    cvg = np.clip(np.where(
        length > 1, symbol // np.maximum(length - 1, 1) * 10,
        np.maximum(from_count, 0) * 10), 0, unitigs.MAX_EDGE_COV)

    # interior-node -> (edge, pos) map, sharded (for read threading);
    # every interior node is written once
    ne = routers.node.scatter(
        _w(interior, succ, -1),
        [torch.stack([e, torch.where(i, r + 1, -1)], -1)
         for e, i, r in zip(int_edge, interior, rank)], op="max")
    node_edge = [x[:, 0].clamp(min=-1) for x in ne]
    node_pos = [x[:, 1].clamp(min=-1) for x in ne]

    eg, table = _build_mini_edgegraph(
        mesh, routers, st, n_edges, from_node, to_node, length, cvg,
        twin_eid, seq_off, seq_pool)
    return eg, table, node_edge, node_pos


def _build_mini_edgegraph(mesh: Mesh, routers: Routers, st: ShardedTable,
                          n_edges: int, from_node, to_node, length, cvg,
                          twin_eid, seq_off, seq_pool):
    """Gather the endpoint k-mers into a dense mini KmerTable and remap
    the edge endpoints into it (the compatibility-table trick of
    io/graph_files.load_contig_graph_files)."""
    dev = mesh.devices[0]
    ends = np.concatenate([from_node, to_node])
    uniq_rows = np.unique(ends[ends >= 0] >> 1)
    # the routed gather returns the rows in uniq_rows (global id) order,
    # which is key order (prefix shards): the mini table is sorted
    mini_keys = mesh.gather_rows(routers.row.gather(
        st.keys, mesh.split_rows(uniq_rows)), dev)
    n_mini = uniq_rows.size
    mini_cap = max(n_mini, 1)

    def remap(nodes):
        mini = np.searchsorted(uniq_rows, np.where(nodes >= 0, nodes >> 1, 0))
        return np.where(nodes >= 0, 2 * mini + (nodes & 1), -1)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    table = dictionary.KmerTable(
        dictionary._pad_to_one(mini_keys, dictionary.SENTINEL),
        zeros(mini_cap, torch.int32), zeros((mini_cap, 4), torch.int32),
        zeros((mini_cap, 4), torch.int32), n_mini,
        zeros(mini_cap, torch.bool))

    live_e = np.arange(length.shape[0]) < n_edges

    def put(x, dead):
        return torch.from_numpy(np.where(live_e, x, dead).astype(np.int64)
                                ).to(dev)

    unused = torch.full((2 * mini_cap,), -1, dtype=torch.int64, device=dev)
    eg = unitigs.EdgeGraph(
        put(remap(from_node), -1), put(remap(to_node), -1), put(length, 0),
        put(cvg, 0), put(twin_eid, -1),
        torch.from_numpy(seq_off.astype(np.int64)).to(dev), seq_pool,
        n_edges, unused, unused.clone(),  # node_edge/node_pos: sharded
        zeros(length.shape[0], torch.bool))
    return eg, table


def kmer_freq_sharded(mesh: Mesh, st: ShardedTable, deleted: Sharded,
                      max_freq: int = 256) -> np.ndarray:
    """.kmerFreq histogram over the resident shards (freqStat,
    prlHashReads.c:994): per-shard bincount partials, summed on the
    host — the table never gathers."""
    def step(s, count, del_s):
        live = (torch.arange(count.shape[0], device=count.device)
                < st.n[s]) & ~del_s
        return torch.bincount(
            count[live].clamp(0, max_freq - 1).to(torch.int64),
            minlength=max_freq)

    return np.sum(mesh.to_host(mesh.map(step, st.count, deleted)), axis=0)


# ---------------------------------------------------------------------------
# read -> preArc threading over the sharded table
# ---------------------------------------------------------------------------


def _thread_local(eid_flat, stream, stream1, lengths, patch_keys,
                  patch_edge, eg_twin, r: int, p: int, k: int):
    """Per-read path-slot logic given resolved edge ids — the local part
    of arcs.thread_reads (see that docstring for the semantics);
    ``eid_flat`` is -2 for a dead or missing node, so that barriers
    form."""
    valid = stream.valid
    node_live = eid_flat > -2
    eid = torch.where(valid & node_live, eid_flat, -1)
    interior = (eid >= 0).view(r, p)
    vertexish = (valid & node_live & (eid < 0)).view(r, p)
    in_read = (torch.arange(p, device=eid.device)[None, :] + k) <= \
        lengths[:, None]
    barrier = in_read & ~(valid & node_live).view(r, p)
    eid = eid.view(r, p)

    pedge = gather_or(
        patch_edge, dictionary.lookup(patch_keys, stream1.kmers), -1)
    pedge = torch.where(
        (pedge >= 0) & stream1.is_rc,
        gather_or(eg_twin, pedge.clamp(min=0), -1), pedge)
    pedge = torch.where(stream1.valid, pedge, -1).view(r, p - 1)
    pair_ok = vertexish[:, :-1] & vertexish[:, 1:] & (pedge >= 0)
    pair_eid = torch.where(pair_ok, pedge, -1)

    prev_same = torch.zeros_like(interior)
    prev_same[:, 1:] = interior[:, :-1] & (eid[:, :-1] == eid[:, 1:])
    return arcs_mod._path_slots(
        torch.where(interior & ~prev_same, eid, -1), pair_eid, barrier)


def thread_reads_sharded(mesh: Mesh, routers: Routers, st: ShardedTable,
                         deleted: Sharded, node_edge: Sharded, eg, patch,
                         seqs, lengths, k: int):
    """Sharded arcs.thread_reads: a routed lookup and a routed
    node_edge gather resolve the read k-mers to edge ids; the path logic
    is local per read and runs where the read block lies, with the patch
    table and the edge twins copied once to every distinct device.

    seqs (R, L) uint8 / lengths (R,): host arrays; the rows are split
    into D contiguous blocks (the last ones padded with empty reads).
    Returns (from_ed, to_ed, valid) over the ``ceil(R / D) * D`` rows in
    read order, on the first shard's device, for arcs.count_arcs."""
    l = seqs.shape[1]
    p = l - k + 1
    seqs_d = mesh.split_rows(seqs, fill=4)
    lens_d = [x.to(torch.int64) for x in mesh.split_rows(lengths, fill=0)]
    r_loc = seqs_d[0].shape[0]

    streams = mesh.map(lambda s, sq, ln: kmer.chop_reads(sq, ln, k),
                       seqs_d, lens_d)
    rows = routers.row.lookup(
        st.keys, st.n, deleted,
        [torch.where(x.valid[:, None], x.kmers, dictionary.SENTINEL)
         for x in streams], k=k)
    eid_g = routers.node.gather1(
        node_edge, [torch.where(r >= 0, 2 * r + x.is_rc, -1)
                    for r, x in zip(rows, streams)])
    # "dead or missing node" is -2, so that barriers form
    eid_flat = [torch.where(r >= 0, g.clamp(min=-1), -2)
                for r, g in zip(rows, eid_g)]

    out = mesh.map(
        lambda s, eid, x, sq, ln, pk, pe, tw: _thread_local(
            eid, x, kmer.chop_reads(sq, ln, k + 1), ln, pk, pe, tw,
            r_loc, p, k),
        eid_flat, streams, seqs_d, lens_d, mesh.replicate(patch.keys),
        mesh.replicate(patch.edge), mesh.replicate(eg.twin))
    return tuple(mesh.gather_rows([o[i] for o in out]) for i in range(3))
