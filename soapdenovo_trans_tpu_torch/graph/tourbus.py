"""Wave-parallel Tour-Bus bubble pass.

Port of ``soapdenovo_trans_tpu/graph/tourbus.py``.  Reference behaviour
being reproduced (not its algorithm): bubblePinch (src/bubble.c:
2048-2135) Dijkstras from every edge, backtracks when a node is reached
twice (comparePaths, :1766, bounded by MAXNODELENGTH), aligns the two
path sequences (compareSequences, :425-497, >= 90% identity, length
difference <= DIFF) and merges the minority path onto the majority
(cleanUpRedundancy, :1617).  -M levels: M <= 1 -> MAXNODELENGTH 3 /
DIFF 2, M == 2 -> 9/3, M >= 3 -> 30/10 (:2072-2086).

One wave, over flat arrays:

1. majority forest: every live edge t picks prev[t] = its
   heaviest-coverage predecessor (one sort over the arc table);
2. every non-forest arc (u -> t) is a bubble candidate: walking
   <= MAXNODELENGTH steps up the forest from t and from u and
   intersecting the two chains gives the fork s and the two paths;
3. the two paths' sequences are scored by LCS: accept iff LCS >= 90%
   of the longer and |lenA - lenB| <= DIFF (``lcs.identity_check``);
4. accepted candidates claim their edges (scatter-min arbitration);
   claim-disjoint winners apply together: minority edges (and twins)
   deleted, their coverage added onto the covering majority edges,
   their arcs remapped onto the majority path.

Waves repeat to a fixpoint like the reference's HasChanged loop
(:2123).  Inside a wave the host reads nothing; ``pinch`` reads the
wave's four counts once per wave.  As the JAX package jits ``_wave`` and
keeps the arc table at a rounded capacity so one compiled wave serves
wave after wave, a pinch runs its waves as one program over buffers of
fixed shapes (``WaveProgram``): on a card the first wave runs eagerly,
the second is captured into a CUDA graph, and every later wave replays
it.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Tuple

import torch

from ..kernels import lcs
from . import arcs as arcs_mod
from . import unitigs
from .edge_clean import _gather_or, _scatter_true, rebuild_arcs

SEQ_CAP = 384    # longest differing-path sequence considered per side
CAND_CAP = 1024  # candidates arbitrated per wave (rest -> next wave)
_BIG = 2**30

CAPTURES = 0  # CUDA graphs captured since the last reset (one a pinch)
REPLAYS = 0   # waves run as replays of a captured graph since the reset


def _params_for(merge_level: int) -> Tuple[int, int]:
    """(MAXNODELENGTH, DIFF) per -M (bubble.c:2072-2086)."""
    if merge_level <= 1:
        return 3, 2
    if merge_level == 2:
        return 9, 3
    return 30, 10


def _lcs_scores(a, b, la, lb, cap: int):
    """LCS length between a[:la] and b[:lb] per batch row — the
    identity measure for compareSequences' F-matrix check
    (bubble.c:425-497): matches / max(len) >= 0.9 accepts.  One launch
    of the LCS kernel on the card (``kernels/lcs.py``).  The wave does
    not call it: ``lcs.identity_check`` is its whole identity check."""
    return lcs.lcs_scores(a, b, la, lb, cap)


def _take(x, idx):
    """take_along_axis over dim 1 with idx clamped into range."""
    return torch.gather(x, 1, idx.clamp(0, x.shape[1] - 1))


def _path_nodes(chain, s_idx, m_max: int, skip_last: int):
    """Interior nodes of a backward chain, re-ordered fork->join.

    chain[c, 0] is the join-side node, chain[c, s_idx[c]] the fork.
    Returns (C, m_max) node ids in PATH order (first-after-fork
    first), -1 padded.  skip_last=1 drops chain[0] (the majority
    chain starts at t, which is not part of the differing segment).
    """
    r = torch.arange(m_max, device=chain.device)[None, :]
    idx = s_idx[:, None] - 1 - r
    return torch.where(idx >= skip_last, _take(chain, idx), -1)


def _gather2(x, nodes, fill):
    return _gather_or(x, nodes.reshape(-1), fill).reshape(nodes.shape)


def _walk(prev, start, steps: int):
    """(C, steps): [start, prev(start), prev(prev(start)), ...]."""
    hist = [start]
    for _ in range(steps - 1):
        hist.append(_gather_or(prev, hist[-1], -1))
    return torch.stack(hist, 1)


def _majority_forest(aset, varc, cvg_f, e_cap: int):
    """prev[t] = the live predecessor of t with the highest coverage
    (lowest from-edge on ties): a sort on (to, -cvg, from), run as two
    stable passes because the three keys do not fit one int64."""
    to_k = torch.where(varc, aset.to_ed, _BIG)
    low = torch.where(varc, -cvg_f, 0) * (1 << 32) + \
        torch.where(varc, aset.from_ed, _BIG)
    o = torch.sort(low, stable=True).indices
    o = o[torch.sort(to_k[o], stable=True).indices]
    s_to, s_from = to_k[o], aset.from_ed[o]
    head = s_to < _BIG
    head[1:] &= s_to[1:] != s_to[:-1]
    prev = torch.full((e_cap + 1,), -1, dtype=torch.int64,
                      device=s_to.device)
    prev[torch.where(head, s_to, e_cap)] = s_from
    return prev[:e_cap]


def _wave(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, failed,
          m_max: int, diff: int, seq_cap: int, cand_cap: int):
    e_cap = eg.length.shape[0]
    dev = eg.length.device
    me = torch.arange(e_cap, device=dev)
    live_e = (me < eg.n_edges) & ~eg.deleted
    varc = (aset.from_ed >= 0) & (aset.to_ed >= 0) & (aset.mult > 0) & \
        _gather_or(live_e, aset.from_ed, False) & \
        _gather_or(live_e, aset.to_ed, False)

    # 1. majority forest
    cvg_f = _gather_or(eg.cvg, aset.from_ed, 0)
    prev = _majority_forest(aset, varc, cvg_f, e_cap)

    # 2. candidates: non-forest arcs not yet examined-and-rejected
    # since the last graph change, weakest minority first; the arc row
    # is the last key, so equal-coverage candidates keep row order
    tree = _gather_or(prev, aset.to_ed, -1) == aset.from_ed
    cand = varc & ~tree & ~failed
    n_cand = cand.sum()
    order = torch.sort(torch.where(cand, cvg_f, _BIG), stable=True).indices
    order = order[torch.sort((~cand[order]).to(torch.uint8),
                             stable=True).indices]
    cid_arc = order[:cand_cap]
    cmask = cand[cid_arc]
    u = torch.where(cmask, aset.from_ed[cid_arc], -1)
    t0 = torch.where(cmask, aset.to_ed[cid_arc], -1)

    # 3. backward chains up the forest, and their first meeting point
    chain_a = _walk(prev, t0, m_max + 2)   # t, a1, ..  (fork at index >= 1)
    chain_b = _walk(prev, u, m_max + 1)    # u, b1, ..
    la_n, lb_n = chain_a.shape[1], chain_b.shape[1]
    eq = (chain_a[:, :, None] == chain_b[:, None, :]) \
        & (chain_a[:, :, None] >= 0) & (chain_b[:, None, :] >= 0)
    ii = torch.arange(la_n, device=dev)[None, :, None]
    jj = torch.arange(lb_n, device=dev)[None, None, :]
    flat = torch.where(eq & (ii >= 1), ii + jj, _BIG).reshape(
        eq.shape[0], -1)
    best = flat.argmin(1)   # first minimum, as jnp.argmin
    found = torch.gather(flat, 1, best[:, None])[:, 0] < _BIG
    i_s = best // lb_n
    j_s = best % lb_n
    found &= cmask & ((i_s - 1) <= m_max) & (j_s <= m_max)
    n_backtracked = found.sum()
    s_node = torch.where(found, _take(chain_a, i_s[:, None])[:, 0], -1)

    # 4. path interiors (fork->join order) + sequences + identity
    maj = torch.where(found[:, None],
                      _path_nodes(chain_a, i_s, m_max, skip_last=1), -1)
    mnr = torch.where(found[:, None],
                      _path_nodes(chain_b, j_s, m_max, skip_last=0), -1)
    # reject degenerate/self-touching candidates: the two paths (and
    # their twins) must be disjoint, and neither may touch s/t
    tw_maj = _gather2(eg.twin, maj, -1)
    tw_mnr = _gather2(eg.twin, mnr, -1)
    ends = torch.stack([s_node, t0, _gather_or(eg.twin, s_node, -1),
                        _gather_or(eg.twin, t0, -1)], 1)
    maj_side = torch.cat([maj, tw_maj, ends], 1)
    mnr_side = torch.cat([mnr, tw_mnr], 1)
    clash = ((mnr_side[:, :, None] == maj_side[:, None, :])
             & (mnr_side[:, :, None] >= 0)).flatten(1).any(1)
    # palindromes inside the minority path
    clash |= ((mnr == tw_mnr) & (mnr >= 0)).any(1)
    found &= ~clash & (mnr >= 0).any(1) & (maj >= 0).any(1)

    # path lengths, the length gate, the LCS of the two path sequences
    # and the 90% verdict: one launch of the identity kernel on the card
    len_a, len_b, compared, ok, _ = lcs.identity_check(
        maj, mnr, found, eg.length, eg.seq_off, eg.seq_pool, diff, seq_cap)
    n_compared = compared.sum()

    # 5. claim arbitration: winners are edge-disjoint within the wave;
    # the lowest (minority coverage, candidate index) claim wins
    c = maj.shape[0]
    claims = torch.cat([maj, tw_maj, mnr, tw_mnr, ends], 1)
    claims = torch.where(ok[:, None] & (claims >= 0), claims, e_cap)
    rank = torch.where(
        ok, (_gather2(eg.cvg, mnr, 0) * (mnr >= 0)).sum(1), _BIG)
    q = claims.shape[1]
    flat_e = claims.reshape(-1)
    flat_rank = rank[:, None].expand(c, q).reshape(-1)
    flat_cid = torch.arange(c, device=dev)[:, None].expand(c, q).reshape(-1)
    big = torch.full((e_cap + 1,), _BIG, dtype=torch.int64, device=dev)
    win_rank = big.scatter_reduce(0, flat_e, flat_rank, "amin",
                                  include_self=True)
    tied = flat_rank == win_rank[flat_e]
    win_cid = big.scatter_reduce(0, flat_e, torch.where(
        tied, flat_cid, _BIG), "amin", include_self=True)
    mine = (win_cid[flat_e] == flat_cid) | (flat_e == e_cap)
    win = ok & mine.reshape(c, q).all(1)
    n_merged = win.sum()

    # 6. apply: delete minority (+twins), fold coverage positionally,
    # remap minority arcs onto the covering majority node
    mnr_w = torch.where(win[:, None], mnr, -1)
    tw_mnr_w = torch.where(win[:, None], tw_mnr, -1)
    del_idx = torch.cat([mnr_w, tw_mnr_w], 1).reshape(-1)
    deleted2 = eg.deleted | _scatter_true(
        e_cap, torch.where(del_idx >= 0, del_idx, e_cap))

    # positional covering: minority node midpoint, scaled to the
    # majority path, picks the covering majority node
    lens_b = _gather2(eg.length, mnr, 0)
    mid_b = torch.cumsum(lens_b, 1) - lens_b + lens_b // 2
    scale = torch.where(len_b[:, None] > 0, mid_b * len_a[:, None]
                        // len_b.clamp(min=1)[:, None], 0)
    lens_a = _gather2(eg.length, maj, 0)
    cum_a = torch.cumsum(lens_a, 1) - lens_a
    inside = (scale[:, :, None] >= cum_a[:, None, :]) & \
        (scale[:, :, None] < (cum_a + lens_a)[:, None, :]) & \
        (maj[:, None, :] >= 0)
    last_maj = _take(maj, ((maj >= 0).sum(1) - 1).clamp(min=0)[:, None])
    cover = torch.where(inside.any(2),
                        torch.gather(maj, 1,
                                     inside.to(torch.uint8).argmax(2)),
                        last_maj)  # fallback: last live majority node
    cover = torch.where(mnr_w >= 0, cover, -1)
    tw_cover = _gather2(eg.twin, cover, -1)

    add_idx = torch.cat([cover, tw_cover], 1).reshape(-1)
    add_val = torch.cat([_gather2(eg.cvg, mnr_w, 0),
                         _gather2(eg.cvg, tw_mnr_w, 0)], 1).reshape(-1)
    cvg2 = torch.cat([eg.cvg, eg.cvg.new_zeros(1)]).index_add_(
        0, torch.where(add_idx >= 0, add_idx, e_cap),
        torch.where(add_idx >= 0, add_val, 0))[:e_cap].clamp(
            0, unitigs.MAX_EDGE_COV)

    remap = torch.cat([me, me.new_zeros(1)])
    for idx, to in ((mnr_w, cover), (tw_mnr_w, tw_cover)):
        idx, to = idx.reshape(-1), to.reshape(-1)
        remap[torch.where(idx >= 0, idx, e_cap)] = to.clamp(min=0)
    remap = remap[:e_cap]

    new_f = torch.where(aset.from_ed >= 0,
                        _gather_or(remap, aset.from_ed, -1), -1)
    new_t = torch.where(aset.to_ed >= 0,
                        _gather_or(remap, aset.to_ed, -1), -1)
    # drop self-loops created by two minority nodes covering one
    # majority node (genuine pre-existing loops are preserved)
    created_loop = (new_f == new_t) & (aset.from_ed != aset.to_ed)
    new_f = torch.where(created_loop, -1, new_f)
    new_t = torch.where(created_loop, -1, new_t)
    new_mult = torch.where(new_f >= 0, aset.mult, 0)

    overflow = (n_cand - cand_cap).clamp(min=0)
    # examined candidates rejected by the checks themselves (not by
    # claim arbitration — those must retry) are reported so `pinch`
    # can skip them until the graph next changes.  When n_merged == 0
    # no candidate was `ok` at all (the globally minimal (rank, cid)
    # ok-candidate always wins every edge it claims), so marking all
    # examined candidates failed is exact.
    fail_mark = cmask & ~ok
    return (cvg2, deleted2, new_f, new_t, new_mult,
            n_backtracked, n_compared, n_merged, overflow,
            cid_arc, fail_mark)


def _wave_step(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, failed,
               m_max: int, diff: int, seq_cap: int, cand_cap: int):
    """One wave on a pinch's buffers, with no host read: ``_wave``, then
    the ``failed`` update of an unproductive wave (its examined
    candidates that the checks rejected), in place and gated on the
    device by ``n_merged == 0``; a productive wave's ``failed`` is
    cleared by ``WaveProgram.apply``.  Returns (counts, cvg2, deleted2,
    new_f, new_t, new_mult); counts is (4,) int64: merged, overflow,
    backtracked, compared."""
    (cvg2, deleted2, nf, nt, nm, n_back, n_cmp, n_merged, overflow,
     cid_arc, fail_mark) = _wave(eg, aset, failed, m_max, diff, seq_cap,
                                 cand_cap)
    a_cap = failed.shape[0]
    failed |= _scatter_true(a_cap, torch.where(
        fail_mark & (n_merged == 0), cid_arc, a_cap))
    return (torch.stack([n_merged, overflow, n_back, n_cmp]), cvg2,
            deleted2, nf, nt, nm)


@contextlib.contextmanager
def _host_sync_is_error():
    """Any host synchronisation on the card raises inside (a wave that
    syncs could not be captured)."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():  # "a prototype feature", once a process
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class WaveProgram:
    """The waves of one pinch as one program over buffers of fixed shape
    (the JAX package's jitted ``_wave`` at a fixed arc capacity).

    The arc table lives in buffers sized to its rows at entry: a merge
    only remaps, drops and aggregates rows, so it never grows.  After a
    productive wave ``apply`` copies ``rebuild_arcs``'s exact table in
    and refills the tail with (-1, -1, 0) rows, which are never
    candidates and sort after every real row, so a wave gives what it
    gives on the exact table.  Coverage, the deleted mask and ``failed``
    are buffers updated in place.

    On a card the first wave runs eagerly, with any host synchronisation
    an error: a real wave, and the warm-up (the kernel build, the sorts'
    workspaces, the identity kernel's shared-memory attribute).  The
    second is captured once into a ``torch.cuda.CUDAGraph`` and every
    later wave replays it (captured work does not run at capture, so the
    captured wave is a replay too); a capture or replay that fails
    raises.  On the CPU every wave calls ``_wave_step``."""

    def __init__(self, eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet,
                 m_max: int, diff: int):
        self.dev = eg.length.device
        self.cvg, self.deleted = eg.cvg.clone(), eg.deleted.clone()
        self.eg = eg._replace(cvg=self.cvg, deleted=self.deleted)
        self.aset = arcs_mod.ArcSet(  # ``_wave`` reads no ``n``
            aset.from_ed.clone(), aset.to_ed.clone(), aset.mult.clone(),
            aset.n)
        self.failed = torch.zeros_like(aset.from_ed, dtype=torch.bool)
        self.args = (m_max, diff, SEQ_CAP, CAND_CAP)
        self.waves = 0
        self.graph = None
        self.outs = None
        self.identity_launches = 0  # identity launches a replay executes

    def _step(self):
        return _wave_step(self.eg, self.aset, self.failed, *self.args)

    def launch(self):
        """Enqueue one wave; returns its (4,) counts on the device."""
        global REPLAYS
        if self.dev.type != "cuda":
            self.outs = self._step()
        elif self.waves == 0:
            with torch.cuda.device(self.dev), _host_sync_is_error():
                self.outs = self._step()
        else:
            with torch.cuda.device(self.dev):
                if self.graph is None:
                    self._capture()
                self.graph.replay()
            REPLAYS += 1
            lcs.IDENTITY_LAUNCHES += self.identity_launches
        self.waves += 1
        return self.outs[0]

    def _capture(self) -> None:
        global CAPTURES
        graph = torch.cuda.CUDAGraph()
        captured = lcs.IDENTITY_CAPTURED
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.dev)):
            self.outs = self._step()
        self.identity_launches = lcs.IDENTITY_CAPTURED - captured
        self.graph = graph
        CAPTURES += 1

    def apply(self) -> arcs_mod.ArcSet:
        """After a productive wave: its coverage and deleted mask into the
        buffers, its remapped arcs rebuilt and copied into the arc buffers
        over (-1, -1, 0) rows, ``failed`` cleared (a replay overwrites the
        wave's outputs, so everything is copied out first).  Returns the
        rebuilt exact-size table."""
        _counts, cvg2, deleted2, nf, nt, nm = self.outs
        exact = rebuild_arcs(nf, nt, nm, self.eg.twin)
        self.cvg.copy_(cvg2)
        self.deleted.copy_(deleted2)
        n = exact.from_ed.shape[0]
        for buf, rows, fill in zip(self.aset[:3], exact[:3], (-1, -1, 0)):
            buf[:n].copy_(rows)
            buf[n:].fill_(fill)
        self.failed.zero_()
        return exact


def pinch(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet,
          k: int, merge_level: int):
    """Wave-parallel Tour-Bus to a fixpoint (bubble.c:2123-2126's
    HasChanged loop).  Returns (eg, aset, stats): the graph and the
    exact-size arc table of the last productive wave (the inputs when
    no wave merged); stats count pairs backtracked, compared and merged,
    waves, productive waves (those that merged), the loop's wall seconds
    and seconds per wave.

    Every productive wave deletes at least one edge; between graph
    changes each unproductive wave retires a fresh CAND_CAP-chunk of
    the remaining candidates (the ``failed`` mask).  The waves run as
    one ``WaveProgram``, one blocking read of four counts a wave."""
    m_max, diff = _params_for(merge_level)
    stats = {"backtracked": 0, "compared": 0, "merged": 0, "waves": 0,
             "productive": 0, "seconds": 0.0}
    t0 = time.time()
    # a graph without a single arc row has no bubble (and no candidate
    # for ``_wave`` to shape its chains on)
    if aset.from_ed.shape[0]:
        prog = WaveProgram(eg, aset, m_max, diff)
        while True:
            stats["waves"] += 1
            n, over, back, cmp_ = prog.launch().tolist()
            stats["backtracked"] += back
            stats["compared"] += cmp_
            if n == 0:
                if over == 0:
                    break
                # chunk exhausted without a merge: the wave retired it
                # into ``failed``; the next examines the next chunk
                continue
            stats["merged"] += n
            stats["productive"] += 1
            # the merge changed the graph: every rejected candidate may
            # be mergeable now (``apply`` clears the mask)
            aset = prog.apply()
        if stats["productive"]:
            eg = prog.eg
    stats["seconds"] = time.time() - t0
    stats["s_per_wave"] = stats["seconds"] / max(stats["waves"], 1)
    return eg, aset, stats
