"""The Hopper kernels of the Tour-Bus wave around its identity check: the
wave's front (``front``: from the arc table to the candidates' chains)
and its back (``back``: from the verdicts to the counts and the
``failed`` mask).

``front`` replaces steps 1-4 of the JAX package's jitted ``_wave`` up to
the identity check (``soapdenovo_trans_tpu/graph/tourbus.py:140-219``:
the live arcs, the majority forest, the candidates and their order, the
backward walks, the first meeting point, the path interiors, their twins
and the clash test); ``back`` replaces the rest (:221-325 from the
verdicts on: the counts, the claim arbitration, the positional cover,
the deletes, the coverage adds, the remap and the rewrite of the arc
rows) and the pinch's ``failed`` update (:349-356).  XLA fuses all of it
into the wave program (device code, not Pallas kernels).  The arc rows
depart from the JAX wave, which remaps every row of a minority node onto
its cover: here a row that the remap would leave unjoined, or that is
the bubble's own, is dropped (``claim_apply_plain``).  The CUDA source is
``csrc/wave.cu`` in this package, compiled for ``sm_90a`` with ``nvcc``
at first use into ``_build/`` and loaded with ``ctypes``
(``kernels/_nvcc.py``).

Each wrapper launches its kernels for CUDA tensors and runs its plain
PyTorch version (``front_plain``, ``back_plain``: the wave's own code,
moved here, whose halves ``candidates_plain``, ``chains_plain`` and
``claim_apply_plain`` are steps 1-2, 3-4 and 5-6) only for CPU tensors.
Both may be captured into a CUDA graph (the Tour-Bus wave is,
``graph/tourbus.WaveProgram``): their launches read nothing back, copy
no host value to the card and set no attribute, and their counters count
executions.  The front keeps its majority forest and the back its
arbitration keys in scratch arrays of each card (``forest_scratch``,
``claim_scratch``), allocated outside any capture and empty between
calls.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..ops.index import gather2, gather_or, scatter_true
from . import _nvcc

SOURCE = os.path.join(_nvcc.CSRC, "wave.cu")
MAX_M = 30  # node slots a path: -M 3's MAXNODELENGTH (its shared memory)
MAX_CAND = 4096  # candidate rows a front takes (its one-block sort)
EMPTY = 2**63 - 1  # an unclaimed entry of the claim scratch
MAX_EDGE_COV = 16000  # an edge's coverage clamp (reference: src/inc/def.h:37)
_BIG = 2**30

# executions of each entry since the last reset: each launch outside a
# CUDA graph capture, and each replay of a graph that holds one (the
# graph's owner adds them, ``graph/tourbus.WaveProgram``); a ``front``
# execution is its eight kernels, a ``back`` its four
FRONT_LAUNCHES = 0
FRONT_CAPTURED = 0  # front launches recorded into CUDA graphs
BACK_LAUNCHES = 0
BACK_CAPTURED = 0  # back launches recorded into CUDA graphs
_LIB = None
_SCRATCH = {}  # (card index, what) -> that scratch of the card


def build() -> str:
    """Compile csrc/wave.cu for sm_90a (once per source content) and
    return the shared library's path."""
    return _nvcc.build(SOURCE)


def _load():
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        lib.front_launch.restype = ctypes.c_int
        lib.front_launch.argtypes = ([ctypes.c_void_p] * 21
                                     + [ctypes.c_longlong] * 5
                                     + [ctypes.c_void_p])
        lib.back_launch.restype = ctypes.c_int
        lib.back_launch.argtypes = ([ctypes.c_void_p] * 33
                                    + [ctypes.c_longlong] * 5
                                    + [ctypes.c_void_p])
        lib.front_work_bytes.restype = ctypes.c_longlong
        lib.front_work_bytes.argtypes = [ctypes.c_longlong] * 3
        for fn in (lib.wave_max_m, lib.wave_empty, lib.wave_max_cand):
            fn.restype = ctypes.c_longlong
        if (lib.wave_max_m(), lib.wave_empty(), lib.wave_max_cand()) != \
                (MAX_M, EMPTY, MAX_CAND):
            raise RuntimeError("csrc/wave.cu and kernels/wave.py disagree "
                               "on the node slots, the empty entry or the "
                               "candidate rows")
        _LIB = lib
    return _LIB


def _scratch(dev, e: int, fill: int, what: str):
    """The ``what`` scratch of card ``dev``: at least e int64 entries, all
    ``fill`` between calls.  Allocated at first need and replaced by a
    larger one when a graph outgrows it, never inside a CUDA graph
    capture."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    have = _SCRATCH.get((dev.index, what))
    if have is not None and have.shape[0] >= e:
        return have
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} scratch of {e} entries first asked for "
                           f"inside a CUDA graph capture on {dev}")
    scratch = torch.full((max(e, 1),), fill, dtype=torch.int64, device=dev)
    _SCRATCH[(dev.index, what)] = scratch
    return scratch


def claim_scratch(dev, e: int):
    """The claim scratch of card ``dev``: at least e int64 entries, every
    one EMPTY between calls (each ``back`` resets what it claimed).
    Allocated at first need and replaced by a larger one when a graph
    outgrows it, never inside a CUDA graph capture (``WaveProgram``
    reserves it before its first wave and keeps a reference, so a graph
    it captured keeps its scratch).  The calls on one card share it, so
    they must not overlap: the wave runs them on one stream."""
    return _scratch(dev, e, EMPTY, "claim")


def forest_scratch(dev, e: int):
    """The forest scratch of card ``dev``: at least e entries (uint64 keys
    in int64), every one 0 between calls (each ``front`` zeroes what it
    wrote).  Allocated, shared and kept as ``claim_scratch``."""
    return _scratch(dev, e, 0, "forest")


def _check(xs, int64, flags, rows, m_max: int) -> None:
    if len({x.device for x in xs}) != 1:
        raise ValueError("wave inputs must lie on one device")
    if not all(x.dtype == torch.int64 for x in int64):
        raise TypeError("node ids, lengths, coverage and arc rows must be "
                        "int64")
    if not all(x.dtype == torch.bool for x in flags):
        raise TypeError("masks must be bool")
    if not 0 <= m_max <= MAX_M:
        raise ValueError(f"m_max {m_max} outside the kernel's 0..{MAX_M}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("wave inputs must be contiguous")
    for what, x, shape in rows:
        if tuple(x.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got "
                             f"{tuple(x.shape)}")


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


def _walk(prev, start, steps: int):
    """(C, steps): [start, prev(start), prev(prev(start)), ...]."""
    hist = [start]
    for _ in range(steps - 1):
        hist.append(gather_or(prev, hist[-1], -1))
    return torch.stack(hist, 1)


def chains_plain(prev, u, t0, cmask, twin, m_max: int):
    """Steps 3-4 of the wave in plain PyTorch, as the JAX wave computes
    them, for C candidate arcs u -> t0 over the majority forest ``prev``:
    returns (maj, mnr, tw_maj, tw_mnr, s_node, ends, found,
    n_backtracked).

    prev, twin: (E,) int64; u, t0: (C,) int64 (-1 where not a
    candidate); cmask: (C,) bool.  maj, mnr and their twins are (C,
    m_max) int64 node lists in path order (fork to join), -1 padded;
    s_node (C,) the fork, ends (C, 4) (s, t0, twin(s), twin(t0)); found
    (C,) bool, the candidates with a meeting point that pass the clash
    test; n_backtracked a 0-dim int64, the candidates with a meeting
    point.  ``csrc/wave.cu`` states the rules."""
    dev = u.device
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

    # 4. path interiors (fork->join order)
    maj = torch.where(found[:, None],
                      _path_nodes(chain_a, i_s, m_max, skip_last=1), -1)
    mnr = torch.where(found[:, None],
                      _path_nodes(chain_b, j_s, m_max, skip_last=0), -1)
    # reject degenerate/self-touching candidates: the two paths (and
    # their twins) must be disjoint, and neither may touch s/t
    tw_maj = gather2(twin, maj, -1)
    tw_mnr = gather2(twin, mnr, -1)
    ends = torch.stack([s_node, t0, gather_or(twin, s_node, -1),
                        gather_or(twin, t0, -1)], 1)
    maj_side = torch.cat([maj, tw_maj, ends], 1)
    mnr_side = torch.cat([mnr, tw_mnr], 1)
    clash = ((mnr_side[:, :, None] == maj_side[:, None, :])
             & (mnr_side[:, :, None] >= 0)).flatten(1).any(1)
    # palindromes inside the minority path
    clash |= ((mnr == tw_mnr) & (mnr >= 0)).any(1)
    found &= ~clash & (mnr >= 0).any(1) & (maj >= 0).any(1)
    return maj, mnr, tw_maj, tw_mnr, s_node, ends, found, n_backtracked


def _claim_shapes(xs, c: int, m: int, e: int, a: int):
    """(name, tensor, shape) of ``back``'s first 17 inputs, those of
    ``claim_apply_plain``."""
    names = ("maj", "mnr", "tw_maj", "tw_mnr", "ends", "ok", "len_a",
             "len_b", "cvg", "length", "twin", "deleted", "from_ed",
             "to_ed", "mult", "from_node", "to_node")
    shapes = ((c, m),) * 4 + ((c, 4),) + ((c,),) * 3 + ((e,),) * 4 + \
        ((a,),) * 3 + ((e,),) * 2
    return tuple(zip(names, xs, shapes))


def claim_apply_plain(maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b,
                      cvg, length, twin, deleted, from_ed, to_ed, mult,
                      from_node, to_node):
    """Steps 5-6 of the Tour-Bus wave in plain PyTorch, the JAX wave's
    claims, deletes, coverage and positional cover with the port's arc
    rule: returns (cvg2, deleted2, new_f, new_t, new_mult, n_merged).

    maj, mnr, tw_maj, tw_mnr: (C, m) int64 and ends (C, 4) int64, as
    ``chains_plain`` gives them; ok, len_a, len_b: (C,) as the identity check
    gives them; cvg, length, twin: (E,) int64 and deleted (E,) bool, an
    ``EdgeGraph``'s; from_ed, to_ed, mult: (A,) int64 arc rows; from_node,
    to_node: (E,) int64, the ``EdgeGraph``'s end nodes.  The ok
    candidates that hold the least (minority coverage, candidate) of every
    edge they claim win (the claims of -1 are no claims); each deletes its
    minority nodes and their twins and moves their coverage onto the
    covering majority node and its twin.  The arc rows (the JAX wave
    remaps them all and drops only the self-loops this makes): a row from
    or to a winner's minority node is dropped where its other end is an
    edge the same winner claims (the bubble's own fork, join and path
    arcs, and their twins), where the node has no cover, and where the
    row remapped onto the cover would not join (to_node[from] !=
    from_node[to]); the rest of those rows are remapped, and the
    self-loops the remap makes are dropped.  So every row a wave leaves
    joins as the rows it was given do.  cvg2 is clamped into [0,
    MAX_EDGE_COV]; n_merged (0-dim int64) counts the winners."""
    e_cap = cvg.shape[0]
    dev = cvg.device
    me = torch.arange(e_cap, device=dev)
    # 5. claim arbitration: winners are edge-disjoint within the wave;
    # the lowest (minority coverage, candidate index) claim wins
    c = maj.shape[0]
    claims = torch.cat([maj, tw_maj, mnr, tw_mnr, ends], 1)
    claims = torch.where(ok[:, None] & (claims >= 0), claims, e_cap)
    rank = torch.where(
        ok, (gather2(cvg, mnr, 0) * (mnr >= 0)).sum(1), _BIG)
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
    # remap the arcs that enter or leave a bubble onto the covering
    # majority node
    mnr_w = torch.where(win[:, None], mnr, -1)
    tw_mnr_w = torch.where(win[:, None], tw_mnr, -1)
    del_idx = torch.cat([mnr_w, tw_mnr_w], 1).reshape(-1)
    deleted2 = deleted | scatter_true(
        e_cap, torch.where(del_idx >= 0, del_idx, e_cap))

    # positional covering: minority node midpoint, scaled to the
    # majority path, picks the covering majority node
    lens_b = gather2(length, mnr, 0)
    mid_b = torch.cumsum(lens_b, 1) - lens_b + lens_b // 2
    scale = torch.where(len_b[:, None] > 0, mid_b * len_a[:, None]
                        // len_b.clamp(min=1)[:, None], 0)
    lens_a = gather2(length, maj, 0)
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
    tw_cover = gather2(twin, cover, -1)

    add_idx = torch.cat([cover, tw_cover], 1).reshape(-1)
    add_val = torch.cat([gather2(cvg, mnr_w, 0),
                         gather2(cvg, tw_mnr_w, 0)], 1).reshape(-1)
    cvg2 = torch.cat([cvg, cvg.new_zeros(1)]).index_add_(
        0, torch.where(add_idx >= 0, add_idx, e_cap),
        torch.where(add_idx >= 0, add_val, 0))[:e_cap].clamp(
            0, MAX_EDGE_COV)

    # each minority node (and twin) of a winner goes to its cover, -1
    # where it has none, and remembers its winner; each edge a winner
    # claims remembers that winner
    cid = torch.arange(c, device=dev)[:, None].expand(c, maj.shape[1])
    remap = torch.cat([me, me.new_zeros(1)])
    owner = torch.full((e_cap + 1,), -1, dtype=torch.int64, device=dev)
    for idx, to in ((mnr_w, cover), (tw_mnr_w, tw_cover)):
        at = torch.where(idx >= 0, idx, e_cap).reshape(-1)
        remap[at] = to.reshape(-1)
        owner[at] = cid.reshape(-1)
    remap, owner = remap[:e_cap], owner[:e_cap]
    claimed = torch.full((e_cap + 1,), -1, dtype=torch.int64, device=dev)
    claimed[torch.where(win[:, None], claims, e_cap).reshape(-1)] = flat_cid
    claimed = claimed[:e_cap]

    new_f = torch.where(from_ed >= 0, gather_or(remap, from_ed, -1), -1)
    new_t = torch.where(to_ed >= 0, gather_or(remap, to_ed, -1), -1)
    moved_f = (from_ed >= 0) & (new_f != from_ed)
    moved_t = (to_ed >= 0) & (new_t != to_ed)
    # a row from or to a minority node is dropped where its other end is
    # claimed by the same winner (the bubble's own arcs: fork, join, either
    # path, their twins), where the node has no cover, and where the
    # remapped row would not join (to_node[from] != from_node[to]); so are
    # the self-loops the remap makes (genuine loops are kept)
    inside = (moved_f & (gather_or(claimed, to_ed, -1)
                         == gather_or(owner, from_ed, -2))) | \
        (moved_t & (gather_or(claimed, from_ed, -1)
                    == gather_or(owner, to_ed, -2)))
    joined = gather_or(to_node, new_f, -1) == gather_or(from_node, new_t, -2)
    drop = ((new_f == new_t) & (from_ed != to_ed)) | \
        ((moved_f | moved_t) & (inside | ~joined))
    new_f = torch.where(drop, -1, new_f)
    new_t = torch.where(drop, -1, new_t)
    new_mult = torch.where(new_f >= 0, mult, 0)
    return cvg2, deleted2, new_f, new_t, new_mult, n_merged


def front(n_edges: int, deleted, cvg, twin, from_ed, to_ed, mult, failed,
          m_max: int, cand_cap: int):
    """The Tour-Bus wave's front, steps 1-4 up to the identity check:
    returns (cid_arc, cmask, u, t0, maj, mnr, tw_maj, tw_mnr, ends, found,
    n_backtracked, n_cand).

    deleted (E,) bool, cvg and twin (E,) int64, an ``EdgeGraph``'s, whose
    first n_edges edges are in use; from_ed, to_ed, mult (A,) int64 arc
    rows (edge ids -1..E-1), failed (A,) bool.  The live arcs (both edges
    in use and not deleted, mult > 0) give the majority forest: each
    edge's live predecessor with the highest coverage, the lowest
    from-edge on ties.  The candidates are the live arcs outside the
    forest and not failed, n_cand of them; cid_arc holds the first
    C = min(cand_cap, A) rows of the order that puts the candidates first,
    by (coverage of the from-edge, row), and the rest in row order; cmask
    marks its candidates, u and t0 their from- and to-edges (-1 where not
    a candidate).  maj, mnr, tw_maj, tw_mnr (C, m_max), ends (C, 4), found
    (C,) and n_backtracked are ``chains_plain`` on that forest and those
    rows.
    The kernel needs coverage within int32 (the JAX package's type) and
    edge ids below 2^31; cand_cap <= MAX_CAND, m_max <= MAX_M."""
    global FRONT_LAUNCHES, FRONT_CAPTURED
    e, a = cvg.shape[0], from_ed.shape[0]
    xs = (deleted, cvg, twin, from_ed, to_ed, mult, failed)
    _check(xs, (cvg, twin, from_ed, to_ed, mult), (deleted, failed),
           (("deleted", deleted, (e,)), ("cvg", cvg, (e,)),
            ("twin", twin, (e,)), ("from_ed", from_ed, (a,)),
            ("to_ed", to_ed, (a,)), ("mult", mult, (a,)),
            ("failed", failed, (a,))), m_max)
    if not 0 <= cand_cap <= MAX_CAND:
        raise ValueError(f"cand_cap {cand_cap} outside the kernel's "
                         f"0..{MAX_CAND}")
    dev = cvg.device
    if dev.type == "cpu":
        return front_plain(n_edges, *xs, m_max, cand_cap)
    if dev.type != "cuda":
        raise ValueError(f"no wave kernel for device {dev}")
    lib = _load()
    c = min(cand_cap, a)
    with torch.cuda.device(dev):
        forest = forest_scratch(dev, e)
        work = torch.empty(lib.front_work_bytes(a, e, c), dtype=torch.uint8,
                           device=dev)
        rows = torch.empty((3, c), dtype=torch.int64, device=dev)
        flags = torch.empty((2, c), dtype=torch.bool, device=dev)
        longs = torch.empty((4, c, m_max), dtype=torch.int64, device=dev)
        ends = torch.empty((c, 4), dtype=torch.int64, device=dev)
        counts = torch.empty(2, dtype=torch.int64, device=dev)
        cid_arc, u, t0 = rows
        cmask, found = flags
        err = lib.front_launch(
            *(x.data_ptr() for x in xs), forest.data_ptr(), work.data_ptr(),
            cid_arc.data_ptr(), cmask.data_ptr(), u.data_ptr(),
            t0.data_ptr(), *(x.data_ptr() for x in longs), ends.data_ptr(),
            found.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
            n_edges, e, a, c, m_max,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"front kernel launch failed: CUDA error "
                               f"{err}")
        if torch.cuda.is_current_stream_capturing():
            FRONT_CAPTURED += 1
        else:
            FRONT_LAUNCHES += 1
    return (cid_arc, cmask, u, t0, *longs, ends, found, counts[0], counts[1])


def _majority_forest(from_ed, to_ed, varc, cvg_f, e_cap: int):
    """prev[t] = the live predecessor of t with the highest coverage
    (lowest from-edge on ties): a sort on (to, -cvg, from), run as two
    stable passes because the three keys do not fit one int64.  The
    second key, (2^31 - 1 - cvg)·2^31 + from, fits one for every int32
    coverage and every from-edge below 2^31."""
    to_k = torch.where(varc, to_ed, _BIG)
    low = torch.where(varc, (2**31 - 1) - cvg_f, 0) * (1 << 31) + \
        torch.where(varc, from_ed, _BIG)
    o = torch.sort(low, stable=True).indices
    o = o[torch.sort(to_k[o], stable=True).indices]
    s_to, s_from = to_k[o], from_ed[o]
    head = s_to < _BIG
    head[1:] &= s_to[1:] != s_to[:-1]
    prev = torch.full((e_cap + 1,), -1, dtype=torch.int64,
                      device=s_to.device)
    prev[torch.where(head, s_to, e_cap)] = s_from
    return prev[:e_cap]


def candidates_plain(n_edges: int, deleted, cvg, from_ed, to_ed, mult,
                     failed, cand_cap: int):
    """Steps 1-2 of the wave in plain PyTorch, as the JAX wave computes
    them: returns (prev, cid_arc, cmask, u, t0, n_cand), the majority
    forest and ``front``'s candidate rows."""
    e_cap = cvg.shape[0]
    dev = cvg.device
    me = torch.arange(e_cap, device=dev)
    live_e = (me < n_edges) & ~deleted
    varc = (from_ed >= 0) & (to_ed >= 0) & (mult > 0) & \
        gather_or(live_e, from_ed, False) & \
        gather_or(live_e, to_ed, False)

    # 1. majority forest
    cvg_f = gather_or(cvg, from_ed, 0)
    prev = _majority_forest(from_ed, to_ed, varc, cvg_f, e_cap)

    # 2. candidates: non-forest arcs not yet examined-and-rejected
    # since the last graph change, weakest minority first; the arc row
    # is the last key, so equal-coverage candidates keep row order
    tree = gather_or(prev, to_ed, -1) == from_ed
    cand = varc & ~tree & ~failed
    n_cand = cand.sum()
    order = torch.sort(torch.where(cand, cvg_f, _BIG), stable=True).indices
    order = order[torch.sort((~cand[order]).to(torch.uint8),
                             stable=True).indices]
    cid_arc = order[:cand_cap]
    cmask = cand[cid_arc]
    u = torch.where(cmask, from_ed[cid_arc], -1)
    t0 = torch.where(cmask, to_ed[cid_arc], -1)
    return prev, cid_arc, cmask, u, t0, n_cand


def front_plain(n_edges: int, deleted, cvg, twin, from_ed, to_ed, mult,
                failed, m_max: int, cand_cap: int):
    """``front`` in plain PyTorch, as the JAX wave computes it: the forest
    and the candidates (``candidates_plain``), then ``chains_plain``."""
    prev, cid_arc, cmask, u, t0, n_cand = candidates_plain(
        n_edges, deleted, cvg, from_ed, to_ed, mult, failed, cand_cap)
    maj, mnr, tw_maj, tw_mnr, _s, ends, found, n_backtracked = \
        chains_plain(prev, u, t0, cmask, twin, m_max)
    return (cid_arc, cmask, u, t0, maj, mnr, tw_maj, tw_mnr, ends, found,
            n_backtracked, n_cand)


def back(maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, cvg, length,
         twin, deleted, from_ed, to_ed, mult, from_node, to_node, compared,
         cmask, cid_arc, n_cand, n_backtracked, cand_cap: int, failed):
    """The Tour-Bus wave's back, from the verdicts on: returns (counts,
    cvg2, deleted2, new_f, new_t, new_mult).

    ``claim_apply_plain``'s 17 inputs, then compared, cmask (C,) bool and
    cid_arc (C,) int64 as the identity check and ``front`` give them,
    n_cand and n_backtracked (0-dim int64), cand_cap and the pinch's
    failed (A,) bool.  counts is (5,) int64: merged, overflow
    (max(n_cand - cand_cap, 0)), backtracked, compared, and the arc rows
    the merge dropped (rows with a from-edge that the arc rule leaves as
    (-1, -1, 0); 0 when nothing merged).  When no row is ok nothing
    merges (counts[0] == 0) and the back sets failed[cid_arc[c]] in place
    for every cmask row; failed is never cleared here.  cvg2, deleted2,
    new_f, new_t and new_mult are ``claim_apply_plain``'s when counts[0]
    > 0 and UNDEFINED when it is 0 (the kernels skip them; no caller
    reads them then: the JAX pinch, ``WaveProgram.apply``); the plain
    version writes them always.  The kernels' arbitration key needs each
    rank (a sum of at most m coverages) below 2^31, which an
    EdgeGraph's coverage, clamped to MAX_EDGE_COV by every wave,
    keeps."""
    global BACK_LAUNCHES, BACK_CAPTURED
    c, m = maj.shape if maj.dim() == 2 else (-1, -1)
    e, a = cvg.shape[0], from_ed.shape[0]
    xs = (maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, cvg, length,
          twin, deleted, from_ed, to_ed, mult, from_node, to_node)
    more = (compared, cmask, cid_arc, n_cand, n_backtracked, failed)
    _check(xs + more, xs[:5] + xs[6:11] + xs[12:] + more[2:5],
           (ok, deleted, compared, cmask, failed),
           _claim_shapes(xs, c, m, e, a) + (
               ("compared", compared, (c,)), ("cmask", cmask, (c,)),
               ("cid_arc", cid_arc, (c,)), ("n_cand", n_cand, ()),
               ("n_backtracked", n_backtracked, ()),
               ("failed", failed, (a,))), m)
    dev = maj.device
    if dev.type == "cpu":
        return back_plain(*xs, *more[:5], cand_cap, failed)
    if dev.type != "cuda":
        raise ValueError(f"no wave kernel for device {dev}")
    lib = _load()
    with torch.cuda.device(dev):
        scratch = claim_scratch(dev, e)
        remap = torch.empty(e, dtype=torch.int64, device=dev)
        owner = torch.empty(e, dtype=torch.int32, device=dev)
        cvg2 = torch.empty(e, dtype=torch.int64, device=dev)
        deleted2 = torch.empty(e, dtype=torch.bool, device=dev)
        arcs = torch.empty((3, a), dtype=torch.int64, device=dev)
        counts = torch.empty(5, dtype=torch.int64, device=dev)
        gate = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.back_launch(
            *(x.data_ptr() for x in xs + more), scratch.data_ptr(),
            remap.data_ptr(), owner.data_ptr(), cvg2.data_ptr(),
            deleted2.data_ptr(),
            *(x.data_ptr() for x in arcs), counts.data_ptr(),
            gate.data_ptr(), c, m, e, a, cand_cap,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"back kernel launch failed: CUDA error "
                               f"{err}")
        if torch.cuda.is_current_stream_capturing():
            BACK_CAPTURED += 1
        else:
            BACK_LAUNCHES += 1
    return (counts, cvg2, deleted2, *arcs)


def back_plain(maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, cvg,
               length, twin, deleted, from_ed, to_ed, mult, from_node,
               to_node, compared, cmask, cid_arc, n_cand, n_backtracked,
               cand_cap: int, failed):
    """``back`` in plain PyTorch: ``claim_apply_plain``, the ``failed``
    update of a wave that merged nothing, and the counts; every output
    written."""
    cvg2, deleted2, new_f, new_t, new_mult, n_merged = claim_apply_plain(
        maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, cvg, length, twin,
        deleted, from_ed, to_ed, mult, from_node, to_node)
    overflow = (n_cand - cand_cap).clamp(min=0)
    # examined candidates rejected by the checks themselves (not by
    # claim arbitration — those must retry) are retired until the graph
    # next changes.  When n_merged == 0 no candidate was `ok` at all
    # (the globally minimal (rank, cid) ok-candidate always wins every
    # edge it claims), so marking all examined candidates failed is
    # exact.
    a_cap = failed.shape[0]
    failed |= scatter_true(a_cap, torch.where(
        cmask & ~ok & (n_merged == 0), cid_arc, a_cap))
    dropped = ((from_ed >= 0) & (new_f < 0)).sum()
    return (torch.stack([n_merged, overflow, n_backtracked,
                         compared.sum(), dropped]),
            cvg2, deleted2, new_f, new_t, new_mult)
