"""splitReps — duplicate short repeat edges whose left/right neighbor
pairing is unambiguously resolved by read paths.

Port of ``soapdenovo_trans_tpu/graph/split_reps.py`` (behavioral
equivalent of the reference's solveReps/solvable/split1edge,
src/splitReps.c:166-303, 419-505): an edge ``m`` with n in-arcs from
distinct lefts and n out-arcs to distinct rights (2 <= n <= 4) is split
into n copies when the read paths traverse it as a perfect matching —
each left continues into exactly one right and vice versa
(``gothrough[i][j]``, splitReps.c:272).  Each copy takes one (left,
right) pair's arcs; reads that crossed the repeat then concatenate
straight through instead of stopping at the branch.

The read evidence arrives as a flat (T, 3) array of consecutive edge
triples; the candidate scan is a vectorized filter over the COO arc
table, and the graph surgery (a handful of row appends and arc moves
per split) is host numpy: candidates are rare by construction.  The
graph and the arcs are read to the host once and go back to their
device at exact sizes, so no padding row follows the appended ones.

The reference v1.04 never calls solveReps in the Trans flow (contig.c
has no call site), so this is a documented superset behind ``contig
-R``, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import arcs as arcs_mod
from . import unitigs

MAX_REP = 4  # reference solvable(): 2..4 branches (splitReps.c:188-199)


def path_triples(paths, file_to_row: np.ndarray) -> np.ndarray:
    """Consecutive (l, m, r) edge-row triples from read paths.

    ``paths``: iterable of 1-based .edge.gz file-id arrays (one per
    recorded read, as written by io.stagefiles.PathRecorder);
    ``file_to_row``: file id -> edge row.  A path with an unknown id
    gives no triple."""
    out = []
    for p in paths:
        rows = file_to_row[np.asarray(p, np.int64)]
        if rows.shape[0] < 3 or np.any(rows < 0):
            continue
        out.append(np.stack([rows[:-2], rows[1:-1], rows[2:]], axis=1))
    if not out:
        return np.zeros((0, 3), np.int64)
    return np.concatenate(out, axis=0)


def _mirror(triples: np.ndarray, twin: np.ndarray) -> np.ndarray:
    """Append the twin-strand orientation of every triple (a read on
    the twin strand is the mirrored twin triple — the reference gets
    this for free because markers live on both an edge and its twin,
    splitReps.c:99-124)."""
    if triples.shape[0] == 0:
        return triples
    t = np.asarray(triples, np.int64)
    t = t[np.all((t >= 0) & (t < twin.shape[0]), axis=1)]
    rev = np.stack([twin[t[:, 2]], twin[t[:, 1]], twin[t[:, 0]]], axis=1)
    return np.unique(np.concatenate([t, rev], axis=0), axis=0)


def solve_reps(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet,
               triples: np.ndarray
               ) -> Tuple[unitigs.EdgeGraph, arcs_mod.ArcSet, int]:
    """Split every solvable repeat edge; returns (edges, arcs, n_split).

    A solvable edge m (solvable(), splitReps.c:166-303):
      * has n distinct in-neighbors and n distinct out-neighbors,
        2 <= n <= MAX_REP, one arc per neighbor;
      * none of {m, lefts, rights} coincide or pair as twins
        (interferingCheck, splitReps.c:33-70);
      * the read-triple matrix gothrough[lefts x rights] is a perfect
        matching.
    Splitting (split1edge + cp1edge + moveArc2cp, splitReps.c:305-436):
    copy m (and its twin) n-1 times; copy i takes pair i's in/out arcs
    (and the twin's mirrored arcs); pair 0 stays on the original.  The
    arcs come back as the kept rows in their order, then the moved ones.
    """
    n_e = eg.n_edges
    dev = eg.twin.device
    twin = eg.twin[:n_e].cpu().numpy()
    deleted = eg.deleted[:n_e].cpu().numpy()

    fr = aset.from_ed[:aset.n].cpu().numpy()
    to = aset.to_ed[:aset.n].cpu().numpy()
    mu = aset.mult[:aset.n].cpu().numpy()
    live = (fr >= 0) & (to >= 0) & (mu > 0)
    if n_e == 0 or not live.any():
        return eg, aset, 0
    fr, to, mu = fr[live], to[live], mu[live]

    out_deg = np.bincount(fr, minlength=n_e)
    in_deg = np.bincount(to, minlength=n_e)
    cand = np.nonzero(
        (out_deg >= 2) & (out_deg <= MAX_REP) & (in_deg == out_deg)
        & ~deleted)[0]
    if cand.size == 0:
        return eg, aset, 0

    trip_set = set(map(tuple, _mirror(triples, twin).tolist()))

    # arc lookup: (from, to) -> multiplicity
    arc_mult = {}
    outs = {}
    ins = {}
    for f, t, m in zip(fr.tolist(), to.tolist(), mu.tolist()):
        arc_mult[(f, t)] = arc_mult.get((f, t), 0) + m
        outs.setdefault(f, []).append(t)
        ins.setdefault(t, []).append(f)

    new_rows = []      # source row of every edge row to append
    arc_del = set()    # (f, t) arcs to drop
    arc_add = []       # (f, t, mult) arcs to append
    n_split = 0
    nxt = n_e
    split_src = set()

    for m in cand.tolist():
        tm = int(twin[m])
        if m in split_src or tm in split_src:
            continue
        lefts = sorted(set(ins.get(m, [])))
        rights = sorted(set(outs.get(m, [])))
        n = len(lefts)
        if n != len(rights) or not (2 <= n <= MAX_REP):
            continue
        involved = [m] + lefts + rights
        inv_set = set(involved)
        if len(inv_set) != len(involved):
            continue  # interferingCheck: repeated participant
        if any(int(twin[e]) in inv_set for e in involved):
            continue  # a participant pairs with another's twin
        if any(e in split_src for e in involved):
            continue
        go = np.array([[1 if (l, m, r) in trip_set else 0
                        for r in rights] for l in lefts])
        if not (np.all(go.sum(1) == 1) and np.all(go.sum(0) == 1)):
            continue  # not a perfect matching -> unresolvable
        pairs = [(lefts[i], rights[int(np.argmax(go[i]))])
                 for i in range(n)]
        # pair 0 stays on m; pairs 1.. get fresh copies
        for (l, r) in pairs[1:]:
            cp, cp_t = nxt, (nxt if tm == m else nxt + 1)
            new_rows.append(m)
            if tm != m:
                new_rows.append(tm)
            nxt = cp_t + 1
            for (f, t, nf, nt) in ((l, m, l, cp), (m, r, cp, r)):
                arc_del.add((f, t))
                arc_add.append((nf, nt, arc_mult.get((f, t), 1)))
            # mirrored twin-strand arcs
            lt, rt = int(twin[l]), int(twin[r])
            for (f, t, nf, nt) in ((rt, tm, rt, cp_t), (tm, lt, cp_t, lt)):
                if (f, t) in arc_mult:
                    arc_del.add((f, t))
                    arc_add.append((nf, nt, arc_mult[(f, t)]))
        split_src.update((m, tm))
        n_split += 1

    if n_split == 0:
        return eg, aset, 0

    # --- append edge rows (cp1edge: seq/length/cvg shared with source)
    add = np.array(new_rows, np.int64)

    def grow(field):
        a = field[:n_e].cpu().numpy()
        return np.concatenate([a, a[add]])

    length = grow(eg.length)
    seq_off = grow(eg.seq_off)
    twin_f = grow(eg.twin)
    # each copy gets its OWN pool region (appended): the concatenate
    # pass's per-base ownership map requires disjoint [off, off+len)
    # per live edge
    pool = eg.seq_pool.cpu().numpy()
    segs = [pool]
    off_next = pool.shape[0]
    for i, src in enumerate(add.tolist()):
        ln = int(length[src])
        segs.append(pool[seq_off[src]:seq_off[src] + ln])
        seq_off[n_e + i] = off_next
        off_next += ln
    # twin wiring: copies were appended (m, tm) adjacent; palindromes single
    i = 0
    while i < add.shape[0]:
        row = n_e + i
        if int(twin[add[i]]) == add[i]:
            twin_f[row] = row
            i += 1
        else:
            twin_f[row] = row + 1
            twin_f[row + 1] = row
            i += 2

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    deleted_f = grow(eg.deleted)
    deleted_f[n_e:] = False
    eg2 = unitigs.EdgeGraph(
        from_node=up(grow(eg.from_node)), to_node=up(grow(eg.to_node)),
        length=up(length), cvg=up(grow(eg.cvg)), twin=up(twin_f),
        seq_off=up(seq_off), seq_pool=up(np.concatenate(segs)),
        n_edges=nxt, node_edge=eg.node_edge, node_pos=eg.node_pos,
        deleted=up(deleted_f))

    # --- rebuild the COO arc table
    keep = np.array([(f, t) not in arc_del
                     for f, t in zip(fr.tolist(), to.tolist())])
    moved = np.array(arc_add, np.int64).reshape(-1, 3)
    aset2 = arcs_mod.ArcSet(
        from_ed=up(np.concatenate([fr[keep], moved[:, 0]])),
        to_ed=up(np.concatenate([to[keep], moved[:, 1]])),
        mult=up(np.concatenate([mu[keep], moved[:, 2]])),
        n=int(keep.sum()) + moved.shape[0])
    return eg2, aset2, n_split
