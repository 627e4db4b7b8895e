"""Stage 4 — scaff: connections -> loci -> transcripts -> .scafSeq.

Host-side transcript builder mirroring transcriptome()
(reference src/transcriptome.c:2223-2345) and the scaffold driver
(src/scaffold.c:35-90).  Loci are small (10s-1000s of contigs), so
this stage is compute-light: connection building runs on device
(graph/connections.py), the per-locus graph surgery below runs on
host over the resulting COO arrays, exactly as SURVEY.md §7.1 plans.

Pass sequence (transcriptome.c:2223-2345):
  setUniqueContig(-L)          -> unique = length >= L
  [PE2Links/Links2Scaf + singleRead2connection]  (device)
  deleteWeakCnt(3)             -> weight < 3 connections dropped
  getLoci                      -> oriented connected components
  linearization                -> transitive-redundancy removal
  deleteInconsistent           -> cross-orientation links dropped
  avoidLoop                    -> DFS cycle breaking
  linearization again
  transcript                   -> classify LINEAR/FORK/BUBBLE/COMPLEX,
                                  emit paths (all-paths for small loci,
                                  heaviest-path DP otherwise,
                                  transcriptome.c:1080-2118)

A host copy of ``soapdenovo_trans_tpu/stages/scaff.py``: that module is
numpy host code, but it belongs to the JAX package, which the port may
not import (the machine that runs the port on the GPU has no jax).
``run_scaff`` reads the port's device tensors (contigs, connections,
contig arcs) to the host once, at its start, and decodes the contig
sequences with the port's ``contig_merge.contig_sequences``; -F gap
filling runs the port's ``graph/gapfill`` on the contigs' device.
``collect_gap_reads`` groups the placed reads by contig once, where the
JAX package scans them once per junction side; each gap gets the same
reads in the same order.  The legacy dict pipeline (``delete_weak``,
``get_loci``, ``_oriented_locus``, ``transcript_sequences``) is copied
too: no stage runs it, and the tests hold ``build_structure`` against
it as the JAX package's tests do.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

LINEAR, FORK, BUBBLE, COMPLEX = "LINEAR", "FORK", "BUBBLE", "COMPLEX"


@dataclasses.dataclass
class ScaffParams:
    min_unique_len: int = 100   # -L ctg_mask
    weak_cnt: int = 3           # deleteWeakCnt cutoff
    max_cnt: int = 0            # -c deleteUnlikelyCnt (0 or >10 = off)
    max_transcripts: int = 5    # -t max_num per COMPLEX locus
    max_step: int = 5           # all-paths enumeration bound (contigs)
    max_routes: int = 10        # path count cap per locus
    ins_size_var: int = 20      # gap tolerance (Links2Scaf :4251-4275)
    gap_len_diff: int = 50      # -G GLDiff: allowed gap-size error for
    #                             gap filling (reference global.h:107)
    fill_gaps: bool = False     # -F: local assembly of gap sequence
    gap_read_window: int = 300  # placement window near a junction for
    #                             gap-read recruitment (readInGap)
    max_reads_per_gap: int = 128  # pairs recruited per junction; the
    #                               deep-gap coverage comes from
    #                               unmapped mates of distal pairs, so
    #                               the cap must span a full insert


@dataclasses.dataclass
class Transcript:
    locus: int
    index: int          # n-th transcript of the locus
    kind: str
    contigs: List[int]  # directed contig rows in order
    gaps: List[int]     # gap after each contig (len-1 entries)


@dataclasses.dataclass
class ScaffResult:
    recs: List[Tuple[str, str]]       # .scafSeq records
    transcripts: List[Transcript]
    stats: Dict[str, float]
    gap_report: List[Tuple[int, int, str, str]]
    # per transcript: [(ctg_row, out_start, out_len, strand)] of every
    # sequence segment actually rendered — the .contigPosInscaff/.agp
    # payload (reference outputScafSeq, prlReadFillGap.c:597-700)
    placements: List[List[Tuple[int, int, int, str]]] = \
        dataclasses.field(default_factory=list)
    # junction id -> intermediate route contigs (the .scaf_gap GAP
    # lines, transcriptome.c:1195-1205 + output1gap)
    routes: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    # junction id -> rendered N-run length (absent when spliced/filled)
    n_runs: Dict[int, int] = dataclasses.field(default_factory=dict)
    # seconds of the structure and render passes and, under -F, of
    # collect (gap-read recruitment), fill (all of gap filling) and
    # fill_<part> (the parts of ``gapfill.fill_gaps``)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    connections: int = 0  # rows of the connection set it was built from


class ConnGraph:
    """Mutable host view of the connection set over directed contigs."""

    def __init__(self, conn, twin, ctg_len, unique):
        self.twin = twin
        self.ctg_len = ctg_len
        self.unique = unique
        self.out: Dict[int, Dict[int, dict]] = defaultdict(dict)
        self.into: Dict[int, Dict[int, dict]] = defaultdict(dict)
        if conn is None:
            return
        n = int(conn.n)
        # pull to numpy ONCE — per-row jnp scalar reads are ~1ms each
        self._add_rows(np.asarray(conn.from_ctg[:n]),
                       np.asarray(conn.to_ctg[:n]),
                       np.asarray(conn.gap[:n]),
                       np.asarray(conn.weight[:n]),
                       np.asarray(conn.se_count[:n]))

    @classmethod
    def from_rows(cls, f, t, gap, wt, se, twin, ctg_len, unique):
        g = cls(None, twin, ctg_len, unique)
        g._add_rows(f, t, gap, wt, se)
        return g

    def _add_rows(self, f, t, gap, wt, se):
        out, into = self.out, self.into
        for fi, ti, gi, wi, si in zip(f.tolist(), t.tolist(),
                                      gap.tolist(), wt.tolist(),
                                      se.tolist()):
            rec = {"gap": gi, "weight": wi, "se": si, "deleted": False}
            out[fi][ti] = rec
            into[ti][fi] = rec

    def delete(self, f, t, with_twin=True):
        rec = self.out.get(f, {}).get(t)
        if rec:
            rec["deleted"] = True
        if with_twin:
            tf, tt = int(self.twin[t]), int(self.twin[f])
            rec2 = self.out.get(tf, {}).get(tt)
            if rec2:
                rec2["deleted"] = True

    def out_live(self, c):
        return [(t, r) for t, r in self.out.get(c, {}).items()
                if not r["deleted"] and self.unique[t]]

    def in_live(self, c):
        return [(f, r) for f, r in self.into.get(c, {}).items()
                if not r["deleted"] and self.unique[f]]


def delete_weak(g: ConnGraph, cutoff: int):
    """deleteWeakCnt (transcriptome.c:470)."""
    for f, outs in g.out.items():
        for t, rec in outs.items():
            if not rec["deleted"] and 0 < rec["weight"] < cutoff:
                rec["deleted"] = True


def delete_unlikely(g: ConnGraph, n_ctg: int, cut_off: int):
    """deleteUnlikelyCnt (-c, transcriptome.c:2202-2228): for every
    NON-unique contig with more than cut_off live links to unique
    contigs, keep only the cut_off heaviest (removeUnnecessaryConnection
    :2155 — we take the true k-th largest weight as the threshold; the
    reference's hand-rolled top-10 insertion sort at :2166-2180 drops
    displaced entries, so its threshold can come out lower — strictly
    fewer deletions — on >3 distinct weights).  Off when 0 or >10."""
    if cut_off == 0 or cut_off > 10:
        return
    for c in range(n_ctg):
        if g.unique[c]:
            continue
        outs = [(t, r) for t, r in g.out.get(c, {}).items()
                if not r["deleted"] and g.unique[t]]
        if len(outs) <= cut_off:
            continue
        kth = sorted((r["weight"] for _, r in outs), reverse=True)[
            cut_off - 1]
        for t, r in outs:
            if r["weight"] < kth:
                g.delete(c, t)


def _weak_mask(wt: np.ndarray, cutoff: int) -> np.ndarray:
    """Vectorized deleteWeakCnt (transcriptome.c:470): rows with
    0 < weight < cutoff die."""
    return ~((wt > 0) & (wt < cutoff))


def _unlikely_mask(f, t, wt, alive, unique, twin, n_ctg,
                   cut_off: int) -> np.ndarray:
    """Vectorized deleteUnlikelyCnt (-c, transcriptome.c:2202-2228):
    for every NON-unique source with more than cut_off live links to
    unique targets, keep the cut_off heaviest (twin rows die along,
    like ConnGraph.delete)."""
    if cut_off == 0 or cut_off > 10 or f.size == 0:
        return alive
    sel = alive & ~unique[f] & unique[t]
    idx = np.nonzero(sel)[0]
    if idx.size == 0:
        return alive
    order = np.lexsort((-wt[idx], f[idx]))
    fi = f[idx][order]
    wi = wt[idx][order]
    start = np.concatenate([[True], fi[1:] != fi[:-1]])
    group_start = np.maximum.accumulate(
        np.where(start, np.arange(fi.size), 0))
    rank = np.arange(fi.size) - group_start
    # threshold per group = weight at rank cut_off-1 (desc order);
    # groups smaller than cut_off never set one -> keep everything
    seg = np.cumsum(start) - 1
    kth_of_group = np.full(int(seg[-1]) + 1, -1, wi.dtype)
    at_k = rank == cut_off - 1
    kth_of_group[seg[at_k]] = wi[at_k]
    kth = kth_of_group[seg]
    doomed_local = (kth >= 0) & (wi < kth)
    doomed_rows = idx[order][doomed_local]
    alive = alive.copy()
    alive[doomed_rows] = False
    # twin rows: (twin[t], twin[f]) of each doomed row
    key = f.astype(np.int64) * n_ctg + t
    skey = np.argsort(key, kind="stable")
    twin_key = twin[t[doomed_rows]].astype(np.int64) * n_ctg + \
        twin[f[doomed_rows]]
    pos = np.searchsorted(key[skey], twin_key)
    pos = np.clip(pos, 0, key.size - 1)
    hit = key[skey[pos]] == twin_key
    alive[skey[pos][hit]] = False
    return alive


def _components(f, t, twin, n_ctg: int):
    """Undirected connected components over twin-pair representatives
    (label propagation with pointer jumping).  Returns (n,) labels
    (min member rep) over contigs, -1 where untouched."""
    rep = np.minimum(np.arange(n_ctg), twin)
    lbl = np.arange(n_ctg, dtype=np.int64)
    rf = rep[f]
    rt = rep[t]
    for _ in range(64):
        m = np.minimum(lbl[rf], lbl[rt])
        before = lbl.copy()
        np.minimum.at(lbl, rf, m)
        np.minimum.at(lbl, rt, m)
        lbl = np.minimum(lbl, lbl[lbl])
        lbl = lbl[lbl]
        if np.array_equal(lbl, before):
            break
    touched = np.zeros(n_ctg, bool)
    touched[rf] = True
    touched[rt] = True
    touched |= touched[twin]
    lbl = lbl[rep]  # contigs share their rep's label
    return np.where(touched, lbl, -1)


def _oriented_locus(g: ConnGraph, members: List[int],
                    twin) -> List[int]:
    """Oriented membership of one component: BFS from the smallest
    member row in its stored orientation (matches get_loci's
    ascending-row seed + claim-the-twin exploration)."""
    member_set = set(members) | {int(twin[c]) for c in members}
    visited = set()
    comp: List[int] = []
    for seed in sorted(members):
        if seed in visited or int(twin[seed]) in visited:
            continue
        if not g.out_live(seed) and not g.in_live(seed):
            visited.add(seed)
            visited.add(int(twin[seed]))
            continue
        stack = [seed]
        visited.add(seed)
        visited.add(int(twin[seed]))
        while stack:
            x = stack.pop()
            comp.append(x)
            nbrs = [t for t, _ in g.out_live(x)] + \
                   [f for f, _ in g.in_live(x)] + \
                   [int(twin[t]) for t, _ in
                    g.out_live(int(twin[x]))] + \
                   [int(twin[f]) for f, _ in
                    g.in_live(int(twin[x]))]
            for t in nbrs:
                if t not in visited and int(twin[t]) not in visited \
                        and t in member_set:
                    visited.add(t)
                    visited.add(int(twin[t]))
                    stack.append(t)
    return comp


def get_loci(g: ConnGraph, n_ctg: int) -> List[List[int]]:
    """Oriented connected components over unique contigs
    (getLociCount/getLoci + propagateComponent, :327-468): BFS through
    live connections both ways; visiting a contig claims its twin."""
    visited = np.zeros(n_ctg, bool)
    loci = []
    for c in range(n_ctg):
        if visited[c] or not g.unique[c]:
            continue
        if not g.out_live(c) and not g.in_live(c):
            visited[c] = visited[int(g.twin[c])] = True
            continue  # isolated contigs become leftover singletons
        comp, stack = [], [c]
        visited[c] = visited[int(g.twin[c])] = True
        while stack:
            x = stack.pop()
            comp.append(x)
            nbrs = [t for t, _ in g.out_live(x)] + \
                   [f for f, _ in g.in_live(x)] + \
                   [int(g.twin[t]) for t, _ in
                    g.out_live(int(g.twin[x]))] + \
                   [int(g.twin[f]) for f, _ in
                    g.in_live(int(g.twin[x]))]
            for t in nbrs:
                if not visited[t] and g.unique[t]:
                    visited[t] = visited[int(g.twin[t])] = True
                    stack.append(t)
        loci.append(comp)
    return loci


def _trace_along_connection(g: ConnGraph, dest: int, start: int,
                            skip_rec: dict, max_steps: int,
                            lo: int, hi: int, k: int) -> bool:
    """traceAlongConnection (transcriptome.c:562-598): bounded DFS over
    live unique connections, excluding the direct connection object;
    accumulated length = sum over interior contigs of
    (K-exclusive contig length + the gap INTO the contig) — the gap
    into the destination is NOT counted (reference quirk, :585-589).
    Lengths here use this module's conventions (ctg_len is K-inclusive,
    gaps are physical), so each interior contributes
    full_len + gap_phys.  True when any route lands in [lo, hi]."""
    found = [False]

    def rec(node, pos, length, gap_in):
        if found[0] or pos > max_steps:
            return
        if pos > 0 and node == dest and length >= lo:
            found[0] = True
            return
        if pos == max_steps or length >= hi:
            return
        if pos > 0:
            length += int(g.ctg_len[node]) + gap_in  # full + gap_phys
        for t, r in g.out_live(node):
            if r is skip_rec or r["deleted"]:
                continue
            rec(t, pos + 1, length, r["gap"])

    rec(start, 0, 0, 0)
    return found[0]


def linearize(g: ConnGraph, locus: List[int], params: ScaffParams,
              k: int = 0):
    """The reference's linearization = deleteUnnecessary per locus
    (transcriptome.c:777-835; simply_linear/bal_simply_linear are
    commented out at :829-830): every live PE-only connection
    (SECount==0, PECount>0) dies when an alternative route through
    live unique connections lands within gapLen +- 2*ins_size_var,
    routes bounded by max_step contigs."""
    if len(locus) <= 2:
        return  # linearization skips 2-contig loci (:825-826)
    v2 = 2 * params.ins_size_var
    for c in locus:
        for d, rec in list(g.out_live(c)):
            if rec["deleted"] or rec["se"] > 0 or rec["weight"] <= 0:
                continue
            gap_ref = rec["gap"] + k  # CONNECT gapLen convention
            if _trace_along_connection(
                    g, d, c, rec, params.max_step,
                    gap_ref - v2, gap_ref + v2, k):
                g.delete(c, d)


def delete_inconsistent(g: ConnGraph, locus: List[int]):
    """deleteInconsistent (transcriptome.c:500): inside a locus each
    contig has a chosen orientation; links to twin-side targets die."""
    if len(locus) <= 1:
        return
    chosen = set(locus)
    for c in locus:
        for t, rec in list(g.out_live(c)):
            if int(g.twin[t]) in chosen and t not in chosen:
                g.delete(c, t)
        bal = int(g.twin[c])
        for t, rec in list(g.out_live(bal)):
            if t in chosen:
                g.delete(bal, t)


def avoid_loops(g: ConnGraph, locus: List[int]):
    """avoidLoop/tourLoci/found_repeat (transcriptome.c:843-1079):
    DFS; back-edges (cycles) are deleted."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {c: WHITE for c in locus}
    for start in locus:
        if color.get(start, BLACK) != WHITE:
            continue
        stack = [(start, iter([t for t, _ in g.out_live(start)]))]
        color[start] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for t in it:
                if color.get(t, BLACK) == GRAY:
                    g.delete(node, t)  # back edge: break the cycle
                    continue
                if color.get(t, BLACK) == WHITE:
                    color[t] = GRAY
                    stack.append((t, iter([x for x, _ in g.out_live(t)])))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()


def classify(g: ConnGraph, locus: List[int]) -> str:
    """getLocusKind (transcriptome.c:1080-1156)."""
    if len(locus) <= 2:
        return LINEAR
    dist = [0, 0, 0]
    for c in locus:
        for node in (c, int(g.twin[c])):
            k = len(g.out_live(node))
            if k == 0:
                dist[0] += 1
            elif k == 2:
                dist[1] += 1
            elif k >= 3:
                dist[2] += 1
    if dist == [2, 0, 0]:
        return LINEAR
    if dist == [3, 1, 0]:
        return FORK
    if dist == [2, 2, 0]:
        return BUBBLE
    return COMPLEX


def _sources(g: ConnGraph, locus: List[int]) -> List[int]:
    return [c for c in locus if not g.in_live(c)]


def all_paths(g: ConnGraph, locus: List[int], params: ScaffParams
              ) -> List[List[int]]:
    """getAllPath/allPath (transcriptome.c:1742-1865): enumerate every
    source->sink path (loci here are DAGs after avoid_loops)."""
    paths: List[List[int]] = []
    srcs = _sources(g, locus) or locus[:1]
    for s in srcs:
        stack = [(s, [s])]
        while stack and len(paths) < params.max_routes:
            node, path = stack.pop()
            outs = g.out_live(node)
            if not outs:
                paths.append(path)
                continue
            for t, _ in outs:
                if t in path:  # safety vs residual cycles
                    paths.append(path)
                    continue
                stack.append((t, path + [t]))
    return paths


def heaviest_paths(g: ConnGraph, locus: List[int], cvg,
                   params: ScaffParams) -> List[List[int]]:
    """COMPLEX-locus extraction (transcriptome.c:1544-2117):
    repeatedly pick the highest-coverage unused contig, score a DP
    backward along connections with a 10000x bonus for paths through
    it, trace the best path, mark members used; stop when all contigs
    are used or -t paths were emitted."""
    used = {c: False for c in locus}
    order = _topo_order(g, locus)
    paths = []
    for _ in range(params.max_transcripts):
        if all(used.values()):
            break
        heavy = max((c for c in locus if not used[c]),
                    key=lambda c: float(cvg[c]), default=None)
        if heavy is None:
            break
        # -1 sentinel for "no predecessor" — contig row 0 is a valid
        # path member/head (getBestWay traceback semantics,
        # reference src/transcriptome.c:1599)
        score: Dict[int, float] = {}
        best_pred: Dict[int, int] = {}
        for c in order:  # topological: preds scored first
            s, bp = 0.0, -1
            for f, rec in g.in_live(c):
                bonus = 10000.0 if (f == heavy or c == heavy) else 1.0
                val = bonus * rec["weight"] + score.get(f, 0.0)
                if val > s:
                    s, bp = val, f
            score[c] = s
            best_pred[c] = bp
        # best endpoint: max score among sinks reachable through heavy,
        # falling back to global max score
        def through_heavy(c):
            while c != -1:
                if c == heavy:
                    return True
                c = best_pred.get(c, -1)
            return False
        sinks = [c for c in locus if not g.out_live(c)] or locus
        cand = [c for c in sinks if through_heavy(c)] or sinks
        end = max(cand, key=lambda c: score.get(c, 0.0))
        path = []
        c = end
        while c != -1:
            path.append(c)
            used[c] = True
            c = best_pred.get(c, -1)
        path.reverse()
        if len(path) >= 1:
            paths.append(path)
    return paths


def _topo_order(g: ConnGraph, locus: List[int]) -> List[int]:
    indeg = {c: len(g.in_live(c)) for c in locus}
    order, queue = [], [c for c in locus if indeg[c] == 0]
    while queue:
        c = queue.pop()
        order.append(c)
        for t, _ in g.out_live(c):
            if t in indeg:
                indeg[t] -= 1
                if indeg[t] == 0:
                    queue.append(t)
    # residual cycle members appended arbitrarily
    for c in locus:
        if c not in order:
            order.append(c)
    return order


def build_transcripts(graph_loci, cvg,
                      params: ScaffParams) -> List[Transcript]:
    """graph_loci: [(ConnGraph, oriented locus member list)] — each
    locus carries the (possibly per-component mini) graph it lives in."""
    out: List[Transcript] = []
    for li, (g, locus) in enumerate(graph_loci):
        kind = classify(g, locus)
        if kind == COMPLEX and len(locus) > params.max_step:
            paths = heaviest_paths(g, locus, cvg, params)
        else:
            paths = all_paths(g, locus, params)
        for pi, path in enumerate(paths):
            if len(path) < 2:
                continue  # single-contig paths stay leftover singletons
            gaps = []
            for a, b in zip(path[:-1], path[1:]):
                rec = g.out.get(a, {}).get(b)
                gaps.append(int(rec["gap"]) if rec else 0)
            out.append(Transcript(li, pi, kind, path, gaps))
    return out


def _loci_in(g: ConnGraph, candidates, twin) -> List[List[int]]:
    """get_loci's oriented-component walk restricted to a candidate
    contig list (used per mini graph; candidates are the component's
    directed endpoints, ascending)."""
    visited = set()
    loci: List[List[int]] = []
    for seed in candidates:
        if seed in visited or not g.unique[seed]:
            continue
        if not g.out_live(seed) and not g.in_live(seed):
            visited.add(seed)
            visited.add(int(twin[seed]))
            continue
        comp, stack = [], [seed]
        visited.add(seed)
        visited.add(int(twin[seed]))
        while stack:
            x = stack.pop()
            comp.append(x)
            nbrs = [t for t, _ in g.out_live(x)] + \
                   [f for f, _ in g.in_live(x)] + \
                   [int(twin[t]) for t, _ in
                    g.out_live(int(twin[x]))] + \
                   [int(twin[f]) for f, _ in
                    g.in_live(int(twin[x]))]
            for t in nbrs:
                if t not in visited and g.unique[t]:
                    visited.add(t)
                    visited.add(int(twin[t]))
                    stack.append(t)
        loci.append(comp)
    return loci


def build_structure(conn, twin, full_len, unique, cvg,
                    params: ScaffParams, k: int = 0
                    ) -> List[Transcript]:
    """The transcriptome() structure phase (transcriptome.c:2223-2345),
    scaled: weak/unlikely filters and connected components run
    vectorized over the COO connection arrays; the per-locus graph
    surgery (linearize/deleteInconsistent/avoidLoop) builds a small
    dict graph per component only — no global dict graph, no global
    per-contig scans."""
    n_rows = int(conn.n)
    n_ctg_rows = full_len.shape[0]
    f = np.asarray(conn.from_ctg[:n_rows]).astype(np.int64)
    t = np.asarray(conn.to_ctg[:n_rows]).astype(np.int64)
    gap = np.asarray(conn.gap[:n_rows])
    wt = np.asarray(conn.weight[:n_rows])
    se = np.asarray(conn.se_count[:n_rows])
    ok = (f >= 0) & (t >= 0)
    f, t, gap, wt, se = f[ok], t[ok], gap[ok], wt[ok], se[ok]
    twin = np.asarray(twin).astype(np.int64)

    alive = _weak_mask(wt, params.weak_cnt)
    alive = _unlikely_mask(f, t, wt, alive, unique, twin, n_ctg_rows,
                           params.max_cnt)
    uu = alive & unique[f] & unique[t]
    lbl = _components(f[uu], t[uu], twin, n_ctg_rows)

    comp_of_row = lbl[np.minimum(f, twin[f])]
    rows = np.nonzero(uu & (comp_of_row >= 0))[0]
    order = rows[np.argsort(comp_of_row[rows], kind="stable")]
    comp_sorted = comp_of_row[order]
    starts = np.concatenate(
        [[0], np.nonzero(comp_sorted[1:] != comp_sorted[:-1])[0] + 1,
         [order.size]])

    graph_loci = []
    for gi in range(starts.size - 1):
        rr = order[starts[gi]:starts[gi + 1]]
        gl = ConnGraph.from_rows(
            f[rr], t[rr], gap[rr], wt[rr], se[rr], twin, full_len,
            unique)
        cands = sorted(set(f[rr].tolist()) | set(t[rr].tolist()))
        for locus in _loci_in(gl, cands, twin):
            linearize(gl, locus, params, k)
            delete_inconsistent(gl, locus)
            avoid_loops(gl, locus)
            linearize(gl, locus, params, k)
        # loci recomputed after cleanup — components split by
        # deleteInconsistent/avoidLoop become separate loci
        # (transcriptome.c:2256-2266)
        for locus in _loci_in(gl, cands, twin):
            graph_loci.append((gl, locus))
    return build_transcripts(graph_loci, cvg, params)


def transcript_sequences(transcripts: List[Transcript], seqs: List[str],
                         used_flags: Optional[np.ndarray] = None
                         ) -> List[Tuple[str, str]]:
    """Assemble scaffold sequences: member contigs joined with N gaps
    exactly like the reference's -F-off rendering (outputScafSeq,
    prlReadFillGap.c:637-656): gapN = CONNECT gap (min 1) Ns, then the
    next contig trimmed by cutHead=K.  k is inferred from nothing here,
    so callers that need the trim should use run_scaff; this helper
    keeps the legacy full-join for quick tests."""
    recs = []
    for idx, tr in enumerate(transcripts, start=1):
        parts = []
        for i, c in enumerate(tr.contigs):
            parts.append(seqs[c])
            if i < len(tr.gaps) and tr.gaps[i] > 0:
                parts.append("N" * tr.gaps[i])
            if used_flags is not None:
                used_flags[c] = True
        seq = "".join(parts)
        header = (f"scaffold{idx} {len(tr.contigs)} {len(seq)} "
                  f"Locus_{tr.locus}_{tr.index} {tr.kind}")
        recs.append((header, seq))
    return recs


def _host(nt):
    """A NamedTuple of tensors (ConnSet, ArcSet) with its tensor fields
    read to host numpy arrays."""
    return type(nt)(*(x.cpu().numpy() if hasattr(x, "cpu") else x
                      for x in nt))


def collect_gap_reads(junctions, read_ctg, read_pos, batch_factory,
                      twin, full_len, window: int, cap: int,
                      read_ins=None) -> List[List[np.ndarray]]:
    """Recruit reads near each junction for local gap assembly.

    The reference prepares `.readInGap` during map (getReadIngap,
    prlRead2Ctg.c:447): a read whose *projected mate* falls past a
    contig end is dropped into that gap.  Placements here are already
    orientation-resolved onto directed contig rows, so for an FR pair
    the mate of a read at pos p on row c spans [p+ins-rl, p+ins) in
    row-c coordinates — if that window crosses the row's end, the mate
    lies in the junction gap.  Two recruitment tiers per junction
    (c1, c2, gap), ``cap // 2`` reads each:

    * mate-projection: reads on a 'tail' side whose projected mate
      overlaps the gap, shallowest first (these recover the gap's
      interior — the mates themselves are usually unmappable);
    * self-proximity: reads placed closest to the junction (these
      anchor the walk at the flanks).

    The selected reads and their PE mates (pairs are adjacent in the
    stream) are picked up in one pass over ``batch_factory()``, the
    mapping read stream in the order the placements were numbered.
    Returns, per junction, the reads' uint8 code rows in ascending read
    number."""
    read_ctg = np.asarray(read_ctg)
    read_pos = np.asarray(read_pos)
    ins = None if read_ins is None else np.asarray(read_ins)
    # reads grouped by contig, ascending read number within a contig
    placed = np.flatnonzero(read_ctg >= 0)
    by_ctg = placed[np.argsort(read_ctg[placed], kind="stable")]
    ctg_sorted = read_ctg[by_ctg]
    take = cap // 2
    want_read, want_slot = [], []
    for s, (c1, c2, gap) in enumerate(junctions):
        near: List[Tuple[int, int]] = []   # (dist to junction, read)
        mates: List[Tuple[int, int]] = []  # (projected depth, read)
        for c, tail in ((c1, True), (int(twin[c1]), False),
                        (c2, False), (int(twin[c2]), True)):
            ln = int(full_len[c])
            rows = by_ctg[np.searchsorted(ctg_sorted, c):
                          np.searchsorted(ctg_sorted, c, side="right")]
            pos = read_pos[rows]
            keep = pos >= ln - window if tail else pos <= window
            rows, pos = rows[keep], pos[keep]
            near.extend(zip(((ln - pos) if tail else pos).tolist(),
                            rows.tolist()))
            if tail and ins is not None:
                mate_end = pos + ins[rows]
                in_gap = (ins[rows] > 0) & (mate_end > ln) & \
                    (mate_end <= ln + max(gap, 0) + window)
                mates.extend(zip((mate_end[in_gap] - ln).tolist(),
                                 rows[in_gap].tolist()))
        near.sort()
        mates.sort()
        picked = {i for _d, i in mates[:take] + near[:take]}
        picked |= {i ^ 1 for i in picked}  # the PE mate is stream-adjacent
        want_read.extend(picked)
        want_slot.extend([s] * len(picked))
    gap_reads: List[List[np.ndarray]] = [[] for _ in junctions]
    if not want_read:
        return gap_reads
    want_read = np.asarray(want_read, np.int64)
    want_slot = np.asarray(want_slot, np.int64)
    order = np.lexsort((want_slot, want_read))
    want_read, want_slot = want_read[order], want_slot[order]
    base = 0  # dense number of the batch's first real read
    for codes, lens, _li in batch_factory():
        lens = np.asarray(lens)
        real = np.flatnonzero(lens > 0)
        if real.size == 0:
            continue
        lo, hi = np.searchsorted(want_read, (base, base + real.size))
        if hi > lo:
            local = real[want_read[lo:hi] - base]
            picked = np.asarray(codes)[local].astype(np.uint8)
            for row, ln, s in zip(picked, lens[local].tolist(),
                                  want_slot[lo:hi].tolist()):
                gap_reads[s].append(row[:ln])
        base += real.size
    return gap_reads


def run_scaff(contigs, conn, k: int, table,
              params: Optional[ScaffParams] = None, ctg_arcs=None,
              gap_read_source=None, preset_transcripts=None
              ) -> ScaffResult:
    """Full scaffold stage: returns a ScaffResult.

    .recs: list of (header, sequence) for .scafSeq — transcripts first,
    then leftover contigs >= 100bp as '>C<row>' singletons (reference
    prlReadFillGap.c:1453-1461).

    gap_read_source: optional (read_ctg, read_pos, batch_factory[,
    read_ins]) for -F local gap assembly (params.fill_gaps);
    batch_factory re-streams the mapping read stream in the order the
    placements were numbered.

    gap_report: list of (scaffold_index, junction_index, method,
    sequence) for filled gaps — the .gapSeq payload.

    preset_transcripts: skip structure building and reuse an existing
    transcript list (-S "scaffold structure exists", scaffold.c:47 —
    resume from .scaf_gap straight into gap closing)."""
    from ..graph import contig_merge, gapfill
    from ..utils import profiling

    seconds: Dict[str, float] = {}
    params = params or ScaffParams()
    n_ctg = contigs.n
    with profiling.phase(seconds, "scaff", "structure"):
        twin = contigs.twin.cpu().numpy()
        full_len = contigs.length.cpu().numpy() + k
        if preset_transcripts is not None:
            transcripts = preset_transcripts
        else:
            unique = np.zeros(full_len.shape[0], bool)
            unique[:n_ctg] = full_len[:n_ctg] >= params.min_unique_len
            transcripts = build_structure(
                _host(conn), twin, full_len, unique,
                contigs.cvg.cpu().numpy(), params, k)

    # (a span, not a phase: ``phase_seconds`` has no key for it)
    with profiling.span("scaff.routes"):
        seqs = contig_merge.contig_sequences(contigs, table, k)
        used = np.zeros(full_len.shape[0], bool)
        router = ArcRouter(_host(ctg_arcs), full_len, k) \
            if ctg_arcs is not None else None

        # junctions: (c1, c2, gap), numbered across the transcripts
        juncs = [(tr.contigs[ji], tr.contigs[ji + 1], tr.gaps[ji])
                 for tr in transcripts for ji in range(len(tr.contigs) - 1)]

        # strategy 1: unique arc route through the contig graph.  Routes
        # are found for every junction (the reference writes them as GAP
        # lines in .scaf_gap regardless of -F, transcriptome.c:1195-1205);
        # their SEQUENCE is spliced only under -F — without fillGap the
        # reference ignores GAP lines entirely and renders Ns
        # (prlReadFillGap.c:1347-1356: procGap is called only
        # `if (fillGap)`).
        routes: Dict[int, List[int]] = {}
        if router is not None:
            for jid, (c1, c2, gap) in enumerate(juncs):
                r = router.find_route(c1, c2, gap, params.ins_size_var)
                if r is not None:
                    routes[jid] = r
    splice_routes = routes if params.fill_gaps else {}

    # strategies 2+3: overlap merge / read-local assembly (-F)
    fill: Dict[int, Tuple[str, str, int]] = {}  # jid -> (kind, seq, ov)
    pending = [jid for jid in range(len(juncs)) if jid not in splice_routes]
    if pending and params.fill_gaps:
        with profiling.phase(seconds, "scaff", "collect"):
            if gap_read_source is not None:
                read_ctg, read_pos, batch_factory = gap_read_source[:3]
                greads = collect_gap_reads(
                    [juncs[jid] for jid in pending], read_ctg, read_pos,
                    batch_factory, twin, full_len, params.gap_read_window,
                    params.max_reads_per_gap,
                    read_ins=gap_read_source[3] if len(gap_read_source) > 3
                    else None)
            else:
                greads = [[] for _ in pending]
        with profiling.phase(seconds, "scaff", "fill"):
            res = gapfill.fill_gaps(
                [(seqs[juncs[jid][0]], seqs[juncs[jid][1]],
                  int(juncs[jid][2])) for jid in pending],
                greads, k, contigs.length.device, tol=params.gap_len_diff)
        seconds.update({f"fill_{name}": sec
                        for name, sec in res.phase_seconds.items()})
        for slot, jid in enumerate(pending):
            if res.filled[slot]:
                ov = int(res.overlap[slot])
                fill[jid] = ("overlap", "", ov) if ov > 0 else \
                    ("localasm", res.fill_seq[slot], 0)

    # --- splice sequences ---
    with profiling.phase(seconds, "scaff", "render"):
        recs: List[Tuple[str, str]] = []
        gap_report: List[Tuple[int, int, str, str]] = []
        placements: List[List[Tuple[int, int, int, str]]] = []
        n_runs: Dict[int, int] = {}
        n_routed = n_filled = 0
        jid = 0

        def strand(c):
            return "+" if c <= int(twin[c]) else "-"

        for idx, tr in enumerate(transcripts, start=1):
            c0 = tr.contigs[0]
            parts = [seqs[c0]]
            pos = len(seqs[c0])
            place = [(c0, 0, pos, strand(c0))]
            used[c0] = True

            def put(c, cut):
                """Append contig c without its first ``cut`` bases."""
                nonlocal pos
                parts.append(seqs[c][cut:])
                place.append((c, pos, len(seqs[c]) - cut, strand(c)))
                pos += len(seqs[c]) - cut

            for ji, c2 in enumerate(tr.contigs[1:]):
                if jid in splice_routes:
                    for x in splice_routes[jid]:
                        put(x, k)
                    put(c2, k)
                    n_routed += 1
                    gap_report.append((idx, ji, "route", "".join(
                        seqs[x][k:] for x in splice_routes[jid])))
                elif jid in fill:
                    kind, fseq, ov = fill[jid]
                    if kind == "overlap":
                        put(c2, ov)
                    else:
                        parts.append(fseq)
                        pos += len(fseq)
                        put(c2, 0)
                    n_filled += 1
                    gap_report.append((idx, ji, kind, fseq))
                else:
                    # no fill: gapN Ns (the CONNECT gap, min 1) + the next
                    # contig trimmed by cutHead=K — reference outputScafSeq
                    # with initiateCtgInScaf's cutHead=overlaplen default
                    # (prlReadFillGap.c:265-270,637-656); without -F,
                    # procGap never runs so every junction renders this way
                    # (prlReadFillGap.c:1347-1356)
                    gap_n = max(tr.gaps[ji] + k, 1)
                    parts.append("N" * gap_n)
                    pos += gap_n
                    n_runs[jid] = gap_n
                    put(c2, k)
                used[c2] = True
                jid += 1
            seq = "".join(parts)
            header = (f"scaffold{idx} {len(tr.contigs)} {len(seq)} "
                      f"Locus_{tr.locus}_{tr.index} {tr.kind}")
            recs.append((header, seq))
            placements.append(place)
        if n_routed or n_filled:
            print(f"[scaff] gaps closed: {n_routed} arc routes, "
                  f"{n_filled} overlap/local-asm of {len(juncs)}")

        # leftover singletons (one per twin pair)
        for c in range(n_ctg):
            if used[c] or used[int(twin[c])] or full_len[c] < 100:
                continue
            if c > int(twin[c]):
                continue
            recs.append((f"C{c}", seqs[c]))
            used[c] = used[int(twin[c])] = True
    return ScaffResult(recs, transcripts, scaf_stats(recs), gap_report,
                       placements, routes, n_runs, seconds, conn.n)


def scaf_stats(recs: List[Tuple[str, str]]) -> Dict[str, float]:
    """ScafStat (reference orderContig.c:2421): base composition,
    N50/N90, longest — the .scafStatistics payload."""
    lengths = sorted((len(s) for _, s in recs), reverse=True)
    if not lengths:
        return {"count": 0}
    total = sum(lengths)
    acc, n50, n90 = 0, 0, 0
    for L in lengths:
        acc += L
        if not n50 and acc >= total * 0.5:
            n50 = L
        if not n90 and acc >= total * 0.9:
            n90 = L
    comp = defaultdict(int)
    for _, s in recs:
        for ch in "ACGTN":
            comp[ch] += s.count(ch)
    return {"count": len(lengths), "total": total, "longest": lengths[0],
            "N50": n50, "N90": n90, **{f"n_{c}": comp[c] for c in "ACGTN"}}


class ArcRouter:
    """Bounded DFS route finder over the contig arc graph.

    Equivalent of traceAlongArc (reference src/searchPath.c:181) +
    output1gap: find the unique contig path c1 -> ... -> c2 whose
    spliced length matches the PE/SE gap estimate, so scaffold gaps
    carry real sequence instead of Ns (the -F-less part of
    prlReadsCloseGap's gap closing)."""

    MAX_TRACE = 5000

    def __init__(self, aset, ctg_len, k):
        self.k = k
        self.ctg_len = ctg_len
        self.adj: Dict[int, List[int]] = defaultdict(list)
        n = int(aset.n)
        # group arcs by source with one argsort instead of a per-arc
        # Python loop (millions of arcs on real data)
        f = np.asarray(aset.from_ed[:n])
        t = np.asarray(aset.to_ed[:n])
        m = np.asarray(aset.mult[:n])
        sel = (f >= 0) & (t >= 0) & (m > 0)
        f, t = f[sel], t[sel]
        order = np.argsort(f, kind="stable")
        f, t = f[order], t[order]
        uniq, starts = np.unique(f, return_index=True)
        bounds = np.append(starts, f.shape[0])
        for j, c in enumerate(uniq.tolist()):
            self.adj[c] = t[bounds[j]:bounds[j + 1]].tolist()

    def find_route(self, c1, c2, gap, tol, max_step=5,
                   max_routes=10) -> Optional[List[int]]:
        """Unique intermediate path c1->...->c2 with
        sum(len_full(x) - K) - K within gap +- tol, or None."""
        routes: List[List[int]] = []
        trace = 0
        k = self.k

        def dfs(node, inter, length):
            nonlocal trace
            trace += 1
            if trace > self.MAX_TRACE or len(routes) > max_routes:
                return
            for t in self.adj.get(node, ()):  # noqa: B007
                if t == c2:
                    if abs(length - k - gap) <= tol:
                        routes.append(list(inter))
                        if len(routes) > max_routes:
                            return
                if len(inter) < max_step and t not in (c1, c2) and t not in inter:
                    add = int(self.ctg_len[t]) - k
                    if length + add - k <= gap + tol:
                        inter.append(t)
                        dfs(t, inter, length + add)
                        inter.pop()

        dfs(c1, [], 0)
        if len(routes) == 1:
            return routes[0]
        return None


def record_membership(recs: List[Tuple[str, str]],
                      transcripts: List[Transcript],
                      twin, n_ctg: int) -> Dict[int, int]:
    """contig row -> index of the first .scafSeq record containing it
    (transcripts first, then C-singletons), twin-insensitive —
    the analogue of .contigPosInscaff (prlReadFillGap outputSeqs)."""
    owner: Dict[int, int] = {}
    for ri, tr in enumerate(transcripts):
        for c in tr.contigs:
            owner.setdefault(c, ri)
            owner.setdefault(int(twin[c]), ri)
    for ri, (h, _s) in enumerate(recs[len(transcripts):], len(transcripts)):
        if h.startswith("C"):
            c = int(h[1:].split()[0])
            owner.setdefault(c, ri)
            owner.setdefault(int(twin[c]), ri)
    return owner


def reads_on_scaffolds(read_ctg: np.ndarray, owner: Dict[int, int],
                       n_records: int):
    """read -> record index (reference getReadOnScaf, ReadTrace.c:41).
    Returns (per-read record idx or -1, per-record hit counts)."""
    read_ctg = np.asarray(read_ctg)
    hi = max([c for c in owner] + [int(read_ctg.max(initial=0))]) + 1
    owner_arr = np.full(hi + 1, -1, np.int64)
    for c, ri in owner.items():
        owner_arr[c] = ri
    rec_of = np.where(read_ctg >= 0, owner_arr[np.clip(read_ctg, 0, hi)], -1)
    hits = np.bincount(rec_of[rec_of >= 0], minlength=n_records)
    return rec_of, hits.astype(np.int64)


def rpkm_table(recs: List[Tuple[str, str]], hits: np.ndarray
               ) -> List[Tuple[str, int, int, float]]:
    """RPKM per record (reference RPKMStat, orderContig.c:3092-3348):
    hits * 1e9 / (total_mapped_reads * length), in float64."""
    total = int(hits.sum())
    out = []
    for i, (h, s) in enumerate(recs):
        rpkm = (hits[i] * 1e9 / (total * len(s))) if total and len(s) \
            else 0.0
        out.append((h.split()[0], len(s), int(hits[i]), rpkm))
    return out
