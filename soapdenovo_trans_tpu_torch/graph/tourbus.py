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
   heaviest-coverage predecessor;
2. every non-forest arc (u -> t) is a bubble candidate, weakest first;
   walking <= MAXNODELENGTH steps up the forest from t and from u and
   intersecting the two chains gives the fork s and the two paths
   (steps 1-2 and the walks: ``wave.front``);
3. the two paths' sequences are scored by LCS: accept iff LCS >= 90%
   of the longer and |lenA - lenB| <= DIFF (``lcs.identity_check``);
4. accepted candidates claim their edges (scatter-min arbitration);
   claim-disjoint winners apply together: minority edges (and twins)
   deleted, their coverage added onto the covering majority edges,
   the arcs that enter or leave the bubble from outside remapped onto
   the majority path where they still join, every other arc of a
   minority edge dropped; a wave where nothing merges retires its
   candidates into ``failed`` (``wave.back``).

The arc rule departs from the JAX package, which remaps every arc of a
minority edge onto its cover, the bubble's own arcs included, and so
can join two edges whose end and start K-mers differ (a cover -> join
row that skips a majority node): the contigs then lose or gain the
bases between.  The reference keeps every join consistent
(cleanUpRedundancy, bubble.c:1617, splits node descriptors to do so);
the port, which cannot split an edge, drops such a row.

On a card each of the three named steps is a hand kernel, and a wave
runs no sort.

Waves repeat to a fixpoint like the reference's HasChanged loop
(:2123).  Inside a wave the host reads nothing; ``pinch`` reads the
wave's five counts once per wave.  As the JAX package jits ``_wave`` and
keeps the arc table at a rounded capacity so one compiled wave serves
wave after wave, a pinch runs its waves as one program over buffers of
fixed shapes (``WaveProgram``): on a card the first wave runs eagerly,
the second is captured into a CUDA graph, and every later wave replays
it.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Tuple

import torch

from ..kernels import lcs, wave
from ..utils import profiling
from . import arcs as arcs_mod
from . import unitigs
from .edge_clean import rebuild_arcs

SEQ_CAP = 384    # longest differing-path sequence considered per side
CAND_CAP = 1024  # candidates arbitrated per wave (rest -> next wave)

CAPTURES = 0  # CUDA graphs captured since the last reset (one a pinch)
REPLAYS = 0   # waves run as replays of a captured graph since the reset
# (module, executions counter, capture counter) of each kernel of a wave
_KERNELS = ((wave, "FRONT_LAUNCHES", "FRONT_CAPTURED"),
            (lcs, "IDENTITY_LAUNCHES", "IDENTITY_CAPTURED"),
            (wave, "BACK_LAUNCHES", "BACK_CAPTURED"))


def _params_for(merge_level: int) -> Tuple[int, int]:
    """(MAXNODELENGTH, DIFF) per -M (bubble.c:2072-2086)."""
    if merge_level <= 1:
        return 3, 2
    if merge_level == 2:
        return 9, 3
    return 30, 10


def _wave_parts(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, failed,
                mark, m_max: int, diff: int, seq_cap: int, cand_cap: int):
    """front -> identity check -> back on one wave's state; the back
    marks ``mark`` (``failed`` or a copy of it) when nothing merges.
    Returns (counts, (cvg2, deleted2, new_f, new_t, new_mult), cid_arc,
    cmask, ok); the five are undefined on a card when counts[0] == 0."""
    # 1-4. live arcs, majority forest, candidates (weakest coverage
    # first, ties in row order), the backward chains up the forest, their
    # first meeting point, the path interiors (fork->join order), their
    # twins and the clash test: the front's kernels on the card
    (cid_arc, cmask, _u, _t0, maj, mnr, tw_maj, tw_mnr, ends, found,
     n_backtracked, n_cand) = wave.front(
        eg.n_edges, eg.deleted, eg.cvg, eg.twin, aset.from_ed, aset.to_ed,
        aset.mult, failed, m_max, cand_cap)

    # path lengths, the length gate, the LCS of the two path sequences
    # and the 90% verdict: one launch of the identity kernel on the card
    len_a, len_b, compared, ok, _ = lcs.identity_check(
        maj, mnr, found, eg.length, eg.seq_off, eg.seq_pool, diff, seq_cap)

    # 5-6. the counts; claim arbitration (edge-disjoint winners, the
    # lowest (minority coverage, candidate index) claim wins) and apply
    # (minority nodes and twins deleted, coverage folded positionally,
    # the arcs from outside remapped onto the covering majority node
    # where they still join, the rest dropped); with no ok row, the
    # examined candidates retired into ``mark``: the back's kernels
    counts, *outs = wave.back(
        maj, mnr, tw_maj, tw_mnr, ends, ok, len_a, len_b, eg.cvg, eg.length,
        eg.twin, eg.deleted, aset.from_ed, aset.to_ed, aset.mult,
        eg.from_node, eg.to_node, compared, cmask, cid_arc, n_cand,
        n_backtracked, cand_cap, mark)
    return counts, outs, cid_arc, cmask, ok


def _wave(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, failed,
          m_max: int, diff: int, seq_cap: int, cand_cap: int):
    """One wave in the outputs of the JAX ``_wave``, ``failed`` left as it
    is: (cvg2, deleted2, new_f, new_t, new_mult, n_backtracked,
    n_compared, n_merged, overflow, cid_arc, fail_mark); the arc rows
    follow the port's rule (``wave.claim_apply_plain``).  On a card the
    first five are undefined when n_merged == 0 (the back skips them)."""
    counts, outs, cid_arc, cmask, ok = _wave_parts(
        eg, aset, failed, failed.clone(), m_max, diff, seq_cap, cand_cap)
    # examined candidates rejected by the checks themselves (not by
    # claim arbitration — those must retry); a pinch retires them when
    # nothing merged
    fail_mark = cmask & ~ok
    return (*outs, counts[2], counts[3], counts[0], counts[1], cid_arc,
            fail_mark)


def _wave_step(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, failed,
               m_max: int, diff: int, seq_cap: int, cand_cap: int):
    """One wave on a pinch's buffers, with no host read: front, identity
    check and back, the back updating ``failed`` in place when nothing
    merged (its examined candidates that the checks rejected); a
    productive wave's ``failed`` is cleared by ``WaveProgram.apply``.
    Returns (counts, cvg2, deleted2, new_f, new_t, new_mult); counts is
    (5,) int64: merged, overflow, backtracked, compared, arc rows
    dropped.  On a card the other five are undefined when counts[0] ==
    0."""
    counts, outs, *_ = _wave_parts(eg, aset, failed, failed, m_max, diff,
                                   seq_cap, cand_cap)
    return (counts, *outs)


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
    an error: a real wave, and the warm-up (the kernel build, the
    identity kernel's shared-memory attribute; the front's and the
    back's scratch are reserved at construction).  The
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
        # the kernels' launches a replay executes, as _KERNELS lists them
        self.replayed = [0] * len(_KERNELS)
        if self.dev.type == "cuda":  # before any capture; kept with the graph
            self.scratch = (wave.claim_scratch(self.dev, eg.cvg.shape[0]),
                            wave.forest_scratch(self.dev, eg.cvg.shape[0]))

    def _step(self):
        return _wave_step(self.eg, self.aset, self.failed, *self.args)

    def launch(self):
        """Enqueue one wave; returns its (5,) counts on the device."""
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
            for (module, executions, _), n in zip(_KERNELS, self.replayed):
                setattr(module, executions, getattr(module, executions) + n)
        self.waves += 1
        return self.outs[0]

    def _capture(self) -> None:
        global CAPTURES
        graph = torch.cuda.CUDAGraph()
        before = [getattr(module, captured) for module, _, captured
                  in _KERNELS]
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.dev)):
            self.outs = self._step()
        self.replayed = [getattr(module, captured) - n for
                         (module, _, captured), n in zip(_KERNELS, before)]
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
    arc rows dropped, waves, productive waves (those that merged), the
    loop's wall seconds and seconds per wave.

    Every productive wave deletes at least one edge; between graph
    changes each unproductive wave retires a fresh CAND_CAP-chunk of
    the remaining candidates (the ``failed`` mask).  The waves run as
    one ``WaveProgram``, one blocking read of five counts a wave.  Inside
    the span ``contig.tourbus``, each wave's enqueue (the eager first
    wave, the capture or a replay) is the span ``contig.tourbus.launch``,
    its count read ``contig.tourbus.read`` (the host's wait on the
    wave's kernels), and each productive wave's ``apply`` is
    ``contig.tourbus.apply``.
    The run's counters (``utils/profiling``) get ``tourbus.<key>`` for
    the waves, productive, merged, compared and arcs_dropped of stats,
    and the waves' shapes: ``tourbus.arc_rows``, the arc buffers' rows
    summed over waves; ``tourbus.cand_rows``, the candidate rows
    (min(CAND_CAP, rows) a wave); ``tourbus.path_slots``, candidate rows
    times MAXNODELENGTH."""
    m_max, diff = _params_for(merge_level)
    stats = {"backtracked": 0, "compared": 0, "merged": 0,
             "arcs_dropped": 0, "waves": 0, "productive": 0,
             "seconds": 0.0}
    rows = aset.from_ed.shape[0]
    with profiling.span("contig.tourbus") as sp:
        # a graph without a single arc row has no bubble (and no candidate
        # for ``_wave`` to shape its chains on)
        if rows:
            prog = WaveProgram(eg, aset, m_max, diff)
            while True:
                stats["waves"] += 1
                with profiling.span("contig.tourbus.launch"):
                    counts = prog.launch()
                with profiling.span("contig.tourbus.read"):
                    n, over, back, cmp_, dropped = counts.tolist()
                stats["backtracked"] += back
                stats["compared"] += cmp_
                if n == 0:
                    if over == 0:
                        break
                    # chunk exhausted without a merge: the wave retired it
                    # into ``failed``; the next examines the next chunk
                    continue
                stats["merged"] += n
                stats["arcs_dropped"] += dropped
                stats["productive"] += 1
                # the merge changed the graph: every rejected candidate may
                # be mergeable now (``apply`` clears the mask)
                with profiling.span("contig.tourbus.apply"):
                    aset = prog.apply()
            if stats["productive"]:
                eg = prog.eg
    stats["seconds"] = sp.seconds
    stats["s_per_wave"] = stats["seconds"] / max(stats["waves"], 1)
    cand_rows = min(CAND_CAP, rows) * stats["waves"]
    counters = {key: stats[key] for key in (
        "waves", "productive", "merged", "compared", "arcs_dropped")}
    counters.update(arc_rows=rows * stats["waves"], cand_rows=cand_rows,
                    path_slots=cand_rows * m_max)
    for key, value in counters.items():
        profiling.counter("tourbus." + key, value)
    return eg, aset, stats
