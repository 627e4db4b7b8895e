"""Stage 2 — contig: edge-graph cleaning + concatenation -> contigs.

Port of ``soapdenovo_trans_tpu/stages/contig.py``, the equivalents of
call_heavygraph (reference src/contig.c:225-296):

    bubblePinch(0.9, M)        [M>0; see graph/bubbles.py]
    deleteWeakEdge(de)
    cutTipsInGraph(0, 0)
    deleteUnlikeArc; delowHighArc(H)
    fixpoint { deleteSimpleLoop; deleteLightArc;
               if changed: linearConcatenate + compactEdgeArray }
    deleteShortContig(48); final linearConcatenate/compact
    output_contig

Each concatenation produces a fresh Contigs graph, so the loop re-runs
the arc filters on progressively merged graphs like the reference's
laps (at most 64, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..graph import arcs as arcs_mod
from ..graph import bubbles, contig_merge, edge_clean, unitigs
from ..utils import profiling

MAX_LAPS = 64


@dataclasses.dataclass
class ContigParams:
    """CLI knobs (reference contig.c initenv + global.h defaults)."""

    weak_cvg: int = 20          # -e EdgeCovCutoff * 10 (default e=2)
    merge_level: int = 1        # -M bubble merge level
    light_out_pct: int = 5      # -q da
    light_flow_pct: int = 2     # -Q dA
    high_arc_multi: int = 200   # -H
    short_component: int = 48   # cut_length


@dataclasses.dataclass
class ContigResult:
    contigs: contig_merge.Contigs
    edge_contig: torch.Tensor  # (E,) input edge -> contig row, or -1
    phase_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    tourbus: Dict[str, float] = dataclasses.field(default_factory=dict)
    laps: int = 0
    # repeat edges split before the stage by ``contig -R`` (None: not run;
    # its seconds are ``phase_seconds["split"]``)
    reps_split: Optional[int] = None


def _as_edgegraph(ctg: contig_merge.Contigs) -> unitigs.EdgeGraph:
    """Re-wrap a Contigs result as an EdgeGraph so the same cleaning and
    concatenation passes run on merged graphs (the node->edge interior
    map no longer applies and is left empty)."""
    none = ctg.length.new_full((1,), -1)
    return unitigs.EdgeGraph(
        from_node=ctg.from_node, to_node=ctg.to_node, length=ctg.length,
        cvg=ctg.cvg, twin=ctg.twin, seq_off=ctg.seq_off,
        seq_pool=ctg.seq_pool, n_edges=ctg.n, node_edge=none, node_pos=none,
        deleted=torch.zeros_like(ctg.length, dtype=torch.bool))


def run_contig(edges: unitigs.EdgeGraph, aset: arcs_mod.ArcSet, k: int,
               params: Optional[ContigParams] = None,
               table=None) -> ContigResult:
    """The full cleaning pipeline.  Phase wall times (bubbles, clean,
    laps, short: the spans ``contig.<phase>``) land in
    ``phase_seconds``; Tour-Bus counters in ``tourbus``."""
    params = params or ContigParams()
    dev = edges.length.device
    phases: Dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def phase(name):
        return profiling.phase(phases, "contig", name, sync)

    stats = {}
    with phase("bubbles"):
        if params.merge_level > 0 and table is not None:
            edges, aset, stats = bubbles.bubble_pinch(
                edges, aset, table, k, params.merge_level)

    with phase("clean"):
        edges = edge_clean.delete_weak_edges(edges, params.weak_cvg)
        edges = edge_clean.cut_tips(edges, aset, k)
        aset = edge_clean.compact_arcs(aset, edges)
        aset = edge_clean.delete_unlike_arcs(aset, edges)
        aset = edge_clean.delow_high_arc(aset, edges, params.high_arc_multi)
        ctg = contig_merge.concatenate(edges, aset)
        edge_contig = ctg.edge2contig
        graph = _as_edgegraph(ctg)
        aset = ctg.arcs

    def follow(ctg):  # compose the input-edge map with one more merge
        return torch.where(edge_contig >= 0,
                           ctg.edge2contig[edge_contig.clamp(min=0)], -1)

    with phase("laps"):
        laps = 0
        for laps in range(1, MAX_LAPS + 1):
            aset = edge_clean.delete_simple_loops(aset, graph)
            aset, changed = edge_clean.delete_light_arcs(
                aset, graph, params.light_out_pct, params.light_flow_pct)
            if not changed:
                break
            aset = edge_clean.compact_arcs(aset, graph)
            ctg = contig_merge.concatenate(graph, aset)
            edge_contig = follow(ctg)
            graph = _as_edgegraph(ctg)
            aset = ctg.arcs

    with phase("short"):
        graph = edge_clean.delete_short_components(
            graph, aset, params.short_component)
        aset = edge_clean.compact_arcs(aset, graph)
        ctg = contig_merge.concatenate(graph, aset)
        edge_contig = follow(ctg)
    print(f"[contig] {ctg.n} contigs ({sum(phases.values()):.1f}s)")
    return ContigResult(ctg, edge_contig, phases, stats, laps)
