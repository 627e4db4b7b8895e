"""Bubble pinching — delegates to the wave-parallel Tour-Bus.

Port of ``soapdenovo_trans_tpu/graph/bubbles.py`` (reference
bubblePinch, src/bubble.c:2048-2135).  The device-parallel formulation
lives in graph/tourbus.py; this module keeps the stage-facing entry
point.
"""

from __future__ import annotations

from . import arcs as arcs_mod
from . import tourbus, unitigs


def bubble_pinch(eg: unitigs.EdgeGraph, aset: arcs_mod.ArcSet,
                 table, k: int, merge_level: int):
    """Run the Tour-Bus bubble pass (no-op at merge_level <= 0).
    Returns (eg, aset, stats); stats is empty when nothing ran."""
    if merge_level <= 0:
        return eg, aset, {}
    eg, aset, stats = tourbus.pinch(eg, aset, k, merge_level)
    print(f"[bubbles] tourbus: {stats['backtracked']} pairs found, "
          f"{stats['compared']} compared, {stats['merged']} merged "
          f"({stats['waves']} waves, {stats['productive']} productive, "
          f"{stats['seconds']:.1f}s)")
    return eg, aset, stats
