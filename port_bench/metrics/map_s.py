"""Seconds of the map stage in the traced assembly
(``AllResult.stage_seconds["map"]``)."""

LAYER = "map stage: stages/map.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.stage_seconds.get("map")
