"""Seconds of pregraph's thread phase (the second read pass through the
edge graph into preArcs): ``PregraphResult.phase_seconds["thread"]``."""

LAYER = "threading: graph/arcs.py, the second read pass"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.pregraph.phase_seconds.get("thread")
