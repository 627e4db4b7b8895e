"""Seconds of the pregraph stage in the traced assembly: the port's own
stage clock (``AllResult.stage_seconds``, devices synchronized)."""

LAYER = "pregraph stage: stages/pregraph.py and the io writers"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.stage_seconds.get("pregraph")
