"""Seconds of the contig stage in the traced assembly
(``AllResult.stage_seconds["contig"]``)."""

LAYER = ("contig stage: stages/contig.py, graph/edge_clean.py, "
         "graph/contig_merge.py")
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.stage_seconds.get("contig")
