"""Seconds of the map stage's read pass in the traced assembly: the
port's span ``map.reads`` (``AllResult.spans``): the reads decoded,
uploaded and placed on the contigs, batch by batch.  Nothing to read
where the port records no such span."""

LAYER = "map stage: stages/map.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("map.reads")
    return None if span is None else span[0]
