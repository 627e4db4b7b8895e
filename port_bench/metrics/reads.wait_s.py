"""Seconds the read passes (pregraph's count and thread passes, map's
read pass) waited for a decoded batch in the traced assembly: the sum of
the port's ``reads.wait`` spans (``AllResult.spans``), one a step of the
read-ahead queue.  Nothing to read where the port records no such
span."""

LAYER = "read passes: io/fastx.py (count, thread and map passes)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("reads.wait")
    return None if span is None else span[0]
