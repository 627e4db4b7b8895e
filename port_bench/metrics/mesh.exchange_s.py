"""Seconds the host spent enqueuing the mesh's exchanges in the traced
assembly: the port's span ``mesh.exchange`` (``AllResult.spans``), once
a ``parallel/mesh.Mesh.all_to_all``, around the moves of its D x D
pieces (a move between two cards is asynchronous, so the span holds its
enqueue, not its copy).  Nothing to read where no mesh ran (one device)
or the port records no such span."""

LAYER = "mesh: parallel/mesh.py, parallel/sharded_*.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("mesh.exchange")
    return None if span is None else span[0]
