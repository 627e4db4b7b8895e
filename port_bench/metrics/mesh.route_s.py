"""Seconds the mesh spent routing in the traced assembly: the port's
span ``mesh.route`` (``AllResult.spans``), once an exchange's routing
in ``parallel/mesh.Mesh.route``: each shard's stable sort of its records
by owner and the blocking host read of the bucket sizes, one a card.
Nothing to read where no mesh ran (one device) or the port records no
such span."""

LAYER = "mesh: parallel/mesh.py, parallel/sharded_*.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("mesh.route")
    return None if span is None else span[0]
