"""Seconds of pregraph's writer in the traced assembly: the port's span
``pregraph.write`` around every file the stage writes (``.kmerFreq``,
``.peGrads``, ``.vertex``, ``.edge.gz``, ``.preArc``, ``.preGraphBasic``)
and its device-to-host copies (``AllResult.spans``).  Nothing to read
where the port records no such span."""

LAYER = "pregraph writer: io/graph_files.py, io/stagefiles.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("pregraph.write")
    return None if span is None else span[0]
