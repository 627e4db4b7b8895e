"""Seconds of Tour-Bus, the bubble merge, in the traced assembly: the
port's span ``contig.tourbus`` (``AllResult.spans``), the whole
pinch: its waves, their count reads and the productive waves'
``apply``.  Nothing to read where Tour-Bus did not run (``-M 0``)."""

LAYER = ("Tour-Bus: graph/tourbus.py, kernels/wave.py, kernels/lcs.py, "
         "csrc/wave.cu, csrc/lcs.cu")
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("contig.tourbus")
    return None if span is None else span[0]
