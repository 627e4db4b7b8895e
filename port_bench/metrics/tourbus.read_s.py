"""Seconds the host waited on its Tour-Bus waves' counts in the traced
assembly: the port's span ``contig.tourbus.read`` (``AllResult.spans``),
once a wave around the blocking read of the wave's five counts, so the
time the wave's kernels run past its enqueue.  Nothing to read where
Tour-Bus did not run (``-M 0``) or the port records no such span."""

LAYER = ("Tour-Bus: graph/tourbus.py, kernels/wave.py, kernels/lcs.py, "
         "csrc/wave.cu, csrc/lcs.cu")
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("contig.tourbus.read")
    return None if span is None else span[0]
