"""Seconds of the productive Tour-Bus waves' ``WaveProgram.apply`` in
the traced assembly (the wave's arcs rebuilt into an exact table and
copied back, eagerly, after each wave that merged): the port's span
``contig.tourbus.apply`` (``AllResult.spans``).  Nothing to read
where no wave merged or the port records no such span."""

LAYER = ("Tour-Bus: graph/tourbus.py, kernels/wave.py, kernels/lcs.py, "
         "csrc/wave.cu, csrc/lcs.cu")
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("contig.tourbus.apply")
    return None if span is None else span[0]
