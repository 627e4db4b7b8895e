"""Milliseconds a Tour-Bus wave in the traced assembly: the port's span
``contig.tourbus`` over its counter ``tourbus.waves``
(``AllResult.spans``, ``.counters``).  Nothing to read where Tour-Bus
ran no wave or the port keeps no such counter."""

LAYER = ("Tour-Bus: graph/tourbus.py, kernels/wave.py, kernels/lcs.py, "
         "csrc/wave.cu, csrc/lcs.cu")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    span = getattr(trace.result, "spans", {}).get("contig.tourbus")
    waves = getattr(trace.result, "counters", {}).get("tourbus.waves")
    if span is None or not waves:
        return None
    return 1000.0 * span[0] / waves
