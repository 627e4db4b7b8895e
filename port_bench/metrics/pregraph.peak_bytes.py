"""Peak device bytes allocated during the pregraph stage
(``AllResult.peak_bytes["pregraph"]``, after a reset of the peak)."""

LAYER = "pregraph stage: stages/pregraph.py and the io writers"
UNIT = "B"
SOURCE = "program_counter"
MOVES = "peak_device_bytes"


def read(trace):
    return trace.result.peak_bytes.get("pregraph")
