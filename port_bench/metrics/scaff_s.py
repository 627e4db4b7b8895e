"""Seconds of the scaff stage in the traced assembly
(``AllResult.stage_seconds["scaff"]``)."""

LAYER = "scaff stage: stages/pelinks.py, stages/scaff.py"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.stage_seconds.get("scaff")
