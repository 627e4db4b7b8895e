"""Seconds of pregraph's count phase (the first read pass, chop, pack,
sort and merge of the runs): ``PregraphResult.phase_seconds["count"]``."""

LAYER = "counting: ops/kmer.py, ops/dictionary.py, the read pass"
UNIT = "s"
SOURCE = "program_span"
MOVES = "assembly_s"


def read(trace):
    return trace.result.pregraph.phase_seconds.get("count")
