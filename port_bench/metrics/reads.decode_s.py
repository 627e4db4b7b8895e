"""Seconds the read-ahead thread spent producing read batches in the
traced assembly: the port's counter ``reads.decode_s``
(``AllResult.counters``), added from that thread batch by batch.
Against ``reads.wait_s``: the decoder sets the pace where the passes
wait for most of it.  Nothing to read where the port keeps no such
counter."""

LAYER = "read passes: io/fastx.py (count, thread and map passes)"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "assembly_s"


def read(trace):
    return getattr(trace.result, "counters", {}).get("reads.decode_s")
