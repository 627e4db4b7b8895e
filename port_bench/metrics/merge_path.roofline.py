"""The merge kernel's share of its byte bound in the traced assembly.

Bytes: 20 B a row read and 20 B written (``trace.merge_bytes``), over
the rows of both runs of every call, which a span around
``kernels.merge_path.merge_sorted_rows`` counts.  Time: the profiler's
device time of ``merge_kernel`` and ``partition_kernel``.  Nothing to
read where counting never merges two runs (rows of three lanes at
K > 28 take concat + sort; one build unit needs no merge)."""

from port_bench import trace as tr

LAYER = "merge kernel: kernels/merge_path.py, csrc/merge_path.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "assembly_s"


def read(trace):
    if not trace.merge_rows:
        return None
    us = trace.device_us(r"\b(merge_kernel|partition_kernel)\b")
    return tr.roofline_share(
        sum(tr.merge_bytes(r) for r in trace.merge_rows), us / 1e6)
