"""The Tour-Bus wave kernels' share of their byte bound in the traced
assembly.

Bytes (``wave_bytes``): a floor of what the 13 launches of every wave
must move, from the port's counters ``tourbus.arc_rows`` (the arc
buffers' rows, summed over waves), ``tourbus.cand_rows`` (the
candidate rows, C a wave) and ``tourbus.path_slots`` (C x m, m the
node slots of a path, MAXNODELENGTH):

* the front reads each arc row's from-edge, to-edge, multiplicity and
  failed flag (25 B a row) and writes each candidate row's cid_arc, u,
  t0, cmask, found, its four paths of m int64 and its four ends
  (58 + 32 m B a row);
* the identity check reads the two paths and found and writes the two
  lengths, the LCS, compared and ok (16 m + 27 B a row);
* the back's head reads ok, compared and cmask (3 B a row).

What the floor leaves out (the coverage, deletes and twins the front
gathers, the compared bases, the forest and select passes, a
productive back's E- and A-sized writes) only adds bytes, so the share
cannot pass 100%.  Time: the profiler's device time of the wave's
kernels, matched by name (a replayed CUDA graph's kernels appear one by
one).  Nothing to read where Tour-Bus ran no wave, the port keeps no
such counter, or the trace holds no wave kernel."""

from port_bench import trace as tr

LAYER = ("Tour-Bus: graph/tourbus.py, kernels/wave.py, kernels/lcs.py, "
         "csrc/wave.cu, csrc/lcs.cu")
UNIT = "%"
SOURCE = "device_trace"
MOVES = "assembly_s"

KERNELS = frozenset((
    "front_forest_kernel", "front_cand_kernel", "front_select_kernel",
    "front_count_kernel", "front_scatter_kernel", "front_sort_kernel",
    "chains_kernel", "identity_kernel", "back_head_kernel", "claim_kernel",
    "apply_kernel", "arcs_kernel"))


def wave_bytes(arc_rows: float, cand_rows: float, path_slots: float) -> float:
    """The byte floor of the waves: 25 B an arc row, 88 B a candidate row
    and 48 B a node slot of a candidate row's path (front 58 + 32 m,
    identity 27 + 16 m, back 3)."""
    return 25.0 * arc_rows + 88.0 * cand_rows + 48.0 * path_slots


def read(trace):
    counters = getattr(trace.result, "counters", {})
    shape = [counters.get("tourbus." + k)
             for k in ("arc_rows", "cand_rows", "path_slots")]
    if None in shape:
        return None
    us = sum(d for name, _s, d in trace.device
             if tr.kernel_name(name) in KERNELS)
    return tr.roofline_share(wave_bytes(*shape), us / 1e6)
