"""The mesh's copies between cards: their share of one direction of an
H100 SXM5's NVLink 4 in the traced assembly.

Bytes: the port's counter ``mesh.peer_bytes`` (every byte a method of
``parallel/mesh.Mesh`` copied from one card to another).  Time: the
summed device durations of the profiler's peer copies (``Memcpy PtoP``),
a sum and not a union, so that copies between different pairs of cards
that run at once cannot read above 100%.  Bound: 450 GB/s, one
direction of 18 NVLink 4 links (900 GB/s both ways).  Nothing to read
where the trace holds no peer copy (one device, logical shards of one
card) or the port keeps no such counter."""

import re

from port_bench import trace as tr

LAYER = "mesh: parallel/mesh.py, parallel/sharded_*.py"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "assembly_s"

NVLINK_BYTES_PER_S = 450e9
PEER_COPY = re.compile(r"^Memcpy PtoP\b")


def peer_copy_us(device) -> float:
    """Summed device microseconds of the peer copies among ``device``'s
    (name, start, duration) rows."""
    return sum(d for name, _s, d in device if PEER_COPY.match(name))


def read(trace):
    peer = getattr(trace.result, "counters", {}).get("mesh.peer_bytes")
    us = peer_copy_us(trace.device)
    if not peer or us <= 0:
        return None
    return tr.roofline_share(peer, us / 1e6, NVLINK_BYTES_PER_S)
