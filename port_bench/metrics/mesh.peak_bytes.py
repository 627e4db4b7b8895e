"""The fullest card of the mesh in the traced assembly: the port's
counter ``mesh.peak_bytes``, the largest of every card's peak device
bytes read at each stage of ``cli.run_all`` (after a reset of each
card's peak).  Beside ``peak_device_bytes``, which reads the first card
alone, it tells whether that card is the fullest.  Nothing to read
where no mesh ran or the port keeps no such counter."""

LAYER = "mesh: parallel/mesh.py, parallel/sharded_*.py"
UNIT = "B"
SOURCE = "program_counter"
MOVES = "peak_device_bytes"


def read(trace):
    return getattr(trace.result, "counters", {}).get("mesh.peak_bytes")
