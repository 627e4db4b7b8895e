"""Share of the traced assembly's wall time in which the device ran
nothing: 1 - (the union of every kernel, copy and memset interval) /
(the assembly's span), in percent."""

LAYER = "the device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "assembly_s"


def read(trace):
    if trace.window_us() <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us())
