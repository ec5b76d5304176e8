"""device_idle_pct.compress: the share of the compress_video calls' wall
time in which the card ran no kernel, copy or memset (the union of the
device intervals of the trace, clipped to the calls), in %."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "compress_fps"


def read(run):
    return None if run.trace is None else run.trace.idle_pct("compress_video")
