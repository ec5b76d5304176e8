"""idle_keyframe_pct.compress: the share of the compress_video calls'
device-idle time (no kernel, copy or memset running) that lies inside
an ``nbf.keyframe`` span, of either thread, put onto the trace's clock,
in %."""

from portbench import programspans

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "compress_fps"


def read(run):
    spans = programspans.mapped(run)
    if spans is None:
        return None
    return programspans.idle_in_pct(
        run, "compress_video",
        [s for s in spans if s.name == "nbf.keyframe"])
