"""wait_pct.compress: the share of the compress_video calls' wall time in
which the main thread waited on the overlap worker (the union of the
``nbf.wait_keyframe`` and ``nbf.wait_finish`` spans of the trace,
clipped to the calls), in %."""

from portbench import programspans, tracestats

LAYER = "facade"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "compress_fps"


def read(run):
    waits = programspans.traced(run, lambda n: n.startswith("nbf.wait_"))
    total = 0.0 if waits is None else run.trace.span_us("compress_video")
    if total <= 0:
        return None
    return 100.0 * tracestats.covered(
        waits, run.trace.spans["compress_video"]) / total
