"""finish_ms_per_frame.compress: the self time of the ``nbf.finish``
spans (each chunk's host record stage, on the overlap worker: its
duration less the part its ``nbf.keyframe`` spans cover) that start
inside the compress_video calls, summed, in ms a frame of those
calls."""

from portbench import programspans

LAYER = "host_record_stage"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "compress_fps"


def read(run):
    spans = programspans.mapped(run)
    n = programspans.frames(run, "compress_video")
    if spans is None or n == 0:
        return None
    finishes = programspans.inside(spans, run, "compress_video",
                                   "nbf.finish")
    if not finishes:
        return None
    return sum(programspans.self_us(s, spans, "nbf.keyframe")
               for s in finishes) / 1e3 / n
