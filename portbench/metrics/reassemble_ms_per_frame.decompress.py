"""reassemble_ms_per_frame.decompress: the planar decoder's 4:4:4
reassembly (the trace's ``nbf.reassemble_444`` spans, each chroma plane
repeated over its 2x2 blocks and stacked with Y, clipped to the
decompress_video calls), summed, in ms a frame decoded.  None where the
trace holds no such span (a program without it, or no planar call)."""

from portbench import programspans, tracestats

LAYER = "planar"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decompress_fps"


def read(run):
    spans = programspans.traced(run, lambda n: n == "nbf.reassemble_444")
    n = programspans.frames(run, "decompress_video")
    if not spans or n == 0:
        return None
    return tracestats.covered(
        spans, run.trace.spans["decompress_video"]) / 1e3 / n
