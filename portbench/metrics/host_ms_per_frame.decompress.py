"""host_ms_per_frame.decompress: the host's decode work in the
decompress_video calls (the union of the trace's ``nbf.dec_parse``,
``nbf.dec_host_slices``, ``nbf.residual_apply`` and
``nbf.keyframe_decode`` spans, clipped to the calls), in ms a frame
decoded."""

from portbench import programspans, tracestats

LAYER = "host_decode"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decompress_fps"

NAMES = ("nbf.dec_parse", "nbf.dec_host_slices", "nbf.residual_apply",
         "nbf.keyframe_decode")


def read(run):
    host = programspans.traced(run, lambda n: n in NAMES)
    n = programspans.frames(run, "decompress_video")
    if host is None or n == 0:
        return None
    return tracestats.covered(
        host, run.trace.spans["decompress_video"]) / 1e3 / n
