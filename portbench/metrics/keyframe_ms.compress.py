"""keyframe_ms.compress: the mean duration of the ``nbf.keyframe`` spans
(one ``encode_keyframe_best`` call each: the scheduled keyframes and the
fallback trials inside ``finish()``, on whichever thread ran them) that
start inside the compress_video calls, in ms."""

from portbench import programspans

LAYER = "host_keyframes"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "compress_fps"


def read(run):
    spans = programspans.mapped(run)
    if spans is None:
        return None
    keys = programspans.inside(spans, run, "compress_video", "nbf.keyframe")
    if not keys:
        return None
    return sum(s.end - s.start for s in keys) / len(keys) / 1e3
