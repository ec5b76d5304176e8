"""chroma_pct.compress: the share of the compress_video calls' wall time
spent in the planar profile's chroma passes (the union of the trace's
``nbf.plane_u`` and ``nbf.plane_v`` spans, clipped to the calls), in %.
The three plane passes run one after another on the main thread, so
this is what coding U and V costs of a clip.  None where the trace holds
no plane pass (a program without the spans, or no planar call)."""

from portbench import programspans, tracestats

LAYER = "planar"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "compress_fps"

NAMES = ("nbf.plane_u", "nbf.plane_v")


def read(run):
    chroma = programspans.traced(run, lambda n: n in NAMES)
    if not chroma:
        return None
    total = run.trace.span_us("compress_video")
    if total <= 0:
        return None
    return 100.0 * tracestats.covered(
        chroma, run.trace.spans["compress_video"]) / total
