"""kernels_roofline.decompress: the kernels of the decompress_video calls
against their bound (tracestats.roofline_pct): the clips' raw bytes
and stored bytes, each counted once a call, at the card's memory
bandwidth, over the summed kernel time inside the calls, in %."""

from portbench import tracestats

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decompress_fps"


def read(run):
    return tracestats.roofline_pct(run, "decompress_video")
