"""kernels_roofline.compress: the kernels of the compress_video calls
against their bound (tracestats.roofline_pct): the clips' raw bytes
and stored bytes, each counted once a call, at the card's memory
bandwidth, over the summed kernel time inside the calls, in %."""

from portbench import tracestats

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "compress_fps"


def read(run):
    return tracestats.roofline_pct(run, "compress_video")
