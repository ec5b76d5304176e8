"""copy_ms_per_frame.decompress: the summed host-to-device and device-to-host
copy time inside the decompress_video calls, in ms a frame."""

from portbench import tracestats

LAYER = "transfers"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decompress_fps"


def read(run):
    return tracestats.copy_ms_per_frame(run, "decompress_video")
