"""copy_ms_per_frame.compress: the summed host-to-device and device-to-host
copy time inside the compress_video calls, in ms a frame."""

from portbench import tracestats

LAYER = "transfers"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "compress_fps"


def read(run):
    return tracestats.copy_ms_per_frame(run, "compress_video")
