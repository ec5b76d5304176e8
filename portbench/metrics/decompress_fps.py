"""decompress_fps: the frames decoded in the window over the summed
wall seconds of the ``decompress_video`` calls, on the host clock.  What
a restore or a playback takes."""

UNIT = "frames/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    calls = run.calls("decompress_video")
    seconds = sum(c["seconds"] for c in calls)
    return sum(c["frames"] for c in calls) / seconds if seconds > 0 else None
