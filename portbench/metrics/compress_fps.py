"""compress_fps: the frames compressed in the window over the summed
wall seconds of the ``compress_video`` calls, on the host clock.  What
the ingest of an archive takes."""

UNIT = "frames/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    calls = run.calls("compress_video")
    seconds = sum(c["seconds"] for c in calls)
    return sum(c["frames"] for c in calls) / seconds if seconds > 0 else None
