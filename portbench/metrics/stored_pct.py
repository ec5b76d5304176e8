"""stored_pct: the ``.bfvc`` bytes written in the window over the raw
bytes of the clips compressed, in %.  The bytes users pay for; lower is
better."""

UNIT = "%"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    calls = run.calls("compress_video")
    raw = sum(c["raw_bytes"] for c in calls)
    return 100.0 * sum(c["stored_bytes"] for c in calls) / raw if raw else None
