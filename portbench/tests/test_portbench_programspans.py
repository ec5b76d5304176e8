"""The readers of the program's spans (``programspans.py`` and the five
metrics over it), on a hand-written trace and list of kept spans
(``program_spans_fixture.json``) whose answers are worked out by hand
below.

Trace (microseconds): compress_video [0, 100] and [200, 300],
decompress_video [100, 180].  Main-thread spans in the trace:
nbf.compress [1, 99] and [201, 299]; nbf.wait_keyframe [10, 40];
nbf.wait_finish [60, 80] and [250, 290]; nbf.decompress [101, 179];
nbf.dec_parse [105, 115]; nbf.keyframe_decode [110, 125];
nbf.dec_device_membership [130, 140]; nbf.residual_apply [150, 170].
Device: K1 [0, 10], K6 [45, 55], a pull [90, 100], K3 [120, 130], K1
[210, 230].

Kept (the program's clock is the trace's + 5000): the main thread's
spans above, the first nbf.wait_finish kept 2 later than traced (the
median offset ignores it); the worker's nbf.keyframe [12, 38],
nbf.finish [42, 95] holding nbf.keyframe [50, 70], nbf.finish [205,
260], and a keyframe of an earlier session at [-10000, -9000].  Each
call holds 10 frames.
"""

import json
import os
import threading

import pytest

from portbench import programspans, run, tracestats
from portbench.run import Record

FIXTURE = os.path.join(os.path.dirname(__file__),
                       "program_spans_fixture.json")
NAMES = ("keyframe_ms.compress", "finish_ms_per_frame.compress",
         "wait_pct.compress", "host_ms_per_frame.decompress",
         "idle_keyframe_pct.compress")


def kept_spans():
    from new_bloom_filter_repo_tpu_torch.utils.profiling import Span

    with open(FIXTURE) as fh:
        rows = json.load(fh)["kept"]
    thread = {"main": threading.main_thread().ident, "worker": 1}
    return [Span(n, thread[t], int(a * 1000), int(b * 1000), p)
            for n, t, a, b, p in rows]


@pytest.fixture()
def record(monkeypatch):
    monkeypatch.setattr(programspans, "kept", kept_spans)
    with open(FIXTURE) as fh:
        trace = tracestats.Trace(json.load(fh)["traceEvents"])
    calls = [{"phase": p, "seconds": 1e-4, "frames": 10, "raw_bytes": 1,
              "stored_bytes": 1}
             for p in ("compress_video", "decompress_video",
                       "compress_video")]
    return Record(calls, 0.0, trace, "cpu")


def test_the_offset_is_the_median_over_the_main_threads_spans(record):
    assert programspans.offset_us(record.trace, kept_spans()) == -5000


def test_mapped_keeps_the_windows_spans_on_the_trace_clock(record):
    spans = programspans.mapped(record)
    worker = sorted((s.name, s.start, s.end) for s in spans
                    if s.thread == 1)
    # the earlier session's keyframe lies outside the window
    assert worker == [("nbf.finish", 42, 95), ("nbf.finish", 205, 260),
                      ("nbf.keyframe", 12, 38), ("nbf.keyframe", 50, 70)]
    assert len(spans) == 10 + 4


def test_self_time_leaves_out_the_children(record):
    spans = programspans.mapped(record)
    first = next(s for s in spans if s.name == "nbf.finish"
                 and s.start == 42)
    assert programspans.self_us(first, spans, "nbf.keyframe") == 53 - 20


@pytest.mark.parametrize("name,want", [
    # keyframes [12, 38] and [50, 70]: (26 + 20) / 2 us
    ("keyframe_ms.compress", 0.023),
    # finish self times 53 - 20 and 55 us, over 20 compressed frames
    ("finish_ms_per_frame.compress", 0.088 / 20),
    # waits 30 + 20 + 40 us of 200
    ("wait_pct.compress", 45.0),
    # parse and keyframe decode [105, 125] and residual [150, 170], over
    # 10 frames
    ("host_ms_per_frame.decompress", 0.004),
    # idle in compress [10, 45], [55, 90], [200, 210], [230, 300]: 150;
    # keyframes inside it 26 + 15
    ("idle_keyframe_pct.compress", 100.0 * 41 / 150),
])
def test_each_reader_gives_the_hand_computed_value(record, name, want):
    assert run.load_metric(name).read(record) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_an_older_program_gives_no_value(record, monkeypatch, name):
    """A program that keeps no spans and traces none (the commit before
    them) gives None, and the result line leaves the metric out."""
    monkeypatch.setattr(programspans, "kept", lambda: None)
    with open(os.path.join(os.path.dirname(__file__),
                           "trace_fixture.json")) as fh:
        older = Record(record.all_calls, 0.0,
                       tracestats.Trace(json.load(fh)["traceEvents"]), "cpu")
    assert run.load_metric(name).read(older) is None
    assert run.load_metric(name).read(Record(record.all_calls, 0.0)) is None


def test_kept_reads_the_programs_store():
    from new_bloom_filter_repo_tpu_torch.utils import profiling

    assert programspans.kept() == profiling.recorded_spans()
