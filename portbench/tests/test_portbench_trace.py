"""The trace arithmetic of the per-layer metrics, on a hand-written
Chrome trace (``trace_fixture.json``) whose answers are worked out by
hand below.

Spans: compress_video [0, 100] and [200, 300], decompress_video
[100, 180] (microseconds).  Device: kernels K1 [10, 30] and K2 [20, 40]
overlap; a host-to-device copy [35, 50] runs beside K2; a
device-to-device copy [60, 70]; a memset [95, 105] crosses from the
first compress span into the decompress span; a device-to-host copy
[150, 170]; K3 [190, 195] lies outside every span; K1 [250, 260]; K4
[290, 310] runs past the window's end at 300.
"""

import os

import pytest

from portbench import tracestats
from portbench.run import Record

FIXTURE = os.path.join(os.path.dirname(__file__), "trace_fixture.json")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def trace():
    return tracestats.Trace.load(FIXTURE)


def calls():
    c = {"phase": "compress_video", "seconds": 1e-4, "frames": 10,
         "raw_bytes": 1000, "stored_bytes": 100}
    d = dict(c, phase="decompress_video", seconds=8e-5)
    return [c, d, dict(c)]


def test_union_clip_covered_and_gaps():
    assert tracestats.union([(5, 9), (0, 2), (1, 3), (3, 4), (7, 7)]) == [
        (0, 4), (5, 9)]
    assert tracestats.clip((0, 10), [(2, 4), (8, 12)]) == 4
    assert tracestats.covered([(0, 3), (2, 5)], [(1, 4)]) == 3
    assert tracestats.gaps([(2, 4), (6, 20)], [(0, 10), (15, 30)]) == [
        (0, 2), (4, 6), (20, 30)]


def test_spans_and_window(trace):
    assert trace.spans["compress_video"] == [(0.0, 100.0), (200.0, 300.0)]
    assert trace.spans["decompress_video"] == [(100.0, 180.0)]
    assert trace.window() == (0.0, 300.0)


def test_idle_is_the_union_of_device_intervals_inside_the_calls(trace):
    # compress: [10, 50] (kernels and the copy beside them) 40, the
    # device copy 10, the memset's first 5, K1 10, K4 up to 300: 10
    assert trace.busy_us("compress_video") == 75
    assert trace.idle_pct("compress_video") == pytest.approx(62.5)
    # decompress: the memset's last 5 and the pull 20 of 80
    assert trace.busy_us("decompress_video") == 25
    assert trace.idle_pct("decompress_video") == pytest.approx(68.75)
    # the whole window also holds K3, between the calls
    assert trace.busy_us() == 105


def test_kernels_and_copies_split_and_clipped(trace):
    # overlapping kernels each count; K3 is outside; K4 is cut at 300
    assert trace.kernel_us("compress_video") == 20 + 20 + 10 + 10
    assert trace.kernel_us("decompress_video") == 0
    # only host<->device copies count; the device-to-device copy does not
    assert trace.host_copy_us("compress_video") == 15
    assert trace.host_copy_us("decompress_video") == 20


def test_roofline_counts_the_clips_bytes_once_a_call(trace):
    rec = Record(calls(), 1.0, trace, H100)
    want = 100 * (2 * 1100) / 3.35e12 / 60e-6
    assert tracestats.roofline_pct(rec, "compress_video") == pytest.approx(
        want)
    # no kernel in the phase, or no trace, or an unknown card: no share
    assert tracestats.roofline_pct(rec, "decompress_video") is None
    assert tracestats.roofline_pct(Record(calls(), 1.0, None, H100),
                                   "compress_video") is None
    assert tracestats.roofline_pct(Record(calls(), 1.0, trace, "cpu"),
                                   "compress_video") is None


def test_copy_ms_per_frame(trace):
    rec = Record(calls(), 1.0, trace, H100)
    assert tracestats.copy_ms_per_frame(rec, "compress_video") == (
        pytest.approx(0.015 / 20))
    assert tracestats.copy_ms_per_frame(rec, "decompress_video") == (
        pytest.approx(0.020 / 10))


def test_breakdown(trace):
    ops = dict(trace.top_device_ops())
    assert ops["K1"] == pytest.approx(30e-6)
    assert ops["K4"] == pytest.approx(10e-6)       # cut at the window
    assert list(ops)[0] == "K1"
    gaps = trace.idle_gaps(4)
    assert [g[1] for g in gaps] == pytest.approx(
        [50e-6, 45e-6, 30e-6, 25e-6])
    assert gaps[0][0] == "compress_video"
    assert gaps[1][0] == "decompress_video"
    assert gaps[3][0] == "compress_video / aten::to"
    # gaps at the edges of the calls count
    assert [round(g[1] * 1e6) for g in trace.idle_gaps(10)][-2:] == [10, 10]


def test_metric_readers_on_the_fixture(trace):
    from portbench.run import load_metric
    rec = Record(calls(), 1.0, trace, H100)
    assert load_metric("device_idle_pct.compress").read(rec) == (
        pytest.approx(62.5))
    assert load_metric("kernels_roofline.decompress").read(rec) is None
    assert load_metric("copy_ms_per_frame.decompress").read(rec) == (
        pytest.approx(0.002))
    assert load_metric("compress_fps").read(rec) == pytest.approx(1e5)
    assert load_metric("stored_pct").read(rec) == pytest.approx(10.0)
    assert load_metric("device_idle_pct.compress").read(
        Record(calls(), 1.0)) is None
