"""The port's planar profile on raw 8-bit 4:2:0 frames, held to the plain
reference of a lossless planar round trip (``portbench/planar_reference.py``):
the decoded Y, U and V planes and the 4:4:4 view, the file's record count
and each plane sequence's keyframe positions; ``video.planar_counts()``;
the plane-pass and reassembly spans and the two benchmark metrics that
read them.  The clips are the ones the benchmark feeds the program
(``portbench.run.make_clip`` under the ``i420-1080-gop250`` configuration)
at 64x48 and 320x180, 30 frames, on the ``pan4`` and ``static`` mixes; and
``pan4`` is shown to move chroma by whole samples.
"""

import json
import os
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from new_bloom_filter_repo_tpu_torch.models import video
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.utils import profiling
from portbench import generator, planar_reference, reference, run, tracestats
from portbench.run import Record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 30


def load(kind, name):
    with open(os.path.join(ROOT, "portbench", kind, name + ".json")) as fh:
        return json.load(fh)


def mix(name):
    return load("traffic", name)["params"]


def i420_config(width, height, interval):
    """The ``i420-1080-gop250`` configuration at another size and GOP."""
    config = load("configs", "i420-1080-gop250")
    return dict(config, width=width, height=height,
                compressor=dict(config["compressor"],
                                keyframe_interval=interval))


def i420_clip(name, width, height, seed=11):
    """The mix's clip as the benchmark makes it: each frame's I420
    planes, and the ``YUVFrame``s the program gets."""
    clip = run.make_clip(i420_config(width, height, 250),
                         dict(load("traffic", name), frames=FRAMES), seed)
    return clip.planes, clip.frames


def compressor(interval):
    return ImprovedVideoCompressor(
        device="cpu", verbose=False,
        **i420_config(0, 0, interval)["compressor"])


# (width, height, keyframe interval): the small geometry with three
# scheduled keyframes a plane, and the cell's GOP of 250 at 320x180.
GEOMETRIES = [(64, 48, 10), (320, 180, 250)]


@pytest.mark.parametrize("width,height,interval", GEOMETRIES)
@pytest.mark.parametrize("name", ["pan4", "static"])
def test_the_planar_round_trip_equals_the_reference(tmp_path, name, width,
                                                    height, interval):
    planes, clip = i420_clip(name, width, height)
    path = str(tmp_path / "clip.bfvc")
    comp = compressor(interval)
    video.reset_planar_counts()
    comp.compress_video(clip, path, input_color_space="YUV")
    counts = video.planar_counts()
    dec = comp.decompress_video(path)
    want = planar_reference.decoded(planes)
    assert len(dec) == len(want) == FRAMES
    for got, w in zip(dec, want):
        for p in planar_reference.PLANES:
            np.testing.assert_array_equal(got.yuv_info[p + "_plane"], w[p])
        np.testing.assert_array_equal(np.asarray(got), w["view"])
        assert np.asarray(got).dtype == np.uint8
    with open(path, "rb") as fh:
        data = fh.read()
    shape = planar_reference.shape_of(data)
    assert shape == planar_reference.container(FRAMES, interval, width,
                                               height)
    records = reference.parse_records(data)
    keys = len(range(0, FRAMES, interval))
    for i, p in enumerate(planar_reference.PLANES):
        seq = records[1 + i * FRAMES:1 + (i + 1) * FRAMES]
        assert counts[p] == {"passes": 1, "frames": FRAMES,
                             "keyframes": keys,
                             "bytes": sum(len(r) for r in seq)}


def test_the_reference_view_repeats_each_chroma_sample_over_its_block():
    y = np.arange(24, dtype=np.uint8).reshape(4, 6)
    u = np.array([[1, 2, 3], [4, 5, 6]], np.uint8)
    view = planar_reference.view_444(y, u, u + 10)
    assert view.shape == (4, 6, 3) and view.dtype == np.uint8
    np.testing.assert_array_equal(view[:, :, 0], y)
    np.testing.assert_array_equal(view[:, :, 1],
                                  np.kron(u, np.ones((2, 2), np.uint8)))
    np.testing.assert_array_equal(view[:, :, 2] - view[:, :, 1], 10)
    # 4:4:4 planes come back as they are
    np.testing.assert_array_equal(planar_reference.view_444(y, y, y),
                                  np.stack([y, y, y], -1))


@pytest.mark.parametrize("pan,whole", [(4.0, True), (3.0, False)])
def test_pan4_moves_chroma_by_whole_samples(pan, whole):
    """Without noise, the ``pan4`` mix's chroma planes are the previous
    frame's rolled by (1, 2) samples (rows, columns) everywhere but at
    the two objects: the 2x2 blocks where the BGR frame is not the
    previous one rolled by (2, 4) pixels.  At ``pan`` 3 the scene moves
    1.5 and 0.75 chroma samples a frame, and most samples differ."""
    frames = generator.generate_frames(
        FRAMES, 320, 180, color_space="YUV", seed=3,
        **dict(mix("pan4"), noise=0.0, pan=pan))
    planes = [generator.to_i420(f) for f in frames]
    differ = outside = total = 0
    for i in range(1, FRAMES):
        moved = np.any(frames[i] != np.roll(frames[i - 1], (2, 4), (0, 1)),
                       axis=2)
        objects = moved.reshape(90, 2, 160, 2).any(axis=(1, 3))
        for c in (1, 2):
            d = planes[i][c] != np.roll(planes[i - 1][c], (1, 2), (0, 1))
            differ += int(d.sum())
            outside += int((d & ~objects).sum())
            total += d.size
            if whole:
                assert objects.mean() < 0.05
    if whole:
        assert outside == 0 and 0 < differ < 0.03 * total
    else:
        assert differ > 0.5 * total


def traced_round_trip(tmp_path):
    """A planar round trip of a 64x48 ``pan4`` clip under a profiler, each
    call inside the benchmark's span; the trace and the kept spans."""
    _, clip = i420_clip("pan4", 64, 48)
    path = str(tmp_path / "clip.bfvc")
    comp = compressor(10)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("compress_video"):
            comp.compress_video(clip, path, input_color_space="YUV")
        with record_function("decompress_video"):
            comp.decompress_video(path)
    tpath = str(tmp_path / "trace.json")
    prof.export_chrome_trace(tpath)
    return tracestats.Trace.load(tpath), profiling.recorded_spans()


def test_the_plane_passes_and_the_reassembly_have_their_spans(tmp_path):
    trace, kept = traced_round_trip(tmp_path)
    main = threading.main_thread().ident
    ours = [s for s in kept if s.thread == main]
    names = [s.name for s in ours]
    for plane in ("nbf.plane_y", "nbf.plane_u", "nbf.plane_v"):
        # once in compress, once in decompress
        assert names.count(plane) == 2
        assert [s.parent for s in ours if s.name == plane] == [
            "nbf.compress", "nbf.decompress"]
    assert names.count("nbf.reassemble_444") == 1
    # the passes run one after another, Y, U, V, and the reassembly after
    start = {s.name: s.start_ns for s in ours if s.parent == "nbf.decompress"}
    assert (start["nbf.plane_y"] < start["nbf.plane_u"]
            < start["nbf.plane_v"] < start["nbf.reassemble_444"])
    traced = [n for _, _, n in trace.host if n.startswith("nbf.plane_")
              or n == "nbf.reassemble_444"]
    assert sorted(traced) == sorted(
        n for n in names if n.startswith("nbf.plane_")
        or n == "nbf.reassemble_444")


def test_the_planar_metrics_read_a_traced_round_trip(tmp_path):
    trace, _ = traced_round_trip(tmp_path)
    calls = [{"phase": p, "seconds": 1.0, "frames": FRAMES, "raw_bytes": 1,
              "stored_bytes": 1}
             for p in ("compress_video", "decompress_video")]
    rec = Record(calls, 0.0, trace, "cpu")
    chroma = run.load_metric("chroma_pct.compress").read(rec)
    assert 0 < chroma < 100
    # the reassembly is a part of the decompress call
    per_frame = run.load_metric("reassemble_ms_per_frame.decompress").read(
        rec)
    wall = trace.span_us("decompress_video") / 1e3 / FRAMES
    assert 0 < per_frame < wall


def span_trace(extra):
    """A hand-written trace: compress_video [0, 100] and [200, 300],
    decompress_video [100, 180], and the main thread's spans ``extra``
    (name, start, end)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
               "dur": b - a}
              for n, a, b in [("compress_video", 0, 100),
                              ("decompress_video", 100, 180),
                              ("compress_video", 200, 300),
                              ("nbf.compress", 1, 99)] + extra]
    calls = [{"phase": p, "seconds": 1e-4, "frames": 10, "raw_bytes": 1,
              "stored_bytes": 1}
             for p in ("compress_video", "decompress_video",
                       "compress_video")]
    return Record(calls, 0.0, tracestats.Trace(events), "cpu")


@pytest.mark.parametrize("name,want", [
    # U [30, 60] and V [60, 90], [230, 250]; the decode's U and V are
    # outside the compress calls: 80 us of 200
    ("chroma_pct.compress", 40.0),
    # the union [160, 190] of the two, inside the call up to 180: 20 us
    # over 10 frames
    ("reassemble_ms_per_frame.decompress", 0.002),
])
def test_each_planar_reader_gives_the_hand_computed_value(name, want):
    rec = span_trace([("nbf.plane_y", 2, 30), ("nbf.plane_u", 30, 60),
                      ("nbf.plane_v", 60, 90), ("nbf.plane_v", 230, 250),
                      ("nbf.plane_u", 120, 140), ("nbf.plane_v", 140, 160),
                      ("nbf.reassemble_444", 160, 175),
                      ("nbf.reassemble_444", 170, 190)])
    assert run.load_metric(name).read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", ["chroma_pct.compress",
                                  "reassemble_ms_per_frame.decompress"])
def test_a_program_without_the_planar_spans_gives_no_value(name):
    """The parent program, or a blocked cell: spans, but none of these;
    and a run without a trace."""
    rec = span_trace([("nbf.wait_finish", 10, 40)])
    assert run.load_metric(name).read(rec) is None
    assert run.load_metric(name).read(Record(rec.all_calls, 0.0)) is None
