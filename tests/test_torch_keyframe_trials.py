"""The port's keyframe trials (``frame_codec.encode_keyframe_best``)
against the JAX package's: the four typed trials' streams DEFLATE in one
native batch and the sectioned trial reuses the winner's DEFLATEs, yet
every record is the JAX package's, byte for byte, with the native
library and with its serial fallbacks (``native.load`` returning None).
The counter ``keyframe_trial_counts`` and the spans inside
``nbf.keyframe`` are held here too.  All on the CPU, at small sizes.
"""

import zlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from new_bloom_filter_repo_tpu.models import frame_codec as jfc
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.utils import native, profiling


def texture(h, w, seed, channels=3):
    """A smooth 8-px texture with a few noisy pixels, uint8."""
    rng = np.random.default_rng(seed)
    shape = (h // 8 + 2, w // 8 + 2) + ((channels,) if channels else ())
    coarse = rng.integers(0, 256, shape).astype(np.float64)
    img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
    y, x = np.mgrid[0:h, 0:w]
    ramp = (y + 2 * x) if channels == 0 else (y + 2 * x)[:, :, None]
    img = (img * 0.5 + ramp) % 256
    noisy = rng.random(img.shape) < 0.03
    img[noisy] += rng.normal(0, 3, int(noisy.sum()))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def blocky_noise(h, w, seed, channels=3, base=None):
    """Noise whose sigma is 1 or 24 by 16x16 blocks, over ``base`` (or
    mod 256 around 0): the 2D-context coder (coding 6) wins there."""
    rng = np.random.default_rng(seed)
    sig = rng.choice([1.0, 24.0], (h // 16 + 1, w // 16 + 1))
    s = np.repeat(np.repeat(sig, 16, 0), 16, 1)[:h, :w, None]
    noise = rng.normal(0, 1, (h, w, channels)) * s
    if base is None:
        return (np.round(noise).astype(np.int64) % 256).astype(np.uint8)
    return np.clip(np.round(base + noise), 0, 255).astype(np.uint8)


def diagonal_tie(n=96):
    """Constant along anti-diagonals, zero above the main one: the SUB,
    UP and MED streams are then the same bytes, so the three filtered
    records tie, and all beat the unfiltered record."""
    rng = np.random.default_rng(11)
    g = np.cumsum(rng.integers(0, 3, (2 * n, 3)), axis=0) % 256
    y, x = np.mgrid[0:n, 0:n]
    s = x + y
    img = np.where((s >= n - 1)[:, :, None], g[s], 0)
    return img.astype(np.uint8)


def i420(frame):
    """(Y, U, V) planes with 2x2 chroma, and the 444 frame that is their
    chroma replication (flag 3)."""
    yp = frame[:, :, 0].copy()
    up = frame[::2, ::2, 1].copy()
    vp = frame[::2, ::2, 2].copy()
    f444 = np.stack([yp, np.repeat(np.repeat(up, 2, 0), 2, 1),
                     np.repeat(np.repeat(vp, 2, 0), 2, 1)], -1)
    return f444, {"format": "I420", "y_plane": yp, "u_plane": up,
                  "v_plane": vp}


def case(name):
    """(frame, yuv_info) of a named case."""
    if name == "gray":
        return texture(128, 160, 1, channels=0), None
    if name == "bgr_textured":
        return texture(64, 96, 2), None
    if name == "bgr_noise":
        rng = np.random.default_rng(3)
        return rng.integers(0, 256, (64, 96, 3), np.uint8), None
    if name == "bgr_grain":
        base = texture(128, 160, 1).astype(np.float64)
        return blocky_noise(128, 160, 1, base=base), None
    if name == "constant":
        return np.zeros((64, 96, 3), np.uint8), None
    if name == "diagonal_tie":
        return diagonal_tie(), None
    if name == "small":
        return texture(16, 24, 4), None
    if name == "yuv_flag1":
        frame = texture(64, 96, 5)
        _, info = i420(texture(64, 96, 6))
        return frame, info
    if name == "yuv_grain":
        rng = np.random.default_rng(10)
        frame = np.clip(np.round(texture(64, 96, 10) + rng.normal(
            0, 3, (64, 96, 3))), 0, 255).astype(np.uint8)
        _, info = i420(texture(64, 96, 11))
        return frame, info
    if name == "yuv_plane_context":
        yp = blocky_noise(128, 160, 7).reshape(128, 480)
        return np.zeros((8, 8, 3), np.uint8), {
            "format": "I420", "y_plane": yp, "u_plane": yp[:8, :8].copy(),
            "v_plane": yp[:8, 8:16].copy()}
    if name == "yuv_flag2":
        frame = texture(64, 96, 7)
        return frame, {"format": "YUV444",
                       "y_plane": frame[:, :, 0].copy(),
                       "u_plane": frame[:, :, 1].copy(),
                       "v_plane": frame[:, :, 2].copy()}
    if name == "yuv_flag3":
        return i420(texture(64, 96, 8))
    if name == "uint16":
        rng = np.random.default_rng(9)
        return (texture(48, 64, 9).astype(np.uint16) * 250
                + rng.integers(0, 4, (48, 64, 3))).astype(np.uint16), None
    raise KeyError(name)


CASES = ("gray", "bgr_textured", "bgr_noise", "bgr_grain", "constant",
         "diagonal_tie", "small", "yuv_flag1", "yuv_grain",
         "yuv_plane_context",
         "yuv_flag2", "yuv_flag3", "uint16")

# What wins in each case, as (type byte, filter id): checks that the
# cases reach the branches they are named for.  In ``bgr_grain`` the
# frame's section, in ``yuv_plane_context`` the Y plane's, is coding 6.
WINNER = {"bgr_noise": {(fc.KEYFRAME, None), (fc.KEYFRAME_S, 0)},
          "bgr_grain": {(fc.KEYFRAME_S, 3)},
          "yuv_grain": {(fc.KEYFRAME_S, 3)},
          "yuv_plane_context": {(fc.KEYFRAME_S, 0)},
          "constant": {(fc.KEYFRAME, None)},
          "diagonal_tie": {(fc.FILTERED, 1)},
          "uint16": {(fc.KEYFRAME, None)}}


def winner(rec):
    return rec[0], (None if rec[0] == fc.KEYFRAME else rec[1])


def codings(rec):
    """The coding byte of each section of a type-15 record."""
    flag, pos = rec[2], 15
    if flag:
        pos += 2 + int.from_bytes(rec[pos:pos + 2], "little")
    out = []
    for i in range((flag != 3) + 3 * (flag in (1, 3))):
        coding = rec[pos]
        stored = int.from_bytes(rec[pos + 1:pos + 5], "little")
        pos += (5 + 4 * (coding != 0) + (coding in (2, 7))
                + 4 * (coding == 6) + stored + 8 * (i >= (flag != 3)))
        out.append(coding)
    assert pos == len(rec)
    return out


# The section codings of the cases that reach the 2D-context coder, and
# of one whose planes keep the winner's DEFLATE.
CODINGS = {"bgr_grain": [6], "yuv_plane_context": [1, 6, 0, 0],
           "yuv_grain": [3, 1, 1, 1]}


@pytest.fixture(params=["native", "serial"])
def library(request, monkeypatch):
    """The port with its native library, or with ``native.load``
    returning None so that every coder takes its serial fallback."""
    if request.param == "serial":
        monkeypatch.setattr(native, "load", lambda: None)
    return request.param


@pytest.mark.parametrize("level", [6, 9])
@pytest.mark.parametrize("name", CASES)
def test_best_keyframe_equals_the_jax_package(name, level, library):
    frame, info = case(name)
    want = jfc.encode_keyframe_best(frame, info, zlib_level=level)
    got = fc.encode_keyframe_best(frame, info, zlib_level=level)
    assert got == want
    if name in WINNER:
        assert winner(got) in WINNER[name]
    if name in CODINGS:
        assert codings(got) == CODINGS[name]


@pytest.mark.parametrize("name", CASES)
def test_typed_and_sectioned_records_equal_the_jax_package(name):
    """The shared record builders: each typed trial and each sectioned
    record, one by one, as the JAX package writes them."""
    frame, info = case(name)
    fids = (0, 1, 2, 3) if frame.dtype == np.uint8 else (0,)
    for fid in fids:
        assert (fc.encode_keyframe(frame, info, typed=True, filter_id=fid)
                == jfc.encode_keyframe(frame, info, typed=True,
                                       filter_id=fid))
        assert (fc.encode_keyframe_s(frame, info, filter_id=fid)
                == jfc.encode_keyframe_s(frame, info, filter_id=fid))
    assert (fc.encode_keyframe(frame, info)
            == jfc.encode_keyframe(frame, info))


@pytest.mark.parametrize("typed", [False, True])
def test_batched_records_equal_the_jax_package(typed):
    """``encode_keyframes_batch`` over every case at once, on the shared
    record builder."""
    frames, infos = zip(*(case(name) for name in CASES))
    assert (fc.encode_keyframes_batch(frames, infos, typed=typed)
            == jfc.encode_keyframes_batch(frames, infos, typed=typed))


def test_the_tie_goes_to_the_first_filter():
    frame, _ = case("diagonal_tie")
    sizes = [len(fc.encode_keyframe(frame, None, typed=True, filter_id=f))
             for f in (0, 1, 2, 3)]
    assert sizes[1] == sizes[2] == sizes[3] < sizes[0]


class _CountingZlib:
    """``zlib`` with its ``compress`` calls counted."""

    def __init__(self):
        self.calls = 0

    def compress(self, *args, **kwargs):
        self.calls += 1
        return zlib.compress(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(zlib, name)


def test_one_batch_and_one_reused_deflate(monkeypatch):
    counting = _CountingZlib()
    monkeypatch.setattr(fc, "zlib", counting)
    frame = texture(48, 64, 12)
    fc.reset_keyframe_trial_counts()
    rec = fc.encode_keyframe_best(frame, None)
    assert fc.keyframe_trial_counts() == {
        "keyframes": 1, "batches": 1, "streams": 4, "reused": 1}
    assert counting.calls == 0
    assert rec == jfc.encode_keyframe_best(frame, None)


def test_planes_batch_their_streams_too():
    frame, info = case("yuv_flag1")
    fc.reset_keyframe_trial_counts()
    fc.encode_keyframe_best(frame, info)
    assert fc.keyframe_trial_counts() == {
        "keyframes": 1, "batches": 1, "streams": 16, "reused": 4}


def test_a_wide_frame_makes_no_batch():
    frame, _ = case("uint16")
    fc.reset_keyframe_trial_counts()
    fc.encode_keyframe_best(frame, None)
    assert fc.keyframe_trial_counts() == {
        "keyframes": 1, "batches": 0, "streams": 0, "reused": 0}
    fc.encode_keyframe_best(texture(16, 24, 4), None)
    fc.reset_keyframe_trial_counts()
    assert fc.keyframe_trial_counts() == dict.fromkeys(
        ("keyframes", "batches", "streams", "reused"), 0)


def test_the_trial_spans_lie_inside_the_keyframe_span():
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fc.encode_keyframe_best(texture(48, 64, 13), None)
    kept = {s.name: s for s in profiling.recorded_spans()}
    profiling.clear_spans()
    outer = kept["nbf.keyframe"]
    for name in ("nbf.keyframe_deflate", "nbf.keyframe_sectioned"):
        span = kept[name]
        assert span.parent == "nbf.keyframe"
        assert span.thread == outer.thread
        assert outer.start_ns <= span.start_ns <= span.end_ns <= outer.end_ns
