"""The PyTorch port's public video API against the JAX package's.

For the same frames and options both packages must write byte-identical
``.bfvc`` files, and each must decode the other's files bit-exactly.
Clips are the seeded ``utils/synthetic.py`` classes at small geometry,
in RGB and grayscale; the port runs on the CPU, through its kernels'
plain twins.
"""

import math
import os

import numpy as np
import pytest

from new_bloom_filter_repo_tpu.models.video import (
    ImprovedVideoCompressor as JaxCompressor,
)
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
    _plan_segments,
    verify_lossless,
)
from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh
from test_video_api import make_video
from new_bloom_filter_repo_tpu_torch.utils import container
from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
    SUITE,
    _smooth_texture,
    generate_frames,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_pan.bfvc")


def clip(name, f, w, h, gray=False, seed=0):
    """``f`` frames of ``w`` x ``h``: of the suite's class ``name``, or
    made by ``name(f, w, h)``."""
    frames = (name(f, w, h) if callable(name)
              else generate_frames(f, w, h, seed=seed, **SUITE[name]))
    if gray:
        frames = [np.ascontiguousarray(x[..., 0]) for x in frames]
    return frames


def record_types(path):
    out = set()
    for p in container.read_bfvc(path)[1]:
        t = fc.record_type(p)
        out.add((t, p[5]) if t == fc.MOTION else t)
    return out


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def rotation(f, w, h, rate=8000, seed=2):
    """A smooth texture rotating ``rate`` microradians a frame about the
    centre, nearest-neighbour: type-20 records."""
    base = _smooth_texture(np.random.default_rng(seed), h, w, False)
    yy = np.arange(h, dtype=np.float64)[:, None] - h / 2.0
    xx = np.arange(w, dtype=np.float64)[None, :] - w / 2.0
    out = []
    for i in range(f):
        c, s = math.cos(rate * i * 1e-6), math.sin(rate * i * 1e-6)
        ry = np.clip(np.floor(h / 2.0 + yy * c - xx * s).astype(np.int64),
                     0, h - 1)
        rx = np.clip(np.floor(w / 2.0 + yy * s + xx * c).astype(np.int64),
                     0, w - 1)
        out.append(base[ry, rx])
    return out


def sensor(f, w, h):
    """A static scene under sensor noise of sigma 1 on every pixel: bare
    byte-rANS residuals (type 13)."""
    return generate_frames(f, w, h, seed=0, noise=1.0, noise_frac=1.0,
                           speed=0.0)


def split_halfpel(f, w, h, seed=3):
    """A smooth texture whose left half moves right and right half moves
    left by half a pixel a frame (rounded mean of neighbours, edges
    clamped): one half-pel phase a tile, type-17 records."""
    x = _smooth_texture(np.random.default_rng(seed), h, w, False).astype(
        np.uint16)
    out = [x]
    for _ in range(f - 1):
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        x = np.concatenate([(x + left + 1)[:, : w // 2] >> 1,
                            (x + right + 1)[:, w // 2:] >> 1], axis=1)
        out.append(x)
    return [a.astype(np.uint8) for a in out]


CLIPS = {
    # name: (class or maker, frames, width, height, gray)
    "static_gentle_rgb": ("static_gentle", 16, 64, 48, False),
    "static_gentle_gray": ("static_gentle", 12, 96, 80, True),
    "pan_rgb": ("pan", 16, 64, 48, False),
    "pan_gray": ("pan", 12, 96, 80, True),
    "scene_cuts_rgb": ("scene_cuts", 20, 64, 48, False),
    "scene_cuts_gray": ("scene_cuts", 16, 96, 80, True),
    "zoom_rgb": ("zoom", 12, 64, 48, False),
    "film_grain_rgb": ("film_grain", 12, 64, 48, False),
    "pan_subpixel_rgb": ("pan_subpixel", 12, 64, 48, False),
    "rotation_rgb": (rotation, 8, 128, 96, False),
    "sensor_rgb": (sensor, 5, 64, 48, False),
    "split_halfpel_rgb": (split_halfpel, 6, 64, 48, False),
}

# Record types a clip must hold, beside being byte-identical: each of
# these predictions is emitted by no other clip.
EMITS = {"rotation_rgb": fc.ROT_G, "sensor_rgb": fc.RESIDUAL_S,
         "split_halfpel_rgb": fc.TILES_HP}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_bfvc_byte_identical_and_cross_decodes(tmp_path, name):
    cls, f, w, h, gray = CLIPS[name]
    frames = clip(cls, f, w, h, gray)
    jpath, tpath = str(tmp_path / "jax.bfvc"), str(tmp_path / "torch.bfvc")
    jstats = JaxCompressor(keyframe_interval=30).compress_video(frames,
                                                                jpath)
    tstats = ImprovedVideoCompressor(
        keyframe_interval=30, device="cpu").compress_video(frames, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read(), f"{name}: .bfvc bytes differ"
    if name in EMITS:
        assert EMITS[name] in record_types(tpath), record_types(tpath)
    for k in ("frame_count", "original_size", "compressed_size",
              "keyframes"):
        assert tstats[k] == jstats[k]
    assert_frames_equal(
        ImprovedVideoCompressor(device="cpu").decompress_video(jpath), frames)
    assert_frames_equal(JaxCompressor().decompress_video(tpath), frames)


def test_chunking_and_prefetch_do_not_change_bytes(tmp_path):
    """Chunk size, prefetch and the keyframe schedule across several
    device runs (chained on the device-resident last frame) keep the
    stream equal to the JAX package's for the same options."""
    frames = clip("pan", 14, 64, 48)
    jpath = str(tmp_path / "jax.bfvc")
    JaxCompressor(keyframe_interval=9, batch_size=4).compress_video(
        frames, jpath)
    with open(jpath, "rb") as fh:
        want = fh.read()
    for bs, prefetch in [(4, True), (4, False), (15, True)]:
        path = str(tmp_path / f"t{bs}{prefetch}.bfvc")
        comp = ImprovedVideoCompressor(keyframe_interval=9, batch_size=bs,
                                       prefetch=prefetch, device="cpu")
        comp.compress_video(frames, path)
        with open(path, "rb") as fh:
            got = fh.read()
        if bs == 4:
            assert got == want
        assert_frames_equal(comp.decompress_video(path), frames)
        assert comp.verify_lossless(
            frames, comp.decompress_video(path))["lossless"]


def test_plan_segments_matches_jax():
    from new_bloom_filter_repo_tpu.models.video import (
        _plan_segments as jax_plan)

    for total, ki, chunk in [(31, 30, 15), (14, 9, 4), (1, 30, 15),
                             (50, 7, 3)]:
        assert _plan_segments(total, ki, chunk) == jax_plan(total, ki,
                                                            chunk)


def test_decodes_jax_fixture():
    """The committed fixture: 16 frames of the seeded 96x80 ``pan``
    clip written by the JAX package (blocked records wrapped in type-6
    motion headers)."""
    kinds = record_types(FIXTURE)
    assert fc.KEYFRAME_S in kinds or fc.KEYFRAME in kinds
    assert any(isinstance(k, tuple) and k[1] in (fc.BLOCKED, fc.BLOCKED_Z,
                                                 fc.BLOCKED_S)
               for k in kinds)
    frames = clip("pan", 16, 96, 80)
    assert_frames_equal(
        ImprovedVideoCompressor(device="cpu").decompress_video(FIXTURE),
        frames)


def test_yuv_color_space_and_single_frame(tmp_path):
    frames = clip("static_gentle", 6, 64, 48)
    jpath, tpath = str(tmp_path / "j.bfvc"), str(tmp_path / "t.bfvc")
    JaxCompressor().compress_video(frames, jpath, input_color_space="YUV")
    ImprovedVideoCompressor(device="cpu").compress_video(frames, tpath,
                                             input_color_space="YUV")
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    dec = ImprovedVideoCompressor(device="cpu").decompress_video(tpath)
    assert hasattr(dec[-1], "yuv_info")
    assert_frames_equal([np.asarray(d.data) for d in dec], frames)
    one = str(tmp_path / "one.bfvc")
    ImprovedVideoCompressor(device="cpu").compress_video(frames[:1], one)
    JaxCompressor().compress_video(frames[:1], jpath)
    with open(jpath, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()


def test_verify_lossless_reports_differences():
    frames = clip("static_gentle", 3, 64, 48)
    bad = [f.copy() for f in frames]
    bad[1][0, 0, 0] ^= 1
    res = verify_lossless(frames, bad)
    assert not res["lossless"] and res["diff_frames"] == [1]
    assert verify_lossless(frames, frames[:2])["lossless"] is False
    assert verify_lossless(frames, frames)["exact_frame_matches"] == 3


@pytest.mark.parametrize("name", ["make_video", "pan"])
def test_devices_mesh_bfvc_equals_jax_single_device(tmp_path, name):
    """devices= on a (2, 2) CPU mesh: the port's stream equals the JAX
    package's single-device file byte for byte, decodes bit-exactly
    through the mesh, and the JAX package decodes it too."""
    frames = (make_video(n=20, h=48, w=64, seed=7) if name == "make_video"
              else clip("pan", 20, 64, 48))
    jpath, tpath = str(tmp_path / "jax.bfvc"), str(tmp_path / "mesh.bfvc")
    JaxCompressor().compress_video(frames, jpath)
    comp = ImprovedVideoCompressor(devices=make_mesh(2, 2, ["cpu"] * 4))
    comp.compress_video(frames, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read(), f"{name}: .bfvc bytes differ"
    assert_frames_equal(comp.decompress_video(tpath), frames)
    assert_frames_equal(JaxCompressor().decompress_video(tpath), frames)


@pytest.mark.parametrize("name", ["static_gentle", "pan"])
def test_run_pulls_are_plain_views_on_the_cpu(tmp_path, monkeypatch, name):
    """On the CPU every device run's frames come back through ``.cpu()``
    (a view): ``pull_counts()`` reads ``plain`` equal to the runs the
    decoder launched, ``pinned`` 0 and the runs' padded frame bytes, and
    the frames are the JAX package's.  The reset zeroes every count."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as tbp

    frames = clip(name, 14, 64, 48)
    path = str(tmp_path / "t.bfvc")
    comp = ImprovedVideoCompressor(keyframe_interval=9, batch_size=4,
                                   device="cpu")
    comp.compress_video(frames, path)
    runs = []
    begin = tbp.BlockedDecoder.decode_run_begin

    def counted(self, base, payloads, stage_times=None):
        runs.append(len(payloads))
        return begin(self, base, payloads, stage_times)

    monkeypatch.setattr(tbp.BlockedDecoder, "decode_run_begin", counted)
    tbp.reset_pull_counts()
    got = comp.decompress_video(path)
    assert len(runs) >= 2
    assert tbp.pull_counts() == {"pinned": 0, "plain": len(runs),
                                 "bytes": sum(runs) * frames[0].nbytes}
    assert_frames_equal(got, frames)
    assert_frames_equal(got, JaxCompressor().decompress_video(path))
    tbp.reset_pull_counts()
    assert tbp.pull_counts() == {"pinned": 0, "plain": 0, "bytes": 0}
