"""The PyTorch port's other profiles and modes against the JAX package's.

Planar (I420, YV12, 444), the byte view (uint16, float32 with NaN,
BGRA), ``profile="bfv2"`` (type-0 Bloom records), ``exact=False``, mixed
shapes and ``mode="keyframe"``: for the same frames and options both
packages must write byte-identical ``.bfvc`` files and each must decode
the other's bit-pattern exactly (``tobytes()`` equality, so NaN payloads
count).  The color, median and diff ops are held to the JAX ops.  The
port runs on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu.models.video import (
    ImprovedVideoCompressor as JaxCompressor,
)
from new_bloom_filter_repo_tpu.ops import color as jcolor
from new_bloom_filter_repo_tpu.ops import diff as jdiff
from new_bloom_filter_repo_tpu.ops import median as jmedian
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models import video as video_mod
from new_bloom_filter_repo_tpu_torch.models.video import (
    FixedVideoCompressor,
    ImprovedVideoCompressor,
    verify_lossless,
)
from new_bloom_filter_repo_tpu_torch.ops import color as tcolor
from new_bloom_filter_repo_tpu_torch.ops import diff as tdiff
from new_bloom_filter_repo_tpu_torch.ops import median as tmedian
from new_bloom_filter_repo_tpu_torch.utils import container
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame
from test_video_api import make_video

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


def bit_exact(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def both(tmp_path, frames, color_space="BGR", **kw):
    """Compress with both packages; require identical files and
    cross-decoding that agrees.  Returns (path, port stats, port decode
    of the JAX file)."""
    jpath, tpath = str(tmp_path / "jax.bfvc"), str(tmp_path / "torch.bfvc")
    jstats = JaxCompressor(**kw).compress_video(
        frames, jpath, input_color_space=color_space)
    tstats = ImprovedVideoCompressor(**kw, device="cpu").compress_video(
        frames, tpath, input_color_space=color_space)
    assert read(jpath) == read(tpath), ".bfvc bytes differ"
    for k in ("frame_count", "original_size", "compressed_size",
              "keyframes"):
        assert tstats[k] == jstats[k]
    from_jax = ImprovedVideoCompressor(**kw, device="cpu").decompress_video(
        jpath)
    bit_exact(from_jax, JaxCompressor(**kw).decompress_video(tpath))
    return tpath, tstats, from_jax


def record_types(path):
    return [fc.record_type(p) for p in container.read_bfvc(path)[1]]


# ---------------------------------------------------------------------------
# planar
# ---------------------------------------------------------------------------

def yuv_clip(fmt, n=10, h=48, w=64, seed=13):
    """YUVFrames with native planes: a bar moving through Y, a chroma
    patch changing in U; ``fmt`` YUV444 keeps full-resolution planes."""
    rng = np.random.default_rng(seed)
    sub = 1 if fmt == "YUV444" else 2
    by = rng.integers(0, 200, (h, w), dtype=np.uint8)
    bu = rng.integers(0, 200, (h // sub, w // sub), dtype=np.uint8)
    bv = rng.integers(0, 200, (h // sub, w // sub), dtype=np.uint8)
    frames = []
    for i in range(n):
        y = by.copy()
        y[8:16, 2 + 3 * i:10 + 3 * i] = 250
        noise = rng.random((h, w)) < 0.02
        y[noise] = rng.integers(0, 256, int(noise.sum()))
        u = bu.copy()
        u[2:6, 2:6] = min(255, 10 * i)
        up = [np.repeat(np.repeat(p, sub, 0), sub, 1) for p in (u, bv)]
        frames.append(YUVFrame(np.stack([y, *up], axis=-1),
                               {"format": fmt, "y_plane": y, "u_plane": u,
                                "v_plane": bv.copy()}))
    return frames


@pytest.mark.parametrize("fmt", ["I420", "YV12", "YUV444"])
def test_planar_equals_jax_and_is_plane_exact(tmp_path, fmt):
    frames = yuv_clip(fmt)
    path, stats, from_jax = both(tmp_path, frames, "YUV",
                                 profile="planar", keyframe_interval=5)
    assert record_types(path)[0] == fc.PLANAR
    assert stats["original_size"] == sum(
        sum(f.yuv_info[p].nbytes for p in ("y_plane", "u_plane", "v_plane"))
        for f in frames)
    rec = ImprovedVideoCompressor(device="cpu").decompress_video(path)
    assert verify_lossless(frames, rec)["lossless"]
    for f, r in zip(frames, rec):
        assert r.yuv_info["format"] == fmt
        for pl in ("y_plane", "u_plane", "v_plane"):
            np.testing.assert_array_equal(f.yuv_info[pl], r.yuv_info[pl])


def test_planar_beats_444_and_rejects_bad_planes(tmp_path):
    frames = yuv_clip("I420", n=12)
    p = ImprovedVideoCompressor(profile="planar", device="cpu").compress_video(
        frames, str(tmp_path / "p.bfvc"), input_color_space="YUV")
    f = ImprovedVideoCompressor(device="cpu").compress_video(
        frames, str(tmp_path / "f.bfvc"), input_color_space="YUV")
    assert p["compressed_size"] < f["compressed_size"]
    rng = np.random.default_rng(3)
    deep = []
    for _ in range(3):
        y = rng.integers(0, 1023, (16, 16), dtype=np.uint16)
        y8 = (y >> 2).astype(np.uint8)
        deep.append(YUVFrame(np.stack([y8] * 3, axis=-1), {
            "format": "I420", "y_plane": y,
            "u_plane": rng.integers(0, 1023, (8, 8), dtype=np.uint16),
            "v_plane": rng.integers(0, 1023, (8, 8), dtype=np.uint16)}))
    with pytest.raises(ValueError, match="uint8"):
        ImprovedVideoCompressor(profile="planar", device="cpu").compress_video(
            deep, input_color_space="YUV")
    mixed = yuv_clip("I420", n=2) + yuv_clip("YUV444", n=1)
    with pytest.raises(ValueError, match="uniform plane geometry"):
        ImprovedVideoCompressor(profile="planar", device="cpu").compress_video(
            mixed, input_color_space="YUV")


# ---------------------------------------------------------------------------
# byte view
# ---------------------------------------------------------------------------

def byte_view_clip(kind):
    """The byte-domain clips of tests/test_hdr_and_determinism.py."""
    if kind == "uint16":
        rng = np.random.default_rng(1)
        base = rng.integers(0, 1 << 16, (32, 48), dtype=np.uint16)
        frames = []
        for i in range(6):
            f = base.copy()
            f[4:8, 4 + 2 * i: 10 + 2 * i] = 40000 + i
            frames.append(f)
        return frames
    if kind == "float32":
        rng = np.random.default_rng(0)
        base = rng.random((24, 64, 3), dtype=np.float32) * 100
        base[3, 5, 1] = np.nan  # NaN payload must survive bit-exactly
        base.view(np.uint32)[7, 9, 2] = 0x7FC00ABC  # a non-canonical NaN
        frames = []
        for i in range(8):
            f = base.copy()
            f[10:14, 2 + 3 * i: 8 + 3 * i] = 7.5 + i
            frames.append(f)
        return frames
    rng = np.random.default_rng(2)
    base = rng.integers(0, 255, (24, 40, 4), dtype=np.uint8)
    frames = []
    for i in range(6):
        f = base.copy()
        f[6:12, 3 * i: 3 * i + 6] = (9, 8, 7, 255)
        frames.append(f)
    return frames


@pytest.mark.parametrize("kind", ["uint16", "float32", "bgra"])
def test_byte_view_equals_jax_bit_pattern_exact(tmp_path, kind):
    frames = byte_view_clip(kind)
    path, stats, from_jax = both(tmp_path, frames, keyframe_interval=6)
    bit_exact(from_jax, frames)
    bit_exact(ImprovedVideoCompressor(device="cpu").decompress_video(path),
              frames)
    types = record_types(path)
    assert types[0] in (fc.KEYFRAME, fc.FILTERED, fc.KEYFRAME_S)
    assert any(t not in (fc.KEYFRAME, fc.FILTERED, fc.KEYFRAME_S)
               for t in types[1:]), types
    key = ImprovedVideoCompressor(mode="keyframe",
                                  device="cpu").compress_video(
        frames, str(tmp_path / "k.bfvc"))
    assert stats["compressed_size"] < key["compressed_size"]


def test_byte_view_runs_the_blocked_kernels(monkeypatch, tmp_path):
    """The byte view encodes through the blocked pipeline with
    byte_view=True and decodes its runs on the uint8 byte view."""
    frames = byte_view_clip("uint16")
    seen = []
    begin = video_mod.blocked_pipeline.BlockedEncoder.encode_chunk_begin

    def spy(self, base, chunk, *a, **kw):
        seen.append((base.dtype, base.shape, kw.get("byte_view")))
        return begin(self, base, chunk, *a, **kw)

    monkeypatch.setattr(video_mod.blocked_pipeline.BlockedEncoder,
                        "encode_chunk_begin", spy)
    comp = ImprovedVideoCompressor(keyframe_interval=6, device="cpu")
    comp.compress_video(frames, str(tmp_path / "u16.bfvc"))
    assert seen == [(np.uint8, (32, 96), True)]


def test_byte_domain_rejects_host_predicted_wrappers():
    prev = np.zeros((4, 4), np.uint16)
    comp = ImprovedVideoCompressor(device="cpu")
    for rtype, name in [(fc.TILES, "tile-motion"), (fc.ZOOM_G, "zoom"),
                        (fc.ROT_G, "rotation"), (fc.AVG2, "avg2"),
                        (fc.REF_HP, "multi-ref")]:
        with pytest.raises(ValueError, match=f"{name}.*byte-domain"):
            comp._apply_residual_record(bytes([rtype]) + bytes(20), rtype,
                                        prev, [prev], True)


# ---------------------------------------------------------------------------
# BFV2
# ---------------------------------------------------------------------------

def scene_cut_clip():
    """Every frame a full scene change (the keyframe fallback)."""
    rng = np.random.default_rng(31)
    return [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
            for _ in range(6)]


BFV2_CLIPS = {
    # name: (frames, keyframe_interval)
    "moving": (lambda: make_video(10, h=40, w=56, seed=21), 10),
    "gray": (lambda: make_video(9, h=40, w=56, c=0, seed=4), 9),
    "scene_cuts": (scene_cut_clip, 6),
}


@pytest.mark.parametrize("name", sorted(BFV2_CLIPS))
def test_bfv2_equals_jax_and_loop(tmp_path, name):
    make, ki = BFV2_CLIPS[name]
    frames = make()
    path, stats, from_jax = both(tmp_path, frames, profile="bfv2",
                                 keyframe_interval=ki)
    bit_exact(from_jax, frames)
    types = record_types(path)
    assert set(types) <= {fc.INTERFRAME, fc.KEYFRAME, fc.FILTERED,
                          fc.KEYFRAME_S}
    if name == "scene_cuts":
        assert stats["keyframes"] > 1
    else:
        assert any(ImprovedVideoCompressor._is_legacy_bloom(p)
                   for p in container.read_bfvc(path)[1])
    comp = ImprovedVideoCompressor(profile="bfv2", keyframe_interval=ki,
                                   device="cpu")
    assert comp._encode_frames(frames) == comp._encode_frames_loop(frames)


def test_cross_profile_decode(tmp_path):
    frames = make_video(5, h=32, w=40, noise=2, seed=8)
    out = []
    for profile in ("bfv2", "blocked"):
        path = str(tmp_path / f"{profile}.bfvc")
        ImprovedVideoCompressor(profile=profile, keyframe_interval=5,
                                device="cpu").compress_video(frames, path)
        out.append(ImprovedVideoCompressor(device="cpu").decompress_video(
            path))
    bit_exact(out[0], out[1])
    bit_exact(out[0], frames)


def test_bfv2_records_in_a_byte_domain_stream(tmp_path):
    """Type-0 Bloom records over the byte view (the JAX package's loop
    path never writes them, but its decoder reads them): written by hand
    from the byte view's masks, decoded bit-exactly by both packages."""
    frames = byte_view_clip("uint16")[:3]
    codec = ImprovedVideoCompressor(device="cpu").bloom_compressor
    payloads = [fc.encode_keyframe_best(frames[0], None)]
    for prev, cur in zip(frames, frames[1:]):
        pv, cv = (ImprovedVideoCompressor._byte_view(x) for x in (prev, cur))
        mask = (pv != cv).astype(np.uint8)
        payloads.append(fc.encode_interframe(mask, cv[mask.astype(bool)],
                                             codec))
    path = str(tmp_path / "b.bfvc")
    container.write_bfvc(path, payloads, container.MAGIC_BLOOM)
    assert ImprovedVideoCompressor._is_legacy_bloom(payloads[1])
    bit_exact(ImprovedVideoCompressor(device="cpu").decompress_video(path),
              frames)
    bit_exact(JaxCompressor().decompress_video(path), frames)


# ---------------------------------------------------------------------------
# exact=False, mixed shapes, keyframe mode
# ---------------------------------------------------------------------------

def near_lossless_clip():
    frames = make_video(8, noise=4, seed=7)
    for i, f in enumerate(frames):
        f[8:20, 3 + 4 * i:13 + 4 * i, :] = 255
    return frames


@pytest.mark.parametrize("direct_yuv", [False, True])
def test_near_lossless_equals_jax_and_its_reconstruction(tmp_path,
                                                         monkeypatch,
                                                         direct_yuv):
    frames = near_lossless_clip()
    recon = []
    apply_diff = video_mod.diff_ops.apply_diff

    def spy(*args, **kw):
        recon.append(apply_diff(*args, **kw))
        return recon[-1]

    monkeypatch.setattr(video_mod.diff_ops, "apply_diff", spy)
    kw = dict(exact=False, noise_tolerance=10.0, keyframe_interval=8,
              use_direct_yuv=direct_yuv)
    path, _, from_jax = both(tmp_path, frames, **kw)
    assert len(recon) == len(frames) - 1      # every inter frame
    dec = ImprovedVideoCompressor(**kw, device="cpu").decompress_video(path)
    bit_exact(dec[1:], recon)
    np.testing.assert_array_equal(dec[0], frames[0])
    patch = np.asarray(dec[-1])[8:20, 31:41]
    assert (patch == 255).all(axis=-1).mean() > 0.9
    assert not verify_lossless(frames, dec)["lossless"]


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_frame_threshold_sigma_equals_jax(gray):
    """The noise sigma behind the near-lossless threshold, on the same
    frames: rtol 1e-6 (float32 sums in another order), and the host
    threshold derived from it."""
    kw = dict(exact=False, noise_tolerance=10.0, bloom_threshold_modifier=1.3)
    for i, f in enumerate(make_video(4, h=48, w=64, seed=9)):
        x = np.array(f[..., 0] if gray else jcolor.bgr_to_gray(
            jnp.asarray(f)))
        want = float(jmedian.noise_level(jnp.asarray(x)))
        got = float(tmedian.noise_level(torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(
            ImprovedVideoCompressor(**kw, device="cpu")._frame_threshold(x),
            JaxCompressor(**kw)._frame_threshold(x), rtol=1e-6)


def test_mixed_shapes_and_dtypes_take_the_loop(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
              rng.integers(0, 256, (16, 8, 3), dtype=np.uint8),
              rng.integers(0, 256, (16, 8, 3), dtype=np.uint8),
              rng.random((16, 8, 3), dtype=np.float32)]
    frames[2] = frames[1].copy()
    frames[2][:2, :3] ^= 0x55
    path, stats, from_jax = both(tmp_path, frames)
    assert stats["keyframes"] == 3
    assert record_types(path)[2] == fc.INTERFRAME
    bit_exact(from_jax, frames)


def test_keyframe_mode_writes_golden_bytes(tmp_path):
    """mode='keyframe' on the reference's frames writes the reference's
    file byte for byte (DEFLATE level 9), and the port decodes it; each
    mode's keyframe DEFLATE level is the JAX package's."""
    for mode in ("bloom", "keyframe"):
        assert (ImprovedVideoCompressor(mode=mode,
                                        device="cpu")._keyframe_zlib_level
                == JaxCompressor(mode=mode)._keyframe_zlib_level)
    frames = np.load(os.path.join(FIXTURES, "golden_frames.npz"))["bgr"]
    out = str(tmp_path / "ours.bfvc")
    ImprovedVideoCompressor(mode="keyframe", device="cpu").compress_video(
        list(frames), out)
    assert read(out) == read(os.path.join(FIXTURES, "golden_ref.bfvc"))
    assert container.read_bfvc(out)[0] == container.MAGIC_FIXED
    rec = ImprovedVideoCompressor(device="cpu").decompress_video(
        os.path.join(FIXTURES, "golden_ref.bfvc"))
    bit_exact(rec, list(frames))
    gray = ImprovedVideoCompressor(device="cpu").decompress_video(
        os.path.join(FIXTURES, "golden_ref_gray.bfvc"))
    bit_exact(gray, JaxCompressor().decompress_video(
        os.path.join(FIXTURES, "golden_ref_gray.bfvc")))


def test_fixed_compressor_round_trips_yuv():
    frames = [video_mod.add_yuv_info_to_frame(f) for f in make_video(4)]
    comp = FixedVideoCompressor(verbose=False)
    rec = comp.decompress_video(comp.compress_video(frames))
    assert comp.verify_lossless(frames, rec)["lossless"]
    np.testing.assert_array_equal(rec[0].yuv_info["u_plane"],
                                  frames[0].yuv_info["u_plane"])


# ---------------------------------------------------------------------------
# color, median and diff ops
# ---------------------------------------------------------------------------

def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", ["bgr_to_gray", "rgb_to_gray",
                                  "bgr_to_rgb", "rgb_to_bgr", "bgr_to_yuv",
                                  "yuv_to_bgr", "gray_to_bgr"])
def test_color_ops_equal_jax(name):
    x = _img((17, 23) if name == "gray_to_bgr" else (17, 23, 3))
    # every u8 triple's corner cases: extremes and mid-grey
    if x.ndim == 3:
        x[0, :8] = [[0, 0, 0], [255, 255, 255], [0, 255, 0], [255, 0, 255],
                    [128, 128, 128], [0, 0, 255], [255, 0, 0], [16, 128, 240]]
    got = getattr(tcolor, name)(torch.from_numpy(x))
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,ksize", [((20, 31), 5), ((20, 31, 3), 5),
                                         ((9, 7), 3)])
def test_median_and_noise_equal_jax(shape, ksize):
    x = _img(shape, seed=ksize)
    got = tmedian.median_blur(torch.from_numpy(x), ksize)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmedian.median_blur(jnp.asarray(x), ksize)))
    np.testing.assert_allclose(
        float(tmedian.noise_level(torch.from_numpy(x), ksize)),
        float(jmedian.noise_level(jnp.asarray(x), ksize)), rtol=1e-6)
    assert tmedian.noise_level(torch.from_numpy(x)).dtype == torch.float32
    with pytest.raises(ValueError, match="odd"):
        tmedian.median_blur(torch.from_numpy(x), 4)


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("shape", [(16, 12), (16, 12, 3)])
def test_diff_ops_equal_jax(shape, direct):
    prev, curr = _img(shape, 1), _img(shape, 1)
    m = np.random.default_rng(2).random(shape[:2]) < 0.3
    curr[m] = _img(shape, 3)[m]
    tp, tc = torch.from_numpy(prev), torch.from_numpy(curr)
    for thr in (0.0, 3.0, 7.4999, 30.0):
        got = tdiff.diff_mask_thresholded(tp, tc, thr, use_direct_yuv=direct)
        want = jdiff.diff_mask_thresholded(jnp.asarray(prev),
                                           jnp.asarray(curr), thr,
                                           use_direct_yuv=direct)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = tdiff.diff_mask_exact(tp, tc).numpy()
    np.testing.assert_array_equal(exact, np.asarray(jdiff.diff_mask_exact(
        jnp.asarray(prev), jnp.asarray(curr))))
    info = ({"y_plane": curr[..., 0].copy(), "u_plane": curr[..., 1].copy(),
             "v_plane": curr[..., 2].copy()} if len(shape) == 3 else None)
    vals = tdiff.gather_changed_values(curr, exact, info)
    np.testing.assert_array_equal(
        vals, jdiff.gather_changed_values(curr, exact, info))
    base_info = (None if info is None else
                 {k: prev[..., i].copy() for i, k in
                  enumerate(("y_plane", "u_plane", "v_plane"))})
    out = tdiff.apply_diff(prev, exact, vals, base_info)
    np.testing.assert_array_equal(out, curr)
    if base_info is not None:
        np.testing.assert_array_equal(base_info["u_plane"], curr[..., 1])
