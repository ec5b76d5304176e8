"""The PyTorch port's file I/O against the JAX package's.

Y4M and raw planar YUV (``utils/videoio``), OpenEXR (``utils/exr``),
the stream report (``utils/streaminfo``) and the Y4M suite writer
(``utils/synthetic``): for the same seeded inputs both packages write
the same file bytes, each reads the other's files, and their errors
match.  Every comparison is exact (file bytes, ``tobytes()`` of frames).
All of it is host code; where a compressor is needed it runs on the CPU.
"""

import os
import struct

import numpy as np
import pytest

from new_bloom_filter_repo_tpu.utils import exr as jexr
from new_bloom_filter_repo_tpu.utils import streaminfo as jstreaminfo
from new_bloom_filter_repo_tpu.utils import synthetic as jsynthetic
from new_bloom_filter_repo_tpu.utils import videoio as jvideoio
from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.utils import container, exr, native
from new_bloom_filter_repo_tpu_torch.utils import streaminfo, synthetic
from new_bloom_filter_repo_tpu_torch.utils import videoio
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
W, H = 64, 48


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# Y4M
# ---------------------------------------------------------------------------

Y4M_CHROMA = {"420jpeg": (W // 2, H // 2), "422": (W // 2, H),
              "444": (W, H), "mono": (0, 0)}


def y4m_planes(colorspace, n=5, seed=0):
    rng = np.random.default_rng(seed)
    cw, ch = Y4M_CHROMA[colorspace]
    out = []
    for _ in range(n):
        planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)]
        if cw:
            planes += [rng.integers(0, 256, (ch, cw), dtype=np.uint8)
                       for _ in range(2)]
        out.append(tuple(planes))
    return out


@pytest.mark.parametrize("colorspace", sorted(Y4M_CHROMA))
def test_y4m_files_equal_and_each_reads_the_others(tmp_path, colorspace):
    planes = y4m_planes(colorspace)
    jpath, tpath = str(tmp_path / "j.y4m"), str(tmp_path / "t.y4m")
    jvideoio.write_y4m(jpath, planes, W, H, colorspace, fps=(30, 1))
    videoio.write_y4m(tpath, planes, W, H, colorspace, fps=(30, 1))
    assert read(jpath) == read(tpath)
    for max_frames in (0, 3):
        got, gp = videoio.read_y4m(jpath, max_frames)
        want, wp = jvideoio.read_y4m(tpath, max_frames)
        assert len(got) == len(want) == (max_frames or len(planes))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        assert {k: gp[k] for k in gp if k != "planes"} == {
            k: wp[k] for k in wp if k != "planes"}
        assert gp["fps"] == (30, 1) and gp["colorspace"] == colorspace
        for gpl, wpl, src in zip(gp["planes"], wp["planes"], planes):
            assert len(gpl) == len(wpl) == len(src)
            for a, b, c in zip(gpl, wpl, src):
                assert a.tobytes() == b.tobytes() == c.tobytes()


def _bad_y4m(kind, path):
    if kind == "not_y4m":
        data = b"RIFF this is not a y4m file\n"
    elif kind == "no_dimensions":
        data = b"YUV4MPEG2 F25:1\nFRAME\n"
    elif kind == "unsupported_colorspace":
        data = b"YUV4MPEG2 W4 H4 C411\nFRAME\n" + bytes(24)
    else:
        assert kind == "bad_frame_marker"
        data = b"YUV4MPEG2 W4 H4 C444\nFRAME\n" + bytes(48) + b"JUNK!\n"
    with open(path, "wb") as fh:
        fh.write(data)


@pytest.mark.parametrize("kind", ["not_y4m", "no_dimensions",
                                  "unsupported_colorspace",
                                  "bad_frame_marker"])
def test_y4m_errors_match(tmp_path, kind):
    path = str(tmp_path / "bad.y4m")
    _bad_y4m(kind, path)
    with pytest.raises(ValueError) as want:
        jvideoio.read_y4m(path)
    with pytest.raises(ValueError) as got:
        videoio.read_y4m(path)
    assert str(got.value) == str(want.value)


def test_open_video_frames_reads_y4m_without_cv2(tmp_path, monkeypatch):
    path = str(tmp_path / "v.y4m")
    videoio.write_y4m(path, y4m_planes("420jpeg"), W, H)
    monkeypatch.setattr(videoio, "_cv2", None)
    frames = videoio.open_video_frames(path, max_frames=2)
    want, _ = videoio.read_y4m(path, 2)
    assert len(frames) == 2
    assert all(a.tobytes() == b.tobytes() for a, b in zip(frames, want))
    with pytest.raises(RuntimeError, match="OpenCV is not installed"):
        videoio.open_video_frames(__file__)
    with pytest.raises(RuntimeError, match="OpenCV is not installed"):
        videoio.write_video_frames(frames, str(tmp_path / "o.mp4"))
    with pytest.raises(ValueError, match="Video file not found"):
        videoio.open_video_frames(str(tmp_path / "missing.mp4"))


# ---------------------------------------------------------------------------
# raw planar YUV
# ---------------------------------------------------------------------------

RAW_SUB = {"I420": (2, 2), "YV12": (2, 2), "YUV422": (2, 1),
           "YUV444": (1, 1)}


def raw_yuv_file(path, fmt, n=5, seed=1):
    sx, sy = RAW_SUB[fmt]
    size = W * H + 2 * (W // sx) * (H // sy)
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        # a short tail after the last whole frame must be ignored
        fh.write(rng.integers(0, 256, n * size + 7, dtype=np.uint8).tobytes())
    return size


@pytest.mark.parametrize("fmt", sorted(RAW_SUB))
def test_raw_yuv_reads_equal_and_writes_reproduce_the_file(tmp_path, fmt):
    src = str(tmp_path / "in.yuv")
    size = raw_yuv_file(src, fmt)
    for kw in ({}, {"max_frames": 2}, {"frame_step": 2},
               {"frame_step": 2, "max_frames": 2}):
        got = videoio.read_raw_yuv(src, W, H, fmt, **kw)
        want = jvideoio.read_raw_yuv(src, W, H, fmt, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert isinstance(g, YUVFrame)
            assert g.data.tobytes() == w.data.tobytes()
            assert g.yuv_info["format"] == w.yuv_info["format"] == fmt
            for key in ("y_plane", "u_plane", "v_plane"):
                assert g.yuv_info[key].shape == w.yuv_info[key].shape
                assert (g.yuv_info[key].tobytes()
                        == w.yuv_info[key].tobytes())
    frames = videoio.read_raw_yuv(src, W, H, fmt)
    jout, tout = str(tmp_path / "j.yuv"), str(tmp_path / "t.yuv")
    # the JAX writer on the port's frames and the other way round
    jvideoio.write_raw_yuv(jout, frames)
    videoio.write_raw_yuv(tout, jvideoio.read_raw_yuv(src, W, H, fmt))
    assert read(jout) == read(tout) == read(src)[:5 * size]


def test_raw_yuv_yv12_swaps_chroma(tmp_path):
    src = str(tmp_path / "in.yuv")
    raw_yuv_file(src, "YV12", n=1)
    as_yv12 = videoio.read_raw_yuv(src, W, H, "YV12")[0].yuv_info
    as_i420 = videoio.read_raw_yuv(src, W, H, "I420")[0].yuv_info
    assert as_yv12["u_plane"].tobytes() == as_i420["v_plane"].tobytes()
    assert as_yv12["v_plane"].tobytes() == as_i420["u_plane"].tobytes()
    # an explicit fmt overrides the frames' own on write
    out = str(tmp_path / "o.yuv")
    videoio.write_raw_yuv(out, videoio.read_raw_yuv(src, W, H, "I420"),
                          "YV12")
    swapped = videoio.read_raw_yuv(out, W, H, "I420")[0].yuv_info
    assert swapped["u_plane"].tobytes() == as_i420["v_plane"].tobytes()


def test_raw_yuv_errors_match(tmp_path):
    src = str(tmp_path / "in.yuv")
    raw_yuv_file(src, "I420", n=1)
    for mod in (jvideoio, videoio):
        with pytest.raises(ValueError, match="unsupported YUV format: NV12"):
            mod.read_raw_yuv(src, W, H, "NV12")
        with pytest.raises(ValueError, match="carries no yuv_info planes"):
            mod.write_raw_yuv(str(tmp_path / "o.yuv"),
                              [np.zeros((H, W, 3), np.uint8)])


# ---------------------------------------------------------------------------
# OpenEXR
# ---------------------------------------------------------------------------

def exr_image(kind, seed=2):
    rng = np.random.default_rng(seed)
    if kind == "half_gray":
        img = rng.normal(0, 8, (41, 29)).astype(np.float16)
        img[0, 0] = np.float16("nan")
        img[1, 2] = np.float16("inf")
        img[3, 4] = np.float16(6e-8)              # denormal
    elif kind == "float_rgb":
        img = (rng.random((37, 23, 3)) * 10).astype(np.float32)
        img[5:12, 4:10] = 123.456
        # NaNs with distinct payloads, infinities, a negative zero
        img.view(np.uint32)[0, 0, 0] = 0x7FC00001
        img.view(np.uint32)[0, 1, 1] = 0xFFC12345
        img[0, 2, 2] = -0.0
        img[1, 0, 0] = np.inf
    else:
        assert kind == "half_rgba"
        img = rng.normal(0, 2, (33, 18, 4)).astype(np.float16)
        img[..., 0] = np.float16(1.0)              # a constant alpha
        img[2, 3, 1] = np.float16("-inf")
    return img


@pytest.mark.parametrize("compression", ["none", "rle", "zips", "zip",
                                         "piz"])
@pytest.mark.parametrize("kind", ["half_gray", "float_rgb", "half_rgba"])
def test_exr_files_equal_and_each_reads_the_others(tmp_path, kind,
                                                   compression):
    img = exr_image(kind)
    jpath, tpath = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(jpath, img, compression=compression)
    exr.write_exr(tpath, img, compression=compression)
    assert read(jpath) == read(tpath)
    got, want = exr.read_exr(jpath), jexr.read_exr(tpath)
    assert got.dtype == want.dtype == img.dtype
    assert got.shape == want.shape == img.shape
    if kind == "half_rgba":
        # written as A, B, G, R; read back with B, G, R first
        img = np.ascontiguousarray(img[..., [1, 2, 3, 0]])
    assert got.tobytes() == want.tobytes() == img.tobytes()


def test_exr_golden_piz_fixture_decodes_and_reencodes(tmp_path):
    fix = os.path.join(FIXTURES, "golden_piz.exr")
    expect = np.load(os.path.join(FIXTURES, "golden_piz_expect.npy"))
    back = exr.read_exr(fix)
    assert np.array_equal(back.view(np.uint16), expect)
    out = str(tmp_path / "re.exr")
    exr.write_exr(out, expect.view(np.float16), compression="piz")
    assert read(out) == read(fix)


@pytest.mark.parametrize("n,hi", [(1, 2), (100, 7), (5000, 300),
                                  (40000, 61000)])
def test_exr_native_huffman_decoder_equals_python(n, hi):
    rng = np.random.default_rng(9)
    data = rng.integers(0, hi, n).astype(np.uint16)
    if n > 10:
        data[10:] = data[9]          # a long run: the run-length path
    blob = exr._huf_compress(data)
    assert blob == jexr._huf_compress(data)
    im, iM, _, n_bits, _ = struct.unpack_from("<IIIII", blob, 0)
    lengths, off = exr._huf_unpack_table(blob, 20, im, iM)
    codes = exr._huf_canonical_codes(lengths)
    py = exr._huf_decode(blob[off:], n_bits, codes, lengths, iM, n)
    nat = native.huf_decode(blob[off:], n_bits, lengths, codes, iM, n)
    assert nat is not None, "the port always has the native decoder"
    assert np.array_equal(py, data) and np.array_equal(nat, data)
    assert np.array_equal(exr._huf_uncompress(blob, n), data)


def test_exr_malformed_input_errors_match(tmp_path):
    bad = str(tmp_path / "bad.exr")
    with open(bad, "wb") as fh:
        fh.write(b"garbage file")
    for mod in (jexr, exr):
        with pytest.raises(ValueError, match="not an EXR"):
            mod.read_exr(bad)
        with pytest.raises(ValueError):
            mod._rle_uncompress(b"\x7f", 5)              # truncated repeat
        with pytest.raises(ValueError):
            mod._rle_uncompress(bytes([250, 1, 2]), 16)  # short literal
        with pytest.raises(ValueError, match="truncated PIZ Huffman"):
            mod._huf_uncompress(b"\x00" * 8, 4)
    # version flag 0x200 is refused as "multi-part" by both readers (the
    # port copies the reference's reading of that flag as it is)
    img = exr_image("half_gray")
    good = str(tmp_path / "good.exr")
    exr.write_exr(good, img)
    blob = bytearray(read(good))
    blob[5] |= 0x02
    with open(bad, "wb") as fh:
        fh.write(blob)
    for mod in (jexr, exr):
        with pytest.raises(ValueError, match="multi-part"):
            mod.read_exr(bad)


def test_exr_corrupt_piz_chunks_fail_the_same_way(tmp_path):
    """A flipped byte in a PIZ chunk either decodes to the same wrong
    image in both packages or raises the same typed error."""
    import zlib

    img = np.linspace(0, 5, 33 * 21).astype(np.float16).reshape(33, 21)
    path = str(tmp_path / "c.exr")
    exr.write_exr(path, img, compression="piz")
    data = read(path)
    rng = np.random.default_rng(5)
    for _ in range(12):
        mut = bytearray(data)
        mut[int(rng.integers(len(data) - 200, len(data)))] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(mut)
        outcome = []
        for mod in (jexr, exr):
            try:
                outcome.append(mod.read_exr(path).tobytes())
            except (ValueError, struct.error, zlib.error) as exc:
                outcome.append((type(exc), str(exc)))
        assert outcome[0] == outcome[1]


# ---------------------------------------------------------------------------
# golden keyframe records
# ---------------------------------------------------------------------------

def golden_records(name):
    data = read(os.path.join(FIXTURES, name))
    count = struct.unpack_from("<I", data, 0)[0]
    off = 4
    for _ in range(count):
        ln = struct.unpack_from("<I", data, off)[0]
        yield data[off + 4:off + 4 + ln]
        off += 4 + ln


def test_port_encodes_the_golden_bgr_keyframes():
    frames = np.load(os.path.join(FIXTURES, "golden_frames.npz"))["bgr"]
    records = list(golden_records("golden_keyframes_bgr.bin"))
    assert len(records) == len(frames) > 0
    for frame, ref in zip(frames, records):
        assert fc.encode_keyframe(frame) == ref
        out, info = fc.decode_keyframe(ref)
        assert info is None and out.tobytes() == frame.tobytes()


def test_port_decodes_the_golden_yuv_keyframes():
    frames = np.load(os.path.join(FIXTURES, "golden_frames.npz"))["yuv"]
    records = list(golden_records("golden_keyframes_yuv.bin"))
    assert len(records) == len(frames) > 0
    for frame, ref in zip(frames, records):
        out, info = fc.decode_keyframe(ref)
        assert out.tobytes() == frame.tobytes()
        assert info is not None
        for ch, key in enumerate(("y_plane", "u_plane", "v_plane")):
            np.testing.assert_array_equal(info[key], frame[:, :, ch])
        assert fc.encode_keyframe(frame, info) == ref


# ---------------------------------------------------------------------------
# stream report
# ---------------------------------------------------------------------------

def port_stream(tmp_path, profile):
    """A .bfvc written by the port on the CPU, one per profile."""
    if profile == "pan_fixture":
        return os.path.join(FIXTURES, "torch_port_pan.bfvc")
    frames = synthetic.generate_frames(
        8, W, H, seed=3, color_space="YUV" if profile == "planar" else "BGR",
        **synthetic.SUITE["static_gentle"])
    kw = {"mode": "keyframe"} if profile == "keyframe" else {
        "profile": profile}
    path = str(tmp_path / f"{profile}.bfvc")
    ImprovedVideoCompressor(device="cpu", keyframe_interval=4,
                            **kw).compress_video(
        frames, path,
        input_color_space="YUV" if profile == "planar" else "BGR")
    return path


@pytest.mark.parametrize("profile", ["blocked", "planar", "bfv2",
                                     "keyframe", "pan_fixture"])
def test_stream_report_equals_the_reference(tmp_path, profile):
    path = port_stream(tmp_path, profile)
    magic, payloads = container.read_bfvc(path)
    body = (payloads[1:] if payloads[0][:1] == bytes([fc.PLANAR])
            else payloads)
    got = streaminfo.attribute_stream(body)
    want = jstreaminfo.attribute_stream(body)
    assert got == want
    assert got["total_bytes"] == sum(len(p) for p in body)
    assert sum(r["count"] for r in got["records"].values()) == len(body)
    if profile == "pan_fixture":
        assert got["wrapped_inner_types"]
    assert (streaminfo.format_report(path, magic, got)
            == jstreaminfo.format_report(path, magic, want))
    assert streaminfo.RECORD_NAMES == jstreaminfo.RECORD_NAMES
    assert streaminfo.CODING_NAMES == jstreaminfo.CODING_NAMES


def test_stream_report_counts_truncated_records_as_unparsed():
    rec = bytes([fc.BLOCKED_S]) + bytes(20) + bytes([1, 255, 255, 255, 255])
    for mod in (jstreaminfo, streaminfo):
        info = mod.attribute_stream([rec])
        assert info["section_codings"]["unparsed"]["count"] == 1
        with pytest.raises(ValueError, match="empty record"):
            mod.attribute_stream([b""])


# ---------------------------------------------------------------------------
# the Y4M suite
# ---------------------------------------------------------------------------

def test_generate_y4m_suite_equals_the_reference(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    want = jsynthetic.generate_y4m_suite(jdir, width=W, height=H,
                                         frame_count=4, seed=2)
    got = synthetic.generate_y4m_suite(tdir, width=W, height=H,
                                       frame_count=4, seed=2)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == len(synthetic.SUITE)
    for g, w in zip(got, want):
        assert read(g) == read(w)
    frames, params = videoio.read_y4m(got[0])
    assert len(frames) == 4
    assert (params["width"], params["height"]) == (W, H)
