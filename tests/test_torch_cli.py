"""The PyTorch port's CLI, verify harness, experiments and profiling
against the JAX package's.

Files go through both command lines with the same flags (the port's with
``--device cpu``): the ``.bfvc`` files are byte-identical, ``compress``
then ``decompress`` reproduces a Y4M and a raw YUV input byte for byte,
EXR frames round-trip with their bit patterns, and both print the same
text.  Every comparison is exact except the experiments' float math
(rtol 1e-12).  Geometry 64x48, 6-8 frames.
"""

import json
import os

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu import cli as jcli
from new_bloom_filter_repo_tpu import experiments as jexperiments
from new_bloom_filter_repo_tpu import verify_harness as jvh
from new_bloom_filter_repo_tpu.models.video import (
    ImprovedVideoCompressor as JaxCompressor,
)
from new_bloom_filter_repo_tpu_torch import cli, experiments
from new_bloom_filter_repo_tpu_torch import verify_harness as vh
from new_bloom_filter_repo_tpu_torch.models import video as video_mod
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.utils import exr, profiling, videoio
from new_bloom_filter_repo_tpu_torch.utils.synthetic import generate_frames
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import yuv_info_of

W, H = 64, 48
CPU = ["--device", "cpu"]


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


def make_y4m(path, n=6, colorspace="420jpeg"):
    """Static textured scene + a moving block, as native planes."""
    rng = np.random.default_rng(0)
    cw, ch = {"420jpeg": (W // 2, H // 2), "422": (W // 2, H),
              "444": (W, H)}[colorspace]
    y0 = rng.integers(16, 235, (H, W), dtype=np.uint8)
    u0 = rng.integers(16, 240, (ch, cw), dtype=np.uint8)
    v0 = rng.integers(16, 240, (ch, cw), dtype=np.uint8)
    planes = []
    for i in range(n):
        y = y0.copy()
        y[10:20, 4 + 4 * i:14 + 4 * i] = 200
        u = u0.copy()
        u[2:5, i:i + 3] = 77
        planes.append((y, u, v0.copy()))
    videoio.write_y4m(path, planes, W, H, colorspace)


def make_raw_yuv(path, fmt, n=6):
    rng = np.random.default_rng(1)
    y0 = rng.integers(0, 256, (H, W), dtype=np.uint8)
    c0 = rng.integers(0, 256, (2, H // 2, W // 2), dtype=np.uint8)
    with open(path, "wb") as fh:
        for i in range(n):
            y = y0.copy()
            y[6:14, 3 * i:3 * i + 8] = 240
            c = c0.copy()
            c[0, 4:8, i:i + 4] = 9          # the first chroma plane stored
            fh.write(y.tobytes() + c.tobytes())
    assert fmt in ("I420", "YV12")


def both_cli(capsys, tmp_path, make_args):
    """Run the JAX CLI and the port's (``--device cpu``) on the argv that
    ``make_args(dir)`` builds for each one's own directory; both must
    return 0 and print the same text but for the directory.  Returns the
    two directories."""
    dirs = {}
    out = {}
    for name, main, extra in (("j", jcli.main, []), ("t", cli.main, CPU)):
        dirs[name] = tmp_path / name
        dirs[name].mkdir(exist_ok=True)
        capsys.readouterr()
        assert main(make_args(str(dirs[name])) + extra) == 0
        out[name] = capsys.readouterr().out.replace(str(dirs[name]), "<dir>")
    assert out["t"] == out["j"]
    assert out["t"].strip()
    return str(dirs["j"]), str(dirs["t"])


# ---------------------------------------------------------------------------
# files through compress / process-yuv / decompress
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", [None, "planar"])
def test_y4m_compress_decompress_reproduces_the_file(tmp_path, capsys,
                                                     profile):
    src = str(tmp_path / "in.y4m")
    make_y4m(src)
    flags = ["--keyframe-interval", "4"]
    if profile:
        flags += ["--profile", profile]
    jdir, tdir = both_cli(
        capsys, tmp_path,
        lambda d: ["compress", src, os.path.join(d, "out.bfvc")] + flags)
    bfvc = os.path.join(tdir, "out.bfvc")
    assert read(bfvc) == read(os.path.join(jdir, "out.bfvc"))
    back = str(tmp_path / "back.y4m")
    assert cli.main(["decompress", bfvc, back] + CPU) == 0
    out = capsys.readouterr().out
    assert "Decompressed 6 frames" in out and back in out
    assert read(back) == read(src)


def test_y4m_422_round_trip_and_the_reference_decodes_the_ports_file(
        tmp_path, capsys):
    src = str(tmp_path / "in.y4m")
    make_y4m(src, colorspace="422")
    bfvc = str(tmp_path / "out.bfvc")
    assert cli.main(["compress", src, bfvc, "--profile", "planar"] + CPU) == 0
    for main, extra, name in ((cli.main, CPU, "t.y4m"),
                              (jcli.main, [], "j.y4m")):
        back = str(tmp_path / name)
        assert main(["decompress", bfvc, back] + extra) == 0
        assert read(back) == read(src)
    assert "Output saved to" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["I420", "YV12"])
def test_process_yuv_then_decompress_reproduces_the_file(tmp_path, capsys,
                                                         fmt):
    src = str(tmp_path / "in.yuv")
    make_raw_yuv(src, fmt)
    jdir, tdir = both_cli(
        capsys, tmp_path,
        lambda d: ["process-yuv", src, os.path.join(d, "out.bfvc"),
                   "--width", str(W), "--height", str(H), "--format", fmt,
                   "--keyframe-interval", "3"])
    bfvc = os.path.join(tdir, "out.bfvc")
    assert read(bfvc) == read(os.path.join(jdir, "out.bfvc"))
    back = str(tmp_path / "back.yuv")
    assert cli.main(["decompress", bfvc, back] + CPU) == 0
    assert read(back) == read(src)
    # the planes come back in canonical order whatever the file's layout
    info = yuv_info_of(ImprovedVideoCompressor(device="cpu")
                       .decompress_video(bfvc)[0])
    assert info["format"] == fmt
    first_chroma = np.frombuffer(read(src), np.uint8,
                                 (W // 2) * (H // 2), W * H)
    plane = info["v_plane" if fmt == "YV12" else "u_plane"]
    assert plane.tobytes() == first_chroma.tobytes()


def test_process_yuv_frame_step_and_max_frames(tmp_path, capsys):
    src = str(tmp_path / "in.yuv")
    make_raw_yuv(src, "I420", n=7)
    bfvc = str(tmp_path / "out.bfvc")
    assert cli.main(["process-yuv", src, bfvc, "--width", str(W),
                     "--height", str(H), "--frame-step", "2",
                     "--max-frames", "3"] + CPU) == 0
    assert "Processed 3 frames" in capsys.readouterr().out
    back = str(tmp_path / "back.yuv")
    assert cli.main(["decompress", bfvc, back] + CPU) == 0
    size = W * H * 3 // 2
    data = read(src)
    assert read(back) == b"".join(data[i * size:(i + 1) * size]
                                  for i in (0, 2, 4))


def hdr_frames(n=4, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 10.0).astype(np.float32)
    frames = []
    for i in range(n):
        f = base.copy()
        f[5:12, 4 + 3 * i:10 + 3 * i] = 123.456
        frames.append(f)
    frames[1].view(np.uint32)[0, 0, 0] = 0x7FC00055     # a NaN payload
    frames[1][0, 1, 1] = np.inf
    frames[1][0, 2, 2] = -0.0
    return frames


@pytest.mark.parametrize("compression", ["zip", "piz"])
def test_exr_directory_round_trip(tmp_path, compression):
    frames = hdr_frames()
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        exr.write_exr(str(seq / f"frame{i:03d}.exr"), f,
                      compression=compression)
    (seq / "notes.txt").write_text("not a frame")
    comp = ImprovedVideoCompressor(device="cpu", keyframe_interval=2)
    jcomp = JaxCompressor(verbose=False, keyframe_interval=2)
    loaded = comp.extract_frames_from_video(str(seq))
    want = jcomp.extract_frames_from_video(str(seq))
    assert len(loaded) == len(want) == 4
    for a, b, c in zip(loaded, want, frames):
        assert a.dtype == np.float32
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert len(comp.extract_frames_from_video(str(seq), max_frames=2)) == 2
    one = comp.extract_frames_from_video(str(seq / "frame001.exr"))
    assert len(one) == 1 and one[0].tobytes() == frames[1].tobytes()
    tpath, jpath = str(tmp_path / "t.bfvc"), str(tmp_path / "j.bfvc")
    comp.compress_video(loaded, tpath)
    jcomp.compress_video(want, jpath)
    assert read(tpath) == read(jpath)
    rec = comp.decompress_video(jpath)
    assert comp.verify_lossless(loaded, rec)["lossless"]
    for a, b in zip(rec, frames):
        assert np.asarray(a).dtype == np.float32
        assert np.asarray(a).tobytes() == b.tobytes()


def bgr_stream(tmp_path):
    frames = generate_frames(4, W, H, noise=1.0, seed=2)
    path = str(tmp_path / "bgr.bfvc")
    ImprovedVideoCompressor(device="cpu").compress_video(frames, path)
    return path, frames


def test_y4m_export_of_a_bgr_stream_raises(tmp_path):
    path, _ = bgr_stream(tmp_path)
    with pytest.raises(ValueError, match="y4m export requires YUV frames"):
        cli.main(["decompress", path, str(tmp_path / "x.y4m")] + CPU)
    with pytest.raises(ValueError, match="carries no yuv_info planes"):
        cli.main(["decompress", path, str(tmp_path / "x.yuv")] + CPU)
    with pytest.raises(FileNotFoundError):
        cli.main(["decompress", str(tmp_path / "none.bfvc"),
                  str(tmp_path / "x.y4m")] + CPU)


def test_decompress_to_mp4_needs_cv2(tmp_path, capsys, monkeypatch):
    pytest.importorskip("cv2")
    path, frames = bgr_stream(tmp_path)
    out = str(tmp_path / "preview" / "out.mp4")
    assert cli.main(["decompress", path, out, "--verbose"] + CPU) == 0
    assert os.path.getsize(out) > 0
    printed = capsys.readouterr().out
    assert "Frames Per Second:" in printed
    assert "Decompressed 4 frames in" in printed
    # the preview holds as many frames of the same size
    back = videoio.open_video_frames(out)
    assert len(back) == 4 and back[0].shape == frames[0].shape
    monkeypatch.setattr(videoio, "_cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV is not installed"):
        cli.main(["decompress", path, str(tmp_path / "o2.mp4")] + CPU)


def test_mp4_preview_of_yuv_and_gray_streams(tmp_path):
    pytest.importorskip("cv2")
    comp = ImprovedVideoCompressor(device="cpu")
    yuv = generate_frames(3, W, H, seed=4, color_space="YUV")
    out = comp.save_frames_as_video(
        [comp.add_yuv_info_to_frame(f) for f in yuv],
        str(tmp_path / "yuv.mp4"))
    assert os.path.getsize(out) > 0
    gray = generate_frames(3, W, H, seed=4, color_space="GRAY")
    assert os.path.getsize(comp.save_frames_as_video(
        gray, str(tmp_path / "gray.mp4"))) > 0
    with pytest.raises(ValueError, match="No frames provided"):
        comp.save_frames_as_video([], str(tmp_path / "none.mp4"))


@pytest.mark.parametrize("color_space", ["BGR", "RGB", "YUV"])
def test_extract_frames_converts_colour_as_the_reference(tmp_path,
                                                         color_space):
    """A Y4M read as BGR/RGB and an mp4 read as YUV go through the
    colour ops: integer arithmetic, the same bytes as the JAX ops."""
    pytest.importorskip("cv2")
    src = str(tmp_path / "in.y4m")
    make_y4m(src, n=3)
    comp = ImprovedVideoCompressor(device="cpu")
    jcomp = JaxCompressor(verbose=False)
    got = comp.extract_frames_from_video(src, output_color_space=color_space)
    want = jcomp.extract_frames_from_video(src,
                                           output_color_space=color_space)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        assert (yuv_info_of(g) is None) == (color_space != "YUV")
    mp4 = videoio.write_video_frames(
        generate_frames(3, W, H, seed=5), str(tmp_path / "clip.mp4"))
    got = comp.extract_frames_from_video(mp4, output_color_space=color_space)
    want = jcomp.extract_frames_from_video(mp4,
                                           output_color_space=color_space)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_default_color_space_and_raw_yuv_needs_dimensions(tmp_path):
    assert video_mod.default_color_space("a/b/CLIP.Y4M") == "YUV"
    assert video_mod.default_color_space("clip.yuv") == "YUV"
    assert video_mod.default_color_space("clip.mp4") == "BGR"
    comp = ImprovedVideoCompressor(device="cpu")
    with pytest.raises(ValueError, match="requires width and height"):
        comp.extract_frames_from_video(str(tmp_path / "x.yuv"))
    with pytest.raises(ValueError, match="Video file not found"):
        comp.extract_frames_from_video(str(tmp_path / "x.mp4"))


# ---------------------------------------------------------------------------
# the other subcommands
# ---------------------------------------------------------------------------

def test_synthetic_subcommand_prints_what_the_reference_prints(tmp_path,
                                                               capsys):
    jdir, tdir = both_cli(
        capsys, tmp_path,
        lambda d: ["synthetic", d, "--frames", "6", "--width", str(W),
                   "--height", str(H), "--keyframe-interval", "4"])
    name = "synthetic_compressed.bfvc"
    assert read(os.path.join(tdir, name)) == read(os.path.join(jdir, name))


def test_analyze_subcommand_prints_what_the_reference_prints(tmp_path,
                                                             capsys):
    both_cli(capsys, tmp_path,
             lambda d: ["analyze", d, "--frames", "4", "--width", str(W),
                        "--height", str(H), "--noise-levels", "0.0", "2.0"])
    assert cli.main(["analyze", str(tmp_path / "t"), "--frames", "4",
                     "--width", str(W), "--height", str(H),
                     "--noise-levels", "1.0"] + CPU) == 0
    out = capsys.readouterr().out
    assert "Noise Analysis Summary" in out
    assert "Tested 1 noise levels" in out


@pytest.mark.parametrize("kind", ["bgr", "planar"])
def test_analyze_stream_equals_the_reference(tmp_path, capsys, kind):
    if kind == "bgr":
        path, _ = bgr_stream(tmp_path)
    else:
        src = str(tmp_path / "in.yuv")
        make_raw_yuv(src, "I420")
        path = str(tmp_path / "planar.bfvc")
        assert cli.main(["process-yuv", src, path, "--width", str(W),
                         "--height", str(H)] + CPU) == 0
    capsys.readouterr()
    text = {}
    for name, main in (("j", jcli.main), ("t", cli.main)):
        assert main(["analyze-stream", path]) == 0
        text[name] = capsys.readouterr().out
        assert main(["analyze-stream", path, "--json"]) == 0
        text[name + "json"] = json.loads(capsys.readouterr().out)
    assert text["t"] == text["j"] and "record type" in text["t"]
    info = text["tjson"]
    assert info == text["jjson"]
    assert info["path"] == path and info["magic"] == "BFV2"
    assert info["total_bytes"] > 0
    n_records = 4 if kind == "bgr" else 18
    assert sum(r["count"] for r in info["records"].values()) == n_records
    assert abs(sum(r["share"] for r in info["records"].values()) - 1) < 0.01


def test_no_action_prints_help_naming_the_port(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert "new_bloom_filter_repo_tpu_torch" in out
    for word in ("compress", "decompress", "process-yuv", "synthetic",
                 "analyze-stream", "analyze"):
        assert word in out


COMMANDS = {
    "compress": lambda d: ["compress", os.path.join(d, "in.y4m"),
                           os.path.join(d, "o.bfvc")],
    "decompress": lambda d: ["decompress", os.path.join(d, "in.bfvc"),
                             os.path.join(d, "o.y4m")],
    "process-yuv": lambda d: ["process-yuv", os.path.join(d, "in.yuv"),
                              os.path.join(d, "o.bfvc"), "--width", str(W),
                              "--height", str(H)],
    "synthetic": lambda d: ["synthetic", d, "--frames", "2"],
    "analyze": lambda d: ["analyze", d, "--frames", "2"],
}


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_cli_without_a_card_and_without_device_raises(tmp_path, monkeypatch,
                                                      command):
    """No ``--device`` means the card; without one the command fails, it
    does not carry on on the CPU."""
    make_y4m(str(tmp_path / "in.y4m"), n=2)
    make_raw_yuv(str(tmp_path / "in.yuv"), "I420", n=2)
    ImprovedVideoCompressor(device="cpu").compress_video(
        generate_frames(2, W, H), str(tmp_path / "in.bfvc"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        cli.main(COMMANDS[command](str(tmp_path)))
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        vh.main([str(tmp_path / "in.y4m"), "--color-spaces", "YUV"])
    assert not os.path.exists(tmp_path / "o.bfvc")


def test_device_flag_reaches_the_compressor(monkeypatch):
    seen = []
    real = cli.ImprovedVideoCompressor

    def spy(**kw):
        seen.append(kw.get("device"))
        return real(**kw)

    monkeypatch.setattr(cli, "ImprovedVideoCompressor", spy)
    with pytest.raises(FileNotFoundError):
        cli.main(["decompress", "/nonexistent.bfvc", "/nonexistent.y4m",
                  "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cli.main(["decompress", "/nonexistent.bfvc", "/nonexistent.y4m"])
    assert seen == ["cpu", None]
    assert cli._parse_devices("4x2") == (4, 2)
    assert cli._parse_devices("auto") == "auto"
    assert cli._parse_devices("2") == 2 and cli._parse_devices(None) is None


# ---------------------------------------------------------------------------
# verify harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["blocked", "planar"])
def test_harness_true_lossless_on_a_y4m(tmp_path, profile):
    src = str(tmp_path / "v.y4m")
    make_y4m(src)
    res = vh.test_true_lossless(src, color_spaces=("YUV",), max_frames=4,
                                verbose=False, profile=profile, device="cpu")
    assert res["all_passed"], res
    got = res["YUV"]
    assert got["passed"] and got["yuv_byte_exact"]
    assert got["profile"] == profile
    assert got["bit_exact"]["frames_compared"] == 4
    want = jvh.test_true_lossless(src, color_spaces=("YUV",), max_frames=4,
                                  verbose=False, profile=profile)["YUV"]
    assert got["compression_ratio"] == want["compression_ratio"] < 1.0
    assert got["bit_exact"] == want["bit_exact"]


def test_harness_main_and_colour_spaces(tmp_path, capsys):
    src = str(tmp_path / "v.y4m")
    make_y4m(src, n=4)
    assert vh.main([src, "--color-spaces", "BGR", "RGB", "YUV",
                    "--max-frames", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for cs in ("BGR", "RGB", "YUV"):
        assert f"[{cs}] PASS" in out
    assert "TRUE LOSSLESS VERIFIED" in out
    # a file that cannot be read is reported for its colour space
    res = vh.test_true_lossless(str(tmp_path / "missing.y4m"), ("YUV",),
                                verbose=False, device="cpu")
    assert not res["all_passed"] and "reason" in res["YUV"]
    assert vh.main([str(tmp_path / "missing.y4m"), "--device", "cpu"]) == 1


def test_harness_bit_exact_comparator_equals_the_reference():
    frames = generate_frames(3, 32, 24, noise=0)
    bad = [f.copy() for f in frames]
    bad[1][3, 4, 0] ^= 5
    got = vh.verify_bit_exact(frames, bad)
    assert got == jvh.verify_bit_exact(frames, bad)
    assert not got["bit_exact"] and got["mismatched_frames"] == [1]
    ex = got["examples"][0]
    assert ex["frame"] == 1 and tuple(ex["pixel"])[:2] == (3, 4)
    same = vh.verify_bit_exact(frames, [f.copy() for f in frames])
    assert same["bit_exact"] and same["frames_compared"] == 3
    short = vh.verify_bit_exact(frames, frames[:2])
    assert not short["bit_exact"] and "frame count" in short["reason"]
    other = vh.verify_bit_exact(frames[:1], [frames[0].astype(np.uint16)])
    assert other["examples"][0]["kind"] == "shape/dtype"


def test_harness_channel_forensics_equal_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    orig = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    bad = orig.copy()
    bad[2, 3, 1] += 10
    bad[5, 5, 1] += 3
    bad[7, 1, 2] += 7
    got = vh.analyze_channel_differences(orig, bad)
    assert got == jvh.analyze_channel_differences(orig, bad)
    assert got["B"]["pixels_different"] == 0
    assert got["G"]["pixels_different"] == 2
    assert got["R"] == {"pixels_different": 1, "mean_abs_diff": 7.0,
                        "max_abs_diff": 7}
    assert vh.verify_bit_exact([orig], [bad])["diff_stats"][0][
        "channels"] == got
    yuv = video_mod.add_yuv_info_to_frame(orig)
    assert sorted(vh.analyze_channel_differences(yuv, bad)) == ["U", "V", "Y"]
    assert list(vh.analyze_channel_differences(orig[..., 0],
                                               bad[..., 0])) == ["ch0"]
    pytest.importorskip("PIL")
    paths = vh._dump_diagnostics(orig, bad, 0, str(tmp_path / "diag"))
    assert len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths)


# ---------------------------------------------------------------------------
# experiments
# ---------------------------------------------------------------------------

def assert_close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_experiments_compare_filters_equals_the_reference():
    kw = {"n": 200, "m": 2048, "probes": 1500, "seed": 42}
    got = experiments.compare_filters(**kw)
    assert_close(got, jexperiments.compare_filters(**kw))
    assert got["rational"]["k"] == got["k_star"]
    assert 0 <= got["rational"]["empirical_fpr"] < 0.1


@pytest.mark.parametrize("m,n,k", [(8192, 1000, 5.678), (4096, 500, 0.25),
                                   (1024, 100, 7.0), (100, 90, 0.77)])
def test_experiments_theoretical_fpr_equals_the_reference(m, n, k):
    assert_close(experiments.theoretical_fpr_rational(m, n, k),
                 jexperiments.theoretical_fpr_rational(m, n, k))
    assert_close(experiments.theoretical_fpr(m, n, k),
                 jexperiments.theoretical_fpr(m, n, k))
    if k == int(k):
        assert_close(experiments.theoretical_fpr_rational(m, n, k),
                     experiments.theoretical_fpr(m, n, k))


def test_experiments_sweeps_equal_the_reference():
    kw = {"n": 100, "m": 1024, "probes": 600, "steps": 4, "seed": 7}
    assert_close(experiments.run_experiment_varying_k(**kw),
                 jexperiments.run_experiment_varying_k(**kw))
    kw = {"mn_ratios": [4, 10], "seed": 3, "n": 80, "probes": 500}
    got = experiments.run_theoretical_comparison(**kw)
    assert_close(got, jexperiments.run_theoretical_comparison(**kw))
    assert [r["m_over_n"] for r in got["rows"]] == [4, 10]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_timer_spans_and_stats():
    timer = profiling.Timer()
    for _ in range(2):
        with timer.span("encode"):
            pass
    with pytest.raises(KeyError):
        with timer.span("decode"):
            raise KeyError("still timed")
    assert set(timer.spans) == {"encode", "decode"}
    timer.spans["encode"] = 0.5
    stats = timer.stats(frames=10)
    assert stats["encode_time"] == 0.5 and stats["encode_fps"] == 20.0
    assert "decode_time" in stats
    assert "encode_fps" not in timer.stats()


def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("NBF_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, how):
    out = tmp_path / "traces"
    if how == "environment":
        monkeypatch.setenv("NBF_TRACE_DIR", str(out))
    else:
        monkeypatch.delenv("NBF_TRACE_DIR", raising=False)
    with profiling.trace(str(out) if how == "argument" else None):
        torch.ones(64).mul(2).sum()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mul" in str(ev.get("name", "")) for ev in events)


def test_measure_host_stages_reports_every_stage_key():
    frames = generate_frames(16, W, H, noise=1.0, seed=6)
    enc_s, dec_s, detail = profiling.measure_host_stages(frames, reps=1,
                                                         device="cpu")
    for key in profiling.ENC_HOST_KEYS + profiling.DEC_HOST_KEYS:
        assert key in detail, key
    for key in ("enc_device_phase_a", "enc_device_kernel", "enc_pull",
                "dec_device_membership", "dec_expand_pull"):
        assert key in detail, key
    assert enc_s > 0 and dec_s > 0
    np.testing.assert_allclose(
        enc_s * 1e3, sum(detail[k] for k in profiling.ENC_HOST_KEYS),
        atol=0.01)
    from new_bloom_filter_repo_tpu.utils import profiling as jprofiling
    assert profiling.ENC_HOST_KEYS == jprofiling.ENC_HOST_KEYS
    assert profiling.DEC_HOST_KEYS == jprofiling.DEC_HOST_KEYS
