"""The port's tools (``new_bloom_filter_repo_tpu_torch/tools/``) against
the root scripts that drive the JAX package.

Everything runs on the CPU (``device="cpu"`` / ``--device cpu``), with
the kernels' plain twins; the JAX package runs as its own tests run it.
Every comparison is exact.  The root scripts are imported only inside
the tests that use them as oracles.  No test touches the network.

Geometry: the bench clip's recipe at 288x352 over 3 frames (a base and
two inter frames): its 240-px box moves 23 and 11 px a frame and wraps
only at the fourth frame, so both inter frames are blocked records
(p = 0.166), as every frame of the 1080p bench batch is.
"""

import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu_torch.tools import bench as tb
from new_bloom_filter_repo_tpu_torch.tools import benchmark_compression as tbc
from new_bloom_filter_repo_tpu_torch.tools import benchmark_stages as tbs
from new_bloom_filter_repo_tpu_torch.tools import download_y4m_videos as tdl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_FRAMES = 288, 352, 3
CPU = ["--device", "cpu"]


def root_script(name: str, monkeypatch, tmp_path):
    """Import a root script as the JAX package's oracle; the scripts fill
    in JAX's compile-cache variables when imported, so those point into
    ``tmp_path`` first."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxc"))
    monkeypatch.syspath_prepend(REPO)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def clip():
    return tb.make_clip(N_FRAMES, H, W)


@pytest.mark.parametrize("n,h,w,seed", [(3, 288, 352, 0), (2, 270, 300, 1)])
def test_make_clip_equals_the_root_bench(monkeypatch, tmp_path, n, h, w,
                                         seed):
    bench = root_script("bench", monkeypatch, tmp_path)
    want = bench.make_clip(n, h, w, seed=seed)
    got = tb.make_clip(n, h, w, seed=seed)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_device_codec_fps_is_lossless_with_the_jax_checksum(clip):
    import jax.numpy as jnp
    from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
    from new_bloom_filter_repo_tpu.ops.pallas import blocked as jbk

    fps, lossless, dev_dispatch = tb._device_codec_fps(clip, device="cpu")
    assert lossless is True and fps > 0
    ok, checksum = tb._pull(dev_dispatch())
    assert ok is True
    # the JAX program's checksum: the wrapping uint32 sum of its decoded
    # values, which equal phase A's packed pixels
    tab = jbp.blocked_tables(H * W)
    _, _, vals = jbp._phase_a(jnp.asarray(np.stack(clip)),
                              npad=tab["nbk"] * jbk.IPB, nb=tab["nbk"])
    want = int(np.asarray(vals).astype(np.uint64).sum() % (1 << 32))
    assert checksum == want


def test_a_flipped_witness_bit_fails_the_check(clip, monkeypatch):
    """The on-device check is not vacuous: one witness bit flipped
    between K1 and K3 makes ``lossless`` false."""
    expand_chain = tb.bk.blocked_expand_chain

    def flipped(passes, wit, *args, **kw):
        wit = wit.clone()
        wit[0, 0, 0] ^= 0x80
        return expand_chain(passes, wit, *args, **kw)

    monkeypatch.setattr(tb.bk, "blocked_expand_chain", flipped)
    _, lossless, dev_dispatch = tb._device_codec_fps(clip, device="cpu")
    assert lossless is False
    assert tb._pull(dev_dispatch())[0] is False


def test_codec_params_refuse_frames_that_are_not_blocked():
    counts = np.zeros((2, 4), np.int32)
    counts[1] = 10
    with pytest.raises(RuntimeError, match="non-inter"):
        tb.codec_params(counts, 4096, 4)
    counts[0] = 1000          # p = 0.98: a keyframe
    with pytest.raises(RuntimeError, match="non-inter"):
        tb.codec_params(counts, 4096, 4)
    counts[0] = 1             # m below MIN_M: a sparse record
    with pytest.raises(RuntimeError, match="non-blocked"):
        tb.codec_params(counts, 4096, 4)


def test_measured_production_fps_writes_the_jax_container(clip):
    from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
    from new_bloom_filter_repo_tpu.utils import container as jcontainer

    _, _, dev_dispatch = tb._device_codec_fps(clip, device="cpu")
    combined, enc, dec, ok, blob = tb._measured_production_fps(
        clip, dev_dispatch, device="cpu", return_container=True)
    assert ok is True and min(combined, enc, dec) > 0
    payloads, _ = jbp.BlockedEncoder().encode_chunk_begin(clip[0],
                                                          clip[1:])()
    assert blob == jcontainer.serialize_bfvc(payloads)


def test_e2e_fps_gives_the_jax_ratio(clip, monkeypatch, tmp_path):
    bench = root_script("bench", monkeypatch, tmp_path)
    fps, t_enc, t_dec, ratio, savings, lossless = tb._e2e_fps(
        clip, device="cpu")
    assert lossless is True and fps > 0 and t_enc > 0 and t_dec > 0
    _, _, _, want_ratio, want_savings, want_lossless = bench._e2e_fps(clip)
    assert (ratio, savings, lossless) == (want_ratio, want_savings,
                                          want_lossless)


def test_bench_json_schema(monkeypatch, capsys):
    """The JSON line's keys (tests/test_cli_and_tools.py's bench contract
    with ``transfer_bound_e2e_fps`` renamed ``e2e_fps``), with every
    heavy stage stubbed."""
    monkeypatch.setattr(tb, "make_clip", lambda *a, **k: [None] * 3)
    monkeypatch.setattr(tb, "_device_codec_fps",
                        lambda frames, device=None: (500.0, True, None))
    monkeypatch.setattr(
        tb, "_e2e_fps",
        lambda frames, device=None: (1.0, 1.0, 1.0, 0.25, 0.75, True))
    monkeypatch.setattr(
        tb, "_host_stage_seconds",
        lambda frames, device=None: (0.010, 0.004, {"enc_deflate": 7.0}))
    monkeypatch.setattr(
        tb, "_measured_production_fps",
        lambda frames, dev_dispatch=None, device=None: (71.4, 100.0, 250.0,
                                                        True))
    ret = tb.main(CPU)
    out = json.loads(capsys.readouterr().out)
    assert out == ret
    for key in ("metric", "value", "unit", "vs_baseline", "platform",
                "device_name", "power_limit_w", "lossless",
                "compression_ratio", "e2e_fps", "host_stage_fps",
                "production_pipeline_fps", "production_encode_fps",
                "production_decode_fps", "production_measured",
                "host_stage_ms_per_frame"):
        assert key in out, key
    assert "transfer_bound_e2e_fps" not in out and "tpu_fallback" not in out
    assert out["platform"] == "cpu" and out["power_limit_w"] is None
    assert "value_4k" in out, out.keys()
    if out["value_4k"] is not None:
        for key in ("lossless_4k", "production_pipeline_fps_4k",
                    "production_encode_fps_4k", "production_decode_fps_4k",
                    "production_measured_4k"):
            assert key in out, key
    else:
        assert "note_4k" in out
    assert out["value"] == 500.0 and out["lossless"] is True
    assert out["production_pipeline_fps"] == 71.4
    assert out["production_encode_fps"] == 100.0
    assert out["production_measured"] is True


def test_bench_4k_failure_is_recorded(monkeypatch, capsys):
    """A 4K stage that raises leaves ``value_4k`` None and its note."""
    def codec(frames, device=None):
        if frames[0] == "4k":
            raise RuntimeError("stub")
        return 500.0, True, None

    monkeypatch.setattr(tb, "make_clip", lambda n_frames=3, h=0, w=0,
                        seed=0: ["4k" if h == 2160 else "hd"] * 3)
    monkeypatch.setattr(tb, "_device_codec_fps", codec)
    monkeypatch.setattr(
        tb, "_e2e_fps",
        lambda frames, device=None: (1.0, 1.0, 1.0, 0.25, 0.75, True))
    monkeypatch.setattr(tb, "_host_stage_seconds",
                        lambda frames, device=None: (0.01, 0.01, {}))
    monkeypatch.setattr(
        tb, "_measured_production_fps",
        lambda frames, dev_dispatch=None, device=None: (1.0, 1.0, 1.0, True))
    out = tb.main(CPU)
    capsys.readouterr()
    assert out["value_4k"] is None
    assert out["note_4k"] == "4k bench failed: RuntimeError: stub"


def test_benchmark_stages_prints_the_jax_parameters(clip, capsys):
    import jax.numpy as jnp
    from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
    from new_bloom_filter_repo_tpu.models.binary_codec import (
        _filter_scalars)
    from new_bloom_filter_repo_tpu.models.bloom import (
        optimal_compression_params)
    from new_bloom_filter_repo_tpu.ops.pallas import blocked as jbk

    assert tbs.main(["--frames", str(N_FRAMES - 1), "--width", str(W),
                     "--height", str(H), "--reps", "1"] + CPU) == 0
    lines = capsys.readouterr().out.splitlines()
    params = dict(kv.split("=") for kv in lines[0].split())
    assert [ln.split()[0] for ln in lines[1:]] == [
        "phase_a", "encode_h", "membership_h", "expand+chain"]
    # the root script's parameter math on the JAX package's counts
    n = H * W
    tab = jbp.blocked_tables(n)
    _, counts, _ = jbp._phase_a(jnp.asarray(np.stack(clip)),
                                npad=tab["nbk"] * jbk.IPB, nb=tab["nbk"])
    counts = np.asarray(counts)
    want = {"m": [], "fk": [], "thi": [], "tlo": []}
    for j in range(N_FRAMES - 1):
        k, l = optimal_compression_params(n, int(counts[j].sum()) / n)
        want["m"].append(min(int(round(l / tab["nb"])) if l else 0,
                             jbk.MMAX))
        _, fk, (thi, tlo) = _filter_scalars(k)
        want["fk"].append(fk)
        want["thi"].append(int(thi))
        want["tlo"].append(int(tlo))
    m, thi, tlo, fk, _ = tb.codec_params(counts, n, tab["nb"])
    assert (m.tolist(), fk.tolist(), thi.tolist(), tlo.tolist()) == (
        want["m"], want["fk"], want["thi"], want["tlo"])
    assert params == {
        "f": str(N_FRAMES - 1), "nb": str(tab["nb"]),
        "vh": str(jbp._vh_bucket(max(1, int(counts.max())))),
        "k_lanes": str(max(want["fk"])),
        "nw": str((max(want["m"]) + 31) // 32),
        "mean_m": f"{np.mean(want['m']):.0f}"}


SUITE_CLASSES = ("synthetic_pan.y4m", "synthetic_static_gentle.y4m")


def test_benchmark_compression_matches_the_jax_ratios(monkeypatch, tmp_path,
                                                     capsys):
    """The synthetic suite at 4 CIF frames a clip through the port's
    harness: every bloom path lossless, each of two classes' ratios
    equal to the root script's ``bench_bloom`` / ``bench_bloom_planar``
    on the same file, the ffmpeg codecs skipped without ffmpeg."""
    jbc = root_script("benchmark_compression", monkeypatch, tmp_path)
    vdir = str(tmp_path / "clips")
    res_path = str(tmp_path / "results.json")
    rc = tbc.main(["--synthetic", "--synthetic-frames", "4", "--video-dir",
                   vdir, "--results", res_path, "--codecs", "bloom",
                   "bloom-planar", "keyframe", "ffv1"] + CPU)
    printed = capsys.readouterr().out
    assert rc == 0
    with open(res_path) as fh:
        results = json.load(fh)
    assert len(results) == 8
    for name, rows in results.items():
        for codec in ("bloom", "bloom-planar", "keyframe"):
            assert rows[codec]["lossless"] is True, (name, codec)
            assert set(rows[codec]) == {"ratio", "encode_s", "decode_s",
                                        "frames", "lossless"}
            assert rows[codec]["frames"] == 4
        assert ("ffv1" in rows) == (shutil.which("ffmpeg") is not None)
    if shutil.which("ffmpeg") is None:
        assert "  ffv1: ffmpeg unavailable/failed, skipped" in printed
    assert "=== Averages (Y4M set) ===" in printed
    for name in SUITE_CLASSES:
        path = os.path.join(vdir, name)
        want = {"bloom": jbc.bench_bloom(path, 1000, "bloom", threads=4),
                "keyframe": jbc.bench_bloom(path, 1000, "keyframe",
                                            threads=4),
                "bloom-planar": jbc.bench_bloom_planar(path, 1000,
                                                       threads=4)}
        for codec, row in want.items():
            assert row["lossless"] is True
            assert results[name][codec]["ratio"] == row["ratio"], (name,
                                                                   codec)


def test_download_offline_writes_the_root_scripts_files(monkeypatch,
                                                        tmp_path):
    dl = root_script("download_y4m_videos", monkeypatch, tmp_path)
    argv = ["--synthetic", "--max-files", "2", "--frames", "3"]
    assert tdl.main(argv + ["--output-dir", str(tmp_path / "port")]) == 0
    assert dl.main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    for name in tdl.CLIPS[:2]:
        with open(tmp_path / "port" / f"{name}.y4m", "rb") as fh:
            got = fh.read()
        with open(tmp_path / "jax" / f"{name}.y4m", "rb") as fh:
            assert got == fh.read(), name
    with open(tmp_path / "port" / "download_attempts.json") as fh:
        assert {a["status"] for a in json.load(fh).values()} == {"synthetic"}
    assert (tdl.CLIPS, tdl.BASE_URL, tdl.DEFAULT_DIR) == (
        dl.CLIPS, dl.BASE_URL, dl.DEFAULT_DIR)


@pytest.mark.parametrize("entry", [
    lambda d: tb.main([]),
    lambda d: tbs.main(["--frames", "2"]),
    lambda d: tbc.main(["--video-dir", d]),
    lambda d: tb._device_codec_fps(tb.make_clip(2, 270, 270)),
    lambda d: tb._measured_production_fps(tb.make_clip(2, 270, 270)),
    lambda d: tb._e2e_fps(tb.make_clip(2, 270, 270)),
], ids=["bench", "benchmark_stages", "benchmark_compression",
        "device_codec_fps", "measured_production_fps", "e2e_fps"])
def test_entry_points_without_a_device_raise(monkeypatch, tmp_path, entry):
    """No card and no --device: RuntimeError, never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry(str(tmp_path))


def test_tools_run_as_modules_without_jax():
    """``python -m`` of each tool loads no JAX and no root script."""
    import subprocess

    code = (
        "import sys, runpy\n"
        "sys.argv = ['x', '--help']\n"
        "for m in ('bench', 'benchmark_stages', 'benchmark_compression',\n"
        "          'download_y4m_videos'):\n"
        "    try:\n"
        "        runpy.run_module('new_bloom_filter_repo_tpu_torch.tools.'\n"
        "                         + m, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), (m, e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'new_bloom_filter_repo_tpu',\n"
        "              'bench', 'benchmark_stages', 'benchmark_compression',\n"
        "              'download_y4m_videos'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
