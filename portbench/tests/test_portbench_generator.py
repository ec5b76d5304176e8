"""The frozen generator gives the port's bytes, and nothing the run
command imports is JAX or the JAX package.

This is the only file of the benchmark that imports the port's own
generator (``utils/synthetic``).
"""

import ast
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import generator, run

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def suite():
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import SUITE
    return SUITE


@pytest.mark.parametrize("seed", [0, 2**33 + 7])
@pytest.mark.parametrize("cls", ["static_gentle", "pan", "static_noisy",
                                 "zoom", "scene_cuts", "noise_storm",
                                 "film_grain", "pan_subpixel"])
def test_frozen_generator_gives_the_ports_bytes(cls, seed):
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
        generate_frames)
    kw = suite()[cls]
    for color_space in ("BGR", "GRAY"):
        want = generate_frames(14, 67, 41, seed=seed,
                               color_space=color_space, **kw)
        got = generator.generate_frames(14, 67, 41, seed=seed,
                                        color_space=color_space, **kw)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_traffic_files_are_generator_arguments():
    accepted = set(inspect.signature(generator.generate_frames).parameters)
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as fh:
            traffic = json.load(fh)
        allowed = accepted - {"frame_count", "width", "height",
                              "color_space", "seed"}
        assert set(traffic["params"]) <= allowed, name
        assert set(traffic.get("warm", {})) <= allowed, name


def traffic_names():
    return sorted(f[:-len(".json")] for f in
                  os.listdir(os.path.join(BENCH, "traffic")))


@pytest.mark.parametrize("name", traffic_names())
def test_every_mix_and_its_warm_frames_are_the_ports_bytes(name):
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
        generate_frames)
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        traffic = json.load(fh)
    config = {"width": 67, "height": 41, "color_space": "BGR"}
    traffic = dict(traffic, frames=20)
    clip = run.make_clip(config, traffic, 2**33 + 5)
    for params, got in ((traffic["params"], clip.frames),
                        ({**traffic["params"], **traffic.get("warm", {})},
                         run.warm_clip(config, traffic, 2**33 + 5, clip))):
        want = generate_frames(len(got), 67, 41, seed=2**33 + 5, **params)
        assert len(got) == run.WARM_FRAMES or got is clip.frames
        for a, b in zip(want, got):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["static", "pan"])
def test_the_mixes_are_the_ports_suite_classes(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        traffic = json.load(fh)
    assert traffic["params"] == suite()[traffic["class"]]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_sources():
    out = []
    for d in (BENCH, os.path.join(BENCH, "metrics")):
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".py")]
    return out


def test_no_source_of_the_harness_imports_jax():
    for path in harness_sources():
        assert not top_level_imports(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(BENCH, "reference.py")
    assert top_level_imports(path) <= {"__future__", "hashlib", "struct",
                                       "typing", "numpy"}
    code = ("import json, sys; import portbench.reference; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"torch", "new_bloom_filter_repo_tpu_torch",
                         *run.FORBIDDEN}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("new_bloom_filter_repo_tpu_torch.models", "jaxtyping",
                 "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "new_bloom_filter_repo_tpu.models", sys)
    assert run.forbidden_modules() == ["jax", "new_bloom_filter_repo_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module a run imports, from the command's own entry down to
    the port's kernels' wrappers, in a process of its own: a small run
    on the CPU with the metric readers loaded, and one of the I420
    layout."""
    code = """
import json, sys
sys.argv = ["portbench/run.py"]
sys.path.insert(0, ".")
from portbench import run
spec = run.load_spec()
cell, config, traffic = run.resolve(spec, "bgr1080-gop250-pan")
run.metrics_for(spec, cell["name"], False)
run.metrics_for(spec, cell["name"], True)
config = dict(config, width=64, height=48)
traffic = dict(traffic, frames=6)
out = run.run_cell(config, traffic, 5, 0, trace=True, device="cpu",
                   log=lambda m: None)
assert out["failed"] == 0, out["numbers"]
config = dict(config, layout="I420", color_space="YUV",
              compressor=dict(config["compressor"], profile="planar"))
out = run.run_cell(config, traffic, 5, 0, device="cpu", log=lambda m: None)
assert out["failed"] == 0, out["numbers"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "new_bloom_filter_repo_tpu_torch" in loaded
    assert "torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


# The I420 planes of pure colours under BT.709 studio range, worked out by
# hand from Y' = 16 + 219 (Kr R + Kg G + Kb B), Cb = 128 + 224 (B - Y) /
# 1.8556, Cr = 128 + 224 (R - Y) / 1.5748 with Kr = 0.2126, Kb = 0.0722,
# rounded half up: (BGR, (Y, Cb, Cr)).
PURE = [((0, 0, 0), (16, 128, 128)), ((255, 255, 255), (235, 128, 128)),
        ((255, 0, 0), (32, 240, 118)), ((0, 255, 0), (173, 42, 26)),
        ((0, 0, 255), (63, 102, 240)), ((128, 128, 128), (126, 128, 128))]


@pytest.mark.parametrize("bgr,yuv", PURE)
def test_to_i420_gives_the_hand_computed_pixels(bgr, yuv):
    frame = np.empty((6, 8, 3), np.uint8)
    frame[:] = bgr
    for plane, want in zip(generator.to_i420(frame), yuv):
        assert np.all(plane == want), (plane, want)


@pytest.mark.parametrize("h,w", [(2, 2), (48, 64), (180, 320), (42, 66)])
def test_to_i420_gives_planes_of_the_native_geometry(h, w):
    frame = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)
    y, u, v = generator.to_i420(frame)
    assert (y.shape, u.shape, v.shape) == ((h, w), (h // 2, w // 2),
                                           (h // 2, w // 2))
    assert y.dtype == u.dtype == v.dtype == np.uint8
    assert 16 <= y.min() and y.max() <= 235
    assert 16 <= min(u.min(), v.min()) and max(u.max(), v.max()) <= 240


def test_to_i420_is_the_stated_integer_arithmetic():
    """Every pixel of a random frame against the docstring's formulas in
    Python-sized integers: the matrix rows, and the chroma of each 2x2
    block rounded once from the block's sums."""
    f = np.random.default_rng(3).integers(0, 256, (24, 34, 3), np.uint8)
    b, g, r = (f[:, :, c].astype(np.int64) for c in range(3))

    def s4(a):
        return a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]

    want = (16 + ((11966 * r + 40254 * g + 4064 * b + 2**15) >> 16),
            128 + ((-6596 * s4(r) - 22188 * s4(g) + 28784 * s4(b)
                    + 2**17) >> 18),
            128 + ((28784 * s4(r) - 26145 * s4(g) - 2639 * s4(b)
                    + 2**17) >> 18))
    for got, exp in zip(generator.to_i420(f), want):
        assert np.array_equal(got, exp)


@pytest.mark.parametrize("shape,dtype", [((6, 8), np.uint8),
                                         ((6, 8, 4), np.uint8),
                                         ((6, 8, 3), np.uint16),
                                         ((5, 8, 3), np.uint8),
                                         ((6, 7, 3), np.uint8)])
def test_to_i420_refuses_what_is_no_even_bgr_frame(shape, dtype):
    with pytest.raises(ValueError):
        generator.to_i420(np.zeros(shape, dtype))


def i420_config(width=64, height=48):
    with open(os.path.join(BENCH, "configs", "bgr1080-gop30.json")) as fh:
        config = json.load(fh)
    return dict(config, layout="I420", color_space="YUV", width=width,
                height=height, compressor=dict(config["compressor"],
                                               profile="planar"))


@pytest.mark.parametrize("name", traffic_names())
def test_an_i420_clip_is_the_same_scene_and_bytes_from_a_seed(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        traffic = dict(json.load(fh), frames=6)
    config = i420_config()
    clip = run.make_clip(config, traffic, 2**33 + 5)
    again = run.make_clip(config, traffic, 2**33 + 5).planes
    bgr = run.make_clip(dict(config, layout="interleaved"), traffic,
                        2**33 + 5).frames
    other = run.make_clip(config, traffic, 2**33 + 6).planes
    assert len(clip.planes) == len(clip.frames) == 6
    assert clip.raw_bytes == 6 * 64 * 48 * 3 // 2
    for planes, same, frame, diff in zip(clip.planes, again, bgr, other):
        assert [p.shape for p in planes] == [(48, 64), (24, 32), (24, 32)]
        for a, b, want in zip(planes, same, generator.to_i420(frame)):
            assert np.array_equal(a, b) and np.array_equal(a, want)
        assert not np.array_equal(planes[0], diff[0])


def test_under_pan_the_chroma_moves_by_no_whole_sample():
    """The pan rolls frame 1 by 3 px across and 2 down: Y follows by a
    whole roll, U by 1.5 samples across, which no integer roll gives."""
    with open(os.path.join(BENCH, "traffic", "pan.json")) as fh:
        traffic = dict(json.load(fh), frames=2)
    traffic["params"] = dict(traffic["params"], noise=0.0)
    (y0, u0, _), (y1, u1, _) = run.make_clip(
        i420_config(320, 180), traffic, 2**33 + 5).planes

    def best(a, b):
        return max(np.mean(np.roll(a, (dy, dx), (0, 1)) == b)
                   for dy in range(-4, 5) for dx in range(-4, 5))

    assert np.mean(np.roll(y0, (2, 3), (0, 1)) == y1) > 0.95
    assert best(u0, u1) < 0.5
