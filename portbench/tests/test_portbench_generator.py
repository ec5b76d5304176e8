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
    for params, got in ((traffic["params"], clip),
                        ({**traffic["params"], **traffic.get("warm", {})},
                         run.warm_clip(config, traffic, 2**33 + 5, clip))):
        want = generate_frames(len(got), 67, 41, seed=2**33 + 5, **params)
        assert len(got) == run.WARM_FRAMES or got is clip
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
    on the CPU with the metric readers loaded."""
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
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "new_bloom_filter_repo_tpu_torch" in loaded
    assert "torch" in loaded
    assert not loaded & set(run.FORBIDDEN)
