"""The PyTorch port imports no JAX, and refuses what it does not port.

The import check runs in a subprocess: this test process already holds
JAX (tests/conftest.py imports it).
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.utils import container

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "new_bloom_filter_repo_tpu_torch")


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import sys\n"
        "import new_bloom_filter_repo_tpu_torch as p\n"
        "import new_bloom_filter_repo_tpu_torch.models.video\n"
        "import new_bloom_filter_repo_tpu_torch.ops.blocked\n"
        "import new_bloom_filter_repo_tpu_torch.ops._build\n"
        "import new_bloom_filter_repo_tpu_torch.parallel.mesh\n"
        "import new_bloom_filter_repo_tpu_torch.parallel.blocked_batch\n"
        "import new_bloom_filter_repo_tpu_torch.graft_entry\n"
        "import chip_smoke\n"
        "assert p.ImprovedVideoCompressor.__module__.endswith('video')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.startswith('new_bloom_filter_repo_tpu.')\n"
        "             or m == 'new_bloom_filter_repo_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import jaxlib|"
                     r"from new_bloom_filter_repo_tpu[ .]|"
                     r"import new_bloom_filter_repo_tpu\b(?!_torch))",
                     re.M)
    files = glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


@pytest.mark.parametrize("kwargs", [
    {"mode": "keyframe"}, {"profile": "planar"}, {"profile": "bfv2"},
    {"exact": False},
])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        ImprovedVideoCompressor(**kwargs)


def test_unknown_options_still_raise_value_error():
    with pytest.raises(ValueError):
        ImprovedVideoCompressor(mode="nope")
    with pytest.raises(ValueError):
        ImprovedVideoCompressor(profile="nope")
    with pytest.raises(ValueError):
        ImprovedVideoCompressor(batch_size=0)
    with pytest.raises(ValueError):
        ImprovedVideoCompressor().compress_video([])


@pytest.mark.parametrize("frames", [
    [np.zeros((8, 8), np.uint16)] * 3,                  # byte view
    [np.zeros((8, 8, 4), np.uint8)] * 3,                # BGRA
    [np.zeros((8, 8, 3), np.float32)] * 3,              # HDR
    [np.zeros((8, 8, 3), np.uint8), np.zeros((8, 9, 3), np.uint8)],
], ids=["uint16", "bgra", "float32", "mixed_shapes"])
def test_unported_frame_kinds_raise(frames):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        ImprovedVideoCompressor().compress_video(frames)


def test_unported_streams_raise(tmp_path):
    comp = ImprovedVideoCompressor()
    key = fc.encode_keyframe_best(np.zeros((8, 8, 3), np.uint8), None)
    path = str(tmp_path / "fixed.bfvc")
    container.write_bfvc(path, [key[1:]], container.MAGIC_FIXED)
    with pytest.raises(NotImplementedError, match="item 10"):
        comp.decompress_video(path)
    planar = [fc.encode_planar_header("I420", 8, 8, 1, [1, 1, 1])]
    bloom0 = fc.build_interframe_record(0.1, 64, 1.5, b"\xff" * 8, 64,
                                        b"\x80", 1, np.zeros(0, np.uint8))
    for payloads, item in [(planar, "item 9"), ([key, bloom0], "item 10")]:
        container.write_bfvc(path, payloads, container.MAGIC_BLOOM)
        with pytest.raises(NotImplementedError, match=item):
            comp.decompress_video(path)
    good = str(tmp_path / "good.bfvc")
    frames = [np.zeros((8, 8, 3), np.uint8)] * 2
    comp.compress_video(frames, good)
    with pytest.raises(NotImplementedError, match="item 12"):
        comp.decompress_video(good, output_path=str(tmp_path / "x.y4m"))


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA card the smoke script exits non-zero and prints no
    result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
