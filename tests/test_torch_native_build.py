"""The port's build of the shared host library (``utils/native.py``).

Runs on the CPU with no card.  Each test works on a copy of ``native/``
in ``tmp_path``, so the repository's ``native/libnbf.so`` is never
touched.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from new_bloom_filter_repo_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Builds and loads the library of argv[1] (build directory argv[2]) at
# the moment argv[3]; prints whether this process compiled it and
# whether the library it loaded has the xxh64 entry point.
CHILD = r"""
import json, sys, time
from new_bloom_filter_repo_tpu_torch.utils import native
native_dir, build_dir, start = sys.argv[1], sys.argv[2], float(sys.argv[3])
time.sleep(max(0.0, start - time.time()))
compiled = native.ensure_built(native_dir, build_dir)
lib = native.open_library(native_dir, build_dir)
print(json.dumps({"compiled": compiled, "xxh64": hasattr(lib, "nbf_xxh64")}))
"""


def native_copy(tmp_path):
    """A copy of the library's sources, with no library."""
    dst = tmp_path / "native"
    dst.mkdir()
    for name in ("nbf.cpp", "Makefile"):
        shutil.copy(os.path.join(REPO, "native", name), dst)
    return dst


def test_processes_started_together_compile_once(tmp_path):
    src = native_copy(tmp_path)
    build = tmp_path / "build"
    start = time.time() + 2.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(src), str(build), str(start)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(o["xxh64"] for o in outs)
    assert sum(o["compiled"] for o in outs) == 1
    # the private build directories are gone; only the lock stays
    assert sorted(os.listdir(build)) == ["libnbf.lock"]
    # younger than its sources, so no loader of either package rebuilds it
    assert not native._stale(str(src))
    assert native.ensure_built(str(src), str(build)) is False


@pytest.mark.parametrize("fault", ["make fails", "library unloadable"])
def test_loader_raises_instead_of_returning_none(tmp_path, monkeypatch,
                                                 fault):
    src = native_copy(tmp_path)
    build = tmp_path / "build"
    if fault == "make fails":
        (src / "nbf.cpp").write_text("#error deliberately broken\n")
        match = "make exit"
    else:     # a library file younger than its sources that is no ELF
        (src / "libnbf.so").write_bytes(b"not a shared library")
        match = "cannot load"
    with pytest.raises(RuntimeError, match=match):
        native.open_library(str(src), str(build))
    real = native.open_library
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "open_library",
                        lambda: real(str(src), str(build)))
    with pytest.raises(RuntimeError, match=match):
        native.load()
