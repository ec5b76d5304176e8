"""The PyTorch port's meshes across processes, on the CPU over gloo.

Each test that needs several processes starts them as fresh
interpreters (``torch.distributed`` is joined once a process), on a
free localhost port, with a hermetic environment, a time limit and a
kill in ``finally``.  Every process calls ``initialize_distributed``,
builds the same mesh of ``(rank, "cpu")`` cells (two a process, the
counterpart of the JAX test's two virtual devices a process) and makes
the same calls on the same seeded inputs.  The ``.bfvc`` file of every
process must equal the port's single-device file and the JAX package's,
both written here in the test process; every sharded program must equal
the unsharded wrapper.  All comparisons are exact.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch
from new_bloom_filter_repo_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 50          # seconds of waiting for one child


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(code: str, n: int, *args) -> list:
    """Run ``code`` in n fresh interpreters as ``rank port *args``;
    returns their outputs.  A child that fails, or outlives its time
    limit, fails the test; none is left running."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"),
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), port, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DONE_{r}" in out, (r, outs)
    return outs


# ---------------------------------------------------------------------------
# The clips of the JAX package's two-process and motion-mesh tests
# ---------------------------------------------------------------------------

CLIPS = r"""
import numpy as np

def static_clip():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 255, (48, 64, 3), np.uint8)
    frames = []
    for t in range(10):
        f = np.roll(base, t, axis=1).copy()
        f[10:18, (3 * t) % 50:(3 * t) % 50 + 8] = (200, 30, 90)
        frames.append(f)
    return frames

def pan_clip():
    rng = np.random.default_rng(11)
    scene = rng.integers(0, 240, (64, 96), np.uint8)
    frames = []
    for i in range(9):
        scene = np.roll(np.roll(scene, 1, axis=0), 2, axis=1)
        f = scene.copy()
        f[5:9, 5:9] = i * 20
        frames.append(f)
    return frames
"""
exec(CLIPS)

JOIN = r"""
import os, sys
rank, port = int(sys.argv[1]), sys.argv[2]
import torch
torch.set_num_threads(2)
from new_bloom_filter_repo_tpu_torch.parallel import mesh as pmesh
info = pmesh.initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                    device_type="cpu")
assert info == {"process_id": rank, "num_processes": 2, "local_devices": 1,
                "global_devices": 2}, info
assert "jax" not in sys.modules
"""

CODEC_CHILD = JOIN + CLIPS + r"""
tmp, clip, dp, sp = sys.argv[3], sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor)
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch as bb
frames = {"static": static_clip, "pan": pan_clip}[clip]()
mesh = pmesh.make_mesh(dp, sp, [(0, "cpu"), (0, "cpu"), (1, "cpu"),
                                (1, "cpu")])
assert mesh.multiproc and mesh.transport == "gloo" and mesh.rank == rank
assert mesh.home == torch.device("cpu")
comp = ImprovedVideoCompressor(devices=mesh)
assert comp._blocked_enc.dispatch.multiproc
out = os.path.join(tmp, f"{clip}_{rank}.bfvc")
comp.compress_video(frames, out, input_color_space="BGR")
enc_hops = bb.hop_stats()["calls"]
dec = comp.decompress_video(out)
assert len(dec) == len(frames)
assert all(np.array_equal(np.asarray(a), b) for a, b in zip(dec, frames))
hop = bb.hop_stats()
assert enc_hops >= 2 and hop["calls"] > enc_hops and hop["bytes"] > 0, hop
print(f"DONE_{rank}", flush=True)
"""


@pytest.mark.parametrize("clip,layout", [("static", (4, 1)),
                                         ("pan", (2, 2))],
                         ids=["static-dp4", "pan-dp2sp2"])
def test_two_processes_write_the_single_device_bytes(clip, layout, tmp_path):
    """Two processes over one mesh (two cells each): each one's file
    equals the port's and the JAX package's single-device files, and
    decodes losslessly through the mesh (in the children).  Both clips
    take type-6 records, whose runs decode through the sharded K4
    path."""
    from new_bloom_filter_repo_tpu.models.video import (
        ImprovedVideoCompressor as JaxCompressor)
    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
    from new_bloom_filter_repo_tpu_torch.utils import container

    run_processes(CODEC_CHILD, 2, tmp_path, clip, *layout)
    frames = {"static": static_clip, "pan": pan_clip}[clip]()
    blobs = {}
    for name, comp in (("port", ImprovedVideoCompressor(device="cpu")),
                       ("jax", JaxCompressor(verbose=False))):
        path = str(tmp_path / f"{name}.bfvc")
        comp.compress_video(frames, path, input_color_space="BGR")
        with open(path, "rb") as fh:
            blobs[name] = fh.read()
    for r in range(2):
        with open(tmp_path / f"{clip}_{r}.bfvc", "rb") as fh:
            blobs[r] = fh.read()
    assert blobs[0] == blobs[1] == blobs["port"] == blobs["jax"]
    types = {fc.record_type(p)
             for p in container.read_bfvc(str(tmp_path / "port.bfvc"))[1]}
    assert fc.MOTION in types      # both clips move: the decode takes K4


SHARD_CHILD = JOIN + r"""
dp, sp = int(sys.argv[3]), int(sys.argv[4])
import numpy as np
from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch as bb
IPB = bk.IPB
KW = {"k_lanes": 3, "vh": 8, "nw": 12}
# cells alternate between the processes, so each owns cells in every row
cells = [((i + j) % 2, "cpu") for i in range(dp) for j in range(sp)]
mesh = pmesh.make_mesh(dp, sp, cells)

def inputs(f, nb, seed=0):
    rng = np.random.default_rng(seed)
    def i32(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))
    d = dict(bits=torch.from_numpy(
        (rng.random((f, nb, IPB)) < 0.05).astype(np.uint8)))
    d["h1"], d["h2"] = i32(0, 1 << 24, (nb, IPB)), i32(0, 1 << 24, (nb, IPB))
    d["ahi"] = i32(-(1 << 31), 1 << 31, (nb, IPB))
    d["alo"] = i32(-(1 << 31), 1 << 31, (nb, IPB))
    d["thi"], d["tlo"] = i32(-(1 << 31), 1 << 31, f), i32(-(1 << 31),
                                                          1 << 31, f)
    d["m"] = torch.tensor([16, 100, 384, 64][:f], dtype=torch.int32)
    d["fk"] = torch.tensor([0, 2, 3, 1][:f], dtype=torch.int32)
    d["vals"] = i32(0, 1 << 24, (f, nb, IPB))
    d["flags"] = torch.zeros(f, dtype=torch.int32)
    d["flags"][f // 2] = 1
    d["raw"] = torch.zeros_like(d["bits"])
    d["raw"][f // 2] = torch.from_numpy(
        (rng.random((nb, IPB)) < 0.03).astype(np.uint8))
    return d

def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)

two = sp > 1
# F = 3 over dp = 4 leaves an empty frame shard; NB = 5 is not divisible
# by sp; F = 1 leaves every cell but one (process 0's) without work
for f, nb in ((3, 5), (1, 5)):
    d = inputs(f, nb)
    tabs = (d["h1"], d["h2"], d["ahi"], d["alo"])
    scal = (d["m"], d["thi"], d["tlo"], d["fk"])
    enc = (bb.make_blocked_encode_h_dpsp if two
           else bb.make_blocked_encode_h_dp)(mesh, **KW)
    got = enc(d["bits"], *tabs, d["vals"], *scal)
    want = bk.blocked_encode_h(d["bits"], *tabs, d["vals"], *scal, **KW)
    same(got, want)
    words, wit, _, vseg, _ = want
    mem = (bb.make_blocked_membership_h_dpsp if two
           else bb.make_blocked_membership_h_dp)(mesh, k_lanes=3, nw=12)
    got = mem(words, *tabs, *scal, d["flags"])
    want = bk.blocked_membership_h(words, *tabs, *scal, d["flags"],
                                   k_lanes=3, nw=12)
    same(got, want)
    passes = want[0]
    exp = (bb.make_blocked_expand_dpsp if two
           else bb.make_blocked_expand_dp)(mesh, vh=8)
    same(exp(passes, wit, d["raw"], d["flags"], vseg),
         bk.blocked_expand(passes, wit, d["raw"], d["flags"], vseg, vh=8))
    a, b, act = bp._frame_mod_tables(*tabs, d["m"], d["thi"], d["tlo"])
    dec = (bb.make_blocked_decode_dpsp if two
           else bb.make_blocked_decode_dp)(mesh, **KW)
    got = dec(words, a, b, act, d["m"], d["fk"], d["flags"], wit, d["raw"],
              vseg)
    p5, w5 = bk.blocked_membership(words, a, b, act, d["m"], d["fk"],
                                   d["flags"], k_lanes=3, nw=12)
    same(got, (p5, w5) + tuple(bk.blocked_expand(p5, wit, d["raw"],
                                                 d["flags"], vseg, vh=8)))
# no frame at all: every process runs the call unsharded, with no hop
calls = bb.hop_stats()["calls"]
d = inputs(3, 5)
empty = exp(passes[:0], wit[:0], d["raw"][:0], d["flags"][:0], vseg[:0])
assert empty[0].shape[0] == 0 and bb.hop_stats()["calls"] == calls

# the dispatch, on a stacked chunk: phase A with the motion search
disp = bp._MeshDispatch(mesh)
assert disp.multiproc
rng = np.random.default_rng(3)
scene = rng.integers(0, 255, (48, 64, 3), np.uint8)
stacked = torch.from_numpy(np.stack(
    [np.roll(scene, (t, 2 * t), (0, 1)) for t in range(4)]))
npad = bp.npad_of(48 * 64)
kw = dict(npad=npad, nb=npad // IPB)
same(disp.phase_a_auto(stacked, 4, **kw),
     bp._phase_a_auto(stacked, stride=4, **kw))
same(disp.phase_a(stacked, **kw), bp._phase_a(stacked, **kw))
counts = disp.motion_counts(stacked, 4)
same([counts], [bp._motion_counts(stacked, stride=4)])
shifts = torch.from_numpy(bp.choose_shifts(counts.numpy()))
assert shifts.any()
same(disp.phase_a_motion(stacked, shifts, **kw),
     bp._phase_a_motion(stacked, shifts, **kw))
print(f"DONE_{rank}", flush=True)
"""


@pytest.mark.parametrize("layout", [(4, 1), (4, 2), (2, 2)],
                         ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_run_sharded_across_two_processes(layout):
    """Every sharded blocked program and every ``_MeshDispatch`` phase-A
    method across two processes, with uneven and empty shards and with
    a call in which one process has no work, against the unsharded
    wrappers in each process."""
    run_processes(SHARD_CHILD, 2, *layout)


ONE_PROCESS = r"""
import sys
rank, port = int(sys.argv[1]), sys.argv[2]
import torch
from new_bloom_filter_repo_tpu_torch.parallel import mesh
assert mesh._DIST is None
info = mesh.initialize_distributed(coordinator_address=f"localhost:{port}",
                                   num_processes=1, process_id=0,
                                   device_type="cpu")
assert info == {"process_id": 0, "num_processes": 1, "local_devices": 1,
                "global_devices": 1}, info
assert mesh.initialize_distributed(device_type="cpu") == info   # idempotent
assert torch.distributed.is_initialized()
m = mesh.make_mesh(1, 1)                 # the initialized type's devices
assert m.home == torch.device("cpu") and not m.multiproc
assert m.ranks == ((0,),) and m.transport == "local"
assert mesh.auto_mesh(device_type="cpu").size == 1
assert "jax" not in sys.modules
print("DONE_0", flush=True)
"""


def test_initialize_distributed_single_process():
    run_processes(ONE_PROCESS, 1)


ENV_CHILD = r"""
import os, sys
rank, port = int(sys.argv[1]), sys.argv[2]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                  RANK=str(rank), WORLD_SIZE="2")
from new_bloom_filter_repo_tpu_torch.parallel import mesh
info = mesh.initialize_distributed(device_type="cpu")
assert info["process_id"] == rank and info["global_devices"] == 2, info
m = mesh.make_mesh(2)                    # one cell a process, rank order
assert m.ranks == ((0,), (1,)) and m.multiproc and m.rank == rank
assert mesh.auto_mesh(device_type="cpu").size == 2
try:
    mesh.make_mesh(1, 1, [(0, "cpu")])
except ValueError as e:                  # rank 1 owns no cell; for rank 0
    assert "cell" in str(e)              # the mesh is one process's
else:
    assert rank == 0
print(f"DONE_{rank}", flush=True)
"""


def test_initialize_distributed_from_the_environment():
    """Without arguments the rendezvous comes from ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``; ``make_mesh`` then
    spans both processes' devices."""
    run_processes(ENV_CHILD, 2)


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------

@pytest.fixture
def two_process_state(monkeypatch):
    """The state ``initialize_distributed`` leaves in process 0 of two
    CPU processes, without a process group: enough to build meshes."""
    monkeypatch.setattr(pmesh, "_DIST", {
        "rank": 0, "world": 2, "device_type": "cpu", "nccl": False,
        "cards": [[("host", "cpu")], [("host", "cpu")]]})


def test_bfv2_refuses_a_mesh_over_processes(two_process_state):
    mesh = pmesh.make_mesh(2)
    assert mesh.multiproc and mesh.transport == "gloo"
    assert "0:cpu" in repr(mesh) and "1:cpu" in repr(mesh)
    with pytest.raises(ValueError, match="bfv2"):
        ImprovedVideoCompressor(profile="bfv2", devices=mesh)
    with pytest.raises(ValueError, match="one process"):
        pbatch.make_gop_masks_dp(mesh)
    with pytest.raises(ValueError, match="one process"):
        pbatch.make_sharded_encode(mesh, 64, 64)
    assert ImprovedVideoCompressor(profile="planar", devices=mesh).mesh \
        is mesh


def test_mesh_without_an_own_cell_raises(two_process_state):
    with pytest.raises(ValueError, match="owns no cell"):
        pmesh.make_mesh(1, 1, [(1, "cpu")])
    with pytest.raises(ValueError, match="every"):
        pmesh.make_mesh(2, 1, [(0, "cpu"), (2, "cpu")])
    with pytest.raises(ValueError, match="initialized type"):
        pmesh.make_mesh(2, 1, [(0, "cpu"), (1, "cuda:0")])
    plain = pmesh.make_mesh(2, 1, ["cpu", (0, "cpu")])
    assert not plain.multiproc and plain.transport == "local"


def test_spanning_mesh_needs_initialization():
    assert pmesh._DIST is None
    with pytest.raises(ValueError, match="owns no cell"):
        pmesh.make_mesh(1, 1, [(1, "cpu")])
    with pytest.raises(ValueError, match="initialize_distributed"):
        pmesh.make_mesh(2, 1, [(0, "cpu"), (1, "cpu")])


def test_initialize_distributed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pmesh.initialize_distributed("127.0.0.1:1", 1, 0)
    assert pmesh._DIST is None and not torch.distributed.is_initialized()


def test_transport_follows_the_cards(monkeypatch):
    """Two processes on one physical card stage through the host; on
    distinct cards they take NCCL (and raise where the build lacks it)."""
    state = {"rank": 0, "world": 2, "device_type": "cuda", "nccl": True,
             "cards": [[("host", "GPU-a"), ("host", "GPU-b")],
                       [("host", "GPU-a"), ("host", "GPU-b")]]}
    monkeypatch.setattr(pmesh, "_DIST", state)
    monkeypatch.setattr(pmesh, "_device", torch.device)
    flat = lambda *cells: [(r, torch.device(d)) for r, d in cells]
    assert pmesh.Mesh._transport(
        flat((0, "cuda:0"), (1, "cuda:0"))) == "gloo-staged"
    assert pmesh.Mesh._transport(flat((0, "cuda:0"), (1, "cuda:1"))) == "nccl"
    # only the home cards talk across processes
    assert pmesh.Mesh._transport(flat(
        (0, "cuda:0"), (0, "cuda:1"), (1, "cuda:1"),
        (1, "cuda:0"))) == "nccl"
    state["cards"][1] = [("other", "GPU-a")]
    assert pmesh.Mesh._transport(flat((0, "cuda:0"), (1, "cuda:0"))) == "nccl"
    with pytest.raises(ValueError, match="has no cuda:1"):
        pmesh.Mesh._transport(flat((0, "cuda:0"), (1, "cuda:1")))
    state["nccl"] = False
    with pytest.raises(RuntimeError, match="NCCL"):
        pmesh.Mesh._transport(flat((0, "cuda:0"), (1, "cuda:0")))
