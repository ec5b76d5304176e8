"""K1-K8, the port's main and mesh paths and its decode pull on an
NVIDIA card.

Marked ``cuda``: each test skips without a card.  On the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX, which the
card's machine need not have).  This file imports no JAX: the kernels
are held to their plain PyTorch twins, which the CPU tests hold to the
JAX Pallas kernels.  Every comparison is exact.
"""

import threading

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa
from new_bloom_filter_repo_tpu_torch.ops.hashtables import npad_of
from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh
from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
    SUITE,
    generate_frames,
)

pytestmark = pytest.mark.cuda
IPB = bk.IPB


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def encode_args(dev, f=4, nb=16, seed=0):
    rng = np.random.default_rng(seed)
    m = np.array([16, 100, 257, 384][:f], np.int32)
    fk = np.array([0, 2, 7, 12][:f], np.int32)
    dens = np.array([0.002, 0.05, 0.2, 0.3][:f])[:, None, None]
    bits = (rng.random((f, nb, IPB)) < dens).astype(np.uint8)
    u32 = np.iinfo(np.uint32).max

    def u(shape):
        return rng.integers(0, u32, shape, dtype=np.uint32,
                            endpoint=True).view(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (t(bits), t(rng.integers(0, 1 << 24, (nb, IPB), dtype=np.int32)),
            t(rng.integers(0, 1 << 24, (nb, IPB), dtype=np.int32)),
            t(u((nb, IPB))), t(u((nb, IPB))),
            t(rng.integers(0, 1 << 24, (f, nb, IPB), dtype=np.int32)),
            t(m), t(u(f)), t(u(f)), t(fk))
    return args, {"k_lanes": 12, "vh": 32, "nw": 12}


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("flagged", [False, True])
def test_kernels_equal_twins(dev, flagged):
    args, kw = encode_args(dev)
    bk.reset_launches()
    same(bk.blocked_encode_h(*args, **kw), bk.blocked_encode_h_ref(*args,
                                                                   **kw))
    words, wit, _, vseg, _ = bk.blocked_encode_h_ref(*args, **kw)
    f = words.shape[0]
    flags = torch.zeros(f, dtype=torch.int32, device=dev)
    raw = torch.zeros_like(args[0])
    if flagged:
        flags[1] = 1
        raw[1] = (torch.rand(raw.shape[1:], device=dev) < 0.1).to(
            torch.uint8)
    mem = (words, *args[1:5], *args[6:10], flags)
    same(bk.blocked_membership_h(*mem, k_lanes=12, nw=12),
         bk.blocked_membership_h_ref(*mem, k_lanes=12, nw=12))
    passes, _ = bk.blocked_membership_h_ref(*mem, k_lanes=12, nw=12)
    exp = (passes, wit, raw, flags, vseg)
    base = args[5][0].flip(-1).contiguous()
    same(bk.blocked_expand_chain(*exp, base, vh=32),
         bk.blocked_expand_chain_ref(*exp, base, vh=32))
    same(bk.blocked_expand(*exp, vh=32), bk.blocked_expand_ref(*exp, vh=32))
    torch.cuda.synchronize()
    assert bk.launches() == {"blocked_encode_h": 1,
                             "blocked_membership_h": 1,
                             "blocked_expand_chain": 1,
                             "blocked_expand": 1,
                             "blocked_encode": 0,
                             "blocked_membership": 0,
                             "phase_a_diff": 0,
                             "motion_counts": 0,
                             "tile_motion_best": 0}


@pytest.mark.parametrize("flagged", [False, True])
def test_k5_kernels_equal_twins_and_k1_k2(dev, flagged):
    args, kw = encode_args(dev, seed=1)
    bits, h1, h2, ahi, alo, vals, m, thi, tlo, fk = args
    a, b, act = bp._frame_mod_tables(h1, h2, ahi, alo, m, thi, tlo)
    enc5 = (bits, a, b, act, vals, m, fk)
    got = bk.blocked_encode(*enc5, **kw)
    same(got, bk.blocked_encode_ref(*enc5, **kw))
    same(got, bk.blocked_encode_h(*args, **kw))
    words = got[0]
    flags = torch.zeros(bits.shape[0], dtype=torch.int32, device=dev)
    if flagged:
        flags[::2] = 1
    mem5 = (words, a, b, act, m, fk, flags)
    got = bk.blocked_membership(*mem5, k_lanes=12, nw=12)
    same(got, bk.blocked_membership_ref(*mem5, k_lanes=12, nw=12))
    same(got, bk.blocked_membership_h(words, h1, h2, ahi, alo, m, thi, tlo,
                                      fk, flags, k_lanes=12, nw=12))
    torch.cuda.synchronize()


def expand_edge_inputs(f, nb, vh, dens, flagged, seed=0):
    """K3/K4 inputs made directly, as numpy (passes, wit, raw, flags,
    vseg, base): frame i passes items at density ``dens[i % len(dens)]``
    (1: every item, 0: none); block 0 has every witness bit set, so with
    every item passing its rank-1023 item reads the last bit; the
    ``flagged`` frames take a raw mask of density 0.4 (unflagged frames
    carry one too, which they must ignore); ``vh`` may leave fewer value
    slots than changed items."""
    rng = np.random.default_rng(seed)
    d = np.resize(np.asarray(dens, np.float64), f).reshape(-1, 1, 1)
    passes = (rng.random((f, nb, IPB)) < d).astype(np.uint8)
    wit = rng.integers(0, 256, (f, nb, IPB // 8), dtype=np.uint8)
    wit[:, 0] = 0xFF
    flags = np.zeros(f, np.int32)
    flags[list(flagged)] = 1
    raw = (rng.random((f, nb, IPB)) < 0.4).astype(np.uint8)
    vseg = rng.integers(0, 1 << 24, (f, nb, vh * 32), dtype=np.int32)
    base = rng.integers(0, 1 << 24, (nb, IPB), dtype=np.int32)
    return passes, wit, raw, flags, vseg, base


# (F, NB, vh, pass densities by frame, flagged frames): all / none /
# half / few passing; F = 1 and 17 (odd: the last trip of the kernels'
# unrolled frame loop runs one frame); NB = 1 and 2033; vh = 4 and 1 leave
# fewer value slots than changed items.
CARD_EDGES = {
    "f17_nb2033_vh4": (17, 2033, 4, [1.0, 0.0, 0.5, 0.03],
                       range(1, 17, 2)),
    "f1_nb2033_vh32": (1, 2033, 32, [1.0], []),
    "f17_nb1_vh32": (17, 1, 32, [1.0, 0.5, 0.0], range(0, 17, 3)),
    "f1_nb1_vh1": (1, 1, 1, [1.0], []),
}


@pytest.mark.parametrize("edge", sorted(CARD_EDGES))
def test_expand_kernels_equal_twins_on_edge_inputs(dev, edge):
    passes, wit, raw, flags, vseg, base = (
        torch.from_numpy(a).to(dev)
        for a in expand_edge_inputs(*CARD_EDGES[edge], seed=3))
    vh = CARD_EDGES[edge][2]
    exp = (passes, wit, raw, flags, vseg)
    same(bk.blocked_expand(*exp, vh=vh), bk.blocked_expand_ref(*exp, vh=vh))
    same(bk.blocked_expand_chain(*exp, base, vh=vh),
         bk.blocked_expand_chain_ref(*exp, base, vh=vh))
    torch.cuda.synchronize()


def test_devices_mesh_stream_equals_one_device(dev, tmp_path):
    frames = generate_frames(16, 96, 80, seed=0, **SUITE["pan"])
    one = str(tmp_path / "one.bfvc")
    ImprovedVideoCompressor(device=dev).compress_video(frames, one)
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i % n) for i in range(4)]
    for dp, sp in [(2, 2), (4, 1), (1, 4)]:
        path = str(tmp_path / f"m{dp}{sp}.bfvc")
        comp = ImprovedVideoCompressor(devices=make_mesh(dp, sp, cards))
        comp.compress_video(frames, path)
        with open(one, "rb") as a, open(path, "rb") as b:
            assert a.read() == b.read()
        for g, w in zip(comp.decompress_video(path), frames):
            np.testing.assert_array_equal(g, w)


# Phase A on the card, K6 and K7 (h, w, C, F, stride): frames of odd
# size, so the current frames of a stacked chunk start off any 4-byte
# boundary, and n not a multiple of 1024 (24 x 37: 7 whole padding
# blocks); gray; a 1080p pair at the main path's stride
PHASE_A_SHAPES = [(24, 37, 3, 9, 4), (96, 130, 1, 5, 4), (64, 48, 2, 3, 8),
                  (1080, 1920, 3, 2, 8)]


def phase_a_chunk(dev, h, w, c, f, seed=0):
    """A stacked (F+1, h, w[, c]) chunk on the card: each frame the last
    rolled by (1, 2) with a fifth of its pixels redrawn, and shifts over
    0, +-7, +-h, +-w and both ends of int32."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)]
    for _ in range(f):
        nxt = np.roll(frames[-1], (1, 2), axis=(0, 1)).copy()
        redraw = rng.random((h, w)) < 0.2
        nxt[redraw] = rng.integers(0, 256, nxt[redraw].shape, dtype=np.uint8)
        frames.append(nxt)
    vals = [0, 7, -7, h, -h, w, -w, (1 << 31) - 1, -(1 << 31)]
    shifts = np.stack([np.resize(vals, f), np.resize(vals[::-1], f)], 1)
    return (torch.from_numpy(np.stack(frames)).to(dev),
            torch.from_numpy(shifts.astype(np.int32)).to(dev))


@pytest.mark.parametrize("shape", PHASE_A_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_phase_a_kernels_equal_twins(dev, shape):
    h, w, c, f, stride = shape
    stacked, shifts = phase_a_chunk(dev, h, w, c, f, seed=h)
    prev, curr = stacked[:-1], stacked[1:]
    npad = npad_of(h * w)
    nb = npad // IPB
    bk.reset_launches()
    for sh in (None, shifts, torch.zeros_like(shifts)):
        same(pa.phase_a_diff(prev, curr, sh, npad, nb),
             pa.phase_a_diff_ref(prev, curr, sh, npad, nb))
    same(pa.motion_counts(prev, curr, stride),
         pa.motion_counts_ref(prev, curr, stride))
    same(bp._phase_a_auto(stacked, stride=stride, npad=npad, nb=nb),
         tuple(x.to(dev) for x in bp._phase_a_auto(
             stacked.cpu(), stride=stride, npad=npad, nb=nb)))
    torch.cuda.synchronize()
    launched = bk.launches()
    assert launched["phase_a_diff"] == 4 and launched["motion_counts"] == 2


# K7 and K8 (h, w, C, F): the shapes above, 1080p, and a width whose
# rows start off 16-byte boundaries (1917 x 3 bytes)
SEARCH_SHAPES = [(24, 37, 3, 9), (96, 130, 1, 5), (64, 48, 2, 3),
                 (1080, 1920, 3, 2), (45, 1917, 3, 2)]


def unaligned(stacked):
    """A copy of ``stacked`` whose first byte lies 1 past a 16-byte
    boundary, so the kernels copy the granules at both of its ends
    byte by byte."""
    buf = torch.empty(stacked.numel() + 16, dtype=torch.uint8,
                      device=stacked.device)
    start = (1 - buf.data_ptr()) % 16
    view = buf[start: start + stacked.numel()].view(stacked.shape)
    view.copy_(stacked)
    assert view.data_ptr() % 16 == 1
    return view


@pytest.mark.parametrize("stride", [1, 4, 8])
@pytest.mark.parametrize("shape", SEARCH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_motion_search_kernels_equal_twins(dev, shape, stride):
    h, w, c, f = shape
    stacked, _ = phase_a_chunk(dev, h, w, c, f, seed=h + stride)
    bk.reset_launches()
    for chunk in (stacked, unaligned(stacked)):
        prev, curr = chunk[:-1], chunk[1:]
        same(pa.motion_counts(prev, curr, stride),
             pa.motion_counts_ref(prev, curr, stride))
        for tlog in (2, 4, 6):
            same(pa.tile_motion_best(prev, curr, tlog=tlog, stride=stride),
                 pa.tile_motion_best_ref(prev, curr, tlog, stride))
    torch.cuda.synchronize()
    launched = bk.launches()
    assert launched["motion_counts"] == 2
    assert launched["tile_motion_best"] == 6


def test_tile_motion_best_on_the_main_path_equals_cpu(dev):
    """The encoder's per-tile search at 1080p through K8 equals the CPU
    port's."""
    frames = generate_frames(3, 1920, 1080, seed=0, **SUITE["zoom"])
    stacked = torch.from_numpy(np.stack(frames))
    kw = {"tlog": bp.tile_log(1080, 1920), "stride": bp.motion_stride(
        1080, 1920)}
    bk.reset_launches()
    same(bp._tile_motion_best(stacked.to(dev), **kw),
         bp._tile_motion_best(stacked, **kw).to(dev))
    assert bk.launches()["tile_motion_best"] == 1


def test_phase_a_wrappers_raise_instead_of_falling_back(dev):
    stacked, shifts = phase_a_chunk(dev, 24, 37, 3, 2)
    prev, curr = stacked[:-1], stacked[1:]
    with pytest.raises(TypeError, match="curr must be torch.uint8"):
        pa.phase_a_diff(prev, curr.to(torch.int32), None, 8192, 8)
    with pytest.raises(TypeError, match="shifts must be torch.int32"):
        pa.phase_a_diff(prev, curr, shifts.long(), 8192, 8)
    with pytest.raises(ValueError, match="prev must be contiguous"):
        pa.motion_counts(prev.transpose(1, 2).contiguous().transpose(1, 2),
                         curr, 4)
    with pytest.raises(TypeError, match="curr must be torch.uint8"):
        pa.tile_motion_best(prev, curr.to(torch.int32), tlog=4, stride=4)
    with pytest.raises(ValueError, match="prev is on cpu"):
        pa.tile_motion_best(prev.cpu(), curr, tlog=4, stride=4)
    with pytest.raises(ValueError, match="K8 takes no tile"):
        pa.tile_motion_best(prev, curr, tlog=14, stride=1)
    with pytest.raises(ValueError, match="prev is on cpu"):
        pa.phase_a_diff(prev.cpu(), curr, None, 8192, 8)
    with pytest.raises(ValueError, match="shifts is on cpu"):
        pa.phase_a_diff(prev, curr, shifts.cpu(), 8192, 8)
    with pytest.raises(ValueError, match="bad geometry"):
        pa.phase_a_diff(prev, curr, None, 8192, 7)
    bk.reset_launches()
    empty = stacked[:0]
    masks, counts, vals = pa.phase_a_diff(empty, empty, None, 8192, 8)
    assert masks.shape == (0, 8, IPB) and vals.shape == (0, 8, IPB)
    assert pa.motion_counts(empty, empty, 4).shape == (0, pa.CANDIDATES)
    assert pa.tile_motion_best(empty, empty, tlog=4,
                               stride=4).shape == (0, 2, 3, 3)
    assert bk.launches()["phase_a_diff"] == 0
    assert bk.launches()["tile_motion_best"] == 0


def test_wrapper_raises_instead_of_falling_back(dev):
    args, kw = encode_args(dev)
    bad = (args[0].to(torch.int32),) + args[1:]
    with pytest.raises(TypeError, match="bits must be torch.uint8"):
        bk.blocked_encode_h(*bad, **kw)
    mixed = args[:1] + (args[1].cpu(),) + args[2:]
    with pytest.raises(ValueError, match="h1 is on cpu"):
        bk.blocked_encode_h(*mixed, **kw)


def test_wrapper_rejects_misaligned_items(dev):
    """K1/K2 load items as vectors: a per-item array that does not start
    on a 16-byte boundary raises instead of launching."""
    args, kw = encode_args(dev)
    bits = args[0]
    flat = torch.empty(bits.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = flat[1:].view(bits.shape)
    shifted.copy_(bits)
    with pytest.raises(ValueError, match="bits must start on a 16-byte"):
        bk.blocked_encode_h(shifted, *args[1:], **kw)
    words = bk.blocked_encode_h(*args, **kw)[0]
    f = words.shape[0]
    h1 = torch.empty(args[1].numel() + 1, dtype=torch.int32,
                     device=dev)[1:].view(args[1].shape)
    with pytest.raises(ValueError, match="h1 must start on a 16-byte"):
        bk.blocked_membership_h(words, h1, *args[2:5], *args[6:10],
                                torch.zeros(f, dtype=torch.int32,
                                            device=dev), k_lanes=12, nw=12)


@pytest.mark.parametrize("name", ["static_gentle", "pan", "scene_cuts"])
def test_cuda_stream_equals_cpu_stream(dev, tmp_path, name):
    frames = generate_frames(16, 96, 80, seed=0, **SUITE[name])
    paths = []
    for d in (dev, "cpu"):
        paths.append(str(tmp_path / f"{d}.bfvc"))
        ImprovedVideoCompressor(device=d).compress_video(frames, paths[-1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    dec = ImprovedVideoCompressor(device=dev).decompress_video(paths[0])
    assert len(dec) == len(frames)
    for g, w in zip(dec, frames):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The decode pull: each device run's frames in pinned host memory
# ---------------------------------------------------------------------------

def pulled_runs(monkeypatch):
    """Spy on BlockedDecoder.decode_run_begin: the payload count of every
    run launched, and the frames each ``finish()`` returned."""
    runs, pulled = [], []
    begin = bp.BlockedDecoder.decode_run_begin

    def counted(self, base, payloads, stage_times=None):
        runs.append(len(payloads))
        last, fin = begin(self, base, payloads, stage_times)

        def finish():
            pulled.append(fin())
            return pulled[-1]
        return last, finish

    monkeypatch.setattr(bp.BlockedDecoder, "decode_run_begin", counted)
    return runs, pulled


@pytest.mark.parametrize("name", ["static_gentle", "pan"])
def test_decode_pulls_into_pinned_memory(dev, tmp_path, monkeypatch, name):
    """Every device run is pulled into page-locked memory (``pinned``
    equal to the runs, ``plain`` 0), the caller's frames are views of it,
    and the frames are the input's and the CPU decode's."""
    frames = generate_frames(40, 320, 180, seed=3, **SUITE[name])
    path = str(tmp_path / "clip.bfvc")
    comp = ImprovedVideoCompressor(device=dev)
    comp.compress_video(frames, path)
    runs, pulled = pulled_runs(monkeypatch)
    bp.reset_pull_counts()
    dec = comp.decompress_video(path)
    assert len(runs) >= 2 and len(pulled) == len(runs)
    assert bp.pull_counts() == {"pinned": len(runs), "plain": 0,
                                "bytes": sum(runs) * frames[0].nbytes}
    assert all(torch.from_numpy(a).is_pinned() for out in pulled
               for a in out)
    from_pulls = {id(a) for out in pulled for a in out}
    kept = [g for g in dec if id(g) in from_pulls]
    assert len(kept) > len(dec) // 2
    assert all(torch.from_numpy(g).is_pinned() for g in kept)
    ref = ImprovedVideoCompressor(device="cpu").decompress_video(path)
    assert len(dec) == len(ref) == len(frames)
    for g, r, w in zip(dec, ref, frames):
        assert g.tobytes() == r.tobytes() == w.tobytes()


def test_kept_frames_survive_later_decodes(dev, tmp_path):
    """Frames of clip A that the caller keeps hold their pinned blocks:
    decoding clips B and C with the same compressor, whose blocks return
    to the cache and are reused, leaves A's frames unchanged."""
    comp = ImprovedVideoCompressor(device=dev)
    clips = []
    for seed, name in enumerate(["static_gentle", "pan", "static_gentle"]):
        frames = generate_frames(40, 320, 180, seed=10 + seed,
                                 **SUITE[name])
        path = str(tmp_path / f"{seed}.bfvc")
        comp.compress_video(frames, path)
        clips.append((frames, path))
    a = comp.decompress_video(clips[0][1])
    want = [g.tobytes() for g in a]
    for frames, path in clips[1:]:
        for g, w in zip(comp.decompress_video(path), frames):
            assert g.tobytes() == w.tobytes()
    torch.cuda.synchronize()
    assert [g.tobytes() for g in a] == want
    assert want == [w.tobytes() for w in clips[0][0]]


def test_a_planar_i420_pan4_clip_on_the_card_equals_cpu_and_reference(
        dev, tmp_path):
    """A 320x180 clip of the benchmark's ``pan4`` mix as I420 planes,
    through the ``i420-1080-gop250`` configuration's compressor on the
    card: its file equals the CPU's byte for byte, its decode the plain
    reference (``portbench/planar_reference.py``) in planes and 4:4:4
    view, and ``planar_counts()`` reads one pass a plane."""
    import json
    import os

    from new_bloom_filter_repo_tpu_torch.models import video
    from portbench import planar_reference, run

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench")
    with open(os.path.join(bench, "configs", "i420-1080-gop250.json")) as fh:
        config = json.load(fh)
    with open(os.path.join(bench, "traffic", "pan4.json")) as fh:
        traffic = json.load(fh)
    n, h, w = 40, 180, 320
    compressor = config["compressor"]
    made = run.make_clip(dict(config, width=w, height=h),
                         dict(traffic, frames=n), 2**32 + 23)
    planes, clip = made.planes, made.frames
    files = []
    for d in (dev, "cpu"):
        files.append(str(tmp_path / f"{d}.bfvc"))
        video.reset_planar_counts()
        ImprovedVideoCompressor(device=d, verbose=False,
                                **compressor).compress_video(
            clip, files[-1], input_color_space="YUV")
        counts = video.planar_counts()
        assert sum(c["passes"] for c in counts.values()) == 3
        assert {p: (c["frames"], c["keyframes"]) for p, c in counts.items()
                } == {p: (n, 1) for p in planar_reference.PLANES}
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        data = a.read()
        assert data == b.read()
    assert planar_reference.shape_of(data) == planar_reference.container(
        n, compressor["keyframe_interval"], w, h)
    dec = ImprovedVideoCompressor(device=dev, **compressor).decompress_video(
        files[0])
    want = planar_reference.decoded(planes)
    assert len(dec) == len(want) == n
    for got, ref in zip(dec, want):
        for p in planar_reference.PLANES:
            assert (np.asarray(got.yuv_info[p + "_plane"]).tobytes()
                    == ref[p].tobytes())
        assert np.asarray(got).tobytes() == ref["view"].tobytes()


# ---------------------------------------------------------------------------
# The other profiles and modes: torch ops on the card, CUDA vs CPU bytes
# ---------------------------------------------------------------------------

def other_clip(kind, n=8, h=48, w=64):
    """Seeded clips of the non-main paths (no JAX needed)."""
    rng = np.random.default_rng(7)
    if kind == "planar":
        from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame
        y0 = rng.integers(0, 200, (h, w), dtype=np.uint8)
        u = rng.integers(0, 200, (h // 2, w // 2), dtype=np.uint8)
        frames = []
        for i in range(n):
            y = y0.copy()
            y[8:16, 2 + 3 * i:10 + 3 * i] = 250
            up = np.repeat(np.repeat(u, 2, 0), 2, 1)
            frames.append(YUVFrame(np.stack([y, up, up], -1), {
                "format": "I420", "y_plane": y, "u_plane": u.copy(),
                "v_plane": u.copy()}))
        return frames
    dtype, c = {"uint16": (np.uint16, 3), "float32": (np.float32, 3),
                "bgra": (np.uint8, 4)}.get(kind, (np.uint8, 3))
    base = (rng.random((h, w, c)) * 200).astype(dtype)
    if dtype == np.float32:
        base[1, 2, 0] = np.nan
    frames = []
    for i in range(n):
        f = base.copy()
        f[8:20, 3 + 4 * i:13 + 4 * i] = 255
        m = rng.random((h, w)) < 0.02
        f[m] = 17 + i
        frames.append(f)
    return frames


OTHER = {
    "planar": ("planar", {"profile": "planar"}),
    "uint16": ("uint16", {}),
    "float32": ("float32", {}),
    "bgra": ("bgra", {}),
    "bfv2": ("rgb", {"profile": "bfv2"}),
    "near_lossless": ("rgb", {"exact": False}),
    "keyframe": ("rgb", {"mode": "keyframe"}),
}


@pytest.mark.parametrize("name", sorted(OTHER))
def test_other_paths_cuda_stream_equals_cpu_stream(dev, tmp_path, name):
    kind, kw = OTHER[name]
    frames = other_clip(kind)
    cs = "YUV" if kind == "planar" else "BGR"
    paths = []
    for d in (dev, "cpu"):
        paths.append(str(tmp_path / f"{d}.bfvc"))
        ImprovedVideoCompressor(device=d, keyframe_interval=8,
                                **kw).compress_video(frames, paths[-1],
                                                     input_color_space=cs)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    dec = ImprovedVideoCompressor(device=dev, **kw).decompress_video(paths[0])
    ref = ImprovedVideoCompressor(device="cpu", **kw).decompress_video(
        paths[0])
    for g, w, f in zip(dec, ref, frames):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        if name != "near_lossless":
            assert np.asarray(g).tobytes() == np.asarray(f).tobytes()


def test_bloom_ops_on_the_card_equal_cpu(dev):
    from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
        BloomFilterCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import median

    rng = np.random.default_rng(3)
    for density in (0.01, 0.1, 0.3, 0.5):
        bits = (rng.random(200 * 300) < density).astype(np.uint8)
        got = BloomFilterCompressor(device=dev).compress(bits)
        want = BloomFilterCompressor(device="cpu").compress(bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        k32 = float(np.float32(BloomFilterCompressor()
                               ._calculate_optimal_params(len(bits),
                                                          got[2])[0]))
        out = BloomFilterCompressor(device=dev).decompress(
            got[0], got[1], len(bits), k32)
        np.testing.assert_array_equal(out, bits)
    img = rng.integers(0, 256, (90, 120), dtype=np.uint8)
    assert torch.equal(median.median_blur(torch.from_numpy(img).to(dev)).cpu(),
                       median.median_blur(torch.from_numpy(img)))


# ---------------------------------------------------------------------------
# Files, the command line and the tools on the card
# ---------------------------------------------------------------------------

def test_cli_on_the_card_equals_cpu_and_reproduces_the_file(dev, tmp_path):
    """``compress`` / ``decompress`` with no ``--device`` run on the
    card: the CPU's ``.bfvc`` bytes, and the input file back."""
    from new_bloom_filter_repo_tpu_torch import cli
    from new_bloom_filter_repo_tpu_torch.utils import videoio

    frames = other_clip("planar")
    src = str(tmp_path / "in.y4m")
    videoio.write_y4m(src, [(f.yuv_info["y_plane"], f.yuv_info["u_plane"],
                             f.yuv_info["v_plane"]) for f in frames], 64, 48)
    for profile in ([], ["--profile", "planar"]):
        card, cpu = str(tmp_path / "card.bfvc"), str(tmp_path / "cpu.bfvc")
        bk.reset_launches()
        assert cli.main(["compress", src, card] + profile) == 0
        assert bk.launches()["blocked_encode_h"] > 0
        assert cli.main(["compress", src, cpu, "--device", "cpu"]
                        + profile) == 0
        with open(card, "rb") as a, open(cpu, "rb") as b:
            assert a.read() == b.read()
        back = str(tmp_path / "back.y4m")
        assert cli.main(["decompress", card, back]) == 0
        with open(src, "rb") as a, open(back, "rb") as b:
            assert a.read() == b.read()


def test_verify_harness_and_host_stages_on_the_card(dev, tmp_path):
    from new_bloom_filter_repo_tpu_torch import verify_harness as vh
    from new_bloom_filter_repo_tpu_torch.utils import profiling, videoio

    frames = other_clip("planar")
    src = str(tmp_path / "in.y4m")
    videoio.write_y4m(src, [(f.yuv_info["y_plane"], f.yuv_info["u_plane"],
                             f.yuv_info["v_plane"]) for f in frames], 64, 48)
    res = vh.test_true_lossless(src, ("YUV", "BGR"), max_frames=6,
                                verbose=False)
    assert res["all_passed"], res
    bk.reset_launches()
    clip = generate_frames(16, 96, 80, seed=0, **SUITE["static_gentle"])
    enc_s, dec_s, detail = profiling.measure_host_stages(clip)
    assert enc_s > 0 and dec_s > 0
    for key in profiling.ENC_HOST_KEYS + profiling.DEC_HOST_KEYS:
        assert key in detail
    launched = bk.launches()
    assert launched["blocked_encode_h"] and launched["blocked_membership_h"]


def test_stress_of_the_double_buffered_kernels(dev):
    """A short run of chip_smoke's phase 12: K1, K5a, K3 and K4 launched a
    few hundred times each, every launch equal to its twin."""
    import chip_smoke

    launched = chip_smoke.phase_stress(
        dev, rounds=(("quiet", 12), ("busy", 6), ("split", 6)), seed=77,
        nbs=(64, 65, 257, 513), fs=(1, 2, 15, 16, 17))
    assert launched == {name: 20 * 24 for name in chip_smoke.STRESS_KERNELS}


def test_32_lanes_on_the_card_equal_twins_and_33_raise(dev):
    """Frames whose floor(k) passes the cap (a damaged stream's) run 33
    lanes on the card as in the twins; a lane count past the cap never
    reaches a kernel."""
    args, kw = encode_args(dev, seed=4)
    fk = torch.tensor([40, 33, 20, 3], dtype=torch.int32, device=dev)
    args = args[:9] + (fk,)
    kw = dict(kw, k_lanes=bk.lane_count(40))
    assert kw["k_lanes"] == 32
    same(bk.blocked_encode_h(*args, **kw), bk.blocked_encode_h_ref(*args,
                                                                   **kw))
    words = bk.blocked_encode_h_ref(*args, **kw)[0]
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    mem = (words, *args[1:5], *args[6:10], flags)
    same(bk.blocked_membership_h(*mem, k_lanes=32, nw=12),
         bk.blocked_membership_h_ref(*mem, k_lanes=32, nw=12))
    with pytest.raises(ValueError, match="k_lanes"):
        bk.blocked_membership_h(*mem, k_lanes=33, nw=12)
    with pytest.raises(ValueError, match="k_lanes"):
        bk.blocked_encode_h(*args, **dict(kw, k_lanes=33))
    torch.cuda.synchronize()


def test_damaged_k_decodes_on_the_card_as_on_the_cpu(dev, tmp_path):
    """chip_smoke phase 15, short: a CIF stream whose first blocked
    record carries k = 2e6 decodes on the card within 30 s, through K2
    with 32 lanes, to the CPU decode's frames."""
    import struct
    import time

    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
    from new_bloom_filter_repo_tpu_torch.utils import container

    frames = generate_frames(16, 352, 288, seed=0, **SUITE["static_gentle"])
    ok = str(tmp_path / "ok.bfvc")
    ImprovedVideoCompressor(device=dev).compress_video(frames, ok)
    magic, payloads = container.read_bfvc(ok)
    i = next(j for j, p in enumerate(payloads)
             if fc.record_type(p) == fc.BLOCKED_Z)
    rec = bytearray(payloads[i])
    rec[9:13] = struct.pack("<f", 2e6)
    payloads[i] = bytes(rec)
    bad = str(tmp_path / "k2e6.bfvc")
    container.write_bfvc(bad, payloads, magic)
    bk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ImprovedVideoCompressor(device=dev).decompress_video(bad)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 30
    assert bk.launches()["blocked_membership_h"] > 0
    want = ImprovedVideoCompressor(device="cpu").decompress_video(bad)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_worker_threads_kernel_lies_in_its_span_on_the_trace_clock(
        dev, tmp_path):
    """Spans of the overlap worker are kept by the program, not traced;
    mapped onto the trace's clock through the main thread's spans
    (``portbench/programspans.py``), a kernel the worker launched
    inside its span starts after the span did."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile, record_function

    from new_bloom_filter_repo_tpu_torch.utils import profiling
    from portbench import programspans, tracestats
    from portbench.run import Record

    x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()

    def job():
        with profiling.span("nbf.pull_lazy"):
            time.sleep(0.002)
            return (x * 3).sum().cpu()

    with ThreadPoolExecutor(max_workers=1) as ex:
        ex.submit(lambda: None).result()
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("compress_video"):
                with profiling.span("nbf.compress"):
                    with profiling.span("nbf.wait_finish"):
                        got = ex.submit(job).result()
    assert got.item() == 3 * (1 << 20) * ((1 << 20) - 1) / 2
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    trace = tracestats.Trace.load(path)
    rec = Record([{"phase": "compress_video", "frames": 1}], 0.0, trace)
    (span,) = [s for s in programspans.mapped(rec)
               if s.name == "nbf.pull_lazy"]
    assert span.thread != threading.main_thread().ident
    inside = [k for k in trace.kernels if span.start <= k[0] <= span.end]
    assert inside, (span, trace.kernels)
    assert all(k[0] >= span.start for k in trace.kernels)
