"""K1-K5b and the port's main and mesh paths on an NVIDIA card.

Marked ``cuda``: each test skips without a card.  On the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX, which the
card's machine need not have).  This file imports no JAX: the kernels
are held to their plain PyTorch twins, which the CPU tests hold to the
JAX Pallas kernels.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
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
                             "blocked_membership": 0}


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
