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
