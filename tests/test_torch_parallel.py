"""The PyTorch port's multi-device blocked path on a CPU mesh.

Meshes repeat the CPU device (``make_mesh(dp, sp, ["cpu"] * dp * sp)``),
the counterpart of the JAX tests' virtual host devices, so each shard
runs the kernels' plain twins.  Every sharded program must equal the
unsharded wrapper on the same seeded inputs, exactly, for uneven shards
and empty shards too.
"""

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu_torch import graft_entry
from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch as bb
from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    make_mesh,
)
from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
    SUITE,
    generate_frames,
)

IPB = bk.IPB
MESHES = [(4, 1), (2, 2), (1, 4)]
KW = {"k_lanes": 3, "vh": 8, "nw": 12}


def cpu_mesh(dp, sp):
    return make_mesh(dp, sp, ["cpu"] * (dp * sp))


def kernel_inputs(f=3, nb=6, seed=0):
    """Seeded inputs of every blocked kernel: F frames of NB blocks, m
    16/100/384, floor k 0/2/3, the middle frame flagged with a raw
    mask, the decode inputs taken from the unsharded encode."""
    rng = np.random.default_rng(seed)
    ms = np.array([16, 100, 384, 64][:f], np.int32)
    fk = np.array([0, 2, 3, 1][:f], np.int32)
    bits = (rng.random((f, nb, IPB)) < 0.05).astype(np.uint8)

    def i32(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    h1, h2 = i32(0, 1 << 24, (nb, IPB)), i32(0, 1 << 24, (nb, IPB))
    ahi, alo = i32(-(1 << 31), 1 << 31, (nb, IPB)), i32(-(1 << 31), 1 << 31,
                                                        (nb, IPB))
    thi, tlo = i32(-(1 << 31), 1 << 31, f), i32(-(1 << 31), 1 << 31, f)
    m, fk = torch.from_numpy(ms), torch.from_numpy(fk)
    bits = torch.from_numpy(bits)
    vals = i32(0, 1 << 24, (f, nb, IPB))
    a, b, act = bp._frame_mod_tables(h1, h2, ahi, alo, m, thi, tlo)
    words, wit, _, vseg, _ = bk.blocked_encode_h(
        bits, h1, h2, ahi, alo, vals, m, thi, tlo, fk, **KW)
    flags = torch.zeros(f, dtype=torch.int32)
    flags[f // 2] = 1
    raw = torch.zeros_like(bits)
    raw[f // 2] = torch.from_numpy(
        (rng.random((nb, IPB)) < 0.03).astype(np.uint8))
    passes, _ = bk.blocked_membership_h(
        words, h1, h2, ahi, alo, m, thi, tlo, fk, flags,
        k_lanes=KW["k_lanes"], nw=KW["nw"])
    return dict(bits=bits, h1=h1, h2=h2, ahi=ahi, alo=alo, vals=vals, m=m,
                thi=thi, tlo=tlo, fk=fk, a=a, b=b, act=act, words=words,
                wit=wit, vseg=vseg, flags=flags, raw=raw, passes=passes)


def _decode_unsharded(words, a, b, act, m, fk, flags, wit, raw, vseg, *,
                      k_lanes, vh, nw):
    passes, wcnt = bk.blocked_membership(words, a, b, act, m, fk, flags,
                                         k_lanes=k_lanes, nw=nw)
    return (passes, wcnt) + bk.blocked_expand(passes, wit, raw, flags, vseg,
                                              vh=vh)


ENC = {"k_lanes": KW["k_lanes"], "vh": KW["vh"], "nw": KW["nw"]}
MEM = {"k_lanes": KW["k_lanes"], "nw": KW["nw"]}
# name: (dp factory, dpsp factory, unsharded function, factory kwargs,
#        argument names in the wrapper's order)
FACTORIES = {
    "encode": (bb.make_blocked_encode_dp, bb.make_blocked_encode_dpsp,
               bk.blocked_encode, ENC,
               "bits a b act vals m fk"),
    "encode_h": (bb.make_blocked_encode_h_dp, bb.make_blocked_encode_h_dpsp,
                 bk.blocked_encode_h, ENC,
                 "bits h1 h2 ahi alo vals m thi tlo fk"),
    "membership_h": (bb.make_blocked_membership_h_dp,
                     bb.make_blocked_membership_h_dpsp,
                     bk.blocked_membership_h, MEM,
                     "words h1 h2 ahi alo m thi tlo fk flags"),
    "decode": (bb.make_blocked_decode_dp, bb.make_blocked_decode_dpsp,
               _decode_unsharded, ENC,
               "words a b act m fk flags wit raw vseg"),
    "membership": (bb.make_blocked_membership_dp,
                   bb.make_blocked_membership_dpsp, bk.blocked_membership,
                   MEM, "words a b act m fk flags"),
    "expand": (bb.make_blocked_expand_dp, bb.make_blocked_expand_dpsp,
               bk.blocked_expand, {"vh": KW["vh"]},
               "passes wit raw flags vseg"),
}


@pytest.fixture(scope="module")
def inputs():
    return kernel_inputs()


def _assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", MESHES, ids=lambda x: f"dp{x[0]}sp{x[1]}")
@pytest.mark.parametrize("variant", ["dp", "dpsp"])
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_equals_unsharded(inputs, name, variant, layout):
    """F = 3 frames over dp = 4 leaves one shard empty and over dp = 2
    splits 2 + 1; NB = 6 blocks over sp = 4 split 2 + 2 + 1 + 1."""
    make_dp, make_dpsp, fn, kw, argnames = FACTORIES[name]
    make = make_dp if variant == "dp" else make_dpsp
    args = [inputs[k] for k in argnames.split()]
    prog = make(cpu_mesh(*layout), **kw)
    _assert_same(prog(*args), fn(*args, **kw))


@pytest.mark.parametrize("name", ["encode_h", "decode"])
def test_dpsp_with_an_empty_block_shard(name):
    """NB = 3 blocks over sp = 4: one block shard is empty."""
    inp = kernel_inputs(f=2, nb=3, seed=5)
    _, make, fn, kw, argnames = FACTORIES[name]
    args = [inp[k] for k in argnames.split()]
    _assert_same(make(cpu_mesh(2, 4), **kw)(*args), fn(*args, **kw))


def test_factory_checks_its_argument_count(inputs):
    prog = bb.make_blocked_expand_dp(cpu_mesh(2, 1), vh=8)
    with pytest.raises(TypeError, match="expected 5 arguments"):
        prog(inputs["passes"])


# ---------------------------------------------------------------------------
# _MeshDispatch: the product route of devices=
# ---------------------------------------------------------------------------

def _chunk(name="pan", f=16, w=64, h=48):
    frames = generate_frames(f, w, h, seed=0, **SUITE[name])
    return torch.from_numpy(np.stack(frames))


def test_mesh_dispatch_sp4_equals_unsharded_kernels():
    """One small frame with its blocks over sp = 4: the counterpart of
    the JAX package's dpsp product-path test."""
    stacked = _chunk("static_gentle", f=2, w=96, h=80)       # one frame
    n = 96 * 80
    tab = blocked_tables(n)
    masks, counts, vals = bp._phase_a(stacked, npad=tab["npad"],
                                      nb=tab["nb"])
    kinds, _, m_arr, fk_arr, thi, tlo, geom = bp.chunk_params(
        counts.numpy(), n, tab["nb"])
    assert kinds == ["blocked"] and tab["nb"] == 8
    scal = bp.frame_scalars("cpu", m_arr, thi, tlo, fk_arr)
    md = bp._MeshDispatch(cpu_mesh(1, 4))
    got = md.encode(masks, vals, tab, *scal, channels=3, **geom)
    w, wi, wc, vs, vc = bk.blocked_encode_h(
        masks, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], vals,
        *scal, **geom)
    _assert_same(got, (w, wi, wc, bp._pack_vseg_bytes(vs, 3), vc))
    words = torch.zeros((1, tab["nb"], bk.NW), dtype=torch.int32)
    words[..., :w.shape[-1]] = w
    flags = torch.zeros(1, dtype=torch.int32)
    mem_kw = {"k_lanes": geom["k_lanes"], "nw": geom["nw"]}
    got = md.membership(words, tab, *scal, flags, **mem_kw)
    passes, wcnt = bk.blocked_membership_h(
        words, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], *scal,
        flags, **mem_kw)
    _assert_same(got, (passes, wcnt))
    raw = torch.zeros_like(masks)
    got = md.expand(passes, wi, raw, flags, bp._pack_vseg_bytes(vs, 3),
                    vh=geom["vh"], channels=3)
    mask, _ = want = bk.blocked_expand(passes, wi, raw, flags, vs,
                                       vh=geom["vh"])
    _assert_same(got, want)
    assert torch.equal(mask, masks)


@pytest.mark.parametrize("dp", [2, 4])
def test_mesh_dispatch_phase_a_under_dp(dp):
    """Phase A sharded over frames on a 15-frame pan chunk (dp = 2
    splits it 8 + 7): every output, the motion shifts included, equals
    the unsharded pass."""
    stacked = _chunk("pan")
    tab = blocked_tables(64 * 48)
    npad, nb = tab["npad"], tab["nb"]
    md = bp._MeshDispatch(cpu_mesh(dp, 1))
    want = bp._phase_a_auto(stacked, stride=4, npad=npad, nb=nb)
    got = md.phase_a_auto(stacked, 4, npad=npad, nb=nb)
    _assert_same(got, want)
    assert want[3].abs().sum() > 0          # the pan chunk has shifts
    _assert_same(md.phase_a(stacked, npad=npad, nb=nb),
                 bp._phase_a(stacked, npad=npad, nb=nb))
    shifts = want[3]
    _assert_same(md.phase_a_motion(stacked, shifts, npad=npad, nb=nb),
                 bp._phase_a_motion_pair(stacked[:-1], stacked[1:], shifts,
                                         npad=npad, nb=nb))
    _assert_same(md.motion_counts(stacked, 4),
                 bp._motion_counts_pair(stacked[:-1], stacked[1:], 4))


@pytest.mark.parametrize("name", ["static_gentle", "pan"])
def test_mesh_decode_routes(monkeypatch, tmp_path, name):
    """Under a mesh, runs without motion decode through K3 on the home
    device and runs with motion through the sharded K4 and the roll
    chain; both bit-exact."""
    frames = generate_frames(16, 64, 48, seed=0, **SUITE[name])
    comp = ImprovedVideoCompressor(devices=cpu_mesh(2, 2))
    path = str(tmp_path / "mesh.bfvc")
    comp.compress_video(frames, path)
    calls = {"k3": 0, "k4": 0}
    k3, k4 = bk.blocked_expand_chain, bp._MeshDispatch.expand

    def spy_k3(*args, **kw):
        calls["k3"] += 1
        return k3(*args, **kw)

    def spy_k4(self, *args, **kw):
        calls["k4"] += 1
        return k4(self, *args, **kw)

    monkeypatch.setattr(bk, "blocked_expand_chain", spy_k3)
    monkeypatch.setattr(bp._MeshDispatch, "expand", spy_k4)
    dec = comp.decompress_video(path)
    assert len(dec) == len(frames)
    for got, want in zip(dec, frames):
        np.testing.assert_array_equal(np.asarray(got), want)
    if name == "pan":
        assert calls["k4"] > 0
    else:
        assert calls["k3"] > 0 and calls["k4"] == 0


# ---------------------------------------------------------------------------
# Dry run and mesh validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [(4, 1), (2, 2)],
                         ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_dryrun_blocked_dp(layout, capsys):
    out = graft_entry.dryrun_blocked_dp(cpu_mesh(*layout), nb=8)
    dp = layout[0]
    assert f"blocked-dp OK: frames={2 * dp} over dp={dp}" in \
        capsys.readouterr().out
    bits = out["args"][0]
    assert torch.equal(out["decoded"][2], bits)
    want = bk.blocked_encode(*out["args"], k_lanes=2, vh=4)
    _assert_same(out["encoded"], want)


def test_unported_entry_points_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        graft_entry.entry()
    with pytest.raises(NotImplementedError, match="item 10"):
        graft_entry.dryrun_multichip(8)
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
        initialize_distributed)
    with pytest.raises(NotImplementedError, match="item 11"):
        initialize_distributed()


def test_auto_mesh_raises_without_enough_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("the machine has two CUDA cards")
    with pytest.raises(ValueError, match="need 2 cuda devices"):
        auto_mesh(2)
    with pytest.raises(ValueError, match="need 2 cpu devices"):
        auto_mesh(2, device_type="cpu")
    assert auto_mesh(device_type="cpu").shape == {"dp": 1, "sp": 1}


def test_make_mesh_layout():
    mesh = make_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.size == 8
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.home == torch.device("cpu")
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh(4, 2, ["cpu"] * 7)
    with pytest.raises(ValueError):
        Mesh([["cpu", "cpu"], ["cpu"]])


def test_devices_option_resolution():
    with pytest.raises(ValueError):
        ImprovedVideoCompressor(devices="everything")
    assert ImprovedVideoCompressor(devices=1).mesh is None
    assert ImprovedVideoCompressor(devices=(1, 1)).mesh is None
    assert ImprovedVideoCompressor(devices=None).mesh is None
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="cuda devices"):
            ImprovedVideoCompressor(devices=(4, 2))
    comp = ImprovedVideoCompressor(devices=make_mesh(4, 2, ["cpu"] * 8))
    assert comp.mesh.shape == {"dp": 4, "sp": 2}
    assert comp.device == torch.device("cpu")
    assert comp._blocked_enc.dispatch is not None
    assert ImprovedVideoCompressor(devices="auto",
                                   device="cpu").mesh.size == 1
    with pytest.raises(ValueError, match="device type"):
        ImprovedVideoCompressor(devices=cpu_mesh(2, 1), device="cuda")
    for kwargs in ({"profile": "bfv2"}, {"exact": False}):
        with pytest.raises(NotImplementedError, match="item 10"):
            ImprovedVideoCompressor(devices=cpu_mesh(2, 1), **kwargs)
