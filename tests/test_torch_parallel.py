"""The PyTorch port's multi-device paths on a CPU mesh.

Meshes repeat the CPU device (``make_mesh(dp, sp, ["cpu"] * dp * sp)``),
the counterpart of the JAX tests' virtual host devices, so each shard
runs the kernels' plain twins.  Every sharded program must equal the
unsharded wrapper on the same seeded inputs, exactly, for uneven shards
and empty shards too: the blocked factories (``parallel/blocked_batch``)
and the BFV2 ones (``parallel/batch``), which are also held to the JAX
package's sharded programs.
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


def test_unported_entry_points_raise(monkeypatch):
    """No entry point is left unported: ``initialize_distributed``, the
    last, now joins a process group (tests/test_torch_distributed.py).
    It still raises where it must: without arguments and without the
    rendezvous variables in the environment, and, asked for the card as
    by default, without one."""
    from new_bloom_filter_repo_tpu_torch.parallel import mesh

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="environment variable"):
        mesh.initialize_distributed(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mesh.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert mesh._DIST is None


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
    assert ImprovedVideoCompressor(devices=1, device="cpu").mesh is None
    assert ImprovedVideoCompressor(devices=(1, 1), device="cpu").mesh is None
    assert ImprovedVideoCompressor(devices=None, device="cpu").mesh is None
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
    for kwargs in ({"profile": "bfv2"}, {"exact": False},
                   {"profile": "planar"}, {"mode": "keyframe"}):
        comp = ImprovedVideoCompressor(devices=cpu_mesh(2, 1), **kwargs)
        assert comp.mesh.shape == {"dp": 2, "sp": 1}
        assert comp.bloom_compressor.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# parallel/batch.py: the BFV2 factories
# ---------------------------------------------------------------------------

def _bfv2_batch(n=2048, densities=(0.05, 0.12, 0.2, 0.29, 0.01, 0.08, 0.16,
                                   0.31)):
    """The batch of the JAX package's tests/test_parallel.py: bits and
    their per-frame (l, t_hi, t_lo, floor_k) as int64 tensors."""
    rng = np.random.default_rng(0)
    bits = np.stack([(rng.random(n) < d).astype(np.uint8)
                     for d in densities])
    return bits, graft_entry._filter_batch(bits)


BFV2_MESHES = [(1, 8), (2, 4), (4, 2), (8, 1), (3, 5)]


@pytest.mark.parametrize("layout", BFV2_MESHES,
                         ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_sharded_encode_decode_equal_unsharded(layout):
    """dp = 3 over 8 frames and sp = 5 over 2048 items are uneven."""
    from new_bloom_filter_repo_tpu_torch.ops import bloom_core as tbc
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        get_hash_tables)
    from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch

    n = 2048
    bits, scal = _bfv2_batch(n)
    t = get_hash_tables(n)
    tables = (*t.h1, *t.h2, *t.act)
    sc = [torch.from_numpy(x) for x in scal]
    l_pad = tbc.bitmap_pad(n)
    mesh = cpu_mesh(*layout)
    arrs, wit, counts = pbatch.make_sharded_encode(mesh, n, l_pad)(
        torch.from_numpy(bits), tables, *sc)
    for i in range(len(bits)):
        ref = tbc.encode_core(torch.from_numpy(bits[i]), t.h1, t.h2, t.act,
                              *(int(x[i]) for x in scal[:3]),
                              floor_k=int(scal[3][i]), l_pad=l_pad)
        assert torch.equal(arrs[i], ref[0])
        assert int(counts[i]) == int(ref[3])
        assert torch.equal(wit[i], ref[2])
    out = pbatch.make_sharded_decode(mesh, n, l_pad)(arrs, wit, tables, *sc)
    assert torch.equal(out, torch.from_numpy(bits))


def test_sharded_encode_equals_jax_sharded_encode():
    import jax
    import jax.numpy as jnp
    from new_bloom_filter_repo_tpu.ops.hashtables import get_hash_tables
    from new_bloom_filter_repo_tpu.parallel import batch as jbatch
    from new_bloom_filter_repo_tpu.parallel.mesh import make_mesh as jmesh
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        hash_tables_from_numpy)
    from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch

    n = 2048
    bits, scal = _bfv2_batch(n)
    jt = get_hash_tables(n, "video")
    l_pad = 768
    want = jbatch.make_sharded_encode(
        jmesh(2, 4, devices=jax.devices("cpu")), n, l_pad)(
            jnp.asarray(bits),
            (jt.h1[0], jt.h1[1], jt.h2[0], jt.h2[1], jt.act[0], jt.act[1]),
            *(jnp.asarray(x.astype(np.uint32)) for x in scal[:3]),
            jnp.asarray(scal[3].astype(np.int32)))
    tt = hash_tables_from_numpy(jt)
    got = pbatch.make_sharded_encode(cpu_mesh(2, 4), n, l_pad)(
        torch.from_numpy(bits), (*tt.h1, *tt.h2, *tt.act),
        *(torch.from_numpy(x) for x in scal))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dp", [2, 3])
def test_gop_factories_equal_unsharded(dp):
    """A 5-frame chunk over dp = 2 (3 + 2) and dp = 3 (2 + 2 + 1)."""
    from new_bloom_filter_repo_tpu_torch.models import gop
    from new_bloom_filter_repo_tpu_torch.ops import bloom_core as tbc
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        get_hash_tables)
    from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch
    from test_torch_bloom_core import chunk_scalars, gop_chunk

    frames = torch.from_numpy(gop_chunk(False))
    n = frames.shape[1] * frames.shape[2]
    mesh = cpu_mesh(dp, 1)
    want = gop.gop_masks(frames)
    got = pbatch.make_gop_masks_dp(mesh)(frames[:-1], frames[1:])
    _assert_same(tuple(got), tuple(want))
    l, thi, tlo, fk, flags = chunk_scalars(want[2].numpy(), n)
    sc = [torch.from_numpy(x.astype(np.int64)) for x in (l, thi, tlo, fk)]
    t = get_hash_tables(n)
    kw = {"l_pad": tbc.bitmap_pad(n), "vmax": 1024}
    enc = gop.gop_encode(want[0], frames[1:], t.h1, t.h2, t.act, *sc, **kw)
    _assert_same(tuple(pbatch.make_gop_encode_dp(mesh, **kw)(
        want[0], frames[1:], t.h1, t.h2, t.act, *sc)), tuple(enc))
    bitmaps = torch.nn.functional.pad(
        enc[0], (0, want[1].shape[1] - enc[0].shape[1]))
    pbm = torch.where(torch.from_numpy(flags)[:, None] > 0, want[1], bitmaps)
    fargs = (pbm, enc[1], enc[3], torch.from_numpy(flags), t.h1, t.h2,
             t.act, *sc)
    fields = gop.gop_decode_fields(*fargs, n=n, vmax=1024)
    _assert_same(tuple(pbatch.make_gop_decode_fields_dp(
        mesh, n=n, vmax=1024)(*fargs)), tuple(fields))


def test_shard_batch_arrays_layout():
    from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch

    bits = torch.arange(5 * 10, dtype=torch.int64).view(5, 10)
    tables = (torch.arange(10), torch.arange(10) * 2)
    scalars = (torch.arange(5),)
    b, t, s = pbatch.shard_batch_arrays(cpu_mesh(2, 3), bits, tables,
                                        scalars)
    assert [[x.shape for x in row] for row in b] == [
        [(3, 4), (3, 3), (3, 3)], [(2, 4), (2, 3), (2, 3)]]
    assert torch.equal(b[1][2], bits[3:, 7:])
    assert torch.equal(t[1][0][2], tables[1][7:])
    assert torch.equal(s[0][1][0], scalars[0][3:])


@pytest.mark.parametrize("layout", [(4, 1), (2, 2)],
                         ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_dryrun_multichip_on_a_cpu_mesh(layout, capsys):
    out = graft_entry.dryrun_multichip(cpu_mesh(*layout))
    printed = capsys.readouterr().out
    dp, sp = layout
    assert (f"dryrun_multichip OK: mesh dp={dp} sp={sp}, batch={2 * dp}, "
            f"n={512 * sp}") in printed
    assert "blocked-dp OK" in printed
    assert torch.equal(out["decoded"], out["bits"])


def test_entry_step_equals_jax_entry():
    import jax
    import __graft_entry__ as jentry

    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    got = fn(*args)
    want = [np.asarray(w) for w in jax.jit(jfn)(*jargs)]
    l = int(args[7])
    # the bit arrays differ only in their zero pad (bloom_core.bitmap_pad)
    np.testing.assert_array_equal(got[0][:l].numpy(), want[0][:l])
    assert not got[0][l:].any() and not want[0][l:].any()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[2]) > 0


def test_dryrun_multichip_with_a_count_needs_the_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("the machine has two CUDA cards")
    with pytest.raises(ValueError, match="need 2 cuda devices"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("profile", ["bfv2", "planar"])
def test_devices_mesh_equals_jax_single_device(tmp_path, monkeypatch,
                                               profile):
    """devices= on CPU meshes: the stream equals the JAX package's
    single-device file, decodes bit-exactly through the mesh, and (bfv2)
    runs the sharded gop stages."""
    from new_bloom_filter_repo_tpu.models.video import (
        ImprovedVideoCompressor as JaxCompressor)
    from new_bloom_filter_repo_tpu_torch.parallel import batch as pbatch
    from test_torch_profiles import yuv_clip
    from test_video_api import make_video

    calls = []
    for name in ("make_gop_masks_dp", "make_gop_encode_dp",
                 "make_gop_decode_fields_dp"):
        real = getattr(pbatch, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(pbatch, name, spy)
    if profile == "bfv2":
        frames, cs, kw = make_video(n=20, h=48, w=64, seed=7), "BGR", {
            "profile": "bfv2", "keyframe_interval": 8}
    else:
        frames, cs, kw = yuv_clip("I420"), "YUV", {
            "profile": "planar", "keyframe_interval": 5}
    jpath, tpath = str(tmp_path / "jax.bfvc"), str(tmp_path / "mesh.bfvc")
    JaxCompressor(**kw).compress_video(frames, jpath, input_color_space=cs)
    comp = ImprovedVideoCompressor(devices=cpu_mesh(3, 2), **kw)
    comp.compress_video(frames, tpath, input_color_space=cs)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    for g, w in zip(comp.decompress_video(tpath), frames):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if profile == "bfv2":
        assert set(calls) == {"make_gop_masks_dp", "make_gop_encode_dp",
                              "make_gop_decode_fields_dp"}
