"""The PyTorch port's blocked kernels K1-K5b against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch twins; the JAX
kernels run in Pallas interpret mode (tests/conftest.py pins JAX to the
CPU).  The same seeded numpy inputs go through both packages, and every
output must be equal (tolerance 0): all of it is integer bit work.
The JAX encode leaves compaction leftovers in value slots beyond a
block's count, so value segments are compared up to ``vcnt`` only.
"""

import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
from new_bloom_filter_repo_tpu.ops.pallas import blocked as jbk
from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as tbp
from new_bloom_filter_repo_tpu_torch.ops import blocked as tbk
from test_torch_cuda import expand_edge_inputs

IPB = 1024


def make_inputs(f, nb, ms, fks, dens, act_mode, seed):
    """Seeded kernel inputs.  ``act_mode``: "random" thresholds, "off"
    (threshold 0: the activation lane never fires) or "on" (threshold
    2^64 - 1: it fires for every item but the all-ones hash)."""
    rng = np.random.default_rng(seed)
    bits = (rng.random((f, nb, IPB))
            < np.asarray(dens, np.float64).reshape(-1, 1, 1)
            ).astype(np.uint8)
    u32 = np.iinfo(np.uint32).max
    tab = {"h1": rng.integers(0, 1 << 24, (nb, IPB)).astype(np.int32),
           "h2": rng.integers(0, 1 << 24, (nb, IPB)).astype(np.int32),
           "act_hi": rng.integers(0, u32, (nb, IPB), dtype=np.uint32,
                                  endpoint=True),
           "act_lo": rng.integers(0, u32, (nb, IPB), dtype=np.uint32,
                                  endpoint=True)}
    vals = rng.integers(0, 1 << 24, (f, nb, IPB)).astype(np.int32)
    if act_mode == "random":
        thi = rng.integers(0, u32, f, dtype=np.uint32, endpoint=True)
        tlo = rng.integers(0, u32, f, dtype=np.uint32, endpoint=True)
    else:
        fill = 0 if act_mode == "off" else u32
        thi = np.full(f, fill, np.uint32)
        tlo = np.full(f, fill, np.uint32)
    return (bits, tab, vals, np.asarray(ms, np.int32),
            np.asarray(fks, np.int32), thi, tlo)


def t(a):
    """numpy -> CPU tensor; u32 arrays travel as int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def n(x):
    return np.asarray(x)


CASES = {
    # (F, NB, m per frame, floor_k per frame, density, activation)
    "mixed": (3, 8, [16, 100, 384], [0, 2, 5], [0.01, 0.06, 0.2],
              "random"),
    "m16_fk0_act_on": (2, 8, [16, 16], [0, 0], [0.002, 0.03], "on"),
    "m384_act_off": (2, 8, [384, 257], [3, 0], [0.3, 0.1], "off"),
    "dense_k12": (2, 16, [300, 64], [12, 7], [0.15, 0.04], "random"),
}


@pytest.fixture(params=sorted(CASES), scope="module")
def case(request):
    f, nb, ms, fks, dens, act = CASES[request.param]
    bits, tab, vals, m, fk, thi, tlo = make_inputs(
        f, nb, ms, fks, dens, act, seed=sorted(CASES).index(request.param))
    kmax = int(fk.max())
    nw = (int(m.max()) + 31) // 32
    vh = tbk.IPB // 32 if int(bits.sum(axis=2).max()) > 128 else 4
    jout = [n(x) for x in jbk.blocked_encode_h(
        bits, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], vals, m,
        thi, tlo, fk, k_lanes=jbk.k_bucket(kmax), vh=vh,
        nw=jbk.nw_bucket(int(m.max())))]
    targs = (t(bits), t(tab["h1"]), t(tab["h2"]), t(tab["act_hi"]),
             t(tab["act_lo"]), t(vals), t(m), t(thi), t(tlo), t(fk))
    tout = [n(x) for x in tbk.blocked_encode_h(*targs, k_lanes=kmax,
                                                vh=vh, nw=nw)]
    return {"bits": bits, "tab": tab, "vals": vals, "m": m, "fk": fk,
            "thi": thi, "tlo": tlo, "kmax": kmax, "nw": nw, "vh": vh,
            "jout": jout, "tout": tout, "targs": targs}


def test_k1_encode_matches_pallas(case):
    jw, jwit, jwcnt, jvseg, jvcnt = case["jout"]
    tw, twit, twcnt, tvseg, tvcnt = case["tout"]
    nw = case["nw"]
    assert tw.dtype == np.int32 and tw.shape[-1] == nw
    np.testing.assert_array_equal(tw, jw[..., :nw])
    assert (jw[..., nw:] == 0).all()          # bucket words beyond m
    np.testing.assert_array_equal(twit, jwit)
    np.testing.assert_array_equal(twcnt, jwcnt)
    np.testing.assert_array_equal(tvcnt, jvcnt)
    assert tvseg.shape == jvseg.shape
    cnt = np.minimum(tvcnt, tvseg.shape[-1])
    live = np.arange(tvseg.shape[-1]) < cnt[..., None]
    np.testing.assert_array_equal(tvseg[live], jvseg[live])
    # witness bytes past ceil(wcnt / 8) are zero in both packages
    used = np.arange(tbk.WIT_BYTES) < ((twcnt + 7) // 8)[..., None]
    assert (twit[~used] == 0).all()
    # every changed item passes its own filter
    assert (twcnt >= case["bits"].sum(axis=2)).all()


@pytest.mark.parametrize("flagged", [False, True])
def test_k2_membership_matches_pallas(case, flagged):
    jw = case["jout"][0]
    f = jw.shape[0]
    flags = np.zeros(f, np.int32)
    if flagged:
        flags[::2] = 1
    tab = case["tab"]
    m, fk, thi, tlo = case["m"], case["fk"], case["thi"], case["tlo"]
    jp, jc = jbk.blocked_membership_h(
        jw, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], m, thi,
        tlo, fk, flags, k_lanes=jbk.k_bucket(case["kmax"]),
        nw=jbk.nw_bucket(int(m.max())))
    # the port takes words padded to NW, as the decoder parses them
    words = np.zeros(jw.shape[:2] + (tbk.NW,), np.int32)
    words[..., :jw.shape[-1]] = jw
    tp, tc = tbk.blocked_membership_h(
        t(words), *case["targs"][1:5], t(m), t(thi), t(tlo), t(fk),
        t(flags), k_lanes=case["kmax"], nw=case["nw"])
    assert tp.dtype == torch.uint8 and tc.dtype == torch.int32
    np.testing.assert_array_equal(n(tp), n(jp))
    np.testing.assert_array_equal(n(tc), n(jc))
    if not flagged:
        np.testing.assert_array_equal(n(tc), case["tout"][2])


def _expand_inputs(case, flagged, seed=7):
    bits = case["bits"]
    f = bits.shape[0]
    jw = case["jout"][0]
    tab = case["tab"]
    flags = np.zeros(f, np.int32)
    raw = np.zeros_like(bits)
    if flagged:
        flags[-1] = 1
        rng = np.random.default_rng(seed)
        raw[-1] = (rng.random(bits.shape[1:]) < 0.05).astype(np.uint8)
    passes, _ = jbk.blocked_membership_h(
        jw, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"], case["m"],
        case["thi"], case["tlo"], case["fk"], flags,
        k_lanes=jbk.k_bucket(case["kmax"]),
        nw=jbk.nw_bucket(int(case["m"].max())))
    return n(passes), case["jout"][1], raw, flags, case["jout"][3]


@pytest.mark.parametrize("flagged", [False, True])
def test_k3_expand_chain_matches_pallas(case, flagged):
    passes, wit, raw, flags, vseg = _expand_inputs(case, flagged)
    base = case["vals"][0][::-1].copy()
    vh = case["vh"]
    want = jbk.blocked_expand_chain(passes, wit, raw, flags, vseg, base,
                                    vh=vh)
    got = tbk.blocked_expand_chain(t(passes), t(wit), t(raw), t(flags),
                                   t(vseg), t(base), vh=vh)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), n(want))
    if not flagged:     # decode of an unflagged encode is the input
        last = np.where(case["bits"][-1] > 0, case["vals"][-1], n(got)[-1])
        np.testing.assert_array_equal(n(got)[-1], last)


@pytest.mark.parametrize("flagged", [False, True])
def test_k4_expand_matches_pallas(case, flagged):
    passes, wit, raw, flags, vseg = _expand_inputs(case, flagged)
    vh = case["vh"]
    jm, jv = jbk.blocked_expand(passes, wit, raw, flags, vseg, vh=vh)
    tm, tv = tbk.blocked_expand(t(passes), t(wit), t(raw), t(flags),
                                t(vseg), vh=vh)
    assert tm.dtype == torch.uint8 and tv.dtype == torch.int32
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_array_equal(n(tv), n(jv))
    if not flagged:
        np.testing.assert_array_equal(n(tm), case["bits"])


# K3/K4 on inputs made directly (test_torch_cuda.expand_edge_inputs),
# at sizes Pallas interpret mode runs quickly, NB a multiple of the
# Pallas tile of 8 blocks (NB = 1 and 2033 run on the card, against the
# twins): (F, NB, vh, pass densities by frame, flagged frames).
EXPAND_EDGES = {
    "all_pass_all_bits": (2, 8, 32, [1.0], []),
    "none_pass": (2, 8, 4, [0.0], []),
    "slots_overflow_vh1": (3, 8, 1, [0.6, 0.9, 0.3], []),
    "alternating_flags": (4, 8, 4, [0.5], [1, 3]),
    "f1": (1, 8, 8, [0.5], []),
    "f17": (17, 8, 4, [1.0, 0.0, 0.5, 0.05], range(1, 17, 2)),
}


@pytest.mark.parametrize("edge", sorted(EXPAND_EDGES))
def test_k3_k4_edge_inputs_match_pallas(edge):
    f, nb, vh, dens, flagged = EXPAND_EDGES[edge]
    passes, wit, raw, flags, vseg, base = expand_edge_inputs(
        f, nb, vh, dens, flagged, seed=sorted(EXPAND_EDGES).index(edge))
    jm, jv = jbk.blocked_expand(passes, wit, raw, flags, vseg, vh=vh)
    tm, tv = tbk.blocked_expand(t(passes), t(wit), t(raw), t(flags),
                                t(vseg), vh=vh)
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_array_equal(n(tv), n(jv))
    want = jbk.blocked_expand_chain(passes, wit, raw, flags, vseg, base,
                                    vh=vh)
    got = tbk.blocked_expand_chain(t(passes), t(wit), t(raw), t(flags),
                                   t(vseg), t(base), vh=vh)
    np.testing.assert_array_equal(n(got), n(want))
    # the inputs are the edges they are named for
    changed = n(tm).sum(axis=2)
    if edge == "all_pass_all_bits":
        assert (changed[:, 0] == IPB).all()       # rank 1023 reads bit 1023
    if edge == "none_pass":
        assert (changed == 0).all()
    if edge == "slots_overflow_vh1":
        assert (changed > vh * 32).any()
        past = np.cumsum(n(tm), axis=2) > vh * 32
        assert (n(tv)[past] == 0).all()


def test_words_bits_helpers_match_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(-(1 << 31), 1 << 31, (3, 5, 12), dtype=np.int64
                         ).astype(np.int32)
    words[0, 0, 0] = np.int32(-(1 << 31))          # only bit 31 set
    bits = n(tbk.words32_to_bits(t(words)))
    np.testing.assert_array_equal(bits, n(jbk.words32_to_bits(words)))
    assert bits[0, 0, 0] == 1 and bits[0, 0, 1:32].sum() == 0
    back = tbk.bits_to_words32(t(bits))
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(n(back), words)
    np.testing.assert_array_equal(n(back), n(jbk.bits_to_words32(bits)))


def test_witness_byte_order_matches_jax():
    rng = np.random.default_rng(4)
    witw = rng.integers(-(1 << 31), 1 << 31, (2, 3, tbk.WW), dtype=np.int64
                        ).astype(np.int32)
    by = n(tbk._witwords_to_bytes(t(witw)))
    np.testing.assert_array_equal(by, n(jbk._witwords_to_bytes(witw)))
    # MSB-first bit order: the bytes equal big-endian u32 words
    np.testing.assert_array_equal(
        by.reshape(-1), witw.astype(">u4").view(np.uint8).reshape(-1))
    np.testing.assert_array_equal(n(tbk._bytes_to_witwords(t(by))), witw)


def test_constants_match_jax():
    assert (tbk.IPB, tbk.NW, tbk.MMAX, tbk.WIT_BYTES, tbk.WW) == (
        jbk.IPB, jbk.NW, jbk.MMAX, jbk.WIT_BYTES, jbk.WW)


def test_non_cpu_non_cuda_tensor_raises():
    """The wrappers take the twin only for a CPU tensor: any other
    device reaches the kernel path or raises, never the twin."""
    meta = torch.empty((1, 8, IPB), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbk.blocked_expand(meta, meta, meta, meta, meta, vh=1)


def test_cpu_calls_do_not_count_launches():
    tbk.reset_launches()
    passes = torch.zeros((1, 8, IPB), dtype=torch.uint8)
    wit = torch.zeros((1, 8, tbk.WIT_BYTES), dtype=torch.uint8)
    flags = torch.zeros(1, dtype=torch.int32)
    vseg = torch.zeros((1, 8, 32), dtype=torch.int32)
    tbk.blocked_expand(passes, wit, passes, flags, vseg, vh=1)
    assert tbk.launches() == {"blocked_encode_h": 0,
                              "blocked_membership_h": 0,
                              "blocked_expand_chain": 0,
                              "blocked_expand": 0,
                              "blocked_encode": 0,
                              "blocked_membership": 0,
                              "phase_a_diff": 0,
                              "motion_counts": 0,
                              "tile_motion_best": 0}


# ---------------------------------------------------------------------------
# K5a / K5b: the kernels on materialized position tables
# ---------------------------------------------------------------------------

K5_CASES = {
    # (F, NB, m per frame, floor_k per frame, change density, act density)
    "f3_nb8": (3, 8, [16, 100, 384], [0, 2, 3], [0.02, 0.06, 0.2], 0.3),
    "f4_nb16": (4, 16, [100, 384, 16, 100], [1, 3, 0, 2],
                [0.01, 0.1, 0.003, 0.25], 0.4),
}


@pytest.fixture(params=sorted(K5_CASES), scope="module")
def k5case(request):
    f, nb, ms, fks, dens, act_dens = K5_CASES[request.param]
    rng = np.random.default_rng(10 + sorted(K5_CASES).index(request.param))
    m = np.asarray(ms, np.int32)
    fk = np.asarray(fks, np.int32)
    bits = (rng.random((f, nb, IPB))
            < np.asarray(dens).reshape(-1, 1, 1)).astype(np.uint8)
    a = np.stack([rng.integers(0, mm, (nb, IPB)) for mm in ms]
                 ).astype(np.int32)
    b = np.stack([rng.integers(0, mm, (nb, IPB)) for mm in ms]
                 ).astype(np.int32)
    act = (rng.random((f, nb, IPB)) < act_dens).astype(np.uint8)
    vals = rng.integers(0, 1 << 24, (f, nb, IPB)).astype(np.int32)
    kmax = int(fk.max())
    nw = (int(m.max()) + 31) // 32
    vh = 32 if int(bits.sum(axis=2).max()) > 128 else 4
    jout = [n(x) for x in jbk.blocked_encode(
        bits, a, b, act, vals, m, fk, k_lanes=jbk.k_bucket(kmax), vh=vh,
        nw=jbk.nw_bucket(int(m.max())))]
    targs = tuple(t(x) for x in (bits, a, b, act, vals, m, fk))
    tout = [n(x) for x in tbk.blocked_encode(*targs, k_lanes=kmax, vh=vh,
                                              nw=nw)]
    return {"bits": bits, "kmax": kmax, "nw": nw, "vh": vh, "jout": jout,
            "tout": tout, "targs": targs}


def test_k5a_encode_matches_pallas(k5case):
    jw, jwit, jwcnt, jvseg, jvcnt = k5case["jout"]
    tw, twit, twcnt, tvseg, tvcnt = k5case["tout"]
    nw = k5case["nw"]
    assert tw.dtype == np.int32 and tw.shape[-1] == nw
    np.testing.assert_array_equal(tw, jw[..., :nw])
    np.testing.assert_array_equal(twit, jwit)
    np.testing.assert_array_equal(twcnt, jwcnt)
    np.testing.assert_array_equal(tvcnt, jvcnt)
    live = np.arange(tvseg.shape[-1]) < np.minimum(
        tvcnt, tvseg.shape[-1])[..., None]
    np.testing.assert_array_equal(tvseg[live], jvseg[live])
    assert (tvseg[~live] == 0).all()
    assert (twcnt >= k5case["bits"].sum(axis=2)).all()


@pytest.mark.parametrize("flagged", [False, True])
def test_k5b_membership_matches_pallas(k5case, flagged):
    jw = k5case["jout"][0]
    bits, a, b, act, _, m, fk = k5case["targs"]
    f = jw.shape[0]
    flags = np.zeros(f, np.int32)
    if flagged:
        flags[1::2] = 1
    jp, jc = jbk.blocked_membership(
        jw, n(a), n(b), n(act), n(m), n(fk), flags,
        k_lanes=jbk.k_bucket(k5case["kmax"]),
        nw=jbk.nw_bucket(int(n(m).max())))
    words = np.zeros(jw.shape[:2] + (tbk.NW,), np.int32)
    words[..., :jw.shape[-1]] = jw
    tp, tc = tbk.blocked_membership(t(words), a, b, act, m, fk, t(flags),
                                    k_lanes=k5case["kmax"],
                                    nw=k5case["nw"])
    assert tp.dtype == torch.uint8 and tc.dtype == torch.int32
    np.testing.assert_array_equal(n(tp), n(jp))
    np.testing.assert_array_equal(n(tc), n(jc))
    if not flagged:     # every changed item passes its own filter
        assert (n(tp)[n(bits) > 0] == 1).all()


def test_frame_mod_tables_match_jax(case):
    tab, m, thi, tlo = case["tab"], case["m"], case["thi"], case["tlo"]
    want = jbp._frame_mod_tables(tab["h1"], tab["h2"], tab["act_hi"],
                                 tab["act_lo"], m, thi, tlo)
    got = tbp._frame_mod_tables(*case["targs"][1:5], t(m), t(thi), t(tlo))
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.uint8]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("flagged", [False, True])
def test_k5_twins_equal_k1_k2_twins_on_mod_tables(case, flagged):
    """K5a on ``_frame_mod_tables`` equals K1 and K5b equals K2: what
    ties the multi-device kernels to the stream."""
    targs = case["targs"]
    bits, h1, h2, ahi, alo, vals, m, thi, tlo, fk = targs
    a, b, act = tbp._frame_mod_tables(h1, h2, ahi, alo, m, thi, tlo)
    kw = {"k_lanes": case["kmax"], "vh": case["vh"], "nw": case["nw"]}
    got = tbk.blocked_encode_ref(bits, a, b, act, vals, m, fk, **kw)
    for g, w in zip(got, case["tout"]):
        np.testing.assert_array_equal(n(g), w)
    flags = torch.zeros(m.shape[0], dtype=torch.int32)
    if flagged:
        flags[0] = 1
    words = got[0]
    mem = tbk.blocked_membership_ref(words, a, b, act, m, fk, flags,
                                     k_lanes=case["kmax"], nw=case["nw"])
    mem_h = tbk.blocked_membership_h_ref(words, h1, h2, ahi, alo, m, thi,
                                         tlo, fk, flags,
                                         k_lanes=case["kmax"],
                                         nw=case["nw"])
    for g, w in zip(mem, mem_h):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The kernels' arithmetic that the CPU cannot run
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def mod_rcp(h, m):
    """``mod_rcp`` of ops/csrc/blocked.cu step for step, in u32
    arithmetic held in uint64: rcp = floor((2^32 - 1) / m), once per
    frame; q = umulhi(h, rcp); r = h - q m; one conditional subtract."""
    m = np.uint64(m)
    rcp = _M32 // m
    q = (h * rcp) >> np.uint64(32)
    r = (h - ((q * m) & _M32)) & _M32
    return np.where(r >= m, r - m, r)


_RNG_M = [int(x) for x in np.random.default_rng(4).integers(16, 385, 3)]


@pytest.mark.parametrize("m", [1, 16, 17, 31, 32, 33, 97, 255, 256, 383, 384]
                         + _RNG_M)
def test_reciprocal_mod_equals_mod_on_every_24_bit_hash(m):
    """The kernels' `h mod m` (no `%`) equals `%` for every h < 2^24, the
    range of the h1/h2 tables."""
    step = 1 << 22
    for lo in range(0, 1 << 24, step):
        h = np.arange(lo, lo + step, dtype=np.uint64)
        np.testing.assert_array_equal(mod_rcp(h, m), h % np.uint64(m))


def test_reciprocal_mod_equals_mod_on_full_u32_hashes():
    """The bound in the kernel's note holds for any u32 h: every m the
    stream admits, on seeded hashes and both ends of the range."""
    rng = np.random.default_rng(5)
    h = np.concatenate([rng.integers(0, 1 << 32, 1 << 14, dtype=np.uint64),
                        np.arange(1 << 10, dtype=np.uint64),
                        (1 << 32) - 1 - np.arange(1 << 10, dtype=np.uint64)])
    for m in [1] + list(range(16, 385)):
        np.testing.assert_array_equal(mod_rcp(h, m), h % np.uint64(m))


@pytest.mark.parametrize("f,nb,want", [(15, 2032, 15), (16, 2032, 16),
                                       (15, 512, 8), (15, 513, 8),
                                       (15, 1, 1), (1, 64, 1),
                                       (40, 24304, 14)])
def test_frames_per_cta(f, nb, want):
    """K1/K2/K5a/K5b walk every frame of a chunk in one CTA (the tables
    read once) when NB alone fills the card, split the frames when it
    does not, and never take more than GMAX frames."""
    fpc = tbk.frames_per_cta(f, nb)
    assert fpc == want
    groups = -(-f // fpc)
    assert 1 <= fpc <= tbk.GMAX and (groups - 1) * fpc < f
    assert nb * groups >= min(tbk.TARGET_CTAS, nb * f)
