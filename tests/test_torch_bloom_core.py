"""The PyTorch port's BFV2 cores against the JAX package's, on the CPU.

``ops/bitpack``, ``ops/hashtables.get_hash_tables``, ``ops/bloom_core``,
``models/binary_codec``, ``models/gop`` and ``models/image_text`` of
both packages take the same seeded numpy inputs (and, through
``hash_tables_from_numpy``, the same hash tables); every output must be
equal (tolerance 0: all of it is integer bit work).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_bloom_filter_repo_tpu.models import gop as jgop
from new_bloom_filter_repo_tpu.models.binary_codec import (
    BloomFilterCompressor as JaxCodec,
)
from new_bloom_filter_repo_tpu.models.binary_codec import _filter_scalars
from new_bloom_filter_repo_tpu.models.bloom import (
    P_STAR,
    optimal_compression_params,
)
from new_bloom_filter_repo_tpu.ops import bitpack as jbp
from new_bloom_filter_repo_tpu.ops import bloom_core as jbc
from new_bloom_filter_repo_tpu.ops.hashtables import (
    get_hash_tables as jax_tables,
)
from new_bloom_filter_repo_tpu_torch.models import gop as tgop
from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
    BloomFilterCompressor,
)
from new_bloom_filter_repo_tpu_torch.models.image_text import BloomCompressor
from new_bloom_filter_repo_tpu_torch.ops import bitpack as tbp
from new_bloom_filter_repo_tpu_torch.ops import bloom_core as tbc
from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
    get_hash_tables,
    hash_tables_from_numpy,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
U32 = 0xFFFFFFFF


def same(got, want):
    """A torch tensor equals a JAX/numpy array: dtype kind, shape, values."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    if want.dtype == np.bool_:
        assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# bitpack and hash tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8,), (3, 64), (2, 5, 4000)])
def test_bitpack_equals_jax_and_numpy(shape):
    rng = np.random.default_rng(len(shape))
    bits = (rng.random(shape) < 0.3).astype(np.uint8)
    packed = tbp.pack_bits(torch.from_numpy(bits))
    same(packed, jbp.pack_bits(jnp.asarray(bits)))
    same(packed, np.packbits(bits, axis=-1))
    n = shape[-1] - 3
    same(tbp.unpack_bits(packed, n), jbp.unpack_bits(jnp.asarray(
        packed.numpy()), n))
    with pytest.raises(ValueError, match="multiple of 8"):
        tbp.pack_bits(torch.zeros(7, dtype=torch.uint8))
    assert [tbp.padded_length(x) for x in (0, 1, 8, 9)] == [0, 8, 8, 16]


@pytest.mark.parametrize("seed_set", ["video", "compress"])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_hash_tables_equal_jax(seed_set, n):
    got = get_hash_tables(n, seed_set)
    want = hash_tables_from_numpy(jax_tables(n, seed_set))
    assert got.n == want.n == n
    for g, w in zip((*got.h1, *got.h2, *got.act),
                    (*want.h1, *want.h2, *want.act)):
        assert g.dtype == torch.int64 and int(g.min()) >= 0
        assert int(g.max()) <= U32
        assert torch.equal(g, w)
    assert get_hash_tables(n, seed_set) is got          # cached
    with pytest.raises(ValueError, match="unknown seed set"):
        get_hash_tables(n, "nope")


def test_u64_mod_is_exact_near_the_modulus_bound():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    halves = t64(x >> np.uint64(32)), t64(x & np.uint64(U32))
    for l in (1, 7, 1000003, tbc.MAX_MODULUS - 1):
        got = tbc._mod(halves, torch.tensor(l))
        np.testing.assert_array_equal(got.numpy(),
                                      [int(v) % l for v in x])


# ---------------------------------------------------------------------------
# bloom_core
# ---------------------------------------------------------------------------

N = 1200

# (density, floor_k, activation): floor_k None and activation "real" take
# k, l and the threshold from the density, as the codec does; otherwise
# l = 500 and the threshold is 0 ("off"), 2^64 - 1 ("on") or random.
CORE_CASES = {
    "p01_real": (0.01, None, "real"),
    "p05_real": (0.05, None, "real"),
    "p20_real": (0.2, None, "real"),
    "p30_real": (0.3, None, "real"),
    "fk0_on": (0.1, 0, "on"),
    "fk12_off": (0.02, 12, "off"),
    "fk7_random": (0.15, 7, "random"),
}


def core_inputs(density, floor_k, act, seed, n=N):
    rng = np.random.default_rng(seed)
    bits = (rng.random(n) < density).astype(np.uint8)
    if floor_k is None:
        k, l = optimal_compression_params(n, bits.sum() / n)
        _, floor_k, (thi, tlo) = _filter_scalars(k)
        return bits, l, int(thi), int(tlo), floor_k
    thi, tlo = {"on": (U32, U32), "off": (0, 0)}.get(
        act, tuple(int(v) for v in rng.integers(0, U32, 2)))
    return bits, 500, thi, tlo, floor_k


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_encode_decode_core_equal_jax(name):
    bits, l, thi, tlo, fk = core_inputs(*CORE_CASES[name],
                                        seed=sorted(CORE_CASES).index(name))
    jt = jax_tables(N, "video")
    tt = get_hash_tables(N, "video")
    l_pad = jbc.bitmap_pad(N)
    want = jbc.encode_core(jnp.asarray(bits), jt.h1, jt.h2, jt.act,
                           jnp.uint32(l), jnp.uint32(thi), jnp.uint32(tlo),
                           floor_k=fk, l_pad=l_pad)
    got = tbc.encode_core(torch.from_numpy(bits), tt.h1, tt.h2, tt.act,
                          l, thi, tlo, floor_k=fk, l_pad=l_pad)
    for g, w in zip(got, want):
        same(g, w)
    dec = tbc.decode_core(got[0], got[2], tt.h1, tt.h2, tt.act, l, thi,
                          tlo, floor_k=fk)
    same(dec, jbc.decode_core(want[0], want[2], jt.h1, jt.h2, jt.act,
                              jnp.uint32(l), jnp.uint32(thi),
                              jnp.uint32(tlo), floor_k=fk))
    same(dec, bits)


@jax.jit
def _jax_lanes(bits, h1, h2, act, l, thi, tlo, fk):
    def one(b, ll, th, tl, kk):
        arr = jbc.insert_partial_lanes(b, h1, h2, act, ll, th, tl, kk,
                                       jbc.MAX_LANES, jbc.bitmap_pad(N))
        pm = jbc.membership_lanes(arr, h1, h2, act, ll, th, tl, kk,
                                  jbc.MAX_LANES)
        wit, cnt = jbc.witness_compact(b, pm)
        return arr, pm, wit, cnt, jbc.witness_expand(wit, pm)
    return jax.vmap(one)(bits, l, thi, tlo, fk)


@pytest.mark.parametrize("seed_set", ["video", "compress"])
def test_lane_masked_functions_equal_jax(seed_set):
    """One batch of 13 frames: floor_k 0..12, densities 1-30 %, the
    activation lane on, off and random; single-frame calls equal the
    batched rows."""
    rng = np.random.default_rng(11)
    f = tbc.MAX_LANES
    dens = np.geomspace(0.01, 0.3, f)
    bits = (rng.random((f, N)) < dens[:, None]).astype(np.uint8)
    fk = np.arange(f, dtype=np.int32)
    l = np.linspace(40, 500, f).astype(np.uint32)   # <= bitmap_pad(N)
    thi = rng.integers(0, U32, f, dtype=np.uint32, endpoint=True)
    tlo = rng.integers(0, U32, f, dtype=np.uint32, endpoint=True)
    thi[:3], tlo[:3] = 0, 0                          # off
    thi[3:6], tlo[3:6] = U32, U32                    # on
    jt = jax_tables(N, seed_set)
    want = _jax_lanes(jnp.asarray(bits), jt.h1, jt.h2, jt.act,
                      *(jnp.asarray(x) for x in (l, thi, tlo, fk)))
    tt = hash_tables_from_numpy(jt)
    tb = torch.from_numpy(bits)
    sc = [t64(x) for x in (l, thi, tlo, fk)]
    arr = tbc.insert_partial_lanes(tb, tt.h1, tt.h2, tt.act, *sc,
                                   tbc.MAX_LANES, jbc.bitmap_pad(N))
    pm = tbc.membership_lanes(arr, tt.h1, tt.h2, tt.act, *sc, tbc.MAX_LANES)
    wit, cnt = tbc.witness_compact(tb, pm)
    for g, w in zip((arr, pm, wit, cnt, tbc.witness_expand(wit, pm)), want):
        same(g, w)
    j = 9                                   # one frame alone, int scalars
    one = tbc.insert_partial_lanes(tb[j], tt.h1, tt.h2, tt.act, int(l[j]),
                                   int(thi[j]), int(tlo[j]), int(fk[j]),
                                   tbc.MAX_LANES, jbc.bitmap_pad(N))
    assert torch.equal(one, arr[j])


def test_thresholds_as_int32_bit_patterns():
    """u32 thresholds travelling as int32 (negative) bit patterns select
    the same lanes as the unsigned values."""
    bits, l, thi, tlo, fk = core_inputs(0.1, 3, "random", seed=4)
    thi, tlo = 0x90000000, 0x80000001
    tt = get_hash_tables(N)
    args = (torch.from_numpy(bits), tt.h1, tt.h2, tt.act, l)
    ref = tbc.encode_core(*args, thi, tlo, floor_k=fk, l_pad=1024)
    pat = tbc.encode_core(*args, torch.tensor(thi - (1 << 32),
                                              dtype=torch.int32),
                          torch.tensor(tlo - (1 << 32), dtype=torch.int32),
                          floor_k=fk, l_pad=1024)
    for a, b in zip(ref, pat):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# BloomFilterCompressor (the cases of tests/test_binary_codec.py)
# ---------------------------------------------------------------------------

def make_bits(n, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(n) < density).astype(np.uint8)


@pytest.mark.parametrize("seed_set", ["video", "compress"])
@pytest.mark.parametrize("density", [0.02, 0.1, 0.2, 0.3, 0.45])
def test_binary_codec_equals_jax(seed_set, density):
    n = 5000
    bits = make_bits(n, density, seed=int(density * 100))
    got = BloomFilterCompressor(seed_set=seed_set, device="cpu").compress(bits)
    want = JaxCodec(seed_set=seed_set).compress(bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bitmap, witness, p, n_, ratio = got
    k32 = float(np.float32(optimal_compression_params(n, p)[0]))
    out = BloomFilterCompressor(seed_set=seed_set, device="cpu").decompress(
        bitmap, witness, n, k32)
    np.testing.assert_array_equal(out, bits)
    np.testing.assert_array_equal(
        JaxCodec(seed_set=seed_set).decompress(bitmap, witness, n, k32),
        bits)
    if density >= BloomFilterCompressor.P_STAR:
        assert len(witness) == 0 and ratio == 1.0
    elif density <= 0.2:
        assert ratio < 1.0


def test_binary_codec_edge_cases():
    c = BloomFilterCompressor(device="cpu")
    zeros = np.zeros(3000, np.uint8)
    bitmap, witness, p, n, _ = c.compress(zeros)
    assert p == 0.0 and len(witness) == 0
    np.testing.assert_array_equal(c.decompress(bitmap, witness, n, 0.0),
                                  zeros)
    sparse = np.zeros(8000, np.uint8)
    sparse[[5, 999, 4321, 7777]] = 1
    bitmap, witness, p, n, ratio = c.compress(sparse)
    k32 = float(np.float32(c._calculate_optimal_params(n, p)[0]))
    np.testing.assert_array_equal(c.decompress(bitmap, witness, n, k32),
                                  sparse)
    assert ratio < 0.2
    with pytest.raises(ValueError, match="unknown seed set"):
        BloomFilterCompressor(seed_set="nope", device="cpu").compress(
            make_bits(100, .1, 0))


def test_binary_codec_decodes_a_foreign_oversized_filter():
    """A filter longer than bitmap_pad(n) (foreign streams) still
    decodes, as the JAX package's l_pad growth allows."""
    n = 600
    bits = make_bits(n, 0.05, seed=2)
    l = tbc.bitmap_pad(n) + 77
    tt = get_hash_tables(n)
    k32 = 4.5
    _, fk, (thi, tlo) = _filter_scalars(k32)
    padded = ((l + 127) // 128) * 128
    arr, _, wit, wlen = tbc.encode_core(torch.from_numpy(bits), tt.h1,
                                        tt.h2, tt.act, l, thi, tlo,
                                        floor_k=fk, l_pad=padded)
    bitmap, witness = arr[:l].numpy(), wit[:int(wlen)].numpy()
    got = BloomFilterCompressor(device="cpu").decompress(bitmap, witness, n,
                                                         k32)
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(
        JaxCodec().decompress(bitmap, witness, n, k32), bits)


# ---------------------------------------------------------------------------
# gop stages
# ---------------------------------------------------------------------------

def gop_chunk(gray: bool, f=5, h=24, w=44, seed=0):
    """f + 1 frames, each changing 0-50 % of its pixels over the last
    (the 50 % frame is a pass-through record)."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    frames = [rng.integers(0, 255, shape, dtype=np.uint8)]
    for i in range(f):
        nxt = frames[-1].copy()
        m = rng.random((h, w)) < [0.0, 0.02, 0.1, 0.25, 0.5][i % 5]
        nxt[m] = rng.integers(0, 255, (int(m.sum()),) + shape[2:])
        frames.append(nxt)
    return np.stack(frames)


def chunk_scalars(counts, n):
    l, thi, tlo, fk, flags = [], [], [], [], []
    for c in counts:
        p = int(c) / n
        k, ll = optimal_compression_params(n, p)
        if p >= P_STAR or ll == 0 or ll >= n:
            l.append(1), thi.append(0), tlo.append(0), fk.append(0)
            flags.append(1)
            continue
        _, f_, (a, b) = _filter_scalars(k)
        l.append(ll), thi.append(a), tlo.append(b), fk.append(f_)
        flags.append(0)
    return (np.array(l, np.uint32), np.array(thi, np.uint32),
            np.array(tlo, np.uint32), np.array(fk, np.int32),
            np.array(flags, np.int32))


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_gop_stages_equal_jax(gray):
    # the gray geometry (23 x 43 = 989 items) pads the masks to n8 = 992
    frames = gop_chunk(gray, h=23 if gray else 24, w=43 if gray else 44)
    h, w = frames.shape[1:3]
    n = h * w
    jt, tt = jax_tables(n, "video"), get_hash_tables(n, "video")
    jm = jgop.gop_masks(jnp.asarray(frames))
    tm = tgop.gop_masks(torch.from_numpy(frames))
    for g, want in zip(tm, jm):
        same(g, want)
    counts = tm[2].numpy()
    l, thi, tlo, fk, flags = chunk_scalars(counts, n)
    assert flags.any() and not flags.all()
    l_pad = jbc.bitmap_pad(n)
    vmax = min(tgop.next_bucket(int(counts.max())), tbp.padded_length(n))
    jarg = [jnp.asarray(x) for x in (l, thi, tlo, fk)]
    targ = [t64(x) for x in (l, thi, tlo, fk)]
    je = jgop.gop_encode(jm[0], jnp.asarray(frames[1:]), jt.h1, jt.h2,
                         jt.act, *jarg, l_pad=l_pad, vmax=vmax)
    te = tgop.gop_encode(tm[0], torch.from_numpy(frames[1:]), tt.h1, tt.h2,
                         tt.act, *targ, l_pad=l_pad, vmax=vmax)
    for g, want in zip(te, je):
        same(g, want)
    # decode fields from the records' byte layout: bitmap bytes (or the
    # packed mask for pass-through frames), witness bytes, values
    nbytes = tbp.padded_length(n) // 8
    pbm = np.zeros((len(counts), nbytes), np.uint8)
    for j, flag in enumerate(flags):
        src = tm[1].numpy()[j] if flag else te[0].numpy()[j]
        nb = nbytes if flag else (int(l[j]) + 7) // 8
        pbm[j, :nb] = src[:nb]
    c = 1 if gray else 3
    jd = jgop.gop_decode_fields(jnp.asarray(pbm), jnp.asarray(te[1].numpy()),
                                jnp.asarray(te[3].numpy()),
                                jnp.asarray(flags), jt.h1, jt.h2, jt.act,
                                *jarg, n=n, vmax=vmax)
    td = tgop.gop_decode_fields(torch.from_numpy(pbm), te[1], te[3],
                                torch.from_numpy(flags), tt.h1, tt.h2,
                                tt.act, *targ, n=n, vmax=vmax)
    for g, want in zip(td, jd):
        same(g, want)
    assert td[1].shape == (len(counts), n, c)
    base = torch.from_numpy(frames[0])
    chained = tgop.gop_chain(base, *td)
    same(chained, jgop.gop_chain(jnp.asarray(frames[0]), *jd))
    same(chained, frames[1:])
    same(tgop.gop_decode(base, torch.from_numpy(pbm), te[1], te[3],
                         torch.from_numpy(flags), tt.h1, tt.h2, tt.act,
                         *targ, n=n, vmax=vmax), frames[1:])


def test_next_bucket_and_kmax():
    assert tgop.KMAX == jgop.KMAX == tbc.MAX_LANES == jbc.MAX_LANES
    for x in (0, 1, 1024, 1025, 5000, 70000):
        assert tgop.next_bucket(x) == jgop.next_bucket(x)


# ---------------------------------------------------------------------------
# image_text (the golden fixtures of tests/test_cli_and_tools.py)
# ---------------------------------------------------------------------------

def test_image_text_decodes_golden_text():
    with open(os.path.join(FIXTURES, "golden_text.bcz"), "rb") as f:
        data = f.read()
    with open(os.path.join(FIXTURES, "golden_text.txt")) as f:
        want = f.read()
    assert BloomCompressor(device="cpu").decompress_text(data) == want


def test_image_text_golden_binary_both_ways():
    c = BloomCompressor(device="cpu")
    with open(os.path.join(FIXTURES, "golden_binary.bcz"), "rb") as f:
        ref = f.read()
    bits = np.load(os.path.join(FIXTURES, "golden_binary_bits.npy"))
    bitmap, witness, p, n, k, shape = c._unpack_compressed_data(ref)
    assert shape == (50, 60)
    np.testing.assert_array_equal(c.decompress(bitmap, witness, n, k), bits)
    bitmap, witness, p, n, _ = c.compress(bits)
    k, _ = c._calculate_optimal_params(n, p)
    assert c._pack_compressed_data(bitmap, witness, p, n, k, (50, 60)) == ref


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_image_text_text_equals_jax(bit_depth):
    from new_bloom_filter_repo_tpu.models.image_text import (
        BloomCompressor as JaxBloomCompressor)

    text = "rational bloom filters, " * 40 + "the end"
    got, ratio = BloomCompressor(device="cpu").compress_text(text, bit_depth)
    want, jratio = JaxBloomCompressor().compress_text(text, bit_depth)
    assert got == want and ratio == jratio
    assert BloomCompressor(device="cpu").decompress_text(got) == text


def test_image_text_image_roundtrip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    img = (rng.random((30, 40)) < 0.12).astype(np.uint8) * 255
    src = str(tmp_path / "img.png")
    Image.fromarray(img).save(src)
    data, _ = BloomCompressor(device="cpu").compress_image(src)
    out = BloomCompressor(device="cpu").decompress_image(
        data, str(tmp_path / "o.png"))
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "o.png")),
                                  img)


@pytest.mark.parametrize("n", [1200, 120000, 2073600])
def test_bitmap_pad_covers_every_filter_length(n):
    """The largest l over every density fits the pad; the JAX package's
    0.31 n pad does not at n = 120000 (ROADMAP Queue 3)."""
    p = np.linspace(0.0002, 0.3245, 20001)
    longest = max(optimal_compression_params(n, float(x))[1] for x in p)
    assert tbc.bitmap_pad(n) >= longest
    assert tbc.bitmap_pad(n) % 128 == 0
    assert (jbc.bitmap_pad(n) >= longest) == (n < 40000)


def test_binary_codec_near_the_longest_filter_is_exact():
    """At p = 0.132 and n = 120000, l exceeds the JAX package's pad: the
    JAX encoder's record does not decode, the port's does, and the JAX
    decoder decodes the port's record (its decode grows the pad)."""
    n = 120000
    bits = make_bits(n, 0.132, seed=1)
    k, l = optimal_compression_params(n, bits.sum() / n)
    assert l > jbc.bitmap_pad(n)
    k32 = float(np.float32(k))
    bitmap, witness, *_ = BloomFilterCompressor(device="cpu").compress(bits)
    assert len(bitmap) == l
    np.testing.assert_array_equal(
        BloomFilterCompressor(device="cpu").decompress(bitmap, witness, n,
                                                       k32), bits)
    np.testing.assert_array_equal(
        JaxCodec().decompress(bitmap, witness, n, k32), bits)
    jbitmap, jwitness, *_ = JaxCodec().compress(bits)
    assert not np.array_equal(
        JaxCodec().decompress(jbitmap, jwitness, n, k32), bits)
