"""Phase A of the port (``ops/phase_a.py``) against the JAX package.

The plain twins of K6 and K7, ``phase_a_diff_ref`` and
``motion_counts_ref``, are held to the JAX functions they stand for
(``_phase_a_pair``, ``_phase_a_motion_pair`` and ``_motion_counts_pair``
of ``new_bloom_filter_repo_tpu/models/blocked_pipeline.py``) on the same
seeded numpy frames; numpy mirrors of the kernels' index arithmetic
(``ops/csrc/phase_a.cu``) are held to the twins; and the wrappers keep
their contract on the CPU.  Every comparison is exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from new_bloom_filter_repo_tpu.models import blocked_pipeline as jbp
from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as tbp
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa
from new_bloom_filter_repo_tpu_torch.ops.hashtables import npad_of

R = pa.MOTION_RADIUS
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def frame_pairs(f, h, w, c, seed=0, change=0.3):
    """(prev, curr) uint8 stacks: curr is prev rolled by 2 px with a
    share ``change`` of its pixels redrawn, so masks are mixed."""
    rng = np.random.default_rng(seed)
    shape = (f, h, w) if c == 1 else (f, h, w, c)
    prev = rng.integers(0, 256, shape, dtype=np.uint8)
    curr = np.roll(prev, (1, 2), axis=(1, 2)).copy()
    redraw = rng.random((f, h, w)) < change
    curr[redraw] = rng.integers(0, 256, curr[redraw].shape, dtype=np.uint8)
    # a run of pixels equal to prev exactly, so zero shifts match there
    curr[:, : h // 3] = prev[:, : h // 3]
    return prev, curr


def shift_rows(f, h, w, seed=0):
    """(f, 2) int32 shifts over the values the roll must wrap as the JAX
    package wraps them: 0, +-7, +-h, +-w, 2^31 - 1 and -2^31."""
    vals = [0, 7, -7, h, -h, w, -w, I32_MAX, I32_MIN]
    rng = np.random.default_rng(seed)
    dy = np.resize(vals, f)
    dx = rng.permutation(np.resize(vals, f))
    return np.stack([dy, dx], axis=1).astype(np.int32)


def geometry(h, w):
    npad = npad_of(h * w)
    return npad, npad // bk.IPB


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return np.asarray(x)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        g, w_ = n(g), n(w_)
        assert g.shape == w_.shape and g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


# (h, w, C, F): n = 888 items is not a multiple of 1024 and leaves 7
# whole padding blocks of the 8 (npad 8192); 64 x 48 leaves 5 of 8;
# 96 x 130 = 12480 items pads to 16384
DIFF_CASES = [(24, 37, 3, 2), (24, 37, 1, 5), (24, 37, 2, 1),
              (64, 48, 3, 1), (64, 48, 2, 5), (96, 130, 1, 2),
              (96, 130, 3, 5)]


def case_id(case):
    return "x".join(map(str, case[:2])) + f"-C{case[2]}-F{case[3]}"


@pytest.mark.parametrize("case", DIFF_CASES, ids=case_id)
def test_phase_a_diff_ref_matches_jax_without_shifts(case):
    h, w, c, f = case
    prev, curr = frame_pairs(f, h, w, c, seed=h + c)
    npad, nb = geometry(h, w)
    want = jbp._phase_a_pair(jnp.asarray(prev), jnp.asarray(curr),
                             npad=npad, nb=nb)
    got = pa.phase_a_diff_ref(t(prev), t(curr), None, npad, nb)
    assert_same(got, want)
    masks, counts, vals = (n(x) for x in got)
    assert masks.reshape(f, -1)[:, h * w:].sum() == 0
    assert vals.reshape(f, -1)[:, h * w:].sum() == 0
    assert counts[:, nb - (npad - h * w) // bk.IPB:].sum() == 0
    zero = pa.phase_a_diff_ref(t(prev), t(curr),
                               torch.zeros((f, 2), dtype=torch.int32),
                               npad, nb)
    assert_same(zero, got)


# (h, w, C): one frame pair a shift row of shift_rows (9 pairs)
MOTION_SHAPES = [(24, 37, 3), (64, 48, 1), (96, 130, 2)]


@pytest.mark.parametrize("shape", MOTION_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}-C{s[2]}")
def test_phase_a_diff_ref_matches_jax_with_shifts(shape):
    h, w, c = shape
    prev, curr = frame_pairs(9, h, w, c, seed=w)
    shifts = shift_rows(9, h, w, seed=c)
    npad, nb = geometry(h, w)
    want = jbp._phase_a_motion_pair(jnp.asarray(prev), jnp.asarray(curr),
                                    jnp.asarray(shifts), npad=npad, nb=nb)
    got = pa.phase_a_diff_ref(t(prev), t(curr), t(shifts), npad, nb)
    assert_same(got, want)


def test_phase_a_motion_wraps_extreme_shifts_as_jax():
    """The port's _phase_a_motion and _phase_a_packed_motion roll by
    shifts near -2^31 and 2^31 - 1 as the JAX package's jitted programs
    do.  Each frame is the previous one rolled by its shift as the JAX
    package rolls it, with a few pixels redrawn, so only those pixels
    change under the JAX roll.  Before the port's roll followed the JAX
    package's int32 arithmetic, -2^31 rolled by (y + 2^31) mod h, not
    (y - 2^31) mod h, and these masks differed from the JAX package's."""
    h, w, c = 24, 37, 3
    rng = np.random.default_rng(11)
    shifts = np.array([[I32_MIN, 5], [I32_MAX, I32_MIN], [3, I32_MAX],
                       [I32_MIN + 3, I32_MIN + 30]], np.int32)
    frames = [rng.integers(0, 256, (h, w, c), dtype=np.uint8)]
    for dy, dx in shifts:
        chw = jnp.asarray(frames[-1].transpose(2, 0, 1))
        nxt = n(jbp._roll2d(chw, jnp.int32(dy), jnp.int32(dx)))
        nxt = nxt.transpose(1, 2, 0).copy()
        nxt[rng.random((h, w)) < 0.05] = 7
        frames.append(nxt)
    stacked = np.stack(frames)
    npad, nb = geometry(h, w)
    want = jbp._phase_a_motion(jnp.asarray(stacked), jnp.asarray(shifts),
                               npad=npad, nb=nb)
    got = tbp._phase_a_motion(t(stacked), t(shifts), npad=npad, nb=nb)
    assert_same(got, want)
    assert 0 < n(got[1]).sum() < 0.1 * len(shifts) * h * w
    np.testing.assert_array_equal(
        n(tbp._phase_a_packed_motion(t(stacked), t(shifts), npad=npad)),
        n(jbp._phase_a_packed_motion(jnp.asarray(stacked),
                                     jnp.asarray(shifts), npad=npad)))


# (h, w, C, F, stride)
COUNT_CASES = [(24, 37, 3, 2, 4), (24, 37, 1, 1, 8), (64, 48, 2, 5, 4),
               (64, 48, 3, 2, 8), (96, 130, 1, 2, 4), (96, 130, 3, 1, 8)]


@pytest.mark.parametrize("case", COUNT_CASES,
                         ids=lambda s: case_id(s) + f"-s{s[4]}")
def test_motion_counts_ref_matches_jax(case):
    h, w, c, f, stride = case
    prev, curr = frame_pairs(f, h, w, c, seed=3 * h + stride)
    want = jbp._motion_counts_pair(jnp.asarray(prev), jnp.asarray(curr),
                                   stride=stride)
    got = pa.motion_counts_ref(t(prev), t(curr), stride)
    assert_same([got], [want])
    # the frames were rolled by (1, 2): no candidate sees fewer
    # mismatches
    best = (1 + R) * (2 * R + 1) + (2 + R)
    assert (n(got)[:, best] == n(got).min(axis=1)).all()


# (h, w, C, F): tiles cut at both edges, 1-3 bytes a pixel, a frame
# smaller than one tile
TILE_SHAPES = [(37, 53, 3, 2), (70, 45, 1, 1), (24, 37, 2, 2), (5, 7, 3, 2)]
TILE_LOGS = [(4, 4), (6, 8), (2, 8), (5, 3)]          # (tlog, stride)


def np_tile_counts(prev, curr, tlog, stride):
    """(F, ty, tx, 225) per-tile mismatch counts in numpy: the body that
    K7 sums per frame and K8 per tile."""
    pp = n(pa.packed_hw(t(prev))).astype(np.int64)
    pc = n(pa.packed_hw(t(curr))).astype(np.int64)
    f, h, w = pc.shape
    ys, xs = np.arange(0, h, stride), np.arange(0, w, stride)
    spt = max(1, (1 << tlog) // stride)
    ty, tx = -(-len(ys) // spt), -(-len(xs) // spt)
    out = np.zeros((f, ty, tx, pa.CANDIDATES), np.int64)
    cur = pc[:, ys[:, None], xs[None, :]]
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ref = pp[:, ((ys - dy) % h)[:, None], ((xs - dx) % w)[None, :]]
            ne = np.zeros((f, ty * spt, tx * spt), np.int64)
            ne[:, : len(ys), : len(xs)] = ref != cur
            out[..., (dy + R) * pa.SIDE + dx + R] = ne.reshape(
                f, ty, spt, tx, spt).sum(axis=(2, 4))
    return out


@pytest.mark.parametrize("tl", TILE_LOGS, ids=lambda s: f"t{s[0]}-s{s[1]}")
@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}-C{s[2]}")
def test_tile_motion_best_ref_matches_jax(shape, tl):
    h, w, c, f = shape
    tlog, stride = tl
    stacked = motion_chain(f, h, w, c, seed=h + w + c)
    prev, curr = stacked[:-1], stacked[1:]
    want = n(jbp._tile_motion_best(jnp.asarray(stacked), tlog=tlog,
                                   stride=stride))
    got = n(pa.tile_motion_best_ref(t(prev), t(curr), tlog, stride))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the port's _tile_motion_best reaches the twin through the wrapper
    np.testing.assert_array_equal(
        n(tbp._tile_motion_best(t(stacked), tlog=tlog, stride=stride)), want)
    tiles = np_tile_counts(prev, curr, tlog, stride)
    np.testing.assert_array_equal(
        tiles.sum(axis=(1, 2)),
        n(pa.motion_counts_ref(t(prev), t(curr), stride)))
    first = tiles.argmin(axis=-1)
    np.testing.assert_array_equal(
        got, np.stack([first, tiles.min(axis=-1),
                       tiles[..., pa.ZERO_CANDIDATE]], axis=-1))


@pytest.mark.parametrize("tl", TILE_LOGS, ids=lambda s: f"t{s[0]}-s{s[1]}")
def test_tile_motion_best_of_constant_frames_ties_at_zero(tl):
    """Every count ties at 0 on constant frames: best is candidate 0, as
    jnp.argmin gives it."""
    tlog, stride = tl
    stacked = np.full((3, 21, 34, 3), 77, np.uint8)
    want = n(jbp._tile_motion_best(jnp.asarray(stacked), tlog=tlog,
                                   stride=stride))
    got = n(pa.tile_motion_best_ref(t(stacked[:-1]), t(stacked[1:]), tlog,
                                    stride))
    np.testing.assert_array_equal(got, want)
    assert not got.any()


# ---------------------------------------------------------------------------
# Numpy mirrors of the kernels' index arithmetic
# ---------------------------------------------------------------------------

def roll_of(d, size):
    """K6's roll_of: (a, b, c) with source(v) = v + (v < c ? a : b),
    less size if it reaches size; without a division for |d| < size
    (and no int32 wrap), else 64-bit Python ints, truncating % as in
    C++, then made non-negative."""
    def cmod(x, m):
        r = abs(x) % m
        return -r if x < 0 else r

    c = (1 << 31) + d
    if -size < d < size and c >= size:        # the division-free branch
        a = -d if d <= 0 else size - d
        return a, a, size
    a = cmod(-d, size)
    a += size if a < 0 else 0
    b = cmod(-d - (1 << 32), size)
    b += size if b < 0 else 0
    return a, b, min(c, size)


def is_identity(r, size):
    a, b, c = r
    return a == 0 and (c >= size or b == 0)


def rolled(v, r, size):
    a, b, c = r
    s = v + np.where(v < c, a, b)
    return np.where(s >= size, s - size, s)


def load4_mirror(frame_bytes, groups, c):
    """K6's load4 for the first ``groups`` thread groups of a frame: four
    packed pixels from 4 * c bytes read as c little-endian u32 words."""
    raw = frame_bytes[: groups * 4 * c].reshape(groups, 4 * c)
    words = raw.view("<u4").astype(np.int64)              # (groups, c)
    out = np.zeros((groups, 4), np.int64)
    for k in range(4):
        for ch in range(c):
            byte = k * c + ch
            out[:, k] |= ((words[:, byte >> 2] >> (8 * (byte & 3)))
                          & 0xFF) << (8 * ch)
    return out.reshape(-1)


def load1_mirror(frame_bytes, idx, c):
    """K6's load1: the packed pixels ``idx``, byte by byte."""
    p = frame_bytes.reshape(-1, c).astype(np.int64)
    v = p[idx, 0]
    for ch in range(1, min(c, 3)):
        v = v | (p[idx, ch] << (8 * ch))
    return v


def load_items_mirror(frame_bytes, nn, c):
    """K6's load_items over a whole frame: vector loads for every thread
    group of four items below n (the frame on a 4-byte boundary), byte
    loads for the last, partial group."""
    full = nn // 4
    return np.concatenate([load4_mirror(frame_bytes, full, c),
                           load1_mirror(frame_bytes,
                                        np.arange(4 * full, nn), c)])


def k6_mirror(prev, curr, shifts, npad, nb):
    """K6 item by item as the kernel computes it: the current pixels
    through load_items; the previous ones the same way when the frame's
    rolls map every item to itself (or there is no shift), else byte by
    byte from the rolled source, (y, x) = (i / w, i % w) through roll_of;
    padding items are 0."""
    f, h, w = curr.shape[:3]
    c = 1 if curr.ndim == 3 else curr.shape[3]
    nn = h * w
    masks = np.zeros((f, npad), np.uint8)
    vals = np.zeros((f, npad), np.int32)
    i = np.arange(nn)
    for j in range(f):
        cb, pb = curr[j].reshape(-1), prev[j].reshape(-1)
        pc = load_items_mirror(cb, nn, c)
        ry = rx = None
        if shifts is not None:
            ry = roll_of(int(shifts[j, 0]), h)
            rx = roll_of(int(shifts[j, 1]), w)
        if ry is None or (is_identity(ry, h) and is_identity(rx, w)):
            pp = load_items_mirror(pb, nn, c)
        else:
            src = rolled(i // w, ry, h) * w + rolled(i % w, rx, w)
            pp = load1_mirror(pb, src, c)
        masks[j, :nn] = pc != pp
        vals[j, :nn] = pc
    masks = masks.reshape(f, nb, bk.IPB)
    return masks, masks.sum(axis=2, dtype=np.int32), vals.reshape(
        f, nb, bk.IPB)


@pytest.mark.parametrize("shape", MOTION_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}-C{s[2]}")
@pytest.mark.parametrize("shifted", [False, True])
def test_k6_mirror_matches_twin(shape, shifted):
    h, w, c = shape
    prev, curr = frame_pairs(9, h, w, c, seed=h * w)
    shifts = shift_rows(9, h, w, seed=h) if shifted else None
    npad, nb = geometry(h, w)
    got = k6_mirror(prev, curr, shifts, npad, nb)
    want = pa.phase_a_diff_ref(t(prev), t(curr),
                               None if shifts is None else t(shifts),
                               npad, nb)
    assert_same(got, want)


def test_roll_of_matches_the_int32_roll_everywhere():
    """roll_of's offsets against the twin's roll_index for every axis
    length to 40 and shifts at both ends of int32 and around 0."""
    ds = [I32_MIN, I32_MIN + 1, I32_MIN + 39, -41, -7, -1, 0, 1, 7, 41,
          I32_MAX - 39, I32_MAX]
    for size in range(1, 41):
        want = n(pa.roll_index(size, torch.tensor(ds, dtype=torch.int32)))
        for row, d in zip(want, ds):
            got = rolled(np.arange(size), roll_of(d, size), size)
            np.testing.assert_array_equal(got, row, err_msg=f"{size} {d}")


def memory(arr, skew):
    """The bytes of ``arr`` as a device tensor would hold them, at an
    address ``skew`` past a 16-byte boundary: (memory as int16, with -1
    for the bytes around the tensor, lo, hi)."""
    raw = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8)
    lo = 64 + skew
    mem = np.full(lo + raw.size + 64, -1, np.int16)
    mem[lo: lo + raw.size] = raw
    return mem, lo, lo + raw.size


def packed_at(mem, pos, used):
    """pixel_at of ``used`` bytes of memory at each of ``pos``; every
    byte must be one of the tensor's (not -1)."""
    b = np.stack([mem[pos + i] for i in range(used)], axis=-1).astype(
        np.int64)
    assert (b >= 0).all(), "a pixel read a byte outside the tensor"
    v = b[..., 0]
    for i in range(1, used):
        v = v | (b[..., i] << (8 * i))
    return v


def funnel(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh) on uint32 words (sh < 32)."""
    return ((hi << np.uint64(32) | lo) >> np.uint64(sh)) & np.uint64(
        0xFFFFFFFF)


def four_pixels(buf, b, c):
    """four_pixels of ops/csrc/phase_a.cu on a landing row ``buf`` (-1:
    a byte no copy wrote): the C + 1 little-endian words from byte b
    rounded down to 4, funnel-shifted to b, four packed pixels cut from
    them; the pixels' own bytes must have been written."""
    assert (buf[b: b + 4 * c] >= 0).all(), "a pixel byte no copy wrote"
    wa = b & ~3
    raw = np.where(buf[wa: wa + 16] < 0, 0xEE, buf[wa: wa + 16]).astype(
        np.uint64)
    wv = [raw[4 * k] | raw[4 * k + 1] << np.uint64(8)
          | raw[4 * k + 2] << np.uint64(16) | raw[4 * k + 3] << np.uint64(24)
          for k in range(4)]
    v = [funnel(wv[k], wv[k + 1], 8 * (b & 3)) for k in range(3)]
    m8, m16, m24 = (np.uint64(x) for x in (0xFF, 0xFFFF, 0xFFFFFF))
    if c == 1:
        px = [(v[0] >> np.uint64(8 * k)) & m8 for k in range(4)]
    elif c == 2:
        px = [v[0] & m16, v[0] >> np.uint64(16), v[1] & m16,
              v[1] >> np.uint64(16)]
    else:
        px = [v[0] & m24,
              (v[0] >> np.uint64(24)) | ((v[1] & m16) << np.uint64(8)),
              (v[1] >> np.uint64(16)) | ((v[2] & m8) << np.uint64(16)),
              v[2] >> np.uint64(8)]
    return [int(x) for x in px]


def search_mirror(prev, curr, stride, tlog=None, rows=None, strip=None,
                  skew=(0, 0)):
    """K7 (``tlog`` None) or K8 as ops/csrc/phase_a.cu walks it: CTAs
    over (frame, band of ``rows`` sample rows, strip of sample columns)
    from k7_tiling / k8_tiling unless given; for each sample row y, warp
    wi compares with previous row y + R - wi (mod h), staged (column q *
    s + ph is image column a + q * s + ph (mod w), a = x0 - R rounded
    down to 4 for s < 15, at word ph * Q + q): on the fast path by warp
    wi mod s, which stages its group's rows once each, from the band's
    first sample row less ceil((2R + 1) / s) - 1 on, keeps the last
    ceil((2R + 1) / s) + 1 and hands warp wi the one wi // s sample rows
    back, each from a landing row of 16-byte granules (run A from the
    granule of column alo's first byte, then run B from the row's start
    where the halo wraps) in four column groups (four_pixels); on the
    generic path by warp wi itself, pixel by pixel; lane k compares
    its sample with words off[j] + k; K7 sums a lane's counts over the
    band, K8 over a tile row, then per tile (lanes in aligned groups of
    g2 of one tile) with the lane-by-lane first minimum.  Previous frames
    lie ``skew[0]`` bytes past a 16-byte boundary (the fast path needs
    0), current ones ``skew[1]``.  Returns K7's (F, 225) counts, or
    K8's (F, ty, tx, 3) rows and (F, ty, tx, 225) counts."""
    f, h, w = curr.shape[:3]
    cs = 1 if curr.ndim == 3 else curr.shape[3]
    used = min(cs, 3)
    s, side = stride, pa.SIDE
    sh, sw = -(-h // s), -(-w // s)
    if tlog is None:
        spt = 0
        rows_, strip_ = pa.k7_tiling(f, h, w, cs, s)
        strip = strip or strip_
    else:
        spt, rows_, strip = pa.k8_tiling(f, h, w, cs, tlog, s)
    rows = rows or rows_
    geo = pa.search_geometry(h, w, cs, s, strip, spt, skew[0] == 0)
    assert geo["smem"] is not None
    p, q, tiles, fast, lrow = (geo[k] for k in ("P", "Q", "tiles", "fast",
                                                "lrow"))
    rw, frame, rowb = p * q, h * w * cs, w * cs
    pmem, plo, _ = memory(prev, skew[0])
    cmem, clo, _ = memory(curr, skew[1])
    out7 = np.zeros((f, side * side), np.int64)
    ty, tx = (-(-sh // spt), -(-sw // spt)) if spt else (0, 0)
    out8 = np.full((f, ty, tx, 3), -1, np.int64)
    tilec = np.zeros((f, ty, tx, side * side), np.int64)
    if spt:
        assert rows % spt == 0
        g2 = 32 if spt >= 32 else spt & -spt
        lanes = np.arange(32)
        mytile = (np.zeros(32, int) if spt >= 32 else
                  np.where(lanes < tiles * spt, lanes // max(spt, 1), -1))
        for grp in range(0, 32, g2):          # a shuffle group, one tile
            assert len(set(mytile[grp: grp + g2])) == 1
    for fi, band, si in itertools.product(range(f), range(-(-sh // rows)),
                                          range(-(-sw // strip))):
        r0, k0 = band * rows, si * strip
        nrows, nk = min(sh, r0 + rows) - r0, min(strip, sw - k0)
        xr = k0 * s - R
        a = xr & ~3 if s < side else xr
        lead = xr - a
        off = np.array([((lead + j) % p) * q + (lead + j) // p
                        for j in range(side)])
        if fast:
            assert lead == 1 and a % 4 == 0 and w % 4 == 0
            alo, ahi, bhi = a, a + rw, 0
            if a < 0:
                alo, ahi, bhi = a + w, w, a + rw
            elif a + rw > w:
                ahi, bhi = w, a + rw - w
            a0 = alo * cs
            na = (ahi * cs - (a0 & ~15) + 15) >> 4
            nb = (bhi * cs + 15) >> 4
            assert na + nb <= 64 and 16 * (na + nb) + 4 <= lrow
        ks = np.arange(nk)
        cnt = np.zeros((side, 32, side), np.int64)     # warp, lane, dx
        s_tile = np.zeros((max(tiles, 1), side * side), np.int64)

        def staged(row):
            """The staged row of previous row ``row`` (a byte address)."""
            poly = np.full(rw, -1, np.int64)
            if fast:
                assert row % 16 == 0
                land = np.full(lrow, -1, np.int16)
                land[: 16 * na] = pmem[row + (a0 & ~15):
                                       row + (a0 & ~15) + 16 * na]
                land[16 * na: 16 * (na + nb)] = pmem[row: row + 16 * nb]
                for ci in range(0, rw, 4):
                    x = a + ci
                    x = x + w if x < 0 else x - w if x >= w else x
                    b = ((a0 & 15) + (x - alo) * cs if alo <= x < ahi
                         else 16 * na + x * cs)
                    for k, px in enumerate(four_pixels(land, b, cs)):
                        poly[(ci % s + k) * q + ci // s] = px
            else:
                ph, qq = np.divmod(np.arange(rw), q)
                x = (a + qq * s + ph) % w
                poly[:] = packed_at(pmem, row + x * cs, used)
            return poly

        def prev_at(r, wi):
            return plo + fi * frame + (r * s + R - wi) % h * rowb

        # the fast path's groups: warp b < s stages rows first .. end - 1
        # into slot (r - first) mod hold, warp b + s * back reads r - back
        back_max = -(-side // s) - 1 if fast else 0
        first, hold = r0 - back_max, back_max + 2
        hist = np.full((s if fast else 0, hold, rw), -1, np.int64)
        for r in range(first, r0):
            for b in range(hist.shape[0]):
                hist[b, (r - first) % hold] = staged(prev_at(r, b))
        for r in range(r0, r0 + nrows):
            for b in range(hist.shape[0]):
                hist[b, (r - first) % hold] = staged(prev_at(r, b))
            cpos = (clo + fi * frame + r * s * rowb + (k0 + ks) * s * cs)
            cur = packed_at(cmem, cpos, used)
            for wi in range(side):
                if fast:
                    b, back = wi % s, wi // s
                    assert back <= back_max
                    poly = hist[b, (r - back - first) % hold]
                else:
                    poly = staged(prev_at(r, wi))
                vals = poly[off[None, :] + ks[:, None]]
                assert (vals >= 0).all(), "a staged word never written"
                np.add.at(cnt[wi], ks % 32, (vals != cur[:, None])[:, ::-1])
            if spt and ((r + 1) % spt == 0 or r + 1 == r0 + nrows):
                for wi in range(side):
                    for lane in range(32):
                        if mytile[lane] >= 0:
                            s_tile[mytile[lane], wi * side: wi * side
                                   + side] += cnt[wi, lane]
                cnt[:] = 0
                tyi = r // spt
                for tt in range(tiles):
                    txi = k0 // spt + tt
                    if txi >= tx:
                        break
                    ct = s_tile[tt]
                    local = [min((ct[i], i) for i in range(lane, side * side,
                                                             32))
                             for lane in range(32)]
                    mn = min(v for v, _ in local)
                    best = min(i for v, i in local if v == mn)
                    assert (out8[fi, tyi, txi] == -1).all(), "a tile twice"
                    out8[fi, tyi, txi] = (best, mn, ct[pa.ZERO_CANDIDATE])
                    tilec[fi, tyi, txi] = ct
                    s_tile[tt] = 0
        out7[fi] += cnt.sum(axis=1).reshape(-1)
    if spt:
        assert (out8 >= 0).all(), "a tile no CTA wrote"
        return out8.astype(np.int32), tilec
    return out7.astype(np.int32)


def motion_chain(f, h, w, c, seed=0):
    """A stacked (f + 1, h, w[, c]) uint8 chunk whose halves move apart:
    each frame is the last with its left half rolled by (1, 2) and its
    right half by (-3, 1), a tenth of its pixels redrawn, so tiles pick
    different shifts."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)]
    for _ in range(f):
        nxt = frames[-1].copy()
        half = w // 2
        nxt[:, :half] = np.roll(frames[-1], (1, 2), axis=(0, 1))[:, :half]
        nxt[:, half:] = np.roll(frames[-1], (-3, 1), axis=(0, 1))[:, half:]
        redraw = rng.random((h, w)) < 0.1
        nxt[redraw] = rng.integers(0, 256, nxt[redraw].shape, dtype=np.uint8)
        frames.append(nxt)
    return np.stack(frames)


@pytest.mark.parametrize("case", COUNT_CASES,
                         ids=lambda s: case_id(s) + f"-s{s[4]}")
def test_k7_mirror_matches_twin(case):
    h, w, c, f, stride = case
    prev, curr = frame_pairs(f, h, w, c, seed=h + w + stride)
    np.testing.assert_array_equal(
        search_mirror(prev, curr, stride),
        n(pa.motion_counts_ref(t(prev), t(curr), stride)))


# (h, w, C, F, stride, tlog, rows, strip, skew): bands over many sample
# rows, strips of 1, 5 and 32 columns, frames narrower than a staged row,
# strides 1 and 3 (15 and 5 phases), 16 (past the window: 15 phases),
# tensors 3, 5 and 11 bytes past a 16-byte boundary, tiles of 1, 10, 16
# and 64 samples: the generic path; then the fast path (strides 4 and 8,
# 1-3 bytes a pixel, halos wrapped at both edges, the last strip cut
# short, tiles of 4 and 8 samples; current frames off their boundary)
WALKS = [(24, 37, 3, 2, 4, None, 6, 5, (0, 0)),
         (13, 9, 1, 2, 4, None, None, None, (5, 11)),
         (40, 61, 2, 1, 1, None, 40, 32, (3, 0)),
         (37, 53, 3, 2, 3, None, 13, 1, (0, 7)),
         (70, 45, 1, 1, 16, None, 5, 2, (9, 9)),
         (24, 37, 3, 2, 4, 4, 8, None, (0, 0)),
         (37, 53, 3, 2, 3, 5, 10, None, (5, 11)),
         (40, 61, 2, 1, 8, 2, 3, None, (0, 3)),
         (40, 61, 1, 1, 1, 6, 64, None, (1, 2)),
         (29, 131, 3, 1, 2, 5, 32, None, (0, 0)),
         (30, 288, 3, 1, 8, None, 7, None, (5, 0)),
         (30, 288, 3, 2, 8, None, 7, None, (0, 0)),
         (37, 160, 1, 2, 4, None, 10, None, (0, 5)),
         (21, 176, 2, 1, 4, None, None, None, (0, 3)),
         (30, 288, 3, 2, 8, 6, 16, None, (0, 1)),
         (37, 160, 3, 1, 4, 4, 8, None, (0, 9)),
         (33, 144, 1, 2, 4, 5, 16, None, (0, 0))]
FAST_WALKS = WALKS[11:]


@pytest.mark.parametrize("walk", WALKS, ids=lambda s: "-".join(
    map(str, s[:6])))
def test_search_mirror_matches_twins(walk):
    """The walk of K7 and K8 at small odd geometries against the twins:
    K7's counts, K8's rows, and K8's per-tile counts summed over the
    tiles against K7's."""
    h, w, c, f, stride, tlog, rows, strip, skew = walk
    if tlog is None:
        geo = pa.search_geometry(h, w, c, stride, strip or pa.SEARCH_LANES,
                                 0, skew[0] == 0)
    else:
        spt, _, strip8 = pa.k8_tiling(f, h, w, c, tlog, stride)
        geo = pa.search_geometry(h, w, c, stride, strip8, spt, skew[0] == 0)
    assert bool(geo["fast"]) == (walk in FAST_WALKS)
    stacked = motion_chain(f, h, w, c, seed=h * w + stride)
    prev, curr = stacked[:-1], stacked[1:]
    counts = n(pa.motion_counts_ref(t(prev), t(curr), stride))
    if tlog is None:
        got = search_mirror(prev, curr, stride, rows=rows, strip=strip,
                            skew=skew)
        np.testing.assert_array_equal(got, counts)
        return
    rows8, tilec = search_mirror(prev, curr, stride, tlog=tlog, rows=rows,
                                 skew=skew)
    np.testing.assert_array_equal(
        rows8, n(pa.tile_motion_best_ref(t(prev), t(curr), tlog, stride)))
    np.testing.assert_array_equal(tilec.sum(axis=(1, 2)), counts)


@pytest.mark.parametrize("f,h,w,c,stride", [
    (1, 1080, 1920, 3, 8), (15, 1080, 1920, 3, 8), (120, 1080, 1920, 3, 8),
    (15, 2160, 3840, 3, 8), (15, 540, 960, 1, 4), (15, 1080, 23040, 1, 8),
    (1, 7, 5, 3, 100), (2, 50, 4000, 64, 1)])
def test_k7_tiling_stays_in_shared_memory(f, h, w, c, stride):
    """K7's and K8's CTAs fit the shared memory a CTA may opt into (two
    to an SM at the main path's shapes, on its fast path); bands cover
    every sample row; the grid is near ``bk.TARGET_CTAS`` where the
    frames allow."""
    rows, strip = pa.k7_tiling(f, h, w, c, stride)
    geo = pa.search_geometry(h, w, c, stride, strip)
    assert strip == pa.SEARCH_LANES and geo["smem"] is not None
    sh, sw = -(-h // stride), -(-w // stride)
    bands = -(-sh // rows)
    assert (bands - 1) * rows < sh <= bands * rows
    ctas = f * bands * -(-sw // strip)
    assert ctas >= min(bk.TARGET_CTAS, f * sh * -(-sw // strip)) // 2
    main = stride in (4, 8) and c <= 3 and w % 16 == 0
    assert bool(geo["fast"]) == main
    for tlog in (2, 4, 6):
        spt, rows8, strip8 = pa.k8_tiling(f, h, w, c, tlog, stride)
        assert rows8 % spt == 0 and spt == max(1, (1 << tlog) // stride)
        geo8 = pa.search_geometry(h, w, c, stride, strip8, spt)
        assert geo8["smem"] is not None and strip8 % spt == 0
        assert strip8 <= max(spt, pa.SEARCH_LANES)
        assert bool(geo8["fast"]) == (main and pa.SEARCH_LANES % spt == 0)
    if main:                                  # two CTAs an SM's 228 KB
        assert geo["smem"] <= 228 * 1024 // 2 - 1024


def test_search_tiling_refuses_what_does_not_fit():
    """A tile wider than the shared memory takes raises; it is never
    given to the twin or cut silently.  K7 takes pixels of any width
    (its staged rows hold packed ints)."""
    with pytest.raises(ValueError, match="K8 takes no tile"):
        pa.k8_tiling(1, 64, 9000, 3, 13, 1)
    assert pa.k7_tiling(1, 8, 100000, 4000, 1)[1] == pa.SEARCH_LANES
    assert pa.search_geometry(8, 100000, 4000, 1, 32)["smem"] is not None


# ---------------------------------------------------------------------------
# The wrappers' contract on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_the_twins_on_cpu_tensors():
    h, w, c, f = 24, 37, 3, 2
    prev, curr = frame_pairs(f, h, w, c)
    shifts = t(shift_rows(f, h, w))
    npad, nb = geometry(h, w)
    bk.reset_launches()
    assert_same(pa.phase_a_diff(t(prev), t(curr), shifts, npad, nb),
                pa.phase_a_diff_ref(t(prev), t(curr), shifts, npad, nb))
    assert_same(pa.phase_a_diff(t(prev), t(curr), None, npad, nb),
                pa.phase_a_diff_ref(t(prev), t(curr), None, npad, nb))
    assert_same([pa.motion_counts(t(prev), t(curr), 4)],
                [pa.motion_counts_ref(t(prev), t(curr), 4)])
    assert_same([pa.tile_motion_best(t(prev), t(curr), tlog=4, stride=4)],
                [pa.tile_motion_best_ref(t(prev), t(curr), 4, 4)])
    launched = bk.launches()
    assert (launched["phase_a_diff"] == launched["motion_counts"]
            == launched["tile_motion_best"] == 0)
    assert set(launched) >= {"phase_a_diff", "motion_counts",
                             "tile_motion_best", "blocked_encode_h"}


def test_wrappers_refuse_other_devices():
    prev = torch.zeros((1, 24, 37, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        pa.phase_a_diff(prev, prev, None, 8192, 8)
    with pytest.raises(ValueError):
        pa.motion_counts(prev, prev, 4)
    with pytest.raises(ValueError):
        pa.motion_counts(prev, prev, 0)
    with pytest.raises(ValueError):
        pa.tile_motion_best(prev, prev, tlog=4, stride=4)
    with pytest.raises(ValueError):
        pa.tile_motion_best(prev, prev, tlog=4, stride=0)
    with pytest.raises(ValueError):
        pa.tile_motion_best(prev, prev, tlog=-1, stride=4)


def test_search_wrappers_refuse_other_frames_on_cpu():
    """K7's and K8's wrappers check the frames before they dispatch, so
    the CPU takes what the card takes."""
    prev, curr = (t(x) for x in frame_pairs(2, 24, 37, 3))
    for call in (lambda p, c: pa.motion_counts(p, c, 4),
                 lambda p, c: pa.tile_motion_best(p, c, tlog=4, stride=4)):
        with pytest.raises(TypeError, match="curr must be torch.uint8"):
            call(prev, curr.to(torch.int32))
        with pytest.raises(ValueError, match="differ"):
            call(prev, curr[:, :, :36])
        with pytest.raises(ValueError, match="frames must be"):
            call(prev[0, 0], curr[0, 0])


@pytest.mark.parametrize("c", [1, 3])
def test_empty_chunks_give_empty_outputs(c):
    h, w = 24, 37
    shape = (0, h, w) if c == 1 else (0, h, w, c)
    prev = torch.zeros(shape, dtype=torch.uint8)
    npad, nb = geometry(h, w)
    for shifts in (None, torch.zeros((0, 2), dtype=torch.int32)):
        masks, counts, vals = pa.phase_a_diff(prev, prev, shifts, npad, nb)
        assert masks.shape == (0, nb, bk.IPB) and masks.dtype == torch.uint8
        assert counts.shape == (0, nb) and counts.dtype == torch.int32
        assert vals.shape == (0, nb, bk.IPB) and vals.dtype == torch.int32
    counts = pa.motion_counts(prev, prev, 4)
    assert counts.shape == (0, pa.CANDIDATES) and counts.dtype == torch.int32
    best = pa.tile_motion_best(prev, prev, tlog=4, stride=4)
    assert best.shape == (0, 2, 3, 3) and best.dtype == torch.int32
