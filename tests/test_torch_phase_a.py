"""Phase A of the port (``ops/phase_a.py``) against the JAX package.

The plain twins of K6 and K7, ``phase_a_diff_ref`` and
``motion_counts_ref``, are held to the JAX functions they stand for
(``_phase_a_pair``, ``_phase_a_motion_pair`` and ``_motion_counts_pair``
of ``new_bloom_filter_repo_tpu/models/blocked_pipeline.py``) on the same
seeded numpy frames; numpy mirrors of the kernels' index arithmetic
(``ops/csrc/phase_a.cu``) are held to the twins; and the wrappers keep
their contract on the CPU.  Every comparison is exact.
"""

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


def k7_mirror(prev, curr, stride):
    """K7 as the kernel walks it: CTAs over (band of sample rows, frame)
    from k7_tiling; per sample row and tile of sample columns, the 2R + 1
    staged previous rows (row ri = (y + R - ri) mod h) over the tile's
    columns and a halo of R (staged column ci = (x0 - R + ci) mod w);
    candidate t = dyi * (2R + 1) + dxi compares staged column k * stride
    + 2R - dxi of row dyi with sample k; per-CTA sums added up."""
    f, h, w = curr.shape[:3]
    pp = n(pa.packed_hw(t(prev)))
    pc = n(pa.packed_hw(t(curr)))
    side = 2 * R + 1
    sh, sw = -(-h // stride), -(-w // stride)
    rows, tile = pa.k7_tiling(f, h, stride)
    dyi, dxi = np.divmod(np.arange(side * side), side)
    out = np.zeros((f, side * side), np.int64)
    for j in range(f):
        for band in range(-(-sh // rows)):
            cnt = np.zeros(side * side, np.int64)
            for r in range(band * rows, min(sh, band * rows + rows)):
                y = r * stride
                for k0 in range(0, sw, tile):
                    nk = min(tile, sw - k0)
                    x0 = k0 * stride
                    cols = (nk - 1) * stride + side
                    ys = (y + R - np.arange(side)) % h
                    xs = (x0 - R + np.arange(cols)) % w
                    staged = pp[j][ys[:, None], xs[None, :]]
                    cur = pc[j, y, x0 + np.arange(nk) * stride]
                    k = np.arange(nk)
                    ref = staged[dyi[:, None],
                                 k[None, :] * stride + 2 * R - dxi[:, None]]
                    cnt += (ref != cur[None, :]).sum(axis=1)
            out[j] += cnt
    return out.astype(np.int32)


@pytest.mark.parametrize("case", COUNT_CASES,
                         ids=lambda s: case_id(s) + f"-s{s[4]}")
def test_k7_mirror_matches_twin(case):
    h, w, c, f, stride = case
    prev, curr = frame_pairs(f, h, w, c, seed=h + w + stride)
    np.testing.assert_array_equal(
        k7_mirror(prev, curr, stride),
        n(pa.motion_counts_ref(t(prev), t(curr), stride)))


@pytest.mark.parametrize("f,h,stride", [(1, 1080, 8), (15, 1080, 8),
                                        (120, 1080, 8), (24, 2160, 8),
                                        (15, 540, 4), (1, 7, 100)])
def test_k7_tiling_stays_in_shared_memory(f, h, stride):
    """K7's tiles fit the 48 KB of shared memory a CTA gets without
    opting in, and its bands cover every sample row."""
    rows, tile = pa.k7_tiling(f, h, stride)
    span = (tile - 1) * stride + pa.SIDE
    assert span <= pa.K7_MAX_SPAN == 3 * 256
    assert (pa.SIDE * span + tile) * 4 <= 48 * 1024
    assert 1 <= tile <= pa.K7_TILE and rows >= 1
    sh = -(-h // stride)
    bands = -(-sh // rows)
    assert (bands - 1) * rows < sh <= bands * rows


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
    launched = bk.launches()
    assert launched["phase_a_diff"] == launched["motion_counts"] == 0
    assert set(launched) >= {"phase_a_diff", "motion_counts",
                             "blocked_encode_h"}


def test_wrappers_refuse_other_devices():
    prev = torch.zeros((1, 24, 37, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        pa.phase_a_diff(prev, prev, None, 8192, 8)
    with pytest.raises(ValueError):
        pa.motion_counts(prev, prev, 4)
    with pytest.raises(ValueError):
        pa.motion_counts(prev, prev, 0)


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
