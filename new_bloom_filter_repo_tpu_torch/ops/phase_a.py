"""Phase A of the blocked encoder: kernels K6-K8, wrappers and twins.

Phase A turns a chunk of (previous, current) frame pairs into what the
Bloom encode kernel (K1, ``ops/blocked.py``) takes: each frame's change
mask and 24-bit packed pixels in 1024-item blocks, with the change count
of each block, and, with global motion on, the mismatch counts of the
motion search; the encoder's residual trials add a per-tile search.  The
JAX package leaves all three to XLA, which fuses each into one device
program (``new_bloom_filter_repo_tpu/models/blocked_pipeline.py``:
``_phase_a_pair`` :359, ``_phase_a_motion_pair`` :681,
``_motion_counts_pair`` :406, ``_tile_motion_best`` :528).  Here:

* :func:`phase_a_diff` (K6) gives (masks, counts, vals) of frame pairs,
  against the previous frame as it is or rolled by a per-frame shift;
* :func:`motion_counts` (K7) gives the subsampled mismatch counts of
  every shift in [-R, R]^2 (R = ``MOTION_RADIUS``);
* :func:`tile_motion_best` (K8) gives the same counts summed per square
  tile, reduced to each tile's best shift (one body with K7).

Each dispatches on where its tensors lie, as ``ops/blocked.py``'s
wrappers do: a CPU tensor goes to its plain PyTorch twin
(:func:`phase_a_diff_ref`, :func:`motion_counts_ref`,
:func:`tile_motion_best_ref`), the CPU tests' path and the reference the
kernel is held to; a CUDA tensor goes to the
hand-written Hopper kernel (``ops/csrc/phase_a.cu``), built at first
use, or raises.  Nothing falls back.  Each wrapper counts its launches
in ``<wrapper>.launches`` (``ops.blocked.launches`` reads them with
K1-K5b's).

The roll is the JAX package's to the bit: the source row of row y under
a shift dy is ``(y - dy) % h`` computed in int32, so for dy within h of
-2^31 the difference wraps by 2^32 before the floor modulo (:func:`
roll_index`); the same for columns.
"""

from __future__ import annotations

import torch

from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops._build import MOTION_RADIUS

IPB = bk.IPB
SIDE = 2 * MOTION_RADIUS + 1          # shifts along one axis
CANDIDATES = SIDE * SIDE              # (dy, dx) candidates of the search
MOTION_STRIDE = 4                     # default sample stride
ZERO_CANDIDATE = MOTION_RADIUS * SIDE + MOTION_RADIUS   # the shift (0, 0)
# K7/K8 (ops/csrc/phase_a.cu): a CTA of SIDE warps, one a dy, and a lane
# a sample column: a strip holds at most SEARCH_LANES sample columns (K8:
# the whole tiles that fit, or one wider tile); a staged row holds
# SEARCH_EXTRA columns past the strip's on the fast path; the band's
# samples stay in shared memory, of which a CTA may opt into SMEM_MAX
# bytes.
SEARCH_LANES = 32
SEARCH_EXTRA = 2 * MOTION_RADIUS + 3
SEARCH_BAND_ROWS = 256                # most sample rows a band
SEARCH_LAND = 4                       # fast: landing rows a staging warp
SMEM_MAX = 232448


# ---------------------------------------------------------------------------
# Plain PyTorch twins and their helpers
# ---------------------------------------------------------------------------

def pack_pixels(frames_flat: torch.Tensor) -> torch.Tensor:
    """(F, n, C) uint8 -> (F, n) int32 24-bit packed (C <= 3)."""
    c = frames_flat.shape[-1]
    v = frames_flat[..., 0].to(torch.int32)
    if c > 1:
        v = v | (frames_flat[..., 1].to(torch.int32) << 8)
    if c > 2:
        v = v | (frames_flat[..., 2].to(torch.int32) << 16)
    return v


def packed_hw(frames: torch.Tensor) -> torch.Tensor:
    """(B, h, w[, c]) uint8 -> (B, h, w) int32 packed pixels."""
    b, h, w = frames.shape[:3]
    arr = frames if frames.ndim == 4 else frames[..., None]
    return pack_pixels(arr.reshape(b, h * w, arr.shape[-1])).reshape(b, h, w)


def to_blocks(x: torch.Tensor, npad: int, nb: int) -> torch.Tensor:
    """(F, n) -> (F, nb, IPB), zero-padded to npad items."""
    f, n = x.shape
    if npad != n:
        x = torch.nn.functional.pad(x, (0, npad - n))
    return x.reshape(f, nb, IPB)


def roll_index(n: int, d: torch.Tensor) -> torch.Tensor:
    """(B, n) int64 source positions of np.roll by the (B,) shifts ``d``
    along an axis of length n, as the JAX package computes them:
    ``arange(n) - d`` in int32 (wrapping by 2^32), then a floor modulo."""
    t = torch.arange(n, device=d.device) - d.to(torch.int64)[:, None]
    t = torch.remainder(t + (1 << 31), 1 << 32) - (1 << 31)
    return torch.remainder(t, n)


def roll2d(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor):
    """Per-row np.roll(img[i], (dy[i], dx[i]), axis=(0, 1)) for a
    (B, h, w) batch with (B,) shift tensors (no host sync)."""
    b, h, w = img.shape
    ys = roll_index(h, dy)
    xs = roll_index(w, dx)
    bi = torch.arange(b, device=img.device)[:, None, None]
    return img[bi, ys[:, :, None], xs[:, None, :]]


def phase_a_diff_ref(prev, curr, shifts, npad: int, nb: int):
    """Plain twin of :func:`phase_a_diff`."""
    f, h, w = curr.shape[:3]
    pp = packed_hw(prev)
    pc = packed_hw(curr)
    if shifts is not None:
        pp = roll2d(pp, shifts[:, 0], shifts[:, 1])
    masks = to_blocks((pc != pp).reshape(f, h * w).to(torch.uint8), npad,
                      nb)
    counts = masks.sum(dim=2, dtype=torch.int32)
    return masks, counts, to_blocks(pc.reshape(f, h * w), npad, nb)


def shift_mismatch(prev_u8, curr_u8, stride: int):
    """Yield, for each dy in [-R, R], the (B, sh, D, sw) mismatch map of
    the stride-subsampled current frame against the previous frame
    shifted by (dy, dx) for every dx in [-R, R] (D = 2R + 1)."""
    prev = packed_hw(prev_u8)
    curr = packed_hw(curr_u8)
    h, w = curr.shape[1], curr.shape[2]
    dev = curr.device
    ys = torch.arange(0, h, stride, device=dev)
    xs = torch.arange(0, w, stride, device=dev)
    cs = curr[:, ys][:, :, xs]                          # (B, sh, sw)
    d = torch.arange(-MOTION_RADIUS, MOTION_RADIUS + 1, device=dev)
    px = (xs[None, :] - d[:, None]) % w                 # (D, sw) by dx
    for dy in range(-MOTION_RADIUS, MOTION_RADIUS + 1):
        rows = prev[:, (ys - dy) % h]                   # (B, sh, w)
        yield rows[:, :, px] != cs[:, :, None, :]       # (B, sh, D, sw)


def motion_counts_ref(prev, curr, stride: int = MOTION_STRIDE):
    """Plain twin of :func:`motion_counts`."""
    rows = [ne.sum(dim=(1, 3), dtype=torch.int32)
            for ne in shift_mismatch(prev, curr, stride)]
    return torch.stack(rows, dim=1).reshape(curr.shape[0], CANDIDATES)


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST minimum along ``dim`` (explicit, so ties break
    the same way on every device: the reference takes the first argmin
    in (dy, dx) order)."""
    size = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = size
    idx = torch.arange(size, device=x.device).view(shape)
    mn = x.min(dim=dim, keepdim=True).values
    return torch.where(x == mn, idx, size).min(dim=dim).values


def samples_per_tile(tlog: int, stride: int) -> int:
    """Samples along a side of a square tile of 2**tlog pixels."""
    return max(1, (1 << tlog) // stride)


def tile_motion_best_ref(prev, curr, tlog: int,
                         stride: int = MOTION_STRIDE):
    """Plain twin of :func:`tile_motion_best`."""
    b, h, w = curr.shape[:3]
    sh, sw = -(-h // stride), -(-w // stride)
    spt = samples_per_tile(tlog, stride)
    ty, tx = -(-sh // spt), -(-sw // spt)
    pad_y, pad_x = ty * spt - sh, tx * spt - sw
    rows = []
    for ne in shift_mismatch(prev, curr, stride):
        ne = ne.permute(0, 2, 1, 3).to(torch.int32)     # (B, D, sh, sw)
        ne = torch.nn.functional.pad(ne, (0, pad_x, 0, pad_y))
        rows.append(ne.reshape(b, SIDE, ty, spt, tx, spt).sum(dim=(3, 5)))
    counts = torch.stack(rows, dim=1).reshape(b, CANDIDATES, ty, tx)
    counts = counts.permute(0, 2, 3, 1)                 # (B, ty, tx, C)
    best = first_argmin(counts, -1)
    bc = counts.min(dim=-1).values
    c0 = counts[..., ZERO_CANDIDATE]
    return torch.stack([best, bc, c0], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> twin, CUDA tensor -> kernel (or raise)
# ---------------------------------------------------------------------------

def _frame_geometry(prev, curr):
    """(F, h, w, bytes a pixel) of a pair of frame stacks, checked."""
    if curr.ndim not in (3, 4):
        raise ValueError(f"frames must be (F, h, w) or (F, h, w, C), got "
                         f"{tuple(curr.shape)}")
    f, h, w = curr.shape[:3]
    c = 1 if curr.ndim == 3 else curr.shape[3]
    if h < 1 or w < 1 or c < 1:
        raise ValueError(f"empty frames {tuple(curr.shape)}")
    return f, h, w, c


def _search_frames(prev, curr):
    """:func:`_frame_geometry` of the motion searches' frame pairs, which
    must be uint8 stacks of one shape on either device."""
    for name, x in (("prev", prev), ("curr", curr)):
        if x.dtype != torch.uint8:
            raise TypeError(f"{name} must be torch.uint8, got {x.dtype}")
    if prev.shape != curr.shape:
        raise ValueError(f"prev {tuple(prev.shape)} and curr "
                         f"{tuple(curr.shape)} differ")
    return _frame_geometry(prev, curr)


def _frames(prev, curr):
    return {"prev": (prev, torch.uint8, tuple(curr.shape)),
            "curr": (curr, torch.uint8, tuple(curr.shape))}


def phase_a_diff(prev, curr, shifts, npad: int, nb: int):
    """Masks, per-block counts and packed pixels of frame pairs (K6).

    Args:
      prev, curr: (F, h, w) or (F, h, w, C) uint8 frames; pair j is
        (prev[j], curr[j]).  A pixel is packed to c0 | c1 << 8 | c2 << 16
        from its first three bytes.
      shifts: (F, 2) int32 per-frame (dy, dx): the diff runs against
        np.roll(prev[j], (dy, dx), axis=(0, 1)); None for no roll (zero
        rows give the same bytes).
      npad, nb: items and 1024-item blocks of a padded frame (npad = nb *
        1024 >= h * w).

    Returns (masks (F, NB, 1024) u8: curr != rolled prev; counts (F, NB)
    i32: the masks' sums per block; vals (F, NB, 1024) i32: curr's packed
    pixels), items h * w..npad - 1 zero.  F = 0 gives empty outputs
    without a launch.
    """
    if bk._on_cpu(curr):
        return phase_a_diff_ref(prev, curr, shifts, npad, nb)
    f, h, w, c = _frame_geometry(prev, curr)
    if npad != nb * IPB or h * w > npad or npad >= 1 << 31:
        raise ValueError(f"bad geometry npad={npad} nb={nb} for {h}x{w}")
    dev = curr.device
    named = _frames(prev, curr)
    if shifts is not None:
        named["shifts"] = (shifts, torch.int32, (f, 2))
    ptrs = bk._cuda_args(dev, named)
    if shifts is None:
        ptrs.append(None)
    masks = torch.empty((f, nb, IPB), dtype=torch.uint8, device=dev)
    counts = torch.empty((f, nb), dtype=torch.int32, device=dev)
    vals = torch.empty((f, nb, IPB), dtype=torch.int32, device=dev)
    if f:
        bk._launch("nbf_k6_phase_a_diff",
                   ptrs + [masks.data_ptr(), counts.data_ptr(),
                           vals.data_ptr(), f, nb, h, w, c], dev)
        phase_a_diff.launches += 1
    return masks, counts, vals


def search_geometry(h: int, w: int, c: int, stride: int, strip: int,
                    spt: int = 0, aligned: bool = True,
                    rows: int = 1) -> dict:
    """The layout of a K7 (``spt`` 0) or K8 CTA, as ``search_geometry``
    in ``ops/csrc/phase_a.cu`` computes it: a strip of ``strip`` sample
    columns (K8: whole tiles of ``spt`` samples within SEARCH_LANES
    lanes, or one wider tile); a warp's staged row of P phases of Q
    columns; ``fast``, the stride of the fast path or 0 (strides 4 and
    8, pixels of at most 3 bytes, full strips, w a multiple of 4 and rows
    of a multiple of 16 bytes from a 16-byte boundary, ``aligned``); its
    ``lrow`` landing bytes a row; ``smem`` bytes of shared memory with
    the samples of a band of ``rows`` sample rows (None past
    SMEM_MAX)."""
    p = min(stride, SIDE)
    q = strip + (SEARCH_EXTRA // stride if stride < SIDE else 0)
    cols = p * q
    fast = (stride in (4, 8) and c <= 3 and strip == SEARCH_LANES
            and w % 4 == 0 and w * c % 16 == 0 and aligned and cols <= w)
    lrow = (cols * c + 2 * 16 + 15 + 4) // 16 * 16
    tiles = strip // spt if spt else 0
    hist = -(-SIDE // stride) + 1           # fast: staged rows a group keeps
    smem = ((stride * (hist * cols * 4 + SEARCH_LAND * lrow) if fast
             else SIDE * cols * 4)
            + -(-rows * strip * 4 // 16) * 16 + 2 * tiles * CANDIDATES * 4)
    return {"strip": strip, "tiles": tiles, "P": p, "Q": q,
            "fast": stride if fast else 0, "lrow": lrow,
            "smem": smem if smem <= SMEM_MAX else None}


def _bands(f: int, units: int, per_band: int, strips: int) -> int:
    """Sample rows a band of units (sample rows, or K8's tile rows) of
    ``per_band`` sample rows each, so the grid of f x bands x strips CTAs
    holds about ``bk.TARGET_CTAS`` and a band at most SEARCH_BAND_ROWS
    sample rows (one unit where a unit is more)."""
    bands = min(units, max(1, -(-bk.TARGET_CTAS // max(f * strips, 1)),
                           -(-units * per_band // SEARCH_BAND_ROWS)))
    return -(-units // bands) * per_band


def k7_tiling(f: int, h: int, w: int, c: int, stride: int):
    """(sample rows a CTA, sample columns a strip) of K7: strips of
    SEARCH_LANES columns, bands so the grid holds about
    ``bk.TARGET_CTAS`` CTAs."""
    sh, sw = -(-h // stride), -(-w // stride)
    return _bands(f, sh, 1, -(-sw // SEARCH_LANES)), SEARCH_LANES


def k8_tiling(f: int, h: int, w: int, c: int, tlog: int, stride: int):
    """(samples a tile side, sample rows a CTA, sample columns a strip)
    of K8: as many whole tiles a strip as SEARCH_LANES lanes hold (one
    where a tile is wider), whole tile rows a band, bands so the grid
    holds about ``bk.TARGET_CTAS`` CTAs.  Raises ValueError where a strip
    does not fit the shared memory."""
    spt = samples_per_tile(tlog, stride)
    strip = spt if spt >= SEARCH_LANES else spt * (SEARCH_LANES // spt)
    sh, sw = -(-h // stride), -(-w // stride)
    rows = _bands(f, -(-sh // spt), spt, -(-sw // strip))
    if search_geometry(h, w, c, stride, strip, spt, rows=rows)["smem"] is None:
        raise ValueError(f"K8 takes no tile of {spt} samples at stride "
                         f"{stride}")
    return spt, rows, strip


def motion_counts(prev, curr, stride: int = MOTION_STRIDE):
    """Subsampled mismatch counts of every candidate shift (K7).

    prev, curr: (F, h, w[, C]) uint8 frame pairs.  Returns (F, (2R+1)^2)
    i32: for candidate (dy + R) * (2R + 1) + (dx + R), the number of
    samples (y, x), y in range(0, h, stride) and x in range(0, w,
    stride), whose packed current pixel differs from the previous
    frame's at ((y - dy) mod h, (x - dx) mod w).  F = 0 gives an empty
    output without a launch."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    f, h, w, c = _search_frames(prev, curr)
    if bk._on_cpu(curr):
        return motion_counts_ref(prev, curr, stride)
    dev = curr.device
    ptrs = bk._cuda_args(dev, _frames(prev, curr))
    counts = torch.zeros((f, CANDIDATES), dtype=torch.int32, device=dev)
    if f:
        rows, strip = k7_tiling(f, h, w, c, stride)
        bk._launch("nbf_k7_motion_counts",
                   ptrs + [counts.data_ptr(), f, h, w, c, stride, rows,
                           strip], dev)
        motion_counts.launches += 1
    return counts


def tile_motion_best(prev, curr, *, tlog: int, stride: int = MOTION_STRIDE):
    """Per-tile best shift of the motion search (K8).

    prev, curr: (F, h, w[, C]) uint8 frame pairs.  The samples of
    :func:`motion_counts` fall in square tiles of spt x spt samples (spt
    = max(1, 2**tlog // stride)); per tile, the mismatch counts of every
    candidate shift, samples past the frame counting 0.  Returns (F, ty,
    tx, 3) i32 rows (the first candidate of least count, that count, the
    zero shift's count), ty and tx the tiles down and across.  F = 0
    gives an empty output without a launch."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if tlog < 0:
        raise ValueError(f"tlog must be >= 0, got {tlog}")
    f, h, w, c = _search_frames(prev, curr)
    if bk._on_cpu(curr):
        return tile_motion_best_ref(prev, curr, tlog, stride)
    dev = curr.device
    ptrs = bk._cuda_args(dev, _frames(prev, curr))
    spt, rows, strip = k8_tiling(f, h, w, c, tlog, stride)
    sh, sw = -(-h // stride), -(-w // stride)
    ty, tx = -(-sh // spt), -(-sw // spt)
    out = torch.empty((f, ty, tx, 3), dtype=torch.int32, device=dev)
    if f:
        bk._launch("nbf_k8_tile_motion_best",
                   ptrs + [out.data_ptr(), f, h, w, c, stride, spt, rows,
                           strip], dev)
        tile_motion_best.launches += 1
    return out


_WRAPPERS = (phase_a_diff, motion_counts, tile_motion_best)
for _fn in _WRAPPERS:
    _fn.launches = 0
