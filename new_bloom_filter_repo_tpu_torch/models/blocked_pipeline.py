"""BFV3 host orchestration over the blocked kernels, in PyTorch.

The port of ``new_bloom_filter_repo_tpu.models.blocked_pipeline``.  Per
chunk of up to ``_CHUNK`` inter frames: phase A (exact diff masks,
per-block change counts, 24-bit packed pixels, and the global-motion
search) runs on the encoder's device as kernels K7 (the search's counts)
and K6 (the diff; ``ops/phase_a.py``), with the shift gate between them
as torch ops (the residual trials' per-tile search is K8); the host runs
the reference float64 parameter math (p, k, l, then m = round(l / nb)); one
kernel launch Bloom-encodes the chunk (``ops/blocked.py`` K1); the host
assembles records.  Decode mirrors it: parse, membership kernel (K2),
host witness/value slicing, then the fused expansion + chain kernel
(K3), or for runs with motion the expansion kernel (K4) followed by a
per-frame roll chain, and one pull of the frames (into pinned host
memory, issued at launch, on a CUDA device).

Every tensor lives on the ``device`` the encoder or decoder was built
with; CPU tensors take the kernels' plain twins.  Built with a ``mesh``
(``parallel/mesh.py``) of more than one cell, both route phase A and
the kernels through the frame- and block-sharded programs of
``parallel/blocked_batch.py`` (:class:`_MeshDispatch`) and gather the
results on the mesh's home device; K3, which chains each block column
through the whole chunk, runs there unsharded.  The stream is
byte-identical with or without a mesh.  Record selection and the host
``finish()`` phase are the reference's, unchanged:

  count == 0                  -> EMPTY (type 2)
  density > 0.45              -> DPCM residual (type 8) or keyframe,
                                 whichever stores fewer bytes
  m would be < MIN_M          -> SPARSE (type 4: indices + values)
  p >= P* or l degenerate     -> pass-through (type 0/7) vs residual,
                                 whichever stores fewer bytes
  otherwise                   -> BLOCKED (type 3, or 7 when a section
                                 entropy-codes smaller)
Nonzero global-motion shifts wrap any of these with a type-6 header.

A mesh may span several processes (``parallel.mesh.
initialize_distributed``): every process then makes the same calls on
the same frames, runs the device stages of its own cells, receives
every other cell's outputs, and so assembles the same records.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
from new_bloom_filter_repo_tpu_torch.models.binary_codec import _filter_scalars
from new_bloom_filter_repo_tpu_torch.models.bloom import (
    P_STAR,
    optimal_compression_params,
)
from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa
from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
    SUPER,
    blocked_tables,
    npad_of,
)
from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch as bb
from new_bloom_filter_repo_tpu_torch.parallel.mesh import home_device
from new_bloom_filter_repo_tpu_torch.utils import native, profiling

__all__ = ["BlockedEncoder", "BlockedDecoder", "SUPER", "blocked_tables",
           "npad_of"]

MIN_M = 16            # below this sub-filter width a sparse record wins
KEY_DENSITY = 0.45    # scene-cut fallback
RANS8_MIN = 4096      # byte-rANS trial floor: its 384-byte stored
                      # frequency table needs a few KB to amortize
RANSC_MIN = 16384     # order-1 context rANS floor: 8 conditional
                      # tables = 3072 stored bytes to amortize
FILTER_GATE = 0.25    # try filtered-residual (type 14) trials only
                      # when plain DEFLATE stores > this fraction of
                      # the raw bytes (else LZ already won; measured:
                      # half-pel residuals at 0.40 gain 19% filtered,
                      # grain residuals at 0.21 never do)


# ---------------------------------------------------------------------------
# Phase A: diff masks, per-block counts, packed pixels (ops/phase_a.py:
# K6, K7 and K8 for the motion searches, on a CUDA device; their twins on
# a CPU)
# ---------------------------------------------------------------------------

# The JAX module's names for two of phase A's helpers
_pack_pixels = pa.pack_pixels
_roll2d = pa.roll2d


def _phase_a_pair(prev, curr, *, npad: int, nb: int):
    """Masks + per-block counts + packed pixels from (prev, curr) frame
    pairs (K6).  Pixels are packed to 24-bit ints, so the change mask is
    one int32 compare (any channel differs, for c <= 3) and the packed
    values are reused as the witness payload."""
    return pa.phase_a_diff(prev.contiguous(), curr.contiguous(), None,
                           npad, nb)


def _phase_a(stacked, *, npad: int, nb: int):
    """:func:`_phase_a_pair` over a stacked (F+1, h, w[, c]) chunk.
    Returns (masks (F,NB,IPB) u8, counts (F,NB) i32, vals (F,NB,IPB) i32)."""
    return _phase_a_pair(stacked[:-1], stacked[1:], npad=npad, nb=nb)


# Global-motion estimation: a per-frame (dy, dx) shift searched on the
# device collapses camera-pan content from dense-mask keyframe fallback
# to near-static cost.  np.roll (wrap-around) semantics on (H, W); the
# wrapped edge strip self-codes as ordinary changed pixels.

MOTION_RADIUS = pa.MOTION_RADIUS   # search window: shifts in [-R, R]^2
MOTION_STRIDE = pa.MOTION_STRIDE   # subsampled count grid (n/16 samples)
MOTION_ACCEPT = 0.7    # accept the best shift iff count <= 0.7 * count(0,0)
MOTION_ACCEPT_10 = 7   # ... which the gates test as cb * 10 <= c0 * 7
MOTION_MIN_C0 = 64     # ... and the zero-shift count is worth beating


def _motion_counts_pair(prev_u8, curr_u8, stride: int = MOTION_STRIDE):
    """Per-(prev, curr)-pair subsampled mismatch counts over the shift
    window (K7).  prev_u8/curr_u8: (B, h, w[, c]) uint8; returns (B, C)
    i32, candidate index (dy+R)*(2R+1)+(dx+R)."""
    return pa.motion_counts(prev_u8.contiguous(), curr_u8.contiguous(),
                            stride)


def _motion_counts(stacked, *, stride: int = MOTION_STRIDE):
    """:func:`_motion_counts_pair` over a stacked (F+1, h, w[, c]) uint8
    chunk: (F, (2R+1)^2) i32 mismatch counts for every candidate shift
    of the previous frame."""
    return _motion_counts_pair(stacked[:-1], stacked[1:], stride=stride)


def motion_stride(h: int, w: int) -> int:
    """Count-grid stride for the motion searches: 4 keeps small frames
    sensitive; 1MP+ frames (720p/1080p/4K) use 8 — still tens of
    thousands of samples, at a quarter of the compare cost."""
    return 8 if h * w >= (1 << 20) else MOTION_STRIDE


def tile_log(h: int, w: int) -> int:
    """Tile side (log2) for the per-tile trial: 16-px tiles below 1MP
    (finer maps track radial zoom/rotation fields — 4% smaller zoom
    streams than 32-px, and the map bytes are DEFLATE'd so coherent
    regions stay cheap), 64-px above — the bigger tiles keep the
    1080p/4K map overhead (and search memory) small at 8x8 count
    samples per tile with :func:`motion_stride` = 8."""
    return 6 if h * w >= (1 << 20) else TILE_LOG


def choose_shifts(counts: np.ndarray) -> np.ndarray:
    """Host shift decision from :func:`_motion_counts` output, (F, 2)
    int32.

    Deterministic: first argmin in (dy, dx) lexicographic order; the
    zero shift wins unless the best candidate beats it by the margin (a
    wrong pick only costs ratio, never losslessness, but zero shifts
    keep static content's streams byte-identical to motion-off
    encodes).  The gate is exact integer math (cb * 10 <= c0 * 7), the
    one :func:`_phase_a_auto_pair` takes on the device."""
    f = counts.shape[0]
    side = 2 * MOTION_RADIUS + 1
    zero_idx = MOTION_RADIUS * side + MOTION_RADIUS
    shifts = np.zeros((f, 2), np.int32)
    best = np.argmin(counts, axis=1)
    c0 = counts[:, zero_idx].astype(np.int64)
    cb = counts[np.arange(f), best].astype(np.int64)
    take = (c0 >= MOTION_MIN_C0) & (cb * 10 <= c0 * MOTION_ACCEPT_10)
    shifts[take, 0] = best[take] // side - MOTION_RADIUS
    shifts[take, 1] = best[take] % side - MOTION_RADIUS
    return shifts


def _phase_a_auto_pair(prev, curr, *, stride: int, npad: int, nb: int):
    """Phase A with the motion search, the shift decision and the
    motion-rolled diff in one pass on the device.  The shift gate is the
    reference's: the first argmin in (dy, dx) order, taken only when the
    zero-shift count is worth beating (c0 >= MOTION_MIN_C0) and the best
    count clears the margin in exact integer math, so the decision is
    the same on every device.

    Returns (masks, counts, vals, shifts, best_shifts)."""
    counts225 = _motion_counts_pair(prev, curr, stride=stride)
    side = 2 * MOTION_RADIUS + 1
    zero_idx = MOTION_RADIUS * side + MOTION_RADIUS
    best = pa.first_argmin(counts225, 1)
    # int32 margin products: counts are subsampled-grid mismatch counts
    # (< n/stride^2), so cb * 10 stays far below 2^31 at any geometry
    c0 = counts225[:, zero_idx]
    cb = torch.gather(counts225, 1, best[:, None])[:, 0]
    take = (c0 >= MOTION_MIN_C0) & (cb * 10 <= c0 * MOTION_ACCEPT_10)
    by = (best // side - MOTION_RADIUS).to(torch.int32)
    bx = (best % side - MOTION_RADIUS).to(torch.int32)
    best_shifts = torch.stack([by, bx], dim=-1)
    shifts = torch.where(take[:, None], best_shifts, 0).to(torch.int32)
    masks, counts, vals = _phase_a_motion_pair(prev, curr, shifts,
                                               npad=npad, nb=nb)
    return masks, counts, vals, shifts, best_shifts


def _phase_a_auto(stacked, *, stride: int, npad: int, nb: int):
    """:func:`_phase_a_auto_pair` over a stacked (F+1, h, w[, c]) chunk."""
    return _phase_a_auto_pair(stacked[:-1], stacked[1:], stride=stride,
                              npad=npad, nb=nb)


TILE_LOG = 4       # 16-px tiles for the per-tile residual trial (<1MP)
TILE_ACCEPT = 0.8  # accept a tile's best shift iff count <= 0.8 * c0
TILE_MIN_C0 = 4    # ... and the tile's zero-shift count is worth beating



def _tile_motion_best(stacked, *, tlog: int, stride: int = MOTION_STRIDE):
    """Per-TILE best-shift summary over the global search window (K8).

    stacked: (F+1, h, w[, c]) uint8.  Returns (F, ty, tx, 3) i32 rows
    (best_candidate_idx, best_count, zero_shift_count) per square tile
    of side 2**tlog, from the same subsampled mismatch counts as the
    global search — the device half of the type-10 per-tile motion
    trial.  Reduced on the device, so only (F, ty, tx, 3) is pulled."""
    return pa.tile_motion_best(stacked[:-1].contiguous(),
                               stacked[1:].contiguous(), tlog=tlog,
                               stride=stride)


def choose_tile_shifts(summary: np.ndarray) -> np.ndarray:
    """Host per-tile shift decision from one frame's
    :func:`_tile_motion_best` row (ty, tx, 3).  Returns (ty, tx, 2)
    int8.  Deterministic; tiles keep the zero shift unless their best
    candidate clears the TILE_ACCEPT margin (a wrong pick only costs
    ratio — the residual stays exact)."""
    side = 2 * MOTION_RADIUS + 1
    best, bc, c0 = summary[..., 0], summary[..., 1], summary[..., 2]
    take = (c0 >= TILE_MIN_C0) & (bc <= TILE_ACCEPT * c0)
    t = np.zeros(best.shape + (2,), np.int8)
    t[take, 0] = (best[take] // side - MOTION_RADIUS).astype(np.int8)
    t[take, 1] = (best[take] % side - MOTION_RADIUS).astype(np.int8)
    return t


def _tile_hp_refine(prev: np.ndarray, curr: np.ndarray,
                    tsh: np.ndarray, tlog: int,
                    stride: int) -> Optional[np.ndarray]:
    """Half-pel refinement of an integer per-tile shift map (host side
    of the type-17 trial).

    For each tile, scores the 9 half-pel neighbors of its integer shift
    (2*tsh + {-1,0,1}^2) by wrap-aware subsampled SAD under the exact
    type-17 prediction (edge-clamped bilinear, tile_predict_hp
    rounding) and keeps the per-tile argmin, ties preferring the even
    phase.  Returns the (ty, tx, 2) int8 HALF-PEL map, or None when the
    refined map does not beat the pure-integer map by >0.5% total SAD
    (the margin the global half-pel probe also uses) — fractional
    phases that don't help only bloat the map and the trial cost.

    Captures spatially-varying fractional motion (zoom/rotation fields)
    that neither the integer tile map nor one global half-pel shift can
    fit; the per-tile independence keeps it one vectorized pass."""
    h, w = curr.shape[:2]
    ys = np.arange(0, h, stride, dtype=np.int32)
    xs = np.arange(0, w, stride, dtype=np.int32)
    ti, tj = ys >> tlog, xs >> tlog
    ty, tx = tsh.shape[:2]
    idx = (ti[:, None] * tx + tj[None, :]).ravel()
    sy_base = tsh[:, :, 0].astype(np.int32)[ti[:, None], tj[None, :]] * 2
    sx_base = tsh[:, :, 1].astype(np.int32)[ti[:, None], tj[None, :]] * 2
    cs = curr[ys[:, None], xs[None, :]].astype(np.int16)
    yy, xx = ys[:, None], xs[None, :]
    offsets = [(0, 0), (-1, -1), (-1, 0), (-1, 1), (0, -1),
               (0, 1), (1, -1), (1, 0), (1, 1)]
    sads = []
    for oy, ox in offsets:
        sy, sx = sy_base + oy, sx_base + ox
        iy, fy = sy >> 1, (sy & 1).astype(np.uint16)
        ix, fx = sx >> 1, (sx & 1).astype(np.uint16)
        r0 = np.clip(yy - iy, 0, h - 1)
        r1 = np.clip(yy - iy - 1, 0, h - 1)
        c0 = np.clip(xx - ix, 0, w - 1)
        c1 = np.clip(xx - ix - 1, 0, w - 1)
        if curr.ndim == 3:
            fy, fx = fy[..., None], fx[..., None]
        acc = (prev[r0, c0].astype(np.uint16) + fx * prev[r0, c1]
               + fy * prev[r1, c0] + (fy * fx) * prev[r1, c1])
        sh = fy + fx
        pred = ((acc + ((1 << sh) >> 1)) >> sh).astype(np.int16)
        d = (cs - pred) & 0xFF
        fold = np.minimum(d, 256 - d)
        if fold.ndim == 3:
            fold = fold.sum(axis=2)
        sads.append(np.bincount(idx, weights=fold.ravel(),
                                minlength=ty * tx))
    sads = np.stack(sads)                  # (9, ty*tx)
    pick = np.argmin(sads, axis=0)         # first-min: (0,0) wins ties
    best = sads[pick, np.arange(ty * tx)].sum()
    if best >= 0.995 * sads[0].sum():
        return None
    off = np.asarray(offsets, np.int32)[pick].reshape(ty, tx, 2)
    return (tsh.astype(np.int32) * 2 + off).astype(np.int8)


def _rot_fit(tsh: np.ndarray, tlog: int, h: int, w: int) -> float:
    """Least-squares CURL fit of an accepted integer tile-shift map:
    a rotation's motion field is (dy, dx) = theta * (x - cx, -(y - cy)),
    so theta ~ [sum(dy * rx) - sum(dx * ry)] / sum(r^2).  Returns theta
    in radians — the seed for the type-20 parametric rotation search
    (sign convention probes both ways regardless)."""
    t = 1 << tlog
    ty, tx = tsh.shape[:2]
    ry = (np.arange(ty) + 0.5) * t - h / 2.0
    rx = (np.arange(tx) + 0.5) * t - w / 2.0
    sy = tsh[..., 0].astype(np.float64)
    sx = tsh[..., 1].astype(np.float64)
    num = (sy * rx[None, :]).sum() - (sx * ry[:, None]).sum()
    den = float((ry * ry).sum() * tx + (rx * rx).sum() * ty)
    return num / den if den else 0.0


def _zoom_fit(tsh: np.ndarray, tlog: int, h: int, w: int) -> float:
    """Least-squares radial fit of an accepted integer tile-shift map:
    shift ≈ z * (tile centre - frame centre) per axis.  Returns z
    (pixels of shift per pixel of radius, ~ per-frame scale delta) —
    the seed for the type-18 parametric zoom search."""
    t = 1 << tlog
    ty, tx = tsh.shape[:2]
    ry = (np.arange(ty) + 0.5) * t - h / 2.0
    rx = (np.arange(tx) + 0.5) * t - w / 2.0
    sy = tsh[..., 0].astype(np.float64)
    sx = tsh[..., 1].astype(np.float64)
    num = (sy * ry[:, None]).sum() + (sx * rx[None, :]).sum()
    den = float((ry * ry).sum() * tx + (rx * rx).sum() * ty)
    return num / den if den else 0.0



def _phase_a_motion_pair(prev, curr, shifts, *, npad: int, nb: int):
    """Motion-diff masks/counts/values from (prev, curr, shift) rows
    (K6): the diff runs against roll(prev, (dy, dx)); zero shifts
    reproduce :func:`_phase_a_pair` exactly."""
    return pa.phase_a_diff(prev.contiguous(), curr.contiguous(),
                           shifts.contiguous(), npad, nb)


def _phase_a_motion(stacked, shifts, *, npad: int, nb: int):
    """:func:`_phase_a` with per-frame global-motion shifts, (F, 2) i32:
    the diff runs against roll(prev, (dy, dx)) instead of prev; zero
    rows reproduce :func:`_phase_a`'s masks exactly."""
    return _phase_a_motion_pair(stacked[:-1], stacked[1:], shifts,
                                npad=npad, nb=nb)


def _packbits_rows(flat: torch.Tensor, npad: int) -> torch.Tensor:
    """(F, n) bool -> (F, npad // 8) u8, np.packbits order."""
    f, n = flat.shape
    x = flat.to(torch.uint8)
    if npad != n:
        x = torch.nn.functional.pad(x, (0, npad - n))
    return bk._pack_bits_msb(x)


def _phase_a_packed_motion(stacked, shifts, *, npad: int):
    """packbits(motion diff mask) — the :func:`_phase_a_packed` variant
    for chunks carrying nonzero shifts."""
    packed = pa.packed_hw(stacked)
    rolled_prev = _roll2d(packed[:-1], shifts[:, 0], shifts[:, 1])
    f = packed.shape[0] - 1
    return _packbits_rows((packed[1:] != rolled_prev).reshape(f, -1), npad)


def _phase_a_packed(stacked, *, npad: int):
    """packbits(diff mask) for a chunk — pulled only when a
    pass-through or sparse record needs the raw mask bytes."""
    neq = stacked[1:] != stacked[:-1]
    if neq.ndim == 4:
        neq = neq.any(dim=-1)
    return _packbits_rows(neq.reshape(neq.shape[0], -1), npad)


def _split_bytes24(v: torch.Tensor, channels: int):
    """24-bit packed ints -> list of c uint8 tensors (low byte first) —
    the single definition of the pixel byte order every pack/unpack
    path in this module shares."""
    outs = [(v & 0xFF).to(torch.uint8)]
    if channels > 1:
        outs.append(((v >> 8) & 0xFF).to(torch.uint8))
    if channels > 2:
        outs.append(((v >> 16) & 0xFF).to(torch.uint8))
    return outs


def _join_bytes24(parts):
    """Inverse of :func:`_split_bytes24`."""
    out = parts[0].to(torch.int32)
    if len(parts) > 1:
        out = out | (parts[1].to(torch.int32) << 8)
    if len(parts) > 2:
        out = out | (parts[2].to(torch.int32) << 16)
    return out


def _pack_vseg_bytes(vseg: torch.Tensor, channels: int) -> torch.Tensor:
    """(F,NB,vh*32) i32 packed value slots -> (F,NB,vh*32*c) u8
    pixel-major bytes — the byte stream the record assembler needs,
    repacked on the device so the pull carries c bytes per slot."""
    st = torch.stack(_split_bytes24(vseg, channels), dim=-1)
    return st.reshape(st.shape[0], st.shape[1], -1)


def _unpack_vseg_bytes(vb: torch.Tensor, channels: int) -> torch.Tensor:
    """Inverse of :func:`_pack_vseg_bytes` (decode-side upload form)."""
    f_, nb_, w = vb.shape
    v = vb.reshape(f_, nb_, w // channels, channels)
    return _join_bytes24([v[..., i] for i in range(channels)])


def _pack_base(base: torch.Tensor, *, npad: int, nb: int) -> torch.Tensor:
    """(h, w[, c]) uint8 -> (NB, IPB) i32 24-bit packed pixels."""
    packed = pa.packed_hw(base[None]).reshape(1, -1)
    return pa.to_blocks(packed, npad, nb)[0]


def _unpack_frames(packed: torch.Tensor, *, shape) -> torch.Tensor:
    """(F, NB, IPB) i32 packed pixels -> (F,) + shape uint8 frames."""
    h, w = shape[:2]
    c = 1 if len(shape) == 2 else shape[2]
    f = packed.shape[0]
    v = packed.reshape(f, -1)[:, : h * w]
    return torch.stack(_split_bytes24(v, c), dim=-1).reshape((f,) + shape)


def _chain_apply_motion(base: torch.Tensor, masks, vals, shifts, *, shape):
    """Apply decoded per-frame (mask, packed-value) deltas as a chain
    with per-frame global-motion rolls (type-6 records):
    frame_j = where(mask_j, vals_j, roll(frame_{j-1}, shifts[j])) on
    24-bit packed pixels.  ``shifts``: host (F, 2) ints.  The roll moves
    pixels across blocks, so this stays a per-frame loop of torch ops."""
    h, w = shape[:2]
    n = h * w
    f = masks.shape[0]
    m2 = masks.reshape(f, -1)[:, :n].reshape(f, h, w)
    v2 = vals.reshape(f, -1)[:, :n].reshape(f, h, w)
    prev = pa.packed_hw(base[None])[0]
    out = []
    for j in range(f):
        dy, dx = int(shifts[j, 0]), int(shifts[j, 1])
        rolled = (torch.roll(prev, shifts=(dy, dx), dims=(0, 1))
                  if dy or dx else prev)
        prev = torch.where(m2[j] > 0, v2[j], rolled)
        out.append(prev)
    return _unpack_frames(torch.stack(out), shape=shape)


def _vh_bucket(max_count: int) -> int:
    """Value rows (vh*32 slots) covering max per-block change count."""
    need = max(1, (max_count + 31) // 32)
    vh = 1
    while vh < need:
        vh *= 2
    return min(vh, 32)


def nbk_of(nb: int) -> int:
    """The JAX package's kernel block count: ``nb`` rounded up to a
    multiple of 64 from nb = 512 on (its Pallas grid's tiles).  The port's
    kernels run over ``nb`` blocks; its decoder still counts the JAX
    decoder's padded blocks into the witness and value slicing
    (:func:`padded_block_wcnt`)."""
    return ((nb + 63) // 64) * 64 if nb >= 512 else nb


def padded_block_wcnt(parsed: dict, nb: int) -> np.ndarray:
    """(F, nbk_of(nb) - nb) membership counts of the JAX decoder's padded
    blocks, whose sub-filter words and hash tables are zero: an item
    there probes bit 0 of a zero word, so it passes iff its frame is not
    flagged and has no active lane, that is floor(k) < 0, or floor(k) = 0
    with a zero activation threshold (the zero activation hash is below
    any other).  Only a damaged k gives such a frame; it then wants 128
    witness bytes more a padded block, as in the JAX package."""
    fk = parsed["fk_arr"]
    no_lane = (fk < 0) | ((fk == 0) & (parsed["thi"] == 0)
                          & (parsed["tlo"] == 0))
    open_ = (parsed["flags"] == 0) & no_lane
    return np.repeat((open_ * bk.IPB).astype(np.int32)[:, None],
                     nbk_of(nb) - nb, axis=1)


def chunk_params(counts: np.ndarray, n: int, nb: int):
    """Host float64 parameter math of one chunk from its per-block
    change counts (F, NB): the record kind of every frame ("empty",
    "key", "pass", "sparse" or "blocked"), its k, and the blocked
    frames' filter scalars m, floor(k) and the u64 activation threshold
    as u32 (hi, lo).  Returns ``(kinds, ks, m_arr, fk_arr, thi, tlo,
    geom)``; ``geom`` holds K1's run-time geometry: ``k_lanes`` (lanes
    0..max floor(k), capped as the decoder caps it: ``bk.lane_count``),
    ``nw`` (words covering the largest m) and ``vh`` (value rows
    covering the largest block count).  The bytes do not
    depend on the geometry as long as it covers every frame."""
    f = counts.shape[0]
    frame_counts = counts.sum(axis=1)
    row_max = counts.max(axis=1)
    kinds: List[str] = []
    ks = np.zeros(f, np.float64)
    m_arr = np.ones(f, np.int32)
    fk_arr = np.zeros(f, np.int32)
    thi = np.zeros(f, np.uint32)
    tlo = np.zeros(f, np.uint32)
    max_block = 1
    for j in range(f):
        cnt = int(frame_counts[j])
        p = cnt / n
        if cnt == 0:
            kinds.append("empty")
            continue
        if p > KEY_DENSITY:
            kinds.append("key")
            continue
        max_block = max(max_block, int(row_max[j]))
        k, l = optimal_compression_params(n, p)
        ks[j] = k
        m = int(round(l / nb)) if l else 0
        if p >= P_STAR or l == 0 or l >= n:
            kinds.append("pass")
            continue
        if m < MIN_M:
            kinds.append("sparse")
            continue
        kinds.append("blocked")
        m_arr[j] = min(m, bk.MMAX)
        _, floor_k, (a_hi, a_lo) = _filter_scalars(k)
        fk_arr[j] = floor_k
        thi[j] = a_hi
        tlo[j] = a_lo
    geom = {"k_lanes": bk.lane_count(fk_arr.max()),
            "nw": max(1, (int(m_arr.max()) + 31) // 32),
            "vh": _vh_bucket(max_block)}
    return kinds, ks, m_arr, fk_arr, thi, tlo, geom


def frame_scalars(device, m_arr, thi, tlo, fk_arr):
    """The per-frame kernel scalars (m, thi, tlo, floor_k) as int32
    tensors on ``device``; the u32 thresholds travel as int32 bit
    patterns."""
    return tuple(torch.from_numpy(a.view(np.int32)).to(device)
                 for a in (m_arr, thi, tlo, fk_arr))


def _frame_mod_tables(h1, h2, act_hi, act_lo, m_arr, t_hi, t_lo):
    """Per-frame position tables and activation bits, materialized: the
    inputs of K5a/K5b.  h1/h2: (NB, IPB) i32 24-bit hashes; act_hi,
    act_lo: (NB, IPB) and t_hi, t_lo: (F,) u32 bit patterns in int32
    (compared unsigned on int64-widened values); m_arr: (F,) i32.
    Returns a, b (F,NB,IPB) i32 and act (F,NB,IPB) u8."""
    a, b, act = bk._prelude(h1, h2, act_hi, act_lo, m_arr, t_hi, t_lo)
    return a.to(torch.int32), b.to(torch.int32), act.to(torch.uint8)


class _MeshDispatch:
    """Routes phase A and the blocked kernels through the dp/dpsp-
    sharded programs of ``parallel/blocked_batch.py``.

    Frames shard over ``dp`` and, when the mesh's ``sp`` axis is larger
    than 1, the block axis shards over ``sp``.  Neither axis needs
    collectives, and the record geometry (npad, nb) is canonical per n,
    so sharded and unsharded pipelines emit byte-identical streams.
    Every result is gathered on the mesh's home device.

    On a mesh whose cells belong to several processes (``multiproc``)
    each process runs the shards of its own cells and every result
    reaches every process's home device, so the host record stages run
    alike everywhere and every process writes the same bytes.  The
    methods below are called from the thread that drives the device
    phase, in the same order in every process (the host ``finish()``
    phase, which may run on a worker thread, calls none of them)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sp = int(mesh.shape["sp"])
        # the mesh spans more than one process
        # (parallel.mesh.initialize_distributed was called)
        self.multiproc = bool(mesh.multiproc)

    def _loc(self, x):
        """A program input across processes: every process holds the
        identical full copy and cuts its own cells' shards from it
        (``bb.run_sharded``), so nothing is sent on the way in."""
        return x

    def _glob(self, *arrays):
        """Program outputs across processes: full copies on this
        process's home device.  ``bb.run_sharded`` has made the hop
        (``bb._exchange``; ``bb.hop_stats()`` times it), so every pull
        after this sees what one device would hold."""
        return arrays if len(arrays) > 1 else arrays[0]

    @staticmethod
    def _pairs(stacked):
        """(prev, curr) frame pairs of a stacked (F+1, h, w[, c]) chunk,
        built BEFORE sharding, so no shard needs a neighbour's frame."""
        return stacked[:-1], stacked[1:]

    def _frames(self, fn, *args):
        return bb.run_sharded(self.mesh, fn, [self._loc(a) for a in args],
                              (bb.DP,) * len(args), block_axis=False)

    def phase_a(self, stacked, *, npad: int, nb: int):
        """dp-sharded diff stage: masks, counts, vals."""
        return self._glob(*self._frames(
            lambda p, c: _phase_a_pair(p, c, npad=npad, nb=nb),
            *self._pairs(stacked)))

    def motion_counts(self, stacked, stride: int):
        """dp-sharded global-motion search counts."""
        return self._glob(*self._frames(
            lambda p, c: (_motion_counts_pair(p, c, stride=stride),),
            *self._pairs(stacked)))

    def phase_a_auto(self, stacked, stride: int, *, npad: int, nb: int):
        """dp-sharded fused phase A (motion search, the per-pair shift
        decision, rolled diff): masks, counts, vals, shifts, best."""
        return self._glob(*self._frames(
            lambda p, c: _phase_a_auto_pair(p, c, stride=stride, npad=npad,
                                            nb=nb),
            *self._pairs(stacked)))

    def phase_a_motion(self, stacked, shifts, *, npad: int, nb: int):
        """dp-sharded motion diff stage (rows independent)."""
        return self._glob(*self._frames(
            lambda p, c, s: _phase_a_motion_pair(p, c, s, npad=npad, nb=nb),
            *self._pairs(stacked), shifts))

    def _tables(self, tab):
        return tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"]

    def encode(self, masks, vals, tab, m, thi, tlo, fk, *, k_lanes, vh, nw,
               channels):
        """Sharded K1 encode; value segments repacked to bytes."""
        make = (bb.make_blocked_encode_h_dpsp if self.sp > 1
                else bb.make_blocked_encode_h_dp)
        w, wi, wc, vs, vc = self._glob(*make(
            self.mesh, k_lanes=k_lanes, vh=vh, nw=nw)(
            *(self._loc(a) for a in (masks, *self._tables(tab), vals, m,
                                     thi, tlo, fk))))
        return w, wi, wc, _pack_vseg_bytes(vs, channels), vc

    def membership(self, words, tab, m, thi, tlo, fk, flags, *, k_lanes,
                   nw):
        """Sharded K2 membership: (passes, wcnt)."""
        make = (bb.make_blocked_membership_h_dpsp if self.sp > 1
                else bb.make_blocked_membership_h_dp)
        return self._glob(*make(self.mesh, k_lanes=k_lanes, nw=nw)(
            *(self._loc(a) for a in (words, *self._tables(tab), m, thi, tlo,
                                     fk, flags))))

    def expand(self, passes, wit, raw, flags, vseg_bytes, *, vh, channels):
        """Value bytes unpacked to packed pixels, then sharded K4."""
        make = (bb.make_blocked_expand_dpsp if self.sp > 1
                else bb.make_blocked_expand_dp)
        return self._glob(*make(self.mesh, vh=vh)(
            *(self._loc(a) for a in (
                passes, wit, raw, flags,
                _unpack_vseg_bytes(vseg_bytes, channels)))))


def _dispatch_of(mesh) -> Optional[_MeshDispatch]:
    return _MeshDispatch(mesh) if mesh is not None and mesh.size > 1 else None


def _strip_rows(arr2d: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate arr2d[i, :lengths[i]] without a Python loop.

    u8 rows go through the native memcpy walk (utils/native.py) when the
    library is built; wider dtypes are viewed as bytes first."""
    if arr2d.dtype == np.uint8:
        return native.strip_rows(arr2d, lengths.astype(np.uint32))
    itemsize = arr2d.dtype.itemsize
    flat = native.strip_rows(
        np.ascontiguousarray(arr2d).view(np.uint8).reshape(
            arr2d.shape[0], arr2d.shape[1] * itemsize),
        (lengths * itemsize).astype(np.uint32))
    return flat.view(arr2d.dtype)


def _deflate_unwinnable(buf: bytes, bits: bool,
                        hist: Optional[np.ndarray] = None) -> bool:
    """True when DEFLATE provably cannot beat the section's iid
    entropy floor, so the batch skips compressing it.

    Near-uniform byte streams (order-0 entropy >= 7.98 bits/byte) are
    incompressible at the byte level and store raw.  For packed-bit
    sections (``bits``: Bloom sub-filter bitmaps, witness streams,
    pass-through masks), when the empirical byte entropy matches the
    product-Bernoulli value 8*H(p) of the stream's bit density there
    is no sub-byte or run structure for LZ/Huffman to exploit — the
    iid floor n*H(p) bounds every coder, and the binary-rANS trial
    (section coding 2) already reaches it; sub-filter bitmaps sit at
    the P* ~ 0.32 density by construction.  Structured masks (runs of
    changed pixels) show byte entropy well below 8*H(p) and keep their
    DEFLATE trial.  A wrong skip only costs ratio, never correctness:
    section coding bytes record whichever coder actually won."""
    if len(buf) < 4096:
        return False
    c = native.byte_hist(buf) if hist is None else hist
    p = c[c > 0] / len(buf)
    hbyte = float(-(p * np.log2(p)).sum())
    if hbyte >= 7.98:
        return True
    if not bits:
        return False
    ones = int(c @ native._POP8)
    pb = min(max(ones / (8.0 * len(buf)), 1e-9), 1 - 1e-9)
    hbit = -(pb * np.log2(pb) + (1 - pb) * np.log2(1 - pb))
    # very sparse/dense sections (hbit < 0.15) keep DEFLATE: its run
    # coding beats the rANS table overhead there and costs ~nothing
    return hbit >= 0.15 and hbyte >= 8.0 * hbit * 0.985



class BlockedEncoder:
    """Encodes chunks of frames into typed records via the blocked
    kernels on ``device`` (default: the current CUDA card, see
    ``parallel.mesh.default_device``; CPU tensors run the kernels' plain
    twins).

    ``mesh`` (optional ``parallel.mesh.Mesh``) shards phase A over
    frames and the encode kernel over frames and blocks; tensors then
    live on the mesh's home device, and ``device``, if given, must be of
    its type.  The emitted stream is identical with or without a mesh."""

    def __init__(self, zlib_level: int = 6, num_threads: int = 0,
                 motion: bool = True, device=None, mesh=None):
        self.device = home_device(mesh, device)
        self.dispatch = _dispatch_of(mesh)
        self.zlib_level = zlib_level
        self.num_threads = int(num_threads or 0)
        # Global-motion search (type-6 wrapped records).  Any decoder
        # of this format reads both; motion=False pins the co-located
        # diff (byte-identical to older encodes).
        self.motion = motion
        self.begin_stream()

    def begin_stream(self) -> None:
        """Reset cross-chunk motion-tracking state at a stream boundary:
        bytes must be a function of the stream alone."""
        # the type-18 zoom's and the type-20 rotation's search seeds (see
        # the reference encoder), and the global frame offset of the
        # next chunk, which keys their per-chunk entry snapshots
        self._zoom = MotionTrack()
        self._rot = MotionTrack()
        self._gframe = 0

    @staticmethod
    def stack_chunk(base: np.ndarray, frames: List[np.ndarray],
                    device) -> torch.Tensor:
        """Host-stack + upload of a chunk.  On a CUDA device the copy
        leaves from pinned memory without blocking, so a caller that
        stacks one chunk ahead overlaps it with the previous chunk."""
        with profiling.span("nbf.upload"):
            host = torch.from_numpy(np.stack([base] + list(frames)))
            dev = torch.device(device)
            if dev.type == "cuda":
                return host.pin_memory().to(dev, non_blocking=True)
            return host.to(dev)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_chunk(self, base: np.ndarray, frames: List[np.ndarray],
                     payload_sink: List[bytes], keyframe_fn=None,
                     stacked=None, stage_times: Optional[dict] = None,
                     byte_view: bool = False) -> int:
        """Encode ``frames`` (diffed against base, then chained); append
        one record per frame to payload_sink.  Returns the number of
        keyframes emitted.  Serial wrapper over
        :meth:`encode_chunk_begin`; the pipelined caller
        (models/video.py) runs the returned host phase on a worker
        thread instead, beside the next chunk's device phase."""
        payloads, keyframes = self.encode_chunk_begin(
            base, frames, keyframe_fn, stacked=stacked,
            stage_times=stage_times, byte_view=byte_view)()
        payload_sink.extend(payloads)
        return keyframes

    def encode_chunk_begin(self, base: np.ndarray,
                           frames: List[np.ndarray], keyframe_fn=None, *,
                           stacked=None,
                           stage_times: Optional[dict] = None,
                           byte_view: bool = False):
        """DEVICE phase of the chunk encode: phase A, per-frame parameter
        math from the pulled counts, the Bloom-encode kernel (K1), and
        the output pull.  Returns ``finish() -> (payloads, keyframes)``,
        :func:`finish_chunk` over the pulled :class:`HostChunk`: the
        HOST phase, safe to run on a worker thread while the caller
        starts the next chunk's device phase, and again for the same
        bytes; its two lazy device pulls (pass-through masks, per-tile
        motion search) target this encoder's device.

        ``keyframe_fn(j) -> bytes`` supplies a keyframe record for
        scene-cut fallbacks; ``stacked`` may carry a pre-uploaded
        :meth:`stack_chunk` result.  ``byte_view``: frames are raw bytes
        of wider-dtype content — half-pel, tile and filtered-residual
        trials (which mix neighbouring samples) are off for them.
        ``stage_times`` (optional dict) accumulates wall seconds per
        stage."""
        with profiling.stages(stage_times) as stage:
            stage.next("nbf.enc_device_phase_a")
            f = len(frames)
            # Global frame offset of this chunk within the stream (motion
            # tracking), claimed at BEGIN time in chunk order.
            g0 = self._gframe
            self._gframe += f
            shape = base.shape
            h, w = shape[:2]
            channels = 1 if base.ndim == 2 else shape[2]
            n = h * w
            tab = blocked_tables(n, self.device)
            nb, npad = tab["nb"], tab["npad"]

            if stacked is None:
                stacked = self.stack_chunk(base, frames, self.device)

            # Phase A.  With motion enabled the search, the shift decision,
            # and the rolled diff run as one device pass and the small
            # outputs come back in one pull; the packed masks stay lazy
            # (pass-through/sparse records only).
            shifts = np.zeros((f, 2), np.int32)
            best_shifts = np.zeros((f, 2), np.int32)
            shifts_d = None
            stride = motion_stride(h, w)
            tlog = tile_log(h, w)
            if (self.motion and h >= 4 * MOTION_RADIUS
                    and w >= 4 * MOTION_RADIUS):
                if self.dispatch is not None:
                    masks, counts_d, vals, shifts_d, best_d = \
                        self.dispatch.phase_a_auto(stacked, stride, npad=npad,
                                                   nb=nb)
                else:
                    masks, counts_d, vals, shifts_d, best_d = _phase_a_auto(
                        stacked, stride=stride, npad=npad, nb=nb)
                counts, shifts, best_shifts = (
                    t.cpu().numpy() for t in (counts_d, shifts_d, best_d))
            else:
                if self.dispatch is not None:
                    masks, counts_d, vals = self.dispatch.phase_a(
                        stacked, npad=npad, nb=nb)
                else:
                    masks, counts_d, vals = _phase_a(stacked, npad=npad, nb=nb)
                counts = counts_d.cpu().numpy()
            packed = (functools.partial(_phase_a_packed_motion, stacked,
                                        shifts_d, npad=npad)
                      if shifts.any()
                      else functools.partial(_phase_a_packed, stacked,
                                             npad=npad))

            stage.next("nbf.enc_param_math")
            kinds, ks, m_arr, fk_arr, thi, tlo, geom = chunk_params(counts, n,
                                                                     nb)
            scalars = frame_scalars(self.device, m_arr, thi, tlo, fk_arr)
            if self.dispatch is not None:
                words_d, wit_d, wcnt_d, vseg_d, vcnt_d = self.dispatch.encode(
                    masks, vals, tab, *scalars, channels=channels, **geom)
            else:
                words_d, wit_d, wcnt_d, vseg_d, vcnt_d = bk.blocked_encode_h(
                    masks, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"],
                    vals, *scalars, **geom)
                vseg_d = _pack_vseg_bytes(vseg_d, channels)
            frame_counts = counts.sum(axis=1)
            if stage_times is not None:
                stage.next("nbf.enc_device_kernel")
                self._sync()
            stage.next("nbf.enc_pull")
            words, wit, wcnt, vseg, vcnt = (
                t.cpu().numpy() for t in (words_d, wit_d, wcnt_d, vseg_d,
                                          vcnt_d))
        chunk = HostChunk(
            frames=frames, base=base, keyframe_fn=keyframe_fn,
            byte_view=byte_view, motion=self.motion, h=h, w=w,
            channels=channels, nb=nb, g0=g0, tlog=tlog, stride=stride,
            kinds=kinds, ks=ks, m_arr=m_arr, words=words, wit=wit,
            wcnt=wcnt, vseg=vseg, vcnt=vcnt, shifts=shifts,
            best_shifts=best_shifts, frame_counts=frame_counts,
            packed=_LazyPull(packed),
            tile_summary=_LazyPull(functools.partial(
                _tile_motion_best, stacked, tlog=tlog, stride=stride)),
            zlib_level=self.zlib_level, num_threads=self.num_threads)
        return functools.partial(finish_chunk, chunk, self._zoom, self._rot,
                                 stage_times)


# ---------------------------------------------------------------------------
# The encoder's HOST phase: finish_chunk and its stages (gather_sections,
# deflate_sections, residual_trials a group of frames, assemble_records),
# over one chunk's pulled arrays
# ---------------------------------------------------------------------------

class _LazyPull:
    """A device result of one chunk that only some records need: pulled
    on first use (span ``nbf.pull_lazy``), once a chunk, and kept."""

    def __init__(self, compute):
        self._compute = compute
        self._host = None

    def __call__(self) -> np.ndarray:
        if self._host is None:
            with profiling.span("nbf.pull_lazy"):
                self._host = self._compute().cpu().numpy()
        return self._host


@dataclasses.dataclass
class HostChunk:
    """The host phase's input for one chunk: its frames, what its device
    phase pulled, and two device results pulled on first use."""
    frames: list
    base: np.ndarray
    keyframe_fn: Optional[Callable[[int], bytes]]
    byte_view: bool
    motion: bool             # the encoder searches global motion
    h: int
    w: int
    channels: int
    nb: int
    g0: int                  # global frame offset of frames[0]
    tlog: int                # tile side (log2) of the per-tile trials
    stride: int              # count grid of the motion searches and probes
    kinds: List[str]         # chunk_params' record kind of every frame
    ks: np.ndarray
    m_arr: np.ndarray
    words: np.ndarray        # K1's outputs (F, NB, ...)
    wit: np.ndarray
    wcnt: np.ndarray
    vseg: np.ndarray
    vcnt: np.ndarray
    shifts: np.ndarray       # (F, 2) accepted global shifts
    best_shifts: np.ndarray  # (F, 2) the search's argmin
    frame_counts: np.ndarray
    packed: _LazyPull        # (F, npad // 8) packbits(diff mask)
    tile_summary: _LazyPull  # (F, ty, tx, 3) _tile_motion_best
    zlib_level: int
    num_threads: int

    @property
    def f(self) -> int:
        return len(self.frames)

    @property
    def n(self) -> int:
        return self.h * self.w

    @property
    def vlvl(self) -> int:
        # Value streams and DPCM residuals DEFLATE at level 1 when the
        # level is defaulted: level 6 buys <1% over level 1 on changed-
        # pixel bytes at 3-5x the CPU (the host pipeline's hot stage),
        # and the byte-rANS trial recovers the entropy-side difference.
        # An explicitly-raised level (>= 7) is honored as stated intent.
        return self.zlib_level if self.zlib_level >= 7 else 1


class MotionTrack:
    """Cross-chunk tracking of one parametric motion probe (the type-18
    zoom or the type-20 rotation): the stream's state after the last
    finished chunk, each chunk's entry snapshot keyed by its global
    frame offset (repeat host phases of a chunk must recompute identical
    bytes), and the working copy a host phase advances and publishes for
    the next chunk (host phases run in chunk order on the callers'
    single worker).  The state: ``gidx``, the global index of the
    anchor frame; ``abs``, its latent parameter; ``rel``, the tracked
    rate a frame."""

    def __init__(self):
        self.stream: dict = {}
        self.entry: Dict[int, dict] = {}
        self.work: dict = {}

    def enter(self, g0: int) -> None:
        snap = self.entry.get(g0)
        if snap is None:
            snap = self.entry[g0] = dict(self.stream)
        self.work = dict(snap)

    def warm(self, fv: "FrameView") -> bool:
        """The anchor is reachable from frame ``fv``: at most 15 frames
        back (the format's bound), and in this chunk or its base."""
        s = self.work
        return ("gidx" in s and 1 <= fv.gj - s["gidx"] <= 15
                and fv.j - (fv.gj - s["gidx"]) >= -1)

    def accept(self, warm: bool, fv: "FrameView", rb: int, cur: int,
               ref: int) -> None:
        """Advance past frame ``fv``'s accepted prediction (``cur`` for
        the frame, ``ref`` for the anchor ``rb`` back)."""
        s = self.work
        s["rel"] = (cur - ref) / rb
        if fv.last or (warm and rb >= 12):
            # re-pin at the chunk's last frame (the only frame the next
            # chunk can still reach as its base) or when rb nears the
            # format bound
            s["gidx"], s["abs"] = fv.gj, cur
        elif not warm:
            # cold lock: pin the anchor at the previous frame (latent
            # scale 0)
            s["gidx"], s["abs"] = fv.gj - 1, ref

    def publish(self) -> None:
        self.stream = dict(self.work)


class ChunkSections:
    """A chunk's DEFLATE-able sections (value streams, blocked bitmaps,
    witness streams, pass-through masks) and, by frame, their indices
    and bytes, the bit-packed witness and the residual trials."""

    def __init__(self, f: int):
        self.bufs: List[bytes] = []
        self.level: List[int] = []
        self.bits: List[bool] = []
        self.zsecs: List[bytes] = []
        # One byte histogram per section, shared by every entropy
        # gate that consumes it (DEFLATE-unwinnable, bit density,
        # order-0 entropy): the gates were each re-walking the same
        # few-hundred-KB buffers, a measurable slice of the host
        # budget at 1080p.
        self.hists: dict = {}
        self.vz = [-1] * f
        self.bz = [-1] * f
        self.wz = [-1] * f
        self.val: List[bytes] = [b""] * f
        self.bm: List[Optional[bytes]] = [None] * f
        self.wit: List[Optional[bytes]] = [None] * f
        self.wit_pk: List[Optional[bytes]] = [None] * f  # coding-7 bit pack
        self.res_trials = [[] for _ in range(f)]  # (tag, meta, record)

    def add(self, buf: bytes, lvl: int, bits: bool = False) -> int:
        self.bufs.append(buf)
        self.level.append(lvl)
        self.bits.append(bits)
        return len(self.bufs) - 1

    def hist(self, key, buf: bytes) -> np.ndarray:
        h = self.hists.get(key)
        if h is None:
            h = self.hists[key] = native.byte_hist(buf)
        return h


def finish_chunk(chunk: HostChunk, zoom: MotionTrack, rot: MotionTrack,
                 stage_times: Optional[dict] = None) -> tuple:
    """HOST phase of a chunk encode: section gathering, entropy coding,
    residual trials, record assembly; returns ``(payloads, keyframes)``.
    Runs on pulled numpy arrays (plus rare lazy device pulls for
    pass-through masks and the per-tile motion search); thread-safe
    against a concurrent device phase.  Its span (``nbf.finish``) and
    its stages' spans open on the thread that runs it: under the
    pipelined schedule a worker, later than the device pull that ended
    the outer timeline."""
    with profiling.span("nbf.finish"), \
            profiling.stages(stage_times) as stage:
        stage.next("nbf.enc_host_sections")
        zoom.enter(chunk.g0)
        rot.enter(chunk.g0)
        secs = gather_sections(chunk)
        stage.next("nbf.enc_deflate")
        deflate_sections(chunk, secs)
        # DPCM residual trials (dense/pass frames), gathered and DEFLATE'd
        # in sub-batches of ~48 MB of raw bytes: grainy 1080p chunks would
        # otherwise buffer two full-frame residuals per frame for the
        # whole chunk (~190-370 MB transient) before one big batch;
        # sub-batching keeps the threaded stage while bounding the spike.
        res_frames = [j for j in range(chunk.f)
                      if chunk.kinds[j] in ("key", "pass")]
        frame_bytes = max(1, int(np.asarray(chunk.frames[0]).nbytes))
        group_sz = max(1, (48 << 20) // (2 * frame_bytes))
        for g in range(0, len(res_frames), group_sz):
            residual_trials(chunk, secs, res_frames[g: g + group_sz], zoom,
                            rot)
        stage.next("nbf.enc_assembly")
        out = assemble_records(chunk, secs)
        stage.end()
        zoom.publish()
        rot.publish()
        return out


def gather_sections(chunk: HostChunk) -> ChunkSections:
    """Every DEFLATE-able section of the chunk's blocked and pass-through
    records, collected first so that :func:`deflate_sections` compresses
    them in ONE native threaded batch (utils/native.py, num_threads
    plumbed from the public API) instead of per-record zlib calls — the
    host entropy stage is this pipeline's hot loop once device compute
    is fast (VERDICT r2 #1/#3)."""
    secs = ChunkSections(chunk.f)
    for j, kind in enumerate(chunk.kinds):
        # key frames: residual trial handled in the bounded pass
        if kind in ("empty", "sparse", "key"):
            continue
        # vseg rows are already pixel-major bytes (device repack);
        # strip the per-block padding and the stream is done.
        secs.val[j] = _strip_rows(chunk.vseg[j],
                                  chunk.vcnt[j] * chunk.channels).tobytes()
        secs.vz[j] = secs.add(secs.val[j], chunk.vlvl)
        if kind == "pass":
            secs.bm[j] = chunk.packed()[j][: (chunk.n + 7) // 8].tobytes()
            secs.bz[j] = secs.add(secs.bm[j], 1, bits=True)
        elif kind == "blocked":
            m = int(chunk.m_arr[j])
            secs.bm[j] = native.pack_subfilters(chunk.words[j], m).tobytes()
            secs.bz[j] = secs.add(secs.bm[j], 1, bits=True)
            seg_lens = (chunk.wcnt[j] + 7) // 8
            secs.wit[j] = _strip_rows(chunk.wit[j], seg_lens).tobytes()
            secs.wz[j] = secs.add(secs.wit[j], 1, bits=True)
            secs.wit_pk[j] = native.bitpack_rows(chunk.wit[j], chunk.wcnt[j])
    return secs


def deflate_sections(chunk: HostChunk, secs: ChunkSections) -> None:
    """DEFLATE every section a DEFLATE can win, one native batch a
    level, into ``secs.zsecs`` (empty for the skipped ones)."""
    # Bitmap/witness sections DEFLATE at level 1: on near-random
    # filter bits and biased witness bits, higher levels buy <2%
    # over level 1 at 5x the CPU (measured); value streams and DPCM
    # residuals keep the configured level, where modeling does pay.
    secs.zsecs = [b""] * len(secs.bufs)
    skip = [_deflate_unwinnable(
                s, bf, secs.hist(("s", i), s) if len(s) >= 4096 else None)
            for i, (s, bf) in enumerate(zip(secs.bufs, secs.bits))]
    # witness sections whose BIT-PACKED form is iid (no structure
    # beyond the bit bias once the padding is gone) skip their
    # DEFLATE trial too: the padding structure was the only thing
    # LZ could exploit, and the coding-7 rANS candidate reaches the
    # iid floor the padded DEFLATE cannot beat.
    for j, pk in enumerate(secs.wit_pk):
        if (pk is not None and secs.wz[j] >= 0
                and _deflate_unwinnable(
                    pk, True,
                    secs.hist(("wp", j), pk) if len(pk) >= 4096 else None)):
            skip[secs.wz[j]] = True
    for lvl in sorted(set(secs.level)):
        idxs = [i for i, sl in enumerate(secs.level)
                if sl == lvl and not skip[i]]
        outs = native.deflate_frames([secs.bufs[i] for i in idxs],
                                     level=lvl, threads=chunk.num_threads,
                                     engine="fast")
        for i, z in zip(idxs, outs):
            secs.zsecs[i] = z


# ---- residual predictions -------------------------------------------------

class Prediction(NamedTuple):
    """One kind of residual prediction: ``predict(ref, meta, tlog)``
    predicts the frame from ``ref(rb)`` (the frame ``rb`` back, or the
    chunk's base), ``wrap(meta, record, tlog)`` wraps its residual
    record in the header that tells the decoder so."""
    predict: Callable
    wrap: Callable


def _roll(prev: np.ndarray, dy: int, dx: int) -> np.ndarray:
    if (dy, dx) == (0, 0):
        return prev
    return np.roll(np.roll(prev, dy, axis=0), dx, axis=1)


# The residual predictions by the tag the candidate search gives them;
# the comment above each names its meta and its wrapper's record type.
PREDICTIONS: Dict[str, Prediction] = {
    # (dy, dx) integer roll: type 6, the bare residual at (0, 0)
    "int": Prediction(
        lambda ref, m, t: _roll(ref(1), *m),
        lambda m, rec, t: fc.wrap_motion(*m, rec) if m != (0, 0) else rec),
    # (sy, sx) half-pel bilinear: type 9
    "hp": Prediction(lambda ref, m, t: fc.halfpel_predict(ref(1), *m),
                     lambda m, rec, t: fc.wrap_motion_hp(*m, rec)),
    # (ref_back, sy, sx) half-pel against an older reference: type 16
    "ref": Prediction(
        lambda ref, m, t: fc.halfpel_predict(ref(m[0]), m[1], m[2]),
        lambda m, rec, t: fc.wrap_motion_ref(*m, rec)),
    # (rb2, thr) conditional mean of two references: type 19
    "avg2": Prediction(
        lambda ref, m, t: fc.avg2_predict(ref(1), ref(m[0]), m[1]),
        lambda m, rec, t: fc.wrap_avg2(*m, rec)),
    # (ty, tx, 2) per-tile integer map: type 10
    "tile": Prediction(lambda ref, m, t: fc.tile_predict(ref(1), m, t),
                       lambda m, rec, t: fc.wrap_motion_tiles(t, m, rec)),
    # (ty, tx, 2) per-tile half-pel map: type 17
    "tileh": Prediction(
        lambda ref, m, t: fc.tile_predict_hp(ref(1), m, t),
        lambda m, rec, t: fc.wrap_motion_tiles(t, m, rec,
                                               rtype=fc.TILES_HP)),
    # (ref_back, z_cur, z_ref, dy, dx) two-scale parametric zoom: type 18
    "zoomg": Prediction(
        lambda ref, m, t: fc.zoom_predict(ref(m[0]), *m[1:]),
        lambda m, rec, t: fc.wrap_motion_zoom(m[1], m[3], m[4], rec,
                                              ref_back=m[0], z_ref=m[2])),
    # (ref_back, a_cur, a_ref, dy, dx) two-angle rotation: type 20
    "rotg": Prediction(
        lambda ref, m, t: fc.rot_predict(ref(m[0]), *m[1:]),
        lambda m, rec, t: fc.wrap_motion_rot(m[1], m[3], m[4], rec,
                                             ref_back=m[0], a_ref=m[2])),
}


def _ref(chunk: HostChunk, j: int, rb: int) -> np.ndarray:
    """The frame ``rb`` before frame ``j`` of the chunk (its base when
    that lies before the chunk)."""
    return np.asarray(chunk.frames[j - rb] if j >= rb else chunk.base,
                      np.uint8)


def _residual(chunk: HostChunk, j: int, tag: str, meta) -> bytes:
    """DPCM bytes of frame ``j`` against its ``tag`` prediction."""
    pred = PREDICTIONS[tag].predict(functools.partial(_ref, chunk, j), meta,
                                    chunk.tlog)
    return (np.asarray(chunk.frames[j], np.uint8) - pred).tobytes()


# ---- the candidate search -------------------------------------------------

class FrameView:
    """One key or pass frame as the candidate search's probes see it:
    its references and the stride grid (``ys``, ``xs``) on which they
    sample the wrap-aware SAD against ``curr_sub``."""

    def __init__(self, chunk: HostChunk, j: int):
        self.chunk, self.j, self.kind = chunk, j, chunk.kinds[j]
        self.gj = chunk.g0 + j
        self.last = j == chunk.f - 1
        self.h, self.w, self.stride = chunk.h, chunk.w, chunk.stride
        self.curr = np.asarray(chunk.frames[j], np.uint8)
        self.prev = self.ref(1)
        self.curr_sub = self.curr[::self.stride, ::self.stride].astype(
            np.int16)
        self.ys = np.arange(0, self.h, self.stride)
        self.xs = np.arange(0, self.w, self.stride)

    def ref(self, rb: int) -> np.ndarray:
        return _ref(self.chunk, self.j, rb)


def res_candidates(chunk: HostChunk, j: int, zoom: MotionTrack,
                   rot: MotionTrack) -> list:
    """Prediction candidates for the residual trials of key or pass frame
    ``j``, as (tag, meta) pairs: the accepted mask shift, the
    unconditional search argmin, the per-tile map (when any tile clears
    its margin — zoom/rotation content), and — when real global motion
    is present on direct uint8 content — the probes below (a fractional
    pan re-mixes every pixel, so the integer-roll residual is large while
    the bilinear half-pel residual is near-noise).  Every candidate
    competes by final record size only.  Dense and pass-through-dense
    frames probe even from a zero argmin: slow pans/zooms (< 0.5
    px/frame at the edges, e.g. chroma planes at half the luma rate)
    round to integer zero while a half-pel or parametric-zoom prediction
    collapses the residual, and these frames were about to pay a
    keyframe- or pass-through-sized record, which dwarfs the probe
    cost."""
    cands = [("int", (int(chunk.shifts[j, 0]), int(chunk.shifts[j, 1])))]
    by, bx = int(chunk.best_shifts[j, 0]), int(chunk.best_shifts[j, 1])
    if ("int", (by, bx)) not in cands:
        cands.append(("int", (by, bx)))
    if chunk.byte_view or not chunk.motion:
        return cands
    tsh = None
    if min(chunk.h, chunk.w) >= (1 << chunk.tlog):
        # the per-tile map (lazy: ONE device search a chunk, pulled as
        # a tiny (F, ty, tx, 3) summary)
        tsh = choose_tile_shifts(chunk.tile_summary()[j])
        if tsh.any():
            cands.append(("tile", tsh))
    fv = FrameView(chunk, j)
    if j >= 1:
        _probe_avg2(fv, cands)
    # per-tile HALF-PEL refinement (type 17): fractional motion that
    # VARIES across the frame (zoom/rotation fields) lands between
    # integer phases per tile; refine each accepted tile shift to its
    # best half-pel phase.  Dense frames with an all-zero integer map
    # still probe — slow zooms move <0.5 px/frame at the edges yet
    # change every pixel.
    if tsh is not None and (tsh.any() or fv.kind == "key"):
        thm = _tile_hp_refine(fv.prev, fv.curr, tsh, chunk.tlog, fv.stride)
        if thm is not None:
            cands.append(("tileh", thm))
    _probe_zoom(fv, tsh, by, bx, zoom, cands)
    _probe_rot(fv, tsh, by, bx, rot, cands)
    if by == 0 and bx == 0 and fv.kind != "key":
        # non-dense frame with zero global argmin: the tile map (if
        # any) was the only sub-pel story; the global half-pel/multi-ref
        # probes below can't beat a mask the integer diff already made
        # cheap.
        return cands
    _probe_halfpel(fv, by, bx, cands)
    return cands


def _sad(fv: FrameView, pred: np.ndarray) -> int:
    """Wrap-aware SAD of the stride-grid prediction ``pred``: |curr -
    pred| mod 256 with ±128 folding."""
    d = (fv.curr_sub - pred) & 0xFF
    return int(np.minimum(d, 256 - d).sum())


def _sad_count(fv: FrameView, pred: np.ndarray):
    """:func:`_sad` and the count of changed samples."""
    d = (fv.curr_sub - pred) & 0xFF
    return int(np.minimum(d, 256 - d).sum()), int(np.count_nonzero(d))


def _probe_avg2(fv: FrameView, cands: list) -> None:
    """Conditional two-reference average (type 19): on static scenes
    under sensor grain, averaging two references where they agree halves
    the reference-side noise the DPCM residual must code (1.5 sigma^2
    vs 2 sigma^2 — ~0.2 bits/sample); the agreement threshold keeps
    moving content (where blending ghosts) on plain DPCM.  Threshold
    picked by subsampled wrap-aware SAD; the candidate only enters when
    it beats the plain previous-frame diff on that grid."""
    st = fv.stride
    p16 = fv.prev[::st, ::st].astype(np.int16)
    r16 = fv.ref(2)[::st, ::st].astype(np.int16)
    agree = np.abs(p16 - r16)
    avg = (p16 + r16 + 1) >> 1
    prev_sad = _sad(fv, p16)
    best_t, best_sad = 0, prev_sad
    for thr in (8, 16, 32):
        s = _sad(fv, np.where(agree <= thr, avg, p16))
        if s < best_sad:
            best_t, best_sad = thr, s
    if best_t and best_sad < 0.995 * prev_sad:
        cands.append(("avg2", (2, best_t)))


def _hp_sad(fv: FrameView, ref: np.ndarray, sy: int, sx: int) -> int:
    """Wrap-aware subsampled SAD of the half-pel prediction: it tracks
    DPCM coded size far better than changed-pixel count on
    fractional-motion content (bilinear leaves near-zero but nonzero
    error everywhere).  Gathers ONLY the stride-grid samples with roll
    (wrap) indexing — value-identical to subsampling the full
    fc.halfpel_predict at 1/stride^2 the work (the probe loop's
    full-frame predictions were the encode host stage's largest cost at
    1080p)."""
    ys, xs, h, w = fv.ys, fv.xs, fv.h, fv.w
    iy, fy = sy >> 1, sy & 1
    ix, fx = sx >> 1, sx & 1
    r0 = (ys - iy) % h
    c0 = (xs - ix) % w
    p00 = ref[r0[:, None], c0[None, :]].astype(np.uint16)
    if fy:
        r1 = (ys - iy - 1) % h
        p10 = ref[r1[:, None], c0[None, :]]
    if fx:
        c1 = (xs - ix - 1) % w
        p01 = ref[r0[:, None], c1[None, :]]
    if fy and fx:
        s = (p00 + p10 + p01 + ref[r1[:, None], c1[None, :]] + 2) >> 2
    elif fy:
        s = (p00 + p10 + 1) >> 1
    elif fx:
        s = (p00 + p01 + 1) >> 1
    else:
        s = p00
    return _sad(fv, s.astype(np.int16))


def _zoom_sad(fv: FrameView, ref: np.ndarray, zc: int, zr: int, dyc: int,
              dxc: int):
    """Stride-grid (SAD, changed-count) of the type-18 two-scale zoom
    prediction — same index math as fc.zoom_predict, gathered only at
    the grid points.  Both metrics matter: a slow zoom's plain diff on
    smooth texture changes ~70% of pixels at TINY amplitudes (low SAD),
    while an exact zoom prediction leaves few but larger errors (moving
    objects) — SAD alone would keep the wrong one."""
    h, w = fv.h, fv.w
    sc = 1.0 + zc * 1e-6
    cy0, cx0 = h / 2.0, w / 2.0
    my = np.floor((fv.ys - cy0) / sc + cy0)
    mx = np.floor((fv.xs - cx0) / sc + cx0)
    if zr:
        sb = 1.0 + zr * 1e-6
        my = np.ceil(cy0 + (my - cy0) * sb)
        mx = np.ceil(cx0 + (mx - cx0) * sb)
    r = np.clip(my.astype(np.int64) - dyc, 0, h - 1)
    c2 = np.clip(mx.astype(np.int64) - dxc, 0, w - 1)
    return _sad_count(fv, ref[r[:, None], c2[None, :]].astype(np.int16))


def _rot_sad(fv: FrameView, ref: np.ndarray, a_cur: int, a_ref: int,
             dyc: int, dxc: int):
    """Stride-grid (SAD, changed-count) of the type-20 two-angle
    prediction — same index math as fc.rot_predict, gathered at the
    grid."""
    h, w = fv.h, fv.w
    cy0, cx0 = h / 2.0, w / 2.0
    yf = fv.ys.astype(np.float64) - cy0
    xf = fv.xs.astype(np.float64) - cx0
    th2 = a_cur * 1e-6
    co, si = math.cos(th2), math.sin(th2)
    my = np.floor(cy0 + yf[:, None] * co - xf[None, :] * si)
    mx = np.floor(cx0 + yf[:, None] * si + xf[None, :] * co)
    if a_ref:
        tr = -a_ref * 1e-6
        c1, s1 = math.cos(tr), math.sin(tr)
        uy = my + 0.5 - cy0
        ux = mx + 0.5 - cx0
        my = np.floor(cy0 + uy * c1 - ux * s1)
        mx = np.floor(cx0 + uy * s1 + ux * c1)
    ry = my.astype(np.int64) - dyc
    rx = mx.astype(np.int64) - dxc
    np.clip(ry, 0, h - 1, out=ry)
    np.clip(rx, 0, w - 1, out=rx)
    return _sad_count(fv, ref[ry, rx].astype(np.int16))


def _zoom_score(sc_pair) -> int:
    """Scalar rank of a (SAD, changed-count) pair: each changed pixel
    pays entropy bits on top of its amplitude, so count carries
    byte-like weight."""
    return sc_pair[0] + 4 * sc_pair[1]


def _param_refine(fv: FrameView, sad, ref: np.ndarray, start: int, r0: int,
                  dyx, quant: int, bound: int, max_evals: int):
    """Coarse-to-fine 1-D descent on the frame's parameter (z_cur or
    a_cur; the anchor's ``r0`` fixed — for warm anchors it is known from
    the tracked state), with plateau-aware steps from 4x the edge
    quantum down to a quarter of it, within ±``bound``.  The score
    valley at the true value is deep (one edge pixel of error doubles
    the residual) and a few quanta wide, so the walk locks on in ~20-40
    evals.  Returns (value, (SAD, changed-count))."""
    best = start
    best_p = sad(fv, ref, start, r0, *dyx)
    best_c = _zoom_score(best_p)
    step = 4 * quant
    evals = 0
    while step >= max(8, quant // 4) and evals < max_evals:
        moved = True
        while moved and evals < max_evals:
            moved = False
            for cand in (best - step, best + step):
                if abs(cand) > bound:
                    continue
                p = sad(fv, ref, cand, r0, *dyx)
                evals += 1
                c = _zoom_score(p)
                if c < best_c:
                    best_c, best, best_p = c, cand, p
                    moved = True
        step >>= 1
    return best, best_p


def _gate(best, p0) -> bool:
    """The parametric probes' dual gate against the plain prediction's
    (SAD, count) ``p0``: enter the record trials when the prediction
    wins on the amplitude-weighted score OR collapses the changed-pixel
    count — a zoom-exact prediction concentrates few large errors
    (moving objects) where the plain diff smears tiny errors everywhere,
    and either shape can be the cheaper record (the trials decide by
    bytes)."""
    return (_zoom_score(best[0]) < 0.995 * _zoom_score(p0)
            or best[0][1] < 0.7 * p0[1])


def _param_search(fv: FrameView, sad, probes, by: int, bx: int, quant: int,
                  bound: int, max_evals: int):
    """Best two-parameter prediction over ``probes`` (rb, anchor value,
    [seeds]; at least one seed), as ((SAD, count), rb, value, anchor
    value, dy, dx).  Seed pass: score every (probe, seed, translation)
    cheaply, then run ONE descent from the single best start — refining
    from seeds outside the valley just walks plateaus for nothing (the
    probe stage is per-frame host work; at 1080p each eval is a
    32k-point gather)."""
    dyxs = [(by, bx)]
    if (by, bx) != (0, 0):
        dyxs.append((0, 0))
    start = None  # (score, probe-idx, seed, dyx)
    refs = []
    for rb0, r0, seeds in probes:
        ref0 = fv.ref(rb0)
        refs.append(ref0)
        for dyx in dyxs:
            for s in seeds:
                c = _zoom_score(sad(fv, ref0, s, r0, *dyx))
                if start is None or c < start[0]:
                    start = (c, len(refs) - 1, s, dyx)
    _, pi, seed, dyx = start
    rb0, r0, _ = probes[pi]
    cur, p = _param_refine(fv, sad, refs[pi], seed, r0, dyx, quant, bound,
                           max_evals)
    return (p, rb0, cur, r0, *dyx)


def _probe_zoom(fv: FrameView, tsh, by: int, bx: int, track: MotionTrack,
                cands: list) -> None:
    """Parametric zoom probe (type 18): a radial shift field varies
    continuously with radius — the per-tile map can only quantize it,
    leaving mixed-rounding seams inside every tile.  FIXED-ANCHOR
    tracking: a slow zoom's per-frame scale step is UNIDENTIFIABLE at
    short range (any z with edge shift under a pixel quantizes to the
    same map), so advancing the anchor every frame locks in a wrong
    absolute scale and poisons the two-scale requantization.  Instead
    the anchor frame stays PINNED — its latent scale is trustworthy (0
    at the zoom's onset: the pre-zoom frame IS the latent grid) — and
    identifiability grows with distance as the cumulative relative zoom
    leaves the sub-pixel regime.  The anchor re-pins to the accepted
    frame at the chunk's last frame (the only frame the next chunk can
    still reach as its base) or when rb nears the 15-frame format
    bound, by which point its z_cur is well-identified.  A COLD probe
    (no reachable anchor) sweeps single-scale against the previous
    frame from the tile-map radial fit or, on dense/pass frames, a
    small geometric grid.  Candidates compete by final record size; SAD
    acceptance gates the trial."""
    h, w = fv.h, fv.w
    zfit = _zoom_fit(tsh, fv.chunk.tlog, h, w) if tsh is not None else 0.0
    warm = track.warm(fv)
    probes = []   # (rb, z_ref, [z_cur seeds])
    if warm:
        rb0 = fv.gj - track.work["gidx"]
        zr0 = track.work["abs"]
        # The tracked per-frame rate plus a geometric grid scaled by the
        # anchor distance: early in a zoom the rate estimate is
        # unidentifiable (every sub-pixel scale quantizes to the same
        # map, so the SAD surface is a plateau the descent cannot
        # cross) — a 2x-spaced grid always lands one seed inside the
        # deep valley around the true cumulative scale.
        seeds = [int(round(zr0 + track.work.get("rel", 0.0) * rb0))]
        if abs(zfit) > 2.0 / max(h, w):
            seeds.append(int(round(zr0 + zfit * 1e6 / (1.0 - zfit) * rb0)))
        for zrate in (500, 1000, 2000, 4000, 8000, 16000):
            for sgn in (1, -1):
                zp = zr0 + sgn * zrate * rb0
                if zp not in seeds:
                    seeds.append(zp)
        # the format bounds |z| <= 5e5 ppm; the tracked-rate and fit
        # seeds extrapolated by the anchor distance can overshoot it
        # (the refine clamps its steps, but a start outside the range
        # would survive to the wrap and raise)
        seeds = [z for z in seeds if abs(z) <= 500_000]
        if seeds:
            probes.append((rb0, zr0, seeds))
    else:
        # cold single-scale probe vs prev: the previous frame is assumed
        # to BE the latent grid (true at a zoom's onset; mid-zoom cold
        # starts fail the SAD gate and stay cold)
        if abs(zfit) > 2.0 / max(h, w):
            zcands = [zfit * m for m in (0.7, 0.85, 1.0, 1.15, 1.3)]
        else:
            # dense AND pass-through-dense frames sweep the geometric
            # grid: a slow zoom changes 30-50% of pixels (pass
            # territory) while every tile shift stays sub-pixel, so
            # neither the tile map nor the argmin hints at it
            zcands = [sgn * z
                      for z in (0.0005, 0.001, 0.002, 0.004, 0.008, 0.016)
                      for sgn in (1, -1)]
        seeds = []
        for z in zcands:
            zp = int(round(z * 1e6 / (1.0 - z)))
            if zp and abs(zp) <= 500_000:
                seeds.append(zp)
        if seeds:
            probes.append((1, 0, seeds))
    if not probes:
        return
    # One-edge-pixel scale quantum: the gathered map is PIECEWISE
    # CONSTANT in z (a pixel at distance d from the centre changes its
    # source index every ~1e6/d ppm), so descent steps below the edge
    # quantum land on plateaus and stall — the walk must stride at least
    # one plateau per step.
    zquant = max(16, int(1e6 / max(1, max(h, w) // 2)))
    best = _param_search(fv, _zoom_sad, probes, by, bx, zquant, 500_000,
                         128)
    if _gate(best, _zoom_sad(fv, fv.prev, 0, 0, by, bx)):
        cands.append(("zoomg", best[1:]))
        track.accept(warm, fv, *best[1:4])


def _probe_rot(fv: FrameView, tsh, by: int, bx: int, track: MotionTrack,
               cands: list) -> None:
    """Parametric rotation probe (type 20): a rotation's shift field
    varies with radius AND direction — the tile map quantizes it into
    mixed-rounding seams.  Same anchored two-parameter tracking as the
    zoom probe: the anchor frame's absolute latent angle stays PINNED
    (composing two nearest-neighbour resamplings through a single
    relative angle mispredicts many pixels mid-rotation), warm seeds
    come from the tracked rate plus an aquant-scaled grid by anchor
    distance, and a cold start anchors the previous frame at latent
    angle 0 (exact at a rotation's onset).  Candidates compete by final
    record size; SAD acceptance gates the trial."""
    h, w = fv.h, fv.w
    rfit = _rot_fit(tsh, fv.chunk.tlog, h, w) if tsh is not None else 0.0
    max_rad = max(h, w) / 2.0
    aquant = max(16, int(round(1e6 / max_rad)))
    zoom_added = any(t == "zoomg" for t, _ in cands)
    warm = track.warm(fv)
    probes = []   # (rb, a_ref, [a_cur seeds])
    if warm:
        rb0 = fv.gj - track.work["gidx"]
        ar0 = track.work["abs"]
        seeds = [int(round(ar0 + track.work.get("rel", 0.0) * rb0))]
        if abs(rfit) * max_rad > 2.0:
            for sgn in (1, -1):
                seeds.append(int(round(ar0 + sgn * rfit * 1e6 * rb0)))
        for m_ in (1, 2, 4, 8, 16):
            for sgn in (1, -1):
                ap = ar0 + sgn * m_ * aquant * rb0
                if ap not in seeds:
                    seeds.append(ap)
        # the format bounds |angle| <= 1e6 urad; a tracked rate
        # extrapolated by the anchor distance can overshoot it
        seeds = [a for a in seeds if abs(a) <= 1_000_000]
        if seeds:
            probes.append((rb0, ar0, seeds))
    else:
        if abs(rfit) * max_rad > 2.0:
            seeds = [int(round(sgn * rfit * 1e6 * m_))
                     for m_ in (0.7, 0.85, 1.0, 1.15, 1.3)
                     for sgn in (1, -1)]
            seeds = [a for a in seeds if 0 < abs(a) <= 1_000_000]
        elif not zoom_added:
            seeds = [sgn * m_ * aquant
                     for m_ in (1, 2, 4, 8, 16)
                     for sgn in (1, -1)
                     if m_ * aquant <= 1_000_000]
        else:
            seeds = []
        if seeds:
            probes.append((1, 0, seeds))
    if not probes:
        return
    best = _param_search(fv, _rot_sad, probes, by, bx, aquant, 1_000_000,
                         96)
    if best[2] != best[3] and _gate(best, _rot_sad(fv, fv.prev, 0, 0, 0, 0)):
        cands.append(("rotg", best[1:]))
        track.accept(warm, fv, *best[1:4])


def _vertex(vm, v0, vp) -> float:
    """Sub-sample offset of the parabola through three equally-spaced
    SAD samples, clamped to [-1, 1]."""
    den = vm - 2 * v0 + vp
    if den <= 0:
        return float(np.argmin([vm, v0, vp]) - 1)
    return float(np.clip(0.5 * (vm - vp) / den, -1, 1))


def _probe_halfpel(fv: FrameView, by: int, bx: int, cands: list) -> None:
    """Global half-pel (type 9) and multi-reference (type 16) probes
    around the integer argmin (by, bx)."""
    if fv.kind == "key" and by == 0 and bx == 0:
        # Interpolated motion (a real camera pan) changes EVERY pixel,
        # so the changed-pixel count the device search minimizes is flat
        # across shifts and its argmin is noise — the sub-pel probes
        # below would anchor at (0, 0) and miss the true shift entirely
        # (the frames then pay full keyframes).  A coarse wrap-aware
        # integer SAD search over +-3 px re-anchors them; the subsampled
        # gather keeps it a few ms even at 1080p, and it only runs on
        # dense frames whose alternative is a keyframe-sized record.
        best_i = None
        for iy in range(-3, 4):
            for ix in range(-3, 4):
                ps = fv.prev[(fv.ys - iy) % fv.h][:, (fv.xs - ix) % fv.w]
                c = _sad(fv, ps)
                if best_i is None or c < best_i:
                    best_i, by, bx = c, iy, ix
        if (by, bx) != (0, 0) and ("int", (by, bx)) not in cands:
            cands.append(("int", (by, bx)))

    int_sad = None
    best_c, best_s = None, None
    hp_grid = np.zeros((3, 3))
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            sy, sx = 2 * by + oy, 2 * bx + ox
            c = _hp_sad(fv, fv.prev, sy, sx)
            hp_grid[oy + 1, ox + 1] = c
            if oy == 0 and ox == 0:
                int_sad = c
            elif best_c is None or c < best_c:
                best_c, best_s = c, (sy, sx)
    if best_c is not None and best_c < 0.995 * int_sad:
        cands.append(("hp", best_s))

    # QUARTER-pel per-frame motion estimate from the 3x3 half-pel SAD
    # grid (separable parabolic fit): the true fractional shift lands
    # between half-pel samples; the vertex recovers it to ~1/4 pel,
    # which is what anchors the multi-reference probes correctly below.
    est_y = 2 * by + _vertex(hp_grid[0, 1], hp_grid[1, 1], hp_grid[2, 1])
    est_x = 2 * bx + _vertex(hp_grid[1, 0], hp_grid[1, 1], hp_grid[1, 2])
    # multi-reference probes (type 16): sub-half-pel motion (fractional
    # pans; chroma planes pan at half the luma rate) lands BETWEEN
    # half-pel phases frame-to-frame, but rb frames back the phase step
    # multiplies back onto the grid and the bilinear prediction matches
    # — the frames that were keyframing despite the half-pel search (60%
    # of the pan_subpixel stream's bytes).  Probes center on rb *
    # (quarter-pel estimate): scaling the INTEGER argmin instead
    # (2*rb*by) compounds its up-to-half-pel error by rb and misses the
    # matching phase entirely (e.g. a 1.25 px/frame pan: true rb=4 shift
    # is 10 half-pels, 2*rb*by anchors at 8).
    for rb in (2, 4, 8):
        if fv.j < rb - 1:
            continue
        ref = fv.ref(rb)
        best2_c, best2_s = _hp_descent(fv, ref, int(round(rb * est_y)),
                                       int(round(rb * est_x)))
        if best2_c < 0.995 * int_sad:
            cands.append(("ref", (rb, *best2_s)))


def _hp_descent(fv: FrameView, ref: np.ndarray, cy: int, cx: int):
    """Separable coordinate descent (2 rounds, ±3 sweeps) of the half-pel
    SAD against ``ref`` from the anchor (cy, cx): the quarter-pel
    estimate's error compounds by rb (a 0.38 half-pel bias is 3
    half-pels off at rb=8), so a fixed ±1 grid around rb*est misses the
    exactly-matching phase; the descent walks to it (SAD collapses at
    the true phase, so the valley is steep and 1-D sweeps find it).
    Returns (SAD, (sy, sx))."""
    best_s = (cy, cx)
    best_c = _hp_sad(fv, ref, cy, cx)
    for _ in range(2):
        improved = False
        sy0, sx0 = best_s
        for sy in range(sy0 - 3, sy0 + 4):
            if sy == sy0:
                continue
            c = _hp_sad(fv, ref, sy, sx0)
            if c < best_c:
                best_c, best_s = c, (sy, sx0)
                improved = True
        sy0, sx0 = best_s
        for sx in range(sx0 - 3, sx0 + 4):
            if sx == sx0:
                continue
            c = _hp_sad(fv, ref, sy0, sx)
            if c < best_c:
                best_c, best_s = c, (sy0, sx)
                improved = True
        if not improved:
            break
    return best_c, best_s


# ---- the residual trials --------------------------------------------------

def _enqueue_rans(tasks: list, tmeta: list, key, raw: bytes, rl: int,
                  cap: int, stride: int) -> None:
    """Entropy-gated trial enqueue: order-0 byte histogram (coding 3)
    and, on streams large enough to amortize the 8 conditional tables,
    ONE context rANS trial — 2D (coding 6, max of the left/up magnitude
    buckets; wins 2-8% on spatially-correlated prediction error) when
    its sampled conditional entropy meaningfully beats the horizontal
    model's, order-1 (coding 4) otherwise.  H0 lower-bounds the order-0
    size and the sampled H1/H2 estimate the context coders, so streams a
    coder cannot shrink below ``cap`` never reach the pool — at 1080p a
    wasted rANS pass costs 10-60 ms/frame.  Enqueued tasks run in ONE
    native threaded call (native.rans_trials), so the trial family
    scales across host cores like the DEFLATE stage.  ``stride``: the
    raster row pitch in bytes of the 2D-context coder."""
    if rl < RANS8_MIN:
        return
    h0 = native.entropy_bits(raw)
    if h0 * rl / 8.0 + 388 < cap:
        tasks.append(raw)
        tmeta.append((key, 3, 0))
    if rl >= RANSC_MIN:
        h1 = native.cond_entropy_bits(raw)
        h2 = (native.cond2_entropy_bits(raw, stride)
              if stride < rl else 8.0)
        if h2 < h1 - 0.04 and h2 * rl / 8.0 + 3084 < cap * 1.02:
            tasks.append(raw)
            tmeta.append((key, 6, stride))
        elif h1 * rl / 8.0 + 3080 < cap * 1.02:
            tasks.append(raw)
            tmeta.append((key, 4, 0))


def _pick_rans(cands, rl: int, cap: int):
    """Smallest pooled trial result under ``cap``, as a (coding, bytes,
    raw_len[, stride]) section, or None.  Candidates arrive
    coding-3-first, so ties go to the cheaper-to-decode byte-histogram
    coder."""
    best = None
    for c, r, st in cands or []:
        if len(r) < cap:
            best = (c, r, rl) if c != 6 else (6, r, rl, st)
            cap = len(r)
    return best


def residual_trials(chunk: HostChunk, secs: ChunkSections, js: List[int],
                    zoom: MotionTrack, rot: MotionTrack) -> None:
    """The DPCM residual trials of one group of key and pass frames
    ``js``: every candidate's residual DEFLATE'd in one batch, its
    filtered variants and entropy-gated rANS trials pooled likewise; the
    smallest record of each candidate goes to ``secs.res_trials``."""
    raws, meta = [], []
    for j in js:
        for tag, m in res_candidates(chunk, j, zoom, rot):
            r = _residual(chunk, j, tag, m)
            raws.append(r)
            meta.append((j, tag, m, len(r)))
    vlvl, threads = chunk.vlvl, chunk.num_threads
    outs = native.deflate_frames(raws, level=vlvl, threads=threads,
                                 engine="fast")
    # Spatially-filtered variants (type 14) where DEFLATE left
    # headroom: fractional-motion prediction error is spatially
    # correlated (bilinear interpolation low-passes the frame),
    # so SUB/UP filtering cuts subpixel-pan residuals 10-15%.
    # The gate skips trials DEFLATE already crushed (film grain
    # LZ structure), bounding the extra host CPU to content
    # where filtering can actually win.
    filt_raws, filt_meta = [], []
    if not chunk.byte_view:
        for idx, ((j, tag, m, rl), z) in enumerate(zip(meta, outs)):
            if len(z) <= FILTER_GATE * rl:
                continue
            plane = np.frombuffer(raws[idx], np.uint8).reshape(
                np.asarray(chunk.frames[j]).shape)
            for fid in (1, 2, 3):
                filt_raws.append(fc.spatial_filter(plane, fid).tobytes())
                filt_meta.append((idx, fid))
    filt_outs = (native.deflate_frames(filt_raws, level=vlvl,
                                       threads=threads, engine="fast")
                 if filt_raws else [])
    # One pooled native call runs every entropy-gated rANS trial of the
    # group across host threads (filtered and unfiltered residuals
    # alike), instead of serial per-stream encodes on the Python thread.
    # Residual streams are raster frames: the 2D-context coder's row
    # pitch in bytes is a frame row's.
    res_stride = chunk.w * chunk.channels
    rtasks: list = []
    rmeta: list = []
    base_recs: list = []
    for (idx, fid), fraw, fz in zip(filt_meta, filt_raws, filt_outs):
        _enqueue_rans(rtasks, rmeta, ("f", idx, fid), fraw, meta[idx][3],
                      len(fz), res_stride)
    for idx, ((j, tag, m, rl), raw, z) in enumerate(zip(meta, raws, outs)):
        rec = fc.build_residual_record(rl, z)
        base_recs.append(rec)
        _enqueue_rans(rtasks, rmeta, ("u", idx), raw, rl, len(rec) - 10,
                      res_stride)
    routs = native.rans_trials(rtasks, [c for _, c, _ in rmeta],
                               threads=threads,
                               strides=[s for _, _, s in rmeta])
    rcands: dict = {}
    for (key, c, s), r in zip(rmeta, routs):
        if r is not None:
            rcands.setdefault(key, []).append((c, r, s))
    best_filt: dict = {}
    for (idx, fid), fz in zip(filt_meta, filt_outs):
        rl = meta[idx][3]
        sec, cost = (1, fz, rl), len(fz)
        rsec = _pick_rans(rcands.get(("f", idx, fid)), rl, cost)
        if rsec is not None:
            sec = rsec
        frec = fc.build_residual_f_record(fid, sec)
        cur = best_filt.get(idx)
        if cur is None or len(frec) < len(cur):
            best_filt[idx] = frec
    for idx, (j, tag, m, rl) in enumerate(meta):
        # type 8 (DEFLATE) vs type 13 (byte-rANS section) vs type 14
        # (filtered): only the smallest wrapped record survives the
        # group, so trial storage stays one record per frame.
        rec = base_recs[idx]
        rsec = _pick_rans(rcands.get(("u", idx)), rl, len(rec) - 10)
        if rsec is not None and len(rsec[1]) + 10 < len(rec):
            rec = fc.build_residual_s_record(rsec)
        frec = best_filt.get(idx)
        if frec is not None and len(frec) < len(rec):
            rec = frec
        secs.res_trials[j].append((tag, m, rec))


# ---- record assembly ------------------------------------------------------

def _bitrans_pred(length: int, ones: int):
    """(quantized prob, provable floor in bytes) of static binary rANS
    over a ``length``-byte stream with ``ones`` set bits: the coded body
    cannot land meaningfully below the cross-entropy of the bit density
    against the quantized model, so callers skip the encode entirely
    when even the floor loses the section (the skipped trials were pure
    waste: same final coding choice)."""
    bits8 = 8 * length
    prob = min(255, max(1, round(256 * ones / bits8)))
    q = prob / 256.0
    pb = ones / bits8
    hq = 0.0
    if pb > 0.0:
        hq -= pb * math.log2(q)
    if pb < 1.0:
        hq -= (1.0 - pb) * math.log2(1.0 - q)
    return prob, length * hq + 4.0  # 4-byte state head


def _section_coding(secs: ChunkSections, raw: Optional[bytes], zi: int,
                    byte_rans: bool = False):
    """Per-section coding choice: raw vs DEFLATE vs static binary rANS
    vs (``byte_rans``) byte-histogram rANS, whichever stores fewest
    bytes (header cost included).  Binary rANS — the near-entropy coder
    for iid-biased bit streams (native/nbf.cpp) — is only attempted when
    the stream's bit density is away from 0.5 (quantized prob outside
    [0.35, 0.65]), where H(p) < 1 leaves room to win; witness streams
    (~0.8 ones) and sparse pass-through masks are the targets.  Byte
    rANS targets value streams and DPCM residuals, where DEFLATE's
    Huffman stage leaves 5-15% on the table and runs 5-10x slower; its
    384-byte stored table needs sections of a few KB to amortize."""
    if raw is None or len(raw) == 0:
        return (0, b"", 0)
    best_cost, best = len(raw), (0, raw, 0)
    z = secs.zsecs[zi]
    if z and len(z) + 4 < best_cost:
        best_cost, best = len(z) + 4, (1, z, len(raw))
    hist = secs.hist(("s", zi), raw)
    ones = int(hist @ native._POP8)
    prob, floor_b = _bitrans_pred(len(raw), ones)
    # attempt binary rANS only when its provable floor can still beat
    # the current best (acceptance needs len(r) + 5 < best_cost and
    # len(r) >= floor - slack)
    if (prob <= 90 or prob >= 166) and floor_b + 3.0 < best_cost:
        r = native.rans_encode(raw, prob)
        if r is not None and len(r) + 5 < best_cost:
            best_cost = len(r) + 5
            best = (2, r, len(raw), prob)
    if byte_rans and len(raw) >= RANS8_MIN:
        # entropy pre-gates (see _enqueue_rans): skip coders the
        # stream's H0/H1 already rules out — value streams are often
        # near-uniform changed-pixel bytes where a wasted rANS pass costs
        # milliseconds per frame.
        nzp = hist[hist > 0] / len(raw)
        h0 = float(-(nzp * np.log2(nzp)).sum())
        if h0 * len(raw) / 8.0 + 392 < best_cost:
            r8 = native.rans8_encode(raw)
            if r8 is not None and len(r8) + 4 < best_cost:
                best_cost = len(r8) + 4
                best = (3, r8, len(raw))
        if len(raw) >= RANSC_MIN:
            h1 = native.cond_entropy_bits(raw)
            if h1 * len(raw) / 8.0 + 3084 < best_cost * 1.02:
                rc = native.ransc_encode(raw)
                if rc is not None and len(rc) + 4 < best_cost:
                    best_cost = len(rc) + 4
                    best = (4, rc, len(raw))
    return best


def _wrap_shift(chunk: HostChunk, j: int, rec: bytes) -> bytes:
    """``rec``, motion-wrapped when frame j carries a nonzero shift
    (keyframes never wrap — they reset)."""
    dy, dx = int(chunk.shifts[j, 0]), int(chunk.shifts[j, 1])
    return fc.wrap_motion(dy, dx, rec) if dy or dx else rec


def _best_trial(chunk: HostChunk, trials) -> bytes:
    """Smallest residual trial, wrapped with ITS OWN prediction (which
    may differ from the mask path's shifts[j])."""
    best = None
    for tag, m, rec in trials:
        rec = PREDICTIONS[tag].wrap(m, rec, chunk.tlog)
        if best is None or len(rec) < len(best):
            best = rec
    return best


def _witness_coding(secs: ChunkSections, j: int, wbits: int):
    """The witness section of blocked frame ``j``: its per-section
    choice, or the coding-7 candidate: strip the per-block byte padding
    (~17% of witness bytes on sparse-change content) and binary-rANS the
    pure bit stream; the decoder re-pads from its own membership counts,
    so only the packed byte count travels.  Beats the
    DEFLATE-of-padded-rows trial, whose only edge WAS the padding
    structure."""
    wsec = _section_coding(secs, secs.wit[j], secs.wz[j])
    if wbits:
        packed = secs.wit_pk[j]
        ones = int(secs.hist(("wp", j), packed) @ native._POP8)
        prob, floor_b = _bitrans_pred(len(packed), ones)
        # coding-7 stored cost is len(r) + 10 header bytes
        # (fc._sec_stored_cost); attempt the encode only when the
        # provable floor can still win
        if floor_b + 8.0 < fc._sec_stored_cost(wsec):
            r = native.rans_encode(packed, prob)
            if r is not None:
                w7 = (7, r, len(packed), prob)
                if fc._sec_stored_cost(w7) < fc._sec_stored_cost(wsec):
                    wsec = w7
    return wsec


def _inter_record(chunk: HostChunk, secs: ChunkSections, j: int) -> bytes:
    """The record of pass-through or blocked frame ``j``: per-section
    entropy choice; all-raw falls back to the type-3 layout (decodes in
    older readers), or type 0 for pass-through.  A pass-through frame
    takes its smallest residual trial instead where that stores fewer
    bytes."""
    n, k = chunk.n, chunk.ks[j]
    p = int(chunk.frame_counts[j]) / n
    values_z = secs.zsecs[secs.vz[j]]
    vcount = len(secs.val[j])
    vsec = _section_coding(secs, secs.val[j], secs.vz[j], byte_rans=True)
    bsec = _section_coding(secs, secs.bm[j], secs.bz[j])
    passing = chunk.kinds[j] == "pass"
    if passing:
        bits, wbits, wsec, rtype = n, 0, (0, b"", 0), fc.INTERFRAME
    else:
        bits, wbits = int(chunk.m_arr[j]) * chunk.nb, int(chunk.wcnt[j].sum())
        wsec, rtype = _witness_coding(secs, j, wbits), fc.BLOCKED
    if vsec[0] != 1:
        rec = fc.build_blocked_s_record(p, n, k, bits, wbits, bsec, wsec,
                                        vsec)
    elif bsec[0] or wsec[0]:
        rec = fc.build_blocked_z_record(p, n, k, bits, wbits, bsec, wsec,
                                        values_z, vcount)
    else:
        rec = fc.build_interframe_record(
            p, n, k, secs.bm[j], bits, secs.wit[j] or b"", wbits,
            values_z=values_z, values_count=vcount, rtype=rtype)
    if passing:
        res_rec = _best_trial(chunk, secs.res_trials[j])
        if len(res_rec) < len(rec) + (
                5 if (chunk.shifts[j, 0] or chunk.shifts[j, 1]) else 0):
            return res_rec  # carries its own wrap
    return _wrap_shift(chunk, j, rec)


def assemble_records(chunk: HostChunk, secs: ChunkSections) -> tuple:
    """One record a frame, in order, from the coded sections and the
    residual trials; returns ``(payloads, keyframes)``."""
    payloads: List[bytes] = []
    keyframes = 0
    for j, kind in enumerate(chunk.kinds):
        if kind == "empty":
            payloads.append(_wrap_shift(chunk, j, fc.encode_empty_frame()))
        elif kind == "key":
            # dense fallback: DPCM residual vs full keyframe — the
            # keyframe wins on true scene cuts (residual ~ random), the
            # residual on grain/subpixel motion
            key_rec = chunk.keyframe_fn(j)
            res_rec = _best_trial(chunk, secs.res_trials[j])
            if len(res_rec) < len(key_rec):
                payloads.append(res_rec)  # carries its own wrap
            else:
                payloads.append(key_rec)
                keyframes += 1
        elif kind == "sparse":
            values = _strip_rows(chunk.vseg[j], chunk.vcnt[j] * chunk.channels)
            mask_bits = np.unpackbits(chunk.packed()[j])[:chunk.n]
            payloads.append(_wrap_shift(chunk, j, fc.encode_sparse_frame(
                chunk.n, np.flatnonzero(mask_bits), values,
                zlib_level=chunk.zlib_level)))
        else:
            payloads.append(_inter_record(chunk, secs, j))
    return payloads, keyframes


# How BlockedDecoder.decode_run_begin pulled its runs' frames: into
# pinned host memory behind a CUDA event (``pinned``), or not at all, a
# CPU device's frames being on the host (``plain``); and their bytes.
_PULL_KEYS = ("pinned", "plain", "bytes")
_pull_counts = dict.fromkeys(_PULL_KEYS, 0)
_pull_lock = threading.Lock()


def reset_pull_counts() -> None:
    """Set every count of :func:`pull_counts` to 0."""
    with _pull_lock:
        _pull_counts.update(dict.fromkeys(_PULL_KEYS, 0))


def pull_counts() -> Dict[str, int]:
    """Counts of decode-run pulls since the last reset."""
    with _pull_lock:
        return dict(_pull_counts)


def _count_pull(kind: str, nbytes: int) -> None:
    with _pull_lock:
        _pull_counts[kind] += 1
        _pull_counts["bytes"] += nbytes


class BlockedDecoder:
    """Decodes runs of typed records (types 0-pass/2/3/4/7/9, optionally
    type-6 wrapped) through the blocked kernels on ``device``; returns
    reconstructed frames.

    ``mesh`` shards membership, and the K4 expansion of runs with motion,
    like :class:`BlockedEncoder`; K3 runs on the home device."""

    def __init__(self, device=None, mesh=None):
        self.device = home_device(mesh, device)
        self.dispatch = _dispatch_of(mesh)
        # chunk-batch staging buffers (witness segments, value
        # segments), reused across decode_run calls.  Every row is
        # either pad_rows-filled or explicitly zeroed, so reuse never
        # leaks bytes between chunks.
        self._bufs: dict = {}

    def _batch_buf(self, key: str, shape: tuple) -> np.ndarray:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != shape:
            buf = np.empty(shape, np.uint8)
            self._bufs[key] = buf
        return buf

    def decode_run(self, base: np.ndarray, payloads: List[bytes],
                   stage_times: Optional[dict] = None
                   ) -> List[np.ndarray]:
        """Decode ``payloads`` chained onto ``base``.  Serial wrapper
        over :meth:`decode_run_begin`."""
        _, finish = self.decode_run_begin(base, payloads, stage_times)
        return finish()

    def parse_records(self, shape, payloads: List[bytes]) -> dict:
        """HOST half 1 of a run decode: record parse, section INFLATE,
        bitmap unpack — everything up to (but excluding) the device
        membership dispatch.  Returns the parsed per-frame arrays as a
        dict; :meth:`slice_streams` consumes it together with the
        membership witness counts.  Factored out so the production
        pipeline (and bench.py's measured overlap loop) can run the
        host byte stages independently of the device queue."""
        f = len(payloads)
        h, w = shape[:2]
        n = h * w
        npad = npad_of(n)
        nb = npad // bk.IPB

        words = np.zeros((f, nb, bk.NW), np.int32)   # packed words
        raw_used = False
        flags = np.zeros(f, np.int32)
        m_arr = np.ones(f, np.int32)
        fk_arr = np.zeros(f, np.int32)
        thi = np.zeros(f, np.uint32)
        tlo = np.zeros(f, np.uint32)
        # pass-through/sparse masks are rare: parses that never write the
        # mask share one PRISTINE zero array (freshly mmapping ~32 MB per
        # 1080p chunk parse costs real page-table work every call); the
        # first write swaps in a private zeroed copy for THIS parse, so
        # the shared one is never dirtied (and never uploaded — see
        # decode_run_begin's raw_used gate).
        zkey = ("zmask", f, nb)
        raw_mask = self._bufs.get(zkey)
        if raw_mask is None:
            raw_mask = np.zeros((f, nb, bk.IPB), np.uint8)
            self._bufs[zkey] = raw_mask

        def _writable_mask():
            nonlocal raw_mask, raw_used
            if not raw_used:
                raw_mask = np.zeros((f, nb, bk.IPB), np.uint8)
                raw_used = True
            return raw_mask
        wit_streams: List[Optional[bytes]] = [None] * f
        wit_packed = [False] * f  # coding-7: bit-packed, re-pad below
        value_streams: List[Optional[np.ndarray]] = [None] * f

        shifts = np.zeros((f, 2), np.int32)
        for j, payload in enumerate(payloads):
            rtype = fc.record_type(payload)
            off = 0
            if rtype == fc.MOTION:
                dy, dx, off = fc.parse_motion(payload)
                shifts[j] = (dy, dx)
                rtype = payload[off]
            if rtype == fc.EMPTY:
                flags[j] = 1
                continue
            if rtype == fc.SPARSE:
                rec_n, indices, values = fc.parse_sparse_frame(
                    payload, off + 1)
                if rec_n != n:
                    raise ValueError(
                        "sparse record length mismatch with geometry")
                if indices.size and int(indices.max()) >= n:
                    raise ValueError("sparse record index out of range")
                flags[j] = 1
                mb = np.zeros(npad, np.uint8)
                mb[indices] = 1
                _writable_mask()[j, :nb] = mb.reshape(nb, bk.IPB)
                value_streams[j] = values
                continue
            if rtype == fc.BLOCKED_Z:
                rec = fc.parse_blocked_z(payload, off + 1)
            elif rtype == fc.BLOCKED_S:
                rec = fc.parse_blocked_s(payload, off + 1)
            elif (rtype in fc.RESIDUAL_TYPES
                  or rtype in (fc.MOTION_HP, fc.TILES, fc.REF_HP,
                               fc.TILES_HP, fc.ZOOM_G, fc.AVG2,
                               fc.ROT_G)):
                # DPCM residuals (and their half-pel/tile/multi-ref
                # wrappers) reconstruct on host against the running
                # frame (models/video.py splits device runs around
                # them) — reaching here means a caller fed decode_run
                # a record family it cannot chain
                raise ValueError(
                    "residual record routed to blocked decoder "
                    "(host-applied type; split the run around it)")
            else:
                rec = fc.parse_interframe(payload, off + 1)
            if rec["n"] != n:
                raise ValueError("record length mismatch with geometry")
            value_streams[j] = rec["values"]
            if rec["witness_bits"] == 0:          # pass-through
                flags[j] = 1
                bits = np.unpackbits(rec["bitmap_bytes"])[:n]
                mb = np.zeros(npad, np.uint8)
                mb[:n] = bits
                _writable_mask()[j, :nb] = mb.reshape(nb, bk.IPB)
                continue
            if rtype not in (fc.BLOCKED, fc.BLOCKED_Z, fc.BLOCKED_S):
                raise ValueError("BFV2 bloom record routed to blocked decoder")
            m = rec["bitmap_bits"] // nb
            # The encoder emits sparse records below MIN_M and clamps
            # to MMAX above; reject out-of-range m from third-party or
            # corrupt streams instead of decoding them wrong (the
            # reference decoder rejects the same range).
            if (m < MIN_M or m > bk.MMAX
                    or rec["bitmap_bits"] != m * nb):
                raise ValueError(
                    f"blocked record sub-filter width {m} outside "
                    f"[{MIN_M}, {bk.MMAX}] (bitmap_bits="
                    f"{rec['bitmap_bits']}, blocks={nb})")
            m_arr[j] = m
            words[j, :nb] = native.unpack_subfilters(
                rec["bitmap_bytes"], nb, m, bk.NW)
            _, floor_k, (a_hi, a_lo) = _filter_scalars(float(rec["k"]))
            fk_arr[j] = floor_k
            thi[j] = a_hi
            tlo[j] = a_lo
            wit_streams[j] = rec["witness_bytes"].tobytes()
            wit_packed[j] = bool(rec.get("witness_packed"))

        return {"f": f, "words": words, "raw_used": raw_used,
                "flags": flags, "m_arr": m_arr, "fk_arr": fk_arr,
                "thi": thi, "tlo": tlo, "raw_mask": raw_mask,
                "wit_streams": wit_streams, "wit_packed": wit_packed,
                "value_streams": value_streams, "shifts": shifts}

    def slice_streams(self, parsed: dict, wcnt: np.ndarray,
                      nb: int, channels: int):
        """HOST half 2 of a run decode: slice witness streams into
        per-block padded segments and derive per-block change counts
        (popcount of witness bits) — both native single-pass walks
        (utils/native.py pad_rows / witness_popcounts); this stage was
        the decode host hot spot (10.2 -> ~0.5 ms/frame at 1080p).
        Depends on the device membership counts ``wcnt``; under the
        pipelined schedule it runs while the NEXT chunk's membership
        executes.  Returns (wit, block_counts, vseg, vh).

        ``wcnt`` may carry the JAX decoder's padded blocks after the
        ``nb`` real ones (:meth:`membership_counts`): a frame whose
        padded blocks pass items consumes their witness bytes and values
        too, as there, and they are dropped."""
        f = parsed["f"]
        flags = parsed["flags"]
        raw_mask = parsed["raw_mask"]
        wit_streams = parsed["wit_streams"]
        wit_packed = parsed["wit_packed"]
        value_streams = parsed["value_streams"]
        # frames whose padded blocks pass items (a damaged k) walk every
        # row in a scratch array; the others walk the nb real rows
        rows = [wcnt.shape[1] if wcnt[j, nb:].any() else nb
                for j in range(f)]
        # batch arrays start uninitialized: pad_rows(out=frame slice)
        # zero-fills and writes each frame in one native pass, and the
        # rare frames without a stream zero their row explicitly.
        wit = self._batch_buf("wit", (f, nb, bk.WIT_BYTES))
        block_counts = np.zeros((f, nb), np.int32)
        padded_counts = np.zeros((f, wcnt.shape[1] - nb), np.int32)
        for j in range(f):
            if wit_streams[j] is None:
                wit[j] = 0
                if flags[j]:
                    block_counts[j] = raw_mask[j].sum(axis=1)
                continue
            cnt = wcnt[j, :rows[j]]
            if wit_packed[j]:
                out = native.bitunpack_rows(wit_streams[j], rows[j],
                                            bk.WIT_BYTES, cnt)
            else:
                out = (wit[j] if rows[j] == nb
                       else np.empty((rows[j], bk.WIT_BYTES), np.uint8))
                native.pad_rows(np.frombuffer(wit_streams[j], np.uint8),
                                rows[j], bk.WIT_BYTES,
                                ((cnt + 7) // 8).astype(np.uint32), out=out)
            counts = native.witness_popcounts(out, cnt)
            block_counts[j] = counts[:nb]
            padded_counts[j, :rows[j] - nb] = counts[nb:]
            if wit_packed[j] or rows[j] != nb:
                wit[j] = out[:nb]

        vh = _vh_bucket(int(max(block_counts.max(initial=1),
                                padded_counts.max(initial=1))))
        # value segments travel as pixel-major BYTES (c bytes per slot
        # instead of a 4-byte int) and are packed to 24-bit ints on
        # device after the upload (_unpack_vseg_bytes).
        stride = vh * 32 * channels
        vseg = self._batch_buf("vseg", (f, nb, stride))
        for j in range(f):
            vs = value_streams[j]
            if vs is None or vs.size == 0:
                vseg[j] = 0
                continue
            counts = np.concatenate([block_counts[j],
                                     padded_counts[j, :rows[j] - nb]])
            out = (vseg[j] if rows[j] == nb
                   else np.empty((rows[j], stride), np.uint8))
            native.pad_rows(np.ascontiguousarray(vs, np.uint8), rows[j],
                            stride, (counts * channels).astype(np.uint32),
                            out=out)
            if rows[j] != nb:
                vseg[j] = out[:nb]
        return wit, block_counts, vseg, vh

    def membership_counts(self, parsed: dict, shape):
        """DEVICE half 1 of a run decode: upload the parsed sub-filter
        words and run the membership kernel (K2).  Returns
        ``(passes_d, wcnt)`` — the device-resident pass mask and the
        pulled per-block witness counts :meth:`slice_streams` needs."""
        h, w = shape[:2]
        dev = self.device
        tab = blocked_tables(h * w, dev)
        # the stream sets floor(k): cap its lane count as the JAX
        # decoder does (a damaged k must not set K2's loop)
        k_lanes = bk.lane_count(parsed["fk_arr"].max())
        nw = max(1, (int(parsed["m_arr"].max()) + 31) // 32)
        words = torch.from_numpy(parsed["words"]).to(dev)
        scalars = frame_scalars(dev, parsed["m_arr"], parsed["thi"],
                                parsed["tlo"], parsed["fk_arr"])
        flags = torch.from_numpy(parsed["flags"]).to(dev)
        if self.dispatch is not None:
            passes_d, wcnt_d = self.dispatch.membership(
                words, tab, *scalars, flags, k_lanes=k_lanes, nw=nw)
        else:
            passes_d, wcnt_d = bk.blocked_membership_h(
                words, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"],
                *scalars, flags, k_lanes=k_lanes, nw=nw)
        # the JAX decoder's padded blocks, after the real ones
        return passes_d, np.concatenate(
            [wcnt_d.cpu().numpy(),
             padded_block_wcnt(parsed, parsed["words"].shape[1])], axis=1)

    def decode_run_begin(self, base, payloads: List[bytes],
                         stage_times: Optional[dict] = None):
        """Parse + dispatch phase of a run decode.  ``base`` may be a
        host ndarray or a tensor on this decoder's device (the previous
        run's chained last frame).  Returns ``(last_dev, finish)``:
        ``last_dev`` is the device tensor of the final decoded frame —
        the next run can chain on it without a host round trip — and
        ``finish()`` returns the decoded frames, views of one host array
        (on a CUDA device a pinned block whose copy was issued behind the
        launches, and which ``finish()`` waits on).  The uploads,
        launches and pull issue after the slicing and the wait in
        ``finish()`` are all ``nbf.dec_expand_pull``."""
        with profiling.stages(stage_times) as stage:
            stage.next("nbf.dec_parse")
            f = len(payloads)
            shape = tuple(base.shape)
            h, w = shape[:2]
            channels = 1 if len(shape) == 2 else shape[2]
            n = h * w
            dev = self.device
            npad = npad_of(n)
            nb = npad // bk.IPB

            parsed = self.parse_records(shape, payloads)
            flags = parsed["flags"]
            raw_mask = parsed["raw_mask"]
            shifts = parsed["shifts"]

            stage.next("nbf.dec_device_membership")
            passes_d, wcnt = self.membership_counts(parsed, shape)
            stage.next("nbf.dec_host_slices")

            wit, block_counts, vseg, vh = self.slice_streams(
                parsed, wcnt, nb, channels)

            stage.next("nbf.dec_expand_pull")
            # pass-through/sparse masks are rare; when none occurred the
            # raw-mask array is all zero — create it on the device instead
            # of uploading zeros.  wit/vseg are reused staging buffers, so
            # they are copied (a CPU "upload" would alias them).
            raw_d = (torch.from_numpy(raw_mask).to(dev) if parsed["raw_used"]
                     else torch.zeros((f, nb, bk.IPB), dtype=torch.uint8,
                                      device=dev))
            wit_d = torch.from_numpy(wit).to(dev, copy=True)
            vbytes_d = torch.from_numpy(vseg).to(dev)
            flags_d = torch.from_numpy(flags).to(dev)
            base_d = (base if torch.is_tensor(base)
                      else torch.from_numpy(np.array(base, np.uint8)).to(dev))
            if bool(shifts.any()):
                if self.dispatch is not None:
                    mask_d, vals_d = self.dispatch.expand(
                        passes_d, wit_d, raw_d, flags_d, vbytes_d, vh=vh,
                        channels=channels)
                else:
                    mask_d, vals_d = bk.blocked_expand(
                        passes_d, wit_d, raw_d, flags_d,
                        _unpack_vseg_bytes(vbytes_d, channels), vh=vh)
                frames_d = _chain_apply_motion(base_d, mask_d, vals_d, shifts,
                                               shape=shape)
            else:
                # K3 chains every block column through the chunk, so it runs
                # unsharded on the home device, with or without a mesh
                packed = bk.blocked_expand_chain(
                    passes_d, wit_d, raw_d, flags_d,
                    _unpack_vseg_bytes(vbytes_d, channels),
                    _pack_base(base_d, npad=npad, nb=nb), vh=vh)
                frames_d = _unpack_frames(packed, shape=shape)

            # a card's frames go to pinned host memory in stream order,
            # right behind this run's kernels, so the copy runs while the
            # host parses the next run; the caching host allocator reuses
            # a block only after its copy completes and the caller has
            # dropped every frame of it.  A CPU device's frames are the
            # host array already.
            host, pulled = frames_d, None
            if frames_d.device.type == "cuda":
                host = torch.empty(frames_d.shape, dtype=frames_d.dtype,
                                   pin_memory=True)
                host.copy_(frames_d, non_blocking=True)
                pulled = torch.cuda.current_stream(
                    frames_d.device).record_event()
            _count_pull("plain" if pulled is None else "pinned", host.nbytes)

        def finish() -> List[np.ndarray]:
            with profiling.span("nbf.dec_expand_pull", stage_times):
                if pulled is not None:
                    pulled.synchronize()
                frames = host.numpy()
            return [frames[j] for j in range(f)]

        return frames_d[f - 1], finish
