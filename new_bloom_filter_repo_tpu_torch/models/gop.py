"""Batched GOP (group-of-pictures) stages of the BFV2 profile, as torch ops.

The port of ``new_bloom_filter_repo_tpu.models.gop``.  A chunk of inter
frames is encoded in two device passes with the host parameter math
between them, and decoded in one:

encode:
  :func:`gop_masks`  — exact any-channel diff masks for the whole chunk,
                       packed bits and change counts (one pull);
  (host)             — float64 parameter math per frame (p, k, l,
                       activation threshold);
  :func:`gop_encode` — lane-masked Bloom insert, membership, witness
                       compaction, np.packbits packing and the compaction
                       of changed values into a bucketed buffer (one
                       pull);
  (host)             — record assembly.

decode:
  :func:`gop_decode_fields` — bitmap unpack, membership, witness
                       expansion, value gather for every frame;
  :func:`gop_chain`  — a loop over the frames applying each
                       (mask, pixels) delta to the previous frame.

The JAX package ``vmap``s a per-frame body; here every op carries the
frame axis itself (``ops/bloom_core`` takes per-frame scalars).  Value
buffers are bucketed to the next power of two of the chunk's largest
change count (:func:`next_bucket`), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from new_bloom_filter_repo_tpu_torch.ops import bitpack
from new_bloom_filter_repo_tpu_torch.ops.bloom_core import (
    MAX_LANES,
    _exclusive_cumsum,
    insert_partial_lanes,
    membership_lanes,
    witness_compact,
)

KMAX = MAX_LANES


def _n8(n: int) -> int:
    return bitpack.padded_length(n)


def gop_masks_pairs(prev, curr):
    """Exact diff masks for (prev, curr) frame pairs.

    Returns (masks (B, n8) u8, packed (B, n8/8) u8, counts (B,) i32)."""
    neq = curr != prev
    if neq.dim() == 4:
        neq = neq.any(-1)
    b = neq.shape[0]
    n = neq.shape[1] * neq.shape[2]
    masks = neq.reshape(b, n).to(torch.uint8)
    counts = masks.sum(1, dtype=torch.int32)
    if _n8(n) != n:
        masks = F.pad(masks, (0, _n8(n) - n))
    return masks, bitpack.pack_bits(masks), counts


def gop_masks(frames: torch.Tensor):
    """Exact diff masks for consecutive frames.

    frames: (B+1, h, w[, c]) uint8 — frame 0 is the reconstruction base.
    Returns (masks (B, n8) u8, packed (B, n8/8), counts (B,))."""
    return gop_masks_pairs(frames[:-1], frames[1:])


def gop_encode(masks, frames_curr, h1, h2, act, l, t_hi, t_lo, floor_k,
               *, l_pad: int, vmax: int):
    """Batched Bloom encode of a chunk's inter frames.

    masks: (B, n8) u8 (only [:, :n] meaningful; n from the hash tables).
    frames_curr: (B, h, w[, c]) uint8 — the frames whose changed values
      are gathered.
    l/t_hi/t_lo/floor_k: (B,) per-frame scalars.  Frames that are
    pass-through or empty should carry l=1, floor_k=0 (outputs ignored).

    Returns (packed_bitmaps (B, l_pad/8), packed_witness (B, n8/8),
             wcounts (B,) i32, values (B, vmax, C) u8).
    """
    n = h1[0].shape[0]
    b = masks.shape[0]
    frames_flat = frames_curr.reshape(b, n, -1)
    c = frames_flat.shape[-1]
    bits = masks[:, :n]
    bit_array = insert_partial_lanes(bits, h1, h2, act, l, t_hi, t_lo,
                                     floor_k, KMAX, l_pad)
    pmask = membership_lanes(bit_array, h1, h2, act, l, t_hi, t_lo,
                             floor_k, KMAX)
    witness, wcount = witness_compact(bits, pmask)
    # Changed-value compaction: pixel i with mask=1 lands at slot
    # cumsum-1; everything else (and any overflow) drops into the void
    # row vmax, which is sliced off.
    changed = bits != 0
    vidx = _exclusive_cumsum(changed)
    slot = torch.where(changed & (vidx < vmax), vidx, vmax)
    rows = torch.arange(b, device=masks.device, dtype=torch.int64)[:, None]
    values = torch.zeros((b, vmax + 1, c), dtype=torch.uint8,
                         device=masks.device)
    values[rows, slot] = frames_flat
    pw = bitpack.pack_bits(F.pad(witness, (0, _n8(n) - n)))
    return bitpack.pack_bits(bit_array), pw, wcount, values[:, :vmax]


def gop_decode_fields(packed_bitmaps, packed_witness, values, flags,
                      h1, h2, act, l, t_hi, t_lo, floor_k,
                      *, n: int, vmax: int):
    """Per-frame decode fields: (mask (B, n) u8, pix (B, n, C) u8).

    The frame-independent part of the decode (bitmap unpack, membership,
    witness expansion, value gather); only :func:`gop_chain` is
    sequential."""
    n8 = packed_bitmaps.shape[1] * 8
    bit_array = bitpack.unpack_bits(packed_bitmaps, n8)
    pmask = membership_lanes(bit_array, h1, h2, act, l, t_hi, t_lo,
                             floor_k, KMAX)
    witness = bitpack.unpack_bits(packed_witness, n8)[:, :n]
    decoded = torch.where(pmask, torch.gather(witness, 1,
                                              _exclusive_cumsum(pmask)), 0)
    flagged = (flags > 0).view(-1, 1)
    mask = torch.where(flagged, bit_array[:, :n],
                       decoded.to(torch.uint8))
    vidx = _exclusive_cumsum(mask != 0).clamp(0, vmax - 1)
    c = values.shape[-1]
    pix = torch.gather(values, 1, vidx[..., None].expand(-1, -1, c))
    return mask, pix


def gop_chain(base, masks, pix):
    """Chain per-frame (mask, pixels) deltas from the decoded keyframe.

    base: (h, w[, c]) uint8; masks: (B, n) u8; pix: (B, n, C) u8.
    Returns frames (B, h, w[, c]) uint8."""
    shape = tuple(base.shape)
    c = 1 if base.dim() == 2 else shape[-1]
    prev = base.reshape(-1, c)
    frames = []
    for mask, p in zip(masks, pix):
        prev = torch.where((mask != 0)[:, None], p, prev)
        frames.append(prev)
    return torch.stack(frames).reshape((masks.shape[0],) + shape)


def gop_decode(base, packed_bitmaps, packed_witness, values, flags,
               h1, h2, act, l, t_hi, t_lo, floor_k,
               *, n: int, vmax: int):
    """Batched chunk decode: :func:`gop_decode_fields` then
    :func:`gop_chain`.

    base: (h, w[, c]) uint8 — the decoded frame the chunk starts from.
    packed_bitmaps: (B, n8/8) u8 — bitmap region (zero-padded; covers
      both Bloom bitmaps of length l and pass-through masks of length n).
    packed_witness: (B, n8/8) u8.
    values: (B, vmax, C) u8 — inflated changed values.
    flags: (B,) — 1 where the record is pass-through (witness empty: the
      bitmap *is* the mask).

    Returns frames (B, h, w[, c]) uint8.
    """
    masks, pix = gop_decode_fields(
        packed_bitmaps, packed_witness, values, flags,
        h1, h2, act, l, t_hi, t_lo, floor_k, n=n, vmax=vmax)
    return gop_chain(base, masks, pix)


def next_bucket(x: int) -> int:
    """Power-of-two bucket (at least 1024) for value-buffer sizing."""
    b = 1024
    while b < x:
        b *= 2
    return b
