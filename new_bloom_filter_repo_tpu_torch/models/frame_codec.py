"""Frame-level records: zlib keyframes and Bloom-coded inter-frames.

Byte-format parity targets:

* **Untyped keyframe record** — the reference's live .bfvc frame format
  (fixed_video_compressor.py:27-74): ``<III`` (h, w, dtype itemsize) +
  ``<I`` zlib length + payload + ``<B`` has_yuv flag + optional per-plane
  zlib'd Y/U/V sections with ``<II`` shapes.  Decode infers dtype from
  itemsize (1->uint8, 2->uint16, else float32, :91-96) and channel count
  from size divisibility (:98-108).
* **Typed keyframe record** — leading type byte 1 then the same body
  (improved_video_compressor.py:1043-1100).
* **Typed inter-frame record** — leading type byte 0 (a value the
  reference reserves but never emits) then the diff payload of
  improved_video_compressor.py:930-959: ``<f`` p, ``<I`` n, ``<f`` k,
  ``<I`` bitmap bits, ``<I`` witness bits, ``<I``+packbits(bitmap),
  ``<I``+packbits(witness), ``<I`` zlib length + ``<I`` value count +
  zlib(changed values, level 9).

The reference shipped the inter-frame path unwired (SURVEY.md §2
dead-code notes); this module is the working wiring.
"""

from __future__ import annotations

import io
import math
import os
import struct
import threading
import zlib
from typing import Dict, Optional

import numpy as np

from new_bloom_filter_repo_tpu_torch.utils import profiling


KEYFRAME = 1
INTERFRAME = 0
# BFV2 extensions (type bytes the reference format leaves unused):
# 2 — a frame identical to its predecessor costs 1 byte instead of a
#     packbits(zeros(n)) pass-through record.
# 3 — blocked rational-Bloom record (the TPU-native BFV3 profile,
#     ops/pallas/blocked.py): same field layout as type 0 but the bitmap
#     is the concatenation of per-1024-index-block sub-filters
#     (m = bitmap_bits / num_blocks bits each) and the witness stream is
#     the concatenation of per-block byte-aligned segments.
# 4 — sparse record: explicit changed-pixel indices + values, used when
#     the change count is so small that any bitmap would dominate.
# 5 — planar stream header: the container carries N independent plane
#     streams (native 4:2:0/4:2:2 geometry — half the samples of the
#     reference's 444 upconversion) instead of per-frame records; the
#     header is followed by each plane's record sequence in order.
# 6 — global-motion wrapper: <h dy, <h dx (np.roll shifts applied to the
#     previous frame before diffing) followed by any inter-style inner
#     record (0/2/3/4/7).  Decode reconstructs against roll(prev).
#     Collapses camera-pan content from dense-mask fallback to
#     near-static cost; the reference has no motion handling at all.
# 7 — blocked record with entropy-coded sections: the type-3 layout but
#     the bitmap and witness streams each carry a coding flag and may be
#     DEFLATE'd (the reference layout mandates raw packbits only for its
#     own type 0, improved_video_compressor.py:930-959; types 3/4/5/7
#     are this framework's extensions and free to compress — the
#     witness stream is strongly biased toward 1-bits).
# 8 — residual (DPCM) record: DEFLATE of (curr - prev) mod 256 over the
#     frame's raw bytes, optionally against a motion-rolled prev (type-6
#     wrapper).  Emitted when the change mask is dense (film grain,
#     subpixel pans, heavy noise) and the residual bytes entropy-code
#     smaller than both a keyframe and a pass-through record — dense
#     content the reference can only store as a full zlib keyframe.
# 9 — half-pel motion wrapper: like type 6 but shifts are in HALF-pixel
#     units and the prediction is the integer bilinear average of the
#     1/2/4 neighboring integer rolls ((a+b+1)>>1 / (a+b+c+d+2)>>2 —
#     exact, deterministic).  Only wraps residual (type 8) records, and
#     only for direct uint8 channel content (never byte-domain frames,
#     where averaging adjacent bytes is meaningless).
# 10 — tile-motion wrapper: like type 6 but with a PER-TILE shift map
#     (square tiles of side 2**tlog; int8 (dy, dx) per tile; prediction
#     samples prev at edge-clamped per-pixel coordinates).  Captures
#     zoom/rotation/multi-object motion a single global shift cannot.
#     Only wraps residual (type 8) records on direct uint8 content.
# 11 — filtered keyframe: a typed keyframe whose frame/plane byte
#     streams are spatially predicted (PNG-style) before DEFLATE —
#     filter 1 = SUB (left neighbor), 2 = UP (row above), 3 = MED
#     (LOCO-I median edge detector), mod-256.  SUB/UP invert as an
#     exact uint8 cumsum (vectorized); MED reconstructs raster-order
#     in native code.  Natural-image keyframes DEFLATE far smaller
#     predicted; the reference can only zlib raw bytes
#     (fixed_video_compressor.py:31).
# 12 — blocked record with a SECTIONED value stream: the type-7 layout
#     but the value bytes are a coded section like bitmap/witness
#     (coding 0 raw / 1 DEFLATE / 2 binary rANS / 3 byte-histogram
#     rANS) instead of mandatory DEFLATE.  Emitted when raw or rANS
#     stores the values smaller than DEFLATE (noise-heavy value
#     streams are near-incompressible under LZ; order-0 rANS reaches
#     H0 at memory-walk speed — native/nbf.cpp nbf_rans8_*).
# 13 — sectioned residual record: type 8's DPCM payload as a coded
#     section; byte-rANS beats DEFLATE by 10-15% on grain-like
#     residuals (Laplacian bytes carry no LZ structure, and Huffman's
#     integer bit lengths round up what rANS codes fractionally).
# 14 — spatially-filtered residual: the DPCM plane is SUB/UP/MED-
#     predicted (spatial_filter) before the coded section.
#     Fractional-motion prediction error is spatially correlated
#     (bilinear interpolation is a low-pass mix), so filtering cuts
#     subpixel-pan residual streams another 10-15%.
# 15 — sectioned keyframe: the typed-keyframe streams (frame and/or
#     Y/U/V planes, optionally SUB/UP-filtered) each stored as a coded
#     section so byte/context rANS can beat DEFLATE on grain-dominated
#     keyframes (3-5%); layout reordered flag-first so stream presence
#     is unambiguous.
# 17 — HALF-PEL tile-motion wrapper: type 10's per-tile map with the
#     int8 (dy, dx) shifts in HALF-pixel units and the prediction the
#     edge-clamped per-pixel bilinear of :func:`tile_predict_hp` (same
#     exact integer rounding as type 9).  Captures spatially-varying
#     FRACTIONAL motion — zoom/rotation fields whose per-tile shifts
#     land between integer pixels — that neither the integer tile map
#     nor a global half-pel shift can fit.  Only wraps residual-family
#     records on direct uint8 content.
# 18 — parametric ZOOM global-motion wrapper (the global-motion-model
#     idea of MPEG-4 GMC / AV1's ROTZOOM, restricted to isotropic
#     scale) with a TWO-SCALE latent-grid map and a multi-frame
#     reference: the record carries cumulative scales for the current
#     frame (z_cur) and for the reference ref_back<=15 frames back
#     (z_ref), both about the frame centre in ppm, plus an integer
#     translation.  Prediction projects each pixel to its latent grid
#     point under s_cur (m = floor((p-c)/s_cur + c)) then samples the
#     reference pixel that covers that latent point under s_ref
#     (q = ceil(c + (m-c)*s_ref)); z_ref = 0 degrades to the direct
#     single-stage map.  The two-stage form matters because a single
#     RELATIVE scale composes two nearest-neighbour quantizations and
#     mispredicts most pixels of a steady resampled zoom, while the
#     latent-grid map is exact.  A radial shift field also varies
#     continuously with radius, so any per-tile map quantizes it with
#     mixed-rounding seams inside every tile — the parametric gather
#     reproduces the field per PIXEL with a 14-byte header.  Only
#     wraps residual-family records on direct uint8 content.
EMPTY = 2
BLOCKED = 3
SPARSE = 4
PLANAR = 5
MOTION = 6
BLOCKED_Z = 7
RESIDUAL = 8
MOTION_HP = 9
TILES = 10
FILTERED = 11
BLOCKED_S = 12
RESIDUAL_S = 13
RESIDUAL_F = 14
KEYFRAME_S = 15
REF_HP = 16
TILES_HP = 17
ZOOM_G = 18
AVG2 = 19
ROT_G = 20

_HDR_III = struct.Struct("<III")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
_F32 = struct.Struct("<f")
_U8 = struct.Struct("<B")


def _dtype_from_itemsize(itemsize: int):
    # Reference rule: fixed_video_compressor.py:91-96.
    if itemsize == 1:
        return np.uint8
    if itemsize == 2:
        return np.uint16
    return np.float32


# ---------------------------------------------------------------------------
# Keyframe records
# ---------------------------------------------------------------------------

def _frame_is_plane_upsample(frame: np.ndarray, yuv_info: dict) -> bool:
    """True when the 444 frame is exactly chroma replication of the
    wrapper's native subsampled planes — then the frame payload itself
    is redundant and the record can store only the planes (flag 3),
    cutting a 4:2:0-sourced keyframe to a third."""
    if frame.ndim != 3 or frame.shape[2] != 3 or frame.dtype != np.uint8:
        return False
    h, w = frame.shape[:2]
    y = np.asarray(yuv_info.get("y_plane"))
    u = np.asarray(yuv_info.get("u_plane"))
    v = np.asarray(yuv_info.get("v_plane"))
    if y is None or u is None or v is None or y.shape != (h, w):
        return False
    if u.shape != v.shape or u.ndim != 2:
        return False
    ch, cw = u.shape
    if ch == 0 or cw == 0 or h % ch or w % cw:
        return False
    if not np.array_equal(y, frame[:, :, 0]):
        return False
    ry, rx = h // ch, w // cw
    if not np.array_equal(np.repeat(np.repeat(u, ry, 0), rx, 1),
                          frame[:, :, 1]):
        return False
    return np.array_equal(np.repeat(np.repeat(v, ry, 0), rx, 1),
                          frame[:, :, 2])


def _planes_are_channels(frame: np.ndarray, yuv_info: dict) -> bool:
    """True when the yuv_info planes are exactly the frame's channels
    (a 444 wrapper) — storable as a 1-byte flag instead of three
    duplicate zlib streams."""
    if frame.ndim != 3 or frame.shape[2] != 3 or frame.dtype != np.uint8:
        return False
    for ci, plane in enumerate(("y_plane", "u_plane", "v_plane")):
        arr = np.asarray(yuv_info.get(plane))
        if arr is None or arr.shape != frame.shape[:2]:
            return False
        if not np.array_equal(arr, frame[:, :, ci]):
            return False
    return True


def spatial_filter(arr: np.ndarray, fid: int) -> np.ndarray:
    """Spatial prediction filter, mod-256 over uint8.

    fid 1 = SUB (predict from the left neighbor, axis 1), 2 = UP
    (predict from the row above, axis 0), 3 = MED (the LOCO-I /
    JPEG-LS median edge detector: min(a,b) when the up-left corner
    c >= max(a,b), max(a,b) when c <= min(a,b), else a+b-c — an
    edge-adaptive predictor that beats SUB/UP on natural imagery and
    smooth motion residuals).  Out-of-frame neighbors read as 0, so
    the top row degenerates to SUB and the left column to UP.
    (h, w) or (h, w, c) arrays; channels filter independently.
    Exactly inverted by :func:`spatial_unfilter`."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    if fid == 3:
        if a.ndim not in (2, 3):
            raise ValueError("MED filter needs (h, w[, c]) arrays")
        a16 = a.astype(np.int16)
        left = np.zeros_like(a16)
        left[:, 1:] = a16[:, :-1]
        up = np.zeros_like(a16)
        up[1:] = a16[:-1]
        ul = np.zeros_like(a16)
        ul[1:, 1:] = a16[:-1, :-1]
        mn = np.minimum(left, up)
        mx = np.maximum(left, up)
        pred = np.where(ul >= mx, mn,
                        np.where(ul <= mn, mx, left + up - ul))
        return (a16 - pred).astype(np.uint8)  # int16 diff wraps mod 256
    axis = 1 if fid == 1 else 0
    pred = np.zeros_like(a)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    src[axis] = slice(None, -1)
    dst[axis] = slice(1, None)
    pred[tuple(dst)] = a[tuple(src)]
    return a - pred  # uint8 wrap == mod 256


def spatial_unfilter(arr: np.ndarray, fid: int) -> np.ndarray:
    """Inverse of :func:`spatial_filter`.

    SUB/UP invert as a mod-256 running sum along the prediction axis
    (uint8 cumsum accumulates mod 256 — vectorized).  MED must
    reconstruct in raster order (each prediction reads reconstructed
    neighbors), which runs in native code (utils.native.unfilter_med)
    with a per-pixel numpy fallback."""
    if fid == 3:
        from new_bloom_filter_repo_tpu_torch.utils import native
        return native.unfilter_med(np.ascontiguousarray(arr, np.uint8))
    axis = 1 if fid == 1 else 0
    return np.cumsum(arr, axis=axis, dtype=np.uint8)


def _keyframe_flag(frame: np.ndarray, yuv_info: dict | None,
                   typed: bool) -> int:
    """The plane flag of a keyframe record: 0 no planes, 1 frame and
    planes, 2 planes = frame channels (typed), 3 planes only (typed)."""
    if yuv_info is None:
        return 0
    if typed:
        if _planes_are_channels(frame, yuv_info):
            return 2
        if _frame_is_plane_upsample(frame, yuv_info):
            return 3
    return 1


def _keyframe_arrays(frame: np.ndarray, yuv_info: dict | None,
                     flag: int) -> list:
    """The arrays a keyframe record stores as byte streams, in record
    order: the frame unless flag 3, then Y/U/V for flags 1 and 3."""
    arrs = [] if flag == 3 else [frame]
    if flag in (1, 3):
        arrs += [np.asarray(yuv_info[plane])
                 for plane in ("y_plane", "u_plane", "v_plane")]
    return arrs


def _stream_bytes(arr: np.ndarray, filter_id: int) -> bytes:
    """One stored byte stream, spatially predicted when ``filter_id``."""
    if filter_id:
        return spatial_filter(arr, filter_id).tobytes()
    return np.asarray(arr).tobytes()


def _keyframe_record(frame: np.ndarray, yuv_info: dict | None, flag: int,
                     zs: list, typed: bool, filter_id: int) -> bytes:
    """A type-1 (or type-11 when ``filter_id``) keyframe record, or the
    untyped reference layout, around ``zs``: the DEFLATE of each stream
    of :func:`_keyframe_arrays`, in that order."""
    buf = io.BytesIO()
    if typed:
        if filter_id:
            buf.write(_U8.pack(FILTERED))
            buf.write(_U8.pack(filter_id))
        else:
            buf.write(_U8.pack(KEYFRAME))
    buf.write(_HDR_III.pack(frame.shape[0], frame.shape[1],
                            frame.dtype.itemsize))
    zs = iter(zs)
    if flag == 3:
        buf.write(_U32.pack(0))  # frame payload elided (derivable)
    else:
        z = next(zs)
        buf.write(_U32.pack(len(z)))
        buf.write(z)
    buf.write(_U8.pack(flag))
    if flag == 0:
        return buf.getvalue()
    fmt = yuv_info.get("format", "YUV444").encode("utf-8")
    buf.write(_U16.pack(len(fmt)))
    buf.write(fmt)
    if flag == 2:
        return buf.getvalue()
    for plane in ("y_plane", "u_plane", "v_plane"):
        pz = next(zs)
        buf.write(_U32.pack(len(pz)))
        buf.write(pz)
        buf.write(struct.pack("<II", *np.asarray(yuv_info[plane]).shape))
    return buf.getvalue()


def encode_keyframe(frame: np.ndarray, yuv_info: dict | None = None,
                    typed: bool = False, zlib_level: int = 9,
                    filter_id: int = 0) -> bytes:
    """Serialize a keyframe with bit-exact zlib coding.

    Typed records elide redundancy the reference layout doubles up on:
    flag 2 ("planes = frame channels") skips the three plane streams of
    a 444 wrapper; flag 3 ("frame = chroma replication of the planes")
    skips the frame payload of a 4:2:0/4:2:2-sourced frame, storing only
    the native planes (a third of the bytes).  Untyped records always
    write the reference layout (flag 0/1) for BFVC byte parity.

    ``filter_id`` (typed uint8 frames only) emits a type-11 FILTERED
    record: every stored byte stream is spatially predicted
    (:func:`spatial_filter`) before DEFLATE.  Prefer
    :func:`encode_keyframe_best`, which picks the smallest variant.
    """
    frame = np.asarray(frame)
    if filter_id and (not typed or frame.dtype != np.uint8):
        raise ValueError("filtered keyframes require typed uint8 frames")
    flag = _keyframe_flag(frame, yuv_info, typed)
    zs = [zlib.compress(_stream_bytes(a, filter_id), level=zlib_level)
          for a in _keyframe_arrays(frame, yuv_info, flag)]
    return _keyframe_record(frame, yuv_info, flag, zs, typed, filter_id)


# The filter ids of encode_keyframe_best's typed trials (unfiltered,
# SUB, UP, MED), whose streams DEFLATE as one threaded batch.
KEYFRAME_FILTERS = (0, 1, 2, 3)

# How often encode_keyframe_best batched its trials' DEFLATEs: calls
# (``keyframes``), native batches, streams in them, and streams whose
# DEFLATE the sectioned trial took from the batch.
_TRIAL_KEYS = ("keyframes", "batches", "streams", "reused")
_trial_counts = dict.fromkeys(_TRIAL_KEYS, 0)
_trial_lock = threading.Lock()


def reset_keyframe_trial_counts() -> None:
    """Set every count of :func:`keyframe_trial_counts` to 0."""
    with _trial_lock:
        _trial_counts.update(dict.fromkeys(_TRIAL_KEYS, 0))


def keyframe_trial_counts() -> Dict[str, int]:
    """Counts of :func:`encode_keyframe_best` since the last reset."""
    with _trial_lock:
        return dict(_trial_counts)


def _count_trials(**counts: int) -> None:
    with _trial_lock:
        for key, n in counts.items():
            _trial_counts[key] += n


def encode_keyframe_best(frame: np.ndarray, yuv_info: dict | None = None,
                         zlib_level: int = 9) -> bytes:
    """Smallest of the typed keyframe, its SUB/UP/MED-filtered
    variants, and the sectioned (type-15) variant of the winner.

    Spatial prediction typically DEFLATEs natural-image keyframes far
    smaller than raw bytes; noise-dominated frames fall back to the
    unfiltered record.  The sectioned trial then lets each stream pick
    byte/context rANS over DEFLATE — a 3-5% win on grain-dominated
    keyframes where Huffman's integer bit lengths round up.  Non-uint8
    frames always return the unfiltered record (byte-level filtering
    across wide samples mixes exponents).

    The four typed trials' streams DEFLATE in one native batch, a
    thread a stream (``native.deflate_frames``, zlib's bytes), and the
    sectioned trial reuses the winner's DEFLATEs; the records are those
    of :func:`encode_keyframe` and :func:`encode_keyframe_s`.  One
    ``nbf.keyframe`` span, with ``nbf.keyframe_deflate`` and
    ``nbf.keyframe_sectioned`` inside it."""
    from new_bloom_filter_repo_tpu_torch.utils import native

    with profiling.span("nbf.keyframe"):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            _count_trials(keyframes=1)
            return encode_keyframe(frame, yuv_info, typed=True,
                                   zlib_level=zlib_level)
        flag = _keyframe_flag(frame, yuv_info, True)
        arrs = _keyframe_arrays(frame, yuv_info, flag)
        fids = KEYFRAME_FILTERS
        raws = [[_stream_bytes(a, fid) for a in arrs] for fid in fids]
        flat = [raw for trial in raws for raw in trial]
        with profiling.span("nbf.keyframe_deflate"):
            zflat = native.deflate_frames(
                flat, level=zlib_level,
                threads=min(len(flat), os.cpu_count() or 1))
        n = len(arrs)
        zs = [zflat[i * n:(i + 1) * n] for i in range(len(fids))]
        records = [_keyframe_record(frame, yuv_info, flag, zs[fid], True,
                                    fid) for fid in fids]
        # min keeps the first of the smallest: unfiltered, then 1, 2, 3
        best_fid = min(fids, key=lambda fid: len(records[fid]))
        best = records[best_fid]
        reused = 0
        if all(a.dtype == np.uint8 for a in arrs):
            with profiling.span("nbf.keyframe_sectioned"):
                cand = _keyframe_s_record(frame, yuv_info, flag, best_fid,
                                          arrs, raws[best_fid], zlib_level,
                                          zs[best_fid])
            reused = n
            if len(cand) < len(best):
                best = cand
        _count_trials(keyframes=1, batches=1, streams=len(flat),
                      reused=reused)
        return best


def _best_byte_sec(raw: bytes, zlib_level: int, stride: int = 0,
                   z: Optional[bytes] = None) -> tuple:
    """Best coded section for a byte stream: raw vs DEFLATE vs byte
    rANS vs context rANS, entropy-gated (the H0/H1 bounds skip coders
    that cannot beat the current best — see blocked_pipeline's
    _enqueue_rans for the same policy).  ``stride`` (a raster plane's
    row pitch in bytes) additionally arms the 2D-context coder
    (coding 6); when its sampled conditional entropy meaningfully
    beats the horizontal model's, it replaces the order-1 trial —
    same table cost, so one context trial runs either way.  ``z``, when
    given, is ``zlib.compress(raw, zlib_level)`` already computed."""
    from new_bloom_filter_repo_tpu_torch.utils import native
    if z is None:
        z = zlib.compress(raw, zlib_level)
    rl = len(raw)
    if len(z) < rl:
        best, cost = (1, z, rl), len(z)
    else:
        best, cost = (0, raw, 0), rl
    if rl >= 4096:
        h0 = native.entropy_bits(raw)
        if h0 * rl / 8.0 + 388 < cost:
            r8 = native.rans8_encode(raw)
            if r8 is not None and len(r8) < cost:
                best, cost = (3, r8, rl), len(r8)
        if rl >= 16384:
            h1 = native.cond_entropy_bits(raw)
            h2 = (native.cond2_entropy_bits(raw, stride)
                  if 0 < stride <= rl else 8.0)
            if h2 < h1 - 0.04 and h2 * rl / 8.0 + 3084 < cost * 1.02:
                r2 = native.rans2_encode(raw, stride)
                if r2 is not None and len(r2) < cost:
                    best, cost = (6, r2, rl, stride), len(r2)
            elif h1 * rl / 8.0 + 3080 < cost * 1.02:
                rc = native.ransc_encode(raw)
                if rc is not None and len(rc) < cost:
                    best, cost = (4, rc, rl), len(rc)
    return best


def encode_keyframe_s(frame: np.ndarray, yuv_info: dict | None = None,
                      filter_id: int = 0,
                      zlib_level: int = 9) -> Optional[bytes]:
    """Type-15 SECTIONED keyframe: the typed-keyframe streams, each as
    a coded section (raw / DEFLATE / byte rANS / context rANS — see
    :func:`_best_byte_sec`), optionally spatially predicted first.

    Layout: <B 15, <B filter_id (0 = none), <B flag, <III h w itemsize,
    [<H fmt_len, fmt if flag], [section(frame) unless flag == 3],
    [3 x (section(plane), <II shape) if flag in (1, 3)].

    uint8 frames only; returns None otherwise."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or filter_id not in (0, 1, 2, 3):
        return None
    flag = _keyframe_flag(frame, yuv_info, True)
    arrs = _keyframe_arrays(frame, yuv_info, flag)
    if any(a.dtype != np.uint8 for a in arrs):
        return None
    return _keyframe_s_record(frame, yuv_info, flag, filter_id, arrs,
                              [_stream_bytes(a, filter_id) for a in arrs],
                              zlib_level)


def _keyframe_s_record(frame: np.ndarray, yuv_info: dict | None,
                       flag: int, filter_id: int, arrs: list, raws: list,
                       zlib_level: int, zs: Optional[list] = None) -> bytes:
    """The type-15 record of :func:`encode_keyframe_s` over the uint8
    ``arrs`` of :func:`_keyframe_arrays` and their stream bytes
    ``raws``; ``zs``, when given, holds each stream's DEFLATE."""
    buf = io.BytesIO()
    buf.write(_U8.pack(KEYFRAME_S))
    buf.write(_U8.pack(filter_id))
    buf.write(_U8.pack(flag))
    buf.write(_HDR_III.pack(frame.shape[0], frame.shape[1], 1))
    if flag:
        fmt = yuv_info.get("format", "YUV444").encode("utf-8")
        buf.write(_U16.pack(len(fmt)))
        buf.write(fmt)
    first_plane = 0 if flag == 3 else 1
    for i, (arr, raw) in enumerate(zip(arrs, raws)):
        if i < first_plane:
            stride = arr.shape[1] * (arr.shape[2] if arr.ndim == 3 else 1)
        else:
            stride = arr.shape[1]
        _write_section(buf, _best_byte_sec(
            raw, zlib_level, stride=stride,
            z=None if zs is None else zs[i]))
        if i >= first_plane:
            buf.write(struct.pack("<II", *arr.shape))
    return buf.getvalue()


def decode_keyframe_s(data: bytes, offset: int = 0):
    """Inverse of :func:`encode_keyframe_s` (offset at the filter_id
    byte, i.e. after the type byte).  Returns (frame, yuv_info)."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    fid = _U8.unpack(buf.read(1))[0]
    if fid not in (0, 1, 2, 3):
        raise ValueError(f"unknown keyframe filter id: {fid}")
    flag = _U8.unpack(buf.read(1))[0]
    if flag > 3:
        raise ValueError(f"unknown keyframe plane flag: {flag}")
    h, w, itemsize = _HDR_III.unpack(buf.read(12))
    if itemsize != 1:
        raise ValueError("sectioned keyframe with non-uint8 payload")

    def _unf(a: np.ndarray) -> np.ndarray:
        return spatial_unfilter(a, fid) if fid else a

    fmt = None
    if flag:
        fmt_len = _U16.unpack(buf.read(2))[0]
        fmt = buf.read(fmt_len).decode("utf-8")
    frame = None
    if flag != 3:
        raw = _read_section(buf)
        expected_gray = h * w
        if raw.size > expected_gray and raw.size % expected_gray == 0:
            frame = raw.reshape((h, w, raw.size // expected_gray))
        elif raw.size == expected_gray:
            frame = raw.reshape((h, w))
        else:
            raise ValueError("sectioned keyframe payload size mismatch")
        frame = np.ascontiguousarray(_unf(frame))
    yuv_info = None
    if flag in (1, 3):
        yuv_info = {"format": fmt}
        for plane in ("y_plane", "u_plane", "v_plane"):
            arr = _read_section(buf)
            ph, pw = struct.unpack("<II", buf.read(8))
            if arr.size != ph * pw:
                raise ValueError("sectioned keyframe plane size mismatch")
            yuv_info[plane] = _unf(arr.reshape((ph, pw))).copy()
        if flag == 3:
            ch, cw = yuv_info["u_plane"].shape
            if ch == 0 or cw == 0 or h % ch or w % cw:
                raise ValueError(
                    "plane-only keyframe with bad chroma geometry")
            ry, rx = h // ch, w // cw
            frame = np.stack(
                [yuv_info["y_plane"],
                 np.repeat(np.repeat(yuv_info["u_plane"], ry, 0), rx, 1),
                 np.repeat(np.repeat(yuv_info["v_plane"], ry, 0), rx, 1)],
                axis=-1)
    elif flag == 2:
        yuv_info = {"format": fmt,
                    "y_plane": frame[:, :, 0].copy(),
                    "u_plane": frame[:, :, 1].copy(),
                    "v_plane": frame[:, :, 2].copy()}
    return frame, yuv_info


def encode_keyframes_batch(frames, infos, typed: bool = False,
                           zlib_level: int = 9,
                           threads: int = 0) -> list:
    """Serialize many keyframes with the DEFLATE stage parallelized.

    All zlib streams (frame bytes + any YUV planes) are compressed in one
    multi-threaded native batch (utils/native.py) and then assembled into
    records byte-identically to :func:`encode_keyframe` (same zlib, same
    level — the entropy stage is the keyframe path's hot loop,
    fixed_video_compressor.py:31).
    """
    from new_bloom_filter_repo_tpu_torch.utils import native

    frames = [np.asarray(frame) for frame in frames]
    plan = [(frame, info, _keyframe_flag(frame, info, False))
            for frame, info in zip(frames, infos)]
    streams = [_keyframe_arrays(*p) for p in plan]
    compressed = iter(native.deflate_frames(
        [a.tobytes() for arrs in streams for a in arrs], level=zlib_level,
        threads=threads))
    return [_keyframe_record(frame, info, flag,
                             [next(compressed) for _ in arrs], typed, 0)
            for (frame, info, flag), arrs in zip(plan, streams)]


def decode_keyframe(data: bytes, offset: int = 0, filter_id: int = 0):
    """Parse a keyframe body (after any type byte).

    Returns (frame ndarray, yuv_info dict or None).  ``filter_id``:
    the stored byte streams are spatially predicted (type-11 FILTERED
    records) and each is unfiltered after DEFLATE decode.
    """
    def _unf(a: np.ndarray) -> np.ndarray:
        return spatial_unfilter(a, filter_id) if filter_id else a

    buf = io.BytesIO(data)
    buf.seek(offset)
    h, w, itemsize = _HDR_III.unpack(buf.read(12))
    if filter_id and itemsize != 1:
        raise ValueError("filtered keyframe with non-uint8 payload")
    zlen = _U32.unpack(buf.read(4))[0]
    if zlen == 0:  # flag-3 record: frame derivable from the planes
        flag = buf.read(1)
        if not flag or flag[0] != 3:
            raise ValueError("keyframe with no payload and no planes")
        fmt_len = _U16.unpack(buf.read(2))[0]
        fmt = buf.read(fmt_len).decode("utf-8")
        yuv_info = {"format": fmt}
        for plane in ("y_plane", "u_plane", "v_plane"):
            pz_len = _U32.unpack(buf.read(4))[0]
            pz = buf.read(pz_len)
            ph, pw = struct.unpack("<II", buf.read(8))
            yuv_info[plane] = _unf(np.frombuffer(
                zlib.decompress(pz), dtype=np.uint8).reshape((ph, pw))).copy()
        ch, cw = yuv_info["u_plane"].shape
        if ch == 0 or cw == 0 or h % ch or w % cw:
            raise ValueError("plane-only keyframe with bad chroma geometry")
        ry, rx = h // ch, w // cw
        frame = np.stack(
            [yuv_info["y_plane"],
             np.repeat(np.repeat(yuv_info["u_plane"], ry, 0), rx, 1),
             np.repeat(np.repeat(yuv_info["v_plane"], ry, 0), rx, 1)],
            axis=-1)
        return frame, yuv_info
    raw = zlib.decompress(buf.read(zlen))
    dtype = _dtype_from_itemsize(itemsize)
    expected_gray = h * w * itemsize
    if len(raw) > expected_gray and len(raw) % expected_gray == 0:
        channels = len(raw) // expected_gray
        frame = np.frombuffer(raw, dtype=dtype).reshape((h, w, channels))
    else:
        frame = np.frombuffer(raw, dtype=dtype).reshape((h, w))
    frame = _unf(frame)
    yuv_info = None
    flag = buf.read(1)
    if flag and flag[0] == 1:
        fmt_len = _U16.unpack(buf.read(2))[0]
        fmt = buf.read(fmt_len).decode("utf-8")
        yuv_info = {"format": fmt}
        for plane in ("y_plane", "u_plane", "v_plane"):
            pz_len = _U32.unpack(buf.read(4))[0]
            pz = buf.read(pz_len)
            ph, pw = struct.unpack("<II", buf.read(8))
            yuv_info[plane] = _unf(np.frombuffer(
                zlib.decompress(pz), dtype=np.uint8).reshape((ph, pw))).copy()
    elif flag and flag[0] == 2:  # planes elided: they are the channels
        fmt_len = _U16.unpack(buf.read(2))[0]
        fmt = buf.read(fmt_len).decode("utf-8")
        yuv_info = {"format": fmt,
                    "y_plane": frame[:, :, 0].copy(),
                    "u_plane": frame[:, :, 1].copy(),
                    "v_plane": frame[:, :, 2].copy()}
    return frame, yuv_info


# ---------------------------------------------------------------------------
# Inter-frame records (the working wiring of the reference's diff payload)
# ---------------------------------------------------------------------------

def encode_sparse_frame(n: int, indices: np.ndarray, values: np.ndarray,
                        zlib_level: int = 9) -> bytes:
    """BFV2 extension: sparse change record (type 4).

    Layout: <B 4, <I n, <I count, zlib(<u32 indices>), zlib(values)."""
    buf = io.BytesIO()
    buf.write(_U8.pack(SPARSE))
    buf.write(_U32.pack(n))
    idx = np.asarray(indices, dtype=np.uint32)
    buf.write(_U32.pack(idx.size))
    iz = zlib.compress(idx.tobytes(), level=zlib_level)
    buf.write(_U32.pack(len(iz)))
    buf.write(iz)
    values = np.asarray(values, dtype=np.uint8).ravel()
    vz = zlib.compress(values.tobytes(), level=zlib_level)
    buf.write(_U32.pack(len(vz)))
    buf.write(_U32.pack(values.size))
    buf.write(vz)
    return buf.getvalue()


def parse_sparse_frame(data: bytes, offset: int = 0):
    """Inverse of :func:`encode_sparse_frame` (after the type byte).

    Returns (n, indices uint32[count], values uint8[...])."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    n = _U32.unpack(buf.read(4))[0]
    count = _U32.unpack(buf.read(4))[0]
    iz_len = _U32.unpack(buf.read(4))[0]
    indices = np.frombuffer(zlib.decompress(buf.read(iz_len)),
                            dtype=np.uint32)[:count]
    vz_len = _U32.unpack(buf.read(4))[0]
    v_count = _U32.unpack(buf.read(4))[0]
    values = np.frombuffer(zlib.decompress(buf.read(vz_len)),
                           dtype=np.uint8)[:v_count]
    return n, indices, values


def build_interframe_record(p: float, n: int, k: float,
                            bitmap_bytes: bytes, bitmap_bits: int,
                            witness_bytes: bytes, witness_bits: int,
                            values: np.ndarray = None, typed: bool = True,
                            zlib_level: int = 9,
                            rtype: int = INTERFRAME,
                            values_z: bytes = None,
                            values_count: int = 0) -> bytes:
    """Assemble the inter-frame diff payload from already-computed parts
    (byte layout: improved_video_compressor.py:930-959; ``rtype``
    selects the type byte: INTERFRAME or BLOCKED).

    Pass either ``values`` (raw, compressed here) or ``values_z`` +
    ``values_count`` (already DEFLATE'd by the native threaded batch
    stage — byte-identical to in-line zlib at the same level)."""
    buf = io.BytesIO()
    if typed:
        buf.write(_U8.pack(rtype))
    buf.write(_F32.pack(p))
    buf.write(_U32.pack(n))
    buf.write(_F32.pack(k))
    buf.write(_U32.pack(bitmap_bits))
    buf.write(_U32.pack(witness_bits))
    buf.write(_U32.pack(len(bitmap_bytes)))
    buf.write(bitmap_bytes)
    buf.write(_U32.pack(len(witness_bytes)))
    buf.write(witness_bytes)
    if values_z is None:
        values = np.asarray(values, dtype=np.uint8).ravel()
        values_z = zlib.compress(values.tobytes(), level=zlib_level)
        values_count = values.size
    buf.write(_U32.pack(len(values_z)))
    buf.write(_U32.pack(values_count))
    buf.write(values_z)
    return buf.getvalue()


def encode_empty_frame() -> bytes:
    """BFV2 extension: no-change frame record (1 byte)."""
    return _U8.pack(EMPTY)


def encode_interframe(mask: np.ndarray, values: np.ndarray, codec,
                      typed: bool = True, zlib_level: int = 9) -> bytes:
    """Bloom-code a binary change mask + exact changed values.

    Payload format: improved_video_compressor.py:930-959, prefixed with
    type byte 0 when ``typed``.  ``codec``: see :func:`decode_interframe`.
    """
    flat = np.asarray(mask, dtype=np.uint8).ravel()
    bitmap, witness, p, n, _ = codec.compress(flat)
    k, _l = codec._calculate_optimal_params(n, p)
    bitmap_bytes = np.packbits(np.asarray(bitmap, dtype=np.uint8)).tobytes()
    witness_bytes = np.packbits(np.asarray(witness, dtype=np.uint8)).tobytes()
    return build_interframe_record(
        p, n, k, bitmap_bytes, len(bitmap), witness_bytes, len(witness),
        values, typed=typed, zlib_level=zlib_level)


def build_blocked_z_record(p: float, n: int, k: float,
                           bitmap_bits: int, witness_bits: int,
                           bitmap_sec: tuple, witness_sec: tuple,
                           values_z: bytes, values_count: int) -> bytes:
    """Assemble a type-7 blocked record from pre-coded sections.

    ``bitmap_sec`` / ``witness_sec`` are (coding, stored_bytes, raw_len)
    tuples — coding 0 = raw, 1 = DEFLATE, 2 = static binary rANS (the
    near-entropy coder for biased bit streams, native/nbf.cpp; raw_len
    is followed by the quantized bit-probability byte).  ``values_z``
    is the already zlib'd value stream (the value section was always
    compressed — this form lets the encoder batch all DEFLATE work
    through the native threaded stage instead of per-record zlib calls).

    Layout: <B 7, <f p, <I n, <f k, <I bitmap_bits, <I witness_bits,
    section(bitmap), section(witness), <I vz_len, <I value_count, vz;
    section := <B coding, <I stored_len, [<I raw_len if coding != 0],
    [<B bit_prob if coding == 2], bytes.
    """
    buf = io.BytesIO()
    buf.write(_U8.pack(BLOCKED_Z))
    buf.write(_F32.pack(p))
    buf.write(_U32.pack(n))
    buf.write(_F32.pack(k))
    buf.write(_U32.pack(bitmap_bits))
    buf.write(_U32.pack(witness_bits))
    for sec in (bitmap_sec, witness_sec):
        _write_section(buf, sec)
    buf.write(_U32.pack(len(values_z)))
    buf.write(_U32.pack(values_count))
    buf.write(values_z)
    return buf.getvalue()


def _write_section(buf, sec: tuple) -> None:
    """Serialize a (coding, stored_bytes, raw_len[, param]) section:
    <B coding, <I stored_len, [<I raw_len if coding != 0],
    [<B bit_prob if coding == 2], [<I row_stride if coding == 6],
    bytes."""
    coding, stored, raw_len = sec[0], sec[1], sec[2]
    buf.write(_U8.pack(coding))
    buf.write(_U32.pack(len(stored)))
    if coding:
        buf.write(_U32.pack(raw_len))
    if coding in (2, 7):
        buf.write(_U8.pack(sec[3]))  # quantized bit probability
    elif coding == 6:
        buf.write(_U32.pack(sec[3]))  # raster row pitch in bytes
    buf.write(stored)


def _sec_stored_cost(sec: tuple) -> int:
    """Serialized byte cost of a (coding, stored, raw_len[, param])
    section under :func:`_write_section`'s layout."""
    coding, stored = sec[0], sec[1]
    return (5 + (4 if coding else 0)
            + (1 if coding in (2, 7) else 4 if coding == 6 else 0)
            + len(stored))


def build_blocked_s_record(p: float, n: int, k: float,
                           bitmap_bits: int, witness_bits: int,
                           bitmap_sec: tuple, witness_sec: tuple,
                           values_sec: tuple) -> bytes:
    """Assemble a type-12 blocked record: :func:`build_blocked_z_record`
    with the value stream as a coded section too (coding 3 = byte-
    histogram rANS joins the per-section choices).

    Layout: <B 12, <f p, <I n, <f k, <I bitmap_bits, <I witness_bits,
    section(bitmap), section(witness), section(values)."""
    buf = io.BytesIO()
    buf.write(_U8.pack(BLOCKED_S))
    buf.write(_F32.pack(p))
    buf.write(_U32.pack(n))
    buf.write(_F32.pack(k))
    buf.write(_U32.pack(bitmap_bits))
    buf.write(_U32.pack(witness_bits))
    for sec in (bitmap_sec, witness_sec, values_sec):
        _write_section(buf, sec)
    return buf.getvalue()


def _read_section(buf) -> np.ndarray:
    coding = _U8.unpack(buf.read(1))[0]
    stored_len = _U32.unpack(buf.read(4))[0]
    if coding == 0:
        return np.frombuffer(buf.read(stored_len), dtype=np.uint8)
    if coding == 1:
        from new_bloom_filter_repo_tpu_torch.utils import native
        raw_len = _U32.unpack(buf.read(4))[0]
        z = buf.read(stored_len)
        raw = native.inflate_one(z, raw_len)
        if raw is None:          # native absent/declined: exact zlib path
            raw = zlib.decompress(z)
        if len(raw) != raw_len:
            raise ValueError("section raw length mismatch")
        return np.frombuffer(raw, dtype=np.uint8)
    if coding == 2:
        from new_bloom_filter_repo_tpu_torch.utils import native
        raw_len = _U32.unpack(buf.read(4))[0]
        prob = _U8.unpack(buf.read(1))[0]
        if not 1 <= prob <= 255:
            raise ValueError(f"rANS section probability {prob} out of range")
        raw = native.rans_decode(buf.read(stored_len), prob, raw_len)
        return np.frombuffer(raw, dtype=np.uint8)
    if coding == 3:
        from new_bloom_filter_repo_tpu_torch.utils import native
        raw_len = _U32.unpack(buf.read(4))[0]
        raw = native.rans8_decode(buf.read(stored_len), raw_len)
        return np.frombuffer(raw, dtype=np.uint8)
    if coding == 4:
        from new_bloom_filter_repo_tpu_torch.utils import native
        raw_len = _U32.unpack(buf.read(4))[0]
        raw = native.ransc_decode(buf.read(stored_len), raw_len)
        return np.frombuffer(raw, dtype=np.uint8)
    if coding == 6:
        from new_bloom_filter_repo_tpu_torch.utils import native
        raw_len = _U32.unpack(buf.read(4))[0]
        stride = _U32.unpack(buf.read(4))[0]
        if not 0 < stride <= raw_len:
            raise ValueError(
                f"rANS2 section stride {stride} out of range")
        raw = native.rans2_decode(buf.read(stored_len), stride, raw_len)
        return np.frombuffer(raw, dtype=np.uint8)
    if coding == 7:
        raise ValueError(
            "coding 7 (bit-packed witness) is only valid in a blocked "
            "record's witness position")
    raise ValueError(f"unknown section coding {coding}")


def _read_witness_section(buf) -> tuple:
    """Witness-position section read: like :func:`_read_section` but
    also accepts coding 7 (bit-packed binary rANS: the per-block byte
    padding is stripped; the DECODER re-pads from its membership
    counts).  Returns (bytes_array, packed_flag)."""
    pos = buf.tell()
    coding = buf.read(1)
    if not coding:
        raise ValueError("truncated section header")
    if coding[0] != 7:
        buf.seek(pos)
        return _read_section(buf), False
    from new_bloom_filter_repo_tpu_torch.utils import native
    stored_len = _U32.unpack(buf.read(4))[0]
    raw_len = _U32.unpack(buf.read(4))[0]
    prob = _U8.unpack(buf.read(1))[0]
    if not 1 <= prob <= 255:
        raise ValueError(f"rANS section probability {prob} out of range")
    raw = native.rans_decode(buf.read(stored_len), prob, raw_len)
    return np.frombuffer(raw, dtype=np.uint8), True


def parse_blocked_z(data: bytes, offset: int = 0) -> dict:
    """Parse a type-7 record (after the type byte) into the same dict
    shape :func:`parse_interframe` returns (sections decompressed)."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    out = {}
    out["p"] = _F32.unpack(buf.read(4))[0]
    out["n"] = _U32.unpack(buf.read(4))[0]
    out["k"] = _F32.unpack(buf.read(4))[0]
    out["bitmap_bits"] = _U32.unpack(buf.read(4))[0]
    out["witness_bits"] = _U32.unpack(buf.read(4))[0]
    out["bitmap_bytes"] = _read_section(buf)
    out["witness_bytes"], out["witness_packed"] = _read_witness_section(buf)
    vz_len = _U32.unpack(buf.read(4))[0]
    out["values_count"] = _U32.unpack(buf.read(4))[0]
    vz = buf.read(vz_len)
    # the encoder's value stream is exactly values_count bytes
    # (blocked_pipeline val_bytes); alien streams with padding fall
    # back to the exact zlib path below
    from new_bloom_filter_repo_tpu_torch.utils import native
    raw = native.inflate_one(vz, out["values_count"])
    if raw is None or len(raw) != out["values_count"]:
        raw = zlib.decompress(vz)
    out["values"] = np.frombuffer(
        raw, dtype=np.uint8)[: out["values_count"]]
    return out


def parse_blocked_s(data: bytes, offset: int = 0) -> dict:
    """Parse a type-12 record (after the type byte) into the dict shape
    :func:`parse_blocked_z` returns."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    out = {}
    out["p"] = _F32.unpack(buf.read(4))[0]
    out["n"] = _U32.unpack(buf.read(4))[0]
    out["k"] = _F32.unpack(buf.read(4))[0]
    out["bitmap_bits"] = _U32.unpack(buf.read(4))[0]
    out["witness_bits"] = _U32.unpack(buf.read(4))[0]
    out["bitmap_bytes"] = _read_section(buf)
    out["witness_bytes"], out["witness_packed"] = _read_witness_section(buf)
    out["values"] = _read_section(buf)
    out["values_count"] = out["values"].size
    return out


def build_residual_record(raw_len: int, residual_z: bytes) -> bytes:
    """Assemble a type-8 DPCM record from the already-DEFLATE'd
    byte-domain residual (curr - prev mod 256, flattened raw bytes).

    Layout: <B 8, <I raw_len, <I z_len, z."""
    return (_U8.pack(RESIDUAL) + _U32.pack(raw_len)
            + _U32.pack(len(residual_z)) + residual_z)


def parse_residual_record(data: bytes, offset: int = 0) -> np.ndarray:
    """Inverse of :func:`build_residual_record` (after the type byte);
    returns the residual bytes."""
    raw_len, z_len = struct.unpack_from("<II", data, offset)
    from new_bloom_filter_repo_tpu_torch.utils import native
    z = data[offset + 8: offset + 8 + z_len]
    raw = native.inflate_one(z, raw_len)
    if raw is None:
        raw = zlib.decompress(z)
    if len(raw) != raw_len:
        raise ValueError("residual record length mismatch")
    return np.frombuffer(raw, dtype=np.uint8)


def build_residual_s_record(sec: tuple) -> bytes:
    """Assemble a type-13 residual record from a coded section (see
    :func:`_write_section`).  Layout: <B 13, section."""
    buf = io.BytesIO()
    buf.write(_U8.pack(RESIDUAL_S))
    _write_section(buf, sec)
    return buf.getvalue()


def build_residual_f_record(filter_id: int, sec: tuple) -> bytes:
    """Assemble a type-14 residual record: the DPCM byte plane is
    spatially predicted (:func:`spatial_filter`) before entropy coding.
    Half-pel/fractional prediction error keeps spatial correlation the
    temporal diff can't remove; SUB/UP/MED filtering cuts those
    residual streams 10-15% before DEFLATE/rANS.  Layout: <B 14,
    <B filter_id, section."""
    if filter_id not in (1, 2, 3):
        raise ValueError(f"bad residual filter id {filter_id}")
    buf = io.BytesIO()
    buf.write(_U8.pack(RESIDUAL_F))
    buf.write(_U8.pack(filter_id))
    _write_section(buf, sec)
    return buf.getvalue()


RESIDUAL_TYPES = (RESIDUAL, RESIDUAL_S, RESIDUAL_F)


def parse_residual_any(data: bytes, offset: int,
                       shape=None) -> np.ndarray:
    """Parse a residual payload whose TYPE BYTE is at ``offset`` —
    type 8 (DEFLATE body), type 13 (coded section), or type 14
    (spatially-filtered coded section; needs the prediction ``shape``
    to invert the filter).  Returns the flat DPCM byte plane."""
    t = data[offset]
    if t == RESIDUAL:
        return parse_residual_record(data, offset + 1)
    if t == RESIDUAL_S:
        buf = io.BytesIO(data)
        buf.seek(offset + 1)
        return _read_section(buf)
    if t == RESIDUAL_F:
        fid = data[offset + 1]
        if fid not in (1, 2, 3):
            raise ValueError(f"bad residual filter id {fid}")
        if shape is None:
            raise ValueError("filtered residual needs the frame shape")
        buf = io.BytesIO(data)
        buf.seek(offset + 2)
        flat = _read_section(buf)
        if flat.size != int(np.prod(shape)):
            raise ValueError("residual record length mismatch")
        return spatial_unfilter(flat.reshape(shape), fid).reshape(-1)
    raise ValueError(f"not a residual record (type {t})")


def halfpel_predict(prev: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """Half-pel motion prediction: sample ``prev`` at (y - sy/2,
    x - sx/2) with wrap-around and exact integer bilinear rounding.

    sy/sx are in half-pixel units; even components reduce to plain
    np.roll.  uint8 arrays only (per-channel averaging)."""
    iy, fy = sy >> 1, sy & 1   # floor division: -3 -> (-2, 1)
    ix, fx = sx >> 1, sx & 1

    def roll(a, b):
        return np.roll(np.roll(prev, a, axis=0), b, axis=1)

    if not fy and not fx:
        return roll(iy, ix)
    p00 = roll(iy, ix).astype(np.uint16)
    if fy and fx:
        s = (p00 + roll(iy + 1, ix) + roll(iy, ix + 1)
             + roll(iy + 1, ix + 1) + 2) >> 2
    elif fy:
        s = (p00 + roll(iy + 1, ix) + 1) >> 1
    else:
        s = (p00 + roll(iy, ix + 1) + 1) >> 1
    return s.astype(np.uint8)


def apply_residual(prev: np.ndarray, residual: np.ndarray,
                   dy: int = 0, dx: int = 0,
                   halfpel: bool = False) -> np.ndarray:
    """Reconstruct a residual-coded frame: roll ``prev`` by (dy, dx) on
    its leading two axes (np.roll wrap semantics, matching type-6
    motion; with ``halfpel`` the shifts are half-pixel units and the
    prediction is :func:`halfpel_predict`), then add the residual mod
    256 over the raw bytes."""
    if halfpel:
        if prev.dtype != np.uint8:
            raise ValueError("half-pel residual on non-uint8 frame")
        base = halfpel_predict(prev, dy, dx)
    elif dy or dx:
        base = np.roll(np.roll(prev, dy, axis=0), dx, axis=1)
    else:
        base = prev
    flat = np.ascontiguousarray(base).view(np.uint8).reshape(-1)
    if flat.size != residual.size:
        raise ValueError("residual length mismatch with geometry")
    out = (flat + residual).astype(np.uint8)  # uint8 wrap == mod 256
    return out.view(prev.dtype).reshape(prev.shape)


def wrap_motion(dy: int, dx: int, inner: bytes) -> bytes:
    """Wrap an inter-style record with a global-motion header (type 6).

    The decoder rolls the previous reconstruction by (dy, dx) —
    np.roll wrap-around semantics on the (H, W) axes — before applying
    the inner record's mask/values."""
    return _U8.pack(MOTION) + struct.pack("<hh", dy, dx) + inner


def parse_motion(data: bytes):
    """Returns (dy, dx, inner_offset) of a type-6 or type-9 record
    (type-9 shifts are in half-pel units)."""
    dy, dx = struct.unpack_from("<hh", data, 1)
    return dy, dx, 5


def wrap_motion_hp(sy: int, sx: int, inner: bytes) -> bytes:
    """Wrap a residual record with a HALF-PEL motion header (type 9)."""
    return _U8.pack(MOTION_HP) + struct.pack("<hh", sy, sx) + inner


def wrap_motion_ref(ref_back: int, sy: int, sx: int,
                    inner: bytes) -> bytes:
    """Wrap a residual record with a MULTI-REFERENCE half-pel motion
    header (type 16): the prediction reads ``ref_back`` frames back
    (2-7) instead of the immediately previous frame.  Sub-half-pel
    per-frame motion (slow pans; chroma planes pan at half the luma
    rate) is invisible to the half-pel grid frame-to-frame, but a
    longer temporal baseline doubles/triples the phase step back onto
    it — the multi-reference idea of H.264's reference picture lists.
    Layout: <B 16, <B ref_back, <hh sy sx (half-pel units), inner.

    ``ref_back`` reaches to 15: chroma planes of a 4:2:0 stream pan at
    HALF the luma rate AND alias under 2x subsampling — an odd full-res
    row shift is invisible to the plane grid — so their content only
    realigns with a reference every 4th/8th frame."""
    if not 2 <= ref_back <= 15:
        raise ValueError(f"ref_back {ref_back} outside [2, 15]")
    return (_U8.pack(REF_HP) + _U8.pack(ref_back)
            + struct.pack("<hh", sy, sx) + inner)


def parse_motion_ref(data: bytes):
    """Returns (ref_back, sy, sx, inner_offset) of a type-16 record."""
    if len(data) < 6:
        raise ValueError("truncated multi-reference motion record")
    ref_back = data[1]
    if not 2 <= ref_back <= 15:
        raise ValueError(f"ref_back {ref_back} outside [2, 15]")
    sy, sx = struct.unpack_from("<hh", data, 2)
    return ref_back, sy, sx, 6


def wrap_avg2(rb2: int, thr: int, inner: bytes) -> bytes:
    """Wrap a residual record with a CONDITIONAL TWO-REFERENCE AVERAGE
    prediction header (type 19): where the previous frame and the frame
    ``rb2`` back (2-15) agree within ``thr`` (1-255), the predictor is
    their rounded mean; elsewhere it falls back to the previous frame.
    On static scenes under sensor grain, plain DPCM codes the
    difference of two independent grain fields (variance 2 sigma^2);
    averaging two references where they agree halves the reference-side
    grain (1.5 sigma^2) while the threshold keeps moving content —
    where blending would ghost — on plain DPCM.  Temporal denoising
    with change detection, applied backwards-only so the stream stays
    strictly causal.  Layout: <B 19, <B rb2, <B thr, inner."""
    if not 2 <= rb2 <= 15:
        raise ValueError(f"rb2 {rb2} outside [2, 15]")
    if not 1 <= thr <= 255:
        raise ValueError(f"avg2 threshold {thr} outside [1, 255]")
    return _U8.pack(AVG2) + _U8.pack(rb2) + _U8.pack(thr) + inner


def parse_motion_avg2(data: bytes):
    """Returns (rb2, thr, inner_offset) of a type-19 record."""
    if len(data) < 3:
        raise ValueError("truncated avg2 record")
    rb2, thr = data[1], data[2]
    if not 2 <= rb2 <= 15:
        raise ValueError(f"avg2 rb2 {rb2} outside [2, 15]")
    if thr < 1:
        raise ValueError("avg2 threshold 0")
    return rb2, thr, 3


def avg2_predict(ref1: np.ndarray, ref2: np.ndarray,
                 thr: int) -> np.ndarray:
    """Conditional rounded mean of two uint8 references: averaged where
    they agree within ``thr``, ``ref1`` elsewhere (exact integer
    math)."""
    a = ref1.astype(np.int16)
    b = ref2.astype(np.int16)
    avg = (a + b + 1) >> 1
    return np.where(np.abs(a - b) <= thr, avg, a).astype(np.uint8)


def wrap_motion_tiles(tlog: int, tshifts: np.ndarray, inner: bytes,
                      zlib_level: int = 6, rtype: int = TILES) -> bytes:
    """Wrap a residual record with a PER-TILE motion map (type 10, or
    type 17 when ``rtype=TILES_HP`` — same layout, shifts in half-pel
    units).

    ``tshifts``: (ty, tx, 2) int8 — (dy, dx) per square tile of side
    2**tlog, row-major.  Layout: <B rtype, <B tlog, <H ty, <H tx,
    <H zlen, map bytes (DEFLATE'd when that is smaller, zlen == 0
    means raw), inner."""
    t = np.ascontiguousarray(tshifts, dtype=np.int8)
    ty, tx = t.shape[:2]
    raw = t.tobytes()
    z = zlib.compress(raw, level=zlib_level)
    hdr = _U8.pack(rtype) + _U8.pack(tlog) + _U16.pack(ty) + _U16.pack(tx)
    if len(z) < len(raw):
        return hdr + _U16.pack(len(z)) + z + inner
    return hdr + _U16.pack(0) + raw + inner


def parse_motion_tiles(data: bytes, offset: int = 0):
    """Inverse of :func:`wrap_motion_tiles` (from the type byte; the
    layout is shared by types 10 and 17 — the caller dispatches the
    prediction on the type).

    Returns (tlog, tshifts (ty, tx, 2) int8, inner_offset)."""
    if len(data) < offset + 8:
        raise ValueError("truncated tile-motion header")
    tlog = data[offset + 1]
    ty, tx = struct.unpack_from("<HH", data, offset + 2)
    zlen = struct.unpack_from("<H", data, offset + 6)[0]
    pos = offset + 8
    raw_len = ty * tx * 2
    if ty == 0 or tx == 0 or tlog > 12:
        raise ValueError("tile-motion record with bad tile geometry")
    if zlen:
        try:
            raw = zlib.decompress(data[pos: pos + zlen])
        except zlib.error as e:
            raise ValueError(f"corrupt tile-motion map: {e}") from e
        pos += zlen
    else:
        raw = data[pos: pos + raw_len]
        pos += raw_len
    if len(raw) != raw_len:
        raise ValueError("tile-motion map length mismatch")
    tshifts = np.frombuffer(raw, dtype=np.int8).reshape(ty, tx, 2)
    return tlog, tshifts, pos


def tile_predict(prev: np.ndarray, tshifts: np.ndarray,
                 tlog: int) -> np.ndarray:
    """Per-tile motion prediction: pred[y, x] = prev[clip(y - dy_t),
    clip(x - dx_t)] where (dy_t, dx_t) is the shift of (y, x)'s tile.

    Edge-CLAMPED sampling (unlike the type-6 global roll's wrap): a
    per-tile wrap would smear the opposite frame edge into interior
    tiles.  Works on (h, w) or (h, w, c) arrays of any dtype — the
    gather is whole-pixel, never byte-mixing."""
    h, w = prev.shape[:2]
    dy, dx = _tile_pel_maps(tshifts, tlog, h, w)
    rows = np.clip(np.arange(h, dtype=np.int32)[:, None] - dy, 0, h - 1)
    cols = np.clip(np.arange(w, dtype=np.int32)[None, :] - dx, 0, w - 1)
    return prev[rows, cols]


def _tile_pel_maps(tshifts: np.ndarray, tlog: int, h: int, w: int):
    """Per-pixel (dy, dx) int32 maps from a per-tile shift map."""
    t = 1 << tlog
    ty, tx = tshifts.shape[:2]
    if ty != -(-h // t) or tx != -(-w // t):
        raise ValueError("tile map does not cover the frame geometry")
    dy = np.repeat(np.repeat(tshifts[:, :, 0].astype(np.int32), t, 0),
                   t, 1)[:h, :w]
    dx = np.repeat(np.repeat(tshifts[:, :, 1].astype(np.int32), t, 0),
                   t, 1)[:h, :w]
    return dy, dx


def wrap_motion_zoom(z_cur: int, dy: int, dx: int, inner: bytes,
                     ref_back: int = 1, z_ref: int = 0) -> bytes:
    """Wrap a residual record with a parametric ZOOM global-motion
    header (type 18): TWO cumulative scale deltas in parts per million
    (scale = 1 + z * 1e-6 about the frame centre) that place the
    current frame (``z_cur``) and the reference ``ref_back`` frames
    back (``z_ref``) on a common latent pixel grid, plus an integer
    translation.  The two-scale form is the honest global-motion-model
    projection (MPEG-4 GMC / AV1 ROTZOOM restricted to isotropic
    scale): prediction maps each pixel to its LATENT grid point under
    s_cur, then samples the reference at the pixel that covers that
    latent point under s_ref — exact for resampled zooms, where a
    single relative scale composes two nearest-neighbour quantizations
    and mispredicts most pixels.  ``z_ref=0`` degrades to the direct
    single-stage map.  Layout: <B 18, <B ref_back, <i z_cur, <i z_ref,
    <hh dy dx, inner."""
    if not 1 <= ref_back <= 15:
        raise ValueError(f"zoom ref_back {ref_back} outside [1, 15]")
    return (_U8.pack(ZOOM_G) + _U8.pack(ref_back)
            + struct.pack("<ii", int(z_cur), int(z_ref))
            + struct.pack("<hh", dy, dx) + inner)


def parse_motion_zoom(data: bytes, offset: int = 0):
    """Returns (ref_back, z_cur, z_ref, dy, dx, inner_offset) of a
    type-18 record."""
    if len(data) < offset + 14:
        raise ValueError("truncated zoom-motion record")
    ref_back = data[offset + 1]
    if not 1 <= ref_back <= 15:
        raise ValueError(f"zoom ref_back {ref_back} outside [1, 15]")
    z_cur, z_ref = struct.unpack_from("<ii", data, offset + 2)
    for z in (z_cur, z_ref):
        if not -500_000 <= z <= 500_000:
            raise ValueError(f"zoom-motion scale delta {z} out of range")
    dy, dx = struct.unpack_from("<hh", data, offset + 10)
    return ref_back, z_cur, z_ref, dy, dx, offset + 14


def zoom_predict(prev: np.ndarray, z_cur: int, z_ref: int = 0,
                 dy: int = 0, dx: int = 0) -> np.ndarray:
    """Parametric zoom prediction (type 18), separable per axis with
    edge-clamped nearest-neighbour gathers and float64 index math
    (bit-deterministic across hosts).

    Two-stage latent-grid map: m = floor((p - c) / s_cur + c) is the
    latent pixel frame position p shows under cumulative scale s_cur;
    the reference pixel q = ceil(c + (m - c) * s_ref) is the smallest
    grid point whose own latent source under s_ref is m (any q in
    [c + (m-c)s_ref, c + (m+1-c)s_ref) maps to m; for s_ref >= 1 that
    interval always contains ceil of its start).  With z_ref == 0 the
    second stage is the identity (q = m) — the direct single-scale
    map.  Integer translation t = (dy, dx) applies to q.  A zoom's
    shift field varies continuously with radius; the per-pixel gather
    reproduces it exactly where any per-tile map leaves mixed-rounding
    seams."""
    h, w = prev.shape[:2]
    s_cur = 1.0 + z_cur * 1e-6
    cy, cx = h / 2.0, w / 2.0

    def axis(n: int, c: float) -> np.ndarray:
        m = np.floor((np.arange(n) - c) / s_cur + c)
        if z_ref:
            m = np.ceil(c + (m - c) * (1.0 + z_ref * 1e-6))
        return m.astype(np.int64)

    ys = np.clip(axis(h, cy) - dy, 0, h - 1)
    xs = np.clip(axis(w, cx) - dx, 0, w - 1)
    return prev[np.ix_(ys, xs)]


def wrap_motion_rot(a_cur: int, dy: int, dx: int, inner: bytes,
                    ref_back: int = 1, a_ref: int = 0) -> bytes:
    """Wrap a residual record with a parametric ROTATION global-motion
    header (type 20): TWO cumulative rotation angles in microradians
    about the frame centre that place the current frame (``a_cur``)
    and the reference ``ref_back`` frames back (``a_ref``) on a common
    latent pixel grid, plus an integer translation — the rotation
    component of MPEG-4 GMC / AV1 ROTZOOM the per-tile map can only
    quantize (a rotation's shift field varies continuously with radius
    AND direction, leaving mixed-rounding seams inside every tile).
    The two-angle form mirrors the type-18 zoom: a single relative
    angle composes two nearest-neighbour resamplings and mispredicts
    many pixels mid-rotation; mapping both frames onto the latent grid
    keeps the prediction near-exact whenever the anchor's absolute
    angle is tracked.  ``a_ref=0`` degrades to the direct single-stage
    map.  Layout: <B 20, <B ref_back, <i a_cur, <i a_ref, <hh dy dx,
    inner."""
    if not 1 <= ref_back <= 15:
        raise ValueError(f"rotation ref_back {ref_back} outside [1, 15]")
    for a in (a_cur, a_ref):
        if not -1_000_000 <= a <= 1_000_000:
            raise ValueError(f"rotation angle {a} urad outside +-1e6")
    return (_U8.pack(ROT_G) + _U8.pack(ref_back)
            + struct.pack("<ii", int(a_cur), int(a_ref))
            + struct.pack("<hh", dy, dx) + inner)


def parse_motion_rot(data: bytes, offset: int = 0):
    """Returns (ref_back, a_cur, a_ref, dy, dx, inner_offset) of a
    type-20 record."""
    if len(data) < offset + 14:
        raise ValueError("truncated rotation-motion record")
    ref_back = data[offset + 1]
    if not 1 <= ref_back <= 15:
        raise ValueError(f"rotation ref_back {ref_back} outside [1, 15]")
    a_cur, a_ref = struct.unpack_from("<ii", data, offset + 2)
    for a in (a_cur, a_ref):
        if not -1_000_000 <= a <= 1_000_000:
            raise ValueError(f"rotation angle {a} urad outside +-1e6")
    dy, dx = struct.unpack_from("<hh", data, offset + 10)
    return ref_back, a_cur, a_ref, dy, dx, offset + 14


def rot_predict(prev: np.ndarray, a_cur: int, a_ref: int = 0,
                dy: int = 0, dx: int = 0) -> np.ndarray:
    """Parametric rotation prediction (type 20): two-stage latent-grid
    map with edge-clamped nearest-neighbour gathers and float64 index
    math (bit-deterministic across hosts).

    Stage 1 maps each current pixel p to its latent source
    m = floor(c + R(a_cur)(p - c)); stage 2 samples the reference at
    the pixel whose own latent source is m — approximated by the
    cell-centre preimage q = floor(c + R(-a_ref)(m + 0.5 - c)).  With
    ``a_ref == 0`` stage 2 is the identity (q = m), the direct
    single-stage map.  Integer translation (dy, dx) applies to q.
    Whole-pixel gather, never byte-mixing, so any dtype and channel
    count works."""
    h, w = prev.shape[:2]
    cy, cx = h / 2.0, w / 2.0
    th = a_cur * 1e-6
    c0, s0 = math.cos(th), math.sin(th)
    yy = np.arange(h, dtype=np.float64)[:, None] - cy
    xx = np.arange(w, dtype=np.float64)[None, :] - cx
    my = np.floor(cy + yy * c0 - xx * s0)
    mx = np.floor(cx + yy * s0 + xx * c0)
    if a_ref:
        tr = a_ref * 1e-6
        c1, s1 = math.cos(-tr), math.sin(-tr)
        uy = my + 0.5 - cy
        ux = mx + 0.5 - cx
        my = np.floor(cy + uy * c1 - ux * s1)
        mx = np.floor(cx + uy * s1 + ux * c1)
    ry = my.astype(np.int64) - dy
    rx = mx.astype(np.int64) - dx
    np.clip(ry, 0, h - 1, out=ry)
    np.clip(rx, 0, w - 1, out=rx)
    return prev[ry, rx]


def tile_predict_hp(prev: np.ndarray, tshifts: np.ndarray,
                    tlog: int) -> np.ndarray:
    """Per-tile HALF-PEL motion prediction (type 17): ``tshifts`` is in
    half-pixel units; each pixel samples prev at (y - dy_t/2, x - dx_t/2)
    with edge-clamped coordinates and the exact integer bilinear
    rounding of :func:`halfpel_predict` ((a+b+1)>>1 / (a+b+c+d+2)>>2).
    uint8 arrays only — byte-domain frames must never be averaged."""
    if prev.dtype != np.uint8:
        raise ValueError("half-pel tile prediction on non-uint8 frame")
    h, w = prev.shape[:2]
    sy, sx = _tile_pel_maps(tshifts, tlog, h, w)
    iy, fy = sy >> 1, (sy & 1).astype(np.uint16)
    ix, fx = sx >> 1, (sx & 1).astype(np.uint16)
    yy = np.arange(h, dtype=np.int32)[:, None]
    xx = np.arange(w, dtype=np.int32)[None, :]
    r0 = np.clip(yy - iy, 0, h - 1)
    r1 = np.clip(yy - iy - 1, 0, h - 1)   # the fy half-step neighbor
    c0 = np.clip(xx - ix, 0, w - 1)
    c1 = np.clip(xx - ix - 1, 0, w - 1)
    if prev.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    p00 = prev[r0, c0].astype(np.uint16)
    # Per-pixel mixed phases in one exact expression: weights (1, fx,
    # fy, fy*fx), bias (1 << (fy+fx)) >> 1, shift fy+fx — reduces to
    # p00 / (a+b+1)>>1 / (a+b+c+d+2)>>2 per tile.  Max sum 1022 < 2^16.
    acc = (p00 + fx * prev[r0, c1] + fy * prev[r1, c0]
           + (fy * fx) * prev[r1, c1])
    sh = fy + fx
    return ((acc + ((1 << sh) >> 1)) >> sh).astype(np.uint8)


def parse_interframe(data: bytes, offset: int = 0) -> dict:
    """Parse an inter-frame payload into its raw parts without running the
    Bloom decode (for batched device decoding)."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    out = {}
    out["p"] = _F32.unpack(buf.read(4))[0]
    out["n"] = _U32.unpack(buf.read(4))[0]
    out["k"] = _F32.unpack(buf.read(4))[0]
    out["bitmap_bits"] = _U32.unpack(buf.read(4))[0]
    out["witness_bits"] = _U32.unpack(buf.read(4))[0]
    bsize = _U32.unpack(buf.read(4))[0]
    out["bitmap_bytes"] = np.frombuffer(buf.read(bsize), dtype=np.uint8)
    wsize = _U32.unpack(buf.read(4))[0]
    out["witness_bytes"] = np.frombuffer(buf.read(wsize), dtype=np.uint8)
    vz_len = _U32.unpack(buf.read(4))[0]
    out["values_count"] = _U32.unpack(buf.read(4))[0]
    out["values"] = np.frombuffer(
        zlib.decompress(buf.read(vz_len)), dtype=np.uint8)[: out["values_count"]]
    return out


def decode_interframe(data: bytes, codec, offset: int = 0):
    """Inverse of :func:`encode_interframe` (payload after any type byte).

    ``codec`` is any object with the ``BloomFilterCompressor`` surface
    (``compress``/``decompress``/``_calculate_optimal_params``), such as
    ``models.binary_codec.BloomFilterCompressor``.

    Returns (flat mask uint8[n], values uint8[count]).
    (reference: improved_video_compressor.py:969-1015)
    """
    rec = parse_interframe(data, offset)
    bitmap = np.unpackbits(rec["bitmap_bytes"])[: rec["bitmap_bits"]]
    witness = np.unpackbits(rec["witness_bytes"])[: rec["witness_bits"]]
    if rec["witness_bits"] > 0:
        flat = codec.decompress(bitmap, witness, rec["n"], rec["k"])
    else:
        flat = bitmap
    return flat, rec["values"]


# ---------------------------------------------------------------------------
# Planar stream header (profile="planar": native-subsampling plane coding)
# ---------------------------------------------------------------------------

def encode_planar_header(fmt: str, width: int, height: int,
                         frame_count: int, plane_counts) -> bytes:
    """Planar container header (type 5).

    Layout: <B 5, <H len + fmt utf-8, <I width, <I height (luma geometry),
    <I frame_count, <B n_planes, n_planes x <I per-plane record count.
    The header payload is followed in the container by each plane's
    record sequence, in plane order (Y, then U, then V)."""
    buf = io.BytesIO()
    buf.write(_U8.pack(PLANAR))
    f = fmt.encode("utf-8")
    buf.write(_U16.pack(len(f)))
    buf.write(f)
    buf.write(_U32.pack(width))
    buf.write(_U32.pack(height))
    buf.write(_U32.pack(frame_count))
    buf.write(_U8.pack(len(plane_counts)))
    for c in plane_counts:
        buf.write(_U32.pack(c))
    return buf.getvalue()


def parse_planar_header(data: bytes, offset: int = 0) -> dict:
    """Inverse of :func:`encode_planar_header` (after the type byte)."""
    buf = io.BytesIO(data)
    buf.seek(offset)
    fmt_len = _U16.unpack(buf.read(2))[0]
    fmt = buf.read(fmt_len).decode("utf-8")
    width = _U32.unpack(buf.read(4))[0]
    height = _U32.unpack(buf.read(4))[0]
    frame_count = _U32.unpack(buf.read(4))[0]
    n_planes = _U8.unpack(buf.read(1))[0]
    counts = [_U32.unpack(buf.read(4))[0] for _ in range(n_planes)]
    return {"format": fmt, "width": width, "height": height,
            "frame_count": frame_count, "plane_counts": counts}


def record_type(data: bytes) -> int:
    """Type byte of a typed record."""
    return data[0]
