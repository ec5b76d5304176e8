"""Blocked rational-Bloom kernels K1-K5b: wrappers and plain twins.

The PyTorch counterpart of ``new_bloom_filter_repo_tpu/ops/pallas/
blocked.py``.  The stream semantics are unchanged: the items of each
1024-index block probe only that block's private m-bit sub-filter
(m <= 384, at most 12 u32 words); floor(k) deterministic lanes plus the
fractional activation lane; per-block witness segments of the passing
items' change bits, MSB-first; the changed items' 24-bit packed pixels
compacted to the front of a ``vh * 32``-slot value segment.

Each public function keeps the JAX signature, shapes and dtypes, with
``k_lanes``, ``nw`` and ``vh`` as plain run-time arguments (the JAX
package bucketed them into compile variants).  It dispatches on where
its tensors lie:

* a CPU tensor goes to the function's plain PyTorch twin (``*_ref``),
  which is the CPU tests' path and the reference the kernel is held to;
* a CUDA tensor goes to the hand-written Hopper kernel
  (``ops/csrc/blocked.cu``), built at first use; the wrapper raises if
  the build, the checks or the launch fail.  Nothing falls back.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``; :func:`reset_launches` and :func:`launches` read
and clear them all.

Dtype conventions: the u32 quantities of the JAX interface (the
activation-hash halves and the per-frame thresholds ``thi``/``tlo``)
travel as int32 tensors holding the same bit patterns, because torch's
uint32 supports few operations.  The twins widen to int64 before any
shift or compare, so no arithmetic right shift or signed compare can
change a bit.
"""

from __future__ import annotations

from typing import Dict

import torch

from new_bloom_filter_repo_tpu_torch.ops import _build
from new_bloom_filter_repo_tpu_torch.ops._build import GMAX, MAX_K_LANES

IPB = 1024              # items (pixel indices) per block
NW = 12                 # u32 sub-filter words per block
MMAX = NW * 32          # = 384: max per-block filter bits
WIT_BYTES = IPB // 8    # per-block witness segment (128 B, byte-aligned)
WW = IPB // 32          # witness u32 words per block (32)
# K1, K2, K5a and K5b: a CTA walks up to GMAX frames of one block (the
# build's constant); the wrapper splits the frames into groups so the
# grid holds at least TARGET_CTAS CTAs (about 8 of 256 threads per SM of
# an H100's 132).
TARGET_CTAS = 1024

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Packing helpers (bit order: np.packbits per u32 word / big-endian bytes)
# ---------------------------------------------------------------------------

def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def words32_to_bits(words32: torch.Tensor) -> torch.Tensor:
    """(..., nw) i32 -> (..., nw*32) u8 (packbits bit order per word)."""
    shifts = 31 - torch.arange(32, device=words32.device, dtype=torch.int64)
    bits = (words32.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(words32.shape[:-1]
                        + (words32.shape[-1] * 32,)).to(torch.uint8)


def bits_to_words32(bits: torch.Tensor) -> torch.Tensor:
    """(..., nw*32) u8 -> (..., nw) i32."""
    nw = bits.shape[-1] // 32
    b = bits.reshape(bits.shape[:-1] + (nw, 32)).to(torch.int64)
    shifts = 31 - torch.arange(32, device=bits.device, dtype=torch.int64)
    return _wrap_i32((b << shifts).sum(dim=-1))


def _witwords_to_bytes(witw: torch.Tensor) -> torch.Tensor:
    """(F, NB, WW) i32 -> (F, NB, WIT_BYTES) u8 big-endian per word."""
    shifts = torch.tensor([24, 16, 8, 0], device=witw.device,
                          dtype=torch.int64)
    by = (witw.to(torch.int64)[..., None] >> shifts) & 0xFF
    return by.reshape(witw.shape[:-1] + (WIT_BYTES,)).to(torch.uint8)


def _bytes_to_witwords(by: torch.Tensor) -> torch.Tensor:
    """(F, NB, WIT_BYTES) u8 -> (F, NB, WW) i32 big-endian per word."""
    b = by.reshape(by.shape[:-1] + (WW, 4)).to(torch.int64)
    return _wrap_i32((b[..., 0] << 24) | (b[..., 1] << 16)
                     | (b[..., 2] << 8) | b[..., 3])


def _pack_bits_msb(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8k) 0/1 -> (..., k) u8, MSB-first (np.packbits)."""
    b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=bits.device,
                     dtype=torch.int32)
    return (b.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------

def _prelude(h1, h2, act_hi, act_lo, m, thi, tlo):
    """a = h1 mod m, b = h2 mod m, act = (u64 activation hash <
    threshold), broadcast to (F, NB, IPB); u64 compare as an unsigned
    hi/lo compare in int64."""
    f_ = m.shape[0]
    m64 = m.to(torch.int64).view(f_, 1, 1)
    a = h1.to(torch.int64)[None] % m64
    b = h2.to(torch.int64)[None] % m64
    ahi = (act_hi.to(torch.int64) & _U32)[None]
    alo = (act_lo.to(torch.int64) & _U32)[None]
    thi64 = (thi.to(torch.int64) & _U32).view(f_, 1, 1)
    tlo64 = (tlo.to(torch.int64) & _U32).view(f_, 1, 1)
    act = (ahi < thi64) | ((ahi == thi64) & (alo < tlo64))
    return a, b, act


def lane_count(max_floor_k: int) -> int:
    """``k_lanes`` for frames whose largest floor(k) is ``max_floor_k``:
    that floor(k), within [0, MAX_K_LANES] as the JAX package's
    ``k_bucket`` bounds it.  A frame with a larger floor(k), which only a
    damaged stream carries, then probes lanes 0..MAX_K_LANES, as in the
    JAX package; a negative floor(k) activates no lane in either."""
    return min(max(int(max_floor_k), 0), MAX_K_LANES)


def _check_k_lanes(k_lanes: int) -> None:
    if not 0 <= k_lanes <= MAX_K_LANES:
        raise ValueError(f"k_lanes={k_lanes} outside [0, {MAX_K_LANES}]")


def _lanes(a, b, m64, act, floor_k, k_lanes):
    """Yield (positions, active) for lanes j = 0..k_lanes: position
    (a + j*b) mod m, active when j < floor_k or (j == floor_k and act).
    The mod is one conditional subtract per lane, as in the JAX
    package's ``_positions``: it assumes a, b < m."""
    fk = floor_k.to(torch.int64).view(-1, 1, 1)
    pos = a
    for j in range(k_lanes + 1):
        yield pos, (fk > j) | ((fk == j) & act)
        pos = pos + b
        pos = torch.where(pos >= m64, pos - m64, pos)


def _membership(filt, a, b, m64, act, floor_k, k_lanes, cap):
    """Pass mask (F, NB, IPB) bool given the expanded sub-filter bits
    ``filt`` (F, NB, cap) u8."""
    f_, nb, _ = filt.shape
    flat = filt.reshape(-1)
    row = (torch.arange(f_ * nb, device=filt.device, dtype=torch.int64)
           .view(f_, nb, 1) * cap)
    passes = torch.ones(a.shape, dtype=torch.bool, device=filt.device)
    for pos, active in _lanes(a, b, m64, act, floor_k, k_lanes):
        inb = pos < cap
        hit = (flat[row + torch.where(inb, pos, 0)] != 0) & inb
        passes &= hit | ~active
    return passes


def _excl_rank(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count along the last axis (int64)."""
    x64 = x.to(torch.int64)
    return torch.cumsum(x64, dim=-1) - x64


def blocked_encode_ref(bits, a, b, act, vals, m, floor_k, *, k_lanes: int,
                       vh: int, nw: int = NW):
    """Plain twin of :func:`blocked_encode`.  Value slots beyond a
    block's ``vcnt`` are zero (the JAX kernel leaves compaction
    leftovers there; the stream never reads them)."""
    f_, nb, _ = bits.shape
    dev = bits.device
    cap = nw * 32
    m64 = m.to(torch.int64).view(f_, 1, 1)
    a, b, act = a.to(torch.int64), b.to(torch.int64), act != 0
    changed = bits != 0
    filt = torch.zeros(f_ * nb * cap, dtype=torch.uint8, device=dev)
    row = (torch.arange(f_ * nb, device=dev, dtype=torch.int64)
           .view(f_, nb, 1))
    for pos, active in _lanes(a, b, m64, act, floor_k, k_lanes):
        sel = active & changed & (pos < cap)
        filt[(row * cap + pos)[sel]] = 1
    filt = filt.view(f_, nb, cap)
    words = bits_to_words32(filt)
    passes = _membership(filt, a, b, m64, act, floor_k, k_lanes, cap)

    wbits = torch.zeros(f_ * nb * IPB, dtype=torch.uint8, device=dev)
    rank = _excl_rank(passes)
    wbits[(row * IPB + rank)[passes & changed]] = 1
    wit = _pack_bits_msb(wbits.view(f_, nb, IPB))
    wcnt = passes.sum(dim=-1).to(torch.int32)

    vslots = vh * 32
    slot = _excl_rank(changed)
    vseg = torch.zeros(f_ * nb * vslots, dtype=torch.int32, device=dev)
    keep = changed & (slot < vslots)
    vseg[(row * vslots + slot)[keep]] = vals.to(torch.int32)[keep]
    vcnt = changed.sum(dim=-1).to(torch.int32)
    return words, wit, wcnt, vseg.view(f_, nb, vslots), vcnt


def blocked_encode_h_ref(bits, h1, h2, act_hi, act_lo, vals, m, thi, tlo,
                         floor_k, *, k_lanes: int, vh: int, nw: int = NW):
    """Plain twin of :func:`blocked_encode_h`: the hash prelude, then
    :func:`blocked_encode_ref`'s body."""
    a, b, act = _prelude(h1, h2, act_hi, act_lo, m, thi, tlo)
    return blocked_encode_ref(bits, a, b, act, vals, m, floor_k,
                              k_lanes=k_lanes, vh=vh, nw=nw)


def blocked_membership_ref(words, a, b, act, m, floor_k, flags, *,
                           k_lanes: int, nw: int = NW):
    """Plain twin of :func:`blocked_membership`."""
    _check_words(words, nw)
    f_ = words.shape[0]
    filt = words32_to_bits(words[:, :, :nw])
    m64 = m.to(torch.int64).view(f_, 1, 1)
    passes = _membership(filt, a.to(torch.int64), b.to(torch.int64), m64,
                         act != 0, floor_k, k_lanes, nw * 32)
    passes &= (flags == 0).view(f_, 1, 1)
    return passes.to(torch.uint8), passes.sum(dim=-1).to(torch.int32)


def blocked_membership_h_ref(words, h1, h2, act_hi, act_lo, m, thi, tlo,
                             floor_k, flags, *, k_lanes: int,
                             nw: int = NW):
    """Plain twin of :func:`blocked_membership_h`: the hash prelude,
    then :func:`blocked_membership_ref`'s body."""
    a, b, act = _prelude(h1, h2, act_hi, act_lo, m, thi, tlo)
    return blocked_membership_ref(words, a, b, act, m, floor_k, flags,
                                  k_lanes=k_lanes, nw=nw)


def blocked_expand_ref(passes, wit, raw_mask, flags, vseg, *, vh: int):
    """Plain twin of :func:`blocked_expand`."""
    f_ = passes.shape[0]
    p = passes != 0
    rank = _excl_rank(p)
    byte = torch.gather(wit, -1, (rank >> 3).clamp(max=WIT_BYTES - 1))
    wbit = (byte.to(torch.int64) >> (7 - (rank & 7))) & 1
    decoded = p & (wbit != 0)
    mask = torch.where((flags != 0).view(f_, 1, 1), raw_mask != 0, decoded)
    vslots = vh * 32
    slot = _excl_rank(mask)
    v = torch.gather(vseg.to(torch.int32), -1, slot.clamp(max=vslots - 1))
    vals = torch.where(mask & (slot < vslots), v, 0)
    return mask.to(torch.uint8), vals.to(torch.int32)


def blocked_expand_chain_ref(passes, wit, raw_mask, flags, vseg,
                             base_packed, *, vh: int):
    """Plain twin of :func:`blocked_expand_chain`."""
    mask, vals = blocked_expand_ref(passes, wit, raw_mask, flags, vseg,
                                    vh=vh)
    out = torch.empty_like(vals)
    run = base_packed.to(torch.int32)
    for f in range(mask.shape[0]):
        run = torch.where(mask[f] != 0, vals[f], run)
        out[f] = run
    return out


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> twin, CUDA tensor -> kernel (or raise)
# ---------------------------------------------------------------------------

def _check_words(words, nw: int):
    """Guard on the packed-words contract: (F, NB, nw..NW) int32."""
    if words.dtype != torch.int32:
        raise TypeError(
            f"words must be int32 PACKED sub-filter words (got "
            f"{words.dtype}); convert expanded bits with bits_to_words32")
    if words.shape[-1] < nw or words.shape[-1] > NW:
        raise ValueError(
            f"words last axis must be in [{nw}, {NW}] packed u32 words, "
            f"got {words.shape[-1]} (expanded-bit arrays are {MMAX} wide)")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


# Arrays the kernels read as vectors besides the per-item ones (K3/K4).
_VECTOR_ROWS = ("wit", "vseg")


def _cuda_args(device, named: Dict[str, tuple]):
    """Check each (tensor, dtype, shape) for the kernel and return the
    tensors' device pointers, in order.  Per-item arrays (last axis IPB),
    witness segments and value segments must start on a 16-byte
    boundary: the kernels load them as vectors."""
    ptrs = []
    for name, (t, dtype, shape) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (shape[-1] == IPB or name in _VECTOR_ROWS) and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        ptrs.append(t.data_ptr())
    return ptrs


def frames_per_cta(f_: int, nb: int) -> int:
    """Frames one CTA of K1, K2, K5a or K5b walks: all ``f_`` (so the
    hash tables are read once) unless that leaves fewer than
    TARGET_CTAS CTAs, and never more than GMAX."""
    groups = max(-(-f_ // GMAX), min(f_, -(-TARGET_CTAS // nb)))
    return -(-f_ // groups)


def _launch(name: str, args: list, device) -> None:
    """Launch a kernel on ``device``'s current stream, with ``device``
    current: the runtime loads the module into, and launches in, the
    context of the current card, which must be the tensors' own."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _scalars(f_, m, thi, tlo, floor_k, flags=None):
    out = {"m": (m, torch.int32, (f_,)), "thi": (thi, torch.int32, (f_,)),
           "tlo": (tlo, torch.int32, (f_,)),
           "floor_k": (floor_k, torch.int32, (f_,))}
    if flags is not None:
        out["flags"] = (flags, torch.int32, (f_,))
    return out


def _mod_tables(f_, nb, a, b, act):
    return {"a": (a, torch.int32, (f_, nb, IPB)),
            "b": (b, torch.int32, (f_, nb, IPB)),
            "act": (act, torch.uint8, (f_, nb, IPB))}


def _tables(nb, h1, h2, act_hi, act_lo):
    return {k: (t, torch.int32, (nb, IPB)) for k, t in
            (("h1", h1), ("h2", h2), ("act_hi", act_hi),
             ("act_lo", act_lo))}


def blocked_encode_h(bits, h1, h2, act_hi, act_lo, vals, m, thi, tlo,
                     floor_k, *, k_lanes: int, vh: int, nw: int = NW):
    """Blocked Bloom encode of a chunk with in-kernel hash prelude (K1).

    Args:
      bits: (F, NB, IPB) uint8 change-mask bits per block.
      h1, h2: (NB, IPB) int32 — low 24 bits of the per-geometry hashes.
      act_hi, act_lo: (NB, IPB) int32 — u32 halves of the activation hash.
      vals: (F, NB, IPB) int32 — 24-bit packed pixel values.
      m, thi, tlo, floor_k: (F,) int32 per-frame sub-filter bits,
        activation threshold halves (u32 bit patterns) and floor(k).
      k_lanes: lanes 0..k_lanes run (>= the largest floor_k, or
        MAX_K_LANES; :func:`lane_count`).
      vh: value segments hold vh*32 slots per block.
      nw: sub-filter words per block (32*nw >= the largest m).

    Returns (words (F,NB,nw) i32 PACKED sub-filter words,
             wit (F,NB,128) u8, wcnt (F,NB) i32,
             vseg (F,NB,vh*32) i32, vcnt (F,NB) i32).
    Raises ValueError for k_lanes outside [0, MAX_K_LANES].
    """
    _check_k_lanes(k_lanes)
    if _on_cpu(bits):
        return blocked_encode_h_ref(bits, h1, h2, act_hi, act_lo, vals, m,
                                    thi, tlo, floor_k, k_lanes=k_lanes,
                                    vh=vh, nw=nw)
    f_, nb, _ = bits.shape
    if not (1 <= nw <= NW and 1 <= vh <= 32):
        raise ValueError(f"bad geometry nw={nw} vh={vh}")
    dev = bits.device
    outs = _encode_outputs(f_, nb, nw, vh, dev)
    ptrs = _cuda_args(dev, {
        "bits": (bits, torch.uint8, (f_, nb, IPB)),
        **_tables(nb, h1, h2, act_hi, act_lo),
        "vals": (vals, torch.int32, (f_, nb, IPB)),
        **_scalars(f_, m, thi, tlo, floor_k)})
    if f_ and nb:
        _launch("nbf_k1_encode",
                ptrs + [o.data_ptr() for o in outs]
                + [f_, nb, k_lanes, nw, vh * 32, frames_per_cta(f_, nb)],
                dev)
        blocked_encode_h.launches += 1
    return outs


def blocked_membership_h(words, h1, h2, act_hi, act_lo, m, thi, tlo,
                         floor_k, flags, *, k_lanes: int, nw: int = NW):
    """Decode pass mask with in-kernel hash prelude (K2).

    words: (F, NB, nw..NW) i32 PACKED sub-filter words; flags: (F,) i32 —
    1 for pass-through/sparse/empty records (passes forced to 0).
    Returns (passes (F,NB,IPB) u8, wcnt (F,NB) i32); the per-block pass
    count is summed inside the kernel.  Raises ValueError for k_lanes
    outside [0, MAX_K_LANES]."""
    _check_k_lanes(k_lanes)
    if _on_cpu(words):
        return blocked_membership_h_ref(words, h1, h2, act_hi, act_lo, m,
                                        thi, tlo, floor_k, flags,
                                        k_lanes=k_lanes, nw=nw)
    _check_words(words, nw)
    f_, nb, wstride = words.shape
    dev = words.device
    passes = torch.empty((f_, nb, IPB), dtype=torch.uint8, device=dev)
    wcnt = torch.empty((f_, nb), dtype=torch.int32, device=dev)
    ptrs = _cuda_args(dev, {
        "words": (words, torch.int32, (f_, nb, wstride)),
        **_tables(nb, h1, h2, act_hi, act_lo),
        **_scalars(f_, m, thi, tlo, floor_k, flags)})
    if f_ and nb:
        _launch("nbf_k2_membership",
                [ptrs[0], wstride] + ptrs[1:]
                + [passes.data_ptr(), wcnt.data_ptr(), f_, nb, k_lanes, nw,
                   frames_per_cta(f_, nb)], dev)
        blocked_membership_h.launches += 1
    return passes, wcnt


def _encode_outputs(f_, nb, nw, vh, dev):
    """Uninitialised (words, wit, wcnt, vseg, vcnt) for K1 and K5a."""
    return (torch.empty((f_, nb, nw), dtype=torch.int32, device=dev),
            torch.empty((f_, nb, WIT_BYTES), dtype=torch.uint8, device=dev),
            torch.empty((f_, nb), dtype=torch.int32, device=dev),
            torch.empty((f_, nb, vh * 32), dtype=torch.int32, device=dev),
            torch.empty((f_, nb), dtype=torch.int32, device=dev))


def blocked_encode(bits, a, b, act, vals, m, floor_k, *, k_lanes: int,
                   vh: int, nw: int = NW):
    """Blocked Bloom encode of a chunk from materialized position tables
    (K5a): K1 without the hash prelude.

    Args:
      bits: (F, NB, IPB) uint8 change-mask bits per block.
      a, b: (F, NB, IPB) int32 — h1 mod m, h2 mod m per frame (< m).
      act: (F, NB, IPB) uint8 — activation-lane test results (nonzero =
        active), as ``models.blocked_pipeline._frame_mod_tables`` makes.
      vals: (F, NB, IPB) int32 — 24-bit packed pixel values.
      m, floor_k: (F,) int32 per-frame sub-filter bits and floor(k).
      k_lanes, vh, nw: as for :func:`blocked_encode_h`.

    Returns what :func:`blocked_encode_h` returns; on the tables of
    ``_frame_mod_tables`` the two are equal."""
    _check_k_lanes(k_lanes)
    if _on_cpu(bits):
        return blocked_encode_ref(bits, a, b, act, vals, m, floor_k,
                                  k_lanes=k_lanes, vh=vh, nw=nw)
    f_, nb, _ = bits.shape
    if not (1 <= nw <= NW and 1 <= vh <= 32):
        raise ValueError(f"bad geometry nw={nw} vh={vh}")
    dev = bits.device
    outs = _encode_outputs(f_, nb, nw, vh, dev)
    ptrs = _cuda_args(dev, {
        "bits": (bits, torch.uint8, (f_, nb, IPB)),
        **_mod_tables(f_, nb, a, b, act),
        "vals": (vals, torch.int32, (f_, nb, IPB)),
        "m": (m, torch.int32, (f_,)),
        "floor_k": (floor_k, torch.int32, (f_,))})
    if f_ and nb:
        _launch("nbf_k5a_encode",
                ptrs + [o.data_ptr() for o in outs]
                + [f_, nb, k_lanes, nw, vh * 32, frames_per_cta(f_, nb)],
                dev)
        blocked_encode.launches += 1
    return outs


def blocked_membership(words, a, b, act, m, floor_k, flags, *,
                       k_lanes: int, nw: int = NW):
    """Decode pass mask from materialized position tables (K5b): K2
    without the hash prelude.

    words: (F, NB, nw..NW) i32 PACKED sub-filter words; a, b: (F,NB,IPB)
    i32 (< m); act: (F,NB,IPB) u8; m, floor_k, flags: (F,) i32.
    Returns (passes (F,NB,IPB) u8, wcnt (F,NB) i32); the per-block pass
    count is summed inside the kernel (an XLA pass on the TPU)."""
    _check_k_lanes(k_lanes)
    if _on_cpu(words):
        return blocked_membership_ref(words, a, b, act, m, floor_k, flags,
                                      k_lanes=k_lanes, nw=nw)
    _check_words(words, nw)
    f_, nb, wstride = words.shape
    dev = words.device
    passes = torch.empty((f_, nb, IPB), dtype=torch.uint8, device=dev)
    wcnt = torch.empty((f_, nb), dtype=torch.int32, device=dev)
    ptrs = _cuda_args(dev, {
        "words": (words, torch.int32, (f_, nb, wstride)),
        **_mod_tables(f_, nb, a, b, act),
        "m": (m, torch.int32, (f_,)),
        "floor_k": (floor_k, torch.int32, (f_,)),
        "flags": (flags, torch.int32, (f_,))})
    if f_ and nb:
        _launch("nbf_k5b_membership",
                [ptrs[0], wstride] + ptrs[1:]
                + [passes.data_ptr(), wcnt.data_ptr(), f_, nb, k_lanes, nw,
                   frames_per_cta(f_, nb)], dev)
        blocked_membership.launches += 1
    return passes, wcnt


def _expand_inputs(passes, wit, raw_mask, flags, vseg, vh):
    f_, nb, _ = passes.shape
    return {"passes": (passes, torch.uint8, (f_, nb, IPB)),
            "wit": (wit, torch.uint8, (f_, nb, WIT_BYTES)),
            "raw_mask": (raw_mask, torch.uint8, (f_, nb, IPB)),
            "flags": (flags, torch.int32, (f_,)),
            "vseg": (vseg, torch.int32, (f_, nb, vh * 32))}


def blocked_expand(passes, wit, raw_mask, flags, vseg, *, vh: int):
    """Witness + value expansion for decode (K4).

    passes: (F,NB,IPB) u8 from :func:`blocked_membership_h`; wit:
    (F,NB,128) u8 witness segments; raw_mask: (F,NB,IPB) u8 masks of
    flagged records; flags: (F,) i32; vseg: (F,NB,vh*32) i32.
    Returns (mask (F,NB,IPB) u8, vals (F,NB,IPB) i32)."""
    if _on_cpu(passes):
        return blocked_expand_ref(passes, wit, raw_mask, flags, vseg, vh=vh)
    f_, nb, _ = passes.shape
    dev = passes.device
    ptrs = _cuda_args(dev, _expand_inputs(passes, wit, raw_mask, flags,
                                          vseg, vh))
    mask = torch.empty((f_, nb, IPB), dtype=torch.uint8, device=dev)
    vals = torch.empty((f_, nb, IPB), dtype=torch.int32, device=dev)
    if f_ and nb:
        _launch("nbf_k4_expand",
                ptrs + [mask.data_ptr(), vals.data_ptr(), f_, nb, vh * 32],
                dev)
        blocked_expand.launches += 1
    return mask, vals


def blocked_expand_chain(passes, wit, raw_mask, flags, vseg, base_packed,
                         *, vh: int):
    """Fused decode stage 2: expansion + frame chaining (K3).

    Same record semantics as :func:`blocked_expand` followed by
    ``frame_f = where(mask_f, vals_f, frame_{f-1})`` from
    ``base_packed`` (NB, IPB) i32.  Returns packed frames (F,NB,IPB) i32."""
    if _on_cpu(passes):
        return blocked_expand_chain_ref(passes, wit, raw_mask, flags, vseg,
                                        base_packed, vh=vh)
    f_, nb, _ = passes.shape
    dev = passes.device
    named = _expand_inputs(passes, wit, raw_mask, flags, vseg, vh)
    named["base_packed"] = (base_packed, torch.int32, (nb, IPB))
    ptrs = _cuda_args(dev, named)
    out = torch.empty((f_, nb, IPB), dtype=torch.int32, device=dev)
    if f_ and nb:
        _launch("nbf_k3_expand_chain",
                ptrs + [out.data_ptr(), f_, nb, vh * 32], dev)
        blocked_expand_chain.launches += 1
    return out


_WRAPPERS = (blocked_encode_h, blocked_membership_h, blocked_expand_chain,
             blocked_expand, blocked_encode, blocked_membership)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Launch count of each kernel wrapper since the last reset."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launches()
