"""Data-parallel rational-Bloom encode/decode cores, as torch ops.

The port of ``new_bloom_filter_repo_tpu.ops.bloom_core``, the cores of
the BFV2 (type-0) records and of the binary codec:

* **insert pass** — every index computes its floor(k)+1 double-hash
  lanes and ORs 1 into the bit array where its input bit (and, for the
  last lane, its activation bit) is set;
* **membership pass** — every index gathers its lanes and ANDs them;
* **witness compaction** — an exclusive prefix sum over the pass mask
  places each passing index's original bit at its in-order witness slot;
* **witness expansion (decode)** — the same prefix sum gathers witness
  bits back to passing indices; failing indices are guaranteed zeros.

The hash tables are full u64 values held as int64 ``(hi, lo)`` halves
(``ops/hashtables.get_hash_tables``).  ``h mod l`` is
``((hi mod l) * (2**32 mod l) + lo mod l) mod l`` in int64, exact since
every factor is below ``MAX_MODULUS`` = 2**28 and so every product below
2**56; the activation test is an unsigned hi/lo compare on the same
halves.  The insert stores ones with ``index_put_``: every write stores
1, so the result is the same whatever order the writes land in, on the
CPU and on CUDA.

The lane-masked variants (``insert_partial_lanes``, ``membership_lanes``,
``witness_compact``, ``witness_expand``) take a single frame (bits
``(n,)``, scalar l/thresholds/floor_k) or a batch (bits ``(B, n)``,
per-frame ``(B,)`` scalars), where the JAX package ``vmap``s them.
Scalars may be Python or numpy integers or integer tensors; u32
thresholds may be int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_MODULUS = 1 << 28   # the mod identity above needs l < 2**28
MAX_LANES = 13  # k = log2(q*ln^2(2)/p) < 12.3 for p > 1e-4 -> floor_k <= 12
_U32 = 0xFFFFFFFF


def bitmap_pad(n: int) -> int:
    """Bit-array allocation covering every achievable l for input n.

    l = floor(p·n·k/ln2) with k(p) = log2((1-p)·ln²2/p) peaks at
    0.31605·n (p ≈ 0.132); pad to 0.3161·n plus slack and round up to a
    multiple of 128.  The JAX package pads to 0.31·n, which is short for
    n above about 40000 at densities near 0.13: its scatter then drops
    bits and its gather clamps, and the record does not decode
    (ROADMAP Queue 3).  The pad never reaches the stream, which stores
    the first l bits.
    """
    return ((int(0.3161 * n) + 136) + 127) // 128 * 128


def _scalar(x, device, u32: bool = False) -> torch.Tensor:
    """An integer scalar or per-frame vector as int64 on ``device``,
    shaped to broadcast against an index axis (``(B,)`` -> ``(B, 1)``).
    ``u32``: reduce mod 2**32 (int32 bit patterns become unsigned)."""
    if torch.is_tensor(x):
        t = x.to(device=device, dtype=torch.int64)
    else:
        t = torch.as_tensor(np.asarray(x).astype(np.int64), device=device)
    if u32:
        t = t & _U32
    return t.unsqueeze(-1) if t.dim() else t


def _mod(h, l):
    """(hi * 2**32 + lo) mod l for a u64 held as int64 halves."""
    hi, lo = h
    return ((hi % l) * ((1 << 32) % l) + lo % l) % l


def _mod_u32(h, l):
    """What the JAX package's ``u64_mod_u32`` computes for any u32 l,
    valid or not: a long division in 4-bit steps whose running remainder
    wraps at 2**32 once l >= 2**28, and x % 0 = 0 (XLA).  Equal to
    :func:`_mod` for 0 < l < MAX_MODULUS, where every stream's l lies;
    a damaged record's l may lie outside."""
    one = torch.where(l == 0, 1, l)
    r = torch.zeros_like(h[0])
    for half in h:
        for j in range(8):
            r = (((r << 4) | ((half >> (28 - 4 * j)) & 0xF)) & _U32) % one
    return torch.where(l == 0, 0, r)


def _outside_modulus(l) -> bool:
    """Whether any l is 0 or at least MAX_MODULUS (a damaged record)."""
    return bool(((l == 0) | (l >= MAX_MODULUS)).any())


def _prelude(h1, h2, act, l, t_hi, t_lo):
    """a = h1 mod l, b = h2 mod l and the activation test act < T, for
    every index (and frame, when the scalars are per-frame)."""
    dev = h1[0].device
    l = _scalar(l, dev)
    thi = _scalar(t_hi, dev, u32=True)
    tlo = _scalar(t_lo, dev, u32=True)
    activated = (act[0] < thi) | ((act[0] == thi) & (act[1] < tlo))
    mod = _mod_u32 if _outside_modulus(l) else _mod
    return mod(h1, l), mod(h2, l), l, activated


def lane_positions_masked(a, b, l, k_max: int):
    """k_max+1 double-hash lane positions ``(a + j*b) mod l``, built by
    conditional subtraction (a, b < l) in u32, as the JAX package builds
    them: the sum wraps at 2**32, which only an l beyond MAX_MODULUS
    (a damaged record) can reach."""
    positions = [a]
    cur = a
    for _ in range(k_max):
        cur = (cur + b) & _U32
        cur = torch.where(cur >= l, cur - l, cur)
        positions.append(cur)
    return positions


def _active(j: int, floor_k, activated):
    """Lane j applies when j < floor_k, or j == floor_k and the index's
    activation bit is set; ``floor_k`` is an int or an int64 tensor."""
    return (floor_k > j) | ((floor_k == j) & activated)


def _set_ones(bit_array: torch.Tensor, pos: torch.Tensor, on: torch.Tensor):
    """bit_array[..., pos] = 1 where ``on``, per leading row."""
    width = bit_array.shape[-1]
    rows = bit_array.numel() // width
    idx = pos + (torch.arange(rows, device=pos.device, dtype=torch.int64)
                 .view(bit_array.shape[:-1] + (1,)) * width)
    bit_array.view(-1).index_put_(
        (idx[on],), torch.ones((), dtype=torch.uint8, device=pos.device))


def _insert(bits, positions, floor_k, activated, l_pad: int):
    on_bits = bits != 0
    bit_array = torch.zeros(bits.shape[:-1] + (l_pad,), dtype=torch.uint8,
                            device=bits.device)
    for j, pos in enumerate(positions):
        _set_ones(bit_array, pos, on_bits & _active(j, floor_k, activated))
    return bit_array


def _gather_index(pos, width: int):
    """The bit the JAX package's gather reads for u32 position ``pos`` in
    a bit array of ``width``: the index clamped to the array, and 0 from
    2**31 on (XLA takes the index as int32).  Only a damaged record's l
    puts a position past the array; on a card an unclamped gather would
    fault."""
    return torch.where(pos >= (1 << 31), 0, pos.clamp(max=width - 1))


def _membership(bit_array, positions, floor_k, activated):
    pass_mask = torch.ones(positions[0].shape, dtype=torch.bool,
                           device=bit_array.device)
    width = bit_array.shape[-1]
    for j, pos in enumerate(positions):
        hit = torch.gather(bit_array, -1, _gather_index(pos, width)) != 0
        pass_mask &= hit | ~_active(j, floor_k, activated)
    return pass_mask


def _exclusive_cumsum(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.int64)
    return torch.cumsum(m, -1) - m


def witness_compact(bits, pass_mask):
    """(witness uint8 (..., n), count int32 (...)): the bits of passing
    indices in ascending index order, zero-padded.  Indices that fail
    land in a drop slot n, which is sliced off."""
    n = bits.shape[-1]
    slot = torch.where(pass_mask, _exclusive_cumsum(pass_mask), n)
    witness = torch.zeros(bits.shape[:-1] + (n + 1,), dtype=torch.uint8,
                          device=bits.device)
    rows = witness.numel() // (n + 1)
    idx = slot + (torch.arange(rows, device=bits.device, dtype=torch.int64)
                  .view(bits.shape[:-1] + (1,)) * (n + 1))
    witness.view(-1).index_put_((idx.reshape(-1),),
                                bits.to(torch.uint8).reshape(-1))
    count = pass_mask.sum(-1, dtype=torch.int32)
    return witness[..., :n], count


def witness_expand(witness, pass_mask):
    """Reconstructed bits uint8 (..., n) from witness + pass mask."""
    widx = _exclusive_cumsum(pass_mask)
    return torch.where(pass_mask, torch.gather(witness, -1, widx),
                       0).to(torch.uint8)


def encode_core(bits, h1, h2, act, l, t_hi, t_lo, *, floor_k: int,
                l_pad: int):
    """Bloom-encode a binary lane of length n.

    Args:
      bits: uint8 (n,) of 0/1 — the flattened binary input.
      h1, h2, act: (hi, lo) int64 (n,) lane tables (ops.hashtables).
      l: actual Bloom filter length (< 2**28, <= l_pad).
      t_hi, t_lo: activation threshold (u64 halves).
      floor_k: floor of the float32-quantized k.
      l_pad: padded bit-array length (bitmap_pad(n)).

    Returns (bit_array uint8 (l_pad,) valid in [0, l), pass_mask bool
    (n,), witness uint8 (n,) valid in [0, witness_len), witness_len
    int32 scalar tensor).
    """
    a, b, l, activated = _prelude(h1, h2, act, l, t_hi, t_lo)
    positions = lane_positions_masked(a, b, l, floor_k)
    bit_array = _insert(bits, positions, floor_k, activated, l_pad)
    pass_mask = _membership(bit_array, positions, floor_k, activated)
    witness, witness_len = witness_compact(bits, pass_mask)
    return bit_array, pass_mask, witness, witness_len


def decode_core(bit_array, witness, h1, h2, act, l, t_hi, t_lo, *,
                floor_k: int):
    """Inverse of :func:`encode_core`: passing indices read the next
    witness bit, failing indices are exact zeros.  Returns uint8 (n,).

    ``floor_k`` comes from the record's k.  Above MAX_LANES it raises
    ValueError: the encoder never writes such a k (floor_k <= 12), and
    the JAX package unrolls floor_k + 1 lanes when it compiles, so a
    damaged k of 2e6 never finishes there (ROADMAP Queue 3).  Below 0 it
    probes lane 0 under the activation test, as the JAX package does."""
    if floor_k > MAX_LANES:
        raise ValueError(f"floor(k) = {floor_k} above {MAX_LANES} lanes: "
                         f"not a record this codec writes")
    floor_k = max(floor_k, 0)
    a, b, l, activated = _prelude(h1, h2, act, l, t_hi, t_lo)
    positions = lane_positions_masked(a, b, l, floor_k)
    pass_mask = _membership(bit_array, positions, floor_k, activated)
    return witness_expand(witness, pass_mask)


def insert_partial_lanes(bits, h1, h2, act, l, t_hi, t_lo, floor_k,
                         k_max: int, l_pad: int):
    """Bit array uint8 (..., l_pad) with a run-time floor_k: lanes are
    computed to ``k_max`` and masked per frame."""
    a, b, l, activated = _prelude(h1, h2, act, l, t_hi, t_lo)
    fk = _scalar(floor_k, bits.device)
    return _insert(bits, lane_positions_masked(a, b, l, k_max), fk,
                   activated, l_pad)


def membership_lanes(bit_array, h1, h2, act, l, t_hi, t_lo, floor_k,
                     k_max: int):
    """Pass mask bool (..., n) with a run-time floor_k."""
    a, b, l, activated = _prelude(h1, h2, act, l, t_hi, t_lo)
    fk = _scalar(floor_k, bit_array.device)
    return _membership(bit_array, lane_positions_masked(a, b, l, k_max), fk,
                       activated)
