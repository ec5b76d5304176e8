"""The lossless binary-string Bloom codec (bitmap + witness).

The PyTorch port of ``new_bloom_filter_repo_tpu.models.binary_codec``.
Encode: measure the ones-density p; if p >= P* = 0.32453 pass the input
through unchanged; otherwise build a rational Bloom filter over the
set-bit indices and emit (bitmap, witness), where the witness holds the
original bit of every index that passes the membership test, in
ascending index order.  Decode re-runs membership per index: pass ->
next witness bit, fail -> guaranteed 0.

The per-index passes run as the torch ops of ``ops/bloom_core.py`` on
the codec's ``device``; this layer owns the scalar parameter math (host
float64) and the density pass-through rules.  :func:`_filter_scalars`
quantizes k to float32 *before* the filter is built, because the
bitstream stores float32 k and the decoder rebuilds the filter from
that value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.models.bloom import (
    P_STAR,
    activation_threshold_u64,
    optimal_compression_params,
)
from new_bloom_filter_repo_tpu_torch.ops import bloom_core
from new_bloom_filter_repo_tpu_torch.ops.hashtables import get_hash_tables
from new_bloom_filter_repo_tpu_torch.parallel.mesh import default_device


def _filter_scalars(k: float):
    """Host-side scalar prep: float32-quantized k -> (k32, floor_k, T)."""
    k32 = float(np.float32(k))
    floor_k = math.floor(k32)
    p_act = k32 - floor_k
    t = activation_threshold_u64(p_act)
    t = min(t, (1 << 64) - 1)  # p_act < 1 always, but clamp defensively
    return k32, floor_k, (np.uint32(t >> 32), np.uint32(t & 0xFFFFFFFF))


class BloomFilterCompressor:
    """Lossless Bloom-filter compression of binary arrays.

    ``seed_set`` picks the hash surface: ``"video"`` for the .bfvc frame
    codec, ``"compress"`` for the standalone image/text codec.
    ``device`` holds the hash tables and runs the encode and decode
    passes (default: the current CUDA card; without a card, pass
    ``device="cpu"``, or the constructor raises)."""

    P_STAR = P_STAR

    def __init__(self, verbose: bool = False, seed_set: str = "video",
                 device=None):
        self.verbose = verbose
        self.seed_set = seed_set
        self.device = default_device(device)

    def _calculate_optimal_params(self, n: int, p: float):
        return optimal_compression_params(n, p)

    def compress(self, binary_input):
        """Compress a 1D binary (0/1) array.

        Returns (bloom_bitmap, witness, density, input_length, ratio)
        with the reference's pass-through rules; bitmap and witness are
        uint8 numpy arrays."""
        binary_input = np.asarray(binary_input, dtype=np.uint8).ravel()
        n = int(binary_input.shape[0])
        ones = int(binary_input.sum())
        p = ones / n

        if p >= self.P_STAR:
            if self.verbose:
                print(f"Density {p:.4f} >= threshold {self.P_STAR}, "
                      "compression not effective")
            return binary_input, np.zeros(0, dtype=np.uint8), p, n, 1.0

        k, l = self._calculate_optimal_params(n, p)
        if l == 0 or l >= n:
            return binary_input, np.zeros(0, dtype=np.uint8), p, n, 1.0
        if l >= bloom_core.MAX_MODULUS:
            raise ValueError(f"filter length {l} exceeds supported maximum")

        _, floor_k, (t_hi, t_lo) = _filter_scalars(k)
        tables = get_hash_tables(n, self.seed_set, self.device)
        bit_array, _, witness, wlen = bloom_core.encode_core(
            torch.from_numpy(binary_input).to(self.device),
            tables.h1, tables.h2, tables.act, l, t_hi, t_lo,
            floor_k=floor_k, l_pad=bloom_core.bitmap_pad(n))
        wlen = int(wlen)
        bitmap = bit_array[:l].cpu().numpy()
        witness = witness[:wlen].cpu().numpy()

        ratio = (l + wlen) / n
        if self.verbose:
            print(f"Input length: {n}, Density: {p:.4f}")
            print(f"Optimal parameters: k={k:.4f}, l={l}")
            print(f"Bloom filter size: {l} bits")
            print(f"Witness size: {wlen} bits")
            print(f"Compression ratio: {ratio:.4f}")
        return bitmap, witness, p, n, ratio

    def decompress(self, bloom_bitmap, witness, n: int, k: float):
        """Inverse of :meth:`compress` from recorded values.

        ``k`` is the float32 value stored in the record; an empty witness
        means the bitmap *is* the original data (pass-through)."""
        if len(witness) == 0:
            return np.asarray(bloom_bitmap, dtype=np.uint8)

        bloom_bitmap = np.asarray(bloom_bitmap, dtype=np.uint8).ravel()
        l = int(bloom_bitmap.shape[0])
        n = int(n)
        _, floor_k, (t_hi, t_lo) = _filter_scalars(float(k))
        tables = get_hash_tables(n, self.seed_set, self.device)
        l_pad = bloom_core.bitmap_pad(n)
        if l > l_pad:  # foreign stream with an oversized filter: still valid
            l_pad = ((l + 127) // 128) * 128
        padded = np.zeros(l_pad, dtype=np.uint8)
        padded[:l] = bloom_bitmap
        wpad = np.zeros(n, dtype=np.uint8)
        w = np.asarray(witness, dtype=np.uint8).ravel()
        wpad[: w.shape[0]] = w

        out = bloom_core.decode_core(
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(wpad).to(self.device),
            tables.h1, tables.h2, tables.act, l, t_hi, t_lo,
            floor_k=floor_k)
        return out.cpu().numpy()
