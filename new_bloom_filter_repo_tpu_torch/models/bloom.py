"""Probabilistic data-structure core: standard and rational Bloom filters.

One implementation per concept (the reference carries three copies of the
rational filter and two of the standard one; see SURVEY.md §2 dead-code
notes).  This module provides:

* :class:`StandardBloomFilter` — classic integer-k filter with per-hash
  independent seeds (reference API: rational_bloom_filter.py:9-71).
* :class:`RationalBloomFilter` — non-integer k*: floor(k*) deterministic
  double-hash lanes plus one extra lane activated per-item with probability
  frac(k*) (reference API: rational_bloom_filter.py:74-214 for the
  string-keyed research variant and improved_video_compressor.py:39-138 for
  the integer-index video variant — both surfaces live on the one class
  here, distinguished only by seed configuration).
* the closed-form parameter helpers (optimal m, k, k*).

These host-side classes are the *semantics oracle*: tiny, loopy, and exact.
The data-parallel device path that encodes video lives in
:mod:`new_bloom_filter_repo_tpu_torch.ops.blocked` (the blocked profile).
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np

try:  # the same C extension the reference uses; fall back to our spec impl
    import xxhash as _xxhash

    def _xxh64_str(s: str, seed: int) -> int:
        return _xxhash.xxh64_intdigest(s, seed)

except ImportError:  # pragma: no cover - exercised only without the wheel
    def _xxh64_str(s: str, seed: int) -> int:
        from new_bloom_filter_repo_tpu_torch.utils.native import xxh64
        return xxh64(s.encode("utf-8"), seed)


# Reference seed sets (improved_video_compressor.py:62-63,94 — video/index
# variant; rational_bloom_filter.py:100-101,134 — research/string variant,
# whose activation seed is ceil(k*)).
VIDEO_H1_SEED = 0x12345678
VIDEO_H2_SEED = 0x87654321
VIDEO_ACTIVATION_SEED = 999


class StandardBloomFilter:
    """Classic Bloom filter with an integer number of hash functions.

    Hash i of an item is ``xxh64(str(item), seed=i) mod m`` — k independent
    seeded lanes (reference: rational_bloom_filter.py:25-41).
    """

    def __init__(self, m: int, k: int):
        self.size = int(m)
        self.hash_count = int(k)
        self.bit_array = np.zeros(self.size, dtype=np.uint8)

    def _hash(self, item, seed: int) -> int:
        return _xxh64_str(str(item), seed) % self.size

    def add(self, item) -> None:
        for i in range(self.hash_count):
            self.bit_array[self._hash(item, i)] = 1

    def contains(self, item) -> bool:
        return all(
            self.bit_array[self._hash(item, i)] for i in range(self.hash_count)
        )

    def add_many(self, items: Iterable) -> None:
        for item in items:
            self.add(item)

    @staticmethod
    def get_optimal_size(n: int, p: float) -> int:
        """m = -n ln p / ln^2 2 (reference: rational_bloom_filter.py:43-56)."""
        m = -(n * math.log(p)) / (math.log(2) ** 2)
        return int(math.ceil(m))

    @staticmethod
    def get_optimal_hash_count(m: int, n: int) -> int:
        """k = round((m/n) ln 2), at least 1 (rational_bloom_filter.py:58-71)."""
        k = (m / n) * math.log(2)
        return max(1, int(round(k)))


def activation_probability(k_star: float) -> float:
    """Fractional part of k* — the extra-lane activation probability."""
    return float(k_star) - math.floor(k_star)


def activation_threshold_u64(p_activation: float) -> int:
    """Exact integer threshold T such that the reference's activation test
    ``xxh64(item, act_seed) / (2**64 - 1) < p_activation`` (evaluated in
    float64, reference: improved_video_compressor.py:94-97) is equivalent to
    the pure-integer test ``hash < T``.

    The float64 division by the constant 2**64-1 is weakly monotone in the
    integer hash, so the passing set is exactly an initial segment [0, T);
    T is found by binary search using the same correctly-rounded float64
    arithmetic CPython uses.  This turns a float64 comparison (unavailable
    on TPU lanes) into an exact u64 compare.
    """
    if p_activation <= 0.0:
        return 0
    denom = 2 ** 64 - 1
    if denom / denom < p_activation:
        return 2 ** 64  # every hash activates
    # T is the smallest h with fl(h/denom) >= p.  Under round-to-nearest
    # that is (up to the tie rule) the smallest h with h/denom >= m,
    # where m is the midpoint between p and its predecessor float — an
    # exact dyadic rational, so ceil(m*denom) lands within one step of
    # the answer and the verification walk below runs 0-1 iterations.
    # This replaces a 64-iteration binary search (64 big-int float
    # divisions) that sat on the encoder's per-frame path; the walk
    # uses the same authoritative float64 test, so the result is
    # bit-identical by construction.
    prev = math.nextafter(p_activation, 0.0)
    pn, pd = prev.as_integer_ratio()
    qn, qd = p_activation.as_integer_ratio()
    mn = pn * qd + qn * pd               # m = mn / md, exact
    md = 2 * pd * qd
    h = -((-mn * denom) // md)           # ceil(m * denom)
    while h > 0 and (h - 1) / denom >= p_activation:
        h -= 1
    while h <= denom and h / denom < p_activation:
        h += 1
    return h


class RationalBloomFilter:
    """Rational Bloom filter: floor(k*) deterministic lanes + 1 fractional.

    Double hashing ``(h1 + i*h2) mod m`` with h1/h2 from two fixed seeds;
    the extra lane fires iff ``xxh64(item, act_seed)/(2**64-1) < frac(k*)``
    — the same test at insert and query time, preserving no-false-negatives
    (reference: rational_bloom_filter.py:103-182,
    improved_video_compressor.py:65-138).

    ``seeds`` selects the surface:
      * ``"research"`` — h1=0, h2=1, activation seed ceil(k*) (string keys,
        rational_bloom_filter.py:100-101,134)
      * ``"video"`` — h1=0x12345678, h2=0x87654321, activation 999 (integer
        pixel-index keys, improved_video_compressor.py:62-63,94)
      * ``"compress"`` — h1=0, h2=1, activation 999 (bloom_compress.py
        nested variant, bloom_compress.py:159-196)
    """

    def __init__(self, m: int, k_star: float, seeds: str = "research"):
        self.size = int(m)
        self.k_star = float(k_star)
        self.floor_k = math.floor(self.k_star)
        self.ceil_k = math.ceil(self.k_star)
        self.p_activation = self.k_star - self.floor_k
        self.bit_array = np.zeros(self.size, dtype=np.uint8)
        self.seeds = seeds
        if seeds == "video":
            self.h1_seed, self.h2_seed = VIDEO_H1_SEED, VIDEO_H2_SEED
            self.activation_seed = VIDEO_ACTIVATION_SEED
        elif seeds == "compress":
            self.h1_seed, self.h2_seed = 0, 1
            self.activation_seed = VIDEO_ACTIVATION_SEED
        elif seeds == "research":
            self.h1_seed, self.h2_seed = 0, 1
            self.activation_seed = self.ceil_k
        else:
            raise ValueError(f"unknown seed set: {seeds!r}")
        self._act_threshold = activation_threshold_u64(self.p_activation)

    # -- hashing ----------------------------------------------------------
    def _get_hash_indices(self, item, i: int) -> int:
        h1 = _xxh64_str(str(item), self.h1_seed)
        h2 = _xxh64_str(str(item), self.h2_seed)
        return (h1 + i * h2) % self.size

    def _determine_activation(self, item) -> bool:
        h = _xxh64_str(str(item), self.activation_seed)
        return h < self._act_threshold

    # -- string-keyed research API ----------------------------------------
    def add(self, item) -> None:
        for i in range(self.floor_k):
            self.bit_array[self._get_hash_indices(item, i)] = 1
        if self._determine_activation(item):
            self.bit_array[self._get_hash_indices(item, self.floor_k)] = 1

    def contains(self, item) -> bool:
        for i in range(self.floor_k):
            if not self.bit_array[self._get_hash_indices(item, i)]:
                return False
        if self._determine_activation(item):
            if not self.bit_array[self._get_hash_indices(item, self.floor_k)]:
                return False
        return True

    # -- integer-index video API (improved_video_compressor.py:99-138) ----
    def add_index(self, index: int) -> None:
        self.add(index)

    def check_index(self, index: int) -> bool:
        return self.contains(index)

    # -- parameter math ----------------------------------------------------
    @staticmethod
    def get_optimal_size(n: int, p: float) -> int:
        m = -(n * math.log(p)) / (math.log(2) ** 2)
        return int(math.ceil(m))

    @staticmethod
    def get_optimal_hash_count(m: int, n: int) -> float:
        """k* = (m/n) ln 2, floored at 0.1 (rational_bloom_filter.py:199-214)."""
        k_star = (m / n) * math.log(2)
        return max(0.1, k_star)


# Critical density threshold for the compression codec — the theoretical
# density limit above which Bloom coding cannot help
# (reference: improved_video_compressor.py:150, results.md:15).
P_STAR = 0.32453


def optimal_compression_params(n: int, p: float) -> tuple[float, int]:
    """Optimal (k, l) for lossless Bloom coding of an n-bit string with
    ones-density p: k = log2(q ln^2 2 / p), l = floor(p n k / ln 2)
    (reference: improved_video_compressor.py:161-196).

    Returns (0, 0) when compression cannot help (p ~ 0 or p >= P*).
    """
    if p <= 0.0001:
        return 0, 0
    if p >= P_STAR:
        return 0, 0
    q = 1.0 - p
    L = math.log(2)
    k = math.log2(q * (L ** 2) / p)
    if math.isnan(k) or k <= 0:
        return 0, 0
    l = int(p * n * k * (1.0 / L))
    return max(0.1, k), max(1, l)
