"""Host scalar prep for the rational-Bloom filters.

The PyTorch port's counterpart of
``new_bloom_filter_repo_tpu.models.binary_codec``, reduced to what the
blocked video profile needs: :func:`_filter_scalars`, the float64 host
math that turns a frame's k into the float32-quantized k, floor(k) and
the u64 activation threshold every filter kernel reads.  k is quantized
to float32 *before* the filter is built, because the bitstream stores
float32 k and the decoder rebuilds the filter from that value.

The binary-string codec ``BloomFilterCompressor`` is not ported yet
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import math

import numpy as np

from new_bloom_filter_repo_tpu_torch.models.bloom import activation_threshold_u64


def _filter_scalars(k: float):
    """Host-side scalar prep: float32-quantized k -> (k32, floor_k, T)."""
    k32 = float(np.float32(k))
    floor_k = math.floor(k32)
    p_act = k32 - floor_k
    t = activation_threshold_u64(p_act)
    t = min(t, (1 << 64) - 1)  # p_act < 1 always, but clamp defensively
    return k32, floor_k, (np.uint32(t >> 32), np.uint32(t & 0xFFFFFFFF))
