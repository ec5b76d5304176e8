"""Bit packing and unpacking on uint8 tensors, in np.packbits order.

The port of ``new_bloom_filter_repo_tpu.ops.bitpack``.  The .bfvc
records store bitmaps and witnesses as np.packbits bytes (the first
element lands in the most significant bit); packing on the device
shrinks the pulls to the host eightfold.
"""

from __future__ import annotations

import torch


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8 0/1 tensor (..., n) with n % 8 == 0 -> packed uint8
    (..., n/8), np.packbits bit order."""
    *lead, n = bits.shape
    if n % 8:
        raise ValueError("pack_bits needs a multiple of 8")
    b = bits.reshape(*lead, n // 8, 8).to(torch.uint8)
    out = b[..., 0] << 7
    for i in range(1, 8):
        out |= b[..., i] << (7 - i)
    return out


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed uint8 (..., m) -> 0/1 uint8 (..., n) with n <= 8*m."""
    *lead, m = packed.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*lead, 8 * m)[..., :n]


def padded_length(n: int, multiple: int = 8) -> int:
    return ((n + multiple - 1) // multiple) * multiple
