"""Median filtering and noise estimation, as torch ops.

The port of ``new_bloom_filter_repo_tpu.ops.median``.  The noise of a
frame is the standard deviation of its residual against a 5x5 median
blur, and the adaptive diff threshold of the near-lossless mode derives
from it.  The median is a rank filter: the k*k edge-padded windows are
stacked on a leading axis, sorted, and the middle one taken.

:func:`noise_level` is the population standard deviation in float32 as
the JAX package computes it (mean, centred squares, their mean, square
root), except that the two sums accumulate in float64 and round once to
float32.  XLA's float32 sum order cannot be reproduced; a float64 sum
gives the same float32 value on the CPU and on CUDA, and differs from
the JAX package's by at most the rounding of XLA's float32 sum.
"""

from __future__ import annotations

import torch


def _edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate-pad the two leading (spatial) axes by r."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    return img[rows][:, cols]


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """k x k median filter with replicated borders (cv2.medianBlur parity).

    img: HxW (or HxWxC, filtered per channel) tensor."""
    if ksize % 2 != 1:
        raise ValueError("ksize must be odd")
    r = ksize // 2
    padded = _edge_pad(img, r)
    h, w = img.shape[0], img.shape[1]
    windows = torch.stack([padded[dy:dy + h, dx:dx + w]
                           for dy in range(ksize) for dx in range(ksize)])
    return windows.sort(dim=0).values[(ksize * ksize) // 2]


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.float64).to(torch.float32)


def noise_level(frame: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Noise sigma = population std(frame - median_blur(frame)), a
    float32 scalar tensor."""
    smoothed = median_blur(frame, ksize)
    residual = frame.to(torch.float32) - smoothed.to(torch.float32)
    n = torch.tensor(residual.numel(), dtype=torch.float32,
                     device=frame.device)
    mean = _sum_f32(residual) / n
    centered = residual - mean
    return torch.sqrt(_sum_f32(centered * centered) / n)


def adaptive_threshold(frame, noise_tolerance: float, min_threshold: float,
                       max_threshold: float) -> float:
    """clamp(sigma * tolerance, min, max), a host float."""
    sigma = float(noise_level(frame))
    return max(min_threshold, min(max_threshold, sigma * noise_tolerance))
