"""Color-space conversions with OpenCV-exact integer semantics, as torch ops.

The port of ``new_bloom_filter_repo_tpu.ops.color``: 14-bit fixed point
(round-half-up descale, saturate-cast) over the BT.601 matrix.  The luma
path (gray, Y) is bit-exact against OpenCV's classic shift-14 kernel;
chroma and the inverse agree with cv2 within ±1 at rounding ties.  All
arithmetic is int32 before any ``>>``, which is arithmetic on int32 in
torch as in JAX, so the negative chroma terms round the same way.
"""

from __future__ import annotations

import torch

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)

# Classic OpenCV luma coefficients: gray = descale(B*1868 + G*9617 + R*4899)
_B2Y, _G2Y, _R2Y = 1868, 9617, 4899
# BT.601 analog-YUV chroma rows (cv2 >= 5.0 semantics), quantized to 2^-14:
#   U = -0.14713 R - 0.28886 G + 0.436 B + 128
#   V =  0.615  R - 0.51499 G - 0.10001 B + 128
_R2U, _G2U, _B2U = -2411, -4733, 7143
_R2V, _G2V, _B2V = 10076, -8438, -1639
# Inverse: R = Y + 1.13983 V', G = Y - 0.39465 U' - 0.58060 V',
#          B = Y + 2.03211 U'   with U' = U-128, V' = V-128
_V2R, _U2G, _V2G, _U2B = 18675, -6466, -9512, 33294


def _descale(x):
    return (x + _HALF) >> _SHIFT


def _sat_u8(x):
    return x.clamp(0, 255).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 HxWx3 BGR -> uint8 HxW gray, cv2.COLOR_BGR2GRAY-exact."""
    x = bgr.to(torch.int32)
    y = _descale(x[..., 0] * _B2Y + x[..., 1] * _G2Y + x[..., 2] * _R2Y)
    return y.to(torch.uint8)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.to(torch.int32)
    y = _descale(x[..., 2] * _B2Y + x[..., 1] * _G2Y + x[..., 0] * _R2Y)
    return y.to(torch.uint8)


def bgr_to_rgb(bgr: torch.Tensor) -> torch.Tensor:
    return bgr.flip(-1)


def rgb_to_bgr(rgb: torch.Tensor) -> torch.Tensor:
    return rgb.flip(-1)


def bgr_to_yuv(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 HxWx3 BGR -> uint8 HxWx3 YUV (BT.601; Y cv2-exact, UV ±1)."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = _descale(b * _B2Y + g * _G2Y + r * _R2Y)
    u = _descale(r * _R2U + g * _G2U + b * _B2U + (128 << _SHIFT))
    v = _descale(r * _R2V + g * _G2V + b * _B2V + (128 << _SHIFT))
    return torch.stack([_sat_u8(y), _sat_u8(u), _sat_u8(v)], dim=-1)


def yuv_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """uint8 HxWx3 YUV -> uint8 HxWx3 BGR (BT.601 inverse, cv2 ±1)."""
    x = yuv.to(torch.int32)
    y, up, vp = x[..., 0], x[..., 1] - 128, x[..., 2] - 128
    r = y + _descale(vp * _V2R)
    g = y + _descale(up * _U2G + vp * _V2G)
    b = y + _descale(up * _U2B)
    return torch.stack([_sat_u8(b), _sat_u8(g), _sat_u8(r)], dim=-1)


def gray_to_bgr(gray: torch.Tensor) -> torch.Tensor:
    return gray[..., None].expand(*gray.shape, 3).contiguous()
