"""Inter-frame difference extraction and application.

The port of ``new_bloom_filter_repo_tpu.ops.diff``.  The binary change
mask is a torch op on the frames' device; the changed-value gather and
scatter stay numpy on the host (the values feed the host zlib stage).

Exact mode's mask is ``any channel differs``, which makes reconstruction
bit-exact for color frames; with a positive threshold the mask follows
the reference's gray/Y semantics, which tolerate noise by design.
"""

from __future__ import annotations

import numpy as np
import torch

from new_bloom_filter_repo_tpu_torch.ops.color import bgr_to_gray


def diff_mask_thresholded(prev, curr, threshold,
                          use_direct_yuv: bool = False) -> torch.Tensor:
    """Reference-style mask: |gray/Y(prev) - gray/Y(curr)| > threshold.

    prev/curr: uint8 HxW or HxWxC tensors; threshold: a float, compared
    in float32 as the JAX package's traced threshold is.  Returns a
    uint8 HxW mask."""
    if prev.dim() == 3 and prev.shape[2] > 1:
        if use_direct_yuv and prev.shape[2] >= 3:
            pg, cg = prev[:, :, 0], curr[:, :, 0]
        else:
            pg, cg = bgr_to_gray(prev), bgr_to_gray(curr)
    else:
        pg, cg = prev, curr
    d = (pg.to(torch.int16) - cg.to(torch.int16)).abs()
    thr = torch.tensor(float(threshold), dtype=torch.float32,
                       device=d.device)
    return (d.to(torch.float32) > thr).to(torch.uint8)


def diff_mask_exact(prev, curr) -> torch.Tensor:
    """Exact mask: 1 where any channel differs — the bit-exact mode."""
    neq = prev != curr
    if neq.dim() == 3:
        neq = neq.any(-1)
    return neq.to(torch.uint8)


def _planes_full_res(yuv_info: dict, shape) -> bool:
    """Plane-indexed reads/writes are only valid when the planes are at
    frame resolution (444 wrappers); native subsampled planes use the
    array channels."""
    for plane in ("y_plane", "u_plane", "v_plane"):
        arr = yuv_info.get(plane)
        if arr is None or np.asarray(arr).shape != tuple(shape):
            return False
    return True


def gather_changed_values(curr: np.ndarray, mask: np.ndarray,
                          yuv_info: dict | None = None) -> np.ndarray:
    """Exact values of changed pixels, all channels interleaved per
    pixel.  For YUV frames with full-resolution plane info, values are
    read from the original planes so reconstruction is plane-exact."""
    mask = np.asarray(mask, dtype=bool)
    curr = np.asarray(curr)
    if curr.ndim == 3 and curr.shape[2] > 1:
        if yuv_info is not None and _planes_full_res(yuv_info, mask.shape):
            rows, cols = np.nonzero(mask)
            vals = np.empty((rows.size, 3), dtype=np.uint8)
            vals[:, 0] = yuv_info["y_plane"][rows, cols]
            vals[:, 1] = yuv_info["u_plane"][rows, cols]
            vals[:, 2] = yuv_info["v_plane"][rows, cols]
            return vals.reshape(-1)
        return curr[mask].reshape(-1)
    return curr[mask].copy()


def apply_diff(base: np.ndarray, mask: np.ndarray, values: np.ndarray,
               yuv_info: dict | None = None) -> np.ndarray:
    """Scatter exact changed values onto a copy of the base frame."""
    out = np.asarray(base).copy()
    mask = np.asarray(mask, dtype=bool)
    if out.ndim == 3 and out.shape[2] > 1:
        c = out.shape[2]
        vals = np.asarray(values, dtype=out.dtype).reshape(-1, c)
        out[mask] = vals
        if yuv_info is not None and _planes_full_res(yuv_info, mask.shape):
            rows, cols = np.nonzero(mask)
            yuv_info["y_plane"][rows, cols] = vals[:, 0]
            yuv_info["u_plane"][rows, cols] = vals[:, 1]
            yuv_info["v_plane"][rows, cols] = vals[:, 2]
    else:
        out[mask] = np.asarray(values, dtype=out.dtype)
    return out
