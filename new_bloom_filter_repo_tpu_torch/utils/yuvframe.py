"""The single YUV frame wrapper.

The reference defines this wrapper four separate times
(fixed_video_compressor.py:118,289; improved_video_compressor.py:1165;
verify_true_lossless.py:169) — one implementation lives here.  It carries
an HxWx3 array plus exact copies of the Y/U/V planes so direct-YUV
pipelines reconstruct plane-exactly.
"""

from __future__ import annotations

import numpy as np


class YUVFrame:
    """ndarray-like wrapper with a ``yuv_info`` plane dict."""

    def __init__(self, data: np.ndarray, yuv_info: dict | None = None):
        self.data = np.asarray(data)
        if yuv_info is None:
            yuv_info = {
                "format": "YUV444",
                "y_plane": self.data[:, :, 0].copy(),
                "u_plane": self.data[:, :, 1].copy(),
                "v_plane": self.data[:, :, 2].copy(),
            }
        self.yuv_info = yuv_info

    # ndarray-compatible surface (reference: fixed_video_compressor.py:287-334)
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self):
        return self.data.nbytes

    @property
    def size(self):
        return self.data.size

    @property
    def T(self):
        return self.data.T

    def __array__(self, dtype=None, copy=None):
        if dtype is not None:
            return self.data.astype(dtype)
        return self.data

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def copy(self):
        return YUVFrame(
            self.data.copy(),
            {k: (v.copy() if hasattr(v, "copy") else v)
             for k, v in self.yuv_info.items()},
        )

    def tobytes(self):
        return self.data.tobytes()

    def astype(self, dtype):
        return self.data.astype(dtype)

    def flatten(self):
        return self.data.flatten()

    def reshape(self, *args, **kwargs):
        return self.data.reshape(*args, **kwargs)


def unwrap(frame):
    """Underlying ndarray of a frame that may be a YUVFrame.

    Note: a plain ``hasattr(frame, "data")`` test (as the reference uses,
    fixed_video_compressor.py:237-245) is wrong — every ndarray exposes a
    ``.data`` memoryview — so wrapper detection keys on ``yuv_info``.
    """
    if isinstance(frame, np.ndarray):
        return frame
    if hasattr(frame, "yuv_info") and hasattr(frame, "data"):
        return np.asarray(frame.data)
    return np.asarray(frame)


def yuv_info_of(frame):
    return getattr(frame, "yuv_info", None)
