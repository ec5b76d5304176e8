"""The benchmark's traffic generator: a frozen copy of the port's
synthetic clip generator (``utils/synthetic.generate_frames``).

The copy lives here so that a change to the program cannot change the
benchmark's inputs.  ``tests/test_portbench_generator.py`` holds it to
the port's generator byte for byte.  One difference is deliberate and
invisible in the bytes: the sparse sensor noise (``0 < noise_frac <
1``, no grain) is added to the masked pixels only, found once by their
flat indices, instead of to a float copy of the whole frame, because a
whole float frame costs most of the time of a 1080p clip and the
rounding of an untouched uint8 pixel gives it back unchanged; noise on
every pixel is added in place to the draw.

A traffic file (``traffic/<name>.json``) names the keyword arguments;
the configuration gives the geometry and the colour space.  A
configuration of ``"layout": "I420"`` takes the same frames through
``to_i420``, the benchmark's own conversion to 4:2:0 planes, so that a
mix gives the same scene in either layout.
"""

from __future__ import annotations

import numpy as np


def _zoom_frame(img: np.ndarray, scale: float) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.clip(((np.arange(h) - h / 2) / scale + h / 2).astype(np.int64),
                 0, h - 1)
    xs = np.clip(((np.arange(w) - w / 2) / scale + w / 2).astype(np.int64),
                 0, w - 1)
    return img[np.ix_(ys, xs)]


def _subpixel_pan(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    y0, fy = int(np.floor(dy)), dy - np.floor(dy)
    x0, fx = int(np.floor(dx)), dx - np.floor(dx)
    a = np.roll(img, (y0, x0), (0, 1)).astype(np.float32)
    b = np.roll(img, (y0 + 1, x0), (0, 1)).astype(np.float32)
    c = np.roll(img, (y0, x0 + 1), (0, 1)).astype(np.float32)
    d = np.roll(img, (y0 + 1, x0 + 1), (0, 1)).astype(np.float32)
    out = (a * (1 - fy) * (1 - fx) + b * fy * (1 - fx)
           + c * (1 - fy) * fx + d * fy * fx)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _film_grain(rng, height, width, sigma: float, cell: int = 2):
    small = rng.normal(0.0, sigma,
                       ((height + cell - 1) // cell,
                        (width + cell - 1) // cell))
    return np.repeat(np.repeat(small, cell, 0), cell, 1)[:height, :width]


def _smooth_texture(rng, height, width, gray, cell: int = 8):
    shape = (height, width) if gray else (height, width, 3)
    small_shape = ((height + cell - 1) // cell, (width + cell - 1) // cell
                   ) + (() if gray else (3,))
    small = rng.integers(20, 200, size=small_shape).astype(np.int16)
    up = np.repeat(np.repeat(small, cell, axis=0), cell, axis=1
                   )[:height, :width]
    up = up + rng.integers(-5, 6, size=shape).astype(np.int16)
    return np.clip(up, 0, 255).astype(np.uint8)


def generate_frames(frame_count: int = 90, width: int = 640,
                    height: int = 480, noise: float = 1.0,
                    speed: float = 1.0, color_space: str = "BGR",
                    seed: int = 0, pan: float = 0.0, zoom: float = 0.0,
                    scene_cut_every: int = 0, noise_frac: float = 0.02,
                    pan_mode: str = "roll", grain: float = 0.0):
    """A list of ``frame_count`` uint8 frames (HxWx3, or HxW for gray):
    a smooth textured scene, optionally panned, zoomed or cut, Gaussian
    sensor noise of sigma ``noise`` on a ``noise_frac`` share of the
    pixels, film grain of sigma ``grain``, and two moving objects."""
    rng = np.random.default_rng(seed)
    gray = color_space.upper() in ("GRAY", "GREY", "MONO")
    shape = (height, width) if gray else (height, width, 3)
    base = _smooth_texture(rng, height, width, gray)

    frames = []
    for i in range(frame_count):
        if scene_cut_every and i and i % scene_cut_every == 0:
            base = _smooth_texture(rng, height, width, gray)
        scene = base
        if pan and pan_mode == "subpixel":
            scene = _subpixel_pan(scene, pan * i / 2.0, pan * i)
        elif pan:
            dx = int(round(pan * i))
            dy = int(round(pan * i / 2))
            scene = np.roll(np.roll(scene, dy, axis=0), dx, axis=1)
        if zoom:
            scene = _zoom_frame(scene, 1.0 + zoom * i)
        if grain <= 0 and noise > 0 and 0 < noise_frac < 1.0:
            idx = np.flatnonzero(rng.random((height, width)) < noise_frac)
            nshape = (idx.size,) if gray else (idx.size, 3)
            frame = scene.copy()
            flat = frame.reshape(height * width, -1)[:, 0] if gray \
                else frame.reshape(height * width, 3)
            vals = (flat[idx].astype(np.float32)
                    + rng.normal(0.0, noise, size=nshape)).astype(np.float32)
            flat[idx] = np.clip(np.round(vals), 0, 255).astype(np.uint8)
        elif grain <= 0 and noise > 0 and noise_frac >= 1.0:
            f = rng.normal(0.0, noise, size=shape)
            f += scene
            np.round(f, out=f)
            np.clip(f, 0, 255, out=f)
            frame = f.astype(np.uint8)
        else:
            f = scene.astype(np.float32)
            if grain > 0:
                g = _film_grain(rng, height, width, grain)
                f = f + (g if gray else g[:, :, None])
            if noise > 0 and noise_frac > 0:
                if noise_frac >= 1.0:
                    f = f + rng.normal(0.0, noise, size=shape)
                else:
                    m = rng.random((height, width)) < noise_frac
                    cnt = int(m.sum())
                    nshape = (cnt,) if gray else (cnt, 3)
                    f[m] = f[m] + rng.normal(0.0, noise, size=nshape)
            frame = np.clip(np.round(f), 0, 255).astype(np.uint8)
        oh = max(4, min(48, height // 5))
        ow = max(4, min(64, width // 5))
        h2 = max(3, min(40, height // 6))
        w2 = max(3, min(40, width // 6))
        x = int(20 + speed * 6 * i) % max(1, width - ow)
        y = int(14 + speed * 3 * i) % max(1, height - oh)
        if gray:
            frame[y:y + oh, x:x + ow] = 235
            frame[(height - y - h2):(height - y), x // 2:x // 2 + w2] = 16
        else:
            frame[y:y + oh, x:x + ow] = (30, 200, 240)
            frame[(height - y - h2):(height - y),
                  x // 2:x // 2 + w2] = (220, 60, 40)
        frames.append(frame)
    return frames


# BT.709 with studio range, in 16 fractional bits: each row is
# round(K * 2**16) of the matrix that takes 8-bit R, G, B (0-255) to
# Y' = 16 + 219 (Kr R + Kg G + Kb B) / 255 and Cb, Cr = 128 + 224 (B - Y,
# R - Y) / (2 (1 - Kb), 2 (1 - Kr)) / 255, with Kr = 0.2126, Kb = 0.0722;
# each chroma row's middle entry is set so that the row sums to 0 (grey
# stays at 128).  Columns are R, G, B.
_BT709 = np.array([[11966, 40254, 4064],
                   [-6596, -22188, 28784],
                   [28784, -26145, -2639]], dtype=np.int32)


def to_i420(frame: np.ndarray):
    """The I420 planes ``(y, u, v)`` of one HxWx3 uint8 BGR frame, H and
    W even: ``y`` is HxW, ``u`` (Cb) and ``v`` (Cr) are (H/2)x(W/2),
    all uint8.

    Matrix: ITU-R BT.709, studio range (Y 16-235, Cb and Cr 16-240), the
    matrix of HD masters, in integer fixed point with 16 fractional bits
    (``_BT709``):

        Y  =  16 + ( 11966 R + 40254 G +  4064 B + 2**15) >> 16
        Cb = 128 + ( -6596 R - 22188 G + 28784 B + 2**15) >> 16
        Cr = 128 + ( 28784 R - 26145 G -  2639 B + 2**15) >> 16

    where ``>>`` floors, so each value is rounded half up.

    Chroma filter: a box.  Cb and Cr of a 2x2 block of pixels are the
    mean of the four pixels' unrounded Cb and Cr, rounded half up once:
    the rows above applied to the block's summed R, G and B, plus 2**17,
    shifted right by 18.  These are stated choices, not ffmpeg's (its
    default chroma downscaler is no box filter).
    """
    f = np.asarray(frame)
    if f.ndim != 3 or f.shape[2] != 3 or f.dtype != np.uint8:
        raise ValueError(f"to_i420 takes HxWx3 uint8 BGR, got {f.shape} "
                         f"{f.dtype}")
    h, w = f.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs an even width and height, got {w}x{h}")
    # Float products and sums of these integers are exact: every partial
    # sum of Y stays under 2**24 (float32's integers), the chroma's under
    # 2**53.
    y = (f.reshape(-1, 3).astype(np.float32)
         @ _BT709[0, ::-1].astype(np.float32)).astype(np.int32)
    y += (16 << 16) + (1 << 15)
    y >>= 16
    # Each 2x2 block: its two rows summed, then its two pixels' B, G, R
    # (one row of 6) through the chroma rows twice, which sums them.
    rows = f[0::2].astype(np.int16) + f[1::2]
    kc = _BT709[1:, ::-1].T.astype(np.float64)
    c = (rows.reshape(-1, 6).astype(np.float64)
         @ np.vstack([kc, kc])).astype(np.int64)
    c += (128 << 18) + (1 << 17)
    c >>= 18
    planes = (y.reshape(h, w), c[:, 0].reshape(h // 2, w // 2),
              c[:, 1].reshape(h // 2, w // 2))
    return tuple(p.astype(np.uint8) for p in planes)
