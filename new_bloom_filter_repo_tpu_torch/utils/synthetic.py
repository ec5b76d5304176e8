"""Synthetic test-clip generation.

The reference CLI advertises a ``synthetic`` subcommand but its handler
reads arguments its subparser never defines and calls a generator that
does not exist (improved_video_compressor.py:1626-1643 vs :1778-1784 —
SURVEY.md §2 broken subcommands).  This is the working implementation:
a static textured scene, moving objects, and Gaussian sensor noise of a
chosen level, in BGR / RGB / YUV / grayscale — plus adversarial content
knobs (global pan, zoom, scene cuts) so benchmark conditions exercise
the codec's dense-mask, keyframe-fallback and pass-through branches,
not just its best case.
"""

from __future__ import annotations

import os

import numpy as np


def _zoom_frame(img: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbour zoom about the image centre (scale >= 1)."""
    h, w = img.shape[:2]
    ys = np.clip(((np.arange(h) - h / 2) / scale + h / 2).astype(np.int64),
                 0, h - 1)
    xs = np.clip(((np.arange(w) - w / 2) / scale + w / 2).astype(np.int64),
                 0, w - 1)
    return img[np.ix_(ys, xs)]


def _subpixel_pan(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Bilinear wrap-around translation by a FRACTIONAL shift.

    Real camera pans are not integer pixel rolls: interpolation re-mixes
    every pixel, so no single (dy, dx) reproduces the previous frame
    exactly — the realistic stress case for the global-motion search
    (a roll-based pan is its best case)."""
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
    """Spatially-correlated per-frame grain field (film/sensor grain):
    unlike i.i.d. white noise it carries local structure the entropy
    stage can partially absorb — closer to how real camera footage
    behaves than the pure-random noise knobs."""
    small = rng.normal(0.0, sigma,
                       ((height + cell - 1) // cell,
                        (width + cell - 1) // cell))
    return np.repeat(np.repeat(small, cell, 0), cell, 1)[:height, :width]


def _smooth_texture(rng, height, width, gray, cell: int = 8):
    """Spatially smooth random scene (block texture + mild detail) —
    compressible like real video, unlike white noise which no lossless
    codec (this one, FFV1, or H.264-lossless) can do anything with."""
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
    """Synthetic clip; returns a list of uint8 frames (HxWx3 or HxW).

    The scene is spatially smooth (block texture + mild detail) so the
    entropy stage has something to compress, like real video; ``noise``
    is per-frame Gaussian sensor noise of the given sigma applied to a
    random ``noise_frac`` fraction of pixels (sparse glints by default;
    noise_frac=1.0 = full-frame noise, the adversarial worst case where
    every pixel changes every frame).

    Adversarial knobs:
      pan: global translation in pixels/frame (camera pan — every pixel
        changes, driving mask density toward the keyframe fallback);
      zoom: per-frame zoom rate (scale = 1 + zoom*i — radial motion);
      scene_cut_every: hard cut to a fresh random scene every N frames
        (exercises the encoder's keyframe-fallback branch).

    Realism knobs (VERDICT r2 #10 — make the synthetic table track real
    content more closely):
      pan_mode: "roll" (integer np.roll — the motion search's exact
        model) or "subpixel" (bilinear fractional shift — every pixel
        re-mixed, like a real camera pan);
      grain: sigma of spatially-correlated per-frame film grain applied
        to EVERY pixel (partially compressible, unlike white noise).
    """
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
        # two moving objects, sized to the frame so small test clips
        # keep visible background (a 48x64 object would blanket a 64x48
        # frame entirely, producing identical frames)
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


# The adversarial benchmark suite: content classes spanning the codec's
# branch space, from its best case (static scene, sparse noise) to cases
# designed to defeat inter coding (global motion => dense masks, cuts =>
# keyframe fallbacks, heavy noise => pass-through records).
SUITE = {
    "static_gentle": dict(noise=2.0, noise_frac=0.02, speed=1.0),
    "static_noisy": dict(noise=6.0, noise_frac=0.10, speed=1.0),
    "pan": dict(noise=2.0, noise_frac=0.02, pan=3.0),
    "zoom": dict(noise=2.0, noise_frac=0.02, zoom=0.004),
    "scene_cuts": dict(noise=4.0, noise_frac=0.05, scene_cut_every=12),
    # every pixel renoised every frame: the designed worst case — inter
    # coding is impossible and the entropy stage sees near-random bytes
    "noise_storm": dict(noise=8.0, noise_frac=1.0, speed=2.0),
    # realism additions (VERDICT r2 #10): film-grain texture like real
    # camera footage, and a fractional-shift pan no roll reproduces
    "film_grain": dict(noise=0.0, grain=3.0, speed=1.0),
    "pan_subpixel": dict(noise=2.0, noise_frac=0.02, pan=2.5,
                         pan_mode="subpixel"),
}


def generate_y4m_suite(out_dir: str, width: int = 352, height: int = 288,
                       frame_count: int = 60, seed: int = 0) -> list:
    """Write the adversarial suite as real 4:2:0 Y4M files (CIF geometry
    by default).  Returns the written paths."""
    from new_bloom_filter_repo_tpu_torch.utils.videoio import write_y4m

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, kw in SUITE.items():
        frames = generate_frames(frame_count, width, height, seed=seed,
                                 **kw)
        planes = [(f[:, :, 0], f[::2, ::2, 1], f[::2, ::2, 2])
                  for f in frames]
        path = os.path.join(out_dir, f"synthetic_{name}.y4m")
        write_y4m(path, planes, width, height)
        paths.append(path)
    return paths
