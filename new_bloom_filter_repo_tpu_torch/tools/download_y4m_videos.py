#!/usr/bin/env python3
"""Fetch the Y4M benchmark clips.

The port of the root ``download_y4m_videos.py``, over the port's
``utils/videoio``.  Downloads the 8 Xiph.org CIF clips the reference's
published numbers use into raw_videos/downloads/.  In offline
environments, --synthetic writes locally generated clips with the same
names instead, so the benchmark harness always has inputs.  Host code
only: it needs no card.

    python -m new_bloom_filter_repo_tpu_torch.tools.download_y4m_videos [--synthetic]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CLIPS = [
    "akiyo_cif", "bowing_cif", "bus_cif", "coastguard_cif",
    "container_cif", "football_422_cif", "foreman_cif", "hall_cif",
]
BASE_URL = "https://media.xiph.org/video/derf/y4m/"
DEFAULT_DIR = os.path.join("raw_videos", "downloads")


def synth_clip(path: str, frames: int = 60, w: int = 352, h: int = 288,
               seed: int = 0) -> None:
    import numpy as np
    from new_bloom_filter_repo_tpu_torch.utils import videoio

    rng = np.random.default_rng(seed)
    y0 = rng.integers(16, 235, (h, w), dtype=np.uint8)
    u0 = rng.integers(64, 192, (h // 2, w // 2), dtype=np.uint8)
    v0 = rng.integers(64, 192, (h // 2, w // 2), dtype=np.uint8)
    planes = []
    for i in range(frames):
        y = y0.copy()
        noise_at = rng.random(y.shape) < 0.02   # sparse sensor noise
        y[noise_at] = np.clip(
            y[noise_at].astype(np.int16)
            + rng.integers(-6, 7, int(noise_at.sum())), 16, 235
        ).astype(np.uint8)
        x = (10 + 5 * i) % (w - 90)
        y[60:140, x:x + 80] = 210
        planes.append((y, u0.copy(), v0.copy()))
    videoio.write_y4m(path, planes, w, h, "420jpeg")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fetch Y4M benchmark clips")
    ap.add_argument("--output-dir", default=DEFAULT_DIR)
    ap.add_argument("--max-files", type=int, default=len(CLIPS))
    ap.add_argument("--synthetic", action="store_true",
                    help="Generate local stand-in clips (offline mode)")
    ap.add_argument("--frames", type=int, default=60,
                    help="Frames per synthetic clip")
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    clips = CLIPS[: args.max_files]
    # Attempt log: records every real-download try (success/failure +
    # reason) so synthetic stand-ins are visible, and the real clips can
    # be fetched once the network is there — clips marked "synthetic"
    # are re-attempted on the next non --synthetic run (the stand-in is
    # replaced in place).
    log_path = os.path.join(args.output_dir, "download_attempts.json")
    attempts = {}
    if os.path.exists(log_path):
        with open(log_path) as fh:
            attempts = json.load(fh)
    for i, name in enumerate(clips):
        path = os.path.join(args.output_dir, f"{name}.y4m")
        prior = attempts.get(name, {})
        if os.path.exists(path) and not prior:
            # predates the attempt log: assume it is a real clip (the
            # log tracks every synthetic stand-in this script writes) —
            # never re-download or overwrite it
            attempts[name] = {"status": "real", "note": "preexisting",
                              "time": time.strftime("%Y-%m-%d %H:%M:%S")}
            prior = attempts[name]
        if os.path.exists(path) and (args.synthetic
                                     or prior.get("status") == "real"):
            print(f"exists: {path}")
            continue
        if args.synthetic:
            print(f"generating synthetic stand-in: {path}")
            synth_clip(path, frames=args.frames, seed=i)
            attempts[name] = {"status": "synthetic",
                              "time": time.strftime("%Y-%m-%d %H:%M:%S")}
            continue
        url = BASE_URL + f"{name}.y4m"
        print(f"downloading {url} ...")
        try:
            import urllib.request
            urllib.request.urlretrieve(url, path + ".part")
            os.replace(path + ".part", path)
            attempts[name] = {"status": "real", "url": url,
                              "time": time.strftime("%Y-%m-%d %H:%M:%S")}
        except Exception as exc:
            print(f"  download failed ({exc}); falling back to synthetic")
            attempts[name] = {"status": "synthetic", "url": url,
                              "error": f"{type(exc).__name__}: {exc}",
                              "time": time.strftime("%Y-%m-%d %H:%M:%S")}
            if not os.path.exists(path):
                synth_clip(path, frames=args.frames, seed=i)
    with open(log_path, "w") as fh:
        json.dump(attempts, fh, indent=1)
    real = sum(1 for a in attempts.values() if a.get("status") == "real")
    print(f"done: {len(clips)} clips in {args.output_dir} "
          f"({real} real, attempt log: {log_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
