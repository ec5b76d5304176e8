#!/usr/bin/env python3
"""Bloom codec vs standard lossless codecs on the Y4M benchmark set.

The port of the root ``benchmark_compression.py``.  Compares:

  * bloom        — the rational-Bloom codec (blocked profile), YUV in
  * bloom-planar — the planar profile: native Y/U/V plane coding
  * keyframe     — the all-zlib-keyframes path (BFVC)
  * ffv1 / huffyuv / h264-lossless — via ffmpeg when available

on .y4m clips, reporting compression ratio, encode and decode seconds and
losslessness per clip and aggregate averages (the table schema of the
reference's results.md:121-151).  The bloom paths run on the current
CUDA card unless given ``--device cpu``; without a card and without it
they raise ``RuntimeError``.

    python -m new_bloom_filter_repo_tpu_torch.tools.benchmark_compression \\
        --video-dir raw_videos/downloads --max-files 5 --max-frames 1000 \\
        --skip-existing
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def _round_trip(comp, path: str, max_frames: int):
    """Extract, compress to a file, decompress: (frames, result, encode
    s, decode s, decoded frames)."""
    frames = comp.extract_frames_from_video(path, max_frames=max_frames,
                                            output_color_space="YUV")
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.bfvc")
        t0 = time.time()
        res = comp.compress_video(frames, out, input_color_space="YUV")
        t_enc = time.time() - t0
        t0 = time.time()
        rec = comp.decompress_video(out)
        t_dec = time.time() - t0
    return frames, res, t_enc, t_dec, rec


def bench_bloom(path: str, max_frames: int, mode: str,
                threads: int = 0, device=None) -> Dict:
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    comp = ImprovedVideoCompressor(verbose=False, mode=mode,
                                   use_direct_yuv=True,
                                   num_threads=threads, device=device)
    frames, res, t_enc, t_dec, rec = _round_trip(comp, path, max_frames)
    v = comp.verify_lossless(frames, rec)
    return {
        "ratio": res["compression_ratio"],
        "encode_s": round(t_enc, 3),
        "decode_s": round(t_dec, 3),
        "frames": len(frames),
        "lossless": bool(v["lossless"]),
    }


def bench_bloom_planar(path: str, max_frames: int,
                       threads: int = 0, device=None) -> Dict:
    """The public planar profile: native Y/U/V plane coding.

    The reference upconverts 4:2:0 to 4:4:4 BGR and measures against the
    *expanded* frame bytes, flattering its ratios.  profile="planar"
    compresses the actual file content — Y, U and V plane sequences
    independently at their true geometry — and compress_video reports
    the ratio against the true raw size.
    """
    import numpy as np
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    comp = ImprovedVideoCompressor(verbose=False, profile="planar",
                                   num_threads=threads, device=device)
    frames, res, t_enc, t_dec, rec = _round_trip(comp, path, max_frames)
    lossless = bool(comp.verify_lossless(frames, rec)["lossless"])
    # plane-exactness too, not just the 444 view
    for f, r in zip(frames, rec):
        for pl in ("y_plane", "u_plane", "v_plane"):
            if not np.array_equal(np.asarray(f.yuv_info[pl]),
                                  np.asarray(r.yuv_info[pl])):
                lossless = False
    return {"ratio": res["compression_ratio"], "encode_s": round(t_enc, 3),
            "decode_s": round(t_dec, 3), "frames": len(frames),
            "lossless": lossless}


def bench_ffmpeg(path: str, max_frames: int, codec_args: List[str],
                 ext: str) -> Optional[Dict]:
    ff = _ffmpeg()
    if not ff:
        return None
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, f"out.{ext}")
        cmd = [ff, "-y", "-loglevel", "error", "-i", path]
        if max_frames:
            cmd += ["-frames:v", str(max_frames)]
        cmd += codec_args + [out]
        t0 = time.time()
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=600)
        except (OSError, subprocess.SubprocessError):
            return None
        t_enc = time.time() - t0
        comp_size = os.path.getsize(out)
    # raw size: parse y4m geometry
    from new_bloom_filter_repo_tpu_torch.utils.videoio import read_y4m
    frames, params = read_y4m(path, max_frames=max_frames)
    raw_size = sum(sum(p.nbytes for p in planes)
                   for planes in params["planes"])
    return {"ratio": comp_size / raw_size, "encode_s": round(t_enc, 3),
            "frames": len(frames)}


CODECS = {
    "ffv1": (["-c:v", "ffv1"], "mkv"),
    "huffyuv": (["-c:v", "huffyuv"], "avi"),
    "h264-lossless": (["-c:v", "libx264", "-qp", "0",
                       "-preset", "medium"], "mkv"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bloom vs standard lossless codecs on Y4M clips")
    ap.add_argument("--video-dir", default="raw_videos/downloads")
    ap.add_argument("--max-files", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=1000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--skip-existing", action="store_true",
                    help="Skip clips already present in the results file")
    ap.add_argument("--results", default="benchmark_results.json")
    ap.add_argument("--codecs", nargs="+",
                    default=["bloom-planar", "bloom", "keyframe", "ffv1",
                             "huffyuv", "h264-lossless"])
    ap.add_argument("--synthetic", action="store_true",
                    help="Generate the adversarial synthetic Y4M suite "
                         "(static/pan/zoom/scene-cuts/noise) into "
                         "--video-dir and benchmark it (offline stand-in "
                         "for the Xiph set)")
    ap.add_argument("--synthetic-frames", type=int, default=60)
    ap.add_argument("--encode-budget-s-per-frame", type=float, default=3.0,
                    help="Per-frame encode wall budget for the bloom "
                         "paths; exceeding it marks the result "
                         "budget_exceeded and prints a warning")
    ap.add_argument("--device", default=None,
                    help="torch device of the bloom paths (default: the "
                         "current CUDA card; 'cpu' runs the kernels' "
                         "plain twins)")
    args = ap.parse_args(argv)

    from new_bloom_filter_repo_tpu_torch.parallel.mesh import default_device
    device = default_device(args.device)

    if args.synthetic:
        from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
            generate_y4m_suite)
        paths = generate_y4m_suite(args.video_dir,
                                   frame_count=args.synthetic_frames)
        print(f"generated {len(paths)} synthetic clips in {args.video_dir}")
        args.max_files = max(args.max_files, len(paths))

    clips = sorted(
        os.path.join(args.video_dir, f)
        for f in os.listdir(args.video_dir) if f.endswith(".y4m")
    )[: args.max_files]
    if not clips:
        print(f"no .y4m clips in {args.video_dir} — run "
              "download_y4m_videos first (use --synthetic offline)")
        return 1

    results = {}
    if args.skip_existing and os.path.exists(args.results):
        with open(args.results) as f:
            results = json.load(f)

    for clip in clips:
        name = os.path.basename(clip)
        results.setdefault(name, {})
        for codec in args.codecs:
            if args.skip_existing and codec in results[name]:
                continue
            print(f"{name} / {codec} ...", flush=True)
            if codec == "bloom-planar":
                r = bench_bloom_planar(clip, args.max_frames,
                                       threads=args.threads, device=device)
            elif codec in ("bloom", "keyframe"):
                r = bench_bloom(clip, args.max_frames, codec,
                                threads=args.threads, device=device)
            elif codec in CODECS:
                spec, ext = CODECS[codec]
                r = bench_ffmpeg(clip, args.max_frames, spec, ext)
                if r is None:
                    print(f"  {codec}: ffmpeg unavailable/failed, skipped")
                    continue
            else:
                continue
            if (codec.startswith("bloom") or codec == "keyframe") and \
                    r["frames"]:
                budget = args.encode_budget_s_per_frame * r["frames"]
                if r["encode_s"] > budget:
                    r["budget_exceeded"] = True
                    print(f"  WARNING: encode took {r['encode_s']}s "
                          f"(> budget {budget:.0f}s) — likely a "
                          f"regression", flush=True)
            results[name][codec] = r
            print(f"  ratio={r['ratio']:.4f} encode={r['encode_s']}s")
        with open(args.results, "w") as f:
            json.dump(results, f, indent=2)

    # aggregate table (results.md:121-151 schema)
    print("\n=== Averages (Y4M set) ===")
    print(f"{'codec':16s} {'ratio':>8s} {'savings':>9s} {'enc s':>8s}")
    for codec in args.codecs:
        rows = [results[c][codec] for c in results
                if codec in results[c]]
        if not rows:
            continue
        ratio = sum(r["ratio"] for r in rows) / len(rows)
        enc = sum(r["encode_s"] for r in rows) / len(rows)
        print(f"{codec:16s} {ratio:8.4f} {100*(1-ratio):8.2f}% {enc:8.2f}")
    print(f"\nresults written to {args.results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
