"""Bit-exact end-to-end verification harness.

The port of ``new_bloom_filter_repo_tpu.verify_harness`` (runs on the
current CUDA card unless ``device``/``--device`` names another device):
per-color-space compress/decompress
round trips with zero-tolerance settings, a single-frame smoke test
first, the standard verify_lossless *plus* an independent byte-level
comparator with per-pixel diff forensics, diagnostic image dumps on
failure, and FPS reporting in both directions.

    python -m new_bloom_filter_repo_tpu_torch.verify_harness video.y4m \
        --color-spaces BGR RGB YUV --output-dir /tmp/verify
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List

import numpy as np

from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
    add_yuv_info_to_frame,
)
from new_bloom_filter_repo_tpu_torch.utils.yuvframe import unwrap, yuv_info_of


def _channel_names(frame, n_channels: int):
    """Channel labels for forensics: Y/U/V for wrapped YUV frames,
    B/G/R for 3-channel arrays (the reference's convention,
    test_lossless.py:193-247), else indices."""
    if getattr(frame, "yuv_info", None) is not None and n_channels == 3:
        return ["Y", "U", "V"]
    if n_channels == 3:
        return ["B", "G", "R"]
    return [f"ch{i}" for i in range(n_channels)]


def analyze_channel_differences(original, decompressed) -> Dict:
    """Per-channel mismatch breakdown for one frame pair (reference:
    test_lossless.py:193-247): diff pixel count, mean and max |diff| per
    B/G/R (or Y/U/V) channel."""
    od, dd = unwrap(original), unwrap(decompressed)
    diff = od.astype(np.int32) - dd.astype(np.int32)
    if diff.ndim == 2:
        diff = diff[..., None]
    out = {}
    for ci, name in enumerate(_channel_names(original, diff.shape[-1])):
        ch = diff[..., ci]
        nz = ch != 0
        cnt = int(nz.sum())
        out[name] = {
            "pixels_different": cnt,
            "mean_abs_diff": (float(np.abs(ch[nz]).mean()) if cnt else 0.0),
            "max_abs_diff": int(np.abs(ch).max()),
        }
    return out


def verify_bit_exact(original_frames, decompressed_frames,
                     max_examples: int = 5) -> Dict:
    """Independent byte-level comparator with per-pixel forensics
    (reference: verify_true_lossless.py:338-492)."""
    result = {
        "bit_exact": True,
        "frames_compared": 0,
        "mismatched_frames": [],
        "examples": [],
    }
    if len(original_frames) != len(decompressed_frames):
        result["bit_exact"] = False
        result["reason"] = (f"frame count {len(original_frames)} vs "
                            f"{len(decompressed_frames)}")
        return result
    for i, (o, d) in enumerate(zip(original_frames, decompressed_frames)):
        od, dd = unwrap(o), unwrap(d)
        result["frames_compared"] += 1
        if od.shape != dd.shape or od.dtype != dd.dtype:
            result["bit_exact"] = False
            result["mismatched_frames"].append(i)
            result["examples"].append(
                {"frame": i, "kind": "shape/dtype",
                 "orig": (od.shape, str(od.dtype)),
                 "decomp": (dd.shape, str(dd.dtype))})
            continue
        if od.tobytes() == dd.tobytes():
            continue
        result["bit_exact"] = False
        result["mismatched_frames"].append(i)
        diff = od.astype(np.int32) - dd.astype(np.int32)
        bad = np.argwhere(diff != 0)
        for pix in bad[:max_examples]:
            idx = tuple(int(x) for x in pix)
            result["examples"].append(
                {"frame": i, "pixel": idx,
                 "orig": int(od[idx]), "decomp": int(dd[idx])})
        result.setdefault("diff_stats", {})[i] = {
            "pixels_different": int((diff != 0).any(axis=-1).sum()
                                    if diff.ndim == 3 else
                                    (diff != 0).sum()),
            "max_abs_diff": int(np.abs(diff).max()),
            "channels": analyze_channel_differences(o, d),
        }
    return result


def _dump_diagnostics(original, decompressed, frame_idx: int,
                      output_dir: str) -> List[str]:
    """Write diagnostic PNGs for the worst frame (reference:
    verify_true_lossless.py:426-452)."""
    paths = []
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return paths
    os.makedirs(output_dir, exist_ok=True)
    od = unwrap(original)
    dd = unwrap(decompressed)
    diff = (np.abs(od.astype(np.int32) - dd.astype(np.int32))
            .clip(0, 255).astype(np.uint8))
    for name, arr in (("orig", od), ("decomp", dd), ("diff", diff)):
        p = os.path.join(output_dir, f"frame{frame_idx}_{name}.png")
        img = arr if arr.ndim == 2 else arr[..., ::-1]  # BGR -> RGB
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def test_color_space(frames, color_space: str, output_dir: str = None,
                     mode: str = "bloom", verbose: bool = True,
                     profile: str = "blocked", device=None) -> Dict:
    """Strict round trip in one color space: zero noise tolerance, exact
    masks.

    Frames that carry native planes (YUV input) are additionally gated
    on RAW ``.yuv`` BYTE IDENTITY: original and reconstructed frames are
    serialized to raw planar YUV (native subsampled geometry) and
    compared byte-for-byte.  ``device``: where the codec runs (default:
    the current CUDA card)."""
    import tempfile

    comp = ImprovedVideoCompressor(
        noise_tolerance=0.0, min_diff_threshold=0.0,
        use_direct_yuv=(color_space.upper() == "YUV"),
        verbose=False, mode=mode, exact=True, profile=profile,
        device=device)

    if color_space.upper() == "YUV":
        # keep frames that already carry native (possibly subsampled)
        # planes — rewrapping would replace them with a 444 view and
        # defeat the planar profile's native-geometry coding
        frames = [f if yuv_info_of(f) is not None
                  else add_yuv_info_to_frame(np.asarray(unwrap(f)))
                  for f in frames]

    # single-frame smoke test first
    with tempfile.TemporaryDirectory() as td:
        smoke = os.path.join(td, "smoke.bfvc")
        comp.compress_video(frames[:1], smoke, input_color_space=color_space)
        rec1 = comp.decompress_video(smoke)
        if not np.array_equal(unwrap(frames[0]), unwrap(rec1[0])):
            return {"color_space": color_space, "passed": False,
                    "reason": "single-frame smoke test failed"}

        path = os.path.join(td, "clip.bfvc")
        t0 = time.time()
        res = comp.compress_video(frames, path,
                                  input_color_space=color_space)
        t_enc = time.time() - t0
        t0 = time.time()
        rec = comp.decompress_video(path)
        t_dec = time.time() - t0

    v = comp.verify_lossless(frames, rec)
    b = verify_bit_exact(frames, rec)
    passed = v["lossless"] and b["bit_exact"]
    out = {
        "color_space": color_space,
        "profile": profile,
        "passed": passed,
        "verify_lossless": v,
        "bit_exact": b,
        "compression_ratio": res["compression_ratio"],
        "compress_fps": len(frames) / t_enc if t_enc > 0 else 0.0,
        "decompress_fps": len(frames) / t_dec if t_dec > 0 else 0.0,
    }
    # Raw-planar byte identity: the strictest gate for YUV content —
    # the reconstructed native planes must serialize to the exact bytes
    # the originals do (the file-level contract process-yuv relies on).
    if all(yuv_info_of(f) is not None for f in frames):
        from new_bloom_filter_repo_tpu_torch.utils import videoio
        import tempfile as _tf
        with _tf.TemporaryDirectory() as td2:
            p_orig = os.path.join(td2, "orig.yuv")
            p_rec = os.path.join(td2, "rec.yuv")
            videoio.write_raw_yuv(p_orig, frames)
            videoio.write_raw_yuv(p_rec, rec)
            with open(p_orig, "rb") as f1, open(p_rec, "rb") as f2:
                out["yuv_byte_exact"] = f1.read() == f2.read()
        passed = passed and out["yuv_byte_exact"]
        out["passed"] = passed
    if not passed and output_dir and v.get("max_diff_frame", -1) >= 0:
        i = v["max_diff_frame"]
        out["diagnostics"] = _dump_diagnostics(frames[i], rec[i], i,
                                               output_dir)
    if verbose:
        status = "PASS" if passed else "FAIL"
        print(f"[{color_space}] {status}  ratio={res['compression_ratio']:.4f}"
              f"  enc={out['compress_fps']:.2f} fps"
              f"  dec={out['decompress_fps']:.2f} fps")
        if not passed:
            print(f"  mismatched frames: {b['mismatched_frames'][:10]}")
            for ex in b["examples"][:5]:
                print(f"  example: {ex}")
    return out


def test_true_lossless(video_path: str, color_spaces=("BGR", "RGB", "YUV"),
                       max_frames: int = 30, output_dir: str = None,
                       mode: str = "bloom", verbose: bool = True,
                       profile: str = "blocked", device=None) -> Dict:
    """Full harness over a real video file."""
    comp = ImprovedVideoCompressor(verbose=False, device=device)
    results = {}
    ok = True
    for cs in color_spaces:
        try:
            frames = comp.extract_frames_from_video(
                video_path, max_frames=max_frames, output_color_space=cs)
            results[cs] = test_color_space(frames, cs, output_dir,
                                           mode=mode, verbose=verbose,
                                           profile=profile, device=device)
        except Exception as exc:  # report, don't abort other spaces
            results[cs] = {"color_space": cs, "passed": False,
                           "reason": f"{type(exc).__name__}: {exc}"}
            if verbose:
                print(f"[{cs}] ERROR {exc}")
        ok = ok and results[cs].get("passed", False)
    results["all_passed"] = ok
    if verbose:
        print(f"\nOverall: {'TRUE LOSSLESS VERIFIED' if ok else 'FAILED'}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bit-exact lossless verification harness")
    ap.add_argument("video", help="Input video path (.y4m/.yuv/anything "
                                  "cv2 reads)")
    ap.add_argument("--color-spaces", nargs="+",
                    default=["BGR", "RGB", "YUV"])
    ap.add_argument("--max-frames", type=int, default=30)
    ap.add_argument("--output-dir", default=None,
                    help="Directory for failure diagnostics")
    ap.add_argument("--mode", choices=["bloom", "keyframe"],
                    default="bloom")
    ap.add_argument("--profile", choices=["blocked", "bfv2", "planar"],
                    default="blocked",
                    help="Codec profile; planar adds a raw .yuv "
                         "byte-identity gate on YUV content")
    ap.add_argument("--device", default=None,
                    help="Device the codec runs on (default: the current "
                         "CUDA card; 'cpu' or e.g. 'cuda:1' on request)")
    args = ap.parse_args(argv)
    results = test_true_lossless(
        args.video, args.color_spaces, args.max_frames, args.output_dir,
        mode=args.mode, profile=args.profile, device=args.device)
    return 0 if results["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
