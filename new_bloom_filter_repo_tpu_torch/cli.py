"""Command-line interface.

The port of ``new_bloom_filter_repo_tpu.cli``: the same subcommands and
flags, plus ``--device`` on every subcommand that builds a compressor.
Without ``--device`` the codec runs on the current CUDA card and the
command fails with ``RuntimeError`` when there is none; ``--device cpu``
(or ``cuda:1``) names another device.  The files are the same on every
device.

    python -m new_bloom_filter_repo_tpu_torch.cli compress in.y4m out.bfvc
    python -m new_bloom_filter_repo_tpu_torch.cli decompress out.bfvc out.y4m
    python -m new_bloom_filter_repo_tpu_torch.cli process-yuv in.yuv out.bfvc \
        --width 1920 --height 1080 --format I420
    python -m new_bloom_filter_repo_tpu_torch.cli synthetic outdir --frames 90
    python -m new_bloom_filter_repo_tpu_torch.cli analyze outdir
    python -m new_bloom_filter_repo_tpu_torch.cli analyze-stream out.bfvc
"""

from __future__ import annotations

import argparse
import os
import sys

from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
    default_color_space,
    verify_lossless,
)


def _default_chunk() -> int:
    from new_bloom_filter_repo_tpu_torch.models import video as _v
    return _v._CHUNK


def _add_device_flag(p):
    p.add_argument("--device", default=None,
                   help="Device the codec runs on (default: the current "
                        "CUDA card; 'cpu' or e.g. 'cuda:1' on request)")


def _add_devices_flag(p):
    p.add_argument("--devices", default=None,
                   help="Several CUDA cards of this process: 'auto' (all "
                        "cards), a card count, or DPxSP (e.g. 4x2: frames "
                        "shard over dp, blocks within a frame over sp for "
                        "oversized frames); shards gather on the first "
                        "card")


def _add_codec_flags(p, include_batch=True):
    p.add_argument("--noise-tolerance", type=float, default=10.0,
                   help="Noise tolerance level (near-lossless mode)")
    p.add_argument("--keyframe-interval", type=int, default=30,
                   help="Maximum frames between keyframes")
    p.add_argument("--min-diff", type=float, default=3.0,
                   help="Minimum threshold for pixel differences")
    p.add_argument("--max-diff", type=float, default=30.0,
                   help="Maximum threshold for pixel differences")
    p.add_argument("--bloom-modifier", type=float, default=1.0,
                   help="Modifier for Bloom filter threshold")
    if include_batch:
        p.add_argument("--batch-size", type=int, default=None,
                       help="Inter frames per device chunk (default: "
                            f"NBF_CHUNK env or {_default_chunk()})")
        p.add_argument("--threads", type=int, default=None,
                       help="Native DEFLATE pool size for the host "
                            "entropy stage (default: all cores)")
    p.add_argument("--mode", choices=["bloom", "keyframe"], default="bloom",
                   help="bloom: keyframes + Bloom inter frames (BFV2); "
                        "keyframe: reference-compatible BFVC")
    p.add_argument("--profile", choices=["blocked", "bfv2", "planar"],
                   default=None,
                   help="blocked: BFV3 records (default); bfv2: reference "
                        "record layout; planar: code native Y/U/V planes "
                        "independently (default for process-yuv)")
    p.add_argument("--near-lossless", action="store_true",
                   help="Reference threshold semantics (lossy by design) "
                        "instead of exact any-channel masks")
    _add_devices_flag(p)
    _add_device_flag(p)
    p.add_argument("--verbose", action="store_true")


def _parse_devices(value):
    if value is None or value == "auto":
        return value
    if isinstance(value, str) and "x" in value:
        dp, sp = value.lower().split("x", 1)
        return (int(dp), int(sp))
    return int(value)


def _compressor(args, use_direct_yuv=False, default_profile="blocked"):
    return ImprovedVideoCompressor(
        noise_tolerance=getattr(args, "noise_tolerance", 10.0),
        keyframe_interval=getattr(args, "keyframe_interval", 30),
        min_diff_threshold=getattr(args, "min_diff", 3.0),
        max_diff_threshold=getattr(args, "max_diff", 30.0),
        bloom_threshold_modifier=getattr(args, "bloom_modifier", 1.0),
        batch_size=getattr(args, "batch_size", None),
        num_threads=getattr(args, "threads", None),
        use_direct_yuv=use_direct_yuv or getattr(args, "use_direct_yuv",
                                                 False),
        verbose=getattr(args, "verbose", False),
        mode=getattr(args, "mode", "bloom"),
        exact=not getattr(args, "near_lossless", False),
        profile=getattr(args, "profile", None) or default_profile,
        devices=_parse_devices(getattr(args, "devices", None)),
        device=getattr(args, "device", None),
    )


def _print_compress_summary(result):
    print("\nCompression Summary:")
    print(f"Original Size: {result['original_size'] / (1024*1024):.2f} MB")
    print(f"Compressed Size: "
          f"{result['compressed_size'] / (1024*1024):.2f} MB")
    print(f"Compression Ratio: {result['compression_ratio']:.4f}")
    print(f"Space Savings: {(1 - result['compression_ratio']) * 100:.1f}%")
    print(f"Keyframes: {result['keyframes']}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="new_bloom_filter_repo_tpu_torch",
        description="Rational-Bloom-filter lossless video codec "
                    "(PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="action")

    pc = sub.add_parser("compress", help="Compress a video file")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--max-frames", type=int, default=0)
    pc.add_argument("--fps", type=float, default=None)
    pc.add_argument("--scale", type=float, default=1.0)
    pc.add_argument("--use-direct-yuv", action="store_true")
    pc.add_argument("--color-space", default=None,
                    choices=["BGR", "RGB", "YUV"],
                    help="Working color space (default: YUV for .y4m/.yuv "
                         "inputs — lossless native-plane round trip — "
                         "else BGR, matching the reference)")
    pc.add_argument("--width", type=int, default=None,
                    help="Frame width (required for raw .yuv input)")
    pc.add_argument("--height", type=int, default=None,
                    help="Frame height (required for raw .yuv input)")
    pc.add_argument("--format", default="I420",
                    choices=["I420", "YV12", "YUV422", "YUV444"],
                    help="Raw .yuv plane layout")
    _add_codec_flags(pc)

    pd = sub.add_parser("decompress", help="Decompress a .bfvc file")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--use-direct-yuv", action="store_true")
    _add_devices_flag(pd)
    _add_device_flag(pd)
    pd.add_argument("--verbose", action="store_true")

    py = sub.add_parser("process-yuv", help="Compress a raw planar YUV file")
    py.add_argument("input")
    py.add_argument("output")
    py.add_argument("--width", type=int, required=True)
    py.add_argument("--height", type=int, required=True)
    py.add_argument("--format", default="I420",
                    choices=["I420", "YV12", "YUV422", "YUV444"])
    py.add_argument("--max-frames", type=int, default=0)
    py.add_argument("--frame-step", type=int, default=1)
    _add_codec_flags(py, include_batch=False)

    ps = sub.add_parser("synthetic",
                        help="Generate, compress and verify synthetic video")
    ps.add_argument("output", help="Output directory")
    ps.add_argument("--frames", type=int, default=90)
    ps.add_argument("--width", type=int, default=640)
    ps.add_argument("--height", type=int, default=480)
    ps.add_argument("--noise", type=float, default=1.0)
    ps.add_argument("--speed", type=float, default=1.0)
    ps.add_argument("--pan", type=float, default=0.0,
                    help="Global pan (pixels/frame)")
    ps.add_argument("--zoom", type=float, default=0.0,
                    help="Zoom rate per frame")
    ps.add_argument("--scene-cut-every", type=int, default=0,
                    help="Hard scene cut every N frames")
    ps.add_argument("--use-direct-yuv", action="store_true")
    ps.add_argument("--color-space", default="BGR",
                    choices=["BGR", "RGB", "YUV", "GRAY"])
    ps.add_argument("--keyframe-interval", type=int, default=30)
    ps.add_argument("--mode", choices=["bloom", "keyframe"], default="bloom")
    _add_devices_flag(ps)
    _add_device_flag(ps)
    ps.add_argument("--verbose", action="store_true")

    pq = sub.add_parser(
        "analyze-stream",
        help="Attribute a .bfvc's bytes by record type / section coding")
    pq.add_argument("input", help=".bfvc file")
    pq.add_argument("--json", action="store_true",
                    help="Machine-readable output")

    pa = sub.add_parser("analyze", help="Analyze noise vs compression")
    pa.add_argument("output", help="Output directory")
    pa.add_argument("--frames", type=int, default=90)
    pa.add_argument("--width", type=int, default=640)
    pa.add_argument("--height", type=int, default=480)
    pa.add_argument("--noise-levels", type=float, nargs="+",
                    default=[0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0])
    pa.add_argument("--use-direct-yuv", action="store_true")
    pa.add_argument("--color-space", default="BGR",
                    choices=["BGR", "RGB", "YUV"])
    _add_device_flag(pa)
    pa.add_argument("--verbose", action="store_true")

    args = parser.parse_args(argv)
    if args.action is None:
        parser.print_help()
        return 0

    if args.action == "compress":
        color_space = args.color_space or default_color_space(args.input)
        comp = _compressor(args, use_direct_yuv=args.use_direct_yuv)
        frames = comp.extract_frames_from_video(
            args.input, max_frames=args.max_frames, target_fps=args.fps,
            scale_factor=args.scale, output_color_space=color_space,
            width=args.width, height=args.height, format=args.format)
        result = comp.compress_video(frames, args.output,
                                     input_color_space=color_space)
        _print_compress_summary(result)
        return 0

    if args.action == "decompress":
        comp = ImprovedVideoCompressor(use_direct_yuv=args.use_direct_yuv,
                                       verbose=args.verbose,
                                       devices=_parse_devices(args.devices),
                                       device=args.device)
        frames = comp.decompress_video(args.input, args.output)
        print("\nDecompression Summary:")
        print(f"Decompressed {len(frames)} frames")
        print(f"Output saved to: {args.output}")
        return 0

    if args.action == "process-yuv":
        comp = _compressor(args, use_direct_yuv=True,
                           default_profile="planar")
        frames = comp.extract_frames_from_video(
            args.input, width=args.width, height=args.height,
            format=args.format, max_frames=args.max_frames,
            frame_step=args.frame_step)
        result = comp.compress_video(frames, args.output,
                                     input_color_space="YUV")
        print(f"\nProcessed {len(frames)} frames from {args.input}")
        print(f"Format: {args.format}, "
              f"Dimensions: {args.width}x{args.height}")
        _print_compress_summary(result)
        return 0

    if args.action == "synthetic":
        from new_bloom_filter_repo_tpu_torch.utils.synthetic import generate_frames
        os.makedirs(args.output, exist_ok=True)
        comp = ImprovedVideoCompressor(
            keyframe_interval=args.keyframe_interval,
            use_direct_yuv=args.use_direct_yuv, verbose=args.verbose,
            mode=args.mode, devices=_parse_devices(args.devices),
            device=args.device)
        frames = generate_frames(args.frames, args.width, args.height,
                                 noise=args.noise, speed=args.speed,
                                 color_space=args.color_space,
                                 pan=args.pan, zoom=args.zoom,
                                 scene_cut_every=args.scene_cut_every)
        path = os.path.join(args.output, "synthetic_compressed.bfvc")
        result = comp.compress_video(frames, path,
                                     input_color_space=args.color_space
                                     if args.color_space != "GRAY" else "BGR")
        rec = comp.decompress_video(path)
        v = verify_lossless(frames, rec)
        print("\nSynthetic Video Summary:")
        print(f"Generated {len(frames)} frames "
              f"({args.width}x{args.height}), noise {args.noise}")
        print(f"Compression Ratio: {result['compression_ratio']:.4f}")
        print(f"Space Savings: "
              f"{(1 - result['compression_ratio']) * 100:.1f}%")
        print(f"Lossless: {v['lossless']}")
        if v["exact_lossless"]:
            print("Perfect bit-exact reconstruction achieved")
        return 0 if v["lossless"] else 1

    if args.action == "analyze-stream":
        import json as _json

        from new_bloom_filter_repo_tpu_torch.utils import container, streaminfo
        magic, payloads = container.read_bfvc(args.input)
        # planar streams: skip the plane-count header, attribute the
        # per-plane records themselves
        body = (payloads[1:] if payloads
                and payloads[0][:1] == bytes([5]) else payloads)
        info = streaminfo.attribute_stream(body)
        if args.json:
            print(_json.dumps({"path": args.input,
                               "magic": magic.decode("ascii", "replace"),
                               **info}))
        else:
            print(streaminfo.format_report(args.input, magic, info))
        return 0

    if args.action == "analyze":
        comp = ImprovedVideoCompressor(use_direct_yuv=args.use_direct_yuv,
                                       verbose=args.verbose,
                                       device=args.device)
        result = comp.analyze_noise_vs_compression(
            width=args.width, height=args.height, frame_count=args.frames,
            noise_levels=args.noise_levels, output_dir=args.output,
            color_space=args.color_space)
        print("\nNoise Analysis Summary:")
        print(f"Tested {len(result['noise_levels'])} noise levels: "
              f"{result['noise_levels']}")
        print(f"Ratios: {[round(r, 4) for r in result['ratios']]}")
        print(f"Lossless: {result['lossless']}")
        if "plot" in result:
            print(f"Plot: {result['plot']}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
