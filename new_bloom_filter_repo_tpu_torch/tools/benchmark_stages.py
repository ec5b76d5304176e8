#!/usr/bin/env python3
"""Per-stage device timings of the blocked codec at bench geometry.

The port of the root ``benchmark_stages.py``.  Times each device stage
of the BFV3 codec in isolation on the synthetic 1080p clip of
``tools/bench.py``: phase A (diff masks + packed pixels), the blocked
encode K1, membership K2, and the fused expansion + chain K3, with the
bench's host parameter math (every frame must be a blocked inter frame).
Use it to attribute regressions the single-number bench headline can't
localize.
Each stage is timed by the host clock over ``--reps`` runs after one
warm-up run, ending on ``torch.cuda.synchronize()``.

Usage:  python -m new_bloom_filter_repo_tpu_torch.tools.benchmark_stages
            [--frames N] [--reps R] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120,
                    help="inter frames per batch (plus one base frame)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--prefetch-compare", action="store_true",
                    help="Time compress_video with prefetch off vs on "
                         "(upload/compute overlap) — this mode measures "
                         "instead of assuming")
    ap.add_argument("--host", action="store_true",
                    help="Also time the HOST stages of the production "
                         "byte pipeline (record assembly/parse) via the "
                         "instrumented encode_chunk/decode_run on a "
                         "15-frame chunk — includes device->host pulls")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; "
                         "'cpu' runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import default_device
    from new_bloom_filter_repo_tpu_torch.tools.bench import (
        codec_params, make_clip)

    device = default_device(args.device)
    frames = make_clip(args.frames + 1, args.height, args.width)
    base, chunk = frames[0], frames[1:]
    f = len(chunk)
    h, w, _ = base.shape
    n = h * w
    tab = bp.blocked_tables(n, device)
    nb, npad = tab["nb"], tab["npad"]
    stacked = torch.from_numpy(np.stack([base] + chunk)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    masks, counts_d, vals = bp._phase_a(stacked, npad=npad, nb=nb)
    m_arr, thi, tlo, fk_arr, geom = codec_params(counts_d.cpu().numpy(), n,
                                                 nb)
    k_lanes, vh, nw = geom["k_lanes"], geom["vh"], geom["nw"]
    print(f"f={f} nb={nb} vh={vh} k_lanes={k_lanes} nw={nw} "
          f"mean_m={m_arr.mean():.0f}", flush=True)

    scalars = bp.frame_scalars(device, m_arr, thi, tlo, fk_arr)
    tables = (tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"])
    flags = torch.zeros(f, dtype=torch.int32, device=device)
    raw = torch.zeros((f, nb, bk.IPB), dtype=torch.uint8, device=device)

    def timeit(name, fn, *fargs):
        out = fn(*fargs)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn(*fargs)
        sync()
        dt = (time.perf_counter() - t0) / args.reps
        print(f"{name:24s} {dt * 1e3:8.1f} ms  {f / dt:7.1f} fps",
              flush=True)
        return out

    timeit("phase_a",
           functools.partial(bp._phase_a, npad=npad, nb=nb), stacked)
    words, wit, wcnt, vseg, vcnt = timeit(
        "encode_h", functools.partial(bk.blocked_encode_h, k_lanes=k_lanes,
                                      vh=vh, nw=nw),
        masks, *tables, vals, *scalars)
    passes, _ = timeit(
        "membership_h", functools.partial(bk.blocked_membership_h,
                                          k_lanes=k_lanes, nw=nw),
        words, *tables, *scalars, flags)
    base_packed = bp._pack_base(stacked[0], npad=npad, nb=nb)
    timeit("expand+chain (fused)",
           functools.partial(bk.blocked_expand_chain, vh=vh), passes, wit,
           raw, flags, vseg, base_packed)

    if args.host:
        from new_bloom_filter_repo_tpu_torch.utils.profiling import (
            measure_host_stages)
        enc_s, dec_s, detail = measure_host_stages(
            [np.asarray(x) for x in frames], reps=args.reps, device=device)
        print("-- production pipeline stages (ms/frame, 15-frame chunk) --",
              flush=True)
        for k, v in sorted(detail.items()):
            print(f"{k:24s} {v:8.2f} ms/frame", flush=True)
        host_s = enc_s + dec_s
        print(f"host-cpu total           {host_s * 1e3:8.2f} ms/frame"
              f"  ({1.0 / host_s:7.1f} fps host-bound)", flush=True)

    if args.prefetch_compare:
        from new_bloom_filter_repo_tpu_torch.models.video import (
            ImprovedVideoCompressor)
        clip = [np.asarray(x) for x in frames[: min(61, len(frames))]]
        print("-- prefetch (upload/compute overlap) comparison --",
              flush=True)
        for pf in (False, True):
            comp = ImprovedVideoCompressor(verbose=False, prefetch=pf,
                                           keyframe_interval=1000,
                                           device=device)
            comp.compress_video(clip[:16], None)      # warm-up
            t0 = time.perf_counter()
            comp.compress_video(clip, None)
            sync()
            dt = time.perf_counter() - t0
            print(f"prefetch={str(pf):5s} {dt:8.2f} s  "
                  f"{len(clip) / dt:7.2f} fps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
