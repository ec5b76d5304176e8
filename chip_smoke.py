#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, ``ImprovedVideoCompressor(device="cuda")``
(blocked profile, exact, motion on), through ``compress_video`` and
``decompress_video`` at 1080p, after building the hand-written Hopper
kernels K1-K4 from ``new_bloom_filter_repo_tpu_torch/ops/csrc`` and
holding each against its plain PyTorch twin on the card.  Phases:

1. device: the card, its power limit, the kernel build;
2. kernel vs twin at the 1080p chunk shapes (F = 15, NB = 2032), on the
   inputs of a real chunk and on a mix with edge-case filter widths,
   pass-through flags and raw masks; exact equality (tolerance 0);
3. the bench clip (1920x1080x3, 31 frames), round trip bit-exact;
4. the synthetic ``pan`` clip (seed 0, 31 frames, 1080p), round trip
   bit-exact, with type-6 motion records;
5. a CIF clip encoded on the card and on the CPU (the twins) to
   identical ``.bfvc`` bytes, and the committed JAX-written fixture
   decoded bit-exactly.

Phases 3 and 4 are the main-path run: every kernel's launch count is
set to 0 just before them and read just after, and a kernel the path
did not launch fails the run.  Every phase that fails raises; nothing
falls back to the CPU.  The second-to-last lines are the per-kernel
JSON and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_pan.bfvc")
CSRC = "new_bloom_filter_repo_tpu_torch/ops/csrc/blocked.cu"
TPU_KERNELS = "new_bloom_filter_repo_tpu/ops/pallas/blocked.py"
# kernel wrapper name -> (short name, pallas_call line it replaces)
KERNELS = {
    "blocked_encode_h": ("K1", 660),
    "blocked_membership_h": ("K2", 703),
    "blocked_expand_chain": ("K3", 832),
    "blocked_expand": ("K4", 774),
}
H, W = 1080, 1920
CHUNK = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def make_bench_clip(n_frames: int, h: int = H, w: int = W, seed: int = 0):
    """The bench.py clip recipe: a textured static background, a moving
    240-px box and ~1.5% sparse sensor noise per frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 220, size=(h, w, 3), dtype=np.uint8)
    frames = []
    for i in range(n_frames):
        f = base.copy()
        noise_mask = rng.random((h, w)) < 0.015
        f[noise_mask] = rng.integers(0, 256, size=(int(noise_mask.sum()), 3))
        x = (40 + 23 * i) % (w - 260)
        y = (60 + 11 * i) % (h - 260)
        f[y:y + 240, x:x + 240] = (30, 200, 240)
        frames.append(f)
    return frames


# ---------------------------------------------------------------------------
# Phase 2: kernels against their twins
# ---------------------------------------------------------------------------

def chunk_args(frames, dev):
    """K1's arguments for the first chunk of ``frames``, computed the way
    the encoder computes them: phase A on ``dev``, then the host
    parameter math."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables

    h, w = frames[0].shape[:2]
    tab = blocked_tables(h * w, dev)
    stacked = bp.BlockedEncoder.stack_chunk(frames[0], frames[1:CHUNK + 1],
                                            dev)
    masks, counts, vals, _, _ = bp._phase_a_auto(
        stacked, stride=bp.motion_stride(h, w), npad=tab["npad"],
        nb=tab["nb"])
    _, _, m, fk, thi, tlo, geom = bp.chunk_params(counts.cpu().numpy(),
                                                  h * w, tab["nb"])
    return ((masks, tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"],
             vals, *bp.frame_scalars(dev, m, thi, tlo, fk)), geom)


def edge_mix_args(tab, f, dev, seed=1):
    """K1 arguments spanning the stream's range: m from 16 to 384, floor
    k from 0 to 12, per-frame change densities from 0.1% to 30%, random
    activation thresholds; vh = 32 so every change fits."""
    import torch

    rng = np.random.default_rng(seed)
    nb = tab["nb"]
    m = np.linspace(16, 384, f).round().astype(np.int32)
    fk = (np.arange(f) % 13).astype(np.int32)
    thi = rng.integers(0, 1 << 32, f, dtype=np.uint64).astype(np.uint32)
    tlo = rng.integers(0, 1 << 32, f, dtype=np.uint64).astype(np.uint32)
    dens = np.geomspace(0.001, 0.3, f)[:, None, None]
    bits = (rng.random((f, nb, 1024)) < dens).astype(np.uint8)
    vals = rng.integers(0, 1 << 24, (f, nb, 1024), dtype=np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    args = (t(bits), tab["h1"], tab["h2"], tab["act_hi"], tab["act_lo"],
            t(vals), t(m), t(thi.view(np.int32)), t(tlo.view(np.int32)),
            t(fk))
    return args, {"k_lanes": int(fk.max()), "vh": 32,
                  "nw": (int(m.max()) + 31) // 32}


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after one
    warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |difference| over tuples of integer tensors; raises on a
    shape or dtype mismatch."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max().item()))
    return err


def kernel_cases(enc_args, enc_kw, dev, flagged: bool, seed: int):
    """(name, kernel call, twin call) for K1-K4 on one input mix.  The
    decode kernels take K1's outputs (the twin's, which the kernel must
    equal); with ``flagged``, every third frame is a pass-through frame
    with a random raw mask."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    words, wit, _, vseg, _ = bk.blocked_encode_h_ref(*enc_args, **enc_kw)
    _, h1, h2, ahi, alo, vals, m, thi, tlo, fk = enc_args
    f, nb, _ = vals.shape
    k_lanes, vh, nw = enc_kw["k_lanes"], enc_kw["vh"], enc_kw["nw"]
    flags = torch.zeros(f, dtype=torch.int32, device=dev)
    raw = torch.zeros((f, nb, bk.IPB), dtype=torch.uint8, device=dev)
    if flagged:
        rng = np.random.default_rng(seed)
        sel = np.arange(f) % 3 == 0
        flags[torch.from_numpy(sel).to(dev)] = 1
        raw[torch.from_numpy(sel).to(dev)] = torch.from_numpy(
            (rng.random((int(sel.sum()), nb, bk.IPB)) < 0.02)
            .astype(np.uint8)).to(dev)
    mem = (words, h1, h2, ahi, alo, m, thi, tlo, fk, flags)
    passes, _ = bk.blocked_membership_h_ref(*mem, k_lanes=k_lanes, nw=nw)
    base = vals[0].clone()
    exp = (passes, wit, raw, flags, vseg)
    return [
        ("blocked_encode_h",
         lambda: bk.blocked_encode_h(*enc_args, **enc_kw),
         lambda: bk.blocked_encode_h_ref(*enc_args, **enc_kw)),
        ("blocked_membership_h",
         lambda: bk.blocked_membership_h(*mem, k_lanes=k_lanes, nw=nw),
         lambda: bk.blocked_membership_h_ref(*mem, k_lanes=k_lanes, nw=nw)),
        ("blocked_expand_chain",
         lambda: bk.blocked_expand_chain(*exp, base, vh=vh),
         lambda: bk.blocked_expand_chain_ref(*exp, base, vh=vh)),
        ("blocked_expand",
         lambda: bk.blocked_expand(*exp, vh=vh),
         lambda: bk.blocked_expand_ref(*exp, vh=vh)),
    ]


def phase_kernels(dev, frames, reps: int = 20, twin_reps: int = 3):
    """Every kernel against its twin on two input mixes; returns
    {wrapper name: {max_abs_err, ms, plain_ms}} (times from the real
    chunk)."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables

    real_args, real_kw = chunk_args(frames, dev)
    h, w = frames[0].shape[:2]
    tab = blocked_tables(h * w, dev)
    mixes = [("real chunk", real_args, real_kw, False, 0),
             ("edge mix + flags", *edge_mix_args(tab, CHUNK, dev), True, 2)]
    out = {}
    for label, args, kw, flagged, seed in mixes:
        bits = args[0]
        log(f"  mix {label}: F={bits.shape[0]} NB={bits.shape[1]} "
            f"k_lanes={kw['k_lanes']} nw={kw['nw']} vh={kw['vh']}")
        for name, kern, twin in kernel_cases(args, kw, dev, flagged, seed):
            got = kern()
            want = twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            rec = out.setdefault(name, {"max_abs_err": 0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            line = f"    {KERNELS[name][0]} {name}: max_abs_err={err}"
            if label == "real chunk":
                rec["ms"] = time_ms(kern, reps)
                rec["plain_ms"] = time_ms(twin, twin_reps)
                line += (f" kernel {rec['ms']:.4f} ms, plain twin "
                         f"{rec['plain_ms']:.4f} ms")
            log(line)
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin on "
                                     f"{label}: max_abs_err={err}")
    return out


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

def count_records(path):
    """Histogram of (outer, inner) record types of a .bfvc file."""
    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
    from new_bloom_filter_repo_tpu_torch.utils import container

    hist = {}
    for p in container.read_bfvc(path)[1]:
        t = fc.record_type(p)
        key = f"6>{p[5]}" if t == fc.MOTION else str(t)
        hist[key] = hist.get(key, 0) + 1
    return hist


def round_trip(label, frames, dev, path, card):
    """compress_video -> .bfvc -> decompress_video, bit-exact; prints
    the fps of each direction beside the card."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    comp = ImprovedVideoCompressor(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = comp.compress_video(frames, path)
    t1 = time.perf_counter()
    dec = comp.decompress_video(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if len(dec) != len(frames) or not all(
            np.array_equal(a, np.asarray(b)) for a, b in zip(frames, dec)):
        raise AssertionError(f"{label}: round trip is not bit-exact")
    hist = count_records(path)
    log(f"  {label}: {len(frames)} frames {frames[0].shape}, bit-exact; "
        f"ratio {stats['compression_ratio']:.6f}; compress "
        f"{len(frames) / (t1 - t0):.3f} fps, decompress "
        f"{len(frames) / (t2 - t1):.3f} fps ({card}); records {hist}")
    return hist


def phase_main_path(dev, bench_frames, pan_frames, tmp, card):
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    bk.reset_launches()
    round_trip("phase 3 static 1080p (bench clip)", bench_frames, dev,
               os.path.join(tmp, "static.bfvc"), card)
    pan_hist = round_trip("phase 4 pan 1080p (synthetic, seed 0)",
                          pan_frames, dev, os.path.join(tmp, "pan.bfvc"),
                          card)
    launches = bk.launches()
    log(f"  main-path kernel launches: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if not any(k.startswith("6>") for k in pan_hist):
        raise AssertionError("pan clip produced no type-6 motion record")
    return launches


def phase_parity(dev, tmp):
    """Same-machine byte parity (CUDA vs CPU twins) and the JAX
    fixture decoded on the card."""
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
        SUITE, generate_frames)

    cif = generate_frames(16, 352, 288, seed=0, **SUITE["static_gentle"])
    paths = {}
    for d in (dev, "cpu"):
        paths[d] = os.path.join(tmp, f"cif_{d}.bfvc")
        ImprovedVideoCompressor(device=d).compress_video(cif, paths[d])
    with open(paths[dev], "rb") as a, open(paths["cpu"], "rb") as b:
        cuda_bytes, cpu_bytes = a.read(), b.read()
    if cuda_bytes != cpu_bytes:
        raise AssertionError("CIF .bfvc differs between CUDA and CPU")
    log(f"  CIF static_gentle 16 frames: CUDA and CPU .bfvc identical "
        f"({len(cuda_bytes)} bytes)")
    pan = generate_frames(16, 96, 80, seed=0, **SUITE["pan"])
    dec = ImprovedVideoCompressor(device=dev).decompress_video(FIXTURE)
    if len(dec) != len(pan) or not all(
            np.array_equal(a, np.asarray(b)) for a, b in zip(pan, dec)):
        raise AssertionError("JAX fixture did not decode bit-exactly")
    log(f"  JAX fixture {os.path.relpath(FIXTURE, REPO)} decoded "
        f"bit-exactly on the card ({len(dec)} frames, records "
        f"{count_records(FIXTURE)})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from new_bloom_filter_repo_tpu_torch.ops import _build
    from new_bloom_filter_repo_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    _build.load()
    log(f"  kernels built from {CSRC} in {_build.build_seconds:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, spills, regs in re.findall(
            r"Compiling entry function '\S*?(k\d_[a-z_]+)\S*'.*?"
            r"(\d+) bytes spill stores.*?Used (\d+) registers",
            _build.build_log, re.S):
        log(f"    ptxas {name}: {regs} registers, {spills} bytes spilled")

    t0 = time.perf_counter()
    bench = make_bench_clip(31)
    pan = synthetic.generate_frames(31, W, H, seed=0,
                                    **synthetic.SUITE["pan"])
    log(f"  clips generated on the host in {time.perf_counter() - t0:.2f} s")

    log(f"phase 2 kernels vs twins at 1080p chunk shapes ({smi}):")
    stats = phase_kernels(dev, bench)
    with tempfile.TemporaryDirectory() as tmp:
        log("phases 3-4 main path:")
        launches = phase_main_path(dev, bench, pan, tmp, smi)
        log("phase 5 parity:")
        phase_parity(dev, tmp)

    kernels = [{"name": f"{KERNELS[n][0]} {n}", "route": "cuda",
                "source": CSRC,
                "replaces": f"{TPU_KERNELS}:{KERNELS[n][1]}",
                "launches": launches[n],
                "max_abs_err": stats[n]["max_abs_err"],
                "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"]}
               for n in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
