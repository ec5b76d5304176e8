#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, ``ImprovedVideoCompressor(device="cuda")``
(blocked profile, exact, motion on), through ``compress_video`` and
``decompress_video`` at 1080p, and its multi-device paths (the mesh dry
run and ``devices=``), after building the hand-written Hopper kernels
K1-K5b from ``new_bloom_filter_repo_tpu_torch/ops/csrc`` and holding
each against its plain PyTorch twin on the card.  Phases:

1. device: the card, its power limit, the kernel build;
2. kernel vs twin at the 1080p chunk shapes (F = 15, NB = 2032), on the
   inputs of a real chunk and on a mix with edge-case filter widths,
   pass-through flags and raw masks; exact equality (tolerance 0); K5a
   and K5b run on the ``_frame_mod_tables`` of the same inputs and must
   also equal K1 and K2;
3. the bench clip (1920x1080x3, 31 frames), round trip bit-exact;
4. the synthetic ``pan`` clip (seed 0, 31 frames, 1080p), round trip
   bit-exact, with type-6 motion records;
5. a CIF clip encoded on the card and on the CPU (the twins) to
   identical ``.bfvc`` bytes, and the committed JAX-written fixture
   decoded bit-exactly;
6. the mesh dry run ``graft_entry.dryrun_blocked_dp`` on a dp = 4 mesh
   (four cards where the machine has them, else one card four times)
   at nb = 2032, 8 frames: K5a encode, K5b + K4 decode, mask == bits,
   and every sharded output equal to the unsharded wrappers';
7. ``devices=``: the phase-3 clip on a (2, 2) mesh and the phase-4 clip
   on a (2, 1) mesh, each ``.bfvc`` byte-identical to the single-device
   file and decoded bit-exactly through the mesh; the same over
   distinct cards where the machine has two or more; one 3840x2160x3
   chunk of 5 frames on a (1, 2) mesh, byte-identical to one device.

Phases 3-4, 6 and 7 are the paths: every kernel's launch count is set
to 0 just before each and read just after, and a kernel its path must
launch that it did not fails the run (K1-K4 on phases 3-4; K5a, K5b
and K4 on phase 6; K1-K4 on phase 7).  Every phase that fails raises;
nothing falls back to the CPU.  The second-to-last lines are the
per-kernel JSON (launches summed over the three path runs) and the
card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.  Exits non-zero without a CUDA card.
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
    "blocked_encode": ("K5a", 595),
    "blocked_membership": ("K5b", 740),
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
    """(name, kernel call, twin call) for K1-K5b on one input mix.  The
    decode kernels take K1's outputs (the twin's, which the kernel must
    equal); K5a and K5b take the ``_frame_mod_tables`` of K1's and K2's
    inputs; with ``flagged``, every third frame is a pass-through frame
    with a random raw mask."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
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
    a, b, act = bp._frame_mod_tables(h1, h2, ahi, alo, m, thi, tlo)
    enc5 = (enc_args[0], a, b, act, vals, m, fk)
    mem5 = (words, a, b, act, m, fk, flags)
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
        ("blocked_encode",
         lambda: bk.blocked_encode(*enc5, **enc_kw),
         lambda: bk.blocked_encode_ref(*enc5, **enc_kw)),
        ("blocked_membership",
         lambda: bk.blocked_membership(*mem5, k_lanes=k_lanes, nw=nw),
         lambda: bk.blocked_membership_ref(*mem5, k_lanes=k_lanes, nw=nw)),
    ]


# K5a/K5b must equal K1/K2 on the materialized tables of the same inputs
SAME_AS = {"blocked_encode": "blocked_encode_h",
           "blocked_membership": "blocked_membership_h"}


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
        got_by_name = {}
        for name, kern, twin in kernel_cases(args, kw, dev, flagged, seed):
            got = kern()
            want = twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            got_by_name[name] = got
            rec = out.setdefault(name, {"max_abs_err": 0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            line = f"    {KERNELS[name][0]} {name}: max_abs_err={err}"
            if name in SAME_AS:
                same = max_abs_err(got, got_by_name[SAME_AS[name]])
                line += (f", vs {KERNELS[SAME_AS[name]][0]} kernel on the "
                         f"same inputs max_abs_err={same}")
                err = max(err, same)
            if label == "real chunk":
                rec["ms"] = time_ms(kern, reps)
                rec["plain_ms"] = time_ms(twin, twin_reps)
                line += (f"; kernel {rec['ms']:.4f} ms, plain twin "
                         f"{rec['plain_ms']:.4f} ms")
            log(line)
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin or "
                                     f"its hash-prelude kernel on {label}: "
                                     f"max_abs_err={err}")
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


def round_trip(label, frames, dev, path, card, **options):
    """compress_video -> .bfvc -> decompress_video, bit-exact; prints
    the fps of each direction beside the card.  ``options`` go to the
    compressor (``devices=``, ``batch_size=``)."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    comp = ImprovedVideoCompressor(device=dev, **options)
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


def path_launches(label: str, needed):
    """Launch counts of the path run just driven; raises if a kernel in
    ``needed`` was not launched."""
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    launches = bk.launches()
    log(f"  {label} kernel launches: {launches}")
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label} never launched {missing}")
    return launches


def phase_main_path(dev, bench_frames, pan_frames, tmp, card):
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    bk.reset_launches()
    round_trip("phase 3 static 1080p (bench clip)", bench_frames, dev,
               os.path.join(tmp, "static.bfvc"), card)
    pan_hist = round_trip("phase 4 pan 1080p (synthetic, seed 0)",
                          pan_frames, dev, os.path.join(tmp, "pan.bfvc"),
                          card)
    launches = path_launches("main path", ["blocked_encode_h",
                                           "blocked_membership_h",
                                           "blocked_expand_chain",
                                           "blocked_expand"])
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


# ---------------------------------------------------------------------------
# Phases 6-7: the multi-device paths
# ---------------------------------------------------------------------------

def mesh_devices(n: int):
    """n distinct cards where the machine has them, else card 0 n times;
    and whether they are distinct."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], True
    return [torch.device("cuda", 0)] * n, False


def phase_dryrun(nb: int):
    """graft_entry.dryrun_blocked_dp on a dp = 4 mesh; every sharded
    output must equal the unsharded wrappers' on the same inputs."""
    import torch
    from new_bloom_filter_repo_tpu_torch import graft_entry
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh

    devs, distinct = mesh_devices(4)
    mesh = make_mesh(4, 1, devs)
    log(f"  layout dp=4 sp=1 over {[str(d) for d in devs]} "
        f"(distinct cards: {distinct}), nb={nb}")
    bk.reset_launches()
    t0 = time.perf_counter()
    out = graft_entry.dryrun_blocked_dp(mesh, nb=nb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches("dry run", ["blocked_encode",
                                         "blocked_membership",
                                         "blocked_expand"])
    bits, a, b, act, vals, m, fk = out["args"]
    words, wit, _, vseg, _ = want_enc = bk.blocked_encode(
        *out["args"], k_lanes=2, vh=4)
    passes, wcnt = bk.blocked_membership(words, a, b, act, m, fk,
                                         out["flags"], k_lanes=2)
    want_dec = (passes, wcnt) + bk.blocked_expand(
        passes, wit, torch.zeros_like(bits), out["flags"], vseg, vh=4)
    torch.cuda.synchronize()
    err = max(max_abs_err(out["encoded"], want_enc),
              max_abs_err(out["decoded"], want_dec))
    log(f"  dry run {bits.shape[0]} frames x {nb} blocks: mask == bits; "
        f"sharded vs unsharded max_abs_err={err}; wall {wall:.3f} s "
        f"including the host's input generation")
    if err != 0:
        raise AssertionError(f"sharded dry run differs from unsharded: "
                             f"max_abs_err={err}")
    return launches


def phase_devices(dev, bench, pan, tmp, card):
    """devices=: each mesh layout's stream must equal one device's."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh

    one = [torch.device("cuda", 0)]
    layouts = [("bench clip", bench, make_mesh(2, 2, one * 4), "static"),
               ("pan clip", pan, make_mesh(2, 1, one * 2), "pan")]
    if torch.cuda.device_count() >= 2:
        devs, _ = mesh_devices(4 if torch.cuda.device_count() >= 4 else 2)
        layouts.append(("bench clip, distinct cards", bench,
                        make_mesh(2, len(devs) // 2, devs), "static"))
    k4 = make_bench_clip(5, h=2 * H, w=2 * W)
    round_trip("4K 5 frames, one device", k4, dev,
               os.path.join(tmp, "k4_single.bfvc"), card, batch_size=4)
    devs, _ = mesh_devices(2)
    layouts.append(("4K 5 frames", k4, make_mesh(1, 2, devs), "k4_single"))

    bk.reset_launches()
    for label, frames, mesh, ref in layouts:
        distinct = len(mesh.distinct_devices()) > 1
        path = os.path.join(tmp, f"mesh_{ref}.bfvc")
        kw = {"batch_size": 4} if ref == "k4_single" else {}
        round_trip(f"phase 7 {label} on {mesh} (distinct cards: "
                   f"{distinct})", frames, None, path, card, devices=mesh,
                   **kw)
        with open(path, "rb") as x, open(os.path.join(tmp, f"{ref}.bfvc"),
                                         "rb") as y:
            if x.read() != y.read():
                raise AssertionError(f"{label}: the mesh stream differs "
                                     f"from the single-device stream")
        log("    .bfvc byte-identical to the single-device file")
    return path_launches("devices=", ["blocked_encode_h",
                                      "blocked_membership_h",
                                      "blocked_expand_chain",
                                      "blocked_expand"])


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
            r"Compiling entry function '\S*?(k\d[ab]?_[a-z_]+)\S*'.*?"
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
        runs = [phase_main_path(dev, bench, pan, tmp, smi)]
        log("phase 5 parity:")
        phase_parity(dev, tmp)
        log(f"phase 6 mesh dry run ({smi}):")
        runs.append(phase_dryrun(nb=2032))
        log(f"phase 7 devices= ({smi}):")
        runs.append(phase_devices(dev, bench, pan, tmp, smi))
    launches = {n: sum(r[n] for r in runs) for n in KERNELS}

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
