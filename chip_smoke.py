#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --mesh-processes-only
    python3 chip_smoke.py --tools-only
    python3 chip_smoke.py --profile-phase-a

Drives the port's main path, ``ImprovedVideoCompressor(device="cuda")``
(blocked profile, exact, motion on), through ``compress_video`` and
``decompress_video`` at 1080p, its multi-device paths (the mesh dry
runs and ``devices=``), its other profiles and modes and its file paths
(the command line, Y4M / raw YUV / EXR in and out), after building
the hand-written Hopper kernels K1-K8 from
``new_bloom_filter_repo_tpu_torch/ops/csrc`` and holding each against
its plain PyTorch twin on the card.  Phases:

1. device: the card, its power limit, the kernel build;
2. kernel vs twin.  First phase A, whose outputs are K1's inputs
   below: K7 (the motion search's counts), K8 (the residual trials'
   per-tile search) and K6 (masks, counts and packed pixels) against
   their twins, tolerance 0, on the first chunk (F = 15) of the 1080p
   bench clip and of the pan clip with motion on (K7 at the path's
   stride, K8 at its tile side, K6 on the shifts the search picks and
   with no shifts), on the same chunks of the other paths below (the
   planar U plane, each byte-view clip), on a 4K chunk (the first 16
   frames of the 4K bench batch) and on ``tools/bench.py``'s batches
   without motion (1080p x 120, 4K x 24), each call timed warm and cold
   with its twin, bytes, operations and bound (K7 beside its PR 13
   time).  Then K1-K5b at the 1080p chunk
   shapes (F = 15, NB = 2032), on the inputs of a real chunk and on a mix with edge-case filter widths,
   pass-through flags and raw masks, at the shapes the other paths
   give the kernels: the first chunk of the phase-8 U plane (960x540,
   NB = 512) and of each phase-9 clip's byte view (NB = 12152, 24304
   and 8104), and on the m sweep: every sub-filter width the stream
   admits (m = 1 and 16..384) over 25 launches of 15 frames at NB = 64,
   then F = 1, F = 16, NB = 1 and NB = 513; K3 and K4 also on inputs
   made directly (every, no, half and few items passing, more changed
   items than value slots, alternating flagged frames, F = 1 and 17, NB
   = 1 and 2033); exact equality (tolerance 0); K5a and K5b run on the
   ``_frame_mod_tables`` of the same inputs and must also equal K1 and
   K2.  On the real chunk each kernel is timed warm (mean of 20 launches
   queued behind a spin of the card, so the host's launch cost does not
   show) and cold (each launch after a 128 MiB write that evicts the
   L2, the launch alone timed), K1-K4 also with a part of their work
   taken away (the "parts" line), and the bytes each kernel must move
   give its bound at the H100's 3.35 TB/s; then K1, K2 and K3 on the
   batches of ``tools/bench.py`` as its codec program gives them (the
   1080p clip's 120 inter frames, F = 120 and NB = 2032, and the 4K
   clip's 24, F = 24 and NB = 8104), tolerance 0, each timed warm and
   cold with its bound, and K3's decoded batch equal to phase A's packed
   pixels;
3. the bench clip (1920x1080x3, 31 frames), round trip bit-exact;
4. the synthetic ``pan`` clip (seed 0, 31 frames, 1080p), round trip
   bit-exact, with type-6 motion records; then 8 frames of the ``zoom``
   class at 1080p, whose residual trials run the per-tile search (K8),
   round trip bit-exact and ``.bfvc`` byte-identical to the CPU port's;
   the launches of each kernel per clip of phases 3 and 4 are printed;
5. CIF clips (352x288, 16 frames) encoded on the card and on the CPU
   (the twins and the CPU torch ops) to identical ``.bfvc`` bytes: the
   blocked profile, ``profile="planar"`` (I420), uint16 frames (the
   byte view), ``profile="bfv2"`` and ``exact=False``; and the committed
   JAX-written fixture decoded bit-exactly;
6. the mesh dry run ``graft_entry.dryrun_blocked_dp`` on a dp = 4 mesh
   (four cards where the machine has them, else one card four times)
   at nb = 2032, 8 frames: K5a encode, K5b + K4 decode, mask == bits,
   and every sharded output equal to the unsharded wrappers';
7. ``devices=``: the phase-3 clip on a (2, 2) mesh and the phase-4 clip
   on a (2, 1) mesh, each ``.bfvc`` byte-identical to the single-device
   file and decoded bit-exactly through the mesh; the same over
   distinct cards where the machine has two or more; one 3840x2160x3
   chunk of 5 frames on a (1, 2) mesh, byte-identical to one device;
8. ``profile="planar"``: an I420 clip of 8 frames (Y 1920x1080, U and V
   960x540, from the ``pan`` class with 2x2-subsampled chroma), round
   trip plane-exact;
9. the byte view: three 1920x1080 clips of 16 frames (x3 uint16 with
   10-bit content, x3 float32 with NaNs, x4 uint8), round trips
   ``tobytes``-exact;
10. ``profile="bfv2"``: 16 frames of the bench clip, type-0 records with
    a witness, round trip bit-exact; the same clip with ``devices=(2,
    1)`` (distinct cards where the machine has them) byte-identical;
    ``graft_entry.dryrun_multichip`` over four distinct cards, else a
    (2, 2) mesh on one card; the gop torch ops timed at the chunk shape;
11. ``exact=False`` on 16 bench-clip frames at 1080p, decode equal to the
    encoder's own reconstruction, the first frame's noise sigma on the
    card and on the CPU; ``mode="keyframe"`` on the golden frames writes
    ``tests/fixtures/golden_ref.bfvc`` byte for byte; ``BloomCompressor``
    decodes the golden text and binary fixtures and re-encodes the
    binary one byte for byte; a 1920x1080 binary array at density 0.05
    round-trips through ``BloomFilterCompressor(device="cuda")``; the
    bloom_core and median torch ops timed at 1080p;
12. stress of the kernels whose shared-memory buffers are rewritten
    within a launch (K1 and K5a double-buffer the sub-filter, K3 and K4
    double-buffer by frame parity, K7 and K8 land previous rows ahead of
    the row they pack and K8 alternates two sets of tile counts): 60
    seeded mixes a kernel (NB 64 to 513, F of 1, 2, 15, 16 and 17, m
    across 1 and 16..384, change and pass densities from none to every
    item, alternating flagged frames, vh of 1, 4 and 16 with more
    changes than slots; K7 and K8 on frames of 1-3 bytes a pixel from 24
    x 37 to 276 x 669 at stride 4 and 8, K8's tiles 4 to 64 pixels),
    each launched 320
    times: a round launches all 60 back to back behind a spin of the
    card, in a new order, and then holds every launch to its twin's
    outputs with tolerance 0; 200 rounds on one stream, 80 beside a
    second stream busy with matrix products and a streaming add, 40
    with the launches split over two streams.  A launch that differs
    fails the run with the mix's seed and shape.  This raises the odds
    of seeing a rare race; it does not prove there is none;
13. files in and out, on the card, through the port's command line with
    no ``--device``: (a) the phase-3 clip (31 frames) and 8 frames of
    the phase-4 clip written as 4:2:0 Y4M files, ``compress`` then
    ``decompress`` to a Y4M file byte-identical to the input, with each
    direction's fps and the time its file reads and writes took; (b) 8
    frames of the pan clip as raw I420 and as YV12 through
    ``process-yuv`` (the planar profile) and ``decompress`` to a
    byte-identical ``.yuv``; (c) 4 float32 frames with NaNs written as
    EXR (zip) into a directory, read through
    ``extract_frames_from_video``, round trip ``tobytes``-exact through
    the byte view, and ``golden_piz.exr`` against its expected array;
    (d) ``synthetic``, ``analyze`` and ``analyze-stream --json`` return 0
    and ``verify_harness.test_true_lossless`` passes on (a)'s static
    file; (e) ``profiling.measure_host_stages`` on the bench clip's
    first chunk, and a compress + decompress of 16 bench frames under
    ``profiling.trace``, whose Chrome trace gives the card's busy share
    (kernel and copy time over the wall).  None of it needs cv2, PIL or
    matplotlib;
14. a mesh across processes: two children of this script (``--mesh-child
    RANK PORT DIR``) each join through ``initialize_distributed``
    ("127.0.0.1:PORT", 2, RANK), build a dp = 2 mesh with one cell a
    process (both on ``cuda:0`` on one card, which takes the staged
    transport over gloo; rank r on ``cuda:r`` on two or more cards,
    which takes NCCL), and after a CIF warm-up each compresses the
    phase-3 and phase-4 clips (31 frames, 1080p) through
    ``ImprovedVideoCompressor(devices=mesh)`` to a file of its own and
    decompresses it through the mesh, bit-exact.  Each prints its
    launches of K1-K4, its fps, the transport and the seconds, calls
    and bytes of the cross-process hop.  Both children's files must
    equal the single-device files of phases 3-4 byte for byte.  A child
    that exits non-zero, outlives 300 s or writes another file fails
    the run;
15. damaged streams through the kernels: the parent writes damaged
    files and a manifest, and one child of this script
    (``--damaged-child MANIFEST``) decodes each on cuda:0 and prints one
    line a trial (its outcome, the sha256 of its frames, the k_lanes of
    each K2 launch).  A trial that prints nothing within 60 s (a hung
    kernel), a child that dies and a CUDA fault (uncaught: the child
    synchronises after every trial) fail the run, naming the trial's
    field and seed.  CIF (352x288, 16 frames) blocked static and pan,
    bfv2, planar I420 and uint16 streams, each with 8 seeded random
    flips (the JAX package's recipe) and edits of the first inter
    record's k (40.5, 2e6, 0), m, bitmap_bits, witness_bits and type-6
    shift (+-32767): every outcome and frame hash must equal the port's
    CPU decode of the same bytes in the parent.  The 1080p files of
    phases 3-4 with k = 40.5, 2e6 and 0 and 4 flips each: each must end,
    K2 never past 32 lanes; the k trials also against a CPU decode where
    the time allows.  Then the child decodes the clean 1080p static file
    bit-exactly after a synchronize, and K2, K3 and K4 must each have
    run on damaged input;
16. the repository's tools on the card (``new_bloom_filter_repo_tpu_
    torch/tools``), with no ``--device``: (a) ``tools.bench.main()``
    prints its JSON line: the codec program (K1 -> K2 -> K3 -> on-device
    check) over the resident 1080p batch of 120 frames and the 4K batch
    of 24, the production schedule at both sizes, ``e2e_fps`` on 16
    frames and the host stages; every ``lossless`` and
    ``production_measured`` must be true and ``value_4k`` set; then the
    card work that one ``encode_chunk_begin`` finish() queues, from a
    profiler trace of it; (b) ``tools.benchmark_stages.main(["--frames",
    "120", "--host", "--prefetch-compare"])`` returns 0 and prints its
    stage lines; (c) ``tools.benchmark_compression.main`` with
    ``--synthetic`` on the 8-class CIF suite (60 frames a clip), codecs
    bloom, bloom-planar and keyframe, every clip lossless, with its
    table; static_gentle, pan and noise_storm at 16 frames on the card
    and on the CPU, every ratio equal; K4's launches by clip.

Phases 8-11 time each round trip once as it is (the path's fps) and
then once more under a stage timer, which synchronises the card around
its device stages, for the breakdown of where the time goes.

Phases 3, 4, 6, 7, 8, 9, 13 (a)-(c), 14 and 16 are the paths of the kernels:
every kernel's launch count is set to 0 just before each and read just
after, and a kernel its path must launch that it did not fails the run
(K1-K3 on phase 3; K1, K2 and K4 on phase 4's pan clip, K1 and K8 on
its zoom clip; K5a, K5b and K4 on phase 6; K1-K4 on phase 7; K1, K2 and K3 or K4 on phases 8 and 13 (a); K1-K3
on phases 9 and 13 (c); K1 and K2 on phase 13 (b); in each child of
phase 14, K1-K3 on the static clip and K1, K2 and K4 on the pan clip;
K1-K3 on phase 16 (a) and (b), whose launches the ``kernels`` line also
gives by part, with (c)'s; and K6 and K7 on every one of these but
phase 6, whose dry run makes its inputs without phase A: each encodes
frames of at least 28 x 28 pixels with motion on).
Every phase that fails raises; nothing falls back to the CPU.
The second-to-last lines are the
per-kernel JSON (launches summed over the path runs) and the card's
name and power limit; the last line is ``{"ok": true, "device":
{...}}``.  Beside the contract's keys, each kernel's entry carries the
``bytes`` (and K7's and K8's ``operations``: a compare and an add for
each candidate of each sample, held to OPS_PER_S) behind ``bound_ms``,
``cold_ms``, its ptxas registers and
spill bytes, K1-K3's records at the bench batches
(``at_bench_batches``) and the launches of phase 16 by part
(``launches_in_tools``).  Exits non-zero without a CUDA card.

``--kernels-only`` stops after phase 2 and prints no JSON: a copy of
this script put at the root of another checkout (an older commit)
times that checkout's kernels the same way, in the same call.
``--profile-phase-a`` runs phase 1, then phase A under ``utils/
profiling.trace`` (``_phase_a`` on the 1080p x 120 bench batch,
``_phase_a_auto`` and ``_tile_motion_best`` on its first 15-frame
chunk: the top five device ops), the codec program's fps on that batch three times and
``tools.benchmark_stages --frames 120``, and prints no JSON; it too runs
from the root of an older checkout (the port since its tools).
``--mesh-processes-only`` runs phases 1, 3-4 and 14 and prints no JSON:
the call to make on a machine with several cards, where phase 14 takes
NCCL between two cards.  ``--damaged-only`` runs phases 1 and 15 on the
CIF streams alone (its clean stream is the CIF static one) and prints
no JSON.  ``--tools-only`` runs phases 1 and 16 and prints no JSON.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_pan.bfvc")
CSRC = "new_bloom_filter_repo_tpu_torch/ops/csrc/blocked.cu"
CSRC_PHASE_A = "new_bloom_filter_repo_tpu_torch/ops/csrc/phase_a.cu"
TPU_KERNELS = "new_bloom_filter_repo_tpu/ops/pallas/blocked.py"
JAX_PIPELINE = "new_bloom_filter_repo_tpu/models/blocked_pipeline.py"
# kernel wrapper name -> (short name, what it replaces: the pallas_call
# of a TPU kernel, or for K6-K8 the JAX function that XLA compiled; the
# kernel's entry function; its source)
KERNELS = {
    "blocked_encode_h": ("K1", f"{TPU_KERNELS}:660", "k1_encode", CSRC),
    "blocked_membership_h": ("K2", f"{TPU_KERNELS}:703", "k2_membership",
                             CSRC),
    "blocked_expand_chain": ("K3", f"{TPU_KERNELS}:832", "k3_expand_chain",
                             CSRC),
    "blocked_expand": ("K4", f"{TPU_KERNELS}:774", "k4_expand", CSRC),
    "blocked_encode": ("K5a", f"{TPU_KERNELS}:595", "k5a_encode", CSRC),
    "blocked_membership": ("K5b", f"{TPU_KERNELS}:740", "k5b_membership",
                           CSRC),
    # _phase_a_pair; _phase_a_motion_pair (:681) too
    "phase_a_diff": ("K6", f"{JAX_PIPELINE}:359", "k6_phase_a_diff",
                     CSRC_PHASE_A),
    "motion_counts": ("K7", f"{JAX_PIPELINE}:406", "k7_motion_counts",
                      CSRC_PHASE_A),
    "tile_motion_best": ("K8", f"{JAX_PIPELINE}:528", "k8_tile_motion_best",
                         CSRC_PHASE_A),
}
# The phase-A kernels; K1-K5b are BLOCKED_KERNELS
PHASE_A_KERNELS = ("phase_a_diff", "motion_counts", "tile_motion_best")
BLOCKED_KERNELS = tuple(k for k in KERNELS if k not in PHASE_A_KERNELS)
# The phase-A kernels every path that encodes with motion on launches
# (K8 runs only where the residual trials reach the per-tile search)
PATH_PHASE_A = ("phase_a_diff", "motion_counts")
H, W = 1080, 1920
CHUNK = 15
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM, 32-bit operations outside the tensor cores (the float32 rate
# of NVIDIA's data sheet): the rate K7's and K8's compares and adds are
# held to
OPS_PER_S = 67e12
FLUSH_BYTES = 128 << 20       # > 2x the 50 MB L2
SPIN_CYCLES = 50_000_000      # ~25 ms of card time to queue launches behind
T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line also says how long the script
    has run."""
    if msg.startswith("phase"):
        msg += f" [{time.perf_counter() - T_START:.1f} s in]"
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


def edge_mix_args(tab, m, dev, seed=1, nb=None):
    """K1 arguments over the first ``nb`` (default all) blocks of ``tab``
    with the per-frame sub-filter bits ``m`` (one frame each): floor k
    from 0 to 12, per-frame change densities from 0.1% to 30%, random
    activation thresholds; vh = 32 so every change fits."""
    import torch

    rng = np.random.default_rng(seed)
    nb = tab["nb"] if nb is None else nb
    m = np.asarray(m, dtype=np.int32)
    f = len(m)
    fk = (np.arange(f) % 13).astype(np.int32)
    thi = rng.integers(0, 1 << 32, f, dtype=np.uint64).astype(np.uint32)
    tlo = rng.integers(0, 1 << 32, f, dtype=np.uint64).astype(np.uint32)
    dens = np.geomspace(0.001, 0.3, f)[:, None, None]
    bits = (rng.random((f, nb, 1024)) < dens).astype(np.uint8)
    vals = rng.integers(0, 1 << 24, (f, nb, 1024), dtype=np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    args = (t(bits), *(tab[k][:nb] for k in ("h1", "h2", "act_hi",
                                              "act_lo")),
            t(vals), t(m), t(thi.view(np.int32)), t(tlo.view(np.int32)),
            t(fk))
    return args, {"k_lanes": int(fk.max()), "vh": 32,
                  "nw": (int(m.max()) + 31) // 32}


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after one
    warm-up call, timed with CUDA events.  The calls are queued behind a
    spin of the card, so the host's launch overhead does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, each after
    a write of FLUSH_BYTES to a scratch tensor (which evicts the 50 MB
    L2), timed with CUDA events around the call alone."""
    import torch

    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for i, (start, end) in enumerate(events):
        scratch.fill_(i)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


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
    """[(name, kernel call, twin call)] for K1-K5b on one input mix, the
    mix's flags, and K4's inputs and K3's base on it.  The decode kernels take K1's outputs (the twin's,
    which the kernel must equal); K5a and K5b take the
    ``_frame_mod_tables`` of K1's and K2's inputs; with ``flagged``,
    every third frame is a pass-through frame with a random raw mask."""
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
    ], flags, exp, base


# K5a/K5b must equal K1/K2 on the materialized tables of the same inputs
SAME_AS = {"blocked_encode": "blocked_encode_h",
           "blocked_membership": "blocked_membership_h"}


def sweep_mixes(dev):
    """(label, K1 args, K1 kwargs, flagged) of the m sweep: every m the
    stream can hold (1 and MIN_M = 16 to 384) in ascending order over 25
    launches of 15 frames at NB = 64, then the shapes F = 1, F = 16,
    NB = 1 and NB = 513 (not a multiple of any frame group) at random
    such m, with pass-through frames."""
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables

    ms = [1] + list(range(16, 385))
    ms += ms[-(25 * CHUNK - len(ms)):]
    small = blocked_tables(64 * 1024, dev)
    for i in range(25):
        m = ms[i * CHUNK:(i + 1) * CHUNK]
        yield (f"m sweep {i + 1}/25 (m {m[0]}..{m[-1]})",
               *edge_mix_args(small, m, dev, seed=10 + i), False)
    rng = np.random.default_rng(7)
    wide = blocked_tables(520 * 1024, dev)
    for label, tab, f, nb in (("F=1", small, 1, 64), ("F=16", small, 16, 64),
                              ("NB=1", small, CHUNK, 1),
                              ("NB=513", wide, CHUNK, 513)):
        yield (f"shape {label}",
               *edge_mix_args(tab, rng.choice(ms, f), dev, seed=40, nb=nb),
               True)


def kernel_bytes(enc_args, kw, flags, want):
    """Bytes each kernel must move on one mix: every input it needs read
    once, every output written once.  Counted as this mix's data needs
    them: values of the changed items only (up to the segment's slots),
    sub-filter words, hash or position tables and witness segments of
    unflagged frames only, raw masks of flagged frames only.  ``want``:
    the twins' outputs by wrapper name."""
    f, nb, ipb = enc_args[0].shape
    items = f * nb * ipb
    nw, vslots = kw["nw"], kw["vh"] * 32
    words, wit, wcnt, vseg, vcnt = want["blocked_encode_h"]
    fl = int((flags != 0).sum())
    fu = f - fl
    enc_out = (4 * words.numel() + wit.numel() + 4 * wcnt.numel()
               + 4 * vseg.numel() + 4 * vcnt.numel())
    chg_vals = 4 * int(vcnt.clamp(max=vslots).sum())
    tables = 16 * nb * ipb
    mask = want["blocked_expand"][0]
    mask_vals = 4 * int(mask.sum(dim=-1).clamp(max=vslots).sum())
    expand_in = (fu * nb * (ipb + 128) + fl * nb * ipb + 4 * f
                 + mask_vals)
    mem_out = items + 4 * f * nb
    return {
        "blocked_encode_h": items + tables + chg_vals + 16 * f + enc_out,
        "blocked_membership_h": (4 * nw * fu * nb + (tables if fu else 0)
                                 + 20 * f + mem_out),
        "blocked_expand_chain": expand_in + 4 * nb * ipb + 4 * items,
        "blocked_expand": expand_in + items + 4 * items,
        "blocked_encode": 10 * items + chg_vals + 8 * f + enc_out,
        "blocked_membership": (4 * nw * fu * nb + 9 * fu * nb * ipb
                               + 12 * f + mem_out),
    }


def time_parts(enc_args, kw, words, exp, base, mask, reps):
    """Each kernel of the main path on the real chunk with one part of
    its work taken away, to show where its time goes: K1 with no changed
    item (no OR-insert, witness bit or value), K1 with vh = 1 (32 value
    slots a block in place of vh * 32), K2 with every frame flagged (no
    membership test; the passes are zeros); K3 and K4 with every frame
    flagged and the chunk's own change mask as the raw mask (no pass
    ranks, no witness bits; the same values), with vh = 1 (the value
    segment cut to 32 slots), and with no passing item (no changed item,
    so no value).  ``exp``: K4's inputs on the chunk (passes, wit, raw,
    flags, vseg); ``mask``: its mask."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    bits, h1, h2, ahi, alo, _, m, thi, tlo, fk = enc_args
    none = (torch.zeros_like(bits),) + tuple(enc_args[1:])
    flags = torch.ones(bits.shape[0], dtype=torch.int32, device=bits.device)
    mem = (words, h1, h2, ahi, alo, m, thi, tlo, fk, flags)
    passes, wit, _, _, vseg = exp
    parts = {
        "every frame flagged": (passes, wit, mask, flags, vseg),
        "vh = 1": (passes, wit, exp[2], exp[3],
                   vseg[..., :32].contiguous()),
        "no passing item": (torch.zeros_like(passes),) + tuple(exp[1:])}
    out = {
        "K1 with no changed item": time_ms(
            lambda: bk.blocked_encode_h(*none, **kw), reps),
        "K1 with vh = 1": time_ms(
            lambda: bk.blocked_encode_h(*enc_args, **{**kw, "vh": 1}), reps),
        "K2 with every frame flagged": time_ms(
            lambda: bk.blocked_membership_h(*mem, k_lanes=kw["k_lanes"],
                                            nw=kw["nw"]), reps)}
    for label, args in parts.items():
        vh = 1 if label == "vh = 1" else kw["vh"]
        out[f"K3 with {label}"] = time_ms(
            lambda: bk.blocked_expand_chain(*args, base, vh=vh), reps)
        out[f"K4 with {label}"] = time_ms(
            lambda: bk.blocked_expand(*args, vh=vh), reps)
    return out


def expand_edge_inputs(f, nb, vh, dens, flagged, dev, seed=0):
    """K3/K4 inputs made directly (passes, wit, raw, flags, vseg, base),
    as tests/test_torch_cuda.py makes them: frame i passes items at
    density ``dens[i % len(dens)]`` (1: every item, 0: none); block 0
    has every witness bit set, so with every item passing its rank-1023
    item reads the last bit; the ``flagged`` frames take a raw mask of
    density 0.4 (unflagged frames carry one too, which they must
    ignore); ``vh`` may leave fewer value slots than changed items."""
    import torch

    rng = np.random.default_rng(seed)
    d = np.resize(np.asarray(dens, np.float64), f).reshape(-1, 1, 1)
    passes = (rng.random((f, nb, 1024)) < d).astype(np.uint8)
    wit = rng.integers(0, 256, (f, nb, 128), dtype=np.uint8)
    wit[:, 0] = 0xFF
    flags = np.zeros(f, np.int32)
    flags[list(flagged)] = 1
    raw = (rng.random((f, nb, 1024)) < 0.4).astype(np.uint8)
    vseg = rng.integers(0, 1 << 24, (f, nb, vh * 32), dtype=np.int32)
    base = rng.integers(0, 1 << 24, (nb, 1024), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (passes, wit, raw, flags, vseg, base))


# K3/K4 edge inputs (F, NB, vh, pass densities by frame, flagged frames):
# every, no, half and few items passing; alternating flagged frames; F =
# 1 and 17 (odd: the last trip of the unrolled frame loop runs one
# frame); NB = 1 and 2033; vh = 4 and 1 leave fewer value slots than
# changed items.
EXPAND_EDGES = {
    "F=17 NB=2033 vh=4, all/none/half/few passing, odd frames flagged":
        (17, 2033, 4, [1.0, 0.0, 0.5, 0.03], range(1, 17, 2)),
    "F=1 NB=2033 vh=32, every item passing":
        (1, 2033, 32, [1.0], []),
    "F=17 NB=1 vh=32": (17, 1, 32, [1.0, 0.5, 0.0], range(0, 17, 3)),
    "F=1 NB=1 vh=1, every item passing": (1, 1, 1, [1.0], []),
}


def expand_edges(dev, out):
    """K3 and K4 against their twins on EXPAND_EDGES (tolerance 0);
    folds each error into ``out``'s records."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    for label, spec in EXPAND_EDGES.items():
        *exp, base = expand_edge_inputs(*spec, dev, seed=3)
        vh = spec[2]
        errs = {
            "blocked_expand_chain": max_abs_err(
                bk.blocked_expand_chain(*exp, base, vh=vh),
                bk.blocked_expand_chain_ref(*exp, base, vh=vh)),
            "blocked_expand": max_abs_err(bk.blocked_expand(*exp, vh=vh),
                                          bk.blocked_expand_ref(*exp,
                                                                vh=vh))}
        torch.cuda.synchronize()
        for name, err in errs.items():
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        log(f"  mix K3/K4 edge {label}: K3 max_abs_err="
            f"{errs['blocked_expand_chain']}, K4 max_abs_err="
            f"{errs['blocked_expand']}")
        if any(errs.values()):
            raise AssertionError(f"K3/K4 disagree with their twins on the "
                                 f"edge input {label}: {errs}")


def phase_kernels(dev, frames, path_chunks=(), reps: int = 20,
                  twin_reps: int = 3):
    """Every kernel against its twin on the first chunk of ``frames``, on
    an edge mix at its shape, on the first chunk of each clip of
    ``path_chunks`` ((label, frames) at the other paths' shapes) and on
    the m sweep, each mix built just before it runs; returns {wrapper
    name: {max_abs_err, ms, plain_ms, cold_ms, bytes, bound_ms}}
    (times and bytes from the first chunk of ``frames``)."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables

    def mixes():
        # (label, args, kwargs, flagged, seed of the raw masks, quiet)
        yield ("real chunk", *chunk_args(frames, dev), False, 0, False)
        h, w = frames[0].shape[:2]
        tab = blocked_tables(h * w, dev)
        yield ("edge mix + flags",
               *edge_mix_args(tab, np.linspace(16, 384, CHUNK).round(), dev),
               True, 2, False)
        for label, clip in path_chunks:
            yield (label, *chunk_args(clip, dev), False, 0, False)
        for label, args, kw, flagged in sweep_mixes(dev):
            yield (label, args, kw, flagged, 3, True)

    out = {}
    for label, args, kw, flagged, seed, quiet in mixes():
        bits = args[0]
        head = (f"  mix {label}: F={bits.shape[0]} NB={bits.shape[1]} "
                f"k_lanes={kw['k_lanes']} nw={kw['nw']} vh={kw['vh']}")
        if not quiet:
            log(head)
        got_by_name, want_by_name, worst = {}, {}, 0
        cases, flags, exp, base = kernel_cases(args, kw, dev, flagged, seed)
        for name, kern, twin in cases:
            got = kern()
            want = twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            got_by_name[name], want_by_name[name] = got, want
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
                rec["cold_ms"] = time_cold_ms(kern, reps)
                line += (f", kernel after an L2 flush "
                         f"{rec['cold_ms']:.4f} ms")
            if not quiet:
                log(line)
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin or "
                                     f"its hash-prelude kernel on {label}: "
                                     f"max_abs_err={err}")
        if quiet:
            log(f"{head}: all six max_abs_err={worst}")
        if label == "edge mix + flags":
            expand_edges(dev, out)
        if label == "real chunk":
            parts = time_parts(args, kw, want_by_name["blocked_encode_h"][0],
                               exp, base, want_by_name["blocked_expand"][0],
                               reps)
            log("    parts: " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in parts.items()))
            for name, n in kernel_bytes(args, kw, flags,
                                        want_by_name).items():
                out[name]["bytes"] = n
                out[name]["bound_ms"] = n / HBM_BYTES_PER_S * 1e3
                log(f"    {KERNELS[name][0]} moves {n} bytes: bound "
                    f"{out[name]['bound_ms']:.4f} ms at "
                    f"{HBM_BYTES_PER_S / 1e12} TB/s, kernel at "
                    f"{out[name]['bound_ms'] / out[name]['ms']:.3f} of it")
    return out


# ---------------------------------------------------------------------------
# Phase 2, first: phase A's kernels K6 and K7 against their twins
# ---------------------------------------------------------------------------

def phase_a_bytes(stacked, nb, shifts):
    """Bytes K6 must move on a stacked (F+1, h, w[, c]) chunk: each frame
    read once (frame j is pair j's previous and pair j-1's current), the
    shifts, and the masks, counts and values written once."""
    f = stacked.shape[0] - 1
    npad = nb * 1024
    return (stacked.numel() + (0 if shifts is None else 8 * f)
            + f * npad + 4 * f * nb + 4 * f * npad)


def motion_bytes(stacked, stride, out_bytes):
    """Bytes K7 or K8 must move on a stacked chunk: the F previous frames
    read once (at a stride of at most 2R + 1 every pixel lies within R
    of a sample row and column), the current frames' samples once, the
    ``out_bytes`` of output written once."""
    f, h, w = stacked.shape[0] - 1, stacked.shape[1], stacked.shape[2]
    c = stacked[0].numel() // (h * w)
    sh, sw = -(-h // stride), -(-w // stride)
    return f * h * w * c + f * sh * sw * c + out_bytes


def motion_ops(stacked, stride):
    """Operations K7 or K8 must do on a stacked chunk: a compare and an
    add for each of the 225 candidates of every sample."""
    from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa

    f, h, w = stacked.shape[0] - 1, stacked.shape[1], stacked.shape[2]
    return 2 * pa.CANDIDATES * f * -(-h // stride) * -(-w // stride)


# K7's warm ms on each phase-2 mix in PR 13's closing run (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md), printed beside this run's
K7_PR13_MS = {"1080p static chunk (bench clip)": 0.1463,
              "1080p pan chunk": 0.1480, "planar U plane chunk": 0.0897,
              "byte view uint16 x3 (10-bit) chunk": 0.5972,
              "byte view float32 x3 (HDR, NaNs) chunk": 1.1744,
              "byte view uint8 x4 (BGRA) chunk": 0.3951}


def phase_a_cases(stacked, motion: bool):
    """[(name, label, kernel call, twin call, bytes, operations)] of
    K6-K8 on one stacked chunk: with ``motion``, K7 at the path's stride
    and K8 at the path's tile side (where the checkout has K8), then K6
    on the shifts the search picks from the twin's counts (the main
    path's call) and K6 with no shifts; without, K6 with no shifts (the
    codec program's call)."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa

    h, w = stacked.shape[1], stacked.shape[2]
    npad = bp.npad_of(h * w)
    nb = npad // 1024
    prev, curr = stacked[:-1], stacked[1:]
    cases = []
    if motion:
        stride = bp.motion_stride(h, w)
        counts = pa.motion_counts_ref(prev, curr, stride)
        shifts = torch_from(bp.choose_shifts(counts.cpu().numpy()),
                            stacked.device)
        f = prev.shape[0]
        cases.append(("motion_counts", f"stride {stride}",
                      lambda: pa.motion_counts(prev, curr, stride),
                      lambda: pa.motion_counts_ref(prev, curr, stride),
                      motion_bytes(stacked, stride, 4 * f * pa.CANDIDATES),
                      motion_ops(stacked, stride)))
        if hasattr(pa, "tile_motion_best"):
            tlog = bp.tile_log(h, w)
            spt = max(1, (1 << tlog) // stride)
            sh, sw = -(-h // stride), -(-w // stride)
            tiles = -(-sh // spt) * -(-sw // spt)
            cases.append(("tile_motion_best", f"tlog {tlog} stride {stride}",
                          lambda: pa.tile_motion_best(prev, curr, tlog=tlog,
                                                      stride=stride),
                          lambda: pa.tile_motion_best_ref(prev, curr, tlog,
                                                          stride),
                          motion_bytes(stacked, stride, 12 * f * tiles),
                          motion_ops(stacked, stride)))
        nz = int((shifts != 0).any(dim=1).sum())
        cases.append(("phase_a_diff", f"shifts from the search ({nz} of "
                      f"{shifts.shape[0]} frames shifted)",
                      lambda: pa.phase_a_diff(prev, curr, shifts, npad, nb),
                      lambda: pa.phase_a_diff_ref(prev, curr, shifts, npad,
                                                  nb),
                      phase_a_bytes(stacked, nb, shifts), 0))
    cases.append(("phase_a_diff", "no shifts",
                  lambda: pa.phase_a_diff(prev, curr, None, npad, nb),
                  lambda: pa.phase_a_diff_ref(prev, curr, None, npad, nb),
                  phase_a_bytes(stacked, nb, None), 0))
    return cases


def torch_from(arr, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def phase_phase_a(dev, mixes, reps: int = 10, twin_reps: int = 2):
    """K6-K8 against their twins on each (label, frames, motion, main)
    mix: the frames stacked on the card as one chunk (base and inter
    frames), tolerance 0, before their outputs feed K1; each kernel call
    timed warm and cold, its twin warm, its bytes, operations and bound
    (the larger of bytes over HBM_BYTES_PER_S and operations over
    OPS_PER_S); K7 beside its PR 13 time.  Returns {wrapper name:
    record}: the worst max_abs_err over every mix, the times and bound
    of the ``main`` mix's first call of each kernel, and every call's
    record under ``at_mixes``."""
    import torch

    out = {name: {"max_abs_err": 0, "at_mixes": {}}
           for name in PHASE_A_KERNELS}
    for label, frames, motion, main in mixes:
        stacked = torch_from(np.stack(frames), dev)
        f, h, w = stacked.shape[0] - 1, stacked.shape[1], stacked.shape[2]
        log(f"  mix {label}: F={f} {h}x{w} {tuple(stacked.shape[3:])} "
            f"motion={'on' if motion else 'off'}")
        for name, what, kern, twin, nbytes, ops in phase_a_cases(stacked,
                                                                motion):
            got, want = kern(), twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            del got, want
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = ops / OPS_PER_S * 1e3
            rec = {"max_abs_err": err, "bytes": nbytes, "operations": ops,
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops
                   else "operations",
                   "ms": time_ms(kern, reps),
                   "cold_ms": time_cold_ms(kern, reps),
                   "plain_ms": time_ms(twin, twin_reps)}
            out[name]["at_mixes"][f"{label}, {what}"] = rec
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            if main and "ms" not in out[name]:
                out[name].update({k: v for k, v in rec.items()
                                  if k != "max_abs_err"})
            before = ""
            if name == "motion_counts":
                before = (f"; PR 13: {K7_PR13_MS[label]:.4f} ms"
                          if label in K7_PR13_MS else "; PR 13: not measured")
            log(f"    {KERNELS[name][0]} {name} ({what}): max_abs_err="
                f"{err}; kernel {rec['ms']:.4f} ms, after an L2 flush "
                f"{rec['cold_ms']:.4f} ms, plain twin {rec['plain_ms']:.4f}"
                f" ms; {nbytes} bytes, {ops} operations, bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"({rec['bound_ms'] / rec['ms']:.3f} of it){before}")
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin on "
                                     f"{label} ({what}): max_abs_err={err}")
        del stacked
        torch.cuda.empty_cache()
    return out


def trace_top_ops(trace_dir, reps: int, top: int = 5):
    """(device ms a rep, [(name, ms a rep, calls a rep)] of the ``top``
    device ops by time) from the one Chrome trace in ``trace_dir``:
    kernels, copies and memsets."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"expected one trace file, found {files}")
    with open(os.path.join(trace_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    by_name = {}
    for ev in events:
        if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            us, calls = by_name.get(ev["name"], (0.0, 0))
            by_name[ev["name"]] = (us + float(ev.get("dur", 0)), calls + 1)
    if not by_name:
        raise AssertionError("the trace holds no device op")
    total = sum(us for us, _ in by_name.values()) / 1e3 / reps
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return total, [(name, us / 1e3 / reps, calls / reps)
                   for name, (us, calls) in ops]


def phase_a_profile(dev, card, reps: int = 5):
    """``--profile-phase-a``: phase A as the tools and the main path call
    it, under ``utils/profiling.trace`` (torch.profiler): ``_phase_a`` on
    tools/bench.py's 1080p batch (F = 120, C = 3), ``_phase_a_auto`` and
    the residual trials' ``_tile_motion_best`` on its first 15-frame
    chunk, ``reps`` calls each after a warm-up; prints the device ms a
    call and the top five device ops.  Then the
    torch-op programs next in line for a kernel at that chunk (the
    packed masks with and without motion, the per-tile motion summary,
    the decoder's roll chain), timed with CUDA events; the codec
    program's fps on that batch (``tools.bench.
    _device_codec_fps``, three runs: the headline ``value``) and
    ``tools.benchmark_stages --frames 120``'s stage lines.  Uses only
    names the port has had since its tools were ported, so a copy of
    this script at the root of an older checkout profiles that
    checkout's phase A the same way, in the same call."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.tools import bench as tb
    from new_bloom_filter_repo_tpu_torch.tools import benchmark_stages as tbs
    from new_bloom_filter_repo_tpu_torch.utils import profiling

    frames = tb.make_clip()
    stacked = torch_from(np.stack(frames), dev)
    h, w = stacked.shape[1], stacked.shape[2]
    tab = bp.blocked_tables(h * w, dev)
    npad, nb = tab["npad"], tab["nb"]
    stride = bp.motion_stride(h, w)
    runs = [
        ("_phase_a, F = 120", lambda: bp._phase_a(stacked, npad=npad,
                                                  nb=nb)),
        ("_phase_a_auto, F = 15", lambda: bp._phase_a_auto(
            stacked[:CHUNK + 1], stride=stride, npad=npad, nb=nb)),
        ("_tile_motion_best, F = 15", lambda: bp._tile_motion_best(
            stacked[:CHUNK + 1], tlog=bp.tile_log(h, w), stride=stride))]
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            dev_ms, ops = trace_top_ops(d, reps)
        log(f"  {label} at 1080p, C = 3 ({card}): device ops "
            f"{dev_ms:.4f} ms a call; top five by device time:")
        for name, ms, calls in ops:
            log(f"    {ms:9.4f} ms  {calls:5.1f} calls  {name[:110]}")
    # the torch-op programs next in line for a kernel (ROADMAP Queue 2)
    # at the main path's chunk, a pan of (1, 2) px a frame
    chunk = stacked[:CHUNK + 1]
    shifts = torch.tensor([[1, 2]] * CHUNK, dtype=torch.int32, device=dev)
    masks, _, vals = bp._phase_a_motion(chunk, shifts, npad=npad, nb=nb)
    host_shifts = shifts.cpu().numpy()
    for label, fn in (
            ("_phase_a_packed", lambda: bp._phase_a_packed(chunk,
                                                           npad=npad)),
            ("_phase_a_packed_motion", lambda: bp._phase_a_packed_motion(
                chunk, shifts, npad=npad)),
            ("_tile_motion_best", lambda: bp._tile_motion_best(
                chunk, tlog=bp.tile_log(h, w), stride=stride)),
            ("_chain_apply_motion", lambda: bp._chain_apply_motion(
                chunk[0], masks, vals, host_shifts,
                shape=tuple(chunk.shape[1:])))):
        log(f"  {label}, F = 15 at 1080p, C = 3: {time_ms(fn, 5):.4f} ms "
            f"a call (CUDA events, warm, queued behind a spin) ({card})")
    del stacked, chunk, masks, vals
    torch.cuda.empty_cache()
    for i in range(3):
        fps, lossless, _ = tb._device_codec_fps(frames, device=dev)
        log(f"  codec program, 1080p x 120 (tools.bench value), run {i}: "
            f"{fps} fps, a rep {120 / fps * 1e3:.3f} ms, lossless "
            f"{lossless} ({card})")
        if not lossless:
            raise AssertionError("the codec program was not lossless")
    log("  tools.benchmark_stages --frames 120:")
    if tbs.main(["--frames", "120"]) != 0:
        raise AssertionError("benchmark_stages failed")


def bench_batch_args(frames, dev):
    """The inputs ``tools/bench.py``'s codec program gives K1-K3 on the
    stacked batch ``frames`` (a base and F inter frames): phase A on the
    whole batch, then the host parameter math.  Returns (stacked, K1
    args, geometry)."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.tools import bench as tb

    h, w = frames[0].shape[:2]
    tab = bp.blocked_tables(h * w, dev)
    stacked = torch.from_numpy(np.stack(frames)).to(dev)
    masks, counts, vals = bp._phase_a(stacked, npad=tab["npad"],
                                      nb=tab["nb"])
    m, thi, tlo, fk, geom = tb.codec_params(counts.cpu().numpy(), h * w,
                                            tab["nb"])
    return stacked, (masks, tab["h1"], tab["h2"], tab["act_hi"],
                     tab["act_lo"], vals,
                     *bp.frame_scalars(dev, m, thi, tlo, fk)), geom


def phase_bench_shapes(dev, batches, reps: int = 10):
    """K1, K2 and K3 against their twins on the bench batches (label,
    frames) at the shapes ``tools/bench.py``'s codec program gives them
    (no flagged frame, no raw mask, K3 chained from the base frame),
    tolerance 0; each kernel timed warm and cold, its twin once, its
    bound from the bytes it must move.  The decoded batch must also
    equal phase A's packed pixels, as the program checks.  Returns
    {label: {wrapper name: {max_abs_err, ms, cold_ms, plain_ms, bytes,
    bound_ms}}}."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    out = {}
    for label, frames in batches:
        stacked, enc, geom = bench_batch_args(frames, dev)
        masks, h1, h2, ahi, alo, vals, m, thi, tlo, fk = enc
        f, nb, _ = masks.shape
        k_lanes, vh, nw = geom["k_lanes"], geom["vh"], geom["nw"]
        log(f"  mix {label}: F={f} NB={nb} k_lanes={k_lanes} nw={nw} "
            f"vh={vh}")
        want_enc = bk.blocked_encode_h_ref(*enc, **geom)
        words, wit, _, vseg, _ = want_enc
        flags = torch.zeros(f, dtype=torch.int32, device=dev)
        raw = torch.zeros((f, nb, bk.IPB), dtype=torch.uint8, device=dev)
        mem = (words, h1, h2, ahi, alo, m, thi, tlo, fk, flags)
        passes, _ = bk.blocked_membership_h_ref(*mem, k_lanes=k_lanes, nw=nw)
        base = bp._pack_base(stacked[0], npad=nb * bk.IPB, nb=nb)
        exp = (passes, wit, raw, flags, vseg, base)
        cases = [
            ("blocked_encode_h", lambda: bk.blocked_encode_h(*enc, **geom),
             lambda: bk.blocked_encode_h_ref(*enc, **geom)),
            ("blocked_membership_h",
             lambda: bk.blocked_membership_h(*mem, k_lanes=k_lanes, nw=nw),
             lambda: bk.blocked_membership_h_ref(*mem, k_lanes=k_lanes,
                                                 nw=nw)),
            ("blocked_expand_chain",
             lambda: bk.blocked_expand_chain(*exp, vh=vh),
             lambda: bk.blocked_expand_chain_ref(*exp, vh=vh))]
        # K4's mask on this batch is phase A's change mask (the decode is
        # exact), which is all kernel_bytes reads of K4's outputs
        nbytes = kernel_bytes(enc, geom, flags,
                              {"blocked_encode_h": want_enc,
                               "blocked_expand": (masks,)})
        recs = out[label] = {}
        for name, kern, twin in cases:
            got = kern()
            want = twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if name == "blocked_expand_chain" and not torch.equal(got, vals):
                raise AssertionError(f"{label}: K3's decoded batch differs "
                                     f"from phase A's packed pixels")
            del got, want
            rec = recs[name] = {"max_abs_err": err, "bytes": nbytes[name]}
            rec["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
            rec["plain_ms"] = time_ms(twin, 1)
            rec["ms"] = time_ms(kern, reps)
            rec["cold_ms"] = time_cold_ms(kern, reps)
            log(f"    {KERNELS[name][0]} {name}: max_abs_err={err}; kernel "
                f"{rec['ms']:.4f} ms, after an L2 flush "
                f"{rec['cold_ms']:.4f} ms, plain twin {rec['plain_ms']:.4f} "
                f"ms; {rec['bytes']} bytes, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_ms'] / rec['ms']:.3f} of it)")
            if err != 0:
                raise AssertionError(f"{name} disagrees with its twin on "
                                     f"{label}: max_abs_err={err}")
        del stacked, enc, want_enc, words, wit, vseg, mem, passes, exp
        torch.cuda.empty_cache()
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


def same_bits(a, b) -> bool:
    """Bit-pattern equality of two frames (NaN payloads included)."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def round_trip(label, frames, dev, path, card, color_space="BGR",
               **options):
    """compress_video -> .bfvc -> decompress_video, bit-pattern exact;
    prints the fps of each direction beside the card.  ``options`` go to
    the compressor (``devices=``, ``batch_size=``, ``profile=``).
    Returns (record histogram, decoded frames)."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    comp = ImprovedVideoCompressor(device=dev, **options)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = comp.compress_video(frames, path, input_color_space=color_space)
    t1 = time.perf_counter()
    dec = comp.decompress_video(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if len(dec) != len(frames) or not all(
            same_bits(a, b) for a, b in zip(frames, dec)):
        raise AssertionError(f"{label}: round trip is not bit-exact")
    hist = count_records(path)
    log(f"  {label}: {len(frames)} frames {np.asarray(frames[0]).shape} "
        f"{np.asarray(frames[0]).dtype}, bit-exact; ratio "
        f"{stats['compression_ratio']:.6f}; compress "
        f"{len(frames) / (t1 - t0):.3f} fps, decompress "
        f"{len(frames) / (t2 - t1):.3f} fps ({card}); records {hist}")
    return hist, dec


def round_trip_staged(label, stages, frames, dev, path, card, **kw):
    """:func:`round_trip` as it is, whose fps are the path's; then once
    more under the :class:`StageTimer` ``stages`` for the breakdown (its
    fps include the timer's synchronisations).  Returns the first run's
    (record histogram, decoded frames)."""
    out = round_trip(label, frames, dev, path, card, **kw)
    with stages:
        round_trip(f"{label}, stage-timed rerun", frames, dev, path, card,
                   **kw)
    stages.report(card)
    return out


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
    """Phases 3-4; the launch counts are read per clip (the launches per
    main-path clip of PERF.md's kernel table) and summed.  Phase 4 ends
    with 8 frames of the ``zoom`` class at 1080p, the content the
    per-tile search (K8) serves: its residual trials must launch K8, and
    its ``.bfvc`` must equal the CPU port's byte for byte."""
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.utils import synthetic

    bk.reset_launches()
    round_trip("phase 3 static 1080p (bench clip)", bench_frames, dev,
               os.path.join(tmp, "static.bfvc"), card)
    static = path_launches("static clip", ["blocked_encode_h",
                                           "blocked_membership_h",
                                           "blocked_expand_chain",
                                           *PATH_PHASE_A])
    bk.reset_launches()
    pan_hist, _ = round_trip("phase 4 pan 1080p (synthetic, seed 0)",
                             pan_frames, dev, os.path.join(tmp, "pan.bfvc"),
                             card)
    pan = path_launches("pan clip", ["blocked_encode_h",
                                     "blocked_membership_h",
                                     "blocked_expand", *PATH_PHASE_A])
    if not any(k.startswith("6>") for k in pan_hist):
        raise AssertionError("pan clip produced no type-6 motion record")
    h, w = np.asarray(pan_frames[0]).shape[:2]
    zoom_frames = synthetic.generate_frames(8, w, h, seed=0,
                                            **synthetic.SUITE["zoom"])
    path = os.path.join(tmp, "zoom.bfvc")
    bk.reset_launches()
    round_trip(f"phase 4 zoom {h}p (synthetic, seed 0)", zoom_frames, dev,
               path, card)
    # its records are keyframes and zoom predictions: no Bloom record
    # for K2 to decode
    zoom = path_launches("zoom clip", ["blocked_encode_h", *PATH_PHASE_A,
                                       "tile_motion_best"])
    t0 = time.perf_counter()
    cpu_path = os.path.join(tmp, "zoom_cpu.bfvc")
    ImprovedVideoCompressor(device="cpu").compress_video(zoom_frames,
                                                         cpu_path)
    if not same_file(path, cpu_path):
        raise AssertionError("zoom clip: the card's .bfvc differs from the "
                             "CPU port's")
    log(f"  zoom clip: the card's .bfvc equals the CPU port's byte for byte "
        f"(CPU encode {time.perf_counter() - t0:.2f} s); K8 launches: "
        f"static {static['tile_motion_best']}, pan "
        f"{pan['tile_motion_best']}, zoom {zoom['tile_motion_best']}")
    return {n: static[n] + pan[n] + zoom[n] for n in static}


def phase_parity(dev, tmp):
    """Same-machine byte parity (CUDA vs CPU) of CIF clips on every
    profile and mode with device work, and the JAX fixture decoded on
    the card."""
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
        SUITE, generate_frames)

    cif = generate_frames(16, 352, 288, seed=0, **SUITE["static_gentle"])
    variants = [
        ("static_gentle", cif, "BGR", {}),
        ("static_gentle planar I420", i420_from(cif), "YUV",
         {"profile": "planar"}),
        ("static_gentle uint16 (byte view)",
         [f.astype(np.uint16) * 4 + 3 for f in cif], "BGR", {}),
        ("static_gentle bfv2", cif, "BGR", {"profile": "bfv2"}),
        ("static_gentle exact=False", cif, "BGR", {"exact": False}),
    ]
    for label, frames, cs, kw in variants:
        blobs = []
        for d in (dev, "cpu"):
            path = os.path.join(tmp, f"cif_{d}.bfvc")
            ImprovedVideoCompressor(device=d, **kw).compress_video(
                frames, path, input_color_space=cs)
            with open(path, "rb") as fh:
                blobs.append(fh.read())
        if blobs[0] != blobs[1]:
            raise AssertionError(f"CIF {label}: .bfvc differs between CUDA "
                                 f"and CPU")
        log(f"  CIF {label} 16 frames: CUDA and CPU .bfvc identical "
            f"({len(blobs[0])} bytes)")
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
                                      "blocked_expand", *PATH_PHASE_A])


# ---------------------------------------------------------------------------
# Phases 8-11: the other profiles and modes
# ---------------------------------------------------------------------------

class StageTimer:
    """While active, times every call of the named module functions on
    the host clock and sums seconds and calls per name.  ``sync`` names
    device stages: the card is synchronised before and after each of
    their calls, so their time is the device work they issue.
    ``closures`` names functions that return a ``finish()`` closure (the
    encoder's host phase), which is timed too, as ``<name>.finish``.
    The wrappers add those synchronisations, nothing else."""

    def __init__(self, targets, sync=(), closures=()):
        import threading

        self.targets = targets          # [(module, function name)]
        self.sync = set(sync)
        self.closures = set(closures)
        names = [n for _, n in targets] + [f"{n}.finish" for n in closures]
        self.seconds = {name: 0.0 for name in names}
        self.calls = {name: 0 for name in names}
        self._lock = threading.Lock()
        self._saved = []

    def _add(self, name, t0):
        with self._lock:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def __enter__(self):
        import torch

        for mod, name in self.targets:
            real = getattr(mod, name)

            def timed(*args, _real=real, _name=name, **kw):
                if _name in self.sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kw)
                if _name in self.sync:
                    torch.cuda.synchronize()
                self._add(_name, t0)
                if _name in self.closures:
                    return self._timed_finish(out, f"{_name}.finish")
                return out

            self._saved.append((mod, name, real))
            setattr(mod, name, timed)
        return self

    def _timed_finish(self, finish, name):
        def timed_finish():
            t0 = time.perf_counter()
            out = finish()
            self._add(name, t0)
            return out
        return timed_finish

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)

    def report(self, card):
        parts = [f"{n} {self.seconds[n] * 1e3:.1f} ms / {self.calls[n]} "
                 f"calls" for n in self.seconds]
        log(f"    stages ({card}; device stages synchronised): "
            + "; ".join(parts))


def i420_from(frames):
    """I420 YUVFrames from 3-channel frames: Y is channel 0, U and V are
    channels 1 and 2 subsampled 2x2 (every other row and column); the
    444 view repeats them."""
    from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame

    out = []
    for f in frames:
        y = np.ascontiguousarray(f[..., 0])
        u = np.ascontiguousarray(f[::2, ::2, 1])
        v = np.ascontiguousarray(f[::2, ::2, 2])
        up = [np.repeat(np.repeat(p, 2, 0), 2, 1) for p in (u, v)]
        out.append(YUVFrame(np.stack([y, *up], axis=-1), {
            "format": "I420", "y_plane": y, "u_plane": u, "v_plane": v}))
    return out


def box_clip(base, box_value, n_frames, seed):
    """The bench recipe over any dtype and channel count: the static
    ``base``, a moving 240-px box of ``box_value`` and ~1.5 % of the
    pixels per frame replaced by values drawn from the base itself."""
    rng = np.random.default_rng(seed)
    h, w = base.shape[:2]
    frames = []
    for i in range(n_frames):
        f = base.copy()
        m = rng.random((h, w)) < 0.015
        k = int(m.sum())
        f[m] = base[rng.integers(0, h, k), rng.integers(0, w, k)]
        x = (40 + 23 * i) % (w - 260)
        y = (60 + 11 * i) % (h - 260)
        f[y:y + 240, x:x + 240] = box_value
        frames.append(f)
    return frames


def _coding_stages(extra=()):
    """Stage timer of a blocked-path round trip: host keyframes (scene-cut
    fallback trials included), the device phase of each chunk encode
    (phase A, K1, the pull), its host phase (``finish()``: entropy and
    residual trials, record assembly; its keyframe trials are counted in
    both), and each run's decode (parse, K2, slicing, K3/K4)."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc

    return StageTimer([(fc, "encode_keyframe_best"),
                       (bp.BlockedEncoder, "encode_chunk_begin"),
                       (bp.BlockedDecoder, "decode_run_begin"), *extra],
                      sync=("encode_chunk_begin", "decode_run_begin"),
                      closures=("encode_chunk_begin",))


def phase_planar(dev, pan, tmp, card):
    """profile="planar" on an I420 clip; K1, K2 and K3 or K4 must run."""
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    frames = i420_from(pan)
    bk.reset_launches()
    _, dec = round_trip_staged("phase 8 planar I420 (pan, Y 1920x1080)",
                               _coding_stages(), frames, dev,
                               os.path.join(tmp, "planar.bfvc"), card,
                               color_space="YUV", profile="planar")
    for i, (f, r) in enumerate(zip(frames, dec)):
        for pl in ("y_plane", "u_plane", "v_plane"):
            if not same_bits(f.yuv_info[pl], r.yuv_info[pl]):
                raise AssertionError(f"planar frame {i} {pl} differs")
    log(f"    planes exact, U/V {dec[0].yuv_info['u_plane'].shape}")
    launches = path_launches("planar", ["blocked_encode_h",
                                        "blocked_membership_h",
                                        *PATH_PHASE_A])
    if launches["blocked_expand_chain"] + launches["blocked_expand"] == 0:
        raise AssertionError("planar decode launched neither K3 nor K4")
    return launches


def byte_view_clips(n_frames):
    """x3 uint16 (10-bit), x3 float32 (HDR radiance with NaNs) and x4
    uint8 clips at 1080p."""
    rng = np.random.default_rng(2)
    u16 = rng.integers(0, 1024, (H, W, 3), dtype=np.uint16)
    f32 = rng.random((H, W, 3), dtype=np.float32) * 4.0
    f32[rng.random((H, W)) < 2e-5] = np.nan
    bgra = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    return [("uint16 x3 (10-bit)", box_clip(u16, (1023, 512, 64), n_frames,
                                            3)),
            ("float32 x3 (HDR, NaNs)", box_clip(f32, (16.0, 8.0, 0.5),
                                                n_frames, 4)),
            ("uint8 x4 (BGRA)", box_clip(bgra, (30, 200, 240, 255),
                                         n_frames, 5))]


def phase_byte_view(dev, clips, tmp, card):
    """The byte view of wider frames; K1-K3 must run (motion is off in
    the byte view's decode: no global shift in these clips)."""
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    bk.reset_launches()
    for label, frames in clips:
        round_trip_staged(f"phase 9 {label}", _coding_stages(), frames, dev,
                          os.path.join(tmp, "byte_view.bfvc"), card)
    return path_launches("byte view", ["blocked_encode_h",
                                       "blocked_membership_h",
                                       "blocked_expand_chain",
                                       *PATH_PHASE_A])


def bfv2_chunk(frames, dev):
    """The gop stages' inputs for the first chunk of ``frames``, made as
    ``_encode_frames_batched_bfv2`` makes them."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import gop
    from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
        _filter_scalars)
    from new_bloom_filter_repo_tpu_torch.models.bloom import (
        optimal_compression_params)
    from new_bloom_filter_repo_tpu_torch.ops import bitpack, bloom_core
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        get_hash_tables)

    h, w = frames[0].shape[:2]
    n = h * w
    stacked = torch.from_numpy(np.stack(frames[:CHUNK + 1])).to(dev)
    masks, packed, counts = gop.gop_masks(stacked)
    cols, flags = [], []
    for c in counts.cpu().numpy():
        k, l = optimal_compression_params(n, int(c) / n)
        flags.append(int(l == 0 or l >= n))     # pass-through record
        if flags[-1]:
            cols.append((1, 0, 0, 0))
            continue
        _, fk, (thi, tlo) = _filter_scalars(k)
        cols.append((l, int(thi), int(tlo), fk))
    scal = [torch.tensor(col, dtype=torch.int64, device=dev)
            for col in zip(*cols)]
    vmax = min(gop.next_bucket(int(counts.max())), bitpack.padded_length(n))
    return {"stacked": stacked, "masks": masks, "packed": packed, "n": n,
            "flags": torch.tensor(flags, dtype=torch.int32, device=dev),
            "tables": get_hash_tables(n, "video", dev), "scalars": scal,
            "l_pad": bloom_core.bitmap_pad(n), "vmax": vmax}


def time_gop_ops(frames, dev, card):
    """The gop torch ops at the 1080p chunk shape (F = 15), CUDA events;
    the chain must rebuild the chunk.  Returns {op: ms}."""
    import torch
    import torch.nn.functional as F
    from new_bloom_filter_repo_tpu_torch.models import gop

    c = bfv2_chunk(frames, dev)
    t = c["tables"]
    enc_args = (c["masks"], c["stacked"][1:], t.h1, t.h2, t.act,
                *c["scalars"])
    kw = {"l_pad": c["l_pad"], "vmax": c["vmax"]}
    pb, pw, _, vals = gop.gop_encode(*enc_args, **kw)
    # a record's bitmap region: the filter, or the mask of a pass-through
    flags = c["flags"]
    pbm = torch.where(flags[:, None] > 0, c["packed"],
                      F.pad(pb, (0, pw.shape[1] - pb.shape[1])))
    fargs = (pbm, pw, vals, flags, t.h1, t.h2, t.act, *c["scalars"])
    masks, pix = gop.gop_decode_fields(*fargs, n=c["n"], vmax=c["vmax"])
    chained = gop.gop_chain(c["stacked"][0], masks, pix)
    if not torch.equal(chained, c["stacked"][1:]):
        raise AssertionError("gop decode did not rebuild the chunk")
    ms = {"gop_masks": time_ms(lambda: gop.gop_masks(c["stacked"]), 5),
          "gop_encode": time_ms(lambda: gop.gop_encode(*enc_args, **kw), 3),
          "gop_decode_fields": time_ms(
              lambda: gop.gop_decode_fields(*fargs, n=c["n"],
                                            vmax=c["vmax"]), 3),
          "gop_chain": time_ms(
              lambda: gop.gop_chain(c["stacked"][0], masks, pix), 3)}
    log(f"    gop ops, F={pb.shape[0]} n={c['n']} vmax={c['vmax']} "
        f"({card}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


def phase_bfv2(dev, bench, tmp, card):
    """profile="bfv2": round trip, the mesh stream, the BFV2 dry run."""
    import torch
    from new_bloom_filter_repo_tpu_torch import graft_entry
    from new_bloom_filter_repo_tpu_torch.models import frame_codec as fc
    from new_bloom_filter_repo_tpu_torch.models import gop
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import bloom_core
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import make_mesh
    from new_bloom_filter_repo_tpu_torch.utils import container

    path = os.path.join(tmp, "bfv2.bfvc")
    round_trip_staged(
        "phase 10 bfv2 (bench clip)",
        StageTimer([(fc, "encode_keyframe_best"), (gop, "gop_masks"),
                    (gop, "gop_encode"), (fc, "build_interframe_record"),
                    (gop, "gop_decode")],
                   sync=("gop_masks", "gop_encode", "gop_decode")),
        bench, dev, path, card, profile="bfv2")
    payloads = container.read_bfvc(path)[1]
    legacy = sum(ImprovedVideoCompressor._is_legacy_bloom(p)
                 for p in payloads)
    if legacy == 0:
        raise AssertionError("bfv2 stream holds no type-0 witness record")
    log(f"    {legacy} of {len(payloads)} records are type-0 Bloom records "
        f"with a witness")
    devs, distinct = mesh_devices(2)
    mesh = make_mesh(2, 1, devs)
    mpath = os.path.join(tmp, "bfv2_mesh.bfvc")
    round_trip(f"phase 10 bfv2 devices=(2, 1) on {mesh} (distinct cards: "
               f"{distinct})", bench, None, mpath, card, devices=mesh,
               profile="bfv2")
    with open(path, "rb") as a, open(mpath, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("bfv2 mesh stream differs from one "
                                 "device's")
    log("    .bfvc byte-identical to the single-device file")
    devs, distinct = mesh_devices(4)
    target = 4 if distinct else make_mesh(2, 2, devs)
    out = graft_entry.dryrun_multichip(target)
    err = 0
    bits = out["bits"]
    t = out["tables"]
    for i in range(bits.shape[0]):
        sc = [int(x[i]) for x in out["scalars"]]
        ref = bloom_core.encode_core(
            bits[i], t[0:2], t[2:4], t[4:6], *sc[:3], floor_k=sc[3],
            l_pad=out["encoded"][0].shape[1])
        err = max(err, max_abs_err((out["encoded"][0][i], out["encoded"][1][i]),
                                   (ref[0], ref[2])))
    log(f"    dryrun_multichip over {[str(d) for d in devs]} (distinct "
        f"cards: {distinct}): sharded vs unsharded "
        f"max_abs_err={err}")
    if err:
        raise AssertionError("sharded BFV2 encode differs from unsharded")
    return time_gop_ops(bench, dev, card)


def phase_near_lossless(dev, bench, tmp, card):
    """exact=False against the encoder's reconstruction; keyframe mode
    against the golden file; the standalone codecs on the card."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models import gop
    from new_bloom_filter_repo_tpu_torch.models import video as video_mod
    from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
        BloomFilterCompressor)
    from new_bloom_filter_repo_tpu_torch.models.image_text import (
        BloomCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import bloom_core, color, median

    comp = video_mod.ImprovedVideoCompressor(device=dev, exact=False)
    path = os.path.join(tmp, "near.bfvc")
    real = video_mod.diff_ops.apply_diff

    def near_trip(label, stages):
        """compress + decompress; decode must equal the reconstruction
        the encoder kept (``apply_diff``'s results)."""
        recon = []

        def spy(*args, **kw):
            recon.append(real(*args, **kw))
            return recon[-1]

        video_mod.diff_ops.apply_diff = spy
        try:
            with stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                comp.compress_video(bench, path)
                t1 = time.perf_counter()
                dec = comp.decompress_video(path)
                t2 = time.perf_counter()
        finally:
            video_mod.diff_ops.apply_diff = real
        if len(recon) != len(bench) - 1 or not all(
                same_bits(a, b) for a, b in zip(dec[1:], recon)):
            raise AssertionError("exact=False decode differs from the "
                                 "encoder's reconstruction")
        log(f"  {label}: {len(bench)} frames, decode == encoder "
            f"reconstruction; compress {len(bench) / (t1 - t0):.3f} fps, "
            f"decompress {len(bench) / (t2 - t1):.3f} fps ({card})")

    label = "phase 11 exact=False (bench clip)"
    near_trip(label, contextlib.nullcontext())
    st = StageTimer([(median, "noise_level"),
                     (video_mod.diff_ops, "diff_mask_thresholded"),
                     (bloom_core, "encode_core"), (gop, "gop_decode")],
                    sync=("noise_level", "diff_mask_thresholded",
                          "encode_core", "gop_decode"))
    near_trip(f"{label}, stage-timed rerun", st)
    st.report(card)
    gray = color.bgr_to_gray(torch.from_numpy(bench[0]).to(dev))
    s_card = float(median.noise_level(gray))
    s_cpu = float(median.noise_level(gray.cpu()))
    log(f"    frame 0 noise sigma: card {s_card!r}, CPU {s_cpu!r}")

    golden = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "golden_frames.npz"))["bgr"]
    kpath = os.path.join(tmp, "keyframe.bfvc")
    video_mod.ImprovedVideoCompressor(device=dev, mode="keyframe") \
        .compress_video(list(golden), kpath)
    with open(kpath, "rb") as a, open(os.path.join(
            REPO, "tests", "fixtures", "golden_ref.bfvc"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("keyframe mode did not write "
                                 "golden_ref.bfvc")
    log("  mode=keyframe on golden_frames.npz wrote golden_ref.bfvc byte "
        "for byte")

    bc = BloomCompressor(device=dev)
    fix = os.path.join(REPO, "tests", "fixtures")
    with open(os.path.join(fix, "golden_text.bcz"), "rb") as fh:
        text = bc.decompress_text(fh.read())
    with open(os.path.join(fix, "golden_text.txt")) as fh:
        if text != fh.read():
            raise AssertionError("golden_text.bcz decoded wrong")
    with open(os.path.join(fix, "golden_binary.bcz"), "rb") as fh:
        ref = fh.read()
    bits = np.load(os.path.join(fix, "golden_binary_bits.npy"))
    bitmap, witness, p, n, k, shape = bc._unpack_compressed_data(ref)
    if not np.array_equal(bc.decompress(bitmap, witness, n, k), bits):
        raise AssertionError("golden_binary.bcz decoded wrong")
    bitmap, witness, p, n, _ = bc.compress(bits)
    k, _ = bc._calculate_optimal_params(n, p)
    if bc._pack_compressed_data(bitmap, witness, p, n, k, shape) != ref:
        raise AssertionError("golden_binary.bcz not re-encoded byte for "
                             "byte")
    log("  BloomCompressor on the card: golden text and binary decoded, "
        "binary re-encoded byte for byte")

    rng = np.random.default_rng(6)
    arr = (rng.random((H, W)) < 0.05).astype(np.uint8)
    codec = BloomFilterCompressor(device=dev)
    bitmap, witness, p, n, ratio = codec.compress(arr)
    k32 = float(np.float32(codec._calculate_optimal_params(n, p)[0]))
    if not np.array_equal(codec.decompress(bitmap, witness, n, k32),
                          arr.ravel()):
        raise AssertionError("BloomFilterCompressor round trip failed")
    log(f"  BloomFilterCompressor(device=cuda) {W}x{H} at density 0.05: "
        f"round trip exact, ratio {ratio:.6f}")
    return time_bloom_ops(dev, arr, bench[1], card)


def time_bloom_ops(dev, arr, frame, card):
    """bloom_core, median and diff torch ops at 1080p, CUDA events."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models.binary_codec import (
        _filter_scalars)
    from new_bloom_filter_repo_tpu_torch.models.bloom import (
        optimal_compression_params)
    from new_bloom_filter_repo_tpu_torch.ops import bloom_core, color, diff
    from new_bloom_filter_repo_tpu_torch.ops import median
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import (
        get_hash_tables)

    n = arr.size
    k, l = optimal_compression_params(n, arr.sum() / n)
    _, fk, (thi, tlo) = _filter_scalars(k)
    t = get_hash_tables(n, "video", dev)
    bits = torch.from_numpy(arr.ravel()).to(dev)
    enc = (bits, t.h1, t.h2, t.act, l, thi, tlo)
    kw = {"floor_k": fk, "l_pad": bloom_core.bitmap_pad(n)}
    bit_array, _, wit, _ = bloom_core.encode_core(*enc, **kw)
    dec = (bit_array, wit, t.h1, t.h2, t.act, l, thi, tlo)
    f0 = torch.from_numpy(frame).to(dev)
    gray = color.bgr_to_gray(f0)
    ms = {"encode_core": time_ms(lambda: bloom_core.encode_core(*enc, **kw),
                                 5),
          "decode_core": time_ms(
              lambda: bloom_core.decode_core(*dec, floor_k=fk), 5),
          "noise_level": time_ms(lambda: median.noise_level(gray), 5),
          "diff_mask_thresholded": time_ms(
              lambda: diff.diff_mask_thresholded(f0, f0.flip(0), 9.5), 10)}
    log(f"    bloom ops at n={n} (floor_k {fk}, l {l}) ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


# ---------------------------------------------------------------------------
# Phase 12: stress of the shared-memory ordering of K1, K5a, K3, K4, K7
# and K8
# ---------------------------------------------------------------------------

# Shapes of the stress pool: every pair (NB, F).  NB from 64 to 513
# blocks, so many CTAs run at once and the twins stay cheap; F odd and
# even, so a launch ends on either parity of the kernels' double buffers.
STRESS_NB = (64, 65, 80, 96, 128, 160, 200, 256, 257, 320, 384, 513)
STRESS_F = (1, 2, 15, 16, 17)
STRESS_VH = (1, 4, 16)        # 32 to 512 value slots: fewer than changes
STRESS_DENS = (1.0, 0.0, 0.5, 0.03, 0.3)
STRESS_SPIN = 10_000_000      # ~5 ms of card time to queue a batch behind
STRESS_KERNELS = ("blocked_encode_h", "blocked_encode",
                  "blocked_expand_chain", "blocked_expand", "motion_counts",
                  "tile_motion_best")


def stress_pool(dev, seed, nbs=STRESS_NB, fs=STRESS_F):
    """{wrapper name: [(label, kernel call, twin's outputs)]} over every
    (NB, F) of ``nbs`` x ``fs``, mix i made from ``seed + i``.

    K1 and K5a (on the ``_frame_mod_tables`` of K1's inputs) take
    :func:`edge_mix_args`: random sub-filter widths m from {1, 16..384},
    floor k 0..12, change densities 0.1-30 %, and here also frames with
    no and with every item changed, and vh of 1, 4 and 16 (32-512 value
    slots: fewer than the changes).  K3 and K4 take
    :func:`expand_edge_inputs`: pass densities from every item to none by
    frame, alternating flagged frames on two mixes of three, the same
    vh.  K7 and K8, which land previous-frame rows in shared memory three
    sample rows ahead and pack them into a ring of rows, take F frame
    pairs of 1-3 bytes a pixel from 24 x 37 up to 276 x 669, each frame
    the last rolled with a fifth of it redrawn, at stride 4 or 8, K8
    with tiles of 4 to 64 pixels.  The twins run once per mix, here."""
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.ops import phase_a as pa
    from new_bloom_filter_repo_tpu_torch.ops.hashtables import blocked_tables

    ms = [1] + list(range(16, 385))
    tab = blocked_tables(max(nbs) * 1024, dev)
    pool = {name: [] for name in STRESS_KERNELS}
    for i, (nb, f) in enumerate(itertools.product(nbs, fs)):
        rng = np.random.default_rng(seed + i)
        vh = STRESS_VH[i % len(STRESS_VH)]
        label = f"seed {seed + i}: F={f} NB={nb} vh={vh}"
        enc, kw = edge_mix_args(tab, rng.choice(ms, f), dev, seed=seed + i,
                                nb=nb)
        kw["vh"] = vh
        bits = enc[0]
        for j in range(f):
            if (i + j) % 7 == 0:
                bits[j] = 1
            elif (i + j) % 7 == 3:
                bits[j] = 0
        _, h1, h2, ahi, alo, vals, m, thi, tlo, fk = enc
        a, b, act = bp._frame_mod_tables(h1, h2, ahi, alo, m, thi, tlo)
        enc5 = (bits, a, b, act, vals, m, fk)
        dens = np.roll(STRESS_DENS, i)
        flagged = range(i % 2, f, 2) if i % 3 else []
        *exp, base = expand_edge_inputs(f, nb, vh, dens, flagged, dev,
                                        seed=seed + i)
        pairs = motion_pairs(f, 24 + 28 * (i % 10), 37 + 79 * (i % 9),
                             1 + i % 3, dev, seed=seed + i)
        stride = 4 if i % 2 else 8
        tlog = 2 + i % 5
        for name, kern, twin in (
                ("blocked_encode_h",
                 lambda e=enc, k=kw: bk.blocked_encode_h(*e, **k),
                 bk.blocked_encode_h_ref(*enc, **kw)),
                ("blocked_encode",
                 lambda e=enc5, k=kw: bk.blocked_encode(*e, **k),
                 bk.blocked_encode_ref(*enc5, **kw)),
                ("blocked_expand_chain",
                 lambda e=exp, b_=base, v=vh: bk.blocked_expand_chain(
                     *e, b_, vh=v),
                 bk.blocked_expand_chain_ref(*exp, base, vh=vh)),
                ("blocked_expand",
                 lambda e=exp, v=vh: bk.blocked_expand(*e, vh=v),
                 bk.blocked_expand_ref(*exp, vh=vh)),
                ("motion_counts",
                 lambda p=pairs, s_=stride: pa.motion_counts(*p, s_),
                 pa.motion_counts_ref(*pairs, stride)),
                ("tile_motion_best",
                 lambda p=pairs, s_=stride, tl=tlog: pa.tile_motion_best(
                     *p, tlog=tl, stride=s_),
                 pa.tile_motion_best_ref(*pairs, tlog, stride))):
            want = twin if isinstance(twin, tuple) else (twin,)
            pool[name].append((label, kern, want))
    return pool


def motion_pairs(f, h, w, c, dev, seed):
    """(prev, curr) of ``f`` frame pairs of h x w pixels of c bytes on
    ``dev``: each frame the last rolled by (1, 2) with a fifth of its
    pixels redrawn, so the counts spread over the candidates."""
    import torch

    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)]
    for _ in range(f):
        nxt = np.roll(frames[-1], (1, 2), axis=(0, 1))
        redraw = rng.random((h, w)) < 0.2
        nxt[redraw] = rng.integers(0, 256, nxt[redraw].shape, dtype=np.uint8)
        frames.append(nxt)
    stacked = torch.from_numpy(np.stack(frames)).to(dev)
    return stacked[:-1], stacked[1:]


def stress_round(cases, order, mode, side):
    """Launch ``cases`` in ``order`` back to back behind a spin of the
    card, then compare every launch with its twin's outputs; returns the
    labels of the launches that differed.  ``mode``: "quiet" (one
    stream), "busy" (``side``, a second stream, runs matrix products and
    a streaming add meanwhile, so the SMs are shared with unrelated
    kernels) or "split" (the launches alternate between the current
    stream and ``side``, so two of the kernels under test share the
    SMs)."""
    import torch

    main = torch.cuda.current_stream()
    torch.cuda._sleep(STRESS_SPIN)
    side.stream.wait_stream(main)            # starts when the spin ends
    if mode == "busy":
        with torch.cuda.stream(side.stream):
            for _ in range(8):
                torch.mm(side.a, side.a, out=side.c)
                side.x.add_(1)
    outs = []
    for n, i in enumerate(order):
        if mode == "split" and n % 2:
            with torch.cuda.stream(side.stream):
                out = cases[i][1]()
        else:
            out = cases[i][1]()
        outs.append(out if isinstance(out, tuple) else (out,))
    main.wait_stream(side.stream)
    bad = []
    for i, got in zip(order, outs):
        want = cases[i][2]
        if len(got) != len(want) or any(
                g.shape != w.shape or g.dtype != w.dtype
                for g, w in zip(got, want)):
            raise AssertionError(f"{cases[i][0]}: output shapes or dtypes "
                                 f"differ from the twin's")
        bad.append(torch.stack([(g != w).any() for g, w in zip(got, want)])
                   .any())
    bad = torch.stack(bad).cpu().numpy()
    return [cases[i][0] for i, b in zip(order, bad) if b]


class StressSide:
    """The second stream of the stress phase and its unrelated work."""

    def __init__(self, dev):
        import torch

        self.stream = torch.cuda.Stream(dev)
        self.a = torch.randn((2048, 2048), device=dev)
        self.c = torch.empty_like(self.a)
        self.x = torch.zeros(16 << 20, dtype=torch.int32, device=dev)


def phase_stress(dev, rounds=(("quiet", 200), ("busy", 80), ("split", 40)),
                 seed=1000, nbs=STRESS_NB, fs=STRESS_F):
    """Phase 12.  K1, K5a, K3, K4, K7 and K8 launched many thousands of
    times over the stress pool, every launch held to its plain twin with
    tolerance 0.  Each round launches every mix of one kernel, in a new
    random order, back to back behind a spin of the card, and compares
    afterwards.  A launch that differs raises with the mix's seed and
    shape.  This raises the odds of seeing a rare shared-memory race; it
    does not prove there is none.  Returns {wrapper name: launches}."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    t0 = time.perf_counter()
    pool = stress_pool(dev, seed, nbs, fs)
    side = StressSide(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rng = np.random.default_rng(seed)
    bk.reset_launches()
    for name, cases in pool.items():
        for mode, count in rounds:
            for r in range(count):
                order = rng.permutation(len(cases))
                bad = stress_round(cases, order, mode, side)
                if bad:
                    raise AssertionError(
                        f"stress: {KERNELS[name][0]} {name} differed from "
                        f"its twin in {mode} round {r} on {len(bad)} of "
                        f"{len(cases)} launches: {bad[:8]}")
    torch.cuda.synchronize()
    launched = bk.launches()
    wall = time.perf_counter() - t1
    per_round = ", ".join(f"{c} {m}" for m, c in rounds)
    log(f"  {len(next(iter(pool.values())))} mixes a kernel (NB {min(nbs)}.."
        f"{max(nbs)}, F {list(fs)}, vh {list(STRESS_VH)}), rounds: "
        f"{per_round}; pool and twins {t1 - t0:.2f} s, launches and "
        f"compares {wall:.2f} s")
    for name in pool:
        log(f"  {KERNELS[name][0]} {name}: {launched[name]} launches, 0 "
            f"differed from the twin")
    return {name: launched[name] for name in pool}


# ---------------------------------------------------------------------------
# Phase 13: files in and out, the CLI, the harness and the tools
# ---------------------------------------------------------------------------

def planes_of(frames):
    """(y, u, v) native planes of YUVFrames."""
    return [(f.yuv_info["y_plane"], f.yuv_info["u_plane"],
             f.yuv_info["v_plane"]) for f in frames]


def same_file(a, b) -> bool:
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


def io_timer():
    """Stage timer of the file reads and writes under the CLI."""
    from new_bloom_filter_repo_tpu_torch.utils import container, videoio

    return StageTimer([(videoio, "read_y4m"), (videoio, "write_y4m"),
                       (videoio, "read_raw_yuv"), (videoio, "write_raw_yuv"),
                       (container, "read_bfvc"), (container, "write_bfvc")])


def cli_ok(argv):
    """Run the port's CLI in this process; raises unless it returns 0."""
    from new_bloom_filter_repo_tpu_torch import cli

    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")


def cli_file_trip(label, src, n_frames, card, compress_args):
    """``compress_args`` (a CLI compress or process-yuv command) from
    ``src`` to a .bfvc beside it, then ``decompress`` to a file of
    ``src``'s extension, no ``--device``: the output file must equal
    ``src`` byte for byte.  Prints each direction's fps and the time its
    file reads and writes took.  Returns the .bfvc's path."""
    import torch

    stem, ext = os.path.splitext(src)
    bfvc = stem + ".bfvc"
    back = stem + "_back" + ext
    timers = []
    walls = []
    for argv in (compress_args + [src, bfvc], ["decompress", bfvc, back]):
        with io_timer() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli_ok(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        timers.append(st)
    if not same_file(src, back):
        raise AssertionError(f"{label}: {back} differs from {src}")
    io = [sum(st.seconds.values()) for st in timers]
    log(f"  {label}: {n_frames} frames, {os.path.getsize(src)} bytes in, "
        f"{os.path.getsize(bfvc)} bytes of .bfvc, output file byte-identical "
        f"to the input; compress {n_frames / walls[0]:.3f} fps (file reads "
        f"and writes {io[0] * 1e3:.1f} ms of {walls[0] * 1e3:.1f} ms), "
        f"decompress {n_frames / walls[1]:.3f} fps ({io[1] * 1e3:.1f} ms of "
        f"{walls[1] * 1e3:.1f} ms) ({card}); records {count_records(bfvc)}")
    return bfvc


def trace_busy_share(trace_dir, wall_s):
    """Device time of the Chrome trace in ``trace_dir`` by category
    (kernels, copies, memsets) over ``wall_s``; raises when the trace
    holds no kernel."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"expected one trace file, found {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    us = {}
    for ev in events:
        cat = str(ev.get("cat", "")).lower()
        if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy",
                                           "gpu_memset"):
            us[cat] = us.get(cat, 0.0) + float(ev.get("dur", 0))
    if not us.get("kernel"):
        raise AssertionError(f"the trace {path} holds no CUDA kernel")
    return path, len(events), {k: v / 1e6 / wall_s for k, v in us.items()}


def phase_files(dev, bench, pan, f32_frames, tmp, card):
    """Phase 13 (a)-(e); returns the launches of (a)-(c)."""
    import torch
    from new_bloom_filter_repo_tpu_torch import verify_harness
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.utils import exr, profiling, videoio

    runs = []
    # (a) Y4M through compress / decompress.  The static clip's records
    # decode on the card (K2, K3).  The pan clip's 4:2:0 chroma moves 1.5
    # px a frame, so its 444 view takes keyframes and host residual
    # records (type 16), found by host trials at about 0.3 fps: 8 of
    # its frames, to keep the phase short.
    bk.reset_launches()
    y4m, bfvc = {}, {}
    for name, clip in (("static", bench), ("pan", pan[:8])):
        y4m[name] = os.path.join(tmp, f"{name}.y4m")
        videoio.write_y4m(y4m[name], planes_of(i420_from(clip)), W, H)
        bfvc[name] = cli_file_trip(
            f"(a) {name} 1080p 4:2:0 Y4M, compress / decompress", y4m[name],
            len(clip), card, ["compress"])
    launches = path_launches("Y4M files", ["blocked_encode_h",
                                           "blocked_membership_h",
                                           *PATH_PHASE_A])
    if launches["blocked_expand_chain"] + launches["blocked_expand"] == 0:
        raise AssertionError("Y4M decode launched neither K3 nor K4")
    runs.append(launches)

    # (b) raw planar YUV through process-yuv (profile="planar")
    bk.reset_launches()
    clip = i420_from(pan[:8])
    for fmt in ("I420", "YV12"):
        raw = os.path.join(tmp, f"{fmt}.yuv")
        videoio.write_raw_yuv(raw, clip, fmt)
        cli_file_trip(f"(b) pan 1080p raw {fmt}, process-yuv / decompress",
                      raw, len(clip), card,
                      ["process-yuv", "--width", str(W), "--height", str(H),
                       "--format", fmt])
    runs.append(path_launches("raw YUV files", ["blocked_encode_h",
                                                "blocked_membership_h",
                                                *PATH_PHASE_A]))

    # (c) a directory of float32 EXR frames (zip) through the byte view
    bk.reset_launches()
    exr_dir = os.path.join(tmp, "exr")
    os.makedirs(exr_dir)
    t0 = time.perf_counter()
    for i, f in enumerate(f32_frames):
        exr.write_exr(os.path.join(exr_dir, f"frame{i:03d}.exr"), f,
                      compression="zip")
    t1 = time.perf_counter()
    comp = ImprovedVideoCompressor()
    loaded = comp.extract_frames_from_video(exr_dir)
    t2 = time.perf_counter()
    if len(loaded) != len(f32_frames) or not all(
            same_bits(a, b) for a, b in zip(loaded, f32_frames)):
        raise AssertionError("EXR frames read back differ from those written")
    log(f"  (c) {len(loaded)} float32 1080p frames with NaNs as EXR (zip): "
        f"written in {(t1 - t0) * 1e3:.1f} ms, read in "
        f"{(t2 - t1) * 1e3:.1f} ms (host), bit patterns equal")
    round_trip("(c) EXR frames, byte view", loaded, None,
               os.path.join(tmp, "exr.bfvc"), card)
    runs.append(path_launches("EXR frames", ["blocked_encode_h",
                                             "blocked_membership_h",
                                             "blocked_expand_chain",
                                             *PATH_PHASE_A]))
    fix = os.path.join(REPO, "tests", "fixtures")
    piz = exr.read_exr(os.path.join(fix, "golden_piz.exr"))
    if not np.array_equal(piz.view(np.uint16),
                          np.load(os.path.join(fix, "golden_piz_expect.npy"))):
        raise AssertionError("golden_piz.exr decoded wrong")
    log(f"  (c) golden_piz.exr {piz.shape} {piz.dtype} equals "
        f"golden_piz_expect.npy")

    # (d) the other subcommands and the harness
    cli_ok(["synthetic", os.path.join(tmp, "synthetic"), "--frames", "16"])
    cli_ok(["analyze", os.path.join(tmp, "analyze"), "--frames", "8",
            "--width", "320", "--height", "240", "--noise-levels", "0", "2"])
    cli_ok(["analyze-stream", bfvc["pan"], "--json"])
    res = verify_harness.test_true_lossless(y4m["static"], ("YUV",),
                                            max_frames=8)
    if not res["all_passed"] or not res["YUV"].get("yuv_byte_exact"):
        raise AssertionError(f"verify_harness failed on the card: {res}")
    log("  (d) synthetic, analyze, analyze-stream returned 0; "
        "verify_harness.test_true_lossless passed on 8 frames of static.y4m "
        "(YUV, raw planes byte-exact)")

    # (e) stage times and a profiler trace of the main path
    clip = bench[:16]
    enc_s, dec_s, detail = profiling.measure_host_stages(clip)
    log(f"  (e) measure_host_stages, 15-frame chunk at 1080p ({card}): host "
        f"stages encode {enc_s * 1e3:.3f} ms/frame, decode "
        f"{dec_s * 1e3:.3f} ms/frame; ms/frame by stage {detail}")
    trace_dir = os.path.join(tmp, "trace")
    path = os.path.join(tmp, "traced.bfvc")
    comp = ImprovedVideoCompressor()
    comp.compress_video(clip, path)          # warm: tables, pinned buffers
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        comp.compress_video(clip, path)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = comp.decompress_video(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if not all(same_bits(a, b) for a, b in zip(clip, dec)):
        raise AssertionError("traced round trip is not bit-exact")
    tpath, n_events, share = trace_busy_share(trace_dir, t2 - t0)
    log(f"  (e) trace of compress + decompress of 16 bench frames: "
        f"{os.path.basename(tpath)}, {os.path.getsize(tpath)} bytes, "
        f"{n_events} events; under the profiler compress "
        f"{len(clip) / (t1 - t0):.3f} fps, decompress "
        f"{len(clip) / (t2 - t1):.3f} fps; device busy share of the wall "
        f"{t2 - t0:.3f} s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(share.items()))
        + f" ({card})")
    return {n: sum(r[n] for r in runs) for n in KERNELS}


# ---------------------------------------------------------------------------
# Phase 14: a mesh across two processes
# ---------------------------------------------------------------------------

MESH_CLIPS = {"static": ["blocked_encode_h", "blocked_membership_h",
                         "blocked_expand_chain", *PATH_PHASE_A],
              "pan": ["blocked_encode_h", "blocked_membership_h",
                      "blocked_expand", *PATH_PHASE_A]}
CHILD_LIMIT_S = 300


def mesh_child(rank: int, port: str, tmp: str) -> int:
    """One process of phase 14; prints one JSON line."""
    import torch
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.parallel import blocked_batch as bb
    from new_bloom_filter_repo_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh)
    from new_bloom_filter_repo_tpu_torch.utils import synthetic

    several = torch.cuda.device_count() >= 2
    torch.cuda.set_device(rank if several else 0)
    info = initialize_distributed(f"127.0.0.1:{port}", 2, rank)
    if info["num_processes"] != 2 or info["process_id"] != rank:
        raise AssertionError(f"initialize_distributed: {info}")
    mesh = make_mesh(2, 1, [(r, f"cuda:{r if several else 0}")
                            for r in range(2)])
    if not mesh.multiproc or mesh.transport != (
            "nccl" if several else "gloo-staged"):
        raise AssertionError(f"{mesh}: transport {mesh.transport}")
    clips = {"static": make_bench_clip(31),
             "pan": synthetic.generate_frames(31, W, H, seed=0,
                                              **synthetic.SUITE["pan"])}
    comp = ImprovedVideoCompressor(devices=mesh)
    warm = synthetic.generate_frames(16, 352, 288, seed=0,
                                     **synthetic.SUITE["pan"])
    path = os.path.join(tmp, f"mesh_proc{rank}_warm.bfvc")
    comp.compress_video(warm, path, input_color_space="BGR")
    comp.decompress_video(path)
    out = {"rank": rank, "transport": mesh.transport, "mesh": repr(mesh),
           "card": torch.cuda.get_device_name(mesh.home)}
    for name, frames in clips.items():
        path = os.path.join(tmp, f"mesh_proc{rank}_{name}.bfvc")
        bk.reset_launches()
        bb.reset_hop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp.compress_video(frames, path, input_color_space="BGR")
        t1 = time.perf_counter()
        enc_hop = bb.hop_stats()
        dec = comp.decompress_video(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if len(dec) != len(frames) or not all(
                same_bits(a, b) for a, b in zip(frames, dec)):
            raise AssertionError(f"process {rank}, {name}: round trip is "
                                 f"not bit-exact")
        launches = bk.launches()
        missing = [k for k in MESH_CLIPS[name] if launches[k] == 0]
        if missing:
            raise AssertionError(f"process {rank}, {name}: never launched "
                                 f"{missing}")
        hop = bb.hop_stats()
        out[name] = {
            "compress_fps": len(frames) / (t1 - t0),
            "decompress_fps": len(frames) / (t2 - t1),
            "launches": launches, "records": count_records(path),
            "hop_compress_s": enc_hop["seconds"],
            "hop_decompress_s": hop["seconds"] - enc_hop["seconds"],
            "hop_wait_s": hop["wait_seconds"],
            "hop_calls": hop["calls"], "hop_received_bytes": hop["bytes"]}
    print(json.dumps(out), flush=True)
    return 0


def single_device_streams(tmp):
    """The bytes of the files phases 3-4 wrote (later phases reuse their
    names)."""
    refs = {}
    for name in MESH_CLIPS:
        with open(os.path.join(tmp, f"{name}.bfvc"), "rb") as fh:
            refs[name] = fh.read()
    return refs


def phase_mesh_processes(tmp, card, refs):
    """Phase 14: start the two children, wait for both, hold their files
    to ``refs``, the single-device streams of phases 3-4.  Returns the
    children's launches, summed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", str(r),
         str(port), tmp], stdout=subprocess.PIPE, text=True, cwd=REPO,
        env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            left = CHILD_LIMIT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(1.0, left))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh process {r} exited with "
                                 f"{p.returncode}: {text[-2000:]}")
        reports.append(json.loads(text.strip().splitlines()[-1]))
    log(f"  two processes, {reports[0]['mesh']}, transport "
        f"{reports[0]['transport']}, {time.perf_counter() - t0:.2f} s in all "
        f"with start-up, clip generation and a CIF warm-up")
    total = {n: 0 for n in KERNELS}
    for rep in reports:
        for name in MESH_CLIPS:
            c = rep[name]
            with open(os.path.join(
                    tmp, f"mesh_proc{rep['rank']}_{name}.bfvc"), "rb") as fh:
                same = fh.read() == refs[name]
            if not same:
                raise AssertionError(
                    f"process {rep['rank']}: the {name} stream differs from "
                    f"the single-device stream")
            log(f"  process {rep['rank']} on {rep['card']}, {name} 1080p 31 "
                f"frames: bit-exact, .bfvc byte-identical to the "
                f"single-device file; compress {c['compress_fps']:.3f} fps, "
                f"decompress {c['decompress_fps']:.3f} fps; hop "
                f"{c['hop_compress_s'] * 1e3:.1f} ms of the compress and "
                f"{c['hop_decompress_s'] * 1e3:.1f} ms of the decompress (of "
                f"both, {c['hop_wait_s'] * 1e3:.1f} ms waiting for the other "
                f"process), {c['hop_calls']} calls, "
                f"{c['hop_received_bytes'] / 1e6:.1f} MB received ({card}); "
                f"launches {c['launches']}; records {c['records']}")
            for n in KERNELS:
                total[n] += c["launches"][n]
    return total


# ---------------------------------------------------------------------------
# Phase 15: damaged streams through the kernels
# ---------------------------------------------------------------------------

TRIAL_LIMIT_S = 60     # a damaged decode that prints nothing this long hangs
CHILD_START_S = 180    # the child's imports and CUDA start-up
CPU_1080P_START_S = 100  # latest start of a 1080p CPU decode in the phase
CPU_JOIN_S = 300         # the phase waits this long for its CPU decodes
DAMAGED_KERNELS = ("blocked_membership_h", "blocked_expand_chain",
                   "blocked_expand")
CUDA_FAULTS = ("CUDA error", "illegal memory access", "device-side assert",
               "illegal instruction", "launch failed")


def frames_digest(frames) -> str:
    """sha256 over every frame's shape, dtype and bytes."""
    import hashlib

    h = hashlib.sha256()
    for f in frames:
        a = np.ascontiguousarray(np.asarray(f))
        h.update(f"{a.shape}{a.dtype.str}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def decode_outcome(path, device):
    """("frames", sha256) or ("raise", message) of the port's decode of
    ``path`` on ``device``."""
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    try:
        frames = ImprovedVideoCompressor(
            device=device, verbose=False).decompress_video(path)
    except Exception as exc:                 # the contract: raise, or frames
        if any(s in str(exc) for s in CUDA_FAULTS):
            raise
        return "raise", f"{type(exc).__name__}: {exc}"[:160]
    return "frames", frames_digest(frames)


def inter_record(payloads):
    """(index, offset of the inner type byte, inner type) of the first
    record K2 or the gop stages decode: blocked (3, 7, 12) or type 0 with
    a witness, maybe behind a type-6 header."""
    import struct

    for i, p in enumerate(payloads):
        off = 5 if p[0] == 6 and len(p) > 5 else 0
        t = p[off]
        if t in (3, 7, 12) or (
                t == 0 and struct.unpack_from("<I", p, off + 17)[0]):
            return i, off, t
    raise AssertionError("stream has no blocked or type-0 record")


def damaged_trials(blob, flips, fields=True):
    """(field, seed, bytes) trials of one stream: ``flips`` seeded random
    flips (the JAX package's recipe: three bytes past the container
    header, each XORed with a non-zero byte) and, with ``fields``, edits
    of the first inter record's k, m, bitmap_bits, witness_bits and
    type-6 shift."""
    import struct

    from new_bloom_filter_repo_tpu_torch.models.blocked_pipeline import (
        npad_of)
    from new_bloom_filter_repo_tpu_torch.utils import container

    out = []
    for seed in range(flips):
        rng = np.random.default_rng(seed)
        bad = bytearray(blob)
        for _ in range(3):
            bad[int(rng.integers(16, len(bad)))] ^= int(rng.integers(1, 256))
        out.append(("random flips", seed, bytes(bad)))
    magic, payloads = container.parse_bfvc(blob)
    i, off, t = inter_record(payloads)
    nb = npad_of(struct.unpack_from("<I", payloads[i], off + 5)[0]) // 1024
    # k = 0 opens the JAX decoder's padded blocks at 1080p (nb 2032,
    # 2048 there): the witness must then cover them too
    edits = [("k = 40.5", off + 9, struct.pack("<f", 40.5)),
             ("k = 2e6", off + 9, struct.pack("<f", 2e6)),
             ("k = 0", off + 9, struct.pack("<f", 0.0))]
    if fields:
        if t != 0:
            edits.append(("m = 16", off + 13, struct.pack("<I", 16 * nb)))
        edits += [("bitmap_bits = 2^32 - 1", off + 13,
                   struct.pack("<I", 0xFFFFFFFF)),
                  ("witness_bits = 0", off + 17, struct.pack("<I", 0))]
        if off:
            edits += [("shift (32767, -32767)", 1,
                       struct.pack("<hh", 32767, -32767)),
                      ("shift (-32767, 32767)", 1,
                       struct.pack("<hh", -32767, 32767))]
    for field, at, new in edits:
        rec = bytearray(payloads[i])
        rec[at:at + len(new)] = new
        edited = list(payloads)
        edited[i] = bytes(rec)
        out.append((f"record {i} {field}", None,
                    container.serialize_bfvc(edited, magic)))
    return out


def damaged_child(manifest_path: str) -> int:
    """Phase 15's child: decodes each damaged file of the manifest on
    cuda:0 through the kernels and prints one JSON line a trial; then the
    clean stream, after a synchronize, and its launch counts."""
    import torch
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk

    with open(manifest_path) as fh:
        manifest = json.load(fh)
    dev = torch.device(manifest["device"])
    lanes = []
    launch = bk._launch

    def recording(name, args, device):
        if name == "nbf_k2_membership":
            lanes.append(args[-3])          # ..., f_, nb, k_lanes, nw, fpc
        return launch(name, args, device)

    bk._launch = recording
    bk.reset_launches()
    print(json.dumps({"ready": torch.cuda.get_device_name(dev)}), flush=True)
    for trial in manifest["trials"]:
        lanes.clear()
        t0 = time.perf_counter()
        outcome, detail = decode_outcome(trial["path"], dev)
        # a fault of this trial's kernels surfaces here, uncaught
        torch.cuda.synchronize(dev)
        print(json.dumps({"id": trial["id"], "outcome": outcome,
                          "detail": detail, "k_lanes": lanes,
                          "seconds": time.perf_counter() - t0}), flush=True)
    damaged = bk.launches()
    outcome, detail = decode_outcome(manifest["clean"], dev)
    torch.cuda.synchronize(dev)
    print(json.dumps({"clean": outcome, "detail": detail,
                      "damaged_launches": damaged,
                      "launches": bk.launches()}), flush=True)
    return 0


def damaged_streams(dev, tmp):
    """Phase 15's CIF streams (352x288, 16 frames), written on the card:
    blocked static and pan, bfv2, planar I420 and the uint16 byte view."""
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
    from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
        SUITE, generate_frames)

    static = generate_frames(16, 352, 288, seed=0, **SUITE["static_gentle"])
    pan = generate_frames(16, 352, 288, seed=0, **SUITE["pan"])
    variants = [("blocked static", static, "BGR", {}),
                ("blocked pan", pan, "BGR", {}),
                ("bfv2", static, "BGR", {"profile": "bfv2"}),
                ("planar I420", i420_from(static), "YUV",
                 {"profile": "planar"}),
                ("uint16 byte view",
                 [f.astype(np.uint16) * 4 + 3 for f in static], "BGR", {})]
    out = {}
    for name, frames, cs, kw in variants:
        path = os.path.join(tmp, f"clean {name}.bfvc")
        ImprovedVideoCompressor(device=dev, **kw).compress_video(
            frames, path, input_color_space=cs)
        with open(path, "rb") as fh:
            out[name] = (fh.read(), frames)
    return out


def phase_damaged(dev, tmp, card, full_size=None):
    """Phase 15.  ``full_size``: {"static": (bytes, frames), "pan":
    (bytes, frames)} of phases 3-4, or None for the short form (CIF only,
    the clean CIF static stream last)."""
    import queue
    import threading

    t_phase = time.perf_counter()
    ddir = os.path.join(tmp, "damaged")
    os.makedirs(ddir, exist_ok=True)
    cif = damaged_streams(dev, ddir)
    trials = []
    for name, (blob, _) in cif.items():
        trials += [("CIF", name, *t) for t in damaged_trials(blob, 8)]
    if full_size is not None:
        for name in ("static", "pan"):
            blob = full_size[name][0]
            trials += [("1080p", name, *t)
                       for t in damaged_trials(blob, 4, fields=False)]
        clean_path = os.path.join(ddir, "clean static 1080p.bfvc")
        with open(clean_path, "wb") as fh:
            fh.write(full_size["static"][0])
        clean_frames = full_size["static"][1]
    else:
        clean_path = os.path.join(ddir, "clean blocked static.bfvc")
        clean_frames = cif["blocked static"][1]
    manifest = {"trials": [], "clean": clean_path,
                "device": "cuda:0" if dev.type == "cuda" else str(dev)}
    for i, (size, name, field, seed, blob) in enumerate(trials):
        path = os.path.join(ddir, f"trial{i}.bfvc")
        with open(path, "wb") as fh:
            fh.write(blob)
        manifest["trials"].append({"id": i, "size": size, "stream": name,
                                   "field": field, "seed": seed,
                                   "path": path})
    man_path = os.path.join(ddir, "manifest.json")
    with open(man_path, "w") as fh:
        json.dump(manifest, fh)
    log(f"  {len(trials)} damaged files ({sum(t[0] == 'CIF' for t in trials)}"
        f" CIF, {sum(t[0] == '1080p' for t in trials)} 1080p) written in "
        f"{time.perf_counter() - t_phase:.2f} s")

    # the port's CPU decodes of the same bytes, beside the child: every
    # CIF trial, and the 1080p k trials that start in time
    cpu = {}

    def cpu_decodes(size):
        for tr in manifest["trials"]:
            if tr["size"] != size:
                continue
            if size == "1080p" and (
                    not tr["field"].endswith(("k = 40.5", "k = 2e6",
                                              "k = 0"))
                    or time.perf_counter() - t_phase > CPU_1080P_START_S):
                continue
            t0 = time.perf_counter()
            cpu[tr["id"]] = (*decode_outcome(tr["path"], "cpu"),
                             time.perf_counter() - t0)

    workers = [threading.Thread(target=cpu_decodes, args=(size,),
                                daemon=True) for size in ("CIF", "1080p")]
    for w in workers:
        w.start()
    lines = queue.Queue()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--damaged-child",
         man_path], stdout=subprocess.PIPE, text=True, cwd=REPO)

    def pump():
        for line in child.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    results, seen = {}, []

    def next_report(limit, waiting_for):
        deadline = time.perf_counter() + limit
        while True:
            left = deadline - time.perf_counter()
            try:
                line = lines.get(timeout=max(0.1, left))
            except queue.Empty:
                child.kill()
                raise AssertionError(f"phase 15: the child printed nothing "
                                     f"for {limit} s while decoding "
                                     f"{waiting_for}") from None
            if line is None:
                child.wait()
                raise AssertionError(
                    f"phase 15: the child died (exit {child.returncode}) "
                    f"while decoding {waiting_for}: {''.join(seen[-20:])}")
            seen.append(line)
            if line.startswith("{"):
                return json.loads(line)

    try:
        ready = next_report(CHILD_START_S, "nothing yet (start-up)")
        log(f"  child on {ready['ready']}")
        for tr in manifest["trials"]:
            what = (f"trial {tr['id']} ({tr['size']} {tr['stream']}, "
                    f"{tr['field']}, seed {tr['seed']})")
            rep = next_report(TRIAL_LIMIT_S, what)
            results[rep["id"]] = rep
        closing = next_report(TRIAL_LIMIT_S, "the clean stream")
        if child.wait(timeout=TRIAL_LIMIT_S) != 0:
            raise AssertionError(f"phase 15: the child exited with "
                                 f"{child.returncode}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    for w in workers:
        w.join(timeout=max(1.0, CPU_JOIN_S - (time.perf_counter() - t_phase)))
    if workers[0].is_alive():
        raise AssertionError("phase 15: the CPU decodes of the CIF trials "
                             "did not finish")
    if workers[1].is_alive():
        log("  the last 1080p CPU decode did not finish in time: its trial "
            "is held to termination and k_lanes only")

    mix = {}
    for tr in manifest["trials"]:
        rep = results[tr["id"]]
        what = (f"trial {tr['id']} ({tr['size']} {tr['stream']}, "
                f"{tr['field']}, seed {tr['seed']})")
        if max(rep["k_lanes"], default=0) > 32:
            raise AssertionError(f"{what}: K2 launched with k_lanes "
                                 f"{rep['k_lanes']}")
        key = (tr["size"], tr["stream"])
        mix.setdefault(key, {"frames": 0, "raise": 0, "max_s": 0.0})
        mix[key][rep["outcome"]] += 1
        mix[key]["max_s"] = max(mix[key]["max_s"], rep["seconds"])
        against = "not compared with a CPU decode"
        if tr["id"] in cpu:
            want, want_detail, cpu_s = cpu[tr["id"]]
            if rep["outcome"] != want or (
                    want == "frames" and rep["detail"] != want_detail):
                raise AssertionError(
                    f"{what}: the card {rep['outcome']} ({rep['detail']}), "
                    f"the CPU {want} ({want_detail})")
            against = (f"the port's CPU decode of the same file agrees "
                       f"({cpu_s:.2f} s)")
        if tr["size"] == "1080p":
            log(f"  {what}: {rep['outcome']} on the card in "
                f"{rep['seconds']:.3f} s, K2 k_lanes {rep['k_lanes']}; "
                f"{against}")
    for (size, name), m in mix.items():
        log(f"  {size} {name}: {m['frames']} trials returned frames, "
            f"{m['raise']} raised; slowest card decode {m['max_s']:.2f} s")
    compared = sum(1 for t in manifest["trials"] if t["id"] in cpu)
    log(f"  {compared} trials held to the port's CPU decode of the same "
        f"bytes (outcome, and the frames' sha256), every CIF trial among "
        f"them; every K2 launch had k_lanes <= 32")
    if closing["clean"] != "frames" or closing["detail"] != frames_digest(
            clean_frames):
        raise AssertionError(f"phase 15: the clean stream after the damaged "
                             f"ones did not decode bit-exactly: {closing}")
    missing = [k for k in DAMAGED_KERNELS
               if closing["damaged_launches"][k] == 0]
    if missing:
        raise AssertionError(f"phase 15: no damaged input reached {missing}")
    log(f"  after the last damaged trial the clean stream decodes "
        f"bit-exactly after torch.cuda.synchronize(); launches on damaged "
        f"input {closing['damaged_launches']}, with the clean decode "
        f"{closing['launches']}")
    log(f"  phase 15 took {time.perf_counter() - t_phase:.2f} s ({card})")


# ---------------------------------------------------------------------------
# Phase 16: the repository's tools on the card
# ---------------------------------------------------------------------------

SUITE_FRAMES = 60                 # frames a suite clip in (c)
SUITE_CPU_CLIPS = ("synthetic_static_gentle.y4m", "synthetic_pan.y4m",
                   "synthetic_noise_storm.y4m")
SUITE_CPU_FRAMES = 16
SUITE_CODECS = ("bloom", "bloom-planar", "keyframe")


def finish_device_work(dev, frames):
    """(kernels, copies) that one ``encode_chunk_begin`` finish() of
    ``frames``' first chunk queues on the card, from a torch.profiler
    trace of that call alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp

    fin = bp.BlockedEncoder(device=dev).encode_chunk_begin(
        frames[0], frames[1:CHUNK + 1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fin()
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum("memcpy" in n.lower() or "memset" in n.lower()
                 for n in on_card)
    return len(on_card) - copies, copies


def suite_bench(tbc, path, codec, max_frames, device=None):
    """One clip through ``tools/benchmark_compression``'s bench of
    ``codec``."""
    if codec == "bloom-planar":
        return tbc.bench_bloom_planar(path, max_frames, threads=4,
                                      device=device)
    return tbc.bench_bloom(path, max_frames, codec, threads=4, device=device)


def phase_tools(dev, tmp, card, suite_frames=SUITE_FRAMES):
    """Phase 16: (a) ``tools.bench.main()`` (the 1080p x 120 codec loop,
    e2e on 16 frames, the host stages, the production schedule, then the
    4K x 24 codec loop and production schedule), every ``lossless`` and
    ``production_measured`` true, ``value_4k`` set; the device work one
    finish() queues.  (b) ``tools.benchmark_stages.main`` at F = 120 with
    --host and --prefetch-compare.  (c) ``tools.benchmark_compression
    .main --synthetic`` on the 8-class CIF suite (``suite_frames``
    frames), codecs bloom, bloom-planar and keyframe, every clip
    lossless; static_gentle, pan and noise_storm at 16 frames on the
    card and on the CPU, every ratio equal.  Returns the launches of
    (a)-(c) by part, and K4's by clip."""
    from new_bloom_filter_repo_tpu_torch.ops import blocked as bk
    from new_bloom_filter_repo_tpu_torch.tools import bench as tb
    from new_bloom_filter_repo_tpu_torch.tools import (
        benchmark_compression as tbc)
    from new_bloom_filter_repo_tpu_torch.tools import benchmark_stages as tbs

    parts = {}
    t0 = time.perf_counter()
    bk.reset_launches()
    out = tb.main([])
    log(f"  (a) tools.bench ran in {time.perf_counter() - t0:.2f} s "
        f"({card}); its JSON line is the line above")
    parts["a"] = path_launches("(a) tools.bench", [
        "blocked_encode_h", "blocked_membership_h", "blocked_expand_chain",
        *PATH_PHASE_A])
    if out.get("value_4k") is None:
        raise AssertionError(f"(a) value_4k is None: {out.get('note_4k')}")
    bad = [k for k in ("lossless", "production_measured", "lossless_4k",
                       "production_measured_4k") if out.get(k) is not True]
    if bad or out.get("host_stage_fps") is None:
        raise AssertionError(f"(a) tools.bench: {bad} not true or no host "
                             f"stage figure: {out}")
    kernels, copies = finish_device_work(dev, tb.make_clip(CHUNK + 1))
    log(f"  (a) one encode_chunk_begin finish() of the bench clip's first "
        f"chunk queued {kernels} kernels and {copies} copies on the card")

    t0 = time.perf_counter()
    bk.reset_launches()
    log("  (b) tools.benchmark_stages --frames 120 --host "
        "--prefetch-compare:")
    rc = tbs.main(["--frames", "120", "--host", "--prefetch-compare"])
    if rc != 0:
        raise AssertionError(f"(b) benchmark_stages returned {rc}")
    log(f"  (b) ran in {time.perf_counter() - t0:.2f} s ({card})")
    parts["b"] = path_launches("(b) tools.benchmark_stages", [
        "blocked_encode_h", "blocked_membership_h", "blocked_expand_chain",
        *PATH_PHASE_A])

    t0 = time.perf_counter()
    vdir = os.path.join(tmp, "suite")
    res_path = os.path.join(tmp, "suite_results.json")
    k4 = {}
    originals = {n: getattr(tbc, n) for n in ("bench_bloom",
                                              "bench_bloom_planar")}

    def counted(name):
        def run(path, max_frames, *args, **kw):
            before = bk.launches()["blocked_expand"]
            r = originals[name](path, max_frames, *args, **kw)
            codec = "bloom-planar" if name.endswith("planar") else args[0]
            n = bk.launches()["blocked_expand"] - before
            if n:
                key = f"{os.path.basename(path)} {codec} {max_frames}"
                k4[key] = k4.get(key, 0) + n
            return r
        return run

    bk.reset_launches()
    for n in originals:
        setattr(tbc, n, counted(n))
    try:
        log(f"  (c) tools.benchmark_compression --synthetic "
            f"--synthetic-frames {suite_frames} --codecs "
            f"{' '.join(SUITE_CODECS)}:")
        rc = tbc.main(["--synthetic", "--synthetic-frames",
                       str(suite_frames), "--video-dir", vdir, "--results",
                       res_path, "--codecs", *SUITE_CODECS])
        if rc != 0:
            raise AssertionError(f"(c) benchmark_compression returned {rc}")
        t_suite = time.perf_counter() - t0
        with open(res_path) as fh:
            results = json.load(fh)
        log(f"  (c) the suite, {suite_frames} frames a clip, "
            f"{t_suite:.2f} s ({card}): clip, codec, ratio, encode s, "
            f"decode s, lossless")
        for clip, rows in sorted(results.items()):
            for codec in SUITE_CODECS:
                r = rows[codec]
                log(f"    {clip} {codec}: {r['ratio']:.6f} "
                    f"{r['encode_s']} {r['decode_s']} {r['lossless']}"
                    + (" budget_exceeded" if r.get("budget_exceeded")
                       else ""))
                if not r["lossless"] or r["frames"] != suite_frames:
                    raise AssertionError(f"(c) {clip} {codec}: {r}")
        if len(results) != 8:
            raise AssertionError(f"(c) {len(results)} suite clips, not 8")
        for clip in SUITE_CPU_CLIPS:
            path = os.path.join(vdir, clip)
            for codec in SUITE_CODECS:
                card_r = suite_bench(tbc, path, codec, SUITE_CPU_FRAMES)
                cpu_r = suite_bench(tbc, path, codec, SUITE_CPU_FRAMES,
                                    device="cpu")
                log(f"    {clip} {codec} {SUITE_CPU_FRAMES} frames: ratio "
                    f"{card_r['ratio']:.6f} on the card, "
                    f"{cpu_r['ratio']:.6f} on the CPU; encode "
                    f"{card_r['encode_s']} / {cpu_r['encode_s']} s")
                if (card_r["ratio"] != cpu_r["ratio"]
                        or not card_r["lossless"] or not cpu_r["lossless"]):
                    raise AssertionError(f"(c) {clip} {codec}: card "
                                         f"{card_r}, CPU {cpu_r}")
    finally:
        for n, fn in originals.items():
            setattr(tbc, n, fn)
    parts["c"] = path_launches("(c) tools.benchmark_compression",
                               list(PATH_PHASE_A))
    log(f"  (c) K4 launches by clip, codec and frames: {k4 or 'none'}; "
        f"(c) took {time.perf_counter() - t0:.2f} s")
    return parts, k4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--damaged-child"]:
        return damaged_child(sys.argv[2])
    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)
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
    built = ("found already built" if _build.build_seconds is None
             else f"built in {_build.build_seconds:.2f} s")
    log(f"  kernels from {CSRC} and {CSRC_PHASE_A} {built} (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}, one a source, then linked)")
    ptxas = {}
    for name, spills, regs in re.findall(
            r"Compiling entry function '\S*?(k\d[ab]?_[a-z_]+)\S*'.*?"
            r"(\d+) bytes spill stores.*?Used (\d+) registers",
            _build.build_log, re.S):
        ptxas[name] = (int(regs), int(spills))
        log(f"    ptxas {name}: {regs} registers, {spills} bytes spilled")

    if "--profile-phase-a" in sys.argv[1:]:
        log(f"phase A profile ({smi}):")
        phase_a_profile(dev, smi)
        return 0
    if "--damaged-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            log(f"phase 15 damaged streams through the kernels, CIF only "
                f"({smi}):")
            phase_damaged(dev, tmp, smi)
        return 0
    if "--tools-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            log(f"phase 16 the tools on the card ({smi}):")
            phase_tools(dev, tmp, smi)
        return 0
    t0 = time.perf_counter()
    bench = make_bench_clip(31)
    pan = synthetic.generate_frames(31, W, H, seed=0,
                                    **synthetic.SUITE["pan"])
    byte_clips = byte_view_clips(16)
    log(f"  clips generated on the host in {time.perf_counter() - t0:.2f} s")

    if "--mesh-processes-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            log("phases 3-4 main path:")
            phase_main_path(dev, bench, pan, tmp, smi)
            log(f"phase 14 a mesh across two processes ({smi}):")
            phase_mesh_processes(tmp, smi, single_device_streams(tmp))
        return 0
    log(f"phase 2 kernels vs twins at 1080p chunk shapes ({smi}):")
    path_chunks = [("planar U plane chunk",
                    [f.yuv_info["u_plane"] for f in i420_from(pan[:16])])]
    path_chunks += [(f"byte view {label} chunk",
                     [ImprovedVideoCompressor._byte_view(f) for f in clip])
                    for label, clip in byte_clips]
    from new_bloom_filter_repo_tpu_torch.tools import bench as tools_bench
    t0 = time.perf_counter()
    batches = [("bench batch 1080p x 120", tools_bench.make_clip()),
               ("bench batch 4K x 24", tools_bench.make_clip(
                   tools_bench.FRAMES_4K, 2160, 3840, seed=1))]
    log(f"  the bench batches of tools/bench.py generated on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    log("  phase A (K6-K8) first: its outputs are K1's inputs below")
    mixes = [("1080p static chunk (bench clip)", bench[:CHUNK + 1], True,
              True),
             ("1080p pan chunk", pan[:CHUNK + 1], True, False)]
    mixes += [(label, clip[:CHUNK + 1], True, False)
              for label, clip in path_chunks]
    mixes.append(("4K chunk (the 4K bench batch's first frames)",
                  batches[1][1][:CHUNK + 1], True, False))
    mixes += [(label, frames, False, False) for label, frames in batches]
    stats = phase_phase_a(dev, mixes)
    stats.update(phase_kernels(dev, bench, path_chunks))
    at_bench = phase_bench_shapes(dev, batches)
    for label, recs in at_bench.items():
        recs["phase_a_diff"] = stats["phase_a_diff"]["at_mixes"][
            f"{label}, no shifts"]
    del batches
    if "--kernels-only" in sys.argv[1:]:
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        log("phases 3-4 main path:")
        runs = [phase_main_path(dev, bench, pan, tmp, smi)]
        single = single_device_streams(tmp)
        log("phase 5 parity:")
        phase_parity(dev, tmp)
        log(f"phase 6 mesh dry run ({smi}):")
        runs.append(phase_dryrun(nb=2032))
        log(f"phase 7 devices= ({smi}):")
        runs.append(phase_devices(dev, bench, pan, tmp, smi))
        log(f"phase 8 planar ({smi}):")
        runs.append(phase_planar(dev, pan[:8], tmp, smi))
        log(f"phase 9 byte view ({smi}):")
        runs.append(phase_byte_view(dev, byte_clips, tmp, smi))
        log(f"phase 10 bfv2 ({smi}):")
        phase_bfv2(dev, bench[:16], tmp, smi)
        log(f"phase 11 near-lossless, keyframe mode, binary codecs ({smi}):")
        phase_near_lossless(dev, bench[:16], tmp, smi)
        log(f"phase 12 stress of K1, K5a, K3, K4, K7, K8 against their "
            f"twins ({smi}):")
        phase_stress(dev)
        log(f"phase 13 files, the CLI, the harness and the tools ({smi}):")
        runs.append(phase_files(dev, bench, pan, byte_clips[1][1][:4], tmp,
                                smi))
        log(f"phase 14 a mesh across two processes ({smi}):")
        runs.append(phase_mesh_processes(tmp, smi, single))
        log(f"phase 15 damaged streams through the kernels ({smi}):")
        phase_damaged(dev, tmp, smi, full_size={
            "static": (single["static"], bench), "pan": (single["pan"], pan)})
        log(f"phase 16 the tools on the card ({smi}):")
        tool_parts, _ = phase_tools(dev, tmp, smi)
        runs += list(tool_parts.values())
    launches = {n: sum(r[n] for r in runs) for n in KERNELS}

    kernels = []
    for n, (short, replaces, entry, source) in KERNELS.items():
        st = stats[n]
        regs, spills = ptxas.get(entry, (None, None))
        kernels.append({
            "name": f"{short} {n}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[n],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st.get("bound_by", "bytes"), "library_ms": None,
            "bytes": st["bytes"], "operations": st.get("operations"),
            "cold_ms": st.get("cold_ms"), "ptxas_registers": regs,
            "ptxas_spill_bytes": spills,
            "at_bench_batches": {label: recs[n] for label, recs
                                 in at_bench.items() if n in recs},
            "launches_in_tools": {part: ln[n]
                                  for part, ln in tool_parts.items()}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
