"""The benchmark of the PyTorch/CUDA port: one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A closed loop with one client, a video archive's ingest worker: it
compresses a clip to a ``.bfvc`` file with the cell's configuration and
restores it, clip after clip, for ``--seconds``; the clip that is
running when the time is up finishes and counts.  The clip is made once
from ``--seed`` in set-up by the benchmark's own generator
(``generator.py``) with the cell's traffic file (``traffic/<name>.json``)
and configuration file (``configs/<name>.json``).  Each call is timed on
the host clock; both return with their results on the host.

A configuration file gives ``width``, ``height``, ``color_space``, the
``compressor``'s keyword arguments and, optionally, ``layout``: how a
frame is laid out, ``"interleaved"`` when the key is absent.
``"interleaved"``: uint8 frames HxWx3 (BGR) or HxW (gray), as the
generator makes them; a call's raw bytes are theirs.  ``"I420"``:
8-bit 4:2:0 planes as a raw ``.yuv`` file holds them, made from the same
frames by ``generator.to_i420``; it needs ``"color_space": "YUV"`` and
the ``"planar"`` profile.  The program gets each frame as it gets one
from ``read_raw_yuv``, a ``YUVFrame`` (the 4:4:4 view and the planes),
and a call's raw bytes are the planes', W x H x 3/2 a frame.

Once the window has closed, ``reference.py`` judges every round trip:
the decoded frames against the clip, the stored file against the
container layout and the keyframe schedule.  ``--trace 1`` runs the same
loop under ``torch.profiler`` and reports the per-layer metrics, each
read by its own file in ``metrics/``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the same numbers end standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, the run prints no result and
exits with 2; when JAX or the JAX package was loaded, with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, List, NamedTuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench import generator, reference, tracestats  # noqa: E402

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "new_bloom_filter_repo_tpu")
# The layouts a configuration may state, the default first.
LAYOUTS = ("interleaved", "I420")
# The keys of a ``YUVFrame``'s planes, in the order a digest takes them.
PLANES = ("y_plane", "u_plane", "v_plane")
# Frames of the untimed round trip in set-up: one keyframe and one
# whole chunk of inter frames, the shapes every timed chunk has.  They
# are the clip's first frames, or, where the traffic file gives ``warm``
# parameters, frames of the same scene made with those (a mix whose
# every frame takes seconds on the host warms no more shapes for it).
WARM_FRAMES = 16


class Clip(NamedTuple):
    """A clip in its configuration's layout, the one place that knows
    the layout.  ``frames``: what the program is given.  ``planes``: each
    frame's planes as the reference judges them, the frame itself or its
    Y, U and V.  ``raw_bytes``: the planes' bytes, as the user holds
    them."""

    layout: str
    frames: list
    planes: list
    raw_bytes: int

    def decoded_planes(self, frame) -> tuple:
        """A decoded frame's planes, in the order of ``planes``."""
        if self.layout == "I420":
            return tuple(frame.yuv_info[k] for k in PLANES)
        return (frame,)


class Record:
    """What a run measured: the timed calls (``phase``, ``seconds``,
    ``frames``, ``raw_bytes``, ``stored_bytes``), the set-up time, the
    parsed trace (``--trace 1``) and the card's name."""

    def __init__(self, calls, setup_s, trace=None, device_kind=""):
        self.all_calls = calls
        self.setup_s = setup_s
        self.trace = trace
        self.device_kind = device_kind

    def calls(self, phase: str) -> list:
        return [c for c in self.all_calls if c["phase"] == phase]


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def resolve(spec: dict, workload: str):
    """The cell, its configuration file's contents and its traffic
    file's contents."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    layout_of(config)
    return cell, config, traffic


def layout_of(config: dict) -> str:
    """The configuration's frame layout (see the module docstring);
    raises ValueError for an unknown one, or for I420 without the colour
    space and profile that code planes."""
    layout = config.get("layout", LAYOUTS[0])
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {LAYOUTS}")
    if layout == "I420" and (config["color_space"] != "YUV" or
                             config["compressor"].get("profile") != "planar"):
        raise ValueError('layout "I420" needs "color_space": "YUV" and '
                         'the compressor\'s "profile": "planar"')
    return layout


def load_metric(name: str):
    """The reader ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """``(entry, reader)`` of each metric the cell reports: its
    end-to-end metrics, or with ``trace`` its per-layer metrics.  A
    metric with a ``workloads`` list belongs to those cells alone; a
    per-layer metric without one belongs to every cell that reports the
    end-to-end metric it ``moves``, cells added later included."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if trace:
        moved = {m["name"] for m in e2e}
        chosen = [m for m in spec["per_layer"]
                  if (workload in m["workloads"] if "workloads" in m
                      else m["moves"] in moved)]
    else:
        chosen = e2e
    out = []
    for m in chosen:
        mod = load_metric(m["name"])
        if mod.UNIT != m["unit"]:
            raise SystemExit(f"metrics/{m['name']}.py gives {mod.UNIT!r}, "
                             f"BENCHMARK.json says {m['unit']!r}")
        out.append((m, mod))
    return out


def make_clip(config: dict, traffic: dict, seed: int) -> Clip:
    """The clip made from ``seed`` in the configuration's layout.  For
    I420 the program gets one ``YUVFrame`` a frame, as ``read_raw_yuv``
    makes them: the planes in ``yuv_info``, ``.data`` the 4:4:4 view
    with each chroma sample repeated over its 2x2 block."""
    layout = layout_of(config)
    frames = generator.generate_frames(
        traffic["frames"], config["width"], config["height"],
        color_space=config["color_space"], seed=seed % (1 << 64),
        **traffic["params"])
    if layout == "interleaved":
        planes = [(f,) for f in frames]
    else:
        from new_bloom_filter_repo_tpu_torch.utils.yuvframe import YUVFrame

        planes = [generator.to_i420(f) for f in frames]
        frames = []
        for y, u, v in planes:
            h, w = y.shape
            view = np.empty((h, w, 3), np.uint8)
            view[:, :, 0] = y
            blocks = view.reshape(h // 2, 2, w // 2, 2, 3)
            blocks[:, :, :, :, 1] = u[:, None, :, None]
            blocks[:, :, :, :, 2] = v[:, None, :, None]
            frames.append(YUVFrame(view, {"format": "I420", "y_plane": y,
                                          "u_plane": u, "v_plane": v}))
    return Clip(layout, frames, planes,
                sum(p.nbytes for ps in planes for p in ps))


def warm_clip(config: dict, traffic: dict, seed: int, clip: Clip) -> list:
    """The frames of the untimed round trip in set-up."""
    if "warm" not in traffic:
        return clip.frames[:WARM_FRAMES]
    return make_clip(config, dict(traffic, frames=WARM_FRAMES, params={
        **traffic["params"], **traffic["warm"]}), seed).frames


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


def round_trip(comp, clip, path, color_space, span) -> tuple:
    """One compress and one decompress of ``clip``; returns the timed
    calls and what the reference judges: the stored file's bytes and the
    decoded frames' digests (None where a call failed)."""
    calls, run = [], {"file": None, "decoded": None, "error": None}
    try:
        with span("compress_video"):
            t = time.perf_counter()
            comp.compress_video(clip.frames, path,
                                input_color_space=color_space)
            dt = time.perf_counter() - t
        stored = os.path.getsize(path)
        calls.append({"phase": "compress_video", "seconds": dt,
                      "frames": len(clip.frames), "raw_bytes": clip.raw_bytes,
                      "stored_bytes": stored})
        with open(path, "rb") as fh:
            run["file"] = fh.read()
        with span("decompress_video"):
            t = time.perf_counter()
            out = comp.decompress_video(path)
            dt = time.perf_counter() - t
        calls.append({"phase": "decompress_video", "seconds": dt,
                      "frames": len(out), "raw_bytes": clip.raw_bytes,
                      "stored_bytes": stored})
        run["decoded"] = [reference.digest(clip.decoded_planes(f))
                          for f in out]
    except Exception as exc:  # the program failed: judged, not raised
        run["error"] = "".join(traceback.format_exception_only(exc)).strip()
        traceback.print_exc(file=sys.stderr)
    return calls, run


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool = False, device: str = "cuda:0",
             t0: float = T0, log: Callable = print, clip=None) -> dict:
    """Set up, run the window, and judge it.  Returns the ``Record``,
    the judged numbers, the round trips, the failures and the peak
    device memory.  ``clip``, where given, is the clip already made
    from ``seed`` (``make_clip``)."""
    import torch

    from new_bloom_filter_repo_tpu_torch.models.video import (
        ImprovedVideoCompressor)

    cuda = torch.device(device).type == "cuda"
    stages = [("imports", time.perf_counter())]
    if clip is None:
        clip = make_clip(config, traffic, seed)
    warm = warm_clip(config, traffic, seed, clip)
    stages.append(("clip", time.perf_counter()))
    comp = ImprovedVideoCompressor(**config["compressor"], device=device)
    color_space = config["color_space"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = os.path.join(tmp, "clip.bfvc")
        comp.compress_video(warm, path, input_color_space=color_space)
        comp.decompress_video(path)
        if cuda:
            torch.cuda.synchronize(device)
        stages.append(("warm round trip", time.perf_counter()))
        log("set-up: " + ", ".join(
            f"{name} {t - prev:.3f} s" for (name, t), prev in
            zip(stages, [t0] + [t for _, t in stages[:-1]])))
        prof = None
        span: Callable = lambda name: contextlib.nullcontext()  # noqa: E731
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
            span = record_function
        if cuda:
            # The peak of the window alone, not of the warm round trip.
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        calls, runs = [], []
        start = time.perf_counter()
        while True:
            c, run = round_trip(comp, clip, path, color_space, span)
            calls += c
            runs.append(run)
            if c:
                log(f"clip {len(runs)}: " + ", ".join(
                    f"{x['phase']} {x['seconds']:.4f} s" for x in c))
            if run["error"] or time.perf_counter() - start >= seconds:
                break
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        parsed = None
        if trace:
            tpath = os.path.join(tmp, "trace.json")
            t = time.perf_counter()
            prof.export_chrome_trace(tpath)
            del prof
            size = os.path.getsize(tpath)
            t1 = time.perf_counter()
            parsed = tracestats.Trace.load(tpath)
            os.remove(tpath)
            log(f"trace: {size} bytes, {len(parsed.host)} host and "
                f"{len(parsed.device())} device events; export "
                f"{t1 - t:.1f} s, parse {time.perf_counter() - t1:.1f} s")
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    del comp
    if cuda:
        torch.cuda.empty_cache()
    judged = reference.judge(clip.planes,
                             config["compressor"]["keyframe_interval"], runs,
                             clip.layout)
    numbers = {k: sum(j[k] for j in judged) for k in reference.LIMITS}
    failed = sum(1 for run, j in zip(runs, judged)
                 if run["error"] or not reference.within_limits(j))
    return {"record": Record(calls, setup_s, parsed, kind),
            "numbers": numbers, "runs": runs, "failed": failed,
            "memory_peak_bytes": int(peak)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    cell, config, traffic = resolve(spec, args.workload)
    readers = metrics_for(spec, args.workload, bool(args.trace))

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s), "
              f"this machine has {n}; no result", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(config, traffic, args.seed, args.seconds,
                   trace=bool(args.trace), device="cuda:0", log=log)
    rec = out["record"]
    metrics = {}
    for entry, mod in readers:
        value = mod.read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": rec.device_kind,
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    result = {"correct": out["failed"] == 0 and bool(out["runs"])
              and reference.within_limits(out["numbers"]),
              "attempted": len(out["runs"]), "failed": out["failed"],
              "metrics": metrics, "device": device}
    if rec.trace is not None:
        window = rec.trace.window()
        device["busy_s"] = rec.trace.busy_us() / 1e6
        device["window_s"] = (window[1] - window[0]) / 1e6 if window else 0.0
        result["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    for run in out["runs"]:
        if run["error"]:
            log(f"error: {run['error']}")
    for name, entry in metrics.items():
        log(f"{name} {entry['value']!r} {entry['unit']}")
    log(f"device {device['kind']}; power {device['power']}")
    result["checks"] = {k: {"value": v, "limit": reference.LIMITS[k]}
                        for k, v in out["numbers"].items()}
    found = forbidden_modules()
    if found:
        log(f"portbench: the run loaded {found}; no result")
        return 3
    for k, v in out["numbers"].items():
        log(f"check {k} {v} limit {reference.LIMITS[k]}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
