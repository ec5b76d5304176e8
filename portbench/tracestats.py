"""Reduction of a ``torch.profiler`` Chrome trace to the per-layer
numbers.

The benchmark wraps each timed call in a ``record_function`` span named
after the call (``compress_video``, ``decompress_video``).  The trace
holds those spans (category ``user_annotation``), the profiler's host
operations (``cpu_op``), and the card's work as CUPTI saw it: kernels
(``kernel``), copies (``gpu_memcpy``) and memsets (``gpu_memset``).
Times are microseconds on one clock.  Device time inside a phase is the
part of each device interval that lies inside one of the phase's spans.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import peaks

Interval = Tuple[float, float]

HOST_CATS = ("cpu_op", "user_annotation")
SPAN_NAMES = ("compress_video", "decompress_video")


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(interval: Interval, windows: Sequence[Interval]) -> float:
    """Length of ``interval`` inside the disjoint ``windows``."""
    a, b = interval
    return sum(max(0.0, min(b, w1) - max(a, w0)) for w0, w1 in windows)


def covered(intervals: Iterable[Interval],
            windows: Sequence[Interval]) -> float:
    """Length of the union of ``intervals`` inside ``windows``."""
    return sum(clip(iv, windows) for iv in union(intervals))


def gaps(busy: Sequence[Interval],
         windows: Sequence[Interval]) -> List[Interval]:
    """The parts of ``windows`` (disjoint) that no interval of ``busy``
    (disjoint, sorted) covers, edges of the windows included."""
    out = []
    for w0, w1 in windows:
        t = w0
        for a, b in busy:
            if b <= t or a >= w1:
                continue
            if a > t:
                out.append((t, min(a, w1)))
            t = max(t, b)
        if t < w1:
            out.append((t, w1))
    return out


def is_host_copy(name: str) -> bool:
    """A copy between host and device (not device to device)."""
    return "HtoD" in name or "DtoH" in name


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without its leading ``void`` and cut to ``limit``
    characters (PyTorch's template names run to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


class Trace:
    """A parsed trace: the benchmark's spans by name, the device events
    and the host events, each as ``(start_us, end_us, name)``."""

    def __init__(self, events: Iterable[dict]):
        self.spans: Dict[str, List[Interval]] = {n: [] for n in SPAN_NAMES}
        self.kernels: List[Tuple[float, float, str]] = []
        self.copies: List[Tuple[float, float, str]] = []
        self.memsets: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            t0 = float(ev["ts"])
            t1 = t0 + float(ev.get("dur", 0.0))
            name = str(ev.get("name", ""))
            if cat == "kernel":
                self.kernels.append((t0, t1, name))
            elif cat == "gpu_memcpy":
                self.copies.append((t0, t1, name))
            elif cat == "gpu_memset":
                self.memsets.append((t0, t1, name))
            elif cat in HOST_CATS:
                if cat == "user_annotation" and name in self.spans:
                    self.spans[name].append((t0, t1))
                self.host.append((t0, t1, name))
        for name in self.spans:
            self.spans[name] = union(self.spans[name])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []))

    def device(self) -> List[Tuple[float, float, str]]:
        return self.kernels + self.copies + self.memsets

    def window(self) -> Optional[Interval]:
        """From the first span's start to the last span's end."""
        spans = [s for v in self.spans.values() for s in v]
        if not spans:
            return None
        return (min(a for a, _ in spans), max(b for _, b in spans))

    def span_us(self, phase: str) -> float:
        return sum(b - a for a, b in self.spans[phase])

    def busy_us(self, phase: Optional[str] = None) -> float:
        """Time in which some device operation ran, inside the phase's
        spans (or inside the whole window)."""
        windows = self.spans[phase] if phase else [self.window() or (0, 0)]
        return covered(((a, b) for a, b, _ in self.device()), windows)

    def idle_pct(self, phase: str) -> Optional[float]:
        total = self.span_us(phase)
        if total <= 0:
            return None
        return 100.0 * (1.0 - self.busy_us(phase) / total)

    def summed_us(self, events, phase: str) -> float:
        """Summed durations of ``events`` inside the phase's spans
        (overlapping events each count)."""
        return sum(clip((a, b), self.spans[phase]) for a, b, _ in events)

    def kernel_us(self, phase: str) -> float:
        return self.summed_us(self.kernels, phase)

    def host_copy_us(self, phase: str) -> float:
        return self.summed_us([e for e in self.copies if is_host_copy(e[2])],
                              phase)

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time in the
        window, by name, in seconds."""
        window = [self.window() or (0, 0)]
        by_name: Dict[str, float] = {}
        for a, b, name in self.device():
            by_name[name] = by_name.get(name, 0.0) + clip((a, b), window)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[short(name), us / 1e6] for name, us in ops if us > 0]

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the benchmark's span open
        then and the innermost profiler operation open then."""
        span = next((n for n, v in self.spans.items()
                     if any(a <= t < b for a, b in v)), "outside the calls")
        inner = None
        for a, b, name in self.host:
            if a <= t < b and name not in self.spans and (
                    inner is None or a > inner[0]):
                inner = (a, name)
        return span if inner is None else f"{span} / {inner[1]}"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the calls in which the device
        ran nothing, in seconds, each named by what the host was doing
        at its midpoint."""
        calls = union(s for v in self.spans.values() for s in v)
        busy = union((a, b) for a, b, _ in self.device())
        found = sorted(gaps(busy, calls), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_label((a + b) / 2), (b - a) / 1e6]
                for a, b in found]


def roofline_pct(run, phase: str) -> Optional[float]:
    """The phase's kernels' share of their bound, in %.  The bound is the
    least time the card needs to read each byte of the work once: the
    raw frames of the clips and their stored files, each once per call,
    at the card's published memory bandwidth.  It counts what the clips
    need, not what any implementation launches, and is divided by the
    summed kernel time inside the phase's calls.  None without a trace,
    a kernel, or a known card."""
    bw = peaks.hbm_bytes_per_s(run.device_kind)
    if run.trace is None or bw is None:
        return None
    us = run.trace.kernel_us(phase)
    if us <= 0:
        return None
    moved = sum(c["raw_bytes"] + c["stored_bytes"] for c in run.calls(phase))
    return 100.0 * moved / bw / (us / 1e6)


def copy_ms_per_frame(run, phase: str) -> Optional[float]:
    """Summed host-to-device and device-to-host copy time inside the
    phase's calls, in ms a frame of those calls."""
    frames = sum(c["frames"] for c in run.calls(phase))
    if run.trace is None or frames == 0:
        return None
    return run.trace.host_copy_us(phase) / 1e3 / frames
