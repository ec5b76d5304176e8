"""The program's own spans, read by the per-layer metrics of its host
layers.

The port marks its host work with ``nbf.*`` spans
(``new_bloom_filter_repo_tpu_torch/utils/profiling.py``).  While the
``--trace 1`` run's profiler records, each span is kept in memory by the
program, with its thread, its start and end on ``time.time_ns()`` and
the span open around it; a span opened on the main thread is also a
``user_annotation`` in the trace.  The encoder's overlap worker runs the
keyframes and each chunk's ``finish()``; the trace does not show that
thread, so its spans come from the kept list alone.

``mapped`` puts every kept span onto the trace's clock: the offset is
the median, over the main thread's spans (each in both), of the trace's
start less the kept start.  A program without the spans (an older
commit) gives None here, and each reader then gives None.
"""

from __future__ import annotations

import statistics
import threading
from collections import namedtuple
from typing import Callable, Dict, List, Optional

from portbench import tracestats

# A kept span on the trace's clock, in microseconds.
Mapped = namedtuple("Mapped", "name thread start end parent")

PREFIX = "nbf."


def kept() -> Optional[list]:
    """The spans the program kept, or None where it keeps none."""
    from new_bloom_filter_repo_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    return None if read is None else read()


def offset_us(trace, spans) -> Optional[float]:
    """Trace clock less kept clock, in microseconds: the median over the
    main thread's kept spans matched, name by name and in order, to the
    trace's spans of that name.  The last kept spans of a name are this
    trace's (a process may have recorded earlier sessions); a name with
    fewer kept spans than traced ones is left out."""
    main = threading.main_thread().ident
    traced: Dict[str, List[float]] = {}
    for a, _, name in trace.host:
        if name.startswith(PREFIX):
            traced.setdefault(name, []).append(a)
    ours: Dict[str, List[float]] = {}
    for s in spans:
        if s.thread == main and s.name in traced:
            ours.setdefault(s.name, []).append(s.start_ns / 1e3)
    diffs = []
    for name, starts in traced.items():
        mine = sorted(ours.get(name, []))
        if len(mine) < len(starts):
            continue
        diffs += [t - k for t, k in zip(sorted(starts),
                                         mine[len(mine) - len(starts):])]
    return statistics.median(diffs) if diffs else None


def mapped(run) -> Optional[List[Mapped]]:
    """The kept spans that overlap the traced window, on the trace's
    clock; None without a trace, kept spans or a span to anchor them."""
    if run.trace is None:
        return None
    spans = kept()
    window = run.trace.window()
    if not spans or window is None:
        return None
    off = offset_us(run.trace, spans)
    if off is None:
        return None
    out = [Mapped(s.name, s.thread, s.start_ns / 1e3 + off,
                  s.end_ns / 1e3 + off, s.parent) for s in spans]
    return [m for m in out if m.end > window[0] and m.start < window[1]]


def inside(spans: List[Mapped], run, phase: str,
           name: str) -> List[Mapped]:
    """The spans of ``name`` that start inside the phase's calls."""
    calls = run.trace.spans[phase]
    return [s for s in spans if s.name == name
            and any(a <= s.start < b for a, b in calls)]


def self_us(span: Mapped, spans: List[Mapped], child: str) -> float:
    """``span``'s duration less the part its ``child`` spans (same
    thread) cover."""
    kids = [(s.start, s.end) for s in spans
            if s.name == child and s.thread == span.thread]
    return (span.end - span.start) - tracestats.covered(
        kids, [(span.start, span.end)])


def traced(run, names: Callable[[str], bool]) -> Optional[list]:
    """The trace's main-thread spans whose names ``names`` accepts, as
    ``(start, end)``; None where the trace holds none of the program's
    spans."""
    if run.trace is None or not any(
            n.startswith(PREFIX) for _, _, n in run.trace.host):
        return None
    return [(a, b) for a, b, n in run.trace.host
            if n.startswith(PREFIX) and names(n)]


def idle_in_pct(run, phase: str, spans: List[Mapped]) -> Optional[float]:
    """Share of the phase's device-idle time (no kernel, copy or memset
    running, inside its calls) that ``spans`` cover, in %."""
    busy = tracestats.union((a, b) for a, b, _ in run.trace.device())
    idle = tracestats.gaps(busy, run.trace.spans[phase])
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    return 100.0 * tracestats.covered(
        ((s.start, s.end) for s in spans), idle) / total


def frames(run, phase: str) -> int:
    return sum(c["frames"] for c in run.calls(phase))
