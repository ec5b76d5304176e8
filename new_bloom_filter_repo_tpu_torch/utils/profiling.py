"""Tracing and profiling.

The port of ``new_bloom_filter_repo_tpu.utils.profiling``: ``trace()``
wraps a region in a ``torch.profiler`` trace (host activities of every
thread and, on a CUDA card, the card's; written as a Chrome trace,
viewable in Perfetto), ``Timer`` collects named span timings that
pipelines can attach to their stats dicts, and ``measure_host_stages``
reads the per-stage wall costs of the blocked pipeline from its own
``stage_times``.

``span(name, stage_times)`` marks where the program's host work
happens (the ``nbf.*`` spans of ``models/video.py``,
``models/blocked_pipeline.py`` and ``models/frame_codec.py``).  It
records only while a ``torch.profiler`` session records, or when a
``stage_times`` dict is given: otherwise it costs one read of a global
and returns a shared no-op.  While a session records, each span opens a
``record_function`` (a ``user_annotation`` in the Chrome trace, on the
trace's clock) and is kept in memory with its thread, start, end and
parent; ``recorded_spans()`` reads them back.  The kept spans include
those of the encoder's finish worker and keyframe pool threads, which a
profiler session started on the main thread does not show.  Their clock is
``time.time_ns()``; the main thread's spans, which are in the trace too,
map them onto the trace's.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace around a region.

    Enabled by passing log_dir or setting NBF_TRACE_DIR; otherwise a
    no-op so hot paths can keep the call site unconditionally.  The
    Chrome trace ``trace_<pid>_<ns>.json`` is written into the directory
    when the region ends.  Where the installed PyTorch can, the trace
    holds every thread's events, so the encoder's workers' ``nbf.*`` spans
    (keyframes, ``nbf.finish``) show beside the main thread's.
    """
    log_dir = log_dir or os.environ.get("NBF_TRACE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_all_threads_config()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _all_threads_config():
    """The profiler's setting that records every thread, or None where
    the installed PyTorch lacks it."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


# What a span kept: its name, the thread it ran on
# (``threading.get_ident()``), its start and end in ``time.time_ns()``,
# and the name of the span open around it on that thread (or None).
Span = collections.namedtuple("Span", "name thread start_ns end_ns parent")

# The spans of the sessions recorded so far; at most _KEEP, the oldest
# dropped first.
_KEEP = 1 << 18
_spans: collections.deque = collections.deque(maxlen=_KEEP)
_open = threading.local()
_NOOP = contextlib.nullcontext()


class _Span:
    """One span: kept (``keep``) and added to ``stage_times`` under its
    name without the ``nbf.`` prefix (where given)."""

    __slots__ = ("name", "stage_times", "keep", "rf", "parent", "t0")

    def __init__(self, name: str, stage_times: Optional[dict], keep: bool):
        self.name = name
        self.stage_times = stage_times
        self.keep = keep

    def __enter__(self):
        # Both stamps are taken before record_function's calls, which
        # let go of the interpreter lock: a thread that waits to take it
        # back then waits inside the span, on both clocks.
        self.t0 = time.time_ns()
        if self.keep:
            stack = _open.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.keep:
            self.rf.__exit__(*exc)
            _open.stack.pop()
            _spans.append(Span(self.name, threading.get_ident(), self.t0,
                               t1, self.parent))
        if self.stage_times is not None:
            key = self.name.removeprefix("nbf.")
            self.stage_times[key] = (self.stage_times.get(key, 0.0)
                                     + (t1 - self.t0) / 1e9)
        return False


def span(name: str, stage_times: Optional[dict] = None):
    """A context manager around one stage of the program's host work.

    Off (no profiler session recording, no ``stage_times``) it is one
    shared no-op.  While a session records, it opens
    ``record_function(name)`` and keeps the span (``recorded_spans``);
    with ``stage_times`` it adds the span's wall seconds under ``name``
    without its ``nbf.`` prefix."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, stage_times, True)
    if stage_times is not None:
        return _Span(name, stage_times, False)
    return _NOOP


class stages:
    """Consecutive spans over straight-line code, one open at a time:
    ``next(name)`` ends the open span and opens ``span(name,
    stage_times)``; leaving the ``with`` block ends the last one."""

    def __init__(self, stage_times: Optional[dict] = None):
        self.stage_times = stage_times
        self.current = None

    def next(self, name: str) -> None:
        self.end()
        self.current = span(name, self.stage_times)
        self.current.__enter__()

    def end(self) -> None:
        if self.current is not None:
            current, self.current = self.current, None
            current.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def recorded_spans() -> List[Span]:
    """The spans kept so far, in the order they ended."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


class Timer:
    """Named wall-clock spans with the reference's fps/seconds schema."""

    def __init__(self):
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.time() - t0

    def stats(self, frames: int = 0) -> Dict:
        out = {f"{k}_time": round(v, 4) for k, v in self.spans.items()}
        if frames:
            for k, v in self.spans.items():
                if v > 0:
                    out[f"{k}_fps"] = round(frames / v, 2)
        return out


# Host stage keys the instrumented pipeline reports
# (models/blocked_pipeline.py encode_chunk/decode_run stage_times).  The
# device stages it reports beside them: enc_device_phase_a,
# enc_device_kernel, enc_pull, dec_device_membership, dec_expand_pull.
ENC_HOST_KEYS = ("enc_param_math", "enc_host_sections", "enc_deflate",
                 "enc_assembly")
DEC_HOST_KEYS = ("dec_parse", "dec_host_slices")


def measure_host_stages(frames, reps: int = 2, device=None):
    """Per-stage wall costs of the blocked byte pipeline, measured from
    the instrumented real code path on a 15-frame chunk.

    ``frames``: >= 16 uniform uint8 frames (frame 0 is the base).
    ``device``: where the pipeline runs (default: the current CUDA card;
    ``"cpu"`` on request).  Returns (enc_host_s_per_frame,
    dec_host_s_per_frame, detail_ms_per_frame) — the two sums cover the
    host-CPU stages only; device dispatch and transfers are tracked
    under their own keys in the detail dict.
    """
    from new_bloom_filter_repo_tpu_torch.models import blocked_pipeline as bp

    base, chunk = frames[0], list(frames[1:16])
    enc = bp.BlockedEncoder(device=device)
    dec = bp.BlockedDecoder(device=device)
    warm = []
    enc.encode_chunk(base, chunk, warm)
    dec.decode_run(base, warm)
    st_enc, st_dec = {}, {}
    for _ in range(reps):
        payloads = []
        enc.encode_chunk(base, chunk, payloads, stage_times=st_enc)
        dec.decode_run(base, payloads, stage_times=st_dec)
    fr = len(chunk) * reps
    enc_host = sum(st_enc.get(k, 0.0) for k in ENC_HOST_KEYS) / fr
    dec_host = sum(st_dec.get(k, 0.0) for k in DEC_HOST_KEYS) / fr
    detail = {k: round(v / fr * 1e3, 3)
              for k, v in {**st_enc, **st_dec}.items()}
    return enc_host, dec_host, detail
