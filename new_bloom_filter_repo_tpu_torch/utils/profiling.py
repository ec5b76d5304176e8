"""Tracing and profiling.

The port of ``new_bloom_filter_repo_tpu.utils.profiling``: ``trace()``
wraps a region in a ``torch.profiler`` trace (host activities and, on a
CUDA card, the card's; written as a Chrome trace, viewable in Perfetto),
``Timer`` collects named span timings that pipelines can attach to
their stats dicts, and ``measure_host_stages`` reads the per-stage wall
costs of the blocked pipeline from its own ``stage_times``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace around a region.

    Enabled by passing log_dir or setting NBF_TRACE_DIR; otherwise a
    no-op so hot paths can keep the call site unconditionally.  The
    Chrome trace ``trace_<pid>_<ns>.json`` is written into the directory
    when the region ends.
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
