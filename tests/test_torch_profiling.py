"""The port's ``nbf.*`` spans (``utils/profiling.span``): off, a round
trip keeps nothing and never opens a ``record_function``; under a
``torch.profiler`` session on the CPU the main thread's spans are in the
Chrome trace, the finish worker's and the keyframe pool's are kept with
their thread, and the benchmark's mapping (``portbench/programspans.py``)
puts them inside the calls that caused them; the file's bytes never
change.

The clip: 20 frames of ``static_gentle`` and 20 with noise on every
pixel, 64x48, a keyframe every 30 frames, so that one round trip takes
two scheduled keyframes, blocked and pass-through records, the
keyframe trials inside ``finish()`` and the residual records the host
applies on decode.
"""

import json
import os
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from new_bloom_filter_repo_tpu_torch.models import video
from new_bloom_filter_repo_tpu_torch.models.video import (
    ImprovedVideoCompressor,
)
from new_bloom_filter_repo_tpu_torch.utils import profiling
from new_bloom_filter_repo_tpu_torch.utils.synthetic import (
    SUITE,
    generate_frames,
)
from portbench import programspans, tracestats
from portbench.run import Record

MAIN_COMPRESS = ("nbf.compress", "nbf.upload", "nbf.enc_device_phase_a",
                 "nbf.enc_param_math", "nbf.enc_pull", "nbf.write_bfvc",
                 "nbf.wait_keyframe", "nbf.wait_finish")
MAIN_DECOMPRESS = ("nbf.decompress", "nbf.read_bfvc", "nbf.keyframe_decode",
                   "nbf.dec_parse", "nbf.dec_device_membership",
                   "nbf.dec_host_slices", "nbf.dec_expand_pull",
                   "nbf.residual_apply")
WORKER = ("nbf.keyframe", "nbf.keyframe_deflate", "nbf.keyframe_sectioned",
          "nbf.finish", "nbf.enc_host_sections", "nbf.enc_deflate",
          "nbf.enc_assembly", "nbf.pull_lazy")


def make_clip():
    quiet = generate_frames(20, 64, 48, seed=4, **SUITE["static_gentle"])
    noisy = generate_frames(20, 64, 48, seed=4, **dict(
        SUITE["static_gentle"], noise=2.6, noise_frac=1.0))
    return quiet + noisy


def round_trip(path, span=lambda name: record_function(name)):
    """compress_video and decompress_video as the benchmark calls them,
    each inside its span; returns the file's bytes."""
    comp = ImprovedVideoCompressor(keyframe_interval=30, device="cpu",
                                   verbose=False)
    clip = make_clip()
    with span("compress_video"):
        comp.compress_video(clip, path)
    with span("decompress_video"):
        out = comp.decompress_video(path)
    for got, want in zip(out, clip):
        np.testing.assert_array_equal(np.asarray(got), want)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One round trip under a profiler session: the file, the parsed
    trace, the kept spans and the record the benchmark's readers get."""
    tmp = tmp_path_factory.mktemp("traced")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data = round_trip(str(tmp / "on.bfvc"))
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    calls = [{"phase": p, "seconds": 1.0, "frames": 40, "raw_bytes": 1,
              "stored_bytes": 1}
             for p in ("compress_video", "decompress_video")]
    rec = Record(calls, 0.0, tracestats.Trace(events), "cpu")
    return {"bytes": data, "events": events, "kept":
            profiling.recorded_spans(), "record": rec}


def test_span_off_is_one_shared_no_op(tmp_path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.clear_spans()
    assert profiling.span("nbf.a") is profiling.span("nbf.b")
    assert profiling.span("nbf.a") is profiling._NOOP
    round_trip(str(tmp_path / "off.bfvc"), span=profiling.span)
    assert profiling.recorded_spans() == []


def test_stage_times_are_kept_under_the_old_keys_without_a_profiler():
    profiling.clear_spans()
    times = {}
    with profiling.span("nbf.outer", times):
        with profiling.stages(times) as stage:
            stage.next("nbf.enc_deflate")
            stage.next("nbf.enc_assembly")
    with pytest.raises(KeyError):
        with profiling.stages(times) as stage:
            stage.next("nbf.enc_deflate")
            raise KeyError("the open stage still ends")
    assert set(times) == {"outer", "enc_deflate", "enc_assembly"}
    assert all(v >= 0 for v in times.values())
    assert times["outer"] >= times["enc_assembly"]
    assert profiling.recorded_spans() == []


@pytest.mark.parametrize("name", MAIN_COMPRESS + MAIN_DECOMPRESS)
def test_the_trace_holds_each_main_thread_span(traced, name):
    main = {ev["tid"] for ev in traced["events"]
            if ev.get("name") == "compress_video"}
    found = [ev for ev in traced["events"]
             if ev.get("name") == name and ev.get("cat") == "user_annotation"]
    assert found and {ev["tid"] for ev in found} <= main


@pytest.mark.parametrize("name", WORKER)
def test_the_worker_spans_are_kept_from_another_thread(traced, name):
    main = threading.main_thread().ident
    threads = {s.thread for s in traced["kept"] if s.name == name}
    assert threads and main not in threads


def test_the_worker_spans_are_not_in_the_trace(traced):
    names = {ev.get("name") for ev in traced["events"]}
    assert "nbf.finish" not in names and "nbf.enc_deflate" not in names


def test_mapped_worker_spans_lie_inside_a_compress_call(traced):
    rec = traced["record"]
    main = threading.main_thread().ident
    spans = programspans.mapped(rec)
    worker = [s for s in spans if s.thread != main]
    assert {s.name for s in worker} == set(WORKER)
    (c0, c1), = rec.trace.spans["compress_video"]
    for s in worker:
        assert c0 <= s.start <= s.end <= c1, s


def test_main_thread_spans_map_onto_their_own_trace_events(traced):
    rec = traced["record"]
    main = threading.main_thread().ident
    events = sorted((a, b) for a, b, n in rec.trace.host
                    if n == "nbf.enc_pull")
    ours = sorted((s.start, s.end) for s in programspans.mapped(rec)
                  if s.thread == main and s.name == "nbf.enc_pull")
    assert len(events) == len(ours) == 3
    # the kept clock starts after record_function opened and stops
    # before it closes; the offset is a median, so a span may sit a few
    # microseconds off its event
    for (a, b), (x, y) in zip(events, ours):
        assert a - 50 <= x <= y <= b + 50 and abs((b - a) - (y - x)) < 1e3


def test_each_wait_ends_after_the_job_it_awaited(traced):
    """The k-th wait on a keyframe returns after the k-th scheduled
    keyframe (one with no span around it on the worker) ended, the k-th
    wait on a ``finish()`` after the k-th ``nbf.finish``: a wait that
    began before its job ended overlaps it.  The noisy chunks' finish()
    outlasts the next chunk's device phase, so some wait does."""
    main = threading.main_thread().ident

    def of(name, thread_is_main, **kw):
        return sorted((s for s in traced["kept"] if s.name == name
                       and (s.thread == main) == thread_is_main
                       and all(getattr(s, k) == v for k, v in kw.items())),
                      key=lambda s: s.start_ns)

    overlapped = 0
    for wait, job in ((of("nbf.wait_keyframe", True),
                       of("nbf.keyframe", False, parent=None)),
                      (of("nbf.wait_finish", True),
                       of("nbf.finish", False))):
        assert len(wait) == len(job) > 0
        for w, j in zip(wait, job):
            assert j.end_ns <= w.end_ns, (w, j)
            overlapped += w.start_ns < j.end_ns
    assert overlapped


def test_the_kept_parents(traced):
    by = {}
    for s in traced["kept"]:
        by.setdefault(s.name, set()).add(s.parent)
    assert by["nbf.compress"] == {None} and by["nbf.finish"] == {None}
    assert by["nbf.enc_deflate"] == {"nbf.finish"}
    assert by["nbf.residual_apply"] == {"nbf.decompress"}
    # a keyframe is scheduled (no parent on the worker) or a trial
    # inside the record assembly of a finish()
    assert by["nbf.keyframe"] == {None, "nbf.enc_assembly"}


@pytest.mark.parametrize("how", ["off", "on", "serial"])
def test_the_file_is_the_same_traced_or_not(traced, tmp_path, monkeypatch,
                                            how):
    path = str(tmp_path / "x.bfvc")
    if how == "off":
        assert round_trip(path) == traced["bytes"]
        return
    if how == "serial":
        monkeypatch.setenv("NBF_OVERLAP", "0")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        assert round_trip(path) == traced["bytes"]
    names = {s.name for s in profiling.recorded_spans()}
    threads = {s.thread for s in profiling.recorded_spans()}
    if how == "serial":
        # every job inline, on the main thread, with no wait
        assert threads == {threading.main_thread().ident}
        assert "nbf.finish" in names and "nbf.wait_finish" not in names
    else:
        # the main thread, the finish worker, and the keyframe pool's
        # threads, which run the scheduled keyframes (no parent) apart
        # from every finish()
        main = threading.main_thread().ident
        kept = profiling.recorded_spans()
        finish = {s.thread for s in kept if s.name == "nbf.finish"}
        keys = {s.thread for s in kept
                if s.name == "nbf.keyframe" and s.parent is None}
        assert len(finish) == 1 and main not in finish | keys
        assert keys and not keys & finish
        assert len(keys) <= video.keyframe_pool_width(2)
        assert threads == {main} | finish | keys
        assert "nbf.wait_finish" in names


def test_the_operators_trace_shows_the_worker(tmp_path, monkeypatch):
    """``profiling.trace`` records every thread where the installed
    PyTorch can, so the worker's spans are in its Chrome trace."""
    if profiling._all_threads_config() is None:
        pytest.skip("this PyTorch profiles the starting thread alone")
    monkeypatch.delenv("NBF_TRACE_DIR", raising=False)
    out = tmp_path / "traces"
    with profiling.trace(str(out)):
        round_trip(str(tmp_path / "t.bfvc"))
    (name,) = os.listdir(out)
    with open(out / name) as fh:
        events = json.load(fh)["traceEvents"]
    main = {ev["tid"] for ev in events if ev.get("name") == "nbf.compress"}
    finish = {ev["tid"] for ev in events if ev.get("name") == "nbf.finish"}
    assert main and finish and not main & finish

