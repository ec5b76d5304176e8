"""A run of the harness on the CPU at a small geometry, with the
program sound, with its lower-precision control, and with each fault of
``faults.py`` planted underneath the timed calls: the comparison with
the reference passes the first and fails the others."""

import hashlib
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, faults, reference, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in run.load_spec()["workloads"]]


def small(workload, frames=None):
    """The cell's configuration and mix at 64x48 (and, for the GOP-30
    cell, 40 frames, so that a clip holds two scheduled keyframes)."""
    cell, config, traffic = run.resolve(run.load_spec(), workload)
    config = dict(config, width=64, height=48)
    if frames is None:
        frames = 40 if config["compressor"]["keyframe_interval"] < 40 else 20
    return config, dict(traffic, frames=frames)


def run_small(workload, seed=2**33 + 11, seconds=0, config=None, **kw):
    cfg, traffic = small(workload)
    return run.run_cell(config or cfg, traffic, seed, seconds, device="cpu",
                        log=lambda m: None, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = run_small(workload, seconds=0.3)
    assert len(out["runs"]) >= 1 and out["failed"] == 0
    assert out["numbers"] == {k: 0 for k in reference.LIMITS}
    rec = out["record"]
    assert len(rec.calls("compress_video")) == len(out["runs"])
    assert len(rec.calls("decompress_video")) == len(out["runs"])
    assert rec.setup_s > 0 and run.forbidden_modules() == []


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The program's near-lossless path (``exact=False``), the
    configuration's lossless guarantee broken."""
    config, _ = small(workload)
    config = dict(config, compressor=dict(config["compressor"], exact=False))
    out = run_small(workload, config=config)
    assert out["failed"] == len(out["runs"]) >= 1
    assert out["numbers"]["frames_wrong"] > 0


def expected(workload):
    """(fault, the number it has to move) for each fault the cell can
    have: skipped keyframes need a clip with two scheduled keyframes."""
    out = [("hold_state", "frames_wrong"), ("drop_half", "frames_wrong"),
           ("drop_records", "records_off"), ("alter", "frames_wrong")]
    config, traffic = small(workload)
    if traffic["frames"] > config["compressor"]["keyframe_interval"]:
        out.append(("skip_keys", "keys_off"))
    return [(workload, f, n) for f, n in out]


@pytest.mark.parametrize("workload,fault,number",
                         [e for cell in CELLS for e in expected(cell)])
def test_a_planted_fault_is_not_correct(workload, fault, number):
    with faults.planted(fault):
        out = run_small(workload)
    assert out["failed"] >= 1
    assert out["numbers"][number] > 0
    assert not reference.within_limits(out["numbers"])


def test_a_corrupted_decoded_frame_fails():
    clip = run.make_clip(*small(CELLS[0], frames=3), seed=4).planes
    data = b"BFV2" + (3).to_bytes(4, "little") + b"".join(
        (1).to_bytes(4, "little") + b"\x01" for _ in range(3))
    bad = [(p[0].copy(),) for p in clip]
    bad[1][0][5, 7, 2] ^= 0x40
    good = {"file": data, "decoded": [reference.digest(p) for p in clip]}
    assert reference.judge(clip, 30, [good]) == [{
        "frames_wrong": 0, "records_off": 0, "keys_off": 0}]
    worse = dict(good, decoded=[reference.digest(p) for p in bad])
    assert reference.judge(clip, 30, [worse])[0]["frames_wrong"] == 1
    short = dict(good, decoded=good["decoded"][:2])
    assert reference.judge(clip, 30, [short])[0]["frames_wrong"] == 1
    failed = dict(good, decoded=None)
    assert reference.judge(clip, 30, [failed])[0]["frames_wrong"] == 3


def test_the_file_checks():
    rec = [b"\x01k", b"\x03i", b"\x0fk", b"\x06i"]
    data = b"BFV2" + len(rec).to_bytes(4, "little") + b"".join(
        len(r).to_bytes(4, "little") + r for r in rec)
    assert reference.parse_records(data) == rec
    assert reference.judge_file(data, 4, 2) == {"records_off": 0,
                                                "keys_off": 0}
    # frame 1 is scheduled but holds an inter record; a record too many
    assert reference.judge_file(data, 3, 1) == {"records_off": 1,
                                                "keys_off": 1}
    for broken in (data[:-1], data + b"\x00", b"BFVC" + data[4:]):
        assert reference.parse_records(broken) is None
        assert reference.judge_file(broken, 4, 2) == {"records_off": 4,
                                                      "keys_off": 2}


def test_every_cell_and_metric_resolves_to_its_files():
    spec = run.load_spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for cell in spec["workloads"]:
        _, config, traffic = run.resolve(spec, cell["name"])
        assert {"width", "height", "color_space", "compressor"} <= set(config)
        assert traffic["frames"] > run.WARM_FRAMES
        names = [m["name"] for m, _ in run.metrics_for(spec, cell["name"],
                                                        False)]
        assert "setup_s" in names and len(names) >= 2
        assert run.metrics_for(spec, cell["name"], True)
    for m in spec["end_to_end"]:
        mod = run.load_metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"])
    for m in spec["per_layer"]:
        mod = run.load_metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert m["moves"] in e2e


def test_metrics_go_to_their_cells_by_name():
    """A per-layer metric without ``workloads`` reaches every cell that
    reports the end-to-end metric it moves, a cell added later too; a
    metric with ``workloads`` reaches those cells alone."""
    spec = run.load_spec()
    spec = dict(spec, workloads=spec["workloads"] + [
        dict(spec["workloads"][0], name="added-later")])
    for cell in [w["name"] for w in spec["workloads"]]:
        got = [m["name"] for m, _ in run.metrics_for(spec, cell, True)]
        assert got == [m["name"] for m in spec["per_layer"]
                       if cell in m.get("workloads", [cell])]
    got = [m["name"] for m, _ in run.metrics_for(spec, "added-later", True)]
    assert got and got == [m["name"] for m in spec["per_layer"]
                           if "workloads" not in m]
    listed = [dict(m, workloads=[CELLS[0]]) for m in spec["per_layer"]]
    e2e = [dict(m, workloads=[CELLS[0]]) if m["name"] == "stored_pct"
           else m for m in spec["end_to_end"]]
    spec = dict(spec, per_layer=listed, end_to_end=e2e)
    assert len(run.metrics_for(spec, CELLS[0], True)) == len(listed)
    assert run.metrics_for(spec, "added-later", True) == []
    assert "stored_pct" in [m["name"] for m, _ in
                            run.metrics_for(spec, CELLS[0], False)]
    assert "stored_pct" not in [m["name"] for m, _ in
                                run.metrics_for(spec, "added-later", False)]


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_the_result_line_keeps_its_keys():
    """``main`` on a faked card: the keys the driver reads, in order, the
    checks last."""
    import torch
    import unittest.mock as mock

    config, traffic = small(CELLS[0], frames=20)
    real = run.run_cell

    def on_cpu(cfg, trf, seed, seconds, trace=False, device="", log=print):
        return real(config, traffic, seed, 0, trace=trace, device="cpu",
                    log=log)

    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1), \
            mock.patch.object(run, "run_cell", on_cpu), \
            mock.patch.object(run, "power_limit", lambda: "n/a"):
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert run.main(["--workload", CELLS[0], "--seed", "9",
                             "--seconds", "0", "--trace", "0"]) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True
    assert set(result["metrics"]) == {"compress_fps", "decompress_fps",
                                      "stored_pct", "setup_s"}
    assert result["checks"]["frames_wrong"] == {"value": 0, "limit": 0}


def test_benchmark_json_keeps_its_shape():
    """Names, units, keys and lengths as the benchmark's contract sets
    them, so that an added entry that breaks one fails here first."""
    import re
    spec = run.load_spec()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(name.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")


# The three BGR cells at 64x48 (``small``) on seed 2**33 + 11, as the
# parent of the I420 layout gave them: SHA-256 over the digests of the
# clip's frames and of the warm frames, and each call's raw bytes.
PINNED = {
    "bgr1080-gop30-static": (
        "481f889553b66afdeea8754312c152ca3924e619660dc03246d354083f9fce68",
        "88d22f24bf91c45c27bcd829494654a58232a9bc8436b684dd26fac9bb46f507",
        368640),
    "bgr1080-gop250-pan": (
        "474173f6575f19cffc637b9c1778a2e13ab5e8e1febbe72acd48c55c58cf17e6",
        "69069abca70227d41a1cfb9deb717b45dcf6bc1a969a9b2b76bf0ac8591982ad",
        184320),
    "bgr1080-gop30-sensor": (
        "a15f7e117d73dc5663ffb8148eb9fa9b3f4f7a8531be00882e2e5b31a15c91e4",
        "994ee2976d3c8c9fcd4235dde5612ac37f665c428ad7f3917b2bf96f86a49b8b",
        368640),
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_the_interleaved_cells_are_made_counted_and_judged_as_before(
        workload):
    config, traffic = small(workload)
    assert run.layout_of(config) == "interleaved"
    seed = 2**33 + 11
    clip = run.make_clip(config, traffic, seed)
    warm = run.warm_clip(config, traffic, seed, clip)

    def digest(frames):
        return hashlib.sha256(b"".join(reference.digest((f,))
                                       for f in frames)).hexdigest()

    want_clip, want_warm, want_raw = PINNED[workload]
    assert (digest(clip.frames), digest(warm)) == (want_clip, want_warm)
    assert clip.planes == [(f,) for f in clip.frames]
    assert clip.raw_bytes == want_raw
    out = run.run_cell(config, traffic, seed, 0, device="cpu",
                       log=lambda m: None)
    assert {c["raw_bytes"] for c in out["record"].all_calls} == {want_raw}
    assert out["numbers"] == {k: 0 for k in reference.LIMITS}
    assert out["failed"] == 0
    assert hashlib.sha256(b"".join(out["runs"][0]["decoded"])
                          ).hexdigest() == want_clip


# -- the I420 layout ---------------------------------------------------------

MIXES = sorted(f[:-len(".json")] for f in
               os.listdir(os.path.join(ROOT, "portbench", "traffic")))


def small_i420(mix, frames=40, **compressor):
    """An I420 planar configuration at 64x48 under ``mix``: 40 frames,
    two scheduled keyframes of each plane sequence at GOP 30."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "bgr1080-gop30.json")) as fh:
        config = json.load(fh)
    config = dict(config, layout="I420", color_space="YUV", width=64,
                  height=48, compressor=dict(config["compressor"],
                                             profile="planar", **compressor))
    with open(os.path.join(ROOT, "portbench", "traffic", mix + ".json")) as fh:
        traffic = dict(json.load(fh), frames=frames)
    return config, traffic


def run_i420(mix, seconds=0, **compressor):
    config, traffic = small_i420(mix, **compressor)
    return run.run_cell(config, traffic, 2**33 + 13, seconds, device="cpu",
                        log=lambda m: None)


@pytest.mark.parametrize("mix", MIXES)
def test_an_i420_run_is_correct_and_counts_the_planes(mix):
    out = run_i420(mix, seconds=0.3)
    assert len(out["runs"]) >= 1 and out["failed"] == 0
    assert out["numbers"] == {k: 0 for k in reference.LIMITS}
    calls = out["record"].all_calls
    assert {c["raw_bytes"] for c in calls} == {64 * 48 * 3 // 2 * 40}
    assert {c["frames"] for c in calls} == {40}


@pytest.mark.parametrize("mix", MIXES)
def test_the_i420_control_is_not_correct(mix):
    out = run_i420(mix, exact=False)
    assert out["failed"] == len(out["runs"]) >= 1
    assert out["numbers"]["frames_wrong"] > 0


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fault,number", [
    ("hold_state", "frames_wrong"), ("drop_half", "frames_wrong"),
    ("drop_records", None), ("skip_keys", "keys_off"),
    ("alter", "frames_wrong")])
def test_a_planted_fault_in_an_i420_run_is_not_correct(mix, fault, number):
    """Each fault as ``control.py`` reads it.  A planar file that has lost
    half its records does not decode: the warm round trip raises, and the
    run ends with no result (``number`` None)."""
    config, traffic = small_i420(mix)
    line = control.read(config, traffic, 2**33 + 13, fault, "cpu")
    assert line["passed"] is False
    if number is None:
        assert "planar stream truncated" in line["errors"][0]
        assert "frames_wrong" not in line
    else:
        assert line[number] > 0 and line["errors"] == []


def test_a_program_that_raises_in_set_up_prints_no_result():
    """``main`` on a faked card, an I420 run with the planar file's
    records halved: the warm round trip raises, and the exception ends
    the run before any result is printed."""
    import io
    import torch
    import unittest.mock as mock
    from contextlib import redirect_stdout

    config, traffic = small_i420("static")
    real = run.run_cell

    def on_cpu(cfg, trf, seed, seconds, trace=False, device="", log=print):
        return real(config, traffic, seed, 0, trace=trace, device="cpu",
                    log=log)

    buf = io.StringIO()
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1), \
            mock.patch.object(run, "run_cell", on_cpu), \
            faults.planted("drop_records"), redirect_stdout(buf), \
            pytest.raises(ValueError, match="planar stream truncated"):
        run.main(["--workload", CELLS[0], "--seed", "9", "--seconds", "0",
                  "--trace", "0"])
    assert buf.getvalue() == ""
    sound = control.read(config, traffic, 9, "program", "cpu")
    assert sound["passed"] is True and sound["errors"] == []


def test_the_program_gets_i420_frames_as_read_raw_yuv_makes_them():
    from new_bloom_filter_repo_tpu_torch.utils.videoio import read_raw_yuv
    import tempfile

    config, traffic = small_i420("pan", frames=3)
    clip = run.make_clip(config, traffic, 7)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.yuv")
        with open(path, "wb") as fh:
            for planes in clip.planes:
                fh.write(b"".join(p.tobytes() for p in planes))
        assert os.path.getsize(path) == clip.raw_bytes
        read = read_raw_yuv(path, 64, 48, "I420")
    for got, want, planes in zip(clip.frames, read, clip.planes):
        assert np.array_equal(got.data, want.data)
        assert got.yuv_info["format"] == "I420"
        for k, p in zip(run.PLANES, planes):
            assert got.yuv_info[k] is p
            assert np.array_equal(want.yuv_info[k], p)
        assert clip.decoded_planes(want) == tuple(
            want.yuv_info[k] for k in run.PLANES)
        assert reference.digest(clip.decoded_planes(want)) == \
            reference.digest(planes)


@pytest.mark.parametrize("change,error", [
    ({"layout": "NV12"}, "unknown layout"),
    ({"color_space": "BGR"}, "YUV"),
    ({"compressor": {"profile": "blocked"}}, "planar")])
def test_a_configuration_that_cannot_hold_its_layout_is_refused(change,
                                                                 error):
    config, _ = small_i420("static")
    assert run.layout_of(config) == "I420"
    config = dict(config, **change)
    with pytest.raises(ValueError, match=error):
        run.layout_of(config)


def header(fmt=b"I420", frames=4, counts=(4, 4, 4), tail=b""):
    return (struct.pack("<BH", 5, len(fmt)) + fmt
            + struct.pack("<IIIB", 64, 48, frames, len(counts))
            + struct.pack(f"<{len(counts)}I", *counts) + tail)


def planar_file(n=4, interval=2, header=None, drop=None, v_inter=None):
    """A sound I420 planar container of ``n`` frames (keyframe records
    at every ``interval``-th position of each plane sequence), or one
    with the header given, record ``drop`` left out, or V's record at
    ``v_inter`` an inter record."""
    if header is None:
        header = (struct.pack("<BH", 5, 4) + b"I420"
                  + struct.pack("<IIIB3I", 64, 48, n, 3, n, n, n))
    seq = [b"\x0fk" if i % interval == 0 else b"\x06i" for i in range(n)]
    v = list(seq)
    if v_inter is not None:
        v[v_inter] = b"\x03i"
    records = [header] + seq + seq + v
    if drop is not None:
        del records[drop]
    return b"BFV2" + struct.pack("<I", len(records)) + b"".join(
        struct.pack("<I", len(r)) + r for r in records)


def test_the_planar_judge_passes_a_sound_file():
    data = planar_file()
    assert reference.parse_planar_header(
        reference.parse_records(data)[0]) == {
            "format": "I420", "width": 64, "height": 48, "frame_count": 4,
            "plane_counts": [4, 4, 4]}
    assert reference.judge_file(data, 4, 2, "I420") == {"records_off": 0,
                                                        "keys_off": 0}
    # the layout is the configuration's: judged as one record a frame,
    # the same file is off by the header and two planes
    assert reference.judge_file(data, 4, 2)["records_off"] == 9


FILE_FAULTS = {
    # a record left out: V's at a scheduled position (the next one moves
    # into it), or U's first (U's and V's keys all shift onto inter
    # records)
    "drop_v2": (planar_file(drop=11), 1, 1),
    "drop_u0": (planar_file(drop=5), 1, 4),
    "frame_count": (planar_file(header=header(frames=5)), 1, 0),
    "plane_count": (planar_file(header=header(counts=(4, 4, 4, 0))), 5, 0),
    "plane_records": (planar_file(header=header(counts=(4, 3, 4))), 1, 0),
    "format": (planar_file(header=header(fmt=b"YV12")), 1, 0),
    "header_tail": (planar_file(header=header(tail=b"\x00")), 1, 0),
    "header_type": (planar_file(header=b"\x01" + header()[1:]), 1, 0),
    "v_scheduled_inter": (planar_file(v_inter=2), 0, 1),
    "v_unscheduled_inter": (planar_file(v_inter=1), 0, 0),
    "no_container": (planar_file()[:-1], 13, 6),
}


@pytest.mark.parametrize("fault", sorted(FILE_FAULTS))
def test_the_planar_judge_counts_each_fault_of_the_file(fault):
    data, off, keys = FILE_FAULTS[fault]
    assert reference.judge_file(data, 4, 2, "I420") == {"records_off": off,
                                                        "keys_off": keys}


def test_a_flipped_byte_in_a_decoded_u_plane_fails():
    config, traffic = small_i420("static", frames=3)
    clip = run.make_clip(config, traffic, 4).planes
    good = {"file": planar_file(n=3, interval=30),
            "decoded": [reference.digest(p) for p in clip]}
    assert reference.judge(clip, 30, [good], "I420") == [{
        "frames_wrong": 0, "records_off": 0, "keys_off": 0}]
    y, u, v = (p.copy() for p in clip[1])
    u[3, 5] ^= 0x01
    bad = dict(good, decoded=list(good["decoded"]))
    bad["decoded"][1] = reference.digest((y, u, v))
    assert reference.judge(clip, 30, [bad], "I420")[0]["frames_wrong"] == 1
    failed = {"file": None, "decoded": None}
    assert reference.judge(clip, 30, [failed], "I420") == [{
        "frames_wrong": 3, "records_off": 10, "keys_off": 3}]
