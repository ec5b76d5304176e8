"""A run of the harness on the CPU at a small geometry, with the
program sound, with its lower-precision control, and with each fault of
``faults.py`` planted underneath the timed calls: the comparison with
the reference passes the first and fails the others."""

import json
import os
import subprocess
import sys

import pytest

from portbench import faults, reference, run

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
    clip = run.make_clip(*small(CELLS[0], frames=3), seed=4)
    data = b"BFV2" + (3).to_bytes(4, "little") + b"".join(
        (1).to_bytes(4, "little") + b"\x01" for _ in range(3))
    bad = [f.copy() for f in clip]
    bad[1][5, 7, 2] ^= 0x40
    good = {"file": data, "decoded": [reference.frame_digest(f)
                                      for f in clip]}
    assert reference.judge(clip, 30, [good]) == [{
        "frames_wrong": 0, "records_off": 0, "keys_off": 0}]
    worse = dict(good, decoded=[reference.frame_digest(f) for f in bad])
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
