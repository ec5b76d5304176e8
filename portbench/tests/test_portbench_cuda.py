"""The harness on the card at a small geometry: a sound run passes, the
control and a planted fault fail, and the traced run gives every
per-layer metric.  Marked ``cuda``; they skip without a card:

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import pytest

from portbench import faults, reference, run

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in run.load_spec()["workloads"]]


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch.cuda.is_available() is "
                    "False here")
    return "cuda:0"


def small(workload, **compressor):
    _, config, traffic = run.resolve(run.load_spec(), workload)
    config = dict(config, width=320, height=180,
                  compressor=dict(config["compressor"], **compressor))
    frames = 40 if config["compressor"]["keyframe_interval"] < 40 else 24
    return config, dict(traffic, frames=frames)


def run_small(card, workload, seconds=0, trace=False, **compressor):
    config, traffic = small(workload, **compressor)
    return run.run_cell(config, traffic, 2**32 + 17, seconds, trace=trace,
                        device=card, log=lambda m: None)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_on_the_card_is_correct(card, workload):
    out = run_small(card, workload, seconds=1)
    assert out["failed"] == 0 and len(out["runs"]) >= 1
    assert reference.within_limits(out["numbers"])
    assert out["memory_peak_bytes"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_on_the_card_is_not_correct(card, workload):
    out = run_small(card, workload, exact=False)
    assert out["numbers"]["frames_wrong"] > 0


@pytest.mark.parametrize("fault", ["hold_state", "alter"])
def test_a_fault_on_the_card_is_not_correct(card, fault):
    with faults.planted(fault):
        out = run_small(card, CELLS[1])
    assert out["numbers"]["frames_wrong"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_traced_run_gives_every_per_layer_metric(card, workload):
    out = run_small(card, workload, seconds=1, trace=True)
    assert out["failed"] == 0
    rec = out["record"]
    assert rec.trace.busy_us() > 0 and rec.trace.kernels
    for entry, mod in run.metrics_for(run.load_spec(), workload, True):
        value = mod.read(rec)
        if rec.device_kind in run.tracestats.peaks.HBM_BYTES_PER_S or (
                "roofline" not in entry["name"]):
            assert value is not None, entry["name"]
        if value is not None and entry["unit"] == "%":
            assert 0 <= value <= 100, (entry["name"], value)


def small_i420(mix, **compressor):
    """An I420 planar configuration at 320x180 under ``mix``, 40 frames:
    two scheduled keyframes of each plane sequence at GOP 30."""
    import json
    import os
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(bench, "configs", "bgr1080-gop30.json")) as fh:
        config = json.load(fh)
    config = dict(config, layout="I420", color_space="YUV", width=320,
                  height=180, compressor=dict(config["compressor"],
                                              profile="planar", **compressor))
    with open(os.path.join(bench, "traffic", mix + ".json")) as fh:
        traffic = dict(json.load(fh), frames=40)
    return config, traffic


@pytest.mark.parametrize("mix", ["static", "pan", "sensor"])
def test_an_i420_run_on_the_card_is_correct_and_its_control_is_not(card,
                                                                   mix):
    config, traffic = small_i420(mix)
    out = run.run_cell(config, traffic, 2**32 + 19, 0, device=card,
                       log=lambda m: None)
    assert out["failed"] == 0 and reference.within_limits(out["numbers"])
    config, traffic = small_i420(mix, exact=False)
    out = run.run_cell(config, traffic, 2**32 + 19, 0, device=card,
                       log=lambda m: None)
    assert out["numbers"]["frames_wrong"] > 0
