"""The harness end to end at a tiny size on the CPU: a sound run is
``correct``, and each fault planted under the timed path turns it false.
The look for a chip is skipped; the rest of a run is the cell's own."""

import json

import pytest

from benchmark import harness
from benchmark.kinds import serve, train
from benchmark.tools import faults


def _line(bench, cell, run):
    run["device_name"] = "NVIDIA H100 80GB HBM3"
    metrics = harness.read_metrics(
        harness.metrics_for(bench, cell.name, cell.trace), run)
    return harness.result_line(cell, run, metrics, "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_run_is_correct_and_reports_its_metrics(tiny, dtype):
    bench, cell = tiny("mixtral-8x7b.serve.chat", dtype=dtype)
    run = serve.run(cell)
    line = _line(bench, cell, run)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"serve_ttft_p90_ms", "serve_tpot_p90_ms",
                                    "serve_output_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] >= 4 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    json.dumps(line, allow_nan=False)


def test_traced_serving_run_reports_per_layer_metrics(tiny):
    # a window long beside the profiled span, whose start alone can take
    # a second on the CPU: admissions fall outside the span too
    bench, cell = tiny("mixtral-8x7b.serve.chat", trace=True, seconds=6.0)
    line = _line(bench, cell, serve.run(cell))
    assert line["correct"]
    for name in ("engine.decode_step_ms.chat", "engine.admit_ms.chat",
                 "model.decode_mfu.chat"):
        assert line["metrics"][name]["value"] > 0
    # no kernel of the card runs on the CPU: its roofline stays silent
    assert "kernel.paged_decode_roofline.chat" not in line["metrics"]
    assert "breakdown" in line and "window_s" in line["device"]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_a_serving_fault_is_not_correct(tiny, fault):
    bench, cell = tiny("mixtral-8x7b.serve.chat", seed=9)
    with faults.SERVE[fault]():
        run = serve.run(cell)
    assert not _line(bench, cell, run)["correct"]


@pytest.mark.parametrize("trace", [False, True])
def test_training_run_is_correct_and_reports_its_metrics(tiny, trace):
    bench, cell = tiny("mistral-7b.train.t4096", trace=trace, seconds=1.0)
    line = _line(bench, cell, train.run(cell))
    assert line["correct"], line["checks"]
    expect = ({"train.step_mfu", "device.idle_share.train"} if trace
              else {"train_tokens_per_s", "setup_s"})
    assert expect <= set(line["metrics"])
    assert set(line["checks"]) == {"grad_gap", "change_gap"}


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_training_fault_is_not_correct(tiny, fault):
    bench, cell = tiny("mistral-7b.train.t4096", seconds=0.5)
    with faults.TRAIN[fault]():
        line = _line(bench, cell, train.run(cell))
    assert not line["correct"], line["checks"]


def test_the_training_control_in_the_programs_place_is_not_correct(tiny):
    """The float8 reference's numbers in the program's place, beside the
    cell's limits, make the run's line not correct; the program's own
    numbers of the same run keep it correct."""
    bench, cell = tiny("mistral-7b.train.t4096", seconds=0.5)
    cell.control = True
    run = train.run(cell)
    assert _line(bench, cell, dict(run))["correct"], run["checks"]
    line = _line(bench, cell, dict(run, checks=cell.control_checks))
    assert not line["correct"], line["checks"]


def test_too_few_served_tokens_is_not_correct(tiny):
    bench, cell = tiny("mixtral-8x7b.serve.chat")
    cell.mix["check_tokens_min"] = 10**6
    assert not _line(bench, cell, serve.run(cell))["correct"]


def test_without_a_card_the_command_prints_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "mixtral-8x7b.serve.chat",
                         "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
