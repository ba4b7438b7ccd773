"""On the card, at each cell's own size: the float8 control and the faults
that the training cell can have fail the cell's limits, and the program
on the same seeds passes them. Needs an NVIDIA H100 and about twelve
minutes: ``python -m pytest benchmark/tests/test_benchmark_card.py``.
``benchmark/tools/calibrate.py`` takes the same readings on a dozen
seeds and more, which is where the limits came from."""

import contextlib

import pytest

from benchmark import harness, traffic, weights
from benchmark.kinds import serve, train
from benchmark.tools import faults

SEEDS = (2147483801, 2147483802, 2147483803)


def _cell(workload, seed, device, seconds=51.0):
    cell = harness.resolve(harness.load_benchmark(), workload, seed=seed,
                           seconds=seconds)
    # the allocator reads its setting when the process first allocates
    harness.set_environment(cell.mix)
    cell.device = device
    return cell


def _correct(cell, numbers):
    """The harness's verdict on ``numbers`` beside the cell's limits."""
    return harness.judge(train.checks(numbers, cell.limits))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_faults_fail_the_limits(card, seed):
    import gc

    import torch
    cell = _cell("mistral-7b.train.t4096", seed, card)
    d = cell.dims
    readings = {}
    for name in ("program", "half_batch"):
        plant = (faults.TRAIN[name]() if name != "program"
                 else contextlib.nullcontext())
        with plant:
            params = weights.make_params(d, seed, card)
            deck = traffic.train_deck(cell.mix, seed, d.vocab, card)
            step, state = train.make_step(cell, params)
            del params
            state, readings[name] = train.program_readings(cell, step,
                                                           state, deck)
            del state, step
        gc.collect()
        torch.cuda.empty_cache()
    ref = train.reference_readings(cell, deck)
    readings["control"] = train.reference_readings(cell, deck, "fp8")
    numbers = {k: train.compare(r, ref) for k, r in readings.items()}
    assert _correct(cell, numbers["program"]), numbers
    assert not _correct(cell, numbers["control"]), numbers
    assert not _correct(cell, numbers["half_batch"]), numbers


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails_the_limit(card, seed):
    import time
    cell = _cell("mixtral-8x7b.serve.chat", seed, card)
    cell.control, cell.t_process = True, time.perf_counter()
    run = serve.run(cell)
    assert harness.judge(run["checks"]), run["checks"]
    assert not harness.judge(cell.control_checks), cell.control_checks
