"""Shared fixtures of the benchmark's tests.

Run them from the checkout's root: ``python -m pytest benchmark/tests``.
Tests marked ``card`` need an NVIDIA GPU and the cells' full sizes; they
skip elsewhere (deciding inside the test, through the ``card`` fixture).
Every other test runs on the CPU at a tiny size.
"""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.models import dims  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU and "
                                       "runs a cell at its full size")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels at their full sizes")
    return torch.device("cuda", 0)


TINY_SIZES = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2)


def tiny_cell(workload: str, seed: int = 5, seconds: float = 3.0,
              trace: bool = False, dtype: str = "float32"):
    """The cell named ``workload`` cut to a CPU test's size: the same
    configuration keys and traffic parameters at toy widths, lengths and
    rates. Returns (BENCHMARK.json, cell)."""
    bench = harness.load_benchmark()
    cell = harness.resolve(bench, workload, seed=seed, seconds=seconds,
                           trace=trace)
    cfg = dict(cell.config, torch_dtype=dtype, **TINY_SIZES)
    if "num_local_experts" in cfg:
        cfg["num_local_experts"] = 4
    cell.config, cell.dims = cfg, dims(cfg)
    mix = copy.deepcopy(cell.mix)
    if mix["kind"] == "serve":
        mix.update(slots=4, capacity=96, rate_per_s=4.0, ramp_s=1.0,
                   tail_s=5.0, trace_s=0.5, check_tokens=40,
                   check_tokens_min=10,
                   prompt=dict(mix["prompt"], median=20, min=8, max=64),
                   output=dict(mix["output"], median=8, min=4, max=24))
    else:
        mix.update(batch=2, seq=32, deck_batches=8, min_steps=2)
    cell.mix = mix
    cell.device = torch.device("cpu")
    cell.t_process = time.perf_counter()
    return bench, cell


@pytest.fixture
def tiny():
    """:func:`tiny_cell`."""
    return tiny_cell
