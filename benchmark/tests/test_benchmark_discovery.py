"""A cell, a traffic mix and a metric are added from files alone: the
harness finds each by the name ``BENCHMARK.json`` gives it."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.kinds import serve


@pytest.fixture
def root(tmp_path):
    """A copy of the benchmark's files, as a checkout would hold them."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def _add(root, tiny_config):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/mixtral-8x7b.json")
                     .read_text())
    cfg.update(tiny_config)
    (root / "benchmark/configs/tiny-moe.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/serve.chat.json").read_text())
    mix.update(rate_per_s=6.0, ramp_s=0.5, tail_s=5.0, slots=4, capacity=96,
               check_tokens=30, check_tokens_min=10,
               prompt={"dist": "uniform", "min": 8, "max": 40},
               output={"dist": "uniform", "min": 4, "max": 12})
    (root / "benchmark/traffic/serve.short.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/tiny-moe.serve.short.json").write_text(
        json.dumps({"max_logit_gap": 0.5}))
    (root / "benchmark/metrics/serve_requests_done.short.py").write_text(
        "def read(run):\n"
        "    return sum(1 for r in run['requests'] if r['times'])\n")
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "benchmark/configs/tiny-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-moe.serve.short",
                               "config": "tiny-moe",
                               "traffic": "serve.short", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "serve_requests_done.short",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "serve_output_tokens_per_s",
                               "workloads": ["tiny-moe.serve.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_new_cell_mix_and_metric_are_found_and_run(root):
    import time

    import torch

    from conftest import TINY_SIZES
    bench = _add(root, dict(TINY_SIZES, num_local_experts=4,
                            torch_dtype="float32"))
    cell = harness.resolve(bench, "tiny-moe.serve.short", root=root,
                           seed=11, seconds=2.0, trace=True)
    assert cell.mix["rate_per_s"] == 6.0 and cell.dims.n_experts == 4
    assert cell.limits == {"max_logit_gap": 0.5}
    names = [m["name"] for m in harness.metrics_for(bench, cell.name, True)]
    assert names == ["serve_requests_done.short"]
    assert "serve_requests_done.short" not in [
        m["name"] for m in harness.metrics_for(
            bench, "mixtral-8x7b.serve.chat", True)]
    cell.device, cell.t_process = torch.device("cpu"), time.perf_counter()
    run = serve.run(cell)
    got = harness.read_metrics(
        harness.metrics_for(bench, cell.name, True), run, root=root)
    assert got["serve_requests_done.short"]["value"] >= 1
    assert got["serve_requests_done.short"]["unit"] == "requests"
    assert harness.judge(run["checks"])


def test_a_missing_file_is_named(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark/limits/mistral-7b.train.t4096.json").unlink()
    with pytest.raises(FileNotFoundError, match="mistral-7b.train.t4096"):
        harness.resolve(bench, "mistral-7b.train.t4096", root=root)
    with pytest.raises(KeyError):
        harness.resolve(bench, "no-such-cell", root=root)
