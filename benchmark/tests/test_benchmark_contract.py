"""``BENCHMARK.json`` against the rules a benchmark file is held to: its
keys, names, units, files, bounds and the time a full check takes."""

import json
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection)_size$"
                    r"|_dim$|_rank$|expansion|experts_per_tok")
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_a_full_check_fits_its_time():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configuration_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _line(config["why"])
    assert _line(config["source"])
    assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key)
        assert body["published"][key] != body[key]
    assert set(body["published"]) == set(config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=list(CELLS))
def test_cell_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert (ROOT / "benchmark/traffic" / f"{cell['traffic']}.json").is_file()
    assert (ROOT / "benchmark/limits" / f"{cell['name']}.json").is_file()
    e2e = [m for m in BENCH["end_to_end"] if _reports(cell["name"], m)]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert any(_reports(cell["name"], m) for m in BENCH["per_layer"])


def test_cells_are_unique_and_few_take_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(CELLS) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_end_to_end_metrics_and_bounds():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= set(CELLS)
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] == 0.25


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = BENCH["per_layer"]
    assert 1 <= len(per) <= 128
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and _reports(cell, e2e[m["moves"]])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    layers = {}
    for m in per:
        head = m["layer"].split(" (")[0]
        layers.setdefault(head, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader_and_valid_names():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(harness.load_reader(m["name"]))
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
