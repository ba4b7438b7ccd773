"""The port's coverage tool (``k8s_operator_libs_tpu_torch.cov``), the twin
of the JAX package's ``tools/cov.py``.

The reference's ``tests/test_cov.py`` runs on the twin as written (the
collector, the AST denominator, the report over the port's package).
The denominator must equal the reference's on every file of the port,
the tool must never write the reference's ``cov.json``, and the
committed ``cov_torch.json`` must say which tests it covers.
"""

import json
import sys
from pathlib import Path

import pytest

from torch_twin import reference_tests

REPO = Path(__file__).resolve().parent.parent
PORT = "k8s_operator_libs_tpu_torch"
sys.path.insert(0, str(REPO / "tools"))

import cov as ref_cov  # noqa: E402  (the JAX package's tools/cov.py)
from k8s_operator_libs_tpu_torch import cov  # noqa: E402

globals().update({k: v for k, v in reference_tests(
    "test_cov.py",
    renames=[('sys.path.insert(0, str(REPO / "tools"))\n\nimport cov',
              f"from {PORT} import cov")]).items()
    if k.startswith("test_")})


def _areas():
    groups = {}
    for path in sorted((REPO / PORT).rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REPO / PORT)
        key = rel.parts[0] if len(rel.parts) > 1 else "(top)"
        groups.setdefault(key, []).append(path)
    return groups


AREAS = _areas()


@pytest.mark.parametrize("area", sorted(AREAS))
def test_executable_lines_equal_the_reference(area):
    for path in AREAS[area]:
        assert cov.executable_lines(path) == ref_cov.executable_lines(path), \
            path


def test_measures_the_port_only():
    assert cov.MEASURED_DIRS == (PORT,)
    assert cov._measured(str(REPO / PORT / "server.py"))
    assert not cov._measured(str(REPO / "k8s_operator_libs_tpu"
                                 / "upgrade" / "util.py"))
    assert not cov._measured(str(REPO / "chip_smoke.py"))


class _NoCollector:
    """Stands in for the line collector: the test process may itself run
    under one, which holds ``sys.monitoring``'s coverage slot."""

    hits = {}

    def start(self):
        pass

    def stop(self):
        pass


@pytest.mark.parametrize("argv, rc, written", [
    ([], 0, "cov_torch.partial.json"),
    (["--update-artifact"], 0, "cov_torch.json"),
    (["--update-artifact"], 1, "cov_torch.partial.json"),
    (["tests/test_torch_cov.py"], 0, "cov_torch.partial.json"),
    (["tests/test_torch_cov.py", "--update-artifact"], None, None),
], ids=["default", "artifact", "failed-run", "filtered", "filtered-artifact"])
def test_writes_its_own_files_never_cov_json(argv, rc, written, tmp_path,
                                             monkeypatch):
    """A plain run writes the untracked partial file (named in
    ``.gitignore``); only a passing run of the default selection under
    ``--update-artifact`` writes ``cov_torch.json``; a filtered
    ``--update-artifact`` is refused (exit 2) before anything runs. The
    reference's ``cov.json`` is never written."""
    assert cov.PARTIAL in (REPO / ".gitignore").read_text().split()
    before = (REPO / "cov.json").read_bytes()
    import pytest as _pytest
    ran = []
    monkeypatch.setattr(_pytest, "main",
                        lambda args: ran.append(list(args)) or rc)
    monkeypatch.setattr(cov, "Collector", _NoCollector)
    monkeypatch.setattr(cov, "REPO", tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / PORT).mkdir()
    (tmp_path / PORT / "m.py").write_text("x = 1\n")
    got = cov.main(list(argv))
    assert got == (2 if rc is None else rc)
    written_files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert written_files == ([written] if written else [])
    if written:
        table = json.loads((tmp_path / written).read_text())
        assert table["files"][f"{PORT}/m.py"] == {
            "hit": 0, "executable": 1, "pct": 0.0, "missing": [1]}
        assert table["subset"] == (" ".join(argv[:1]) if argv[:1] and
                                   argv[0].endswith(".py") else
                                   "tests/test_torch_*.py -m 'not slow'")
    assert ran == ([] if rc is None else
                   [[a for a in argv if a != "--update-artifact"]
                    or cov.DEFAULT_ARGS])
    assert (REPO / "cov.json").read_bytes() == before


def test_default_selection_is_the_port_tests():
    tests = cov.default_tests()
    assert tests and all(Path(t).name.startswith("test_torch_")
                         for t in tests)
    assert "tests/test_torch_cov.py" in tests
    assert cov.DEFAULT_ARGS[cov.DEFAULT_ARGS.index("-m") + 1] == "not slow"


def test_committed_artifact_names_its_subset():
    table = json.loads((REPO / cov.ARTIFACT).read_text())
    assert table["subset"]
    assert table["lines_executable"] == sum(
        f["executable"] for f in table["files"].values())
    assert table["lines_hit"] == sum(f["hit"] for f in table["files"].values())
    assert table["total_pct"] == round(
        100.0 * table["lines_hit"] / table["lines_executable"], 2)
    assert all(rel.startswith(f"{PORT}/") for rel in table["files"])
