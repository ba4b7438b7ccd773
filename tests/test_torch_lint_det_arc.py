"""The port's rules that differ from the JAX package's by design: the
determinism scope (DET001/DET002), the import layering (ARC001) and the
binary-twin list both read, with the port faults they convicted.

The reference's DET reads its package and neither ``cmd/`` nor
``tools/``; the port keeps its entry points and tools inside its package,
so the twin reads the package minus ``lint/index.py:BINARY_TWINS``. The
port's ``LAYERS`` is the reference's with ``tpu`` -> ``gpu`` plus the
entries it states with reasons. Each rule is held to the reference's
fixtures (equal findings where the scope agrees), to its own fixtures
(one that fires and one that stays silent per form), and to copies of
the port's tree with an offence planted: a bare ``time.monotonic()`` in
``upgrade/`` and an import of ``gpu`` from ``health/monitor.py``.
"""

import ast
import re

import pytest

from torch_lint_pairs import (PAIRS, PORT, REPO, at_port, copy_port, norm,
                              planted, reference_domain_tests)
from test_torch_lint import snippets

from k8s_operator_libs_tpu_torch.lint.index import BINARY_TWINS, binary_twin
from k8s_operator_libs_tpu_torch.lint.registry import FileContext

DET, REF_DET = PAIRS["determinism"]
ARC, REF_ARC = PAIRS["layering"]


def det(mod, path, rel):
    source = path.read_text()
    ctx = FileContext(path=rel, tree=ast.parse(source),
                      lines=source.splitlines(), source=source)
    return sorted(mod._run(ctx))


def det_both(src, tmp_path, rel=f"{PORT}/core/case.py"):
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    got = det(DET, f, rel)
    with at_port(("determinism",)):
        want = det(REF_DET, f, rel)
    return got, want


def codes(findings):
    return sorted({f[1] for f in findings})


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """DET over every file of the port (twin, and reference pointed at
    the port) and ARC over the repo and over one copy of the tree."""
    files = {}
    for f in sorted((REPO / PORT).rglob("*.py")):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(REPO).as_posix()
        got = det(DET, f, rel)
        with at_port(("determinism",)):
            want = det(REF_DET, f, rel)
        files[rel] = (got, want)
    root = copy_port(tmp_path_factory.mktemp("port"))
    with at_port(("layering",)):
        ref_arc = REF_ARC.run_project(root, package=PORT)
    return files, ARC.run_project(REPO), ARC.run_project(root), ref_arc


# ------------------------------------------------------ the binary twins

@pytest.mark.parametrize("twin", sorted(BINARY_TWINS))
def test_binary_twin_names_a_port_module_and_its_reference(twin):
    ref = BINARY_TWINS[twin]
    assert ref.startswith(("cmd/", "tools/"))
    assert twin.endswith("/") == ref.endswith("/")
    assert (REPO / PORT / twin).exists(), twin
    assert (REPO / ref).exists(), ref
    if twin.endswith("/"):
        assert (REPO / PORT / twin / "__init__.py").is_file()
    else:
        assert (REPO / PORT / twin).is_file()


@pytest.mark.parametrize("path, want", [
    (f"{PORT}/server.py", "cmd/serve.py"),
    (f"/tmp/x/{PORT}/race/planted.py", "tools/race/"),
    (f"{PORT}/train/cli.py", "cmd/train.py"),
    (f"{PORT}/train/harness.py", None),
    (f"{PORT}/chaos/campaign.py", None),
    (f"{PORT}/racecar.py", None),
    ("cmd/serve.py", None),
])
def test_binary_twin_lookup(path, want):
    assert binary_twin(path, PORT) == want


# --------------------------------------------------------- DET001/DET002

DET_FIXTURES = (
    [(f"{kind}-{code}", getattr(REF_DET, kind)[code])
     for kind in ("OFFENDERS", "CLEAN") for code in sorted(REF_DET.CODES)]
    + snippets(REPO / "tests" / "test_lint_domain.py", "test_det",
               "run_lint_pkg"))


def test_det_fixtures_are_replayed():
    assert len(DET_FIXTURES) >= 5


@pytest.mark.parametrize("src", [s for _, s in DET_FIXTURES],
                         ids=[i for i, _ in DET_FIXTURES])
def test_det_reference_fixtures_replay_equal(src, tmp_path):
    got, want = det_both(src, tmp_path)
    assert got == want


@pytest.mark.parametrize("code", sorted(DET.CODES))
def test_det_own_fixtures_fire_and_stay_silent(code, tmp_path):
    got, _ = det_both(DET.OFFENDERS[code], tmp_path)
    assert code in codes(got)
    got, _ = det_both(DET.CLEAN[code], tmp_path)
    assert got == []


@pytest.mark.parametrize("twin", sorted(BINARY_TWINS))
def test_det_binary_twins_are_out_of_scope(twin, tmp_path):
    """By design: the reference's DET fires on the same source at the
    same path (it has no twin list), the port's stays silent."""
    rel = f"{PORT}/{twin}" + ("case.py" if twin.endswith("/") else "")
    got, want = det_both(DET.OFFENDERS["DET001"], tmp_path, rel)
    assert got == [] and "DET001" in codes(want)


@pytest.mark.parametrize("rel, fires", [
    (f"{PORT}/utils/clock.py", False),
    (f"{PORT}/upgrade/case.py", True),
    (f"{PORT}/train/harness.py", True),
    ("tests/test_torch_case.py", False),
    ("chip_smoke.py", False),
])
def test_det_scope(rel, fires, tmp_path):
    got, want = det_both(DET.OFFENDERS["DET001"], tmp_path, rel)
    assert got == want
    assert bool(got) == fires


def test_det_equals_the_reference_on_the_port(port_runs):
    """Nothing fires on the port; the reference pointed at it fires only
    in the binary twins, which it cannot tell from the library."""
    files = port_runs[0]
    for rel, (got, want) in files.items():
        assert got == [], rel
        if binary_twin(rel, PORT) is None:
            assert want == [], rel
    assert any(want for _, want in files.values())


def test_det_planted_clock_read_in_upgrade(tmp_path):
    root = copy_port(tmp_path)
    rel = "upgrade/upgrade_state.py"
    path = root / PORT / rel
    path.write_text(path.read_text() + "\n\ndef _probe():\n"
                    "    import time\n    return time.monotonic()\n")
    got = det(DET, path, f"{PORT}/{rel}")
    with at_port(("determinism",)):
        want = det(REF_DET, path, f"{PORT}/{rel}")
    assert got == want and codes(got) == ["DET001"]
    assert "time.monotonic" in got[0][2]


# ---------------------------------------------------------------- ARC001

_REFERENCE = reference_domain_tests(("test_arc001",), exclude={})
globals().update({f"test_reference_{k[5:]}": v
                  for k, v in _REFERENCE.items()})


def test_every_reference_arc_test_is_replayed():
    assert len(_REFERENCE) >= 5


def first_level_modules():
    out = set()
    for p in (REPO / PORT).iterdir():
        if p.suffix == ".py" and p.name != "__init__.py":
            out.add(p.stem)
        elif p.is_dir() and (p / "__init__.py").is_file():
            out.add(p.name)
    return out


def test_layers_name_every_first_level_module():
    assert first_level_modules() == set(ARC.LAYERS)


def test_layers_are_a_dag():
    color = {}

    def visit(layer, path):
        assert color.get(layer) != "grey", " -> ".join(path + [layer])
        if color.get(layer) == "black":
            return
        color[layer] = "grey"
        for nxt in sorted(ARC.LAYERS[layer]):
            assert nxt in ARC.LAYERS, (layer, nxt)
            visit(nxt, path + [layer])
        color[layer] = "black"

    for layer in sorted(ARC.LAYERS):
        visit(layer, [])


TOP = {"operator", "router", "server", "status", "apply_crds", "cov",
       "gen_state_diagram", "lint", "race"}


def test_layers_differ_from_the_reference_only_by_the_stated_entries():
    """The reference's table with tpu -> gpu, plus: convert (over
    utils) under models and parallel, and the binary twins on top."""
    rename = {"tpu": "gpu"}
    ref = {rename.get(k, k): {rename.get(v, v) for v in vs}
           for k, vs in REF_ARC.LAYERS.items()}
    added = {k: ARC.LAYERS[k] for k in set(ARC.LAYERS) - set(ref)}
    widened = {k: ARC.LAYERS[k] - ref[k] for k in ref
               if ARC.LAYERS[k] != ref[k]}
    assert all(ARC.LAYERS[k] >= ref[k] for k in ref)
    library = set(ref) | {"convert"}
    assert set(ARC.LIBRARY) == library
    assert added == {"convert": {"utils"},
                     **{t: library | ({"router"} if t == "race" else set())
                        for t in TOP}}
    assert widened == {"models": {"convert"}, "parallel": {"convert"}}
    source = (REPO / PORT / "lint" / "layering.py").read_text()
    for entry in ('"convert": {"utils"}', '"models": {', '"parallel": {',
                  "LAYERS.update(", 'LAYERS["race"]'):
        above = source[:source.index(entry)].splitlines()[:-1]
        comments = []
        while above and above[-1].strip().startswith("#"):
            comments.append(above.pop().strip())
        assert any(c.startswith("# port:") or c.startswith("#: port:")
                   for c in comments), entry


def test_arc_is_clean_on_the_port_and_agrees_with_the_reference(port_runs):
    """The twin finds nothing on the repo or a copy; the reference with
    the port's table differs only where a binary twin sits inside a
    library subpackage (health/sim.py, chaos/crash/), which it holds to
    that subpackage's row."""
    _, on_repo, on_copy, ref = port_runs
    assert on_repo == on_copy == []
    assert ref and all(binary_twin(rel, PORT) for rel, _, _, _ in ref)


def test_arc_planted_import_of_gpu_from_health(tmp_path):
    root = copy_port(tmp_path)
    rel = "health/monitor.py"
    src = (root / PORT / rel).read_text()
    anchor = re.search(r"^from \.\. ?[a-z_.]* ?import .*$", src,
                       flags=re.M).group(0)
    planted(root, rel, anchor, anchor + "\nfrom ..gpu import operator")
    got = ARC.run_project(root)
    with at_port(("layering",)):
        want = [f for f in REF_ARC.run_project(root, package=PORT)
                if not binary_twin(f[0], PORT)]
    assert norm(got) == norm(want)
    assert {(r, c) for r, _, c, _ in got} == {(f"{PORT}/{rel}", "ARC001")}
    assert any("health may not import gpu" in m for _, _, _, m in got)


# ----------------------------------------------- the moved collectives

def test_comm_and_mesh_sit_below_models_with_no_re_export():
    assert not (REPO / PORT / "parallel" / "comm.py").exists()
    assert not (REPO / PORT / "parallel" / "mesh.py").exists()
    for name in ("comm", "mesh", "paths"):
        tree = ast.parse((REPO / PORT / "utils" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level == 0 and not node.module.startswith(PORT)
    users = [REPO / "chip_smoke.py"] + sorted(
        (REPO / "tests").glob("*torch_*.py")) + sorted(
        p for p in (REPO / PORT).rglob("*.py") if "__pycache__" not in p.parts)
    stale = re.compile(rf"{PORT}\.parallel(\.comm|\.mesh| import .*\b"
                       r"(comm|mesh)\b)|from \.\.?parallel(\.comm|\.mesh)"
                       r"|^from \. import comm|^from \.mesh import", re.M)
    for f in users:
        assert not stale.search(f.read_text()), f


def test_build_directories_come_from_utils():
    from k8s_operator_libs_tpu_torch.data import loader
    from k8s_operator_libs_tpu_torch.ops import build
    from k8s_operator_libs_tpu_torch.utils import paths
    assert loader.BUILD_DIR is paths.BUILD_DIR is build.BUILD_DIR
    assert loader.CSRC_DIR is paths.CSRC_DIR is build.CSRC_DIR
    assert (paths.CSRC_DIR / "tokenloader.cpp").is_file()


# ---------------------------------------------------- the repaired sites

# (port file, the reference's file and line): a hatch the port's copy
# had dropped, restored verbatim
HATCHES = [
    ("core/liveclient.py", "k8s_operator_libs_tpu/core/liveclient.py", 79),
    ("core/liveclient.py", "k8s_operator_libs_tpu/core/liveclient.py", 521),
    ("core/liveclient.py", "k8s_operator_libs_tpu/core/liveclient.py", 604),
    ("train/uploader.py", "k8s_operator_libs_tpu/train/uploader.py", 184),
    ("server.py", "cmd/serve.py", 341),
    ("data/loader.py", "k8s_operator_libs_tpu/data/loader.py", 259),
]


@pytest.mark.parametrize("port, ref, line", HATCHES,
                         ids=[f"{p}:{n}" for p, _, n in HATCHES])
def test_reference_hatch_restored(port, ref, line):
    want = (REPO / ref).read_text().splitlines()[line - 1].strip()
    assert "allow —" in want
    lines = [x.strip() for x in (REPO / PORT / port).read_text().splitlines()]
    assert lines.count(want) == 1


class StepClock:
    """An injected clock whose monotonic reading advances one second per
    read."""

    def __init__(self):
        self.t = 100.0

    def now(self):
        self.t += 1.0
        return self.t

    def wall(self):
        return 1_700_000_000.0

    def sleep(self, seconds):
        self.t += seconds


def test_checkpoint_split_reads_the_ledgers_clock(tmp_path):
    """The drain save's fetch/write split feeds the downtime summary:
    it reads the ledger's injected clock (as the loop's windows do), not
    the process's."""
    from k8s_operator_libs_tpu_torch.obs.goodput import GoodputLedger
    from k8s_operator_libs_tpu_torch.train.harness import (
        STATE_FILE, CheckpointingTrainer)

    clock = StepClock()
    ledger = GoodputLedger(str(tmp_path / "goodput.jsonl"), clock=clock)
    trainer = CheckpointingTrainer(None, str(tmp_path / "ckpt"),
                                   device="cpu", ledger=ledger,
                                   step_fn=lambda s, b: (s, {}),
                                   init_fn=lambda seed: None)
    assert trainer._now == clock.now
    trainer._write(3, {"step": 3}, None, clock.now())
    trainer.close()
    assert (trainer.last_fetch_s, trainer.last_write_s) == (1.0, 1.0)
    assert (tmp_path / "ckpt" / "3" / STATE_FILE).exists()


def test_checkpoint_split_without_a_ledger_reads_the_process_clock(tmp_path):
    import time

    from k8s_operator_libs_tpu_torch.train.harness import CheckpointingTrainer
    trainer = CheckpointingTrainer(None, str(tmp_path / "ckpt"),
                                   device="cpu",
                                   step_fn=lambda s, b: (s, {}),
                                   init_fn=lambda seed: None)
    assert trainer._now is time.monotonic
    trainer.close()
