"""The port's lint suite against the JAX package's ``tools/lint``: the
domain passes (LCK001–LCK004, THR001/GRD001) and the torch SYN001.

The lock and thread passes are copies: in this process only, the
reference's passes are pointed at the port (``monkeypatch`` on their
``PACKAGE`` constants; no file of ``tools/`` changes) and must report
what the twin reports, on the reference's own fixtures, on the port's
real tree and on copies of it with one planted offence each. SYN001 is
rewritten for torch's idiom, so it is held to its own fixtures (one that
fires and one that stays silent per sync form) and to mutated copies of
the port's ``serve.py`` and ``harness.py`` with a sync smuggled into each
hot function. The last section holds each repaired site of the port
clean.
"""

import ast
import shutil
import sys
import types
from pathlib import Path

import pytest

from test_torch_lint import AREAS, PORT, snippets

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from lint import lock_discipline as ref_lck  # noqa: E402
from lint import lock_order as ref_order  # noqa: E402
from lint import thread_discipline as ref_thr  # noqa: E402
from lint.index import ProjectIndex as RefIndex  # noqa: E402

from k8s_operator_libs_tpu_torch import lint as port_lint  # noqa: E402
from k8s_operator_libs_tpu_torch.lint import (lock_discipline,  # noqa: E402
                                              lock_order, sync_check,
                                              thread_discipline)
from k8s_operator_libs_tpu_torch.lint.registry import FileContext  # noqa: E402

PAIRS = [(lock_discipline, ref_lck), (thread_discipline, ref_thr)]
REFERENCE_TESTS = REPO / "tests" / "test_lint_domain.py"


@pytest.fixture
def ref_on_port(monkeypatch):
    """The reference's THR/GRD scope and its index's package: the port."""
    monkeypatch.setattr(ref_thr, "PACKAGE", PORT)
    monkeypatch.setattr(RefIndex, "PACKAGE", PORT)


def file_pass(mod, path, rel=None):
    """One file-scope pass's raw findings on ``path`` (shown as ``rel``),
    from a fresh parse."""
    source = Path(path).read_text()
    ctx = FileContext(path=rel or str(path),
                      tree=ast.parse(source, filename=str(path)),
                      lines=source.splitlines(), source=source)
    return sorted(mod._run(ctx))


def domain_findings(path, rel=None):
    """{pass name: (twin's findings, reference's findings)}."""
    return {port.__name__.rsplit(".", 1)[1]:
            (file_pass(port, path, rel), file_pass(ref, path, rel))
            for port, ref in PAIRS}


def codes(findings):
    return sorted({f[-2] for f in findings})


# ------------------------------------------- the reference's own fixtures

LCK_FIXTURES = [(f"{code}-{kind}", code, kind, getattr(ref_lck, kind)[code])
                for kind in ("OFFENDERS", "CLEAN")
                for code in sorted(ref_lck.CODES)]


@pytest.mark.parametrize("code, kind, src",
                         [f[1:] for f in LCK_FIXTURES],
                         ids=[f[0] for f in LCK_FIXTURES])
def test_lock_fixtures_replay_equal(code, kind, src, tmp_path):
    f = tmp_path / "case.py"
    f.write_text(src)
    got = file_pass(lock_discipline, f)
    assert got == file_pass(ref_lck, f)
    assert code in codes(got) if kind == "OFFENDERS" else got == []


THR_FIXTURES = [(f"{code}-{kind}", code, kind, getattr(ref_thr, kind)[code])
                for kind in ("OFFENDERS", "CLEAN")
                for code in sorted(ref_thr.CODES)]


def _pkg_file(tmp_path, src, name="case.py"):
    d = tmp_path / PORT / "core"
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(src)
    return f


@pytest.mark.parametrize("code, kind, src",
                         [f[1:] for f in THR_FIXTURES],
                         ids=[f[0] for f in THR_FIXTURES])
def test_thread_fixtures_replay_equal(code, kind, src, tmp_path,
                                      ref_on_port):
    f = _pkg_file(tmp_path, src)
    got = file_pass(thread_discipline, f)
    assert got == file_pass(ref_thr, f)
    assert code in codes(got) if kind == "OFFENDERS" else got == []


def test_thread_scope_is_the_port_package(tmp_path):
    """Outside the package (a ``cmd/`` tree, a scratch file) the pass is
    silent; inside it the shim module alone may build raw primitives."""
    src = ref_thr.OFFENDERS["THR001"]
    for rel in ("cmd/somecli.py", "case.py"):
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(src)
        assert file_pass(thread_discipline, f) == []
    shim = tmp_path / PORT / "utils" / "threads.py"
    shim.parent.mkdir(parents=True)
    shim.write_text(src)
    assert file_pass(thread_discipline, shim) == []
    assert "THR001" in codes(file_pass(thread_discipline,
                                       _pkg_file(tmp_path, src)))


DOMAIN_SNIPPETS = (
    [(i, s, False) for i, s in snippets(REFERENCE_TESTS, "test_lck")]
    + [(i, s, True) for i, s in snippets(REFERENCE_TESTS, "test_thr",
                                         "run_lint_pkg")]
    + [(i, s, True) for i, s in snippets(REFERENCE_TESTS, "test_grd",
                                         "run_lint_pkg")])


def test_every_reference_domain_snippet_is_replayed():
    assert len(DOMAIN_SNIPPETS) >= 6


@pytest.mark.parametrize("src, in_pkg", [s[1:] for s in DOMAIN_SNIPPETS],
                         ids=[s[0] for s in DOMAIN_SNIPPETS])
def test_reference_domain_snippets_replay_equal(src, in_pkg, tmp_path,
                                                ref_on_port):
    f = _pkg_file(tmp_path, src) if in_pkg else tmp_path / "case.py"
    f.write_text(src)
    for name, (got, want) in domain_findings(f).items():
        assert got == want, name


def _literal_dicts(path, prefix):
    """The module-level ``PREFIX... = {...}`` literals of a test file."""
    out = {}
    for node in ast.parse(Path(path).read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith(prefix):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


LCK4 = _literal_dicts(REFERENCE_TESTS, "LCK4_")
LCK4_FIRES = {"LCK4_ABBA", "LCK4_TRANSITIVE_SLEEP", "LCK4_CROSS_MODULE_RPC"}


def _root(tmp_path, files):
    root = tmp_path / "root"
    for rel, src in files.items():
        dst = root / rel.replace("k8s_operator_libs_tpu/", f"{PORT}/")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src)
    return root


def test_every_lock_order_fixture_is_replayed():
    assert set(LCK4) == LCK4_FIRES | {"LCK4_CONSISTENT",
                                      "LCK4_SLEEP_OUTSIDE"}


@pytest.mark.parametrize("name", sorted(LCK4))
def test_lock_order_fixtures_replay_equal(name, tmp_path, ref_on_port):
    root = _root(tmp_path, LCK4[name])
    got = lock_order.run_project(root)
    assert got == ref_order.run_project(root)
    assert bool(got) == (name in LCK4_FIRES)
    assert all(f[2] == "LCK004" for f in got)


# ------------------------------------------------------ the port's tree

@pytest.mark.parametrize("area", sorted(AREAS))
def test_domain_file_passes_equal_the_reference_on_the_port(area,
                                                            ref_on_port):
    for f in AREAS[area]:
        rel = f.relative_to(REPO).as_posix()
        for name, (got, want) in domain_findings(f, rel).items():
            assert got == want, (rel, name)


def test_lock_order_equals_the_reference_on_the_port(ref_on_port):
    """The pass's raw findings (before the suite's per-line
    suppression): the one blocking call the port keeps under a lock, the
    kernel build's nvcc, hatched at its call site."""
    got = lock_order.run_project(REPO)
    assert got == ref_order.run_project(REPO)
    assert [(rel, code) for rel, _, code, _ in got] == [
        (f"{PORT}/ops/build.py", "LCK004")]
    rel, line, _, _ = got[0]
    assert "# lint: ignore" in (REPO / rel).read_text().splitlines()[
        line - 1]


def _sub(old, new):
    def mutate(src):
        assert src.count(old) == 1, old
        return src.replace(old, new)
    return mutate


# (file, mutation, the code it plants)
PLANTED = {
    "hatch-removed": (
        "obs/reqtrace.py",
        _sub("  # thr: allow — every caller holds self._lock (the _locked "
             "suffix contract)", ""),
        "GRD001"),
    "raw-lock": (
        "obs/trace.py",
        _sub('self._lock = threads.make_lock("trace-list-sink")',
             "self._lock = threading.Lock()"),
        "THR001"),
    "unlocked-read": (
        "server.py",
        _sub("    def _loop(self):",
             "    def peek_draining(self):\n"
             "        return self.draining\n\n"
             "    def _loop(self):"),
        "GRD001"),
    "sleep-under-lock": (
        "ops/build.py",
        _sub("    with _lock:\n        lib = _loaded.get(name)",
             "    with _lock:\n        time.sleep(0.01)\n"
             "        lib = _loaded.get(name)"),
        "LCK002"),
    "sleep-reached-under-lock": (
        "server.py",
        _sub('        """One batcher step, then the SSE buffers and '
             'completions."""',
             '        """One batcher step, then the SSE buffers and '
             'completions."""\n        time.sleep(0.01)'),
        "LCK004"),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_offence_found_alike(case, tmp_path, ref_on_port):
    """A copy of a port file with one planted offence: the twin and the
    reference's pass agree, and the planted code is among the findings.
    The lock-order case copies the whole package, since LCK004 follows
    calls across modules."""
    rel, mutate, code = PLANTED[case]
    root = tmp_path / "root"
    target = root / PORT / rel
    if code == "LCK004":
        shutil.copytree(REPO / PORT, root / PORT,
                        ignore=shutil.ignore_patterns("__pycache__"))
    else:
        target.parent.mkdir(parents=True)
    target.write_text(mutate((REPO / PORT / rel).read_text()))
    found = []
    for name, (got, want) in domain_findings(
            target, f"{PORT}/{rel}").items():
        assert got == want, name
        found += got
    if code == "LCK004":
        got = lock_order.run_project(root)
        assert got == ref_order.run_project(root)
        found += got
    assert code in codes(found)


# --------------------------------------------------------------- SYN001

@pytest.mark.parametrize("form", sorted(sync_check.OFFENDERS))
def test_syn001_offender_fires(form):
    found = sync_check.check_source(sync_check.OFFENDERS[form],
                                    sync_check.FIXTURE_QUALS)
    assert len(found) == 1, found
    _, _, code, msg = found[0]
    assert code == "SYN001"
    assert form.split("(")[0].rstrip(".") in msg


@pytest.mark.parametrize("form", sorted(sync_check.CLEAN))
def test_syn001_clean_twin_stays_silent(form):
    assert sync_check.check_source(sync_check.CLEAN[form],
                                   sync_check.FIXTURE_QUALS) == []


def test_syn001_fixture_pairs_shipped():
    assert set(sync_check.OFFENDERS) == set(sync_check.CLEAN)
    assert {".item()", ".tolist()", ".cpu()", ".numpy()", "float()",
            "int()", "bool()"} <= set(sync_check.OFFENDERS)


SERVE = f"{PORT}/models/serve.py"
HARNESS = f"{PORT}/train/harness.py"


def _syn_root(tmp_path, mutate=None):
    root = tmp_path / "syn"
    for rel in sync_check.HOT_FUNCTIONS:
        src = (REPO / rel).read_text()
        if mutate and rel in mutate:
            src = mutate[rel](src)
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src)
    return root


def test_syn001_real_files_pass(tmp_path):
    assert sync_check.run_project(_syn_root(tmp_path)) == []
    assert sync_check.run_project(REPO) == []


def test_syn001_one_hatch_per_readback_path():
    """The deliberate readbacks are the two hatched lines of serve.py,
    one in each helper; the trainer loop has none."""
    lines = {rel: [i + 1 for i, line in enumerate(
        (REPO / rel).read_text().splitlines())
        if sync_check.HATCH in line] for rel in sync_check.HOT_FUNCTIONS}
    assert lines[HARNESS] == []
    tree = ast.parse((REPO / SERVE).read_text())
    owners = [sync_check._function_node(tree, q).name
              for line in lines[SERVE]
              for q in sync_check.HOT_FUNCTIONS[SERVE]
              if sync_check._function_node(tree, q).lineno <= line
              <= sync_check._function_node(tree, q).end_lineno]
    assert owners == ["_decode", "_spec_round"]


# (hot function, the line a sync goes after, a device value there)
SMUGGLE_SITES = {
    "run": (HARNESS,
            "            state, metrics = self._step_fn(state, batch)\n",
            '            metrics["loss"]'),
    "_decode": (SERVE,
                "            toks = torch.argmax(logits[:, -1], "
                "dim=-1).to(torch.int32)\n",
                "            toks"),
    "_spec_round": (SERVE,
                    "        greedy = torch.argmax(v_logits, "
                    "dim=-1).to(torch.int32)\n",
                    "        greedy"),
    "_step_inner": (SERVE,
                    "        toks = self._decode(n)\n",
                    "        torch.as_tensor(self._lengths, "
                    "device=self.device).max()"),
    "_step_spec_round": (SERVE,
                         "        slab, acc = self._spec_round()\n",
                         "        torch.as_tensor(self._lengths, "
                         "device=self.device).max()"),
}
SMUGGLED = [(fn, form) for fn in sorted(SMUGGLE_SITES)
            for form in (".item()", ".cpu()")]


@pytest.mark.parametrize("fn, form", SMUGGLED,
                         ids=[f"{fn}-{form}" for fn, form in SMUGGLED])
def test_syn001_smuggled_sync_fires(fn, form, tmp_path):
    rel, anchor, value = SMUGGLE_SITES[fn]
    indent = value[:len(value) - len(value.lstrip())]
    line = f"{indent}probe = {value.lstrip()}{form}\n"
    root = _syn_root(tmp_path, mutate={rel: _sub(anchor, anchor + line)})
    found = sync_check.run_project(root)
    assert len(found) == 1, found
    _, _, code, msg = found[0]
    assert code == "SYN001" and form in msg and f"{fn}()" in msg


def test_syn001_host_cast_in_train_loop_fires(tmp_path):
    """The reference's regression: converting the step metrics on the
    host inside the loop instead of at the sync boundary."""
    root = _syn_root(tmp_path, mutate={HARNESS: _sub(
        SMUGGLE_SITES["run"][1],
        SMUGGLE_SITES["run"][1]
        + '            probe = float(metrics["loss"])\n')})
    msgs = [m for _, _, _, m in sync_check.run_project(root)]
    assert len(msgs) == 1
    assert "float()" in msgs[0] and "'metrics'" in msgs[0]


@pytest.mark.parametrize("fn, hatch", [
    ("_decode", "  # syn: readback — the step's ONE sync; [n, slots]"),
    ("_spec_round", "  # syn: readback — the round's ONE sync; [slots, k+2]"),
])
def test_syn001_unhatched_readback_fires(fn, hatch, tmp_path):
    root = _syn_root(tmp_path, mutate={SERVE: _sub(hatch, "")})
    found = sync_check.run_project(root)
    assert len(found) == 1 and f"{fn}()" in found[0][3]
    assert ".cpu()" in found[0][3]


def test_syn001_synchronize_outside_the_boundary_fires(tmp_path):
    """The checkpoint writer waiting on its event directly, as the port
    did before its wait went through ``_sync``."""
    root = _syn_root(tmp_path, mutate={HARNESS: _sub(
        "            self._sync(ready)", "            ready.synchronize()")})
    found = sync_check.run_project(root)
    assert len(found) == 1 and "ready.synchronize" in found[0][3]


def test_syn001_renamed_hot_path_fails_config_drift(tmp_path):
    root = _syn_root(tmp_path, mutate={
        SERVE: _sub("def _step_inner", "def _tick_inner")})
    found = sync_check.run_project(root)
    assert any("not found" in m and "_step_inner" in m
               for _, _, _, m in found)


# ------------------------------------------------- the repaired sites

# (file, the codes that fired there before the repair)
REPAIRED = {
    "obs-trace-sinks": (f"{PORT}/obs/trace.py", {"THR001"}),
    "server-drain-barrier": (f"{PORT}/server.py", {"GRD001"}),
    "reqtrace-gauges": (f"{PORT}/obs/reqtrace.py", {"GRD001"}),
    "race-planted": (f"{PORT}/race/planted.py", {"GRD001", "LCK003"}),
    "race-scheduler": (f"{PORT}/race/scheduler.py", {"LCK001"}),
    "threads-shim": (f"{PORT}/utils/threads.py", {"LCK001"}),
    "gpu-scheduler": (f"{PORT}/gpu/scheduler.py", {"F401"}),
    "chip-smoke": ("chip_smoke.py", {"F541"}),
    "kernel-build": (f"{PORT}/ops/build.py", {"LCK004"}),
    "trainer-sync": (HARNESS, {"SYN001"}),
    "batcher-readbacks": (SERVE, {"SYN001"}),
}


@pytest.fixture(scope="module")
def project_findings():
    return port_lint.lint_project(REPO)


@pytest.mark.parametrize("site", sorted(REPAIRED))
def test_repaired_site_is_clean(site, project_findings):
    rel, _ = REPAIRED[site]
    found = port_lint.lint_file(REPO / rel) + [
        f for f in project_findings if f.startswith(f"{rel}:")]
    assert found == []


def test_checkpoint_writer_waits_through_the_sync_boundary(tmp_path):
    """The writer thread's wait for its snapshot's copies goes through
    ``_sync(event)``, the trainer's one audited wait, and waits on that
    event, not on the whole device."""
    from k8s_operator_libs_tpu_torch.train.harness import (
        STATE_FILE, CheckpointingTrainer)

    trainer = CheckpointingTrainer(None, str(tmp_path / "ckpt"),
                                   device="cpu",
                                   step_fn=lambda s, b: (s, {}),
                                   init_fn=lambda seed: None)
    seen = []
    sync = trainer._sync
    trainer._sync = lambda *a: (seen.append(a), sync(*a))
    event = types.SimpleNamespace(synchronize=lambda: seen.append("event"))
    trainer._write(3, {"step": 3}, event, 0.0)
    trainer.close()
    assert seen == [(event,), "event"]
    assert (tmp_path / "ckpt" / "3" / STATE_FILE).exists()
