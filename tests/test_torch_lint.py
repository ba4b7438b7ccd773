"""The port's lint suite (``k8s_operator_libs_tpu_torch.lint``) against the
JAX package's ``tools/lint``: the generic pass.

The twin carries the same 16 generic codes with the same messages, so
the reference's pass and the twin must report the same findings on the
same inputs: every snippet of ``tests/test_lint.py``, every fixture the
reference's check modules ship, and the port's own tree. The reference's
``tests/test_lint.py`` also runs on the twin as written. The CLI gate
(``test_port_is_clean``) is the twin of ``test_repo_is_clean``: the
suite over its default targets, with the baseline and without it, finds
nothing.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from torch_twin import reference_tests

REPO = Path(__file__).resolve().parent.parent
PORT = "k8s_operator_libs_tpu_torch"
sys.path.insert(0, str(REPO / "tools"))

import lint as ref_lint  # noqa: E402  (the JAX package's tools/lint)
from k8s_operator_libs_tpu_torch import lint as port_lint  # noqa: E402

_REFERENCE = reference_tests(
    "test_lint.py",
    renames=[('sys.path.insert(0, str(REPO / "tools"))\n\nimport lint',
              f"from {PORT} import lint")],
    exclude={
        "test_repo_is_clean": "twinned by test_port_is_clean below",
        "test_state_diagram_svg_is_current":
            "twinned in tests/test_torch_state_diagram.py",
    })
globals().update({k: v for k, v in _REFERENCE.items()
                  if k.startswith("test_")})


# ----------------------------------------------------------------- helpers

def snippets(path, prefix="test_", call="run_lint"):
    """Every source string a test file hands to ``call(tmp_path, src)``
    in a test whose name starts with ``prefix``: a literal argument, or a
    name bound to a literal earlier in the same test. Returns
    [(test name + index, source)]."""
    tree = ast.parse(Path(path).read_text())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith(prefix)):
            continue
        bound = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                try:
                    bound[node.targets[0].id] = ast.literal_eval(node.value)
                except ValueError:
                    pass
        calls = sorted((n for n in ast.walk(fn)
                        if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id == call and len(n.args) >= 2),
                       key=lambda n: (n.lineno, n.col_offset))
        for i, node in enumerate(calls):
            arg = node.args[1]
            if isinstance(arg, ast.Name):
                src = bound.get(arg.id)
            else:
                try:
                    src = ast.literal_eval(arg)
                except ValueError:
                    src = None
            if isinstance(src, str):
                out.append((f"{fn.name}-{i}", src))
    return out


def reference_fixtures():
    """[(module.code.kind, source)] for every OFFENDERS / CLEAN fixture
    the reference's check modules ship."""
    import importlib
    import pkgutil
    out = []
    for info in pkgutil.iter_modules(ref_lint.__path__):
        mod = importlib.import_module(f"lint.{info.name}")
        for kind in ("OFFENDERS", "CLEAN"):
            for code, src in sorted(getattr(mod, kind, {}).items()):
                out.append((f"{info.name}.{code}.{kind.lower()}", src))
    return out


def port_files():
    """The twin's default targets, as files."""
    return port_lint._collect(port_lint.DEFAULT_TARGETS, base=REPO)


def areas():
    """The port's files grouped by top-level entry: each subpackage, the
    package's top-level modules, ``chip_smoke.py`` and the tests."""
    groups = {}
    for f in port_files():
        rel = f.relative_to(REPO)
        if rel.parts[0] != PORT:
            key = rel.parts[0]
        elif len(rel.parts) > 2:
            key = f"{PORT}/{rel.parts[1]}"
        else:
            key = PORT
        groups.setdefault(key, []).append(f)
    return groups


AREAS = areas()


def generic(pkg, path):
    return pkg.lint_file(path, domain=False)


# ------------------------------------------------------------------ parity

SNIPPETS = snippets(REPO / "tests" / "test_lint.py")


def test_every_reference_snippet_is_replayed():
    """The extraction finds the reference file's snippets (it holds more
    than 40 ``run_lint`` calls)."""
    assert len(SNIPPETS) > 40


@pytest.mark.parametrize("src", [s for _, s in SNIPPETS],
                         ids=[i for i, _ in SNIPPETS])
def test_generic_pass_equals_the_reference_on_its_snippets(src, tmp_path):
    f = tmp_path / "case.py"
    f.write_text(src)
    assert generic(port_lint, f) == generic(ref_lint, f)


FIXTURES = reference_fixtures()


@pytest.mark.parametrize("src", [s for _, s in FIXTURES],
                         ids=[i for i, _ in FIXTURES])
def test_generic_pass_equals_the_reference_on_its_fixtures(src, tmp_path):
    f = tmp_path / "case.py"
    f.write_text(src)
    assert generic(port_lint, f) == generic(ref_lint, f)


@pytest.mark.parametrize("area", sorted(AREAS))
def test_generic_pass_equals_the_reference_on_the_port(area):
    for f in AREAS[area]:
        assert generic(port_lint, f) == generic(ref_lint, f), f


# ------------------------------------------------------------- the gate

GATE_FLAGS = {"baseline": [], "no-baseline": ["--no-baseline"]}


@pytest.fixture(scope="module")
def gate_runs():
    """``python -m k8s_operator_libs_tpu_torch.lint`` with the baseline and
    without it, the two started together: {name: (exit code, stdout,
    stderr)}."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.lint", *flags], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flags in GATE_FLAGS.items()}
    runs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        runs[name] = (proc.returncode, out, err)
    return runs


@pytest.mark.parametrize("name", sorted(GATE_FLAGS))
def test_port_is_clean(name, gate_runs):
    """The gate itself: the twin over its default targets (the port's
    package, chip_smoke.py, tests/test_torch_*.py) finds nothing."""
    rc, out, err = gate_runs[name]
    assert rc == 0, out + err
    assert out == ""
    assert " 0 findings" in err


def test_full_run_parses_each_file_once(gate_runs):
    """One ProjectIndex per run: every file pass and every project pass
    read each file from one parse. The index also lists, unparsed, the
    test files WIRE001 may search for a registry key's last reference."""
    _, _, err = gate_runs["no-baseline"]
    n = len(port_files())
    m = re.search(r"lint\[all\]: (\d+) files, (\d+) parses, 0 findings",
                  err)
    assert m, err
    assert int(m.group(2)) == n <= int(m.group(1))


def test_baseline_holds_no_entry():
    assert port_lint.load_baseline(port_lint.BASELINE_PATH) == set()


def test_default_targets_cover_the_port():
    files = {f.relative_to(REPO).as_posix() for f in port_files()}
    assert "chip_smoke.py" in files
    assert f"{PORT}/server.py" in files
    assert f"{PORT}/lint/sync_check.py" in files
    assert "tests/test_torch_lint.py" in files
    assert not any(f.startswith(("k8s_operator_libs_tpu/", "tools/",
                                 "cmd/")) for f in files)


def test_registry_holds_this_slices_passes():
    """Every pass of the reference's suite but the jit-hygiene one, in
    the reference's order; every code with the reference's description
    but WIRE001's (it names the port's registry) and SYN001's (rewritten
    for torch)."""
    names = [c.name for c in port_lint.REGISTRY]
    assert names == [c.name for c in ref_lint.REGISTRY
                     if c.name != "jax-hygiene"]
    assert names == ["generic", "lock-discipline", "lock-order",
                     "determinism", "state-machine", "obs-journey",
                     "obs-attribution", "obs-slo", "obs-timeline",
                     "obs-usage", "chaos-closure", "crash-closure",
                     "exc-contracts", "exc-swallow", "exc-kill",
                     "stale-taint", "wire-closure", "sync-hygiene",
                     "thread-discipline", "import-layering"]
    codes = port_lint.all_codes()
    ref_codes = ref_lint.all_codes()
    assert set(codes) == set(ref_codes) - {"JAX001", "JAX002", "JAX003",
                                           "JAX004"}
    for code in set(codes) - {"WIRE001", "SYN001"}:
        assert codes[code] == ref_codes[code], code
    assert codes["WIRE001"] == ref_codes["WIRE001"].replace(
        "k8s_operator_libs_tpu/", f"{PORT}/")


def test_modes_formats_and_baseline_writing(tmp_path, capsys):
    f = tmp_path / "case.py"
    f.write_text('import json\nx = f"static"\n')
    assert port_lint.main([str(f), "--domain"]) == 0
    assert port_lint.main([str(f), "--generic", "--format", "json"]) == 1
    found = json.loads(capsys.readouterr().out)
    assert [(d["line"], d["code"]) for d in found] == [(1, "F401"),
                                                      (2, "F541")]
    assert port_lint.main([str(f), "--format=github"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("::error file=") and "title=F401::" in out[0]
    bl = tmp_path / "baseline.txt"
    assert port_lint.main([str(f), f"--baseline={bl}",
                           "--write-baseline"]) == 0
    entries = port_lint.load_baseline(bl)
    assert entries == {f"{f.as_posix()}:F401", f"{f.as_posix()}:F541"}
    assert port_lint.main([str(f), f"--baseline={bl}"]) == 0
    assert port_lint.main([str(f), f"--baseline={bl}",
                           "--no-baseline"]) == 1
    assert port_lint.main(["--format", "xml"]) == 2


# --------------------------------------------------------------- imports

NEW_MODULES = sorted(
    [p for p in (REPO / PORT / "lint").glob("*.py")]
    + [REPO / PORT / "cov.py", REPO / PORT / "gen_state_diagram.py"])


@pytest.mark.parametrize("path", NEW_MODULES, ids=lambda p: p.name)
def test_new_modules_import_the_stdlib_and_the_port_only(path):
    """The lint, coverage and diagram twins read source and never run
    it: the standard library and the port's own modules, nothing of
    JAX, the JAX package or ``tools`` (the coverage tool also runs
    pytest, in process)."""
    allowed = {"__future__"} | ({"pytest"} if path.name == "cov.py"
                                else set())
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top in sys.stdlib_module_names or top in allowed, \
                (path.name, name)
