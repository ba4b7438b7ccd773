"""The port's interprocedural engine and exception passes against the JAX
package's: the dataflow engine, EXC001, EXC002, EXC003 and STL001, with
``--explain`` and the token loader's forwarded producer failure.

The engine, EXC001, EXC003 and STL001 are copies (``torch_lint_pairs``
points either side at the other, in the test process only): the
reference's own tests of them run as written with every pass call
checked against the twin; on the port's tree the two build the same
summaries and find nothing; on copies with one planted offence each
they report the same findings. EXC002 reads the binary-twin list, so it
is held to the reference's fixtures at package paths and to its scope.
"""

import ast
import subprocess
import sys

import numpy as np
import pytest

from torch_lint_pairs import (PAIRS, PORT, REPO, at_port, copy_port, norm,
                              planted, port_index, ref_index,
                              reference_domain_tests, summaries, tools_twin)
from test_torch_lint import snippets

from k8s_operator_libs_tpu_torch import lint as port_lint
from k8s_operator_libs_tpu_torch.lint.registry import FileContext

ENGINE_PASSES = ("exc_contracts", "exc_kill", "stale_taint")


def engine_runs(twin_index, ref_root):
    """{pass: (twin's findings, reference's pointed at the port)} and
    both engines' summaries, each side off one index."""
    out = {name: norm(PAIRS[name][0].run_project(twin_index))
           for name in ENGINE_PASSES}
    twin_engine = PAIRS["dataflow"][0].get_engine(twin_index)
    with at_port():
        ref = ref_index.ProjectIndex(ref_root)
        for name in ENGINE_PASSES:
            out[name] = (out[name], norm(PAIRS[name][1].run_project(ref)))
        ref_engine = PAIRS["dataflow"][1].get_engine(ref)
    return out, summaries(twin_engine), summaries(ref_engine)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The engine passes on one copy of the port's tree, both sides (the
    twin on the repo itself is the gate's, ``test_port_is_clean``)."""
    root = copy_port(tmp_path_factory.mktemp("port"))
    return engine_runs(port_index.ProjectIndex(root), root)


# ------------------------------------------------ the reference's tests

_REFERENCE = reference_domain_tests(
    ("test_exc001", "test_exc003", "test_stl001", "test_engine_"),
    exclude={
        "test_exc001_real_repo_passes":
            "the reference's whole tree; the port's is held below",
        "test_exc003_real_repo_passes":
            "the reference's whole tree; the port's is held below",
        "test_stl001_real_repo_passes":
            "the reference's whole tree; the port's is held below",
    })
globals().update({f"test_reference_{k[5:]}": v
                  for k, v in _REFERENCE.items()})


def test_every_reference_flow_test_is_replayed():
    assert len(_REFERENCE) >= 14


# ------------------------------------------------------ the port's tree

@pytest.mark.parametrize("name", ENGINE_PASSES)
def test_engine_pass_equals_the_reference_on_the_port(name, port_runs):
    runs, _, _ = port_runs
    got, want = runs[name]
    assert got == want == []


def test_engine_summaries_equal_the_reference_on_the_port(port_runs):
    """The same call graph and, per function, the same may-raise,
    unclassified and taint summaries."""
    _, twin_summ, ref_summ = port_runs
    assert twin_summ == ref_summ
    assert len(twin_summ[0]) > 1000


def test_roots_name_the_port_spine():
    for name in ("exc_contracts", "stale_taint"):
        twin, ref = PAIRS[name]
        assert len(twin.ROOTS) == len(ref.ROOTS)
        for (rel, qual), (ref_rel, ref_qual) in zip(twin.ROOTS, ref.ROOTS):
            assert rel == ref_rel.replace("k8s_operator_libs_tpu/tpu/",
                                          f"{PORT}/gpu/").replace(
                "k8s_operator_libs_tpu/", f"{PORT}/")
            assert qual == ref_qual.replace("TPUOperator", "GPUOperator")
            tree = ast.parse((REPO / rel).read_text())
            cls, fn = qual.split(".")
            assert any(isinstance(n, ast.ClassDef) and n.name == cls
                       and any(getattr(m, "name", None) == fn
                               for m in n.body) for n in tree.body), qual


# --------------------------------------------- planted offences (copies)

MONITOR = "health/monitor.py"

# case -> (file, old, new, the pass that must convict it)
PLANTS = {
    "reconcile-callee-raises-unclassified": (
        MONITOR,
        "current = node.metadata.labels.get(consts.VERDICT_LABEL)",
        'raise ServerError("injected: verdict sync is down")',
        "exc_contracts"),
    "handler-swallows-operator-killed": (
        MONITOR, "except (ApiError, TimeoutError):", "except BaseException:",
        "exc_kill"),
    "store-read-before-the-freshness-barrier": (
        MONITOR, 'pump(kinds=("Node", "Pod"))', "pass", "stale_taint"),
}
CODES = {"exc_contracts": "EXC001", "exc_kill": "EXC003",
         "stale_taint": "STL001"}


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_planted_offence_found_alike(case, tmp_path):
    rel, old, new, convicts = PLANTS[case]
    root = copy_port(tmp_path)
    planted(root, rel, old, new)
    runs, twin_summ, ref_summ = engine_runs(port_index.ProjectIndex(root),
                                            root)
    assert twin_summ == ref_summ
    for name, (got, want) in runs.items():
        assert got == want, name
    got = runs[convicts][0]
    assert got and {c for _, _, c, _ in got} == {CODES[convicts]}
    assert all(r == f"{PORT}/{MONITOR}" for r, _, _, _ in got)


# --------------------------------------------------------------- EXC002

def file_pass(mod, path, rel):
    source = path.read_text()
    ctx = FileContext(path=rel, tree=ast.parse(source),
                      lines=source.splitlines(), source=source)
    return sorted(mod._run(ctx))


def exc002_both(src, tmp_path, rel=f"{PORT}/core/case.py"):
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    twin, ref = PAIRS["exc_swallow"]
    got = file_pass(twin, f, rel)
    with at_port(("exc_swallow",)):
        want = file_pass(ref, f, rel)
    return got, want


EXC002_FIXTURES = (
    [(f"{kind}", getattr(PAIRS["exc_swallow"][1], kind)["EXC002"])
     for kind in ("OFFENDERS", "CLEAN")]
    + snippets(REPO / "tests" / "test_lint_domain.py", "test_exc002",
               "run_lint_pkg"))


def test_exc002_fixtures_are_the_reference_s():
    twin, ref = PAIRS["exc_swallow"]
    assert twin.OFFENDERS == ref.OFFENDERS and twin.CLEAN == ref.CLEAN
    assert len(EXC002_FIXTURES) >= 3


@pytest.mark.parametrize("src", [s for _, s in EXC002_FIXTURES],
                         ids=[i for i, _ in EXC002_FIXTURES])
def test_exc002_fixtures_replay_equal(src, tmp_path):
    got, want = exc002_both(src, tmp_path)
    assert got == want


@pytest.mark.parametrize("rel, fires", [
    (f"{PORT}/server.py", True),               # cmd/serve.py's twin
    (f"{PORT}/train/cli.py", True),            # cmd/train.py's twin
    (f"{PORT}/core/case.py", True),
    (f"{PORT}/race/case.py", False),           # tools/race/
    (f"{PORT}/lint/case.py", False),           # tools/lint/
    (f"{PORT}/chaos/crash/case.py", False),    # tools/crash/
    (f"{PORT}/health/sim.py", False),          # tools/health_sim.py
    ("tests/test_torch_case.py", False),
])
def test_exc002_scope_follows_the_binary_twins(rel, fires, tmp_path):
    """The reference reads its package and cmd/, not tools/: the twin
    reads the port's package minus the twins of tools/."""
    src = PAIRS["exc_swallow"][1].OFFENDERS["EXC002"]
    got, _ = exc002_both(src, tmp_path, rel)
    assert bool(got) == fires


PORT_FILES = sorted(p for p in (REPO / PORT).rglob("*.py")
                    if "__pycache__" not in p.parts)


def test_exc002_equals_the_reference_on_the_port():
    twin, ref = PAIRS["exc_swallow"]
    scoped = 0
    for f in PORT_FILES:
        rel = f.relative_to(REPO).as_posix()
        got = file_pass(twin, f, rel)
        with at_port(("exc_swallow",)):
            want = file_pass(ref, f, rel)
        assert got == [], rel
        if not tools_twin(rel):
            scoped += 1
            assert want == [], rel
    assert scoped > 100


# ------------------------------------------- the loader's producer fault

class Halt(BaseException):
    """Not an Exception: what ``except Exception`` lets through."""


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_loader_forwards_a_base_exception_to_the_reader(pkg, tmp_path):
    """A producer that raises a ``BaseException`` hands it to the reader
    as the cause of a RuntimeError, in both packages; the port's thread
    used to die with it and the reader got no cause."""
    from k8s_operator_libs_tpu.data import loader as jloader
    from k8s_operator_libs_tpu_torch.data import loader as tloader
    mod = jloader if pkg == "reference" else tloader
    path = tmp_path / "tokens.bin"
    tloader.write_token_file(str(path), np.arange(4096) % 97)
    ds = mod.TokenDataset(str(path), native=False)
    halt = Halt("producer halted")

    def sample_at(*args, **kwargs):
        raise halt

    ds.sample_at = sample_at
    stream = ds.batches(2, 8)
    with pytest.raises(RuntimeError) as info:
        next(stream)
    assert info.value.__cause__ is halt
    stream.close()
    ds.close()


# --------------------------------------------------------------- explain

def test_every_registered_code_has_explain_entry():
    missing = [c for c in port_lint.all_codes() if not port_lint.explain(c)]
    assert missing == [], missing


def test_explain_cli_prints_docs_section():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.lint", "--explain", "EXC001"],
        cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "exception-contract closure" in proc.stdout
    assert "exc_contracts.py" in proc.stdout and "GPUOperator" in proc.stdout


def test_explain_cli_unknown_code_exits_2():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.lint", "--explain", "NOPE999"],
        cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 2


@pytest.mark.parametrize("code", ["JAX001", "JAX004"])
def test_explain_has_no_entry_for_the_jax_codes(code):
    """The catalog says why the jit-hygiene codes have no twin, and
    gives them no section of their own."""
    assert port_lint.explain(code) is None
    assert "JAX001–JAX004" in port_lint.DOCS_PATH.read_text()
