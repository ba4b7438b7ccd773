"""The port's schedule explorer and lockset checker (``race/``) held to
the JAX package's own tests (``tests/test_race.py``), run on the port
through :mod:`torch_twin`: the ``utils/threads`` shim, the cooperative
scheduler's determinism, deadlock and livelock reports, the planted race
found, shrunk and replayed, the lockset checker, the seven harnesses
over the port's own components on seeds 0-2, the registry, and the
shutdown of the port's operator and router binaries.

Then both packages' command lines (``--self-test``, ``--smoke``) run on
the same seeds and must reach the same verdict for every harness, and
the race the lockset checker found in the port's replica pool is pinned
by its seed and shrunk trace.
"""

import importlib

from torch_twin import reference_tests

PORT_RACE = "k8s_operator_libs_tpu_torch.race"

globals().update(reference_tests(
    "test_race.py",
    renames=[
        ("from tools.race import explore as explore_mod",
         f"from {PORT_RACE} import explore as explore_mod"),
        ("from tools.race import harnesses, planted",
         f"from {PORT_RACE} import harnesses, planted"),
        ("from tools.race.explore import", f"from {PORT_RACE}.explore import"),
        ("from tools.race.lockset import", f"from {PORT_RACE}.lockset import"),
        ("from tools.race.scheduler import",
         f"from {PORT_RACE}.scheduler import"),
        ('lockset_files=["tools/race/planted.py"]',
         'lockset_files=["k8s_operator_libs_tpu_torch/race/planted.py"]'),
        # the binaries the shutdown tests start: the port's modules
        ('''    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"race_cli_{name}", str(REPO / "cmd" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod''',
         '''    import importlib
    return importlib.import_module(f"k8s_operator_libs_tpu_torch.{name}")'''),
    ]))

import pytest  # noqa: E402

from k8s_operator_libs_tpu_torch.race import harnesses  # noqa: E402
from k8s_operator_libs_tpu_torch.race.explore import replay, run_once  # noqa: E402

MAINS = {"reference": "tools.race.__main__", "port": f"{PORT_RACE}.__main__"}


def _verdicts(side, argv, capsys):
    """(exit code, [(PASS|FAIL, harness, seed or None)]) of one package's
    ``race`` command line run in-process on ``argv``."""
    rc = importlib.import_module(MAINS[side]).main(argv)
    out = capsys.readouterr().out
    rows = []
    for line in out.splitlines():
        if line.startswith(("PASS ", "FAIL ")):
            words = line.split()
            seed = next((w for w in words[2:] if w.startswith("seed=")),
                        None)
            rows.append((words[0], words[1].rstrip(":"), seed))
    return rc, rows


@pytest.mark.parametrize("argv", [["--self-test"],
                                  ["--smoke", "--budget", "900"]],
                         ids=["self-test", "smoke"])
def test_cli_verdicts_equal_the_reference(argv, capsys):
    """``python -m k8s_operator_libs_tpu_torch.race`` and ``python -m
    tools.race`` on the same seeds: the same exit code and, for every
    harness (the planted ones of ``--self-test``, the seven real ones of
    ``--smoke``), the same verdict at the same failing seed. The smoke's
    wall-clock budget is raised for both so that a loaded test machine
    cannot turn a verdict into a timeout."""
    want = _verdicts("reference", argv, capsys)
    got = _verdicts("port", argv, capsys)
    assert got == want
    assert got[0] == 0
    if argv == ["--self-test"]:
        assert [r[:2] for r in got[1]] == [
            ("FAIL", "planted:racy_counter"), ("PASS", "planted:safe_counter"),
            ("FAIL", "planted:shared_flag")]
    else:
        assert sorted(r[1] for r in got[1]) == sorted(harnesses.HARNESSES)
        assert all(r[0] == "PASS" for r in got[1])


def test_replica_pool_registry_read_under_its_lock():
    """The lockset checker's finding on the port, pinned by its seed and
    shrunk trace: seed 0 of ``router_tick_proxy`` with the empty trace
    convicted ``ReplicaPool.replicas`` (written under the registry lock by
    ``register``, read by the router's ticker with no lock held). The
    registry is now read under its lock too."""
    res = run_once(harnesses.router_tick_proxy, 0, trace=[],
                   lockset_files=harnesses.LOCKSET_FILES["router_tick_proxy"])
    assert res.races == [], [str(r) for r in res.races]
    assert not res.failed, res.describe()
    # the same schedule replays to the same trace
    again = replay(harnesses.router_tick_proxy, 0, [],
                   lockset_files=harnesses.LOCKSET_FILES["router_tick_proxy"])
    assert again.report.trace == res.report.trace
