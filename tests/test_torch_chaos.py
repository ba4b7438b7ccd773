"""The port's chaos harness (``chaos/``) held to the JAX package's own
tests (``tests/test_chaos.py``), run on the port through
:mod:`torch_twin`: the fault catalog, the scenario parsers, the seeded
injector, the invariants and whole campaigns on the port's GPU fleet
(NVLink cliques ``u.pool-<i>`` and single H100 nodes under
``GPUOperator``). The port's driver component is ``gpu`` where the
reference's is ``libtpu``.
"""

from torch_twin import reference_tests

REFERENCE_TESTS = reference_tests(
    "test_chaos.py",
    renames=[('KeyFactory("libtpu")', 'KeyFactory("gpu")'),
             ("(threshold 300s, component libtpu)",
              "(threshold 300s, component gpu)"),
             ('ReplicaPool(component="libtpu"',
              'ReplicaPool(component="gpu"')])
globals().update(REFERENCE_TESTS)

import importlib  # noqa: E402
import re  # noqa: E402

import pytest  # noqa: E402

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}

# the pinned scenarios of the reference's tests with their seeds, the
# crash explorer's sweep scenario, and three seeded random ones
PINNED = {name: (REFERENCE_TESTS[spec], seed) for name, spec, seed in (
    ("correlated", "CORRELATED", 11), ("router", "ROUTER_CHAOS", 13),
    ("migration", "MIGRATION_CHAOS", 17), ("market", "MARKET_CHAOS", 29),
    ("usage", "USAGE_CHAOS", 29))}


def _name_map(text):
    """The reference's words in a campaign's outcome mapped onto the
    port's: its driver component, and a slice's group onto its
    clique's."""
    text = text.replace("component libtpu", "component gpu")
    return re.sub(r"slice/(pool-\d+)", r"clique/u.\1", text)


def _outcome(side, spec, seed):
    chaos = importlib.import_module(f"{ROOTS[side]}.chaos")
    if spec is None:
        scenario = chaos.random_scenario(seed)
    elif spec == "sweep":
        scenario = importlib.import_module(
            f"{ROOTS[side]}.chaos.crash.explorer"
            if side == "port" else "tools.crash.explorer").sweep_scenario()
    else:
        scenario = chaos.parse_scenario(spec)
    res = chaos.run_scenario(scenario, seed)
    return {"converged": res.converged, "ticks": res.ticks,
            "modelled_s": res.modelled_s, "failovers": res.failovers,
            "crashes": res.crashes, "router_stats": res.router_stats,
            "violations": [_name_map(str(v)) for v in res.violations],
            "trace": [_name_map(t) for t in res.trace],
            "attribution": res.attribution,
            "usage_records": res.usage_records}


@pytest.mark.parametrize("name", [*PINNED, "sweep", "random-0", "random-1",
                                  "random-2"])
def test_campaign_outcome_equals_the_reference(name):
    """Each package's ``run_scenario`` on the same scenario and seed:
    the same convergence, ticks, failovers, crashes, router and market
    stats, cause-attribution score, usage records and fault trace, under
    the name map, and no violation."""
    if name in PINNED:
        spec, seed = PINNED[name]
    elif name == "sweep":
        spec, seed = "sweep", 0
    else:
        spec, seed = None, int(name.split("-")[1])
    want = _outcome("reference", spec, seed)
    got = _outcome("port", spec, seed)
    assert got == want
    assert got["converged"] and not got["violations"]


def test_crash_registry_names_the_port_wire_keys():
    """Every wire-key name a crash site claims is a constant of the
    port's ``wire.py``, no key is claimed twice, and the registry equals
    the reference's."""
    registry = importlib.import_module(
        "k8s_operator_libs_tpu_torch.chaos.crash.registry")
    wire = importlib.import_module("k8s_operator_libs_tpu_torch.wire")
    claimed = [k for keys in registry.SITE_WIRE_KEYS.values() for k in keys]
    assert all(isinstance(getattr(wire, k), str) for k in claimed)
    assert len(claimed) == len(set(claimed))
    ref = importlib.import_module("tools.crash.registry")
    assert registry.SITE_WIRE_KEYS == ref.SITE_WIRE_KEYS
    assert registry.SITE_PROCESS == ref.SITE_PROCESS


def _cli(args):
    import os
    import subprocess
    import sys
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=600, env=env,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    return out.returncode, out.stdout


def test_campaign_cli_equals_the_reference():
    """``python -m k8s_operator_libs_tpu_torch.chaos`` prints, for a
    replayed seed, the JSON that ``tools/chaos_campaign.py`` prints, with
    the same exit code, and takes the same flags."""
    argv = ["--seeds", "1", "--base-seed", "3", "--json"]
    port = _cli(["-m", "k8s_operator_libs_tpu_torch.chaos", *argv])
    ref = _cli(["tools/chaos_campaign.py", *argv])
    assert port == ref and port[0] == 0
    from torch_twin import argparse_actions
    port_main = importlib.import_module(
        "k8s_operator_libs_tpu_torch.chaos.__main__").main
    ref_main = importlib.import_module("tools.chaos_campaign").main
    assert argparse_actions(port_main) == argparse_actions(ref_main)


def test_crash_cli_replays_one_point_and_takes_the_reference_flags():
    rc, out = _cli(["-m", "k8s_operator_libs_tpu_torch.chaos.crash",
                    "--site", "cordon-flip", "--phase", "after"])
    assert rc == 0, out
    assert "PASS crash point" in out and "1/1 crash points converged" in out
    from torch_twin import argparse_actions
    port_main = importlib.import_module(
        "k8s_operator_libs_tpu_torch.chaos.crash.__main__").main
    ref_main = importlib.import_module("tools.crash.__main__").main
    assert argparse_actions(port_main) == argparse_actions(ref_main)


def test_status_cli_takes_the_reference_flags():
    from torch_twin import argparse_actions, load_reference_binary
    port = importlib.import_module("k8s_operator_libs_tpu_torch.status")
    assert argparse_actions(port.main) == argparse_actions(
        load_reference_binary("status").main)
