"""The port's health simulation (``health/sim.py``) held to the JAX
package's ``tools/health_sim.py``: the same fault (the driver pod of one
node of a four-node group crash-loops) on each package's fake cluster,
and the same detect -> quarantine -> group-atomic repair -> recover
timeline. The reference's group is a v5e slice of four hosts under
``TPUOperator``, the port's a GB200 NVLink clique of four nodes under
``GPUOperator``; the name map below is the only difference allowed.
"""

import contextlib
import importlib
import io
import logging
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODULES = {"reference": "tools.health_sim",
           "port": "k8s_operator_libs_tpu_torch.health.sim"}


def _name_map(text):
    """The reference's words mapped onto the port's: its device-plugin
    pods onto the driver's, its component onto ``gpu`` and a slice's
    group onto its clique's."""
    text = re.sub(r"\bplugin-", "driver-", text)
    text = text.replace("tpu-device-plugin", "gpu")
    text = re.sub(r"slice/(pool-\w+)", r"clique/u.\1", text)
    return text.replace("slice quarantined, repaired slice-atomically",
                        "clique quarantined, repaired clique-atomically")


def _timeline(text):
    """[(t, node, verdict, quarantine, upgrade state, cordon)] of a
    printed timeline."""
    rows, t = [], None
    for line in text.splitlines():
        m = re.match(r"t=\s*([\d.]+)s$", line)
        if m:
            t = float(m.group(1))
            continue
        m = re.match(r"\s+(\S+)\s+verdict=(\S+)\s+(\S+)\s+upgrade=(\S+)\s+"
                     r"(\S+)$", line)
        if m:
            rows.append((t,) + m.groups())
    return rows


@pytest.fixture(scope="module")
def runs():
    """Each package's simulation run in this process: (exit code, what it
    printed, the WARNING-and-above messages it logged)."""
    out = {}
    for side, name in MODULES.items():
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        root = logging.getLogger()
        root.addHandler(handler)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = importlib.import_module(name).main()
        finally:
            root.removeHandler(handler)
        out[side] = (rc, buf.getvalue(), [r.getMessage() for r in records])
    return out


def test_both_simulations_converge(runs):
    for side, (rc, text, _) in runs.items():
        assert rc == 0, (side, text)
        assert "== converged at t=" in text, side


def test_timeline_equals_the_reference(runs):
    """The verdict, quarantine and upgrade-state timeline of every node at
    every modelled second, the repaired pods and the converged line."""
    want, got = runs["reference"][1], runs["port"][1]
    assert _timeline(got) == _timeline(want)
    assert len(_timeline(got)) > 6
    assert {row[3] for row in _timeline(got)} >= {"Q", "-"}
    assert got == _name_map(want)


def test_remediation_log_equals_the_reference(runs):
    """What the remediator reported (quarantine, repair injection, driver
    pod restart), message for message."""
    want = [_name_map(m) for m in runs["reference"][2]]
    got = runs["port"][2]
    assert got == want
    assert any(m.startswith("quarantined clique/u.pool-a") for m in got)


def test_module_runs_from_the_command_line():
    """``python -m k8s_operator_libs_tpu_torch.health.sim`` exits 0 with
    the converged line last."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", MODULES["port"]], capture_output=True,
        text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(
        "== converged at t=233.2s: clique quarantined")
