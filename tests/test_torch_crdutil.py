"""The port's CRD bootstrap (``crdutil/``, ``apply_crds.py``) held to the
JAX package's own tests, run on the port through :mod:`torch_twin`:
``tests/test_crdutil.py`` whole (its dry-run CLI test runs
``python -m k8s_operator_libs_tpu_torch.apply_crds``'s ``main``), and
the two CRD tests of ``tests/test_liveclient.py`` over the port's
``FakeAPIServer`` and ``LiveCRDClient``.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from torch_twin import (argparse_actions, load_reference_binary,
                        reference_tests)

globals().update(reference_tests(
    "test_crdutil.py",
    renames=[('''    spec = importlib.util.spec_from_file_location("apply_crds_cli", cli_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)''',
              '''    mod = importlib.import_module(
        "k8s_operator_libs_tpu_torch.apply_crds")''')]))

_LIVE = reference_tests("test_liveclient.py", binaries=["apply_crds"])
live = _LIVE["live"]
test_ensure_crds_over_http = _LIVE["test_ensure_crds_over_http"]
test_apply_crds_cli_live_mode = _LIVE["test_apply_crds_cli_live_mode"]

from k8s_operator_libs_tpu_torch.core.fakecluster import (  # noqa: E402
    FakeCluster as PortCluster)
from k8s_operator_libs_tpu_torch.utils.clock import (  # noqa: E402
    FakeClock as PortClock)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def clock():
    return PortClock()


@pytest.fixture
def cluster(clock):
    return PortCluster(clock=clock, cache_lag=0.5)


def test_python_dash_m_runs_apply_crds():
    out = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.apply_crds",
         "--crds-dir", str(REPO / "crds"), "--dry-run"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "applied 2 CRDs" in out.stdout
    assert "jax" not in out.stderr


def test_apply_crds_flags_equal_the_reference():
    import importlib
    port = importlib.import_module("k8s_operator_libs_tpu_torch.apply_crds")
    want = argparse_actions(load_reference_binary("apply_crds").main)
    assert argparse_actions(port.main) == want
    assert ("--crds-dir",) in [a[0] for a in want]
