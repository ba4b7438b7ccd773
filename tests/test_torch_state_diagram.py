"""The port's state-diagram generator (``k8s_operator_libs_tpu_torch.
gen_state_diagram``), the twin of the JAX package's
``tools/gen_state_diagram.py``: the same pipeline of states in the same
order, rendered from the port's own ``UpgradeState``, with the GPU's terms
in its labels, and a committed SVG that is what the generator emits."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = "k8s_operator_libs_tpu_torch"
sys.path.insert(0, str(REPO / "tools"))

import gen_state_diagram as ref_diagram  # noqa: E402
from k8s_operator_libs_tpu_torch import gen_state_diagram  # noqa: E402
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState  # noqa: E402

SVG = REPO / "docs" / "images" / "gpu-driver-upgrade-state-diagram.svg"


def test_states_and_edges_equal_the_reference():
    states = [s for s, _ in gen_state_diagram.PIPELINE]
    assert states == [s for s, _ in ref_diagram.PIPELINE]
    edges = list(zip(states, states[1:]))
    ref_states = [s for s, _ in ref_diagram.PIPELINE]
    assert edges == list(zip(ref_states, ref_states[1:]))
    assert set(states[1:]) | {UpgradeState.FAILED} == set(
        UpgradeState.ALL) - {UpgradeState.UNKNOWN}


def test_labels_speak_of_the_nvlink_clique():
    svg = SVG.read_text()
    assert "NVIDIA GPU driver" in svg and "NVLink" in svg
    assert "clique" in svg
    assert "slice" not in svg and "TPU" not in svg and "libtpu" not in svg
    for state, _ in gen_state_diagram.PIPELINE[1:]:
        assert f">{state}</text>" in svg


def test_state_diagram_svg_is_current(tmp_path):
    """The committed SVG is what the generator emits from the port's
    live state list; generated to a temp path so the committed file is
    never touched, even on failure."""
    fresh = tmp_path / "diagram.svg"
    out = subprocess.run(
        [sys.executable, "-m", f"{PORT}.gen_state_diagram", str(fresh)],
        cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert SVG.read_text() == fresh.read_text(), (
        "docs/images/gpu-driver-upgrade-state-diagram.svg is stale; run "
        "python -m k8s_operator_libs_tpu_torch.gen_state_diagram and "
        "commit the result")
