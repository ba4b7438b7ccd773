"""The port's lint passes beside the JAX package's ``tools/lint`` ones.

Each pass of the port's second half is a copy of a reference pass whose
path constants name the port. This module pairs them and points either
side at the other's layout, in the test process only (no file of
``tools/`` changes):

- :func:`at_port` points the reference's passes at the port: their path
  constants, ``ROOTS`` and ``PACKAGE`` take the twin's values, and the
  reference's ``ProjectIndex.PACKAGE`` becomes the port's package;
- :func:`at_reference` points the twins at the reference's layout, for
  the reference's own fixtures, which are built from the reference's
  files at the reference's paths.

:func:`reference_domain_tests` executes ``tests/test_lint_domain.py``
into a namespace whose pass modules are :class:`Replay` proxies: every
``run_project`` (and ``get_engine``) there runs the reference's pass and
the twin pointed at the reference, asserts that they agree, and hands
the reference's result to the reference's own assertions.
"""

import contextlib
import importlib
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = "k8s_operator_libs_tpu_torch"
sys.path.insert(0, str(REPO / "tools"))

from lint import index as ref_index  # noqa: E402  (the JAX package's tools/lint)

from k8s_operator_libs_tpu_torch.lint import index as port_index  # noqa: E402

NAMES = ("determinism", "layering", "state_machine", "wire_check",
         "chaos_check", "crash_check", "obs_check", "dataflow",
         "exc_contracts", "exc_swallow", "exc_kill", "stale_taint")

#: module -> (twin, reference)
PAIRS = {name: (importlib.import_module(f"{PORT}.lint.{name}"),
                importlib.import_module(f"lint.{name}")) for name in NAMES}

#: constants a copy carries with the port's paths: the only module-level
#: constants where a copied pass may differ from the reference's
PATH_CONSTANTS = {
    "state_machine": {"CONSTS_PATH", "STATE_PATH", "METRICS_PATH",
                      "DIAGRAM_PATH", "HEALTH_CONSTS_PATH",
                      "HEALTH_REMEDIATION_PATH", "HEALTH_METRICS_PATH"},
    "wire_check": {"REGISTRY_PATH", "SCAN_ROOTS", "REFERENCE_ROOTS"},
    "chaos_check": {"FAULTS_PATH", "SCENARIO_PATH", "INVARIANTS_PATH"},
    "crash_check": {"REGISTRY_PATH", "WIRE_PATH", "SCAN_ROOT",
                    "EXCLUDED_PREFIXES"},
    "obs_check": {"CONSTS_PATH", "JOURNEY_PATH", "CHOKE_PATH", "SCAN_ROOTS",
                  "ATTRIBUTION_PATH", "SLO_PATH", "ALERTS_PATH",
                  "METRICS_PATH", "ROUTER_METRICS_PATH", "PROFILE_PATH",
                  "MARKET_METRICS_PATH", "RESILIENCE_PATH", "REQTRACE_PATH",
                  "SLO_CAUSES_PATH", "TIMELINE_PATH", "CAUSES_PATH",
                  "USAGE_PATH"},
    "dataflow": set(),
    "exc_contracts": {"ROOTS"},
    "exc_kill": {"REGISTRY_PATH", "WIRE_PATH", "EXCLUDED_PREFIXES"},
    "stale_taint": {"ROOTS"},
    # the rules that differ by design read the same constants
    "determinism": {"PACKAGE"},
    "exc_swallow": {"PACKAGE"},
    "layering": {"PACKAGE", "LAYERS"},
}


@contextlib.contextmanager
def _pointed(side, names=NAMES):
    """``side`` 0: the reference takes the twin's constants; 1: the
    twin takes the reference's."""
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            twin, ref = PAIRS[name]
            src, dst = (twin, ref) if side == 0 else (ref, twin)
            for const in PATH_CONSTANTS[name]:
                mp.setattr(dst, const, getattr(src, const))
        src, dst = ((port_index, ref_index) if side == 0
                    else (ref_index, port_index))
        mp.setattr(dst.ProjectIndex, "PACKAGE", src.ProjectIndex.PACKAGE)
        yield


def at_port(names=NAMES):
    return _pointed(0, names)


def at_reference(names=NAMES):
    return _pointed(1, names)


def norm(findings):
    """Findings with the twin's name for its own module spelled as the
    reference's (the config-drift messages name the file to edit)."""
    return sorted((rel, line, code, msg.replace(f"{PORT}/lint/",
                                                "tools/lint/"))
                  for rel, line, code, msg in findings)


def tools_twin(rel):
    """Is ``rel`` one of the port's twins of a ``tools/`` file?"""
    return (port_index.binary_twin(rel, PORT) or "").startswith("tools/")


def copy_port(dst):
    """A copy of the port's tree under ``dst``: the package, its test
    files, ``chip_smoke.py`` and the doc STM001 reads."""
    shutil.copytree(REPO / PORT, dst / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (dst / "tests").mkdir()
    for pattern in ("test_torch_*.py", "torch_*.py"):
        for f in (REPO / "tests").glob(pattern):
            shutil.copy(f, dst / "tests" / f.name)
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / "docs").mkdir()
    shutil.copy(REPO / "docs" / "fleet-health.md",
                dst / "docs" / "fleet-health.md")
    return dst


def planted(dst, rel, old, new, count=1):
    """Replace ``old`` by ``new`` in the copy's ``rel`` (``old`` must
    occur ``count`` times)."""
    path = dst / PORT / rel
    src = path.read_text()
    assert src.count(old) == count, (rel, old)
    path.write_text(src.replace(old, new))


# ------------------------------------------------ the reference's tests

class Replay:
    """A reference pass module whose ``run*`` functions and
    ``get_engine`` also run the twin, pointed at the reference's layout,
    and assert the same result; every other attribute is the reference
    module's."""

    def __init__(self, name):
        self._name = name
        self._twin, self._ref = PAIRS[name]

    def __getattr__(self, attr):
        value = getattr(self._ref, attr)
        if attr.startswith("run_") and callable(value):
            return lambda *a, **kw: self._both(attr, *a, **kw)
        return value

    def _both(self, fn, root, *args, **kwargs):
        want = getattr(self._ref, fn)(root, *args, **kwargs)
        if isinstance(root, ref_index.ProjectIndex):
            root = root.root
        if self._name == "layering":      # a default bound at definition
            kwargs.setdefault("package", self._ref.PACKAGE)
        with at_reference():
            got = getattr(self._twin, fn)(Path(root), *args, **kwargs)
        assert norm(got) == norm(want), (self._name, fn)
        return want

    def get_engine(self, index):
        engine = self._ref.get_engine(index)
        with at_reference():
            twin = self._twin.get_engine(port_index.ProjectIndex(index.root))
            assert summaries(twin) == summaries(engine)
        return engine


def summaries(engine):
    """An engine's call graph and per-function summaries, comparable
    across the two packages' classes."""
    out = {}
    for key, s in engine.summaries.items():
        out[key] = (sorted(s.raises.items()), sorted(s.unclassified.items()),
                    s.reads, s.barriers, s.returns_store,
                    sorted(s.param_to_return), sorted(s.param_to_write),
                    [(f.source, f.write_rel, f.write_line, f.write_method,
                      f.via) for f in s.flows])
    edges = {key: sorted(v) for key, v in engine.edges.items()}
    return out, edges


def reference_domain_tests(prefixes, exclude):
    """The tests of ``tests/test_lint_domain.py`` whose names start with
    one of ``prefixes``, minus ``exclude`` ({name: why}), run through
    :class:`Replay` proxies of the passes they call."""
    path = REPO / "tests" / "test_lint_domain.py"
    namespace = {"__name__": "reference_test_lint_domain",
                 "__file__": str(path)}
    exec(compile(path.read_text(), str(path), "exec"), namespace)
    for name in ("state_machine", "wire_check", "chaos_check",
                 "crash_check", "obs_check", "dataflow", "exc_contracts",
                 "exc_kill", "stale_taint", "layering"):
        namespace[name] = Replay(name)
    tests = {k: v for k, v in namespace.items()
             if k.startswith(tuple(prefixes)) and callable(v)}
    for name in exclude:
        if name not in tests:
            raise AssertionError(f"no reference test {name}")
        del tests[name]
    return tests
