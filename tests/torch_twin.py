"""The JAX package's own unit tests, bound to the port.

``reference_tests(path, ...)`` reads a reference test file, points its
imports of ``k8s_operator_libs_tpu`` at ``k8s_operator_libs_tpu_torch``
(plus the renames a test file names, such as the TPU operator's GPU
twin) and executes it into a fresh namespace. A ``tests/test_torch_*.py``
file adds that namespace to its globals, so pytest collects every
reference test body there and runs it on the port, with the fixtures
(``cluster``, ``clock``, ``keys``) the port's test file defines.

Imports of modules the port does not have yet stay pointed at the
reference (``keep``); the tests that use them are left out (``exclude``,
each with the reason) and never collected.

:class:`ServingSLO` is one package's real SLO engine over the serving
TTFT objective, for the tests that hold the autoscaler and the market
arbiter against the reference's. Nothing here imports JAX.
"""

import importlib
import re
from pathlib import Path

REFERENCE = "k8s_operator_libs_tpu"
PORT = "k8s_operator_libs_tpu_torch"
TESTS = Path(__file__).resolve().parent


# a reference test's load of a binary from the repo's cmd/ by file path
# (``spec_from_file_location(name, os.path.join(<tests>, "..", "cmd",
# "<binary>.py"))``, then ``module_from_spec`` and ``exec_module``)
_CMD_LOAD = re.compile(
    r"spec = importlib\.util\.spec_from_file_location\(\s*[^,]+,\s*"
    r"os\.path\.join\(os\.path\.dirname\(__file__\),\s*\"\.\.\",\s*"
    r"\"cmd\",\s*(f?)\"([^\"]+)\.py\"\)\)\s*\n"
    r"(\s*)(\w+) = importlib\.util\.module_from_spec\(spec\)\s*\n"
    r"\s*spec\.loader\.exec_module\(\4\)")


def port_binaries(src, binaries):
    """``src`` with each load of ``cmd/<b>.py`` for ``b`` in ``binaries``
    (or of ``cmd/{name}.py`` through a helper) replaced by an import of
    the port's ``<b>`` module, which ``python -m`` runs."""
    def swap(m):
        fmt, stem, indent, var = m.groups()
        if not fmt and stem not in binaries:
            return m.group(0)
        return (f"{var} = importlib.import_module("
                f"{fmt}\"{PORT}.{stem}\")")
    return _CMD_LOAD.sub(swap, src)


def reference_tests(name, renames=(), keep=(), exclude=None, binaries=()):
    """The namespace of ``tests/<name>`` executed against the port.

    ``renames``: (old, new) text replacements applied after the package
    swap; ``keep``: dotted module paths under the package whose imports
    stay the reference's; ``exclude``: {test name: why it is not
    twinned}; ``binaries``: the ``cmd/`` binaries whose loads become
    imports of the port's (:func:`port_binaries`). Raises if a renamed or
    excluded name is not found, so a changed reference file cannot
    silently drop a twin."""
    src = (TESTS / name).read_text()
    src = re.sub(rf"\b{REFERENCE}\b", PORT, src)
    if binaries:
        src = port_binaries(src, binaries)
    for module in keep:
        src = src.replace(f"{PORT}.{module}", f"{REFERENCE}.{module}")
    for old, new in renames:
        if old not in src:
            raise AssertionError(f"{name}: {old!r} not found")
        src = src.replace(old, new)
    namespace = {"__name__": f"reference_{name[:-3]}",
                 "__file__": str(TESTS / name)}
    exec(compile(src, str(TESTS / name), "exec"), namespace)
    for test in exclude or {}:
        if test not in namespace:
            raise AssertionError(f"{name}: no test {test}")
        del namespace[test]
    return {k: v for k, v in namespace.items()
            if not k.startswith("__") and k not in ("pytest",)}


class ServingSLO:
    """One package's ``SLOEngine`` over the default objectives and its
    own ``TimeSeriesStore``, fed a serving hub's TTFT histogram under the
    workload prefix (as the operator's tsdb scrapes a serving hub).
    ``burn()`` records slow first tokens (every one past the 2.5 s
    objective) and evaluates; ``cool()`` records fast ones two hours
    later and evaluates. ``last`` is the engine's last evaluation, the
    attribute the autoscaler and the arbiter read."""

    def __init__(self, root):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.clock = mod("utils.clock").FakeClock(50_000.0)
        self.hub = mod("obs.metrics").MetricsHub()
        self.tsdb = mod("obs.tsdb").TimeSeriesStore(clock=self.clock)
        slo = mod("obs.slo")
        self.engine = slo.SLOEngine(
            self.tsdb, slo.SLOOptions.from_dict({}).specs, clock=self.clock)

    @property
    def last(self):
        return self.engine.last

    def _feed(self, ttft, n):
        for _ in range(n):
            self.hub.observe("serve_ttft_seconds", ttft)
        self.tsdb.scrape(hub=self.hub, prefix="tpu_workload")
        self.engine.evaluate()

    def burn(self):
        self._feed(0.2, 1)
        self.clock.advance(60.0)
        self._feed(9.0, 40)
        return self

    def cool(self):
        self.clock.advance(7200.0)
        self._feed(0.2, 1)
        self.clock.advance(60.0)
        self._feed(0.2, 400)
        return self


def argparse_actions(main):
    """The argparse actions a binary's ``main(argv)`` builds, as
    (option strings, dest, default, type name, action class, required,
    metavar, choices, nargs, const); ``main`` stops at ``parse_args``."""
    import argparse
    seen = {}

    def parse(self, args=None, namespace=None):
        seen["actions"] = [
            (tuple(a.option_strings), a.dest, a.default,
             getattr(a.type, "__name__", a.type), type(a).__name__,
             a.required, a.metavar, a.choices, a.nargs, a.const)
            for a in self._actions]
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        main([])
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["actions"]


def load_reference_binary(name):
    """The JAX package's ``cmd/<name>.py``, loaded by file path (``cmd/``
    is a directory of entry points, not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"reference_cmd_{name}", TESTS.parent / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
