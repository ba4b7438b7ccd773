"""Stdlib-only line coverage of the port via sys.monitoring (PEP 669,
Python >= 3.12); the twin of the JAX package's ``tools/cov.py``.

It stands in for coverage.py, which the project does not depend on: a
collector registered on :data:`sys.monitoring.COVERAGE_ID`
records the first execution of every (code object, line) in the measured
package and then returns ``sys.monitoring.DISABLE`` for that location, so
steady-state overhead is near zero (each line pays one callback ever;
uninteresting files disable themselves on first sight).

Denominator: executable statement lines from the AST (module docstrings
and bare-string docstring expressions are excluded — CPython emits no code
for them; ``global``/``nonlocal`` likewise).

Usage:
    python -m k8s_operator_libs_tpu_torch.cov [pytest args...]
        # default: tests/test_torch_*.py -q -m 'not slow'
prints per-file coverage for the worst-covered files plus the port's
total, writes the full per-file table to the untracked
``cov_torch.partial.json`` (pass ``--update-artifact`` on a run of the
whole default selection to refresh the committed ``cov_torch.json``), and
exits with pytest's exit code (so CI still fails on test failures, not
coverage). It never writes the JAX package's ``cov.json``.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Set

REPO = Path(__file__).resolve().parent.parent
MEASURED_DIRS = ("k8s_operator_libs_tpu_torch",)
ARTIFACT = "cov_torch.json"
PARTIAL = "cov_torch.partial.json"
# the selection the committed artifact covers: the port's own test files
# on the CPU, without the slow-marked cases
DEFAULT_ARGS = ["-q", "-m", "not slow", "-p", "no:cacheprovider", "-p",
                "no:randomly"]


def default_tests() -> List[str]:
    return sorted(str(p.relative_to(REPO))
                  for p in (REPO / "tests").glob("test_torch_*.py"))


def _measured_path(filename: str):
    """Resolved path string when the file is measured, else None. The
    RESOLVED form is the canonical hits key — co_filename can be relative
    or traverse symlinks, and report() looks up by resolved path."""
    if "__pycache__" in filename or not filename.endswith(".py"):
        return None
    resolved = Path(filename).resolve()
    try:
        rel = resolved.relative_to(REPO)
    except ValueError:
        return None
    return str(resolved) if rel.parts[0] in MEASURED_DIRS else None


def _measured(filename: str) -> bool:
    return _measured_path(filename) is not None


def executable_lines(path: Path) -> Set[int]:
    """Line numbers that produce executed bytecode, from the AST."""
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return set()
    lines: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            lines.add(node.lineno)
            continue
        if not isinstance(node, ast.stmt):
            continue
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            continue  # compile-time declarations: no bytecode
        if (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            continue  # docstring / bare string: no bytecode
        lines.add(node.lineno)
    return lines


class Collector:
    """First-hit line recorder over sys.monitoring. ``tool_id`` defaults
    to COVERAGE_ID; the self-test passes another id so it can run inside
    a coverage run without fighting over the slot."""

    def __init__(self, tool_id: int = None):
        self.hits: Dict[str, Set[int]] = {}
        self._tool = (sys.monitoring.COVERAGE_ID
                      if tool_id is None else tool_id)

    def start(self) -> None:
        sys.monitoring.use_tool_id(self._tool,
                                   "k8s-operator-libs-tpu-torch-cov")
        sys.monitoring.register_callback(
            self._tool, sys.monitoring.events.LINE, self._on_line)
        sys.monitoring.set_events(self._tool, sys.monitoring.events.LINE)

    def stop(self) -> None:
        sys.monitoring.set_events(self._tool, 0)
        sys.monitoring.register_callback(
            self._tool, sys.monitoring.events.LINE, None)
        sys.monitoring.free_tool_id(self._tool)

    def _on_line(self, code, lineno):
        resolved = _measured_path(code.co_filename)
        if resolved is not None:
            self.hits.setdefault(resolved, set()).add(lineno)
        # either way: this (code, line) never fires again
        return sys.monitoring.DISABLE


def report(hits: Dict[str, Set[int]], out_path: Path,
           subset: Optional[str] = None) -> float:
    """Per-file table and total over the measured package, printed and
    written to ``out_path``; ``subset`` names the tests that ran."""
    rows = []
    total_exec = total_hit = 0
    for d in MEASURED_DIRS:
        for path in sorted((REPO / d).rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            exe = executable_lines(path)
            if not exe:
                continue
            got = hits.get(str(path.resolve()), set()) & exe
            total_exec += len(exe)
            total_hit += len(got)
            rows.append((str(path.relative_to(REPO)), len(got), len(exe),
                         sorted(exe - got)))
    pct = 100.0 * total_hit / total_exec if total_exec else 0.0
    rows.sort(key=lambda r: r[1] / r[2])
    print("\n--- coverage (k8s_operator_libs_tpu_torch.cov, "
          "sys.monitoring) ---")
    for rel, got, exe, _missing in rows[:12]:
        print(f"  {100.0 * got / exe:5.1f}%  {got:>5}/{exe:<5}  {rel}")
    if len(rows) > 12:
        print(f"  ... {len(rows) - 12} more files in {out_path.name}")
    print(f"TOTAL: {pct:.1f}% ({total_hit}/{total_exec} lines, "
          f"{len(rows)} files)")
    out_path.write_text(json.dumps({
        "subset": subset,
        "total_pct": round(pct, 2),
        "lines_hit": total_hit, "lines_executable": total_exec,
        "files": {rel: {"hit": got, "executable": exe,
                        "pct": round(100.0 * got / exe, 2),
                        "missing": missing}
                  for rel, got, exe, missing in rows}}, indent=1))
    print(f"full table: {out_path}")
    return pct


def main(argv) -> int:
    os.chdir(REPO)
    # --min-pct N: fail (exit 2) when total coverage lands below N (a CI
    # floor). Parsed here so the rest of argv passes through to pytest
    # untouched.
    min_pct = None
    argv = list(argv)
    if "--min-pct" in argv:
        i = argv.index("--min-pct")
        try:
            min_pct = float(argv[i + 1])
        except (IndexError, ValueError):
            print("usage: python -m k8s_operator_libs_tpu_torch.cov "
                  "[pytest args...] --min-pct N")
            return 2
        del argv[i:i + 2]
    update_artifact = "--update-artifact" in argv
    if update_artifact:
        argv.remove("--update-artifact")
    # filtered runs refuse --update-artifact BEFORE running anything: a
    # partial selection must not masquerade as the artifact, and failing
    # after minutes of tests would waste the run
    partial = any(a == "-k" or "::" in a or a.endswith(".py")
                  for a in argv)
    if update_artifact and partial:
        print("--update-artifact requires the default selection "
              "(no -k/::/file filters)")
        return 2
    pytest_args = argv or default_tests() + DEFAULT_ARGS
    subset = ("tests/test_torch_*.py -m 'not slow'" if not argv
              else " ".join(argv))
    # `python -m pytest` puts the cwd on sys.path; in-process pytest.main
    # does not, so the measured package must be made importable here
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    collector = Collector()
    collector.start()
    try:
        import pytest
        rc = pytest.main(pytest_args)
    finally:
        collector.stop()
    # the tracked cov_torch.json refreshes ONLY under --update-artifact
    # on a PASSING run — by default every run writes the untracked
    # partial file, so a local run or a CI checkout never dirties the
    # committed number as a side effect. A failing/truncated run (-x,
    # --maxfail, or plain failures) downgrades to the partial file: its
    # coverage is not the selection's.
    if update_artifact and rc != 0:
        print(f"--update-artifact: run did not pass cleanly; writing "
              f"{PARTIAL} instead of the committed artifact")
        update_artifact = False
    out_name = ARTIFACT if update_artifact else PARTIAL
    pct = report(collector.hits, REPO / out_name, subset=subset)
    if rc == 0 and min_pct is not None and pct < min_pct:
        print(f"FAIL: coverage {pct:.1f}% below the --min-pct {min_pct}% "
              f"floor")
        return 2
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
