"""lint: the port's static-analysis suite, stdlib-only (the twin of the
JAX package's ``tools/lint``, first half).

A check-registry plugin architecture (see :mod:`.registry`) over a shared
:class:`~.index.ProjectIndex`: the driver parses every file exactly once,
every pass (file-scope and cross-module alike) consumes the index, and
passes run in parallel off it.

Passes:

- :mod:`.core`            — the 16 generic pyflakes-class codes
                            (F821/F401/F811/F841/B006/E722/F541/F601/
                            E712/F632/F631/F602/W605/W0101/A001/A002)
- :mod:`.lock_discipline` — LCK001–LCK003 threading lock invariants
- :mod:`.lock_order`      — LCK004 cross-function lock-order cycles and
                            blocking calls reached while a lock is held
- :mod:`.sync_check`      — SYN001 host-sync hygiene on the decode and
                            training hot paths (torch readbacks)
- :mod:`.thread_discipline` — THR001 threading-shim closure, GRD001
                            guarded-field discipline

The JAX package's JAX001–JAX004 pass has no twin: the port traces no
code. The determinism, exception, dataflow and closure passes are not
ported yet.

Usage::

    python -m k8s_operator_libs_tpu_torch.lint [paths...]   # everything
    python -m k8s_operator_libs_tpu_torch.lint --generic [...]
    python -m k8s_operator_libs_tpu_torch.lint --domain  [...]
    python -m k8s_operator_libs_tpu_torch.lint --format github   # CI annotations
    python -m k8s_operator_libs_tpu_torch.lint --format json     # machine-readable
    python -m k8s_operator_libs_tpu_torch.lint --codes           # every code

Exit 1 on any non-baselined finding. Suppress a single finding by
appending ``# lint: ignore`` (or ``# noqa``) to its line; park whole
known-debt classes in ``lint/baseline.txt`` beside this file
(``--no-baseline`` shows everything, ``--write-baseline`` regenerates the
file from the current findings). Project-scope passes (SYN/LCK004) run
against the repo root whenever domain checks are enabled and no explicit
path arguments narrow the run.
"""

from __future__ import annotations

import ast
import json as _json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

from .registry import REGISTRY, Check, FileContext, all_codes, register
from .index import ProjectIndex, as_index
from . import (core, lock_discipline, lock_order, sync_check,  # noqa: F401  (registration imports)
               thread_discipline)

__all__ = ["lint_file", "lint_project", "run_suite", "main",
           "REGISTRY", "Check", "register", "all_codes",
           "ProjectIndex", "as_index"]

REPO_ROOT = Path(__file__).resolve().parent.parent.parent

# the port's package, its card smoke and the port's own test files
DEFAULT_TARGETS = [ProjectIndex.PACKAGE, "chip_smoke.py",
                   "tests/test_torch_*.py"]

BASELINE_PATH = Path(__file__).resolve().parent / "baseline.txt"

Finding = Tuple[str, int, str, str]            # (path, lineno, code, msg)


def _suppressed(lines: List[str], lineno: int) -> bool:
    if 0 < lineno <= len(lines):
        line = lines[lineno - 1]
        return "# lint: ignore" in line or "# noqa" in line
    return False


# ------------------------------------------------------------ compat layer

def lint_file(path: Path, domain: bool = True,
              generic: bool = True) -> List[str]:
    """Run the file-scope checks over ONE file → formatted findings.

    The single-file compatibility surface (fixture replay, the historical
    ``python -m k8s_operator_libs_tpu_torch.lint file.py``); suite runs go through
    :func:`run_suite` and the shared ProjectIndex instead."""
    path = Path(path)
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        return [f"{path}:{exc.lineno}: E999 syntax error: {exc.msg}"]
    ctx = FileContext(path=str(path), tree=tree, lines=source.splitlines(),
                      source=source)
    findings = []
    for check in REGISTRY:
        if check.scope != "file":
            continue
        if (check.domain and not domain) or (not check.domain
                                             and not generic):
            continue
        findings.extend(check.run(ctx))
    return [f"{path}:{lineno}: {code} {msg}"
            for lineno, code, msg in sorted(findings)
            if not _suppressed(ctx.lines, lineno)]


def lint_project(root: Path = REPO_ROOT) -> List[str]:
    """Run the project-scope (cross-file) passes → formatted findings."""
    index = as_index(Path(root))
    out: List[str] = []
    for check in REGISTRY:
        if check.scope != "project":
            continue
        for rel, lineno, code, msg in check.run(index):
            try:
                lines = index.lines(rel)
            except OSError:
                lines = []
            if _suppressed(lines, lineno):
                continue
            out.append(f"{rel}:{lineno}: {code} {msg}")
    return sorted(out)


# ------------------------------------------------------------ suite driver

def _collect(targets: List[str], base: Optional[Path] = None) -> List[Path]:
    files: List[Path] = []
    for t in targets:
        p = Path(t)
        if base is not None and not p.is_absolute():
            p = base / p
        if any(ch in t for ch in "*?["):
            files.extend(sorted(q for q in p.parent.glob(p.name)
                                if q.suffix == ".py"))
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return [f for f in files if "__pycache__" not in f.parts]


def load_baseline(path: Path) -> set:
    """Baseline entries: ``path:CODE`` (every finding of CODE in that
    file) or ``path:lineno:CODE`` (one pinned finding). ``#`` comments
    and blank lines are skipped."""
    entries = set()
    if not path.is_file():
        return entries
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        entries.add(line)
    return entries


def _baselined(finding: Finding, baseline: set) -> bool:
    rel, lineno, code, _ = finding
    return (f"{rel}:{code}" in baseline
            or f"{rel}:{lineno}:{code}" in baseline)


def run_suite(paths: Optional[List[str]] = None, mode: str = "all",
              root: Path = REPO_ROOT, jobs: Optional[int] = None
              ) -> Tuple[List[Finding], ProjectIndex]:
    """The engine: one ProjectIndex, every enabled pass run off it in a
    thread pool. Returns (sorted findings before baseline filtering, the
    index — whose ``parse_counts`` the spy test reads)."""
    root = Path(root)
    explicit = bool(paths)
    files = (_collect(list(paths)) if explicit
             else _collect(DEFAULT_TARGETS, base=root))
    index = ProjectIndex(root, files=files)
    domain = mode != "generic"
    generic = mode != "domain"
    file_checks = [c for c in REGISTRY if c.scope == "file"
                   and (c.domain and domain or not c.domain and generic)]
    project_checks = [c for c in REGISTRY if c.scope == "project" and domain]

    def run_file(path: Path) -> List[Finding]:
        rel = index.rel(path)
        try:
            ctx = index.context(rel)
        except SyntaxError as exc:
            return [(rel, exc.lineno or 0, "E999",
                     f"syntax error: {exc.msg}")]
        out: List[Finding] = []
        for check in file_checks:
            out.extend((rel, lineno, code, msg)
                       for lineno, code, msg in check.run(ctx))
        return out

    def run_project_check(check: Check) -> List[Finding]:
        return list(check.run(index))

    workers = jobs or min(8, (os.cpu_count() or 2))
    findings: List[Finding] = []
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(run_file, f) for f in files]
        if not explicit:
            futures += [ex.submit(run_project_check, c)
                        for c in project_checks]
        for fut in futures:
            findings.extend(fut.result())

    kept: List[Finding] = []
    for finding in findings:
        rel, lineno = finding[0], finding[1]
        try:
            lines = index.lines(rel)
        except (OSError, SyntaxError):
            lines = []
        if not _suppressed(lines, lineno):
            kept.append(finding)
    return sorted(set(kept)), index


# ---------------------------------------------------------------- emitters

def _gh_escape(s: str, prop: bool = False) -> str:
    s = s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    if prop:
        s = s.replace(":", "%3A").replace(",", "%2C")
    return s


def emit(findings: List[Finding], fmt: str) -> None:
    if fmt == "json":
        print(_json.dumps([{"path": p, "line": ln, "code": c, "message": m}
                           for p, ln, c, m in findings], indent=2))
    elif fmt == "github":
        for p, ln, c, m in findings:
            print(f"::error file={_gh_escape(p, prop=True)},line={ln},"
                  f"title={_gh_escape(c, prop=True)}::{_gh_escape(m)}")
    else:
        for p, ln, c, m in findings:
            print(f"{p}:{ln}: {c} {m}")


# -------------------------------------------------------------------- main

def main(argv: List[str]) -> int:
    mode = "all"
    fmt = "text"
    jobs: Optional[int] = None
    baseline_path = BASELINE_PATH
    use_baseline = True
    write_baseline = False
    paths: List[str] = []
    it = iter(argv)
    for a in it:
        if a in ("--generic", "--generic-only"):
            mode = "generic"
        elif a in ("--domain", "--domain-only"):
            mode = "domain"
        elif a == "--codes":
            for code, desc in sorted(all_codes().items()):
                print(f"{code}  {desc}")
            return 0
        elif a == "--format":
            fmt = next(it, "text")
        elif a.startswith("--format="):
            fmt = a.split("=", 1)[1]
        elif a == "--jobs":
            jobs = int(next(it, "0")) or None
        elif a.startswith("--jobs="):
            jobs = int(a.split("=", 1)[1]) or None
        elif a == "--baseline":
            baseline_path = Path(next(it, str(BASELINE_PATH)))
        elif a.startswith("--baseline="):
            baseline_path = Path(a.split("=", 1)[1])
        elif a == "--no-baseline":
            use_baseline = False
        elif a == "--write-baseline":
            write_baseline = True
        else:
            paths.append(a)
    if fmt not in ("text", "json", "github"):
        print(f"unknown --format {fmt!r} (text|json|github)",
              file=sys.stderr)
        return 2

    findings, index = run_suite(paths or None, mode=mode, jobs=jobs)

    if write_baseline:
        entries = sorted({f"{rel}:{code}" for rel, _, code, _ in findings})
        baseline_path.write_text(
            "# lint baseline — known debt parked so new codes land\n"
            "# strict. One entry per line: path:CODE (every finding of\n"
            "# CODE in that file) or path:lineno:CODE. Shrink, don't grow.\n"
            + "".join(e + "\n" for e in entries))
        print(f"wrote {len(entries)} baseline entries to {baseline_path}",
              file=sys.stderr)
        return 0

    baseline = load_baseline(baseline_path) if use_baseline else set()
    visible = [f for f in findings if not _baselined(f, baseline)]
    emit(visible, fmt)
    parses = sum(index.parse_counts.values())
    baselined = len(findings) - len(visible)
    print(f"lint[{mode}]: {len(index.files())} files, {parses} parses, "
          f"{len(visible)} findings"
          + (f" ({baselined} baselined)" if baselined else ""),
          file=sys.stderr)
    return 1 if visible else 0
