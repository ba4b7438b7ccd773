"""lint: the port's static-analysis suite, stdlib-only (the twin of the
JAX package's ``tools/lint``).

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
- :mod:`.determinism`     — DET001/DET002 injected-clock and seeded-RNG
                            discipline (chaos seed replay depends on it)
- :mod:`.state_machine`   — STM001 upgrade-state-machine exhaustiveness
- :mod:`.obs_check`       — OBS001–OBS005 journey/attribution/SLO/
                            timeline/usage closure
- :mod:`.chaos_check`     — CHS001 chaos fault-catalog closure
- :mod:`.crash_check`     — CRS001 crash-explorer durable-write-site
                            closure over the wire keys it stamps
- :mod:`.exc_contracts`   — EXC001 exception-contract closure over the
                            reconcile spine (interprocedural may-raise,
                            on the :mod:`.dataflow` engine)
- :mod:`.exc_swallow`     — EXC002 broad-except swallow audit
- :mod:`.exc_kill`        — EXC003 crash-kill transparency (no handler
                            may eat the explorer's OperatorKilled)
- :mod:`.stale_taint`     — STL001 stale-read taint: store reads cross
                            the freshness barrier before safety writes
- :mod:`.wire_check`      — WIRE001 wire-key registry closure
- :mod:`.sync_check`      — SYN001 host-sync hygiene on the decode and
                            training hot paths (torch readbacks)
- :mod:`.thread_discipline` — THR001 threading-shim closure, GRD001
                            guarded-field discipline
- :mod:`.layering`        — ARC001 import layering + cycle rejection

The JAX package's JAX001–JAX004 pass has no twin: the port traces no
code. DET, EXC002 and ARC001 scope themselves by
:data:`.index.BINARY_TWINS`, the port's modules whose reference twins
are binaries or tools.

Usage::

    python -m k8s_operator_libs_tpu_torch.lint [paths...]   # everything
    python -m k8s_operator_libs_tpu_torch.lint --generic [...]
    python -m k8s_operator_libs_tpu_torch.lint --domain  [...]
    python -m k8s_operator_libs_tpu_torch.lint --format github   # CI annotations
    python -m k8s_operator_libs_tpu_torch.lint --format json     # machine-readable
    python -m k8s_operator_libs_tpu_torch.lint --codes           # every code
    python -m k8s_operator_libs_tpu_torch.lint --explain EXC001  # its docs section

Exit 1 on any non-baselined finding. Suppress a single finding by
appending ``# lint: ignore`` (or ``# noqa``) to its line; park whole
known-debt classes in ``lint/baseline.txt`` beside this file
(``--no-baseline`` shows everything, ``--write-baseline`` regenerates the
file from the current findings). Project-scope passes (STM/OBS/CHS/CRS/
WIRE/EXC001/EXC003/STL/SYN/LCK004/ARC) run against the repo root whenever
domain checks are enabled and no explicit path arguments narrow the run.
docs/static-analysis-torch.md documents every code.
"""

from __future__ import annotations

import ast
import json as _json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

from .registry import REGISTRY, Check, FileContext, all_codes, register
from .index import ProjectIndex, as_index
from . import (core, lock_discipline, lock_order, determinism,  # noqa: F401,E501  (registration imports)
               state_machine, obs_check, chaos_check, crash_check,
               exc_contracts, exc_swallow, exc_kill, stale_taint,
               wire_check, sync_check, thread_discipline, layering)

__all__ = ["lint_file", "lint_project", "run_suite", "explain", "main",
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


# ----------------------------------------------------------------- explain

DOCS_PATH = REPO_ROOT / "docs" / "static-analysis-torch.md"

_RANGE_RE = re.compile(r"([A-Z]+)(\d+)\s*[–/-]\s*(?:([A-Z]+))?(\d+)")


def _heading_covers(heading: str, code: str) -> bool:
    """Does a ``### CODES · title`` heading cover ``code``? Handles the
    catalog's spellings: ``EXC001``, ``DET001/DET002``,
    ``JAX001–JAX004`` (range), ``THR001/GRD001``."""
    spec = heading.partition("·")[0]
    if code in spec.replace("–", "/").replace("-", "/").split("/") \
            or f" {code} " in f" {spec.strip()} ":
        return True
    m = re.match(r"([A-Z]+)(\d+)", code)
    if not m:
        return False
    prefix, num = m.group(1), int(m.group(2))
    for rm in _RANGE_RE.finditer(spec):
        lo_p, lo_n, hi_p, hi_n = (rm.group(1), int(rm.group(2)),
                                  rm.group(3) or rm.group(1),
                                  int(rm.group(4)))
        if prefix == lo_p == hi_p and lo_n <= num <= hi_n:
            return True
    return False


def explain(code: str, docs_path: Path = DOCS_PATH) -> Optional[str]:
    """The docs/static-analysis-torch.md section for ``code`` — catalog
    entry, clean idiom, escape hatch — so a CI annotation links somewhere
    actionable. Resolution order: a ``###`` section whose heading covers
    the code (ranges and slash-lists included), a ``**CODE**`` bold
    entry inside another code's section (the OBS002 convention), or the
    generic-codes table row. None when the code is undocumented (the
    docs-coverage unit test fails on that)."""
    if not docs_path.is_file():
        return None
    lines = docs_path.read_text().splitlines()
    # pass 1: a ### section of its own
    for i, line in enumerate(lines):
        if line.startswith("### ") and _heading_covers(line[4:], code):
            return _section_at(lines, i)
    # pass 2: documented inside another section as **CODE**
    for i, line in enumerate(lines):
        if f"**{code}**" in line:
            for j in range(i, -1, -1):
                if lines[j].startswith("### "):
                    return _section_at(lines, j)
    # pass 3: a generic-table row
    for line in lines:
        if line.startswith(f"| {code} "):
            return f"{code} (generic pass — `--generic`)\n{line}"
    return None


def _section_at(lines: List[str], start: int) -> str:
    out = [lines[start]]
    for line in lines[start + 1:]:
        if line.startswith("### ") or line.startswith("## "):
            break
        out.append(line)
    return "\n".join(out).rstrip() + "\n"


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
        elif a == "--explain" or a.startswith("--explain="):
            code = (a.split("=", 1)[1] if "=" in a
                    else next(it, "")).strip().upper()
            if not code:
                print("usage: --explain CODE", file=sys.stderr)
                return 2
            section = explain(code)
            if section is None:
                print(f"no docs/static-analysis-torch.md entry for {code!r} "
                      f"(--codes lists every registered code)",
                      file=sys.stderr)
                return 2
            print(section)
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
