"""EXC002: broad-except swallow audit over the library and its binaries.

Every ``except Exception:`` / ``except BaseException:`` / bare
``except:`` is a place where a typed classification — an ``ApiError``
the DEGRADED machinery needs to see, a ``BreakerOpenError`` that should
flip fail-static mode, the crash explorer's kill — can silently become
a log line. Some of those catches are load-bearing (per-component tick
isolation, advisory-write best-effort paths); the audit's job is to make
each one EARN its breadth:

a broad handler passes when it

- **re-raises** — any ``raise`` statement in the handler body (bare
  re-raise, ``raise X from exc`` narrowing, conditional re-raise), or
- **carries the hatch** — ``# exc: allow — <reason>`` on the ``except``
  line, with a NON-EMPTY reason (an empty hatch is a rubber stamp, not
  a triage);

anything else fires. Narrowing the clause to concrete types is the
other fix (then it is no longer broad). There is no baseline for this
code: all historical sites are triaged, so baseline.txt stays empty and
every new broad catch must justify itself at review time.

Scope: the library package and its entry points — the code the
operator runs in production (the reference's package and ``cmd/``). The
developer tools of :data:`~.index.BINARY_TWINS` (the twins of
``tools/``), ``tests/`` and ``chip_smoke.py`` are out of scope by
construction (their broad catches guard developer tooling, not
reconcile semantics). ``E722`` (generic) already covers the bare-except
*syntax*; EXC002 is the stricter domain contract on top.

Proven by OFFENDERS/CLEAN fixtures via tests/test_torch_lint_flow.py.
"""

from __future__ import annotations

import ast
import re
from pathlib import PurePath
from typing import List, Tuple

from .astutil import dotted
from .index import binary_twin
from .registry import Check, FileContext, register

CODES = {
    "EXC002": "broad except (Exception/BaseException/bare) that neither "
              "re-raises nor carries a `# exc: allow — <why>` hatch — "
              "narrow it, re-raise, or justify it",
}

HATCH = "# exc: allow"
# the hatch must carry a reason: "# exc: allow — why" (em-dash or "--")
HATCH_RE = re.compile(r"#\s*exc:\s*allow\s*(?:—|--|-)\s*\S")

PACKAGE = "k8s_operator_libs_tpu_torch"

BROAD_NAMES = ("Exception", "BaseException")


def _in_scope(path: str) -> bool:
    if PACKAGE not in PurePath(path).parts:
        return False
    twin = binary_twin(path, PACKAGE)
    return twin is None or not twin.startswith("tools/")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    nodes = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for n in nodes:
        parts = dotted(n)
        if parts and parts[-1] in BROAD_NAMES:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Any raise in the handler body (not inside a nested def/lambda):
    bare re-raise, narrowed `raise X from exc`, conditional re-raise —
    all count as the handler taking a typed position."""
    stack: List[ast.AST] = list(handler.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Raise):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _run(ctx: FileContext) -> List[Tuple[int, str, str]]:
    if not _in_scope(ctx.path):
        return []
    findings: List[Tuple[int, str, str]] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node) or _reraises(node):
            continue
        lineno = node.lineno
        line = ctx.lines[lineno - 1] if 0 < lineno <= len(ctx.lines) else ""
        if HATCH in line:
            if HATCH_RE.search(line):
                continue
            findings.append(
                (lineno, "EXC002",
                 "broad except hatch without a reason — write "
                 "`# exc: allow — <why this catch must be broad>`"))
            continue
        what = "bare except:" if node.type is None else \
            "except " + (ast.unparse(node.type)
                         if hasattr(ast, "unparse") else "Exception")
        findings.append(
            (lineno, "EXC002",
             f"{what} swallows every classification (ApiError family, "
             f"crash kills) — narrow to concrete types, re-raise, or "
             f"add `{HATCH} — <why>`"))
    return findings


register(Check(name="exc-swallow", codes=CODES, scope="file", run=_run,
               domain=True))


# ------------------------------------------------------- self-test fixtures
# Replayed by tests/test_torch_lint_flow.py under a package-shaped path.

OFFENDERS = {
    "EXC002": '''
import logging

logger = logging.getLogger(__name__)


def tick(mgr):
    try:
        mgr.apply_state()
    except Exception:
        logger.exception("apply failed")
    try:
        mgr.flush()
    except Exception:   # exc: allow
        pass
''',
}

CLEAN = {
    "EXC002": '''
import logging

logger = logging.getLogger(__name__)


def tick(mgr):
    try:
        mgr.apply_state()
    except ValueError:
        logger.exception("bad state")        # narrow: not broad
    try:
        mgr.flush()
    except Exception:
        raise                                 # re-raises
    try:
        mgr.emit_event()
    except Exception:   # exc: allow — events are advisory; never fail a tick
        pass
''',
}
