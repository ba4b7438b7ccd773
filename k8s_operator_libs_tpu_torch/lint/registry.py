"""Check registry: the plugin seam of the lint package.

Every check module builds one :class:`Check` and passes it to
:func:`register` at import time (the package's ``__init__`` imports the
check modules, so importing the package assembles the full suite — the
way golangci-lint enables linters from one config surface).

Two scopes:

- ``file``    — ``run(ctx)`` over one parsed file (a :class:`FileContext`),
                returning ``[(lineno, code, message), ...]``;
- ``project`` — ``run(root)`` over the repo checkout (cross-file passes:
                state-machine exhaustiveness, import layering), returning
                ``[(path, lineno, code, message), ...]``.

``domain=True`` marks the repo-invariant passes (LCK/THR/GRD/SYN) that
``--domain`` runs separately from the generic pyflakes-class codes.

Each check module also ships self-test fixtures (``OFFENDERS`` /
``CLEAN`` source snippets keyed by code) that the lint tests replay — a
check without a firing fixture and a stays-silent fixture cannot
register green.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List


@dataclasses.dataclass
class FileContext:
    """Everything a file-scope check needs, parsed once per file."""

    path: str
    tree: ast.Module
    lines: List[str]
    source: str


@dataclasses.dataclass
class Check:
    name: str
    codes: Dict[str, str]          # code -> one-line description
    scope: str                     # "file" | "project"
    run: Callable                  # see module docstring for signatures
    domain: bool = False


REGISTRY: List[Check] = []


def register(check: Check) -> Check:
    if check.scope not in ("file", "project"):
        raise ValueError(f"unknown check scope {check.scope!r}")
    REGISTRY.append(check)
    return check


def all_codes() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for check in REGISTRY:
        out.update(check.codes)
    return out


def selected(domain: bool, scope: str) -> List[Check]:
    return [c for c in REGISTRY if c.domain == domain and c.scope == scope]
