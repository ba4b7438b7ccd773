"""Small AST helpers shared by the domain passes."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional


def dotted(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` → ``["a", "b", "c"]``; None for anything that is not a
    pure Name/Attribute chain (calls, subscripts, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def is_lock_name(node: ast.AST) -> bool:
    """The repo's lock naming convention, shared by the LCK passes and the
    ProjectIndex: a receiver or with-context whose final dotted segment
    contains ``lock`` or ``mutex`` (``self._lock``, ``state_lock``, …)."""
    parts = dotted(node)
    if not parts:
        return False
    tail = parts[-1].lower()
    return "lock" in tail or "mutex" in tail


def annotate_parents(tree: ast.AST) -> None:
    """Attach ``_lint_parent`` to every node (the AST has no uplinks)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]


def parents(node: ast.AST) -> Iterator[ast.AST]:
    """Walk up the ``_lint_parent`` chain (requires annotate_parents)."""
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def walk_same_function(node: ast.AST) -> Iterator[ast.AST]:
    """Yield ``node`` and descendants WITHOUT entering nested function/
    class bodies — the traversal domain for "inside this function" checks
    (a nested def's body executes later, under its own rules). A nested
    def is yielded itself (so its *presence* is visible) but never
    descended into — including when it is the traversal root."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda, ast.ClassDef)):
        return
    for child in ast.iter_child_nodes(node):
        yield from walk_same_function(child)
