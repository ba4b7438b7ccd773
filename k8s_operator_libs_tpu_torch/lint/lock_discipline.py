"""LCK001–LCK003: lock discipline for the threaded serving/upgrade paths.

The port's threaded modules (core/cachedclient, core/leaderelection,
upgrade/pod_manager, upgrade/drain_manager, server, train/uploader,
data/loader, ...) are the same as the JAX package's. The invariants these
codes pin are the three lock mistakes that produce rare, unreproducible
failures rather than stack traces:

  LCK001  ``lock.acquire()`` without a ``release()`` in a ``finally`` —
          an exception between acquire and release deadlocks every other
          thread forever. Use ``with lock:`` or acquire/try/finally.
  LCK002  blocking call (time.sleep, subprocess.*, urlopen, requests.*)
          inside a ``with <lock>:`` body — the lock is held across a
          wait, serializing every thread behind one sleeper.
  LCK003  an attribute written both inside and outside ``with self.<lock>``
          blocks of the same class (``__init__`` construction writes
          exempt) — the unguarded write races the guarded readers.

"Lock" is name-based: a with-context or receiver whose final segment
contains ``lock`` or ``mutex`` (``self._lock``, ``self.lock``,
``state_lock``, ...) — matching this codebase's naming convention, which
the check itself enforces by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astutil import (annotate_parents, dotted, is_lock_name, parents,
                      walk_same_function)
from .registry import Check, FileContext, register

CODES = {
    "LCK001": "lock.acquire() without release() in a finally",
    "LCK002": "blocking call while holding a lock",
    "LCK003": "attribute written both inside and outside the class lock",
}

BLOCKING_PREFIXES = ("subprocess", "requests")
BLOCKING_EXACT = {("time", "sleep")}
BLOCKING_TAILS = {"urlopen"}


_is_lock_name = is_lock_name  # shared via astutil (the ProjectIndex uses it)


def _lock_items(node) -> List[ast.AST]:
    return [item.context_expr for item in node.items
            if _is_lock_name(item.context_expr)]


def _is_blocking(parts: Optional[List[str]]) -> Optional[str]:
    if not parts:
        return None
    name = ".".join(parts)
    if tuple(parts) in BLOCKING_EXACT or parts[0] in BLOCKING_PREFIXES \
            or parts[-1] in BLOCKING_TAILS:
        return name
    return None


def _release_targets(try_node: ast.Try) -> Set[str]:
    """Receivers released in this try's finally block."""
    out: Set[str] = set()
    for stmt in try_node.finalbody:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "release":
                recv = dotted(node.func.value)
                if recv:
                    out.add(".".join(recv))
    return out


def _check_acquire(findings, stmt: ast.stmt) -> None:
    """LCK001 on a bare ``R.acquire()`` statement (or ``x = R.acquire()``):
    fine iff some enclosing try — or the try immediately following it in
    the same block — releases R in its finally."""
    call = stmt.value if isinstance(stmt, (ast.Expr, ast.Assign)) else None
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"):
        return
    recv_parts = dotted(call.func.value)
    if not recv_parts:
        return
    recv = ".".join(recv_parts)
    for p in parents(stmt):
        if isinstance(p, ast.Try) and recv in _release_targets(p):
            return
    # acquire immediately before `try: ... finally: R.release()`
    parent = getattr(stmt, "_lint_parent", None)
    for field in ("body", "orelse", "finalbody"):
        block = getattr(parent, field, None)
        if isinstance(block, list) and stmt in block:
            i = block.index(stmt)
            if i + 1 < len(block) and isinstance(block[i + 1], ast.Try) \
                    and recv in _release_targets(block[i + 1]):
                return
    findings.append((stmt.lineno, "LCK001",
                     f"{recv}.acquire() without {recv}.release() in a "
                     f"finally (use `with {recv}:` instead)"))


def _check_with_body(findings, with_node) -> None:
    locks = _lock_items(with_node)
    if not locks:
        return
    lock = ".".join(dotted(locks[0]) or ["lock"])
    for stmt in with_node.body:
        for node in walk_same_function(stmt):
            if isinstance(node, ast.Call):
                name = _is_blocking(dotted(node.func))
                if name:
                    findings.append(
                        (node.lineno, "LCK002",
                         f"blocking call {name}() while holding {lock} "
                         "serializes every thread behind it"))


def _check_class(findings, cls: ast.ClassDef) -> None:
    """LCK003: per attribute, classify every ``self.X = ...`` write as
    guarded (inside a with-lock) or unguarded; both kinds present (with
    unguarded writes outside __init__) → report the unguarded ones."""
    guarded: Dict[str, List[int]] = {}
    unguarded: Dict[str, List[int]] = {}
    lock_names: Dict[str, str] = {}
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(method):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                attr = t.attr
                lock = None
                for p in parents(node):
                    if p is method:
                        break
                    if isinstance(p, (ast.With, ast.AsyncWith)):
                        items = _lock_items(p)
                        if items:
                            lock = ".".join(dotted(items[0]) or [])
                            break
                if lock:
                    guarded.setdefault(attr, []).append(node.lineno)
                    lock_names[attr] = lock
                elif method.name != "__init__":
                    unguarded.setdefault(attr, []).append(node.lineno)
    for attr in sorted(set(guarded) & set(unguarded)):
        for lineno in unguarded[attr]:
            findings.append(
                (lineno, "LCK003",
                 f"attribute self.{attr} written here without "
                 f"{lock_names[attr]}, but under it elsewhere in "
                 f"{cls.name} — racy"))


def _run(ctx: FileContext) -> List[Tuple[int, str, str]]:
    findings: List[Tuple[int, str, str]] = []
    annotate_parents(ctx.tree)
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Expr, ast.Assign)):
            _check_acquire(findings, node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            _check_with_body(findings, node)
        elif isinstance(node, ast.ClassDef):
            _check_class(findings, node)
    return findings


register(Check(name="lock-discipline", codes=CODES, scope="file", run=_run,
               domain=True))


# ------------------------------------------------------- self-test fixtures

OFFENDERS = {
    "LCK001": '''
import threading

LOCK = threading.Lock()

def update(registry, key, value):
    LOCK.acquire()
    registry[key] = value   # an exception here deadlocks everyone
    LOCK.release()
''',
    "LCK002": '''
import threading
import time

class Poller:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = {}

    def poll(self):
        with self._lock:
            time.sleep(1.0)
            return dict(self.state)
''',
    "LCK003": '''
import threading

class Runtime:
    def __init__(self):
        self._lock = threading.Lock()
        self.draining = False

    def drain(self):
        with self._lock:
            self.draining = True

    def reset(self):
        self.draining = False   # races drain()'s guarded write
''',
}

CLEAN = {
    "LCK001": '''
import threading

LOCK = threading.Lock()

def update(registry, key, value):
    with LOCK:
        registry[key] = value

def update_manual(registry, key, value):
    LOCK.acquire()
    try:
        registry[key] = value
    finally:
        LOCK.release()

def update_conditional(registry, key, value):
    acquired = LOCK.acquire(timeout=1.0)
    try:
        if acquired:
            registry[key] = value
    finally:
        LOCK.release()
''',
    "LCK002": '''
import threading
import time

class Poller:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = {}

    def poll(self):
        with self._lock:
            snapshot = dict(self.state)
        time.sleep(1.0)          # sleep OUTSIDE the lock
        return snapshot
''',
    "LCK003": '''
import threading

class Runtime:
    def __init__(self):
        self._lock = threading.Lock()
        self.draining = False    # construction: no other threads yet

    def drain(self):
        with self._lock:
            self.draining = True

    def is_draining(self):
        with self._lock:
            return self.draining
''',
}
