"""THR001/GRD001: thread-discipline closure over the operator spine.

The runtime half of the concurrency sanitizer (``utils/threads.py`` +
the package's ``race/``) only works on threading that ROUTES THROUGH the
shim:
a raw ``threading.Thread`` is invisible to the registry (shutdown leak
accounting breaks), a raw ``threading.Lock`` never reaches the
held-lock stack (the lockset checker goes blind) and neither gets a
preemption point under the cooperative explorer. These codes keep the
library closed over that seam — the static half of the sanitizer:

  THR001  raw ``threading.Thread/Lock/RLock/Event/Condition``
          construction anywhere in the port's package (its binaries,
          ``server.py``, ``router.py``, ``operator.py``, ..., are
          modules of it). Route through ``utils/threads.py``
          (``threads.spawn(name, fn)``, ``threads.make_lock(name)``,
          ...). The shim module itself is the one sanctioned
          construction site; ``tests/`` and ``chip_smoke.py`` sit
          outside the scope by path.
  GRD001  guarded-field discipline: an attribute written under a held
          lock in one method of a class but read or written LOCK-FREE
          in a different method. The finding names the lock and both
          sites. (A lock-free WRITE additionally fires file-scope
          LCK003 — GRD001 is the cross-method closure that also covers
          the read side, which LCK003 never sees.) ``__init__``
          construction accesses are exempt: no other thread can hold a
          reference yet.

"Lock" is the repo's name convention (``astutil.is_lock_name``): a
with-context whose final segment contains ``lock``/``mutex``.

Escape hatch: a deliberately lock-free access (a monotonic flag read
whose staleness is benign, a GIL-atomic counter nobody sums) carries
``# thr: allow — <why>`` on the flagged line; same hatch for a raw
threading construction that genuinely must not route through the shim.
"""

from __future__ import annotations

import ast
from pathlib import PurePath
from typing import Dict, List, Optional, Set, Tuple

from .astutil import dotted, is_lock_name, parents, annotate_parents
from .registry import Check, FileContext, register

CODES = {
    "THR001": "raw threading primitive construction outside the "
              "utils/threads.py shim (route through threads.spawn/"
              "make_lock/make_event so the race explorer and the "
              "registry see it)",
    "GRD001": "attribute written under a lock in one method but "
              "accessed lock-free in another method of the same class",
}

HATCH = "# thr: allow"

PACKAGE = "k8s_operator_libs_tpu_torch"
SHIM_SUFFIX = "utils/threads.py"

PRIMITIVES = {"Thread", "Lock", "RLock", "Event", "Condition"}


def _in_scope(path: str) -> bool:
    p = PurePath(path)
    posix = p.as_posix()
    if posix.endswith(SHIM_SUFFIX):
        return False
    return PACKAGE in p.parts


def _hatched(lines: List[str], lineno: int) -> bool:
    return 0 < lineno <= len(lines) and HATCH in lines[lineno - 1]


# ------------------------------------------------------------------ THR001

class _ThreadingAliases:
    """Local names that mean the ``threading`` module, and from-imported
    primitive constructors (``from threading import Thread [as T]``)."""

    def __init__(self, tree: ast.Module):
        self.modules: Set[str] = set()
        self.names: Dict[str, str] = {}     # local name -> primitive
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "threading":
                        self.modules.add(alias.asname or "threading")
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module == "threading":
                    for alias in node.names:
                        if alias.name in PRIMITIVES:
                            self.names[alias.asname or alias.name] = \
                                alias.name


def _check_thr(ctx: FileContext) -> List[Tuple[int, str, str]]:
    al = _ThreadingAliases(ctx.tree)
    findings: List[Tuple[int, str, str]] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        parts = dotted(node.func)
        if not parts:
            continue
        prim: Optional[str] = None
        if len(parts) == 2 and parts[0] in al.modules \
                and parts[1] in PRIMITIVES:
            prim = parts[1]
        elif len(parts) == 1 and parts[0] in al.names:
            prim = al.names[parts[0]]
        if prim is None:
            continue
        if _hatched(ctx.lines, node.lineno):
            continue
        fix = {"Thread": "threads.spawn(name, target)",
               "Lock": 'threads.make_lock("name")',
               "RLock": 'threads.make_rlock("name")',
               "Event": 'threads.make_event("name")',
               "Condition": 'threads.make_condition("name")'}[prim]
        findings.append((
            node.lineno, "THR001",
            f"raw threading.{prim}() bypasses the utils/threads.py shim "
            f"— use {fix} (registry, lockset tracking and the race "
            f"explorer all hang off the shim)"))
    return findings


# ------------------------------------------------------------------ GRD001

def _enclosing_lock(node: ast.AST, method: ast.AST) -> Optional[str]:
    """Dotted name of the innermost with-lock wrapping ``node`` inside
    ``method`` (None = lock-free). Requires annotate_parents."""
    for p in parents(node):
        if p is method:
            return None
        if isinstance(p, (ast.With, ast.AsyncWith)):
            for item in p.items:
                if is_lock_name(item.context_expr):
                    return ".".join(dotted(item.context_expr) or ["lock"])
    return None


def _check_grd_class(ctx: FileContext, cls: ast.ClassDef
                     ) -> List[Tuple[int, str, str]]:
    # pass 1: guarded writes per attribute — (lock name, method, line)
    guarded: Dict[str, Tuple[str, str, int]] = {}
    methods = [m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for method in methods:
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
                if is_lock_name(t):
                    continue
                lock = _enclosing_lock(node, method)
                if lock is not None and t.attr not in guarded:
                    guarded[t.attr] = (lock, method.name, node.lineno)
    if not guarded:
        return []
    # pass 2: lock-free accesses to those attributes in OTHER methods
    findings: List[Tuple[int, str, str]] = []
    seen: Set[Tuple[int, str]] = set()
    for method in methods:
        if method.name == "__init__":
            continue  # construction: no concurrent reader exists yet
        for node in ast.walk(method):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guarded):
                continue
            lock, g_method, g_line = guarded[node.attr]
            if method.name == g_method:
                continue  # same method: cross-method discipline only
            if _enclosing_lock(node, method) is not None:
                continue  # guarded (by some lock) — LCK-family territory
            what = "written" if isinstance(node.ctx, (ast.Store, ast.Del)) \
                else "read"
            key = (node.lineno, node.attr)
            if key in seen:
                continue
            seen.add(key)
            if _hatched(ctx.lines, node.lineno):
                continue
            findings.append((
                node.lineno, "GRD001",
                f"self.{node.attr} {what} lock-free in "
                f"{cls.name}.{method.name}() but written under {lock} in "
                f"{cls.name}.{g_method}() (line {g_line}) — hold {lock} "
                f"here or hatch with '# thr: allow — why'"))
    return findings


def _run(ctx: FileContext) -> List[Tuple[int, str, str]]:
    if not _in_scope(ctx.path):
        return []
    annotate_parents(ctx.tree)
    findings = _check_thr(ctx)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_check_grd_class(ctx, node))
    return findings


register(Check(name="thread-discipline", codes=CODES, scope="file",
               run=_run, domain=True))


# ------------------------------------------------------- self-test fixtures
# Replayed by the lint tests under a package-shaped path (the pass is
# scoped to the port's package).

OFFENDERS = {
    "THR001": '''
import threading
from threading import Event as StopEvent


class Worker:
    def __init__(self):
        self.lock = threading.Lock()
        self.stop = StopEvent()

    def start(self):
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        while not self.stop.is_set():
            self.stop.wait(1.0)
''',
    "GRD001": '''
from ..utils import threads


class Runtime:
    def __init__(self):
        self._lock = threads.make_lock("runtime")
        self.draining = False

    def drain(self):
        with self._lock:
            self.draining = True

    def admitting(self):
        return not self.draining   # lock-free read races drain()
''',
}

CLEAN = {
    "THR001": '''
from ..utils import threads


class Worker:
    def __init__(self):
        self.lock = threads.make_lock("worker")
        self.stop = threads.make_event("worker-stop")

    def start(self):
        self.thread = threads.spawn("worker", self.run)

    def run(self):
        while not self.stop.is_set():
            self.stop.wait(1.0)
''',
    "GRD001": '''
from ..utils import threads


class Runtime:
    def __init__(self):
        self._lock = threads.make_lock("runtime")
        self.draining = False    # construction: no other threads yet

    def drain(self):
        with self._lock:
            self.draining = True

    def admitting(self):
        with self._lock:
            return not self.draining
''',
}
