"""Eraser-style lockset race detection over the operator spine (the
port's twin of the JAX package's ``tools/race/lockset.py``).

Eraser (Savage et al. 1997): for every shared variable, track the
intersection of the locks held at each access; when the candidate
lockset goes EMPTY while the variable is shared and written, no single
lock protects it: a data race, whether or not this run interleaved
badly. So one schedule that merely touches an unguarded field from two
threads convicts it, without the exact racy interleaving.

In Python:

- **instrumentation**: a module-scoped ``sys.settrace`` /
  ``threading.settrace`` line tracer. Outside the watched files the
  global hook costs one dict lookup per call (it returns None there);
  inside them each line event looks up a table of ``self.<attr>`` reads
  and writes on that line, computed once per file by an AST pass
  (Python has line events, not attribute events).
- **locksets**: ``utils/threads.held_locks()``, the per-thread stack the
  shim (and the cooperative scheduler's primitives) keep. A raw
  ``threading.Lock`` would be invisible here, which is why the port
  makes every lock through the shim.
- **a state machine** per ``(object, attr)``: virgin, exclusive (one
  thread), then shared once a second thread arrives (the candidate
  lockset starts as the locks held by both and narrows on every later
  access). An empty lockset on written shared state reports a
  :class:`RaceFinding` with both access sites.

Accesses in ``__init__`` are exempt: the object is confined to one
thread while it is built.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..utils import threads as shim

# the operator spine: the files the checker watches by default, the
# modules that spawn threads and their shared-state neighbours
DEFAULT_SPINE = [
    "k8s_operator_libs_tpu_torch/core/cachedclient.py",
    "k8s_operator_libs_tpu_torch/core/leaderelection.py",
    "k8s_operator_libs_tpu_torch/upgrade/drain_manager.py",
    "k8s_operator_libs_tpu_torch/upgrade/pod_manager.py",
    "k8s_operator_libs_tpu_torch/upgrade/util.py",
    "k8s_operator_libs_tpu_torch/train/uploader.py",
    "k8s_operator_libs_tpu_torch/serving/pool.py",
    "k8s_operator_libs_tpu_torch/serving/router.py",
    "k8s_operator_libs_tpu_torch/router.py",
]


@dataclasses.dataclass(frozen=True)
class Access:
    file: str
    line: int
    thread: str
    write: bool


@dataclasses.dataclass
class RaceFinding:
    cls: str
    attr: str
    first: Access
    second: Access

    def __str__(self) -> str:
        return (f"lockset race on {self.cls}.{self.attr}: "
                f"{'write' if self.second.write else 'read'} at "
                f"{self.second.file}:{self.second.line} "
                f"[{self.second.thread}] with empty lockset; prior "
                f"{'write' if self.first.write else 'read'} at "
                f"{self.first.file}:{self.first.line} "
                f"[{self.first.thread}]")


class _VarState:
    __slots__ = ("first_thread", "first_access", "first_held", "lockset",
                 "shared", "written", "reported")

    def __init__(self, thread: str, access: Access,
                 held: "frozenset"):
        self.first_thread = thread
        self.first_access = access
        self.first_held = held           # locks at the last exclusive access
        self.lockset: Optional[Set[int]] = None   # None until shared
        self.shared = False
        self.written = access.write
        self.reported = False


HATCH = "# thr: allow"


def _attr_table(path: Path) -> Dict[int, List[Tuple[str, bool, bool]]]:
    """line → [(attr, is_write, in_init)] for every ``self.<attr>``
    access in the file. Skipped: lock-named attributes (holding a lock
    while touching the lock object itself is not shared state) and
    lines carrying the ``# thr: allow — why`` hatch, the comment that
    documents a deliberate benign race (the port keeps one only where the
    JAX package has the same line)."""
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    lines = source.splitlines()
    hatched = {i + 1 for i, line in enumerate(lines) if HATCH in line}
    table: Dict[int, List[Tuple[str, bool, bool]]] = {}

    def scan(node: ast.AST, in_init: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_init = in_init
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_init = child.name == "__init__"
            if isinstance(child, ast.Attribute) \
                    and isinstance(child.value, ast.Name) \
                    and child.value.id == "self" \
                    and child.lineno not in hatched:
                tail = child.attr.lower()
                if "lock" not in tail and "mutex" not in tail:
                    table.setdefault(child.lineno, []).append(
                        (child.attr,
                         isinstance(child.ctx, (ast.Store, ast.Del)),
                         in_init))
            scan(child, child_init)

    scan(tree, False)
    return table


class LocksetChecker:
    """Install around a run; read :attr:`races` after.

    ::

        checker = LocksetChecker(files)
        with checker:
            sched.run(harness, sched)
        assert not checker.races
    """

    def __init__(self, files: Optional[List[str]] = None,
                 root: Optional[Path] = None):
        root = root or Path(__file__).resolve().parent.parent.parent
        self._tables: Dict[str, Dict[int, List[Tuple[str, bool, bool]]]] = {}
        for rel in (files if files is not None else DEFAULT_SPINE):
            p = Path(rel)
            if not p.is_absolute():
                p = root / rel
            if p.is_file():
                self._tables[str(p)] = _attr_table(p)
        self._state: Dict[Tuple[int, str, str], _VarState] = {}
        self.races: List[RaceFinding] = []
        self._prev_trace = None
        self._prev_threading = None

    # -------------------------------------------------------- trace hooks

    def _global_trace(self, frame, event, arg):
        if event != "call":
            return None
        if frame.f_code.co_filename in self._tables:
            return self._local_trace
        return None

    def _local_trace(self, frame, event, arg):
        if event == "line":
            table = self._tables.get(frame.f_code.co_filename)
            if table:
                entries = table.get(frame.f_lineno)
                if entries:
                    obj = frame.f_locals.get("self")
                    if obj is not None:
                        fname = frame.f_code.co_filename
                        for attr, write, in_init in entries:
                            if not in_init:
                                self._access(obj, attr, write, fname,
                                             frame.f_lineno)
        return self._local_trace

    # ------------------------------------------------------ eraser machine

    def _access(self, obj, attr: str, write: bool, fname: str,
                line: int) -> None:
        thread = threading.current_thread().name
        key = (id(obj), type(obj).__name__, attr)
        held = frozenset(id(lk) for lk in shim.held_locks())
        access = Access(file=Path(fname).name, line=line, thread=thread,
                        write=write)
        st = self._state.get(key)
        if st is None:
            self._state[key] = _VarState(thread, access, held)
            return
        st.written = st.written or write
        if not st.shared:
            if thread == st.first_thread:
                st.first_access = access   # stay exclusive; refresh site
                st.first_held = held
                return
            # second thread arrives: candidate lockset = what BOTH held
            st.shared = True
            st.lockset = set(st.first_held & held)
        else:
            st.lockset &= held
        if st.written and not st.lockset and not st.reported:
            st.reported = True
            self.races.append(RaceFinding(
                cls=key[1], attr=attr, first=st.first_access,
                second=access))

    # -------------------------------------------------- happens-before lite

    def _on_join(self, joined_os_name: str) -> None:
        """A successful join transfers the joined thread's EXCLUSIVE
        state to the joiner (Eraser refinement: join is a
        happens-before edge — `x` written only by a worker and read by
        its joiner after join() is sequential, not racy). Already-shared
        state keeps its candidate lockset — a join cannot un-race it."""
        joiner = threading.current_thread().name
        for st in self._state.values():
            if not st.shared and st.first_thread == joined_os_name:
                st.first_thread = joiner

    # ----------------------------------------------------------- lifecycle

    def install(self) -> "LocksetChecker":
        self._prev_trace = sys.gettrace()
        self._prev_threading = getattr(threading, "_trace_hook", None)
        threading.settrace(self._global_trace)
        sys.settrace(self._global_trace)
        shim.add_join_hook(self._on_join)
        return self

    def uninstall(self) -> None:
        shim.remove_join_hook(self._on_join)
        sys.settrace(self._prev_trace)
        threading.settrace(self._prev_threading)

    def __enter__(self) -> "LocksetChecker":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
