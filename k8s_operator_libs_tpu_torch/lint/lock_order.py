"""LCK004: cross-function lock-order analysis over the ProjectIndex.

LCK001–LCK003 are file-local. The failure modes that survive them are
*compositional*: thread 1 takes lock A then calls a helper that takes
lock B, thread 2 takes B then (through another path) A — a deadlock no
single function exhibits; or a function that looks innocent under its
lock but calls into a helper that sleeps, spawns a compiler or does a
client RPC, holding the lock across the wait.

The pass consumes the shared :class:`~.index.ProjectIndex` function
table (call sites + lock-acquisition sites + held-while information)
and fires on:

- **lock-order cycles**: build the lock-order graph — an edge A → B
  whenever B is acquired while A is held, directly or through up to
  ``MAX_DEPTH`` resolved call hops — and report every cycle (the
  classic ABBA deadlock shape);
- **blocking calls under a lock, transitively**: a ``time.sleep`` /
  ``subprocess.*`` / ``urlopen`` / ``requests.*`` / client-RPC
  (``*client.method(...)``) call reached through a resolved call chain
  while a lock is held. The *direct* case (the blocking call textually
  inside the ``with`` body) is LCK002's — this code reports only the
  chains LCK002 cannot see.

Lock identity is name-resolved conservatively: ``self.X`` → the
enclosing class's attribute (module-qualified), bare names → the
module's global; receivers the index cannot attribute (``other._lock``)
never create edges — precision over recall, like the call resolution
itself (:meth:`~.index.ProjectIndex.resolve_call`).
"""

from __future__ import annotations

from pathlib import PurePath
from typing import Dict, List, Optional, Set, Tuple

from .index import CallSite, FunctionRecord, ProjectIndex, as_index
from .registry import Check, register

CODES = {
    "LCK004": "cross-function lock-order cycle (potential deadlock) or a "
              "blocking call reached while a lock is held",
}

Finding = Tuple[str, int, str, str]
LockId = str

MAX_DEPTH = 4


def _blocking_name(parts: Tuple[str, ...]) -> Optional[str]:
    """Blocking-call classifier for the transitive facet."""
    name = ".".join(parts)
    if parts == ("time", "sleep"):
        return name
    if parts[0] in ("subprocess", "requests"):
        return name
    if parts[-1] == "urlopen":
        return name
    if len(parts) >= 2 and parts[-1] != "sleep" \
            and "client" in parts[-2].lower():
        return name  # an RPC on a client receiver
    if len(parts) >= 2 and parts[-1] == "sleep" \
            and "clock" in parts[-2].lower():
        return name  # clock.sleep blocks for real under a RealClock
    return None


def _lock_id(rec: FunctionRecord, parts: Tuple[str, ...]) -> Optional[LockId]:
    """Resolve a lock receiver to a stable cross-function identity."""
    stem = PurePath(rec.rel).with_suffix("").name
    if parts[0] in ("self", "cls") and rec.class_name and len(parts) == 2:
        return f"{stem}.{rec.class_name}.{parts[1]}"
    if len(parts) == 1:
        return f"{stem}.{parts[0]}"
    return None  # foreign receiver: unattributable, never an edge


class _Analysis:
    def __init__(self, index: ProjectIndex):
        self.index = index
        self.table = index.functions()
        # lock-order edges: (A, B) -> (rel, lineno, description of the path)
        self.edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}
        self.findings: List[Finding] = []

    # ------------------------------------------------------------- walking

    def run(self) -> List[Finding]:
        for rec in self.table.values():
            self._direct_edges(rec)
            self._transitive(rec)
        self._report_cycles()
        return sorted(set(self.findings))

    def _direct_edges(self, rec: FunctionRecord) -> None:
        for held_parts, inner in rec.held_locks:
            a = _lock_id(rec, held_parts)
            b = _lock_id(rec, inner.parts)
            if a and b and a != b:
                self.edges.setdefault(
                    (a, b), (rec.rel, inner.lineno,
                             f"in {rec.qualname}"))

    def _transitive(self, rec: FunctionRecord) -> None:
        for held_parts, call in rec.held_calls:
            held = _lock_id(rec, held_parts)
            if held is None:
                continue
            callee = self.index.resolve_call(rec, call.parts)
            if callee is None:
                continue
            self._dfs(rec, held, call, callee,
                      chain=[rec.qualname], visited={(rec.rel,
                                                      rec.qualname)})

    def _dfs(self, origin: FunctionRecord, held: LockId, site: CallSite,
             key, chain: List[str], visited: Set, depth: int = 1) -> None:
        if depth > MAX_DEPTH or key in visited:
            return
        visited = visited | {key}
        rec = self.table[key]
        chain = chain + [rec.qualname]
        for call in rec.calls:
            blocking = _blocking_name(call.parts)
            if blocking:
                self.findings.append(
                    (origin.rel, site.lineno, "LCK004",
                     f"{held} is held across a blocking call: "
                     f"{' -> '.join(chain)} reaches {blocking}() "
                     f"({rec.rel}:{call.lineno}) — every other thread "
                     f"queues behind the wait"))
        for lock_site in rec.lock_sites:
            inner = _lock_id(rec, lock_site.parts)
            if inner and inner != held:
                self.edges.setdefault(
                    (held, inner),
                    (origin.rel, site.lineno,
                     f"via {' -> '.join(chain)}"))
        for call in rec.calls:
            nxt = self.index.resolve_call(rec, call.parts)
            if nxt is not None:
                self._dfs(origin, held, site, nxt, chain, visited,
                          depth + 1)

    # ------------------------------------------------------------- cycles

    def _report_cycles(self) -> None:
        graph: Dict[LockId, Set[LockId]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        stack: List[LockId] = []
        seen_cycles: Set[Tuple[LockId, ...]] = set()

        def canon(cycle: List[LockId]) -> Tuple[LockId, ...]:
            # rotate so the lexicographically smallest node leads — one
            # report per cycle regardless of where the DFS entered it
            i = cycle.index(min(cycle))
            return tuple(cycle[i:] + cycle[:i])

        def visit(n: LockId) -> None:
            color[n] = GREY
            stack.append(n)
            for nxt in sorted(graph[n]):
                if color[nxt] == GREY:
                    cycle = stack[stack.index(nxt):]
                    key = canon(cycle)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        rel, lineno, how = self.edges[(n, nxt)]
                        order = " -> ".join(list(key) + [key[0]])
                        self.findings.append(
                            (rel, lineno, "LCK004",
                             f"lock-order cycle {order} ({how}) — two "
                             f"threads taking these in opposite order "
                             f"deadlock"))
                elif color[nxt] == WHITE:
                    visit(nxt)
            stack.pop()
            color[n] = BLACK

        for n in sorted(graph):
            if color[n] == WHITE:
                visit(n)


def run_project(root) -> List[Finding]:
    return _Analysis(as_index(root)).run()


register(Check(name="lock-order", codes=CODES, scope="project",
               run=run_project, domain=True))
