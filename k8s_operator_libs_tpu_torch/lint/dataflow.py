"""Interprocedural dataflow engine over the shared ProjectIndex.

The :class:`~.index.ProjectIndex` resolves calls one hop — enough for
LCK004's bounded chains, not enough to reason about what *escapes* a
reconcile-spine tick or where an informer-store value *ends up*. This
module upgrades that into a bounded whole-package engine, built ONCE per
run off the shared index (``get_engine`` caches on the index object, so
every pass — EXC001/EXC003/STL001 — shares the same summaries; the
parse-count spy still sees one parse per file):

- **call graph** — every function-table record's call sites resolved
  through :meth:`~.index.ProjectIndex.resolve_call` (alias-aware:
  ``self.``/same-module/from-import/module-attr), plus a
  *unique-method* fallback: an unresolved attribute call ``recv.m(...)``
  whose method name ``m`` is defined by exactly ONE class in the table
  (and is not a ubiquitous stdlib-ish name) resolves there — the CHA-lite
  step that carries the graph through ``self.managers[name].apply_state``
  style dispatch. Precision over recall everywhere else.
- **may-raise summaries** — per function, the exception TYPE NAMES that
  may escape it: explicit ``raise`` statements ∪ callee propagation
  (fixpoint over Tarjan SCCs, so recursion terminates) − types handled
  by an enclosing ``except`` (re-raising handlers subtract nothing).
  Client RPCs (a call on a receiver whose last segment contains
  ``client``) are modelled as raising :data:`RPC_RAISES`. Subclass
  relationships come from the package's own ``ClassDef`` bases plus a
  builtin table. Scope note: this tracks *declared* raises and the API
  family — incidental builtin errors (KeyError off a dict, etc.) are out
  of model.
- **unclassified lattice** — the same propagation restricted to the
  :data:`API_FAMILY` (``ApiError`` and descendants), where a broad
  ``except Exception`` / bare ``except`` does NOT subtract: only a
  handler explicitly naming a classified type (:data:`CLASSIFIED`)
  removes the family members it covers. This is EXC001's contract — a
  breaker shed swallowed by a blanket handler is *caught* at runtime but
  never *classified*, so it still escapes this lattice.
- **taint summaries** — per function: informer-store reads (a
  :data:`READ_METHODS` call on a ``*client*`` receiver), declared
  freshness barriers (:data:`BARRIER_METHODS` calls, line-ordered),
  which params/returns carry store-origin values, and every flow of a
  store-origin value into a safety-write argument
  (:data:`SAFETY_WRITES` — the crash registry's patch choke points),
  local or through callee param summaries. STL001 walks these from the
  spine roots carrying barrier state.

Every summary is a witness-carrying map so the passes can print full
propagation chains, not just verdicts.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .astutil import dotted
from .index import FunctionKey, FunctionRecord, ProjectIndex

# ---------------------------------------------------------------- config

#: the classified API-error family root + members (core/client.py /
#: core/resilience.py); EXC001 fires when FIRE_SET members escape a
#: spine root through nothing but broad handlers.
API_FAMILY = ("ApiError", "ServerError", "BreakerOpenError",
              "TooManyRequestsError", "ConflictError", "NotFoundError",
              "InvalidError")
#: naming one of these in an except clause is a *classified* catch
CLASSIFIED = ("ApiError", "ServerError", "BreakerOpenError",
              "TooManyRequestsError", "ConflictError", "NotFoundError",
              "InvalidError")
#: what a client RPC is modelled to raise (ServerError covers the
#: breaker shed — BreakerOpenError is its subclass)
RPC_RAISES = ("ServerError",)

#: the informer-store read surface (receiver tail must contain "client")
READ_METHODS = frozenset({
    "get_node", "list_nodes", "get_pod", "list_pods", "list_daemonsets",
    "list_controller_revisions", "get_job",
})
#: declared freshness barriers (tick-start pump / post-recovery resync)
BARRIER_METHODS = frozenset({"pump", "resync"})
#: the durable safety-write choke points (chaos/crash/registry.py sites
#: all route through these three patch methods)
SAFETY_WRITES = frozenset({
    "patch_node_metadata", "patch_node_unschedulable", "patch_node_taints",
})
#: client methods that are not RPCs (local cache/bookkeeping surface)
NON_RPC_METHODS = frozenset({
    "direct", "pump", "resync", "drain_deltas", "start", "stop",
    "set_event_hook", "wait_synced", "safety",
})

#: unique-method fallback never resolves these — ubiquitous names that
#: appear constantly on stdlib/foreign receivers
UNIQUE_METHOD_DENY = frozenset({
    "get", "set", "add", "append", "extend", "insert", "pop", "clear",
    "update", "copy", "keys", "values", "items", "sort", "sorted",
    "join", "split", "strip", "read", "write", "close", "open", "flush",
    "start", "stop", "run", "send", "recv", "put", "result", "submit",
    "acquire", "release", "wait", "notify", "now", "sleep", "wall",
    "info", "debug", "warning", "error", "exception", "log", "format",
    "encode", "decode", "group", "match", "search", "lower", "upper",
    "startswith", "endswith", "setdefault", "discard", "remove", "index",
    "count", "name", "is_set",
})

#: builtin exception hierarchy (child -> parents) for subclass checks
BUILTIN_BASES: Dict[str, Tuple[str, ...]] = {
    "Exception": ("BaseException",),
    "ArithmeticError": ("Exception",),
    "ZeroDivisionError": ("ArithmeticError",),
    "OverflowError": ("ArithmeticError",),
    "LookupError": ("Exception",),
    "KeyError": ("LookupError",),
    "IndexError": ("LookupError",),
    "ValueError": ("Exception",),
    "UnicodeDecodeError": ("ValueError",),
    "TypeError": ("Exception",),
    "RuntimeError": ("Exception",),
    "NotImplementedError": ("RuntimeError",),
    "RecursionError": ("RuntimeError",),
    "OSError": ("Exception",),
    "IOError": ("OSError",),
    "FileNotFoundError": ("OSError",),
    "PermissionError": ("OSError",),
    "TimeoutError": ("OSError",),
    "ConnectionError": ("OSError",),
    "BrokenPipeError": ("ConnectionError",),
    "ConnectionResetError": ("ConnectionError",),
    "ConnectionRefusedError": ("ConnectionError",),
    "StopIteration": ("Exception",),
    "AttributeError": ("Exception",),
    "NameError": ("Exception",),
    "UnboundLocalError": ("NameError",),
    "ImportError": ("Exception",),
    "ModuleNotFoundError": ("ImportError",),
    "AssertionError": ("Exception",),
    "ReferenceError": ("Exception",),
    "MemoryError": ("Exception",),
    "BufferError": ("Exception",),
    "EOFError": ("Exception",),
    "SystemError": ("Exception",),
    "KeyboardInterrupt": ("BaseException",),
    "SystemExit": ("BaseException",),
    "GeneratorExit": ("BaseException",),
}

# ----------------------------------------------------------- summaries

#: how an exception got into a summary: ("raise", rel, lineno) for an
#: explicit raise, ("rpc", rel, lineno, call) for a modelled client RPC,
#: ("reraise", rel, lineno) for a re-raising handler, or
#: ("call", callee_key, lineno) — follow the callee's witness to chain.
Witness = Tuple


@dataclasses.dataclass
class TaintFlow:
    """One store-origin value reaching a safety-write argument."""
    source: Tuple                      # ("read", lineno) | ("param", idx)
    write_rel: str
    write_line: int
    write_method: str
    via: Tuple[str, ...]               # qualname chain from here to the write


@dataclasses.dataclass
class FunctionSummary:
    key: FunctionKey
    raises: Dict[str, Witness] = dataclasses.field(default_factory=dict)
    unclassified: Dict[str, Witness] = dataclasses.field(default_factory=dict)
    # taint half
    reads: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    barriers: List[int] = dataclasses.field(default_factory=list)
    returns_store: bool = False
    param_to_return: Set[int] = dataclasses.field(default_factory=set)
    # param idx -> first (write_rel, write_line, method, via chain)
    param_to_write: Dict[int, Tuple[str, int, str, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=dict)
    flows: List[TaintFlow] = dataclasses.field(default_factory=list)


class DataflowEngine:
    """Call graph + may-raise + taint summaries, one instance per run."""

    builds = 0  # class-level construction counter (cache-hit test spy)

    def __init__(self, index: ProjectIndex):
        DataflowEngine.builds += 1
        self.index = index
        self.table = index.functions()
        self.class_bases = self._collect_class_bases()
        self._unique_methods = self._collect_unique_methods()
        # resolved edges: caller key -> [(callee key, call lineno)]
        self.edges: Dict[FunctionKey, List[Tuple[FunctionKey, int]]] = {}
        for key, rec in self.table.items():
            out: List[Tuple[FunctionKey, int]] = []
            seen: Set[FunctionKey] = set()
            for call in rec.calls:
                callee = self.resolve(rec, call.parts)
                if callee is not None and callee != key \
                        and callee not in seen:
                    seen.add(callee)
                    out.append((callee, call.lineno))
            self.edges[key] = out
        self.sccs = self._tarjan()          # reverse-topological order
        self.summaries: Dict[FunctionKey, FunctionSummary] = {
            key: FunctionSummary(key=key) for key in self.table}
        self._fixpoint()

    # ------------------------------------------------------------ graph

    def _collect_class_bases(self) -> Dict[str, Tuple[str, ...]]:
        """Class name -> base-class last-segment names, over every
        indexed package module (exception taxonomy + subclassing)."""
        bases: Dict[str, Tuple[str, ...]] = dict(BUILTIN_BASES)
        for tree_root in (self.index.PACKAGE,):
            for rel in self.index.files_under(tree_root):
                try:
                    tree = self.index.tree(rel)
                except (OSError, SyntaxError):
                    continue
                for node in ast.walk(tree):
                    if not isinstance(node, ast.ClassDef):
                        continue
                    names = []
                    for b in node.bases:
                        parts = dotted(b)
                        if parts:
                            names.append(parts[-1])
                    if names and node.name not in BUILTIN_BASES:
                        bases.setdefault(node.name, tuple(names))
        return bases

    def is_subclass(self, name: str, targets: Set[str]) -> bool:
        seen: Set[str] = set()
        frontier = [name]
        while frontier:
            n = frontier.pop()
            if n in targets:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self.class_bases.get(n, ()))
        return False

    def _collect_unique_methods(self) -> Dict[str, FunctionKey]:
        counts: Dict[str, List[FunctionKey]] = {}
        for key, rec in self.table.items():
            if rec.class_name and "." not in rec.qualname.replace(
                    f"{rec.class_name}.", "", 1):
                counts.setdefault(rec.name, []).append(key)
        return {name: keys[0] for name, keys in counts.items()
                if len(keys) == 1 and name not in UNIQUE_METHOD_DENY
                and not name.startswith("__")}

    def resolve(self, rec: FunctionRecord,
                parts: Tuple[str, ...]) -> Optional[FunctionKey]:
        """index.resolve_call plus the unique-method fallback."""
        key = self.index.resolve_call(rec, parts)
        if key is not None:
            return key
        if len(parts) >= 2:
            return self._unique_methods.get(parts[-1])
        return None

    def _tarjan(self) -> List[List[FunctionKey]]:
        """Iterative Tarjan SCC; returned list is reverse-topological
        (callees before callers), the fixpoint processing order."""
        index_of: Dict[FunctionKey, int] = {}
        low: Dict[FunctionKey, int] = {}
        on_stack: Set[FunctionKey] = set()
        stack: List[FunctionKey] = []
        sccs: List[List[FunctionKey]] = []
        counter = [0]

        for start in self.table:
            if start in index_of:
                continue
            work: List[Tuple[FunctionKey, int]] = [(start, 0)]
            while work:
                node, ei = work[-1]
                if ei == 0:
                    index_of[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                out = self.edges.get(node, [])
                advanced = False
                while ei < len(out):
                    nxt = out[ei][0]
                    ei += 1
                    if nxt not in self.table:
                        continue
                    if nxt not in index_of:
                        work[-1] = (node, ei)
                        work.append((nxt, 0))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index_of[nxt])
                if advanced:
                    continue
                work.pop()
                if low[node] == index_of[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return sccs

    # --------------------------------------------------------- fixpoint

    #: per-SCC iteration ceiling — the lattice heights are tiny (a few
    #: dozen exception names, param counts), so real fixpoints land in
    #: 2-3 rounds; the cap is a termination backstop, never a limit hit
    MAX_SCC_ROUNDS = 50

    def _fixpoint(self) -> None:
        for scc in self.sccs:
            for _ in range(self.MAX_SCC_ROUNDS):
                changed = False
                for key in scc:
                    if self._summarize(key):
                        changed = True
                if len(scc) == 1 or not changed:
                    break  # acyclic: one pass is complete

    def _summarize(self, key: FunctionKey) -> bool:
        rec = self.table[key]
        old = self.summaries[key]
        new = _FunctionAnalysis(self, rec).run()
        changed = (set(new.raises) != set(old.raises)
                   or set(new.unclassified) != set(old.unclassified)
                   or new.returns_store != old.returns_store
                   or new.param_to_return != old.param_to_return
                   or set(new.param_to_write) != set(old.param_to_write)
                   or len(new.flows) != len(old.flows))
        self.summaries[key] = new
        return changed

    # ------------------------------------------------- chain rendering

    def chain(self, key: FunctionKey, exc: str,
              lattice: str = "unclassified", limit: int = 12) -> str:
        """Render the witness chain for ``exc`` escaping ``key``:
        ``A -> B -> C raises ServerError (rel:line)``."""
        hops: List[str] = []
        seen: Set[FunctionKey] = set()
        cur = key
        while cur is not None and cur not in seen and len(hops) < limit:
            seen.add(cur)
            rec = self.table[cur]
            hops.append(rec.qualname)
            summ = self.summaries[cur]
            wit = (summ.unclassified if lattice == "unclassified"
                   else summ.raises).get(exc)
            if wit is None:
                break
            if wit[0] == "call":
                cur = wit[1]
                continue
            if wit[0] == "rpc":
                return (f"{' -> '.join(hops)} -> client RPC {wit[3]}() "
                        f"({wit[1]}:{wit[2]}) raises {exc}")
            return (f"{' -> '.join(hops)} raises {exc} "
                    f"({wit[1]}:{wit[2]})")
        return f"{' -> '.join(hops)} ... raises {exc}"


class _FunctionAnalysis:
    """One function's escape + taint summary off current callee state."""

    def __init__(self, engine: DataflowEngine, rec: FunctionRecord):
        self.engine = engine
        self.rec = rec
        self.summary = FunctionSummary(key=(rec.rel, rec.qualname))
        args = rec.node.args
        self.params: List[str] = [a.arg for a in
                                  (args.posonlyargs + args.args)]
        # name -> set of taint sources ({("read", line) | ("param", i)})
        self.name_sources: Dict[str, Set[Tuple]] = {}
        for i, p in enumerate(self.params):
            if i == 0 and rec.class_name and p in ("self", "cls"):
                continue  # the receiver is not a data param
            self.name_sources[p] = {("param", i)}
        self.return_sources: Set[Tuple] = set()
        # local names aliasing the *cached* client (``view = self._client``;
        # a Call value — ``self._client.direct()`` — is NOT an alias: the
        # direct view is uncached, so its reads are never stale)
        self.client_names: Set[str] = set()
        self._collect_client_aliases()

    def _collect_client_aliases(self) -> None:
        body = self.rec.node.body if isinstance(self.rec.node.body, list) \
            else [self.rec.node.body]
        for _ in range(2):  # alias-of-alias
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    if not isinstance(node, ast.Assign):
                        continue
                    parts = dotted(node.value)
                    if not parts:
                        continue
                    if any("client" in seg.lower() for seg in parts) \
                            or parts[0] in self.client_names:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.client_names.add(t.id)

    def _client_receiver(self, parts: Tuple[str, ...]) -> bool:
        """Is ``parts[:-1]`` the cached client (by name or local alias)?"""
        if len(parts) < 2:
            return False
        return ("client" in parts[-2].lower()
                or parts[0] in self.client_names)

    # ------------------------------------------------------------- run

    def run(self) -> FunctionSummary:
        body = self.rec.node.body if isinstance(self.rec.node.body, list) \
            else [self.rec.node.body]
        # taint propagation is flow-insensitive: iterate assignments to a
        # small fixpoint, then scan sinks once
        self._collect_reads_and_barriers(body)
        for _ in range(3):
            before = {n: set(s) for n, s in self.name_sources.items()}
            for stmt in body:
                self._taint_stmt(stmt)
            if before == self.name_sources:
                break
        for stmt in body:
            self._scan_sinks(stmt)
        escapes, unclassified = self._escape_stmts(body)
        self.summary.raises = escapes
        self.summary.unclassified = unclassified
        if self.return_sources:
            for src in self.return_sources:
                if src[0] == "read":
                    self.summary.returns_store = True
                elif src[0] == "param":
                    self.summary.param_to_return.add(src[1])
        return self.summary

    # --------------------------------------------------- escape lattice

    def _handler_types(self, handler: ast.ExceptHandler) -> List[str]:
        if handler.type is None:
            return ["BaseException"]
        nodes = handler.type.elts if isinstance(handler.type, ast.Tuple) \
            else [handler.type]
        out = []
        for n in nodes:
            parts = dotted(n)
            if parts:
                out.append(parts[-1])
        return out

    def _reraises(self, handler: ast.ExceptHandler) -> bool:
        bound = handler.name
        for node in ast.walk(handler):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Raise):
                if node.exc is None:
                    return True
                if isinstance(node.exc, ast.Name) and node.exc.id == bound:
                    return True
        return False

    def _escape_stmts(self, stmts, caught: Optional[Set[str]] = None,
                      bound: Optional[str] = None) -> Tuple[Dict, Dict]:
        """(raises, unclassified) escaping this statement list.

        ``caught``/``bound`` carry the enclosing except-handler context
        (its type names + ``as`` name) so ``raise`` / ``raise e`` inside
        a handler re-escapes the caught types."""
        raises: Dict[str, Witness] = {}
        unclassified: Dict[str, Witness] = {}

        def merge(dst, name, wit):
            dst.setdefault(name, wit)

        def absorb(pair):
            r, u = pair
            for n, w in r.items():
                merge(raises, n, w)
            for n, w in u.items():
                merge(unclassified, n, w)

        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Try):
                body_r, body_u = self._escape_stmts(stmt.body, caught, bound)
                for handler in stmt.handlers:
                    types = set(self._handler_types(handler))
                    if not self._reraises(handler):
                        body_r = {n: w for n, w in body_r.items()
                                  if not self.engine.is_subclass(n, types)}
                        # the unclassified lattice: only a handler that
                        # explicitly names a classified type subtracts
                        # family members — a broad catch is a runtime
                        # catch, never a classification
                        explicit = {t for t in types if t in CLASSIFIED}
                        if explicit:
                            body_u = {n: w for n, w in body_u.items()
                                      if not self.engine.is_subclass(
                                          n, explicit)}
                    absorb(self._escape_stmts(handler.body, caught=types,
                                              bound=handler.name))
                for n, w in body_r.items():
                    merge(raises, n, w)
                for n, w in body_u.items():
                    merge(unclassified, n, w)
                # else/finally clauses are NOT covered by the handlers
                absorb(self._escape_stmts(stmt.orelse, caught, bound))
                absorb(self._escape_stmts(stmt.finalbody, caught, bound))
                continue
            if isinstance(stmt, ast.Raise):
                self._raise_escape(stmt, caught, bound,
                                   raises, unclassified, merge)
            for node in self._expr_nodes(stmt):
                if isinstance(node, ast.Call):
                    parts = dotted(node.func)
                    if parts:
                        self._call_escapes(tuple(parts), node.lineno,
                                           raises, unclassified, merge)
            for sub in self._stmt_sublists(stmt):
                absorb(self._escape_stmts(sub, caught, bound))
        return raises, unclassified

    def _raise_escape(self, node: ast.Raise, caught, bound,
                      raises, unclassified, merge) -> None:
        if node.exc is None or (bound and isinstance(node.exc, ast.Name)
                                and node.exc.id == bound):
            wit = ("reraise", self.rec.rel, node.lineno)
            for n in (caught or ()):
                merge(raises, n, wit)
                if self.engine.is_subclass(n, set(API_FAMILY)):
                    merge(unclassified, n, wit)
            return
        name = self._raised_name(node.exc)
        if name is None:
            return
        wit = ("raise", self.rec.rel, node.lineno)
        merge(raises, name, wit)
        if self.engine.is_subclass(name, set(API_FAMILY)):
            merge(unclassified, name, wit)

    @staticmethod
    def _expr_nodes(stmt):
        """Expression nodes of ONE statement: skips nested statement
        lists (recursed separately by _escape_stmts) and never enters
        lambda/def/class bodies."""
        work: List[ast.AST] = []
        for _field, value in ast.iter_fields(stmt):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    continue
                work.extend(v for v in value if isinstance(v, ast.AST))
            elif isinstance(value, ast.AST):
                work.append(value)
        while work:
            node = work.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)) \
                    or isinstance(node, ast.stmt):
                continue
            yield node
            work.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _stmt_sublists(stmt):
        """Statement lists nested directly inside ``stmt`` (If/For/While/
        With bodies and orelse) — Try is handled before this is called."""
        for _field, value in ast.iter_fields(stmt):
            if isinstance(value, list) and value \
                    and isinstance(value[0], ast.stmt):
                yield value

    def _raised_name(self, exc: ast.AST) -> Optional[str]:
        node = exc
        if isinstance(node, ast.Call):
            node = node.func
        parts = dotted(node)
        return parts[-1] if parts else None

    def _call_escapes(self, parts, lineno, raises, unclassified,
                      merge) -> None:
        callee = self.engine.resolve(self.rec, parts)
        if callee is not None:
            csum = self.engine.summaries.get(callee)
            if csum is not None:
                for n in csum.raises:
                    merge(raises, n, ("call", callee, lineno))
                for n in csum.unclassified:
                    merge(unclassified, n, ("call", callee, lineno))
            return
        if self._is_rpc(parts):
            for n in RPC_RAISES:
                wit = ("rpc", self.rec.rel, lineno, ".".join(parts))
                merge(raises, n, wit)
                merge(unclassified, n, wit)

    def _is_rpc(self, parts: Tuple[str, ...]) -> bool:
        return (self._client_receiver(parts)
                and parts[-1] not in NON_RPC_METHODS)

    # ------------------------------------------------------------ taint

    def _collect_reads_and_barriers(self, body) -> None:
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    continue
                if not isinstance(node, ast.Call):
                    continue
                parts = dotted(node.func)
                if not parts:
                    continue
                if parts[-1] in BARRIER_METHODS:
                    self.summary.barriers.append(node.lineno)
                elif self._is_store_read(tuple(parts)):
                    self.summary.reads.append((node.lineno, parts[-1]))

    def _is_store_read(self, parts: Tuple[str, ...]) -> bool:
        return (parts[-1] in READ_METHODS
                and self._client_receiver(parts))

    def _expr_sources(self, expr) -> Set[Tuple]:
        out: Set[Tuple] = set()
        if expr is None:
            return out
        if isinstance(expr, ast.Name):
            return set(self.name_sources.get(expr.id, ()))
        if isinstance(expr, ast.Lambda):
            return out
        if isinstance(expr, ast.Call):
            parts = dotted(expr.func)
            arg_exprs = list(expr.args) + [k.value for k in expr.keywords]
            if parts:
                tparts = tuple(parts)
                if self._is_store_read(tparts):
                    out.add(("read", expr.lineno))
                    return out
                callee = self.engine.resolve(self.rec, tparts)
                if callee is not None:
                    csum = self.engine.summaries.get(callee)
                    if csum is not None:
                        if csum.returns_store:
                            out.add(("read", expr.lineno))
                        off = self._arg_offset(expr, callee)
                        for i, a in enumerate(expr.args):
                            if i + off in csum.param_to_return:
                                out |= self._expr_sources(a)
                        # receiver taint passes through method calls
                        # (a .copy()/.get() on a tainted object)
                        if isinstance(expr.func, ast.Attribute):
                            out |= self._expr_sources(expr.func.value)
                        return out
            # unresolved call: conservative pass-through of every arg +
            # receiver (sorted(nodes), str(name), node.get(...) …)
            for a in arg_exprs:
                out |= self._expr_sources(a)
            if isinstance(expr.func, ast.Attribute):
                out |= self._expr_sources(expr.func.value)
            return out
        for child in ast.iter_child_nodes(expr):
            out |= self._expr_sources(child)
        return out

    def _bind(self, target, sources: Set[Tuple]) -> None:
        if isinstance(target, ast.Name):
            self.name_sources.setdefault(target.id, set()).update(sources)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, sources)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, sources)

    def _taint_stmt(self, stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            srcs = self._expr_sources(stmt.value)
            if srcs:
                for t in stmt.targets:
                    self._bind(t, srcs)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            srcs = self._expr_sources(stmt.value)
            if srcs:
                self._bind(stmt.target, srcs)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            srcs = self._expr_sources(stmt.iter)
            if srcs:
                self._bind(stmt.target, srcs)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    srcs = self._expr_sources(item.context_expr)
                    if srcs:
                        self._bind(item.optional_vars, srcs)
        elif isinstance(stmt, ast.Return):
            self.return_sources |= self._expr_sources(stmt.value)
        for child in self._stmt_children(stmt):
            self._taint_stmt(child)

    @staticmethod
    def _stmt_children(stmt):
        for field in ("body", "orelse", "finalbody"):
            for child in getattr(stmt, field, []) or []:
                yield child
        for handler in getattr(stmt, "handlers", []) or []:
            for child in handler.body:
                yield child

    def _scan_sinks(self, stmt) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if not isinstance(node, ast.Call):
                continue
            parts = dotted(node.func)
            if not parts:
                continue
            arg_exprs = list(node.args) + [k.value for k in node.keywords]
            if parts[-1] in SAFETY_WRITES:
                for a in arg_exprs:
                    for src in self._expr_sources(a):
                        self._record_flow(src, self.rec.rel, node.lineno,
                                          parts[-1], (self.rec.qualname,))
                continue
            callee = self.engine.resolve(self.rec, tuple(parts))
            if callee is None:
                continue
            csum = self.engine.summaries.get(callee)
            if csum is None or not csum.param_to_write:
                continue
            off = self._arg_offset(node, callee)
            for i, a in enumerate(node.args):
                if i + off in csum.param_to_write:
                    wrel, wline, method, via = csum.param_to_write[i + off]
                    for src in self._expr_sources(a):
                        self._record_flow(
                            src, wrel, wline, method,
                            (self.rec.qualname,) + via)

    def _arg_offset(self, call: ast.Call, callee: FunctionKey) -> int:
        """Positional-arg → callee-param index shift: a bound method call
        (``obj.m(a)``) fills the callee's ``self`` slot implicitly."""
        crec = self.engine.table.get(callee)
        if crec is not None and crec.class_name \
                and isinstance(call.func, ast.Attribute):
            return 1
        return 0

    def _record_flow(self, src, write_rel, write_line, method, via) -> None:
        if src[0] == "param":
            self.summary.param_to_write.setdefault(
                src[1], (write_rel, write_line, method, via))
        self.summary.flows.append(TaintFlow(
            source=src, write_rel=write_rel, write_line=write_line,
            write_method=method, via=via))


# -------------------------------------------------------------- caching

def get_engine(index: ProjectIndex) -> DataflowEngine:
    """The once-per-run seam: every pass shares one engine per index
    (summaries computed once; ``DataflowEngine.builds`` is the spy)."""
    with index._lock:
        engine = getattr(index, "_dataflow_engine", None)
        if engine is None:
            engine = DataflowEngine(index)
            index._dataflow_engine = engine
        return engine
