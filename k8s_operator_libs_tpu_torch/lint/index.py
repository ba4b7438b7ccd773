"""ProjectIndex: parse every module ONCE, share the analysis across passes.

Passes that each re-read and re-parsed what they needed would cost
O(passes × files) parses per run. The ProjectIndex inverts that: the
driver builds one index for the run, every pass consumes it, and
``parse_counts`` lets a test pin "one parse per file per run".

What the index carries (everything lazy, cached, thread-safe):

- **contexts** — the per-file :class:`~.registry.FileContext` (path, AST,
  lines, source) keyed by repo-relative path; ``parse_counts`` records
  how often each file was actually parsed (the spy surface);
- **module map** — dotted module name ↔ relative path for everything
  under the package, so imports resolve to files;
- **import maps** — per file, the local-alias → module and
  from-import → (module, name) tables (relative imports resolved);
- **function table** — every function/method with its qualified name,
  call sites (dotted), lock-acquisition sites (``with <lock>:`` and
  ``.acquire()``), and which calls/locks happen *while a lock is held*
  (consumed by LCK004);
- **approximate call graph** — :meth:`resolve_call` maps a dotted call
  site to a function-table key through ``self.``/same-module/import
  resolution (name-based, one level — precision over recall);
- **wire-literal inventory** — every non-docstring string literal
  containing ``.dev/`` (consumed by WIRE001).

:data:`BINARY_TWINS` names the port's modules whose reference twins are
binaries or tools (``cmd/``, ``tools/``) rather than library modules:
DET001/DET002, EXC002 and ARC001 read it to scope themselves as the
reference's passes are scoped by where those twins live.

Passes accept either a repo root ``Path`` or a ready ``ProjectIndex``;
:func:`as_index` normalizes, so the fixture tests that build scratch
roots keep calling ``run_project(root)`` unchanged.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..utils import threads
from .astutil import dotted, is_lock_name
from .registry import FileContext

FunctionKey = Tuple[str, str]          # (relative path, qualname)

#: package-relative module (a directory ends in "/") -> the reference
#: file it twins. Each lives outside the reference's package, under
#: ``cmd/`` (an entry point) or ``tools/`` (developer tooling).
BINARY_TWINS: Dict[str, str] = {
    "operator.py": "cmd/operator.py",
    "router.py": "cmd/router.py",
    "server.py": "cmd/serve.py",
    "status.py": "cmd/status.py",
    "apply_crds.py": "cmd/apply_crds.py",
    "train/__main__.py": "cmd/train.py",
    "train/cli.py": "cmd/train.py",
    "chaos/__main__.py": "tools/chaos_campaign.py",
    "chaos/crash/": "tools/crash/",
    "race/": "tools/race/",
    "health/sim.py": "tools/health_sim.py",
    "cov.py": "tools/cov.py",
    "gen_state_diagram.py": "tools/gen_state_diagram.py",
    "lint/": "tools/lint/",
}


def binary_twin(path: str, package: str) -> Optional[str]:
    """The reference file ``path`` twins when it is one of
    :data:`BINARY_TWINS` under ``package`` (any spelling whose parts
    contain the package directory), else None."""
    parts = Path(path).parts
    if package not in parts:
        return None
    inner = "/".join(parts[len(parts) - parts[::-1].index(package):])
    for twin, ref in BINARY_TWINS.items():
        if inner == twin or (twin.endswith("/") and inner.startswith(twin)):
            return ref
    return None


@dataclasses.dataclass
class CallSite:
    parts: Tuple[str, ...]             # dotted call name, e.g. ("self", "g")
    lineno: int


@dataclasses.dataclass
class LockSite:
    parts: Tuple[str, ...]             # dotted receiver, e.g. ("self", "_lock")
    lineno: int
    kind: str                          # "with" | "acquire"


@dataclasses.dataclass
class FunctionRecord:
    rel: str
    qualname: str                      # "Class.method" / "func" / "f.inner"
    name: str
    class_name: Optional[str]
    node: ast.AST
    lineno: int
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    lock_sites: List[LockSite] = dataclasses.field(default_factory=list)
    # (held lock parts, call made while holding it)
    held_calls: List[Tuple[Tuple[str, ...], CallSite]] = \
        dataclasses.field(default_factory=list)
    # (held lock parts, lock acquired while holding it)
    held_locks: List[Tuple[Tuple[str, ...], LockSite]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ImportMap:
    modules: Dict[str, str]            # alias -> dotted module
    names: Dict[str, Tuple[str, str]]  # name -> (dotted module, orig name)


@dataclasses.dataclass
class WireLiteral:
    lineno: int
    value: str
    fstring: bool                      # constructed via f"{DOMAIN}/..." ?


class ProjectIndex:
    """One parse per file; derived tables built lazily under a lock."""

    def __init__(self, root: Path, files: Optional[List[Path]] = None):
        self.root = Path(root)
        self._lock = threads.make_rlock("lint-index")
        self._contexts: Dict[str, Optional[FileContext]] = {}
        self.parse_counts: Dict[str, int] = {}
        self._files_under: Dict[str, List[str]] = {}
        self._functions: Optional[Dict[FunctionKey, FunctionRecord]] = None
        self._import_maps: Dict[str, ImportMap] = {}
        self._wire: Dict[str, List[WireLiteral]] = {}
        self._module_rel: Optional[Dict[str, str]] = None
        if files is not None:
            for f in files:
                self.rel(f)  # pre-register so files() is meaningful

    # ------------------------------------------------------------ file layer

    def rel(self, path) -> str:
        """Repo-relative POSIX path (absolute paths outside the root keep
        their absolute spelling — single-file lint of arbitrary paths)."""
        p = Path(path)
        try:
            r = p.resolve().relative_to(self.root.resolve()).as_posix()
        except ValueError:
            r = p.as_posix()
        self._contexts.setdefault(r, None)
        return r

    def files(self) -> List[str]:
        return sorted(self._contexts)

    def exists(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def files_under(self, rel_dir: str) -> List[str]:
        """Every ``*.py`` under root/rel_dir (cached rglob, pycache
        skipped), as relative paths."""
        with self._lock:
            if rel_dir not in self._files_under:
                base = self.root / rel_dir
                out: List[str] = []
                if base.is_dir():
                    for p in sorted(base.rglob("*.py")):
                        if "__pycache__" not in p.parts:
                            out.append(self.rel(p))
                self._files_under[rel_dir] = out
            return self._files_under[rel_dir]

    def context(self, rel_or_path) -> FileContext:
        """The parse-once seam: every tree in the suite comes from here."""
        rel = self.rel(rel_or_path)
        with self._lock:
            ctx = self._contexts.get(rel)
            if ctx is None:
                path = (self.root / rel) if not Path(rel).is_absolute() \
                    else Path(rel)
                source = path.read_text()
                self.parse_counts[rel] = self.parse_counts.get(rel, 0) + 1
                tree = ast.parse(source, filename=rel)
                ctx = FileContext(path=rel, tree=tree,
                                  lines=source.splitlines(), source=source)
                self._contexts[rel] = ctx
            return ctx

    def tree(self, rel: str) -> ast.Module:
        return self.context(rel).tree

    def lines(self, rel: str) -> List[str]:
        return self.context(rel).lines

    # --------------------------------------------------------- module layer

    PACKAGE = "k8s_operator_libs_tpu_torch"

    def module_name(self, rel: str) -> Optional[str]:
        """``pkg/core/client.py`` → ``pkg.core.client`` (None for paths
        outside any indexed tree, e.g. absolute one-off files)."""
        p = Path(rel)
        if p.is_absolute() or p.suffix != ".py":
            return None
        parts = list(p.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) if parts else None

    def module_rel(self, dotted_mod: str) -> Optional[str]:
        """Dotted module → relative file path, for modules that exist in
        the package tree (built once from one rglob)."""
        with self._lock:
            if self._module_rel is None:
                table: Dict[str, str] = {}
                for rel in self.files_under(self.PACKAGE):
                    name = self.module_name(rel)
                    if name:
                        table[name] = rel
                self._module_rel = table
            return self._module_rel.get(dotted_mod)

    def import_map(self, rel: str) -> ImportMap:
        with self._lock:
            if rel not in self._import_maps:
                self._import_maps[rel] = self._build_import_map(rel)
            return self._import_maps[rel]

    def _build_import_map(self, rel: str) -> ImportMap:
        modules: Dict[str, str] = {}
        names: Dict[str, Tuple[str, str]] = {}
        mod = self.module_name(rel) or ""
        is_pkg = rel.endswith("__init__.py")
        for node in ast.walk(self.tree(rel)):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    modules[local] = alias.name if alias.asname \
                        else alias.name.split(".")[0]
                    if alias.asname:
                        modules[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0:
                    base = node.module or ""
                else:
                    segs = mod.split(".") if mod else []
                    drop = node.level if not is_pkg else node.level - 1
                    segs = segs[:len(segs) - drop] if drop <= len(segs) else []
                    if node.module:
                        segs = segs + node.module.split(".")
                    base = ".".join(segs)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    names[local] = (base, alias.name)
        return ImportMap(modules=modules, names=names)

    # ------------------------------------------------------- function table

    def functions(self) -> Dict[FunctionKey, FunctionRecord]:
        """(rel, qualname) → record, over the package tree (the port's
        binaries are modules of the package: it has no ``cmd/``)."""
        with self._lock:
            if self._functions is None:
                table: Dict[FunctionKey, FunctionRecord] = {}
                for tree_root in (self.PACKAGE,):
                    for rel in self.files_under(tree_root):
                        try:
                            tree = self.tree(rel)
                        except (OSError, SyntaxError):
                            continue
                        self._scan_module(rel, tree, table)
                self._functions = table
            return self._functions

    def _scan_module(self, rel: str, tree: ast.Module,
                     table: Dict[FunctionKey, FunctionRecord]) -> None:
        def scan_body(body, prefix: str, class_name: Optional[str]) -> None:
            for stmt in body:
                if isinstance(stmt, ast.ClassDef):
                    scan_body(stmt.body, f"{prefix}{stmt.name}.", stmt.name)
                elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{stmt.name}"
                    rec = FunctionRecord(rel=rel, qualname=qual,
                                         name=stmt.name,
                                         class_name=class_name,
                                         node=stmt, lineno=stmt.lineno)
                    table[(rel, qual)] = rec
                    self._scan_function(rec)
                    scan_body(stmt.body, f"{qual}.", class_name)

        scan_body(tree.body, "", None)

    @staticmethod
    def _scan_function(rec: FunctionRecord) -> None:
        """Fill call / lock-acquisition / held-while tables from the
        function body, without descending into nested scopes (they get
        their own records)."""

        def walk_node(node: ast.AST, held) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # nested scope: its own record, its own held set
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    walk_node(item.context_expr, held)
                    if item.optional_vars is not None:
                        walk_node(item.optional_vars, held)
                locks = [tuple(dotted(i.context_expr) or ())
                         for i in node.items
                         if is_lock_name(i.context_expr)]
                locks = [lk for lk in locks if lk]
                for lk in locks:
                    site = LockSite(lk, node.lineno, "with")
                    rec.lock_sites.append(site)
                    for h in held:
                        rec.held_locks.append((h, site))
                inner = held + tuple(locks)
                for stmt in node.body:
                    walk_node(stmt, inner)
                return
            if isinstance(node, ast.Call):
                parts = dotted(node.func)
                if parts:
                    site = CallSite(tuple(parts), node.lineno)
                    rec.calls.append(site)
                    for h in held:
                        rec.held_calls.append((h, site))
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "acquire" \
                        and is_lock_name(node.func.value):
                    recv = tuple(dotted(node.func.value) or ())
                    if recv:
                        site = LockSite(recv, node.lineno, "acquire")
                        rec.lock_sites.append(site)
                        for h in held:
                            rec.held_locks.append((h, site))
            for child in ast.iter_child_nodes(node):
                walk_node(child, held)

        body = rec.node.body if isinstance(rec.node.body, list) \
            else [rec.node.body]
        for stmt in body:
            walk_node(stmt, ())

    # ------------------------------------------------------ call resolution

    def resolve_call(self, caller: FunctionRecord,
                     parts: Tuple[str, ...]) -> Optional[FunctionKey]:
        """Name-based, one-hop call resolution: ``self.m()`` → same-class
        method, ``f()`` → same-module function or one from-import hop,
        ``mod.f()`` → imported module's function. Anything else → None
        (precision over recall)."""
        table = self.functions()
        if parts[0] in ("self", "cls") and caller.class_name \
                and len(parts) == 2:
            key = (caller.rel, f"{caller.class_name}.{parts[1]}")
            return key if key in table else None
        if len(parts) == 1:
            key = (caller.rel, parts[0])
            if key in table:
                return key
            imp = self.import_map(caller.rel).names.get(parts[0])
            if imp:
                target = self.module_rel(imp[0])
                if target and (target, imp[1]) in table:
                    return (target, imp[1])
            return None
        if len(parts) == 2:
            mod = self.import_map(caller.rel).modules.get(parts[0])
            if mod is None:
                imp = self.import_map(caller.rel).names.get(parts[0])
                # `from ..core import drain` then `drain.f()`
                if imp:
                    mod = f"{imp[0]}.{imp[1]}" if imp[0] else imp[1]
            if mod:
                target = self.module_rel(mod)
                if target and (target, parts[1]) in self.functions():
                    return (target, parts[1])
        return None

    # -------------------------------------------------- wire-literal layer

    WIRE_MARKER = ".dev/"

    def wire_literals(self, rel: str) -> List[WireLiteral]:
        with self._lock:
            if rel not in self._wire:
                self._wire[rel] = self._scan_wire(rel)
            return self._wire[rel]

    def _scan_wire(self, rel: str) -> List[WireLiteral]:
        tree = self.tree(rel)
        docstrings: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                body = getattr(node, "body", [])
                if body and isinstance(body[0], ast.Expr) \
                        and isinstance(body[0].value, ast.Constant) \
                        and isinstance(body[0].value.value, str):
                    docstrings.add(id(body[0].value))
        out: List[WireLiteral] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if id(node) in docstrings:
                    continue
                if self.WIRE_MARKER in node.value:
                    out.append(WireLiteral(node.lineno, node.value, False))
            elif isinstance(node, ast.JoinedStr):
                for v in node.values:
                    if isinstance(v, ast.FormattedValue):
                        parts = dotted(v.value)
                        if parts and parts[-1] == "DOMAIN":
                            out.append(WireLiteral(node.lineno,
                                                   "{DOMAIN}/…", True))
                            break
        return out


def as_index(root_or_index) -> ProjectIndex:
    """Normalize a pass argument: a ready index passes through, a repo
    root gets a fresh (lazy) one — fixture tests hand in scratch roots."""
    if isinstance(root_or_index, ProjectIndex):
        return root_or_index
    return ProjectIndex(Path(root_or_index))
