"""The generic (pyflakes-class) pass of the lint suite, stdlib-only.

The same checker as the JAX package's ``tools/lint/core.py``, with the same
codes and messages, kept as the port's own copy. It is a from-scratch
`ast`-based checker over the highest-value subset of what golangci-lint
gives a Go project, with no third-party linter needed:

  F821  undefined name (scope-aware: modules, classes, functions,
        comprehensions, global/nonlocal, builtins)
  F401  unused import (module scope; `as _`, __init__ re-exports and
        __all__ entries exempt)
  F811  redefinition without use: an import shadowed by another import, or
        a module/class-level def/class redefining an earlier def/class/
        import of the same name (decorated defs — @property/@overload
        pairs — and conditional/try-fallback definitions exempt)
  F841  local variable assigned but never used (function scopes; simple
        `name = ...` targets only — tuple unpacking, loop variables,
        `with ... as`, except-handler names and `_`-prefixed names exempt;
        closure reads from nested scopes count as uses)
  B006  mutable default argument (list/dict/set literal)
  E722  bare `except:`
  F541  f-string without any placeholders
  F601  `== None` / `!= None` comparison (use `is`)
  E712  `== True` / `!= False` comparison (use the value or `is`)
  F632  `is` / `is not` comparison against a str/number/tuple literal
  F631  assert on a non-empty tuple literal (always true)
  F602  duplicate literal key in a dict display
  W605  invalid escape sequence in a plain (non-raw) string literal
  W0101 unreachable code: a statement directly following return / raise /
        break / continue in the same block
  A001  name binding shadows a Python builtin (module/function scopes;
        class attributes exempt — they live behind `self.`/`cls.`)
  A002  function argument shadows a Python builtin

The domain-aware passes (LCK/THR/GRD/SYN) live in sibling modules; the CLI
driver is the package's ``__init__``. A finding can be suppressed by appending
`# lint: ignore` (or `# noqa`) to its line.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Set, Tuple

from .registry import Check, FileContext, register

BUILTINS = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__path__", "__class__",
}


class Scope:
    def __init__(self, kind: str, node: Optional[ast.AST],
                 parent: Optional["Scope"]):
        self.kind = kind          # module | function | class | comprehension
        self.node = node
        self.parent = parent
        self.bindings: Set[str] = set()
        self.globals: Set[str] = set()
        self.nonlocals: Set[str] = set()
        self.has_star_import = False
        self.uses_exec = False
        # F841 bookkeeping (function scopes): first plain-assignment
        # position per name, and every name a load resolved to here —
        # including loads from scopes nested inside this one (closures)
        self.assign_pos: Dict[str, int] = {}
        self.loaded: Set[str] = set()

    def chain_has_star_or_exec(self) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if s.has_star_import or s.uses_exec:
                return True
            s = s.parent
        return False


class Checker(ast.NodeVisitor):
    """Two passes per scope: bind every name the scope defines, then resolve
    loads against the lexical chain (class scopes are skipped for lookups
    from nested functions, like Python itself does)."""

    def __init__(self, path: str, tree: ast.Module, source_lines: List[str]):
        self.path = path
        self.lines = source_lines
        self.findings: List[Tuple[int, str, str]] = []
        self.module_scope = Scope("module", tree, None)
        self.import_positions: Dict[str, Tuple[int, str]] = {}
        self.import_uses: Set[str] = set()
        # every module-scope import event, for F811 (resolved after the
        # walk, when use positions are known)
        self.import_events: List[Tuple[int, str, str, bool]] = []
        self.name_use_lines: Dict[str, List[int]] = {}
        # every Name load in the file, for the F811 redefinition check
        self.all_use_lines: Dict[str, List[int]] = {}
        self._redef_checks: List[List[Tuple[int, str, bool, bool]]] = []
        self.redefined_imports: Set[str] = set()
        self.is_init = path.endswith("__init__.py")
        self.dunder_all: Set[str] = set()

    # ---------------------------------------------------------- reporting

    def report(self, lineno: int, code: str, msg: str) -> None:
        if 0 < lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            if "# lint: ignore" in line or "# noqa" in line:
                return
        self.findings.append((lineno, code, msg))

    # ----------------------------------------------------------- binding

    @staticmethod
    def _target_names(target: ast.AST) -> List[str]:
        out = []
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and isinstance(
                    n.ctx, (ast.Store, ast.Del)):
                out.append(n.id)
        return out

    def bind_scope(self, scope: Scope, body: List[ast.stmt]) -> None:
        """Collect names bound anywhere in this scope (not nested scopes)."""
        for stmt in body:
            self._bind_stmt(scope, stmt)

    def _bind_stmt(self, scope: Scope, node: ast.AST,
                   in_try: bool = False) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            scope.bindings.add(node.name)
            self._check_builtin_shadow(scope, node.name, node.lineno,
                                       what="definition of")
            return  # nested scope bodies handled separately
        if isinstance(node, (ast.Lambda,)):
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            return
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                self._bind_import(scope, name, node.lineno,
                                  alias.asname or alias.name,
                                  in_try=in_try)
            return
        if isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                for alias in node.names:
                    scope.bindings.add(alias.asname or alias.name)
                return
            for alias in node.names:
                if alias.name == "*":
                    scope.has_star_import = True
                    continue
                name = alias.asname or alias.name
                self._bind_import(scope, name, node.lineno, name,
                                  in_try=in_try)
            return
        if isinstance(node, ast.Global):
            scope.globals.update(node.names)
            return
        if isinstance(node, ast.Nonlocal):
            scope.nonlocals.update(node.names)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                names = self._target_names(t)
                scope.bindings.update(names)
                # F841 considers only simple `name = ...` targets: tuple
                # unpacking is idiomatically allowed to discard values
                if isinstance(t, ast.Name) and scope.kind == "function":
                    scope.assign_pos.setdefault(t.id, node.lineno)
                for n in names:
                    self._check_builtin_shadow(scope, n, node.lineno)
        elif isinstance(node, ast.AnnAssign):
            scope.bindings.update(self._target_names(node.target))
            if (isinstance(node.target, ast.Name)
                    and scope.kind == "function" and node.value is not None):
                scope.assign_pos.setdefault(node.target.id, node.lineno)
            for n in self._target_names(node.target):
                self._check_builtin_shadow(scope, n, node.lineno)
        elif isinstance(node, ast.AugAssign):
            # `x += 1` both reads and writes x: a use, never an F841 seed
            scope.bindings.update(self._target_names(node.target))
            scope.loaded.update(self._target_names(node.target))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            names = self._target_names(node.target)
            scope.bindings.update(names)
            for n in names:
                self._check_builtin_shadow(scope, n, node.lineno)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    names = self._target_names(item.optional_vars)
                    scope.bindings.update(names)
                    for n in names:
                        self._check_builtin_shadow(scope, n, node.lineno)
        elif isinstance(node, ast.ExceptHandler):
            if node.name:
                scope.bindings.add(node.name)
                self._check_builtin_shadow(scope, node.name, node.lineno)
        elif isinstance(node, (ast.Match,)):
            for case in node.cases:
                for n in ast.walk(case.pattern):
                    if isinstance(n, (ast.MatchAs, ast.MatchStar)):
                        if n.name:
                            scope.bindings.add(n.name)
                    elif isinstance(n, ast.MatchMapping) and n.rest:
                        scope.bindings.add(n.rest)
        elif isinstance(node, (ast.Expr,)) and isinstance(
                node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Name) and f.id in ("exec", "eval"):
                scope.uses_exec = True
        elif isinstance(node, ast.Delete):
            pass  # names stay "bound enough" for our purposes
        # recurse into compound statements' bodies (same scope); imports
        # under a Try are fallback patterns (try: import X / except:
        # import Y) — exempt from F811 shadowing
        child_in_try = in_try or isinstance(node, ast.Try)
        for field in ("body", "orelse", "finalbody", "handlers", "cases"):
            for child in getattr(node, field, []) or []:
                if isinstance(child, ast.AST):
                    self._bind_stmt(scope, child, in_try=child_in_try)

    def _bind_import(self, scope: Scope, name: str, lineno: int,
                     full: str, in_try: bool = False) -> None:
        if scope is self.module_scope:
            self.import_events.append((lineno, name, full, in_try))
            self.import_positions[name] = (lineno, full)
        scope.bindings.add(name)
        self._check_builtin_shadow(scope, name, lineno, what="import of")

    def _check_builtin_shadow(self, scope: Scope, name: str, lineno: int,
                              what: str = "assignment to") -> None:
        """A001: a module- or function-scope binding hides a builtin for
        everything below it. Class-scope attributes are exempt (accessed
        through self./cls., never bare)."""
        if scope.kind in ("class", "comprehension"):
            return
        if name.startswith("_") or name not in BUILTINS:
            return
        self.report(lineno, "A001", f"{what} {name!r} shadows a builtin")

    def _check_import_shadowing(self) -> None:
        """F811: a module-scope import redefines an earlier import of the
        same name with NO use in between. Resolved after the walk (use
        positions are unknown during binding). Submodule imports
        (`import urllib.error` + `import urllib.request`) complement each
        other, and try/except fallback imports are exempt."""
        by_name: Dict[str, List[Tuple[int, str, bool]]] = {}
        for lineno, name, full, in_try in sorted(self.import_events):
            by_name.setdefault(name, []).append((lineno, full, in_try))
        for name, events in by_name.items():
            uses = self.name_use_lines.get(name, [])
            for (prev_line, prev_full, prev_try), (line, full, is_try) in zip(
                    events, events[1:]):
                if prev_try or is_try:
                    continue
                if "." in full or "." in prev_full:
                    continue
                if any(prev_line < u < line for u in uses):
                    continue
                self.report(line, "F811",
                            f"import {name!r} shadows unused import on "
                            f"line {prev_line}")

    # ---------------------------------------------------------- resolving

    def resolve(self, scope: Scope, name: str) -> bool:
        # scope chain FIRST, builtins last: a local shadowing a builtin must
        # still be marked loaded or F841 would misreport it unused
        s: Optional[Scope] = scope
        first = True
        while s is not None:
            if name in s.globals:
                # global-declared names are trusted: `global x; x = 1` in
                # one function legitimately defines x for the whole module,
                # and the binding pass cannot see that ordering
                return True
            if s.kind == "class" and not first:
                s = s.parent  # class scope invisible to nested functions
                first = False
                continue
            if name in s.bindings:
                s.loaded.add(name)  # F841: resolved loads are uses,
                return True         # including closure reads from children
            first = False
            s = s.parent
        return name in BUILTINS

    # --------------------------------------------------------- scope walk

    def check_scope(self, scope: Scope, body: List[ast.stmt],
                    args: Optional[ast.arguments] = None) -> None:
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                scope.bindings.add(a.arg)
                if not a.arg.startswith("_") and a.arg in BUILTINS \
                        and a.arg != "self":
                    self.report(a.lineno, "A002",
                                f"argument {a.arg!r} shadows a builtin")
        self.bind_scope(scope, body)
        self._collect_def_events(scope, body)
        for stmt in body:
            self._walk_expr_container(scope, stmt)
        if scope.kind == "function" and not scope.chain_has_star_or_exec():
            # F841: every nested scope below has been walked by now, so
            # closure reads have already landed in scope.loaded. eval/exec
            # or star-imports anywhere in the chain make use analysis
            # unsound — same guard as F821.
            for name, lineno in sorted(scope.assign_pos.items(),
                                       key=lambda kv: kv[1]):
                if name in scope.loaded or name.startswith("_"):
                    continue
                if name in scope.globals or name in scope.nonlocals:
                    continue  # writes escape the scope
                self.report(lineno, "F841",
                            f"local variable {name!r} assigned but "
                            "never used")

    def _collect_def_events(self, scope: Scope,
                            body: List[ast.stmt]) -> None:
        """Record direct-child def/class definitions of module and class
        bodies for the post-walk F811 redefinition check. Indirect children
        (under if/try — conditional or fallback definitions) are not
        collected, so they are exempt by construction."""
        if scope.kind not in ("module", "class"):
            return
        # (line, end_line, name, decorated, is_import) — end_line bounds
        # the definition's own body, so a recursive self-reference inside
        # it does not count as a "use between definitions"
        events: List[Tuple[int, int, str, bool, bool]] = []
        if scope is self.module_scope:
            # submodule imports (`import urllib.error` + `import
            # urllib.request`) complement each other — same exemption as
            # the import-vs-import F811 check
            events.extend((line, line, name, False, True)
                          for line, name, full, in_try
                          in self.import_events
                          if not in_try and "." not in full)
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                events.append((stmt.lineno, stmt.end_lineno or stmt.lineno,
                               stmt.name, bool(stmt.decorator_list), False))
        if events:
            self._redef_checks.append(events)

    def _check_def_redefinition(self) -> None:
        """F811 beyond imports (resolved after the walk, when use positions
        are known): an undecorated def/class redefining an earlier same-name
        def/class/import in the same module/class body with no use in
        between. Decorated defs (@property/@x.setter/@overload chains) are
        exempt."""
        for events in self._redef_checks:
            by_name: Dict[str, List[Tuple[int, int, bool, bool]]] = {}
            for line, end_line, name, decorated, is_import in sorted(events):
                by_name.setdefault(name, []).append(
                    (line, end_line, decorated, is_import))
            for name, evs in by_name.items():
                uses = self.all_use_lines.get(name, [])
                for (prev_line, prev_end, _, prev_imp), \
                        (line, _, decorated, is_imp) in zip(evs, evs[1:]):
                    if is_imp:
                        continue  # import-vs-import handled by the import
                    #             F811 check; def-then-import left alone
                    if decorated:
                        continue
                    # a use counts as intervening only AFTER the first
                    # definition's own body ends — a recursive call inside
                    # it must not exempt a genuine duplicate (pyflakes
                    # flags that case too)
                    if any(prev_end < u <= line for u in uses):
                        continue
                    if prev_imp:
                        # a def redefining an import supersedes the
                        # import's F401 — but only when the F811 finding
                        # actually replaces it (an exempt redefinition must
                        # not swallow the F401)
                        self.redefined_imports.add(name)
                    self.report(line, "F811",
                                f"redefinition of {name!r} shadows unused "
                                f"definition on line {prev_line}")

    def _walk_expr_container(self, scope: Scope, node: ast.AST) -> None:
        """Visit `node` attributing Name loads to `scope`, descending into
        nested scopes with fresh Scope objects."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._check_defaults_and_decorators(scope, node)
            sub = Scope("function", node, scope)
            self.check_scope(sub, node.body, node.args)
            return
        if isinstance(node, ast.Lambda):
            for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                self._walk_expr_container(scope, d)
            sub = Scope("function", node, scope)
            sub_args = node.args
            for a in (list(sub_args.posonlyargs) + list(sub_args.args)
                      + list(sub_args.kwonlyargs)
                      + ([sub_args.vararg] if sub_args.vararg else [])
                      + ([sub_args.kwarg] if sub_args.kwarg else [])):
                sub.bindings.add(a.arg)
            self._walk_expr_container(sub, node.body)
            return
        if isinstance(node, ast.ClassDef):
            for d in node.decorator_list + node.bases + [
                    kw.value for kw in node.keywords]:
                self._walk_expr_container(scope, d)
            sub = Scope("class", node, scope)
            self.check_scope(sub, node.body)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            sub = Scope("comprehension", node, scope)
            # first iterable evaluates in the ENCLOSING scope
            gens = node.generators
            self._walk_expr_container(scope, gens[0].iter)
            for g in gens:
                sub.bindings.update(self._target_names(g.target))
            for i, g in enumerate(gens):
                if i > 0:
                    self._walk_expr_container(sub, g.iter)
                for cond in g.ifs:
                    self._walk_expr_container(sub, cond)
            if isinstance(node, ast.DictComp):
                self._walk_expr_container(sub, node.key)
                self._walk_expr_container(sub, node.value)
            else:
                self._walk_expr_container(sub, node.elt)
            return
        if isinstance(node, ast.JoinedStr):
            # F541 applies to the real f-string, never to a format_spec
            # (the `{x:02d}` spec is itself a placeholder-less JoinedStr)
            self._stmt_checks(scope, node)
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self._walk_expr_container(scope, v.value)
                    if v.format_spec is not None:
                        for fv in v.format_spec.values:
                            if isinstance(fv, ast.FormattedValue):
                                self._walk_expr_container(scope, fv.value)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                self.all_use_lines.setdefault(node.id, []).append(
                    node.lineno)
                if node.id in ("eval", "exec"):
                    # a dynamic-evaluation use ANYWHERE in the scope makes
                    # name-use analysis unsound (F821 + F841 guard) — the
                    # statement-level detection in _bind_stmt only sees
                    # bare `exec(...)` expression statements
                    scope.uses_exec = True
                if node.id in self.import_positions:
                    self.import_uses.add(node.id)
                    self.name_use_lines.setdefault(node.id, []).append(
                        node.lineno)
                if (not self.resolve(scope, node.id)
                        and not scope.chain_has_star_or_exec()
                        and not self._in_annotation):
                    self.report(node.lineno, "F821",
                                f"undefined name {node.id!r}")
            return
        if (self._in_annotation and isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            # quoted forward ref nested inside an annotation, e.g.
            # List["NodeUpgradeState"] — resolve uses inside it
            try:
                inner = ast.parse(node.value, mode="eval").body
            except SyntaxError:
                return
            self._walk_expr_container(scope, inner)
            return
        self._stmt_checks(scope, node)
        if isinstance(node, ast.AnnAssign):
            # the annotation may be a forward reference (PEP 563): record
            # name USES (keeps imports "used") but suppress F821 inside
            self._walk_annotation(scope, node.annotation)
            if node.value is not None:
                self._walk_expr_container(scope, node.value)
            self._walk_expr_container(scope, node.target)
            return
        for child in ast.iter_child_nodes(node):
            self._walk_expr_container(scope, child)

    _in_annotation = False

    def _walk_annotation(self, scope: Scope, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        prev = self._in_annotation
        self._in_annotation = True
        try:
            # string annotations: parse and resolve uses inside them too
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                try:
                    inner = ast.parse(node.value, mode="eval").body
                except SyntaxError:
                    return
                self._walk_expr_container(scope, inner)
                return
            self._walk_expr_container(scope, node)
        finally:
            self._in_annotation = prev

    def _check_defaults_and_decorators(self, scope: Scope,
                                       node) -> None:
        for d in node.decorator_list:
            self._walk_expr_container(scope, d)
        for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            self._walk_expr_container(scope, d)
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.report(d.lineno, "B006",
                            "mutable default argument "
                            f"in {node.name}()")
        # annotations are uses (they keep imports alive) but may be forward
        # references — resolved with F821 suppressed
        for a in (list(node.args.posonlyargs) + list(node.args.args)
                  + list(node.args.kwonlyargs)
                  + ([node.args.vararg] if node.args.vararg else [])
                  + ([node.args.kwarg] if node.args.kwarg else [])):
            self._walk_annotation(scope, a.annotation)
        self._walk_annotation(scope, node.returns)

    _TERMINAL = (ast.Return, ast.Raise, ast.Break, ast.Continue)

    def _check_unreachable(self, tree: ast.Module) -> None:
        """W0101: statements directly following a return/raise/break/
        continue in the same block can never execute (golangci's
        unreachable-code class). One finding per block (everything after
        the first is transitively dead)."""
        for node in ast.walk(tree):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if not isinstance(stmts, list):
                    continue
                for prev, nxt in zip(stmts, stmts[1:]):
                    if isinstance(prev, self._TERMINAL):
                        kw = type(prev).__name__.lower()
                        self.report(nxt.lineno, "W0101",
                                    f"unreachable code after {kw!r}")
                        break

    # ------------------------------------------------------ per-node checks

    def _stmt_checks(self, scope: Scope, node: ast.AST) -> None:
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            self.report(node.lineno, "E722", "bare except")
        if isinstance(node, ast.JoinedStr):
            if not any(isinstance(v, ast.FormattedValue)
                       for v in node.values):
                self.report(node.lineno, "F541",
                            "f-string without placeholders")
        if isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            for i, op in enumerate(node.ops):
                if isinstance(op, (ast.Eq, ast.NotEq)) and any(
                        isinstance(side, ast.Constant) and side.value is None
                        for side in (operands[i], operands[i + 1])):
                    self.report(node.lineno, "F601",
                                "comparison to None with ==/!= (use is)")
                if isinstance(op, (ast.Eq, ast.NotEq)) and any(
                        isinstance(side, ast.Constant)
                        and isinstance(side.value, bool)
                        for side in (operands[i], operands[i + 1])):
                    self.report(node.lineno, "E712",
                                "comparison to True/False with ==/!= "
                                "(use the value or `is`)")
                if isinstance(op, (ast.Is, ast.IsNot)) and any(
                        # tuple DISPLAYS parse as ast.Tuple (an
                        # ast.Constant tuple only arises from constant
                        # folding) — match both
                        isinstance(side, ast.Tuple)
                        or (isinstance(side, ast.Constant)
                            and isinstance(side.value, (str, int, float,
                                                        bytes, tuple))
                            and not isinstance(side.value, bool))
                        for side in (operands[i], operands[i + 1])):
                    self.report(node.lineno, "F632",
                                "is/is not comparison with a literal "
                                "(use ==/!=)")
        if isinstance(node, ast.Assert) and isinstance(node.test, ast.Tuple) \
                and node.test.elts:
            self.report(node.lineno, "F631",
                        "assert on a tuple literal is always true")
        if isinstance(node, ast.Dict):
            seen: Set = set()
            for k in node.keys:
                if isinstance(k, ast.Constant):
                    try:
                        if k.value in seen:
                            self.report(k.lineno, "F602",
                                        f"duplicate dict key {k.value!r}")
                        seen.add(k.value)
                    except TypeError:
                        pass
        if isinstance(node, (ast.Global,)):
            for n in node.names:
                self.module_scope.bindings.add(n)
        if isinstance(node, ast.Assign):
            # collect __all__ for unused-import exemptions
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) and isinstance(
                                el.value, str):
                            self.dunder_all.add(el.value)

    # --------------------------------------------------------------- main

    def run(self) -> List[Tuple[int, str, str]]:
        tree = self.module_scope.node
        assert isinstance(tree, ast.Module)
        self.check_scope(self.module_scope, tree.body)
        self._check_import_shadowing()
        self._check_def_redefinition()
        self._check_unreachable(tree)
        # unused imports: module scope, skipped for __init__.py (re-export
        # surface), names in __all__, underscore names, and future imports
        if not self.is_init:
            for name, (lineno, full) in sorted(self.import_positions.items(),
                                               key=lambda kv: kv[1][0]):
                if name in self.import_uses or name in self.dunder_all:
                    continue
                if name in self.redefined_imports:
                    continue  # F811 already reports the redefinition
                if name.startswith("_") or full == "__future__":
                    continue
                self.report(lineno, "F401", f"unused import {name!r}")
        return sorted(self.findings)


def _check_escapes(path: str, source: str,
                   findings: List[Tuple[int, str, str]]) -> None:
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", SyntaxWarning)
        try:
            compile(source, path, "exec")
        except SyntaxError:
            return
    for w in caught:
        if "invalid escape sequence" in str(w.message):
            findings.append((w.lineno or 0, "W605", str(w.message)))


def _run(ctx: FileContext) -> List[Tuple[int, str, str]]:
    checker = Checker(ctx.path, ctx.tree, ctx.lines)
    findings = checker.run()
    _check_escapes(ctx.path, ctx.source, findings)
    return findings


CODES = {
    "F821": "undefined name",
    "F401": "unused import",
    "F811": "redefinition without use",
    "F841": "local variable assigned but never used",
    "B006": "mutable default argument",
    "E722": "bare except",
    "F541": "f-string without placeholders",
    "F601": "== / != comparison to None",
    "E712": "== / != comparison to True/False",
    "F632": "is / is not comparison against a literal",
    "F631": "assert on a non-empty tuple literal",
    "F602": "duplicate literal key in a dict display",
    "W605": "invalid escape sequence in a plain string literal",
    "W0101": "unreachable code after return/raise/break/continue",
    "A001": "name binding shadows a builtin",
    "A002": "function argument shadows a builtin",
}

register(Check(name="generic", codes=CODES, scope="file", run=_run))
