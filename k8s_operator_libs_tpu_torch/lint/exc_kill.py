"""EXC003: crash-kill transparency — no handler may eat the explorer's kill.

The crash-restart explorer (chaos/crash) proves every durable write is a
safe crash boundary by raising ``OperatorKilled`` — deliberately a
``BaseException`` subclass — at the gated client write and asserting the
process dies there (chaos/campaign.py). Any bare ``except:`` or
``except BaseException:`` on a path that can reach one of the registry's
durable-write sites catches that kill, turns "crashed before the write"
into "kept running", and silently VOIDS the crash coverage of every site
it shadows. ``except Exception`` is transparent to the kill by
construction; this pass polices the two forms that are not.

Using the interprocedural engine's call graph, a broad handler fires
when a registered durable-write site is reachable from its ``try`` body
(directly — the patch call is inside the try — or through any resolved
call chain), unless the handler

- **re-raises** (``except BaseException: cleanup(); raise`` — the
  legitimate cleanup idiom stays kill-transparent), or
- names ``OperatorKilled`` explicitly (campaign.py's designated catch
  sites — the only code ALLOWED to absorb a kill, because it is the
  code that threw it), or
- carries ``# exc: allow — <why>`` on the ``except`` line.

The finding names the voided sites so the reviewer sees exactly which
crash-sweep claims the handler would hollow out. Site membership comes
from the same join CRS001 maintains: a function that issues a node-patch
call and references a wire key claimed by ``SITE_WIRE_KEYS`` hosts that
site. No registry in the checkout = nothing to void = silent.

Proven on mutated-copy fixtures by tests/test_torch_lint_flow.py.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .astutil import dotted
from .crash_check import (EXCLUDED_PREFIXES, PATCH_METHODS, REGISTRY_PATH,
                          WIRE_PATH, _site_claims, _wire_constant_names)
from .dataflow import DataflowEngine, get_engine
from .index import FunctionKey, as_index
from .registry import Check, register

CODES = {
    "EXC003": "bare except/except BaseException on a path that reaches a "
              "crash-registry durable-write site — it would swallow the "
              "crash explorer's OperatorKilled and void those sites' "
              "coverage",
}

HATCH = "# exc: allow"
KILL = "OperatorKilled"

Finding = Tuple[str, int, str, str]


def _broad_base(handler: ast.ExceptHandler) -> bool:
    """bare ``except:`` or one naming BaseException — the only two forms
    the kill cannot pass through. Naming OperatorKilled anywhere in the
    clause marks a designated catch site and never fires."""
    if handler.type is None:
        return True
    nodes = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    names = [parts[-1] for n in nodes
             for parts in [dotted(n)] if parts]
    if KILL in names:
        return False
    return "BaseException" in names


def _reraises(handler: ast.ExceptHandler) -> bool:
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


def _hosted_sites(engine: DataflowEngine,
                  claimed_by: Dict[str, str],
                  wire_names: Set[str]) -> Dict[FunctionKey, Set[str]]:
    """Function -> durable-write sites it hosts: it issues a node-patch
    call and references a wire key some site claims (CRS001's join)."""
    out: Dict[FunctionKey, Set[str]] = {}
    for key, rec in engine.table.items():
        if rec.rel.startswith(EXCLUDED_PREFIXES):
            continue  # ungated writers: invisible to the explorer
        if not any(c.parts[-1] in PATCH_METHODS for c in rec.calls):
            continue
        sites: Set[str] = set()
        for node in ast.walk(rec.node):
            name = None
            if isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.Name):
                name = node.id
            if name in wire_names and name in claimed_by:
                sites.add(claimed_by[name])
        if sites:
            out[key] = sites
    return out


def _reachable_sites(engine: DataflowEngine,
                     hosted: Dict[FunctionKey, Set[str]]
                     ) -> Dict[FunctionKey, Set[str]]:
    """Transitive closure of hosted sites over the call graph, memoized
    (reverse-topological SCC order makes one pass exact)."""
    reach: Dict[FunctionKey, Set[str]] = {}
    for scc in engine.sccs:  # callees before callers
        scc_set = set(scc)
        acc: Set[str] = set()
        for key in scc:
            acc |= hosted.get(key, set())
            for callee, _ in engine.edges.get(key, []):
                if callee not in scc_set:
                    acc |= reach.get(callee, set())
        for key in scc:
            if acc:
                reach[key] = acc
    return reach


def _try_body_sites(engine: DataflowEngine, rec,
                    try_node: ast.Try,
                    hosted: Dict[FunctionKey, Set[str]],
                    reach: Dict[FunctionKey, Set[str]]) -> Set[str]:
    sites: Set[str] = set()
    own = hosted.get((rec.rel, rec.qualname), set())
    stack: List[ast.AST] = list(try_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            parts = dotted(node.func)
            if parts:
                if parts[-1] in PATCH_METHODS:
                    sites |= own
                callee = engine.resolve(rec, tuple(parts))
                if callee is not None:
                    sites |= reach.get(callee, set())
        stack.extend(ast.iter_child_nodes(node))
    return sites


def run_project(root) -> List[Finding]:
    index = as_index(root)
    if not index.exists(REGISTRY_PATH) or not index.exists(WIRE_PATH):
        return []  # no crash explorer in this checkout: nothing to void
    engine = get_engine(index)
    wire_names = _wire_constant_names(index.tree(WIRE_PATH))
    claims, _ = _site_claims(index.tree(REGISTRY_PATH))
    claimed_by = {name: site for site, pairs in claims.items()
                  for name, _ in pairs}
    hosted = _hosted_sites(engine, claimed_by, wire_names)
    reach = _reachable_sites(engine, hosted)

    findings: List[Finding] = []
    for key, rec in engine.table.items():
        body = rec.node.body if isinstance(rec.node.body, list) \
            else [rec.node.body]
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(node, ast.Try):
                for handler in node.handlers:
                    if not _broad_base(handler) or _reraises(handler):
                        continue
                    try:
                        lines = index.lines(rec.rel)
                    except (OSError, SyntaxError):
                        lines = []
                    ln = handler.lineno
                    if 0 < ln <= len(lines) and HATCH in lines[ln - 1]:
                        continue
                    sites = _try_body_sites(engine, rec, node,
                                            hosted, reach)
                    if not sites:
                        continue
                    what = "bare except:" if handler.type is None \
                        else "except BaseException"
                    findings.append(
                        (rec.rel, ln, "EXC003",
                         f"{what} would swallow the crash explorer's "
                         f"{KILL} kill, voiding durable-write site(s) "
                         f"{', '.join(sorted(sites))} "
                         f"({REGISTRY_PATH}) — catch Exception, "
                         f"re-raise, or `{HATCH} — <why>`"))
            stack.extend(ast.iter_child_nodes(node))
    return findings


register(Check(name="exc-kill", codes=CODES, scope="project",
               run=run_project, domain=True))
