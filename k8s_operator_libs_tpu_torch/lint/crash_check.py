"""CRS001: crash-explorer durable-write-site closure — every wire key
the library stamps onto nodes is claimed by exactly one registered
crash-explorer site, and every claim is real.

The crash-restart explorer (``chaos/crash``) proves the operator can be
killed immediately before/after every durable write and recover. That
proof is only as strong as its site registry
(``chaos/crash/registry.py::SITE_WIRE_KEYS``): a new durable write the
registry doesn't know is a crash boundary nobody sweeps. This pass
closes the claim over the repo in both directions, AST-only, in the
CHS001/WIRE001 tradition:

- **code -> registry**: every ``wire.py`` constant that appears inside a
  node-patch call (``patch_node_metadata`` / ``patch_node_taints``) in
  the library must be claimed by exactly ONE site — an unclaimed stamp
  is an unswept crash boundary; a double claim makes occurrence
  counting ambiguous.
- **registry -> code**: every claimed key must exist in ``wire.py``
  (unknown names are registry drift) and must actually be stamped by
  some library patch call (a claim nothing stamps is dead coverage that
  would rot silently).
- the registry's ``SITE_PROCESS`` table must cover exactly the
  registered sites (the explorer dispatches kills on it).

Scope: the library package minus ``chaos/`` — the chaos injector writes
the CLOUD's keys (reclaim taints) while playing the external agent, and
does so through the raw cluster client the explorer's gate never sees.
``core/httpapi.py`` (the fake apiserver applying patches server-side)
is excluded for the same reason. Absent ``chaos/crash/registry.py`` =
silent, like CHS001 with no chaos package.

Proven on mutated copies of the real files by
tests/test_torch_lint_closure.py.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .index import as_index
from .registry import Check, register

CODES = {
    "CRS001": "crash-explorer site drift: a stamped wire key no site "
              "claims, a claimed key that is unknown or never stamped, "
              "a key claimed by two sites, or a site without a process "
              "entry",
}

REGISTRY_PATH = "k8s_operator_libs_tpu_torch/chaos/crash/registry.py"
WIRE_PATH = "k8s_operator_libs_tpu_torch/wire.py"
SCAN_ROOT = "k8s_operator_libs_tpu_torch"
# external-agent / server-side writers, invisible to the explorer's
# gated client boundary by construction (see module docstring)
EXCLUDED_PREFIXES = ("k8s_operator_libs_tpu_torch/chaos/",
                     "k8s_operator_libs_tpu_torch/core/httpapi.py",
                     "k8s_operator_libs_tpu_torch/core/fakecluster.py")

PATCH_METHODS = ("patch_node_metadata", "patch_node_taints")

Finding = Tuple[str, int, str, str]


def _assign_target(node: ast.AST):
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        return node.targets[0], node.value
    if isinstance(node, ast.AnnAssign):
        return node.target, node.value
    return None, None


def _wire_constant_names(tree: ast.Module) -> Set[str]:
    """Module-level NAME = "literal" assignments in wire.py."""
    out: Set[str] = set()
    for node in tree.body:
        target, value = _assign_target(node)
        if (isinstance(target, ast.Name)
                and isinstance(value, ast.Constant)
                and isinstance(value.value, str)):
            out.add(target.id)
    return out


def _site_claims(tree: ast.Module) -> Tuple[Dict[str, List[Tuple[str, int]]],
                                            int]:
    """SITE_WIRE_KEYS literal dict -> {site: [(key name, lineno)]},
    table lineno (0 when missing)."""
    for node in ast.walk(tree):
        target, value = _assign_target(node)
        if not (isinstance(target, ast.Name)
                and target.id == "SITE_WIRE_KEYS"):
            continue
        if not isinstance(value, ast.Dict):
            return {}, node.lineno
        out: Dict[str, List[Tuple[str, int]]] = {}
        for key, val in zip(value.keys, value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            claims: List[Tuple[str, int]] = []
            if isinstance(val, (ast.Tuple, ast.List)):
                for elt in val.elts:
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        claims.append((elt.value, elt.lineno))
            out[key.value] = claims
        return out, node.lineno
    return {}, 0


def _dict_string_keys(tree: ast.Module, name: str) -> Tuple[Set[str], int]:
    for node in ast.walk(tree):
        target, value = _assign_target(node)
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if not isinstance(value, ast.Dict):
            return set(), node.lineno
        return {k.value for k in value.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, str)}, node.lineno
    return set(), 0


def _contains_patch_call(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        method = (func.attr if isinstance(func, ast.Attribute)
                  else func.id if isinstance(func, ast.Name) else None)
        if method in PATCH_METHODS:
            return True
    return False


def _stamped_names(tree: ast.Module,
                   wire_names: Set[str]) -> Dict[str, int]:
    """Wire-constant names referenced inside a FUNCTION that issues a
    node-patch call (``QUARANTINE_LABEL``, ``consts.VERDICT_LABEL``,
    ``wire.MARKET_OWNER_LABEL`` all resolve by terminal identifier —
    wire key names are globally unique by construction) -> first
    lineno. Function scope, not call subtree: stamping sites commonly
    build the labels/annotations payload in locals right above the
    patch call (market/arbiter.py ``_stamp``)."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _contains_patch_call(node):
            continue
        for sub in ast.walk(node):
            name = None
            if isinstance(sub, ast.Attribute):
                name = sub.attr
            elif isinstance(sub, ast.Name):
                name = sub.id
            if name in wire_names:
                out.setdefault(name, sub.lineno)
    return out


def run_project(root) -> List[Finding]:
    index = as_index(root)
    if not index.exists(REGISTRY_PATH):
        return []  # no crash explorer in this checkout: nothing to close
    if not index.exists(WIRE_PATH):
        return [(REGISTRY_PATH, 1, "CRS001",
                 f"crash registry present but {WIRE_PATH} missing — "
                 f"nothing to close its key claims against")]
    findings: List[Finding] = []
    wire_names = _wire_constant_names(index.tree(WIRE_PATH))
    claims, table_line = _site_claims(index.tree(REGISTRY_PATH))
    if table_line == 0 or not claims:
        return [(REGISTRY_PATH, max(1, table_line), "CRS001",
                 "SITE_WIRE_KEYS table not found or empty (parse "
                 "drift?)")]
    process_sites, process_line = _dict_string_keys(
        index.tree(REGISTRY_PATH), "SITE_PROCESS")
    if process_line == 0:
        findings.append((REGISTRY_PATH, 1, "CRS001",
                         "SITE_PROCESS table not found (parse drift?)"))
    else:
        for site in sorted(set(claims) - process_sites):
            findings.append(
                (REGISTRY_PATH, table_line, "CRS001",
                 f"site {site!r} has no SITE_PROCESS entry — the "
                 f"explorer cannot dispatch its kills"))
        for site in sorted(process_sites - set(claims)):
            findings.append(
                (REGISTRY_PATH, process_line, "CRS001",
                 f"SITE_PROCESS names unknown site {site!r}"))

    # registry -> wire: claims must name real wire constants, once
    claimed_by: Dict[str, str] = {}
    for site, site_claims in sorted(claims.items()):
        for name, lineno in site_claims:
            if name not in wire_names:
                findings.append(
                    (REGISTRY_PATH, lineno, "CRS001",
                     f"site {site!r} claims {name}, which is not a "
                     f"wire.py constant (renamed or removed key?)"))
                continue
            if name in claimed_by:
                findings.append(
                    (REGISTRY_PATH, lineno, "CRS001",
                     f"wire key {name} claimed by BOTH "
                     f"{claimed_by[name]!r} and {site!r} — occurrence "
                     f"counting would be ambiguous"))
            claimed_by[name] = site

    # code -> registry: every stamped wire key is claimed; collect where
    stamped: Dict[str, Tuple[str, int]] = {}
    for rel in index.files_under(SCAN_ROOT):
        if rel == WIRE_PATH or rel.startswith(EXCLUDED_PREFIXES):
            continue
        try:
            tree = index.tree(rel)
        except SyntaxError:
            continue  # the generic pass reports E999
        for name, lineno in _stamped_names(tree, wire_names).items():
            stamped.setdefault(name, (rel, lineno))
    for name, (rel, lineno) in sorted(stamped.items()):
        if name not in claimed_by:
            findings.append(
                (rel, lineno, "CRS001",
                 f"durable write stamps wire key {name} but no "
                 f"crash-explorer site claims it ({REGISTRY_PATH}) — "
                 f"an unswept crash boundary"))

    # registry -> code: every claim is actually stamped somewhere
    for site, site_claims in sorted(claims.items()):
        for name, lineno in site_claims:
            if name in wire_names and name not in stamped:
                findings.append(
                    (REGISTRY_PATH, lineno, "CRS001",
                     f"site {site!r} claims {name} but no library "
                     f"patch call stamps it — dead crash coverage"))
    return findings


register(Check(name="crash-closure", codes=CODES, scope="project",
               run=run_project, domain=True))
