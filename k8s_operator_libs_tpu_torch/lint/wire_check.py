"""WIRE001: wire-contract closure — every ``*.dev/*`` key lives in the
registry, and the registry carries no dead keys.

The operator's cluster contract is a set of label/annotation/taint keys
(``tpu.dev/health-quarantine``, ``tpu.dev/spot-reclaim``, …). Those
strings are wire format: a typo'd or privately-redefined key silently
splits the contract — the writer and the reader each believe their own
spelling. The registry module (``k8s_operator_libs_tpu_torch/wire.py``)
declares every key exactly once as a plain string constant, and this
pass closes the repo over it in both directions, consuming the shared
:class:`~.index.ProjectIndex` wire-literal inventory:

- **no stray definitions**: a string literal containing ``.dev/``
  anywhere in ``k8s_operator_libs_tpu_torch/`` (its entry points
  included) outside the registry fires — spell the constant's name, not
  its value (docstrings are prose and exempt). An f-string interpolating
  a ``DOMAIN`` constant (``f"{DOMAIN}/…"``) is the same violation in
  disguise and fires too: keys are *constructed* only inside the
  registry. The developer tools of :data:`~.index.BINARY_TWINS` (the
  twins of ``tools/``, this pass among them) are not scanned, as the
  reference scans its package and ``cmd/`` but not ``tools/``.
- **no dead keys**: every registry constant must be referenced by name
  somewhere outside the registry (the package or tests) — an
  unreferenced key is a renamed/removed contract half left behind.

The upgrade pipeline's ``{domain}/{component}-…`` *templates*
(``upgrade/consts.py``) are a separate, instance-scoped mechanism (the
``KeyFactory``) and contain no ``.dev/`` literal — out of scope by
construction.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .index import as_index, binary_twin
from .registry import Check, register

CODES = {
    "WIRE001": "wire-key drift: a *.dev/* literal outside the registry "
              "(k8s_operator_libs_tpu_torch/wire.py), a key constructed "
              "outside it, or a registry key nothing references",
}

REGISTRY_PATH = "k8s_operator_libs_tpu_torch/wire.py"
# where stray literals fire
SCAN_ROOTS = ("k8s_operator_libs_tpu_torch",)
# where a registry constant may be referenced from (tests assert the
# contract — that keeps a key alive)
REFERENCE_ROOTS = SCAN_ROOTS + ("tests",)
PACKAGE = "k8s_operator_libs_tpu_torch"

Finding = Tuple[str, int, str, str]


def _registry_keys(tree: ast.Module) -> Dict[str, Tuple[str, int]]:
    """Module-level ``NAME = "…dev/…"`` constants of the registry."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            target, value = node.target, node.value
        else:
            continue
        if isinstance(value, ast.Constant) and isinstance(value.value, str) \
                and ".dev/" in value.value:
            out[target.id] = (value.value, node.lineno)
    return out


def _references(tree: ast.Module, names: Set[str]) -> Set[str]:
    """Which of ``names`` this module references (as a bare name, an
    attribute tail, or a from-import)."""
    hit: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in names:
            hit.add(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in names:
            hit.add(node.attr)
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name in names:
                    hit.add(alias.name)
    return hit


def run_project(root) -> List[Finding]:
    index = as_index(root)
    if not index.exists(REGISTRY_PATH):
        return [(REGISTRY_PATH, 1, "WIRE001",
                 "wire-key registry module is missing — every *.dev/* "
                 "label/annotation/taint key must be declared here")]
    findings: List[Finding] = []
    keys = _registry_keys(index.tree(REGISTRY_PATH))
    values = {v for v, _ in keys.values()}

    # direction 1: stray literals / constructed keys outside the registry
    for scan_root in SCAN_ROOTS:
        for rel in index.files_under(scan_root):
            if rel == REGISTRY_PATH or (
                    binary_twin(rel, PACKAGE) or "").startswith("tools/"):
                continue
            try:
                literals = index.wire_literals(rel)
            except SyntaxError:
                continue  # the generic pass reports E999
            for lit in literals:
                if lit.fstring:
                    findings.append(
                        (rel, lit.lineno, "WIRE001",
                         "wire key constructed from DOMAIN outside the "
                         f"registry ({REGISTRY_PATH}) — declare the full "
                         "key there and reference it by name"))
                elif lit.value in values:
                    findings.append(
                        (rel, lit.lineno, "WIRE001",
                         f"wire key {lit.value!r} spelled as a literal — "
                         f"reference the {REGISTRY_PATH} constant instead "
                         f"(a local typo would silently fork the "
                         f"contract)"))
                else:
                    findings.append(
                        (rel, lit.lineno, "WIRE001",
                         f"stray wire-key literal {lit.value!r} — declare "
                         f"it in {REGISTRY_PATH} and reference it by "
                         f"name"))

    # direction 2: every registry key is referenced somewhere
    names = set(keys)
    referenced: Set[str] = set()
    for ref_root in REFERENCE_ROOTS:
        for rel in index.files_under(ref_root):
            if rel == REGISTRY_PATH:
                continue
            if not names - referenced:
                break
            try:
                tree = index.tree(rel)
            except SyntaxError:
                continue
            referenced |= _references(tree, names - referenced)
    for name in sorted(names - referenced):
        value, lineno = keys[name]
        findings.append(
            (REGISTRY_PATH, lineno, "WIRE001",
             f"registry key {name} ({value!r}) is referenced nowhere — "
             f"a renamed or removed contract half (delete it or migrate "
             f"the survivors to it)"))
    return findings


register(Check(name="wire-closure", codes=CODES, scope="project",
               run=run_project, domain=True))
