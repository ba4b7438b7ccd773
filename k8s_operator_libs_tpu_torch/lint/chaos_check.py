"""CHS001: chaos fault-catalog closure — the injector's fault-type enum,
the scenario-spec parsers, and the invariant coverage map can never
drift apart.

The chaos harness (``k8s_operator_libs_tpu_torch/chaos/``) hangs three
tables off one closed enum, ``chaos/faults.py::FAULT_TYPES``:

- ``scenario.py::FAULT_PARSERS`` — fault type → spec parser. A fault
  with no parser can never appear in a scenario; a parser for a fault
  the injector doesn't know is dead dispatch.
- ``invariants.py::FAULT_COVERAGE`` — fault type → the invariants that
  fault stresses. A fault no invariant claims is chaos nobody checks; a
  coverage key matching no fault is a renamed/removed fault seen from
  the invariant side.
- ``invariants.py::INVARIANT_NAMES`` — the closed checker catalog.
  Every coverage entry must name a real invariant, and every invariant
  must be stressed by at least one fault (an unstressed checker rots
  silently).

Cross-file, AST-only (no imports), in the STM001/OBS00x tradition;
proven on mutated copies of the real files by
tests/test_torch_lint_closure.py.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .index import as_index
from .registry import Check, register

CODES = {
    "CHS001": "chaos fault-catalog drift: a fault type without a "
              "scenario parser or invariant coverage, a stale parser/"
              "coverage key, an unknown invariant name, or an invariant "
              "no fault stresses",
}

FAULTS_PATH = "k8s_operator_libs_tpu_torch/chaos/faults.py"
SCENARIO_PATH = "k8s_operator_libs_tpu_torch/chaos/scenario.py"
INVARIANTS_PATH = "k8s_operator_libs_tpu_torch/chaos/invariants.py"

Finding = Tuple[str, int, str, str]


def _assign_target(node: ast.AST):
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        return node.targets[0], node.value
    if isinstance(node, ast.AnnAssign):
        return node.target, node.value
    return None, None


def _string_tuple(tree: ast.Module, name: str) -> Tuple[Dict[str, int], int]:
    """Literal string elements of a module-level tuple/list → ({value:
    lineno}, assignment lineno; 0 when missing)."""
    for node in ast.walk(tree):
        target, value = _assign_target(node)
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if not isinstance(value, (ast.Tuple, ast.List)):
            return {}, node.lineno
        out: Dict[str, int] = {}
        for elt in value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out[elt.value] = elt.lineno
        return out, node.lineno
    return {}, 0


def _dict_keys(tree: ast.Module, name: str) -> Tuple[Dict[str, int], int]:
    """Literal string keys of a module-level dict → ({key: lineno},
    assignment lineno; 0 when missing)."""
    for node in ast.walk(tree):
        target, value = _assign_target(node)
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if not isinstance(value, ast.Dict):
            return {}, node.lineno
        out: Dict[str, int] = {}
        for key in value.keys:
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                out[key.value] = key.lineno
        return out, node.lineno
    return {}, 0


def _coverage_entries(tree: ast.Module
                      ) -> Tuple[List[Tuple[str, str, int]], int]:
    """(fault key, invariant name, lineno) triples from the literal
    FAULT_COVERAGE table; table lineno (0 when missing)."""
    for node in ast.walk(tree):
        target, value = _assign_target(node)
        if not (isinstance(target, ast.Name)
                and target.id == "FAULT_COVERAGE"):
            continue
        if not isinstance(value, ast.Dict):
            return [], node.lineno
        out: List[Tuple[str, str, int]] = []
        for key, val in zip(value.keys, value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            if isinstance(val, (ast.Tuple, ast.List)):
                for elt in val.elts:
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        out.append((key.value, elt.value, elt.lineno))
        return out, node.lineno
    return [], 0


def run_project(root) -> List[Finding]:
    index = as_index(root)
    if not index.exists(FAULTS_PATH):
        return []  # no chaos package in this checkout: nothing to close
    findings: List[Finding] = []

    fault_types, ft_line = _string_tuple(index.tree(FAULTS_PATH),
                                         "FAULT_TYPES")
    if ft_line == 0 or not fault_types:
        return [(FAULTS_PATH, max(1, ft_line), "CHS001",
                 "FAULT_TYPES tuple not found or empty (parse drift?)")]
    parsers, parsers_line = _dict_keys(index.tree(SCENARIO_PATH),
                                       "FAULT_PARSERS")
    if parsers_line == 0:
        return [(SCENARIO_PATH, 1, "CHS001",
                 "FAULT_PARSERS table not found (parse drift?)")]
    inv_tree = index.tree(INVARIANTS_PATH)
    invariant_names, inv_line = _string_tuple(inv_tree, "INVARIANT_NAMES")
    if inv_line == 0 or not invariant_names:
        return [(INVARIANTS_PATH, max(1, inv_line), "CHS001",
                 "INVARIANT_NAMES tuple not found or empty (parse "
                 "drift?)")]
    coverage, coverage_line = _coverage_entries(inv_tree)
    if coverage_line == 0:
        return [(INVARIANTS_PATH, 1, "CHS001",
                 "FAULT_COVERAGE table not found (parse drift?)")]
    coverage_keys: Dict[str, int] = {}
    for fault, _, lineno in coverage:
        coverage_keys.setdefault(fault, lineno)

    # closure: every fault type has a parser and coverage; no stale keys
    for fault, lineno in sorted(fault_types.items()):
        if fault not in parsers:
            findings.append(
                (FAULTS_PATH, lineno, "CHS001",
                 f"fault type {fault!r} has no scenario parser in "
                 f"FAULT_PARSERS ({SCENARIO_PATH}) — it can never appear "
                 f"in a scenario spec"))
        if fault not in coverage_keys:
            findings.append(
                (FAULTS_PATH, lineno, "CHS001",
                 f"fault type {fault!r} has no FAULT_COVERAGE entry "
                 f"({INVARIANTS_PATH}) — chaos nobody checks"))
    for fault, lineno in sorted(parsers.items()):
        if fault not in fault_types:
            findings.append(
                (SCENARIO_PATH, lineno, "CHS001",
                 f"FAULT_PARSERS key {fault!r} matches no FAULT_TYPES "
                 f"member (renamed or removed fault?)"))
    for fault, lineno in sorted(coverage_keys.items()):
        if fault not in fault_types:
            findings.append(
                (INVARIANTS_PATH, lineno, "CHS001",
                 f"FAULT_COVERAGE key {fault!r} matches no FAULT_TYPES "
                 f"member (renamed or removed fault?)"))

    # coverage values are real invariants; every invariant is stressed
    stressed = set()
    for fault, inv, lineno in coverage:
        if inv not in invariant_names:
            findings.append(
                (INVARIANTS_PATH, lineno, "CHS001",
                 f"FAULT_COVERAGE[{fault!r}] names unknown invariant "
                 f"{inv!r} (known: {', '.join(sorted(invariant_names))})"))
        stressed.add(inv)
    for inv, lineno in sorted(invariant_names.items()):
        if inv not in stressed:
            findings.append(
                (INVARIANTS_PATH, lineno, "CHS001",
                 f"invariant {inv!r} is stressed by no fault type in "
                 f"FAULT_COVERAGE — an unchecked checker rots silently"))
    return findings


register(Check(name="chaos-closure", codes=CODES, scope="project",
               run=run_project, domain=True))
