"""STM001: state-machine exhaustiveness — enums, handlers, metrics, and
docs can never drift.

Two state machines are covered, same code:

**Upgrade pipeline.** ``upgrade/consts.py`` declares the UpgradeState
members; ``upgrade/upgrade_state.py`` routes every state through a
``process_*`` handler; ``upgrade/metrics.py`` exports a per-state gauge;
the package's ``gen_state_diagram.py`` draws the node. Four files, one
state machine — a diagram image goes stale exactly this way. This
cross-file pass parses all four (AST only, no imports) and fails when
any member of the enum is missing from any of the other three:

- **handler**: the member must be consumed by a ``process_*`` method of
  the manager class — either ``<state-arg>.bucket(UpgradeState.X)``
  inside a ``process_*`` body, or ``UpgradeState.X`` passed to a
  ``self.process_*(...)`` call (the UNKNOWN/DONE routing in ApplyState).
  A ``self.process_*`` call naming a method that does not exist is also
  an error (deleting the handler but not the call site).
- **enum closure**: every member must appear in ``UpgradeState.ALL`` —
  the manually-maintained tuple that metrics and consumers iterate.
- **metrics**: covered either by an explicit ``UpgradeState.X`` reference
  in metrics.py or by iterating ``UpgradeState.ALL`` (the current idiom;
  ALL-membership is checked above, so iteration covers every member).
- **diagram**: gen_state_diagram.py must reference ``UpgradeState.X`` or
  spell the state's wire value as a string literal (the UNKNOWN state's
  value is ``""``, drawn as the literal ``"unknown"``).

**Health verdict lattice.** ``health/consts.py`` declares the
HealthVerdict members; ``health/remediation.py`` dispatches every verdict
to a handler through the ``handlers()`` mapping
(``{HealthVerdict.X: self.process_*}``); ``health/metrics.py`` exports
per-verdict gauges; ``docs/fleet-health.md`` documents each verdict's
wire value. Every member needs all three:

- **handler**: a ``HealthVerdict.X: self.process_*`` entry in the
  remediator's dispatch mapping whose ``process_*`` method exists (a
  mapped-but-undefined handler is also an error);
- **metrics**: an explicit ``HealthVerdict.X`` reference in
  health/metrics.py or iteration of ``HealthVerdict.ALL`` (plus
  ALL-closure, as above);
- **docs**: the wire value must appear in docs/fleet-health.md.

The health facet is skipped when ``health/consts.py`` is absent, so
fixture roots exercising only the upgrade machine still lint.

Tuple-valued class attributes (ALL, IN_PROGRESS, QUARANTINE) and dunder
or dict-valued members are not states.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .astutil import dotted
from .index import as_index
from .registry import Check, register

CODES = {
    "STM001": "UpgradeState member missing a handler/metrics/diagram "
              "registration",
}

CONSTS_PATH = "k8s_operator_libs_tpu_torch/upgrade/consts.py"
STATE_PATH = "k8s_operator_libs_tpu_torch/upgrade/upgrade_state.py"
METRICS_PATH = "k8s_operator_libs_tpu_torch/upgrade/metrics.py"
DIAGRAM_PATH = "k8s_operator_libs_tpu_torch/gen_state_diagram.py"

HEALTH_CONSTS_PATH = "k8s_operator_libs_tpu_torch/health/consts.py"
HEALTH_REMEDIATION_PATH = "k8s_operator_libs_tpu_torch/health/remediation.py"
HEALTH_METRICS_PATH = "k8s_operator_libs_tpu_torch/health/metrics.py"
HEALTH_DOC_PATH = "docs/fleet-health.md"

Finding = Tuple[str, int, str, str]


def _enum_members(tree: ast.Module, enum: str = "UpgradeState"
                  ) -> Tuple[Dict[str, Tuple[str, int]], Set[str]]:
    """→ ({member: (wire value, lineno)}, {names inside the ALL tuple})."""
    members: Dict[str, Tuple[str, int]] = {}
    all_names: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == enum):
            continue
        for stmt in node.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            name = stmt.targets[0].id
            if isinstance(stmt.value, ast.Constant) \
                    and isinstance(stmt.value.value, str):
                members[name] = (stmt.value.value, stmt.lineno)
            elif name == "ALL" and isinstance(stmt.value, ast.Tuple):
                for el in stmt.value.elts:
                    parts = dotted(el)
                    if parts:
                        all_names.add(parts[-1])
    return members, all_names


def _member_refs(node: ast.AST, enum: str = "UpgradeState") -> Set[str]:
    """Every ``<enum>.X`` attribute access under ``node``."""
    out: Set[str] = set()
    for n in ast.walk(node):
        parts = dotted(n) if isinstance(n, ast.Attribute) else None
        if parts and len(parts) == 2 and parts[0] == enum:
            out.add(parts[1])
    return out


def _handler_coverage(tree: ast.Module) -> Tuple[Set[str], Set[str],
                                                 List[Tuple[str, int]]]:
    """→ (states consumed by a process_* handler, defined process_* names,
    [(called-but-undefined process_* name, lineno)])."""
    handled: Set[str] = set()
    defined: Set[str] = set()
    called: List[Tuple[str, int]] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name.startswith("process_"):
                defined.add(method.name)
                # a bucket() read inside a process_* body consumes the state
                for n in ast.walk(method):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "bucket":
                        for arg in n.args:
                            handled |= _member_refs(arg)
            # UpgradeState.X routed through a self.process_*(...) call
            for n in ast.walk(method):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr.startswith("process_"):
                    called.append((n.func.attr, n.lineno))
                    for arg in list(n.args) + [kw.value for kw in n.keywords]:
                        handled |= _member_refs(arg)
    missing_defs = [(name, lineno) for name, lineno in called
                    if name not in defined]
    return handled, defined, missing_defs


def _diagram_coverage(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """→ (UpgradeState.X refs, every string literal in the generator)."""
    literals: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            literals.add(n.value)
    return _member_refs(tree), literals


def _health_handler_coverage(tree: ast.Module
                             ) -> Tuple[Set[str], List[Tuple[str, int]]]:
    """→ (verdicts with a dispatch-mapping handler entry,
    [(mapped-but-undefined process_* name, lineno)]).

    The remediator's exhaustiveness surface is its ``handlers()`` mapping:
    ``{HealthVerdict.X: self.process_*}`` dict literals."""
    defined: Set[str] = set()
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for method in cls.body:
            if isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defined.add(method.name)
    mapped: Set[str] = set()
    dangling: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        for key, value in zip(node.keys, node.values):
            kparts = dotted(key) if isinstance(key, ast.Attribute) else None
            if not (kparts and len(kparts) == 2
                    and kparts[0] == "HealthVerdict"):
                continue
            vparts = dotted(value) if isinstance(value,
                                                 ast.Attribute) else None
            if not (vparts and vparts[-1].startswith("process_")):
                continue
            mapped.add(kparts[1])
            if vparts[-1] not in defined:
                dangling.append((vparts[-1], value.lineno))
    return mapped, dangling


def _health_findings(index) -> List[Finding]:
    root = index.root
    findings: List[Finding] = []
    members, all_names = _enum_members(index.tree(HEALTH_CONSTS_PATH),
                                       enum="HealthVerdict")
    if not members:
        return [(HEALTH_CONSTS_PATH, 1, "STM001",
                 "no HealthVerdict string members found (parse drift?)")]
    mapped, dangling = _health_handler_coverage(
        index.tree(HEALTH_REMEDIATION_PATH))
    for name, lineno in dangling:
        findings.append((HEALTH_REMEDIATION_PATH, lineno, "STM001",
                         f"handlers() maps a verdict to {name}() but no "
                         "such process_* handler is defined"))
    metrics_refs = _member_refs(index.tree(HEALTH_METRICS_PATH),
                                enum="HealthVerdict")
    metrics_iterates_all = "ALL" in metrics_refs
    doc_file = root / HEALTH_DOC_PATH
    doc_text = doc_file.read_text() if doc_file.exists() else ""

    for name, (value, lineno) in sorted(members.items()):
        if name not in mapped:
            findings.append((HEALTH_CONSTS_PATH, lineno, "STM001",
                             f"verdict {name} ({value!r}) has no handler "
                             f"entry in the handlers() mapping of "
                             f"{HEALTH_REMEDIATION_PATH}"))
        if name not in all_names:
            findings.append((HEALTH_CONSTS_PATH, lineno, "STM001",
                             f"verdict {name} missing from "
                             "HealthVerdict.ALL (metrics and consumers "
                             "iterate it)"))
        if not (name in metrics_refs
                or (metrics_iterates_all and name in all_names)):
            findings.append((HEALTH_CONSTS_PATH, lineno, "STM001",
                             f"verdict {name} has no metrics label in "
                             f"{HEALTH_METRICS_PATH}"))
        if value not in doc_text:
            findings.append((HEALTH_CONSTS_PATH, lineno, "STM001",
                             f"verdict {name} ({value!r}) is not "
                             f"documented in {HEALTH_DOC_PATH}"))
    return findings


def run_project(root) -> List[Finding]:
    index = as_index(root)
    root = index.root
    findings: List[Finding] = []
    consts = index.tree(CONSTS_PATH)
    members, all_names = _enum_members(consts)
    if not members:
        return [(CONSTS_PATH, 1, "STM001",
                 "no UpgradeState string members found (parse drift?)")]

    handled, _, missing_defs = _handler_coverage(index.tree(STATE_PATH))
    for name, lineno in missing_defs:
        findings.append((STATE_PATH, lineno, "STM001",
                         f"call to {name}() but no such process_* handler "
                         "is defined"))

    metrics_tree = index.tree(METRICS_PATH)
    metrics_refs = _member_refs(metrics_tree)
    metrics_iterates_all = "ALL" in metrics_refs
    diagram_refs, diagram_literals = _diagram_coverage(
        index.tree(DIAGRAM_PATH))

    for name, (value, lineno) in sorted(members.items()):
        if name not in handled:
            findings.append((CONSTS_PATH, lineno, "STM001",
                             f"state {name} ({value!r}) has no process_* "
                             f"handler in {STATE_PATH}"))
        if name not in all_names:
            findings.append((CONSTS_PATH, lineno, "STM001",
                             f"state {name} missing from UpgradeState.ALL "
                             "(metrics and consumers iterate it)"))
        if not (name in metrics_refs
                or (metrics_iterates_all and name in all_names)):
            findings.append((CONSTS_PATH, lineno, "STM001",
                             f"state {name} has no metrics label in "
                             f"{METRICS_PATH}"))
        display = value or "unknown"
        if not (name in diagram_refs or display in diagram_literals):
            findings.append((CONSTS_PATH, lineno, "STM001",
                             f"state {name} ({display!r}) has no node in "
                             f"the state diagram ({DIAGRAM_PATH})"))

    # health-verdict facet — skipped for fixture roots that only carry the
    # upgrade machine's files (the real repo always has health/consts.py)
    if (root / HEALTH_CONSTS_PATH).exists():
        findings.extend(_health_findings(index))
    return findings


register(Check(name="state-machine", codes=CODES, scope="project",
               run=run_project, domain=True))
