"""STL001: stale-read taint — informer-store values must cross the
freshness barrier before feeding a safety write.

The health monitor argues in a docstring that it never acts on stale
state: the tick pumps the Node/Pod informers FIRST (the declared
freshness barrier), then reads, then writes verdicts/quarantines. This
pass turns that argument into a machine-checked taint property over the
interprocedural engine (:mod:`.dataflow`):

    a value originating at a CachedClient store read (``list_nodes``,
    ``get_node``, ``list_pods``, … on the cached client or a local alias
    of it) must cross a declared freshness barrier — a ``pump()`` /
    ``resync()`` call — before flowing into the arguments of a safety
    write (``patch_node_unschedulable`` / ``patch_node_taints`` /
    ``patch_node_metadata``: cordon/uncordon, quarantine taint/lift, and
    every CRS001 durable decree).

Barrier semantics are line-ordered and chain-inherited, matching how the
spine actually writes them: a read is barriered when a pump/resync call
textually precedes it in the same function, OR when the call chain from
the spine root passed a barrier before descending (the monitor pumps in
``tick`` and reads in helpers; the operator pumps in ``reconcile`` /
``_degraded_tick`` and reads in ``build_state``/the degraded safety
pass). Reads through the ``direct()`` view never fire — the uncached
view cannot be stale by construction.

Only flows reachable from the :data:`ROOTS` fire — the two spine loops
whose writes are safety-relevant. A root whose file exists but whose
function is gone fires config drift at line 1; a missing file (fixture
scratch roots) is silent. Escape hatch: ``# exc: allow — <why>`` on the
read line.

Proven by a barrier-removed mutated monitor copy (fires) and the real
port (silent) in tests/test_torch_lint_flow.py.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .dataflow import get_engine
from .index import FunctionKey, as_index
from .registry import Check, register

CODES = {
    "STL001": "an informer-store read feeds a safety write without "
              "crossing the declared freshness barrier (pump()/resync() "
              "before the read on every chain from the spine root)",
}

HATCH = "# exc: allow"

#: spine roots whose reachable safety writes must be freshness-barriered
ROOTS = (
    ("k8s_operator_libs_tpu_torch/gpu/operator.py", "GPUOperator.reconcile"),
    ("k8s_operator_libs_tpu_torch/health/monitor.py",
     "FleetHealthMonitor.tick"),
)

Finding = Tuple[str, int, str, str]


def run_project(root) -> List[Finding]:
    index = as_index(root)
    engine = get_engine(index)
    findings: List[Finding] = []
    # (key, inherited) -> visited, so the barriered and unbarriered
    # entries to a shared helper are each walked once (may-analysis:
    # ANY unbarriered chain to an unbarriered read fires)
    seen: Set[Tuple[FunctionKey, bool]] = set()
    fired: Dict[Tuple[str, int], bool] = {}

    def visit(key: FunctionKey, inherited: bool, chain: Tuple[str, ...]):
        if (key, inherited) in seen or len(chain) > 24:
            return
        seen.add((key, inherited))
        summary = engine.summaries.get(key)
        if summary is None:
            return
        rec = engine.table[key]
        barriers = summary.barriers
        for flow in summary.flows:
            if flow.source[0] != "read":
                continue
            read_line = flow.source[1]
            if inherited or any(b < read_line for b in barriers):
                continue
            anchor = (rec.rel, read_line)
            if fired.get(anchor):
                continue
            try:
                lines = index.lines(rec.rel)
            except (OSError, SyntaxError):
                lines = []
            if 0 < read_line <= len(lines) \
                    and HATCH in lines[read_line - 1]:
                continue
            fired[anchor] = True
            via = " -> ".join(chain + flow.via)
            findings.append(
                (rec.rel, read_line, "STL001",
                 f"store read feeds safety write "
                 f"{flow.write_method}() at "
                 f"{flow.write_rel}:{flow.write_line} without crossing "
                 f"the freshness barrier (chain: {via}) — pump()/"
                 f"resync() before this read, or `{HATCH} — <why>`"))
        for callee, call_line in engine.edges.get(key, []):
            child_inherited = inherited or any(b < call_line
                                               for b in barriers)
            visit(callee, child_inherited, chain + (rec.qualname,))

    for rel, qual in ROOTS:
        if not index.exists(rel):
            continue
        key = (rel, qual)
        if key not in engine.table:
            findings.append(
                (rel, 1, "STL001",
                 f"declared freshness-barrier root {qual!r} not found — "
                 f"renamed? update ROOTS in "
                 f"k8s_operator_libs_tpu_torch/lint/stale_taint.py"))
            continue
        visit(key, False, ())
    return findings


register(Check(name="stale-taint", codes=CODES, scope="project",
               run=run_project, domain=True))
