"""EXC001: exception-contract closure over the reconcile spine.

The resilience boundary (core/resilience.py) speaks in types: a 5xx is a
``core/client.py:ServerError``, a breaker shed
is a ``BreakerOpenError``, and the whole family roots at ``ApiError``.
The fail-static DEGRADED machinery only works if those types are
*classified* — named by an ``except`` arm — before some blanket
``except Exception`` converts them into an anonymous log line. This pass
closes that contract over the four reconcile-spine tick boundaries using
the interprocedural engine (:mod:`.dataflow`):

    any path from a spine root to a client RPC (or explicit raise) whose
    ApiError/ServerError/BreakerOpenError can escape to the tick loop
    UNCLASSIFIED fires, with the full propagation chain.

"Unclassified" is the engine's second may-raise lattice: a broad
``except Exception`` catches the exception at runtime but does NOT
classify it, so the family member still escapes this lattice; only an
arm explicitly naming ``ApiError`` (or a concrete member) subtracts.
The clean idiom is a classified arm ABOVE the isolation catch::

    try:
        mgr.apply_state(state, comp.policy)
    except ApiError:
        ...  # classified: feed the breaker/DEGRADED machinery
    except Exception:   # exc: allow — per-component isolation
        logger.exception(...)

Roots are declared in :data:`ROOTS` — the tick boundaries every
process_*/probe/remediate/route/arbitrate path funnels through. A root
whose file exists but whose function is gone is config drift and fires
at line 1 (the SYN001 precedent); a missing file (scratch fixture roots,
partial checkouts) is silent.

Escape hatch: ``# exc: allow — <why>`` on the flagged line (the call or
raise inside the root that introduces the escape).

Proven live by mutated-copy fixtures in tests/test_torch_lint_flow.py.
"""

from __future__ import annotations

from typing import List, Tuple

from .dataflow import get_engine
from .index import as_index
from .registry import Check, register

CODES = {
    "EXC001": "an ApiError/ServerError/BreakerOpenError can escape a "
              "reconcile-spine tick boundary unclassified (classify with "
              "an `except ApiError:` arm before any broad handler)",
}

HATCH = "# exc: allow"

#: the reconcile-spine tick boundaries (rel, qualname). Every handler
#: the spine dispatches — process_* state handlers, health probes and
#: the remediator, the router's replica moves, the arbiter's decrees —
#: is reached from one of these.
ROOTS = (
    ("k8s_operator_libs_tpu_torch/gpu/operator.py", "GPUOperator.reconcile"),
    ("k8s_operator_libs_tpu_torch/health/monitor.py",
     "FleetHealthMonitor.tick"),
    ("k8s_operator_libs_tpu_torch/serving/router.py", "RequestRouter.tick"),
    ("k8s_operator_libs_tpu_torch/market/arbiter.py", "CapacityArbiter.tick"),
)

Finding = Tuple[str, int, str, str]


def run_project(root) -> List[Finding]:
    index = as_index(root)
    engine = get_engine(index)
    findings: List[Finding] = []
    for rel, qual in ROOTS:
        if not index.exists(rel):
            continue  # fixture roots / partial checkouts
        key = (rel, qual)
        if key not in engine.table:
            findings.append(
                (rel, 1, "EXC001",
                 f"declared reconcile-spine root {qual!r} not found — "
                 f"renamed? update ROOTS in "
                 f"k8s_operator_libs_tpu_torch/lint/exc_contracts.py "
                 f"so the exception contract keeps covering the spine"))
            continue
        summary = engine.summaries[key]
        try:
            lines = index.lines(rel)
        except (OSError, SyntaxError):
            lines = []
        for exc in sorted(summary.unclassified):
            wit = summary.unclassified[exc]
            lineno = wit[2]
            if 0 < lineno <= len(lines) and HATCH in lines[lineno - 1]:
                continue
            chain = engine.chain(key, exc)
            findings.append(
                (rel, lineno, "EXC001",
                 f"{exc} can escape the {qual} tick loop unclassified: "
                 f"{chain} — add an `except ApiError:` arm "
                 f"(core/client.py) before the broad handler on this "
                 f"path, or `{HATCH} — <why>`"))
    return findings


register(Check(name="exc-contracts", codes=CODES, scope="project",
               run=run_project, domain=True))
