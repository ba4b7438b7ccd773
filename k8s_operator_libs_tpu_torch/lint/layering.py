"""ARC001: package import layering — reject cycles and layer violations.

The package has two dependency spines that must stay one-directional:

    operator side:  utils/api  →  core  →  upgrade / crdutil  →  health  →  gpu
    model side:     ops        →  models / parallel  →  train

``LAYERS`` is the declared DAG: for each first-level subpackage (or
top-level module) of ``k8s_operator_libs_tpu_torch``, the set of sibling
subpackages it may import. Anything not listed is a violation — which
encodes the two standing bans explicitly: ``core`` must never import
``models`` (the operator library cannot grow a torch dependency), and
``upgrade`` must never import ``parallel`` (the state machine stays
deployable without the training stack).

The table is the reference's with ``tpu`` → ``gpu``; each other entry is
the port's own and says why beside it. The port's binaries and tools
(:data:`~.index.BINARY_TWINS`: entry points and developer tooling the
reference keeps in ``cmd/`` and ``tools/``) sit on top: a top-level one
has its own entry, and one nested in a library subpackage
(``health/sim.py``, ``train/cli.py``, ``chaos/crash/``) is held to
:data:`LIBRARY` as those entries are, not to its subpackage's row.

The pass also builds the full module-level import graph (relative and
absolute imports resolved to in-package modules; ``from x import name``
falls back to module ``x`` when ``x.name`` is not itself a module) and
rejects any import cycle, layer-legal or not. Edges point at the module
actually named — ``from ..core.client import Client`` depends on
``core.client``, not on the ``core`` package ``__init__``.

The package ``__init__.py`` re-export surface is exempt from layering
(it IS the public cross-section) but still participates in the cycle
check.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .index import BINARY_TWINS, as_index, binary_twin
from .registry import Check, register

CODES = {
    "ARC001": "import layering violation or import cycle",
}

PACKAGE = "k8s_operator_libs_tpu_torch"

# subpackage (or top-level module) -> siblings it may import
LAYERS: Dict[str, Set[str]] = {
    "utils": set(),
    "api": {"utils"},
    "consts": set(),
    # wire is the leaf registry of `tpu.dev/*` label/annotation/taint keys
    # (WIRE001 keeps the repo closed over it) — it imports nothing, and
    # any subpackage that speaks the wire contract may import it
    "wire": set(),
    "core": {"utils", "api"},
    # obs sits BELOW upgrade/health/gpu: they import its tracer/journey/
    # metrics hub, and obs must never import them back (its stuck-threshold
    # table is keyed by wire values; OBS001 keeps it closed)
    "obs": {"core", "utils"},
    "crdutil": {"core", "utils", "api"},
    "upgrade": {"core", "utils", "api", "obs"},
    "health": {"core", "utils", "api", "upgrade", "obs", "wire"},
    "gpu": {"core", "utils", "api", "upgrade", "crdutil", "health", "obs",
            "wire"},
    # chaos sits at the TOP of the operator spine: it drives the whole
    # stack (operator, electors, health, SLO, the serving router tier,
    # the capacity market) under injected faults and asserts cross-layer
    # invariants — nothing below may import it back
    "chaos": {"core", "utils", "api", "upgrade", "health", "gpu", "obs",
              "wire", "serving", "market"},
    # market arbitrates between the serving tier and the training
    # harness: it reads the router's lanes, the SLO engine's burn, and
    # the upgrade pipeline's budget — only chaos sits above it, and the
    # trainer side is reached through injected signals, never an import
    "market": {"core", "utils", "api", "obs", "serving", "gpu",
               "upgrade", "wire"},
    "data": {"utils"},
    "ops": {"utils"},
    # port: the dtype/bytes bridge between numpy and torch, over utils
    "convert": {"utils"},
    # obs sits below BOTH spines: the workload side (goodput ledger,
    # serving telemetry) may import it too — obs itself still only sees
    # core/utils, so the operator/model separation is untouched
    # port: + convert, the paged KV export's tensor bytes
    "models": {"ops", "utils", "data", "obs", "convert"},
    # port: + convert, the reference's TrainState into the port's
    # (fsdp.train_state_to_torch)
    "parallel": {"models", "ops", "utils", "convert"},
    "train": {"models", "parallel", "ops", "utils", "data", "obs"},
    # serving is the router tier spanning BOTH spines: it consumes the
    # batcher (models), the SLO engine (obs), slice placement (gpu) and
    # node state (upgrade/core) — only chaos sits above it, and neither
    # spine may import it back
    "serving": {"core", "utils", "api", "obs", "models", "gpu",
                "upgrade", "wire"},
}

#: the library: what a binary or tool on top may import
LIBRARY = frozenset(LAYERS)

# port: the top-level binaries and tools of BINARY_TWINS sit on top of
# the library
LAYERS.update({name.rstrip("/").removesuffix(".py"): set(LIBRARY)
               for name in BINARY_TWINS if "/" not in name.rstrip("/")})
# port: the race explorer's harnesses drive the router binary's proxy
# (race/harnesses.py)
LAYERS["race"].add("router")

Finding = Tuple[str, int, str, str]


def _module_name(root: Path, path: Path, package: str) -> str:
    """File path → dotted module name (``root`` contains the package)."""
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_from(module: str, is_pkg: bool, node: ast.ImportFrom,
                  package: str) -> List[str]:
    """Absolute dotted targets of a `from ... import ...` statement."""
    if node.level == 0:
        base = node.module or ""
    else:
        segs = module.split(".")
        # level 1 = the importer's own package: for a plain module drop
        # its leaf name; a package __init__ IS its package already
        drop = node.level if not is_pkg else node.level - 1
        segs = segs[:len(segs) - drop]
        if node.module:
            segs = segs + node.module.split(".")
        base = ".".join(segs)
    if base != package and not base.startswith(package + "."):
        return []
    return [base if alias.name == "*" else f"{base}.{alias.name}"
            for alias in node.names]


def _to_module(name: str, modules: Set[str]) -> Optional[str]:
    """Longest prefix of ``name`` that is an actual module —
    ``pkg.core.client.Client`` → ``pkg.core.client``;
    ``pkg.core.missing`` → ``pkg.core`` (attribute of the __init__)."""
    parts = name.split(".")
    while parts:
        cand = ".".join(parts)
        if cand in modules:
            return cand
        parts = parts[:-1]
    return None


def _subpackage(module: str) -> str:
    """pkg.core.client → core; pkg.consts → consts; pkg → ''."""
    segs = module.split(".")
    return segs[1] if len(segs) > 1 else ""


def _is_type_checking_if(node: ast.AST) -> bool:
    """``if TYPE_CHECKING:`` / ``if typing.TYPE_CHECKING:`` — imports in
    there never execute, so they are neither edges nor cycles."""
    if not isinstance(node, ast.If):
        return False
    test = node.test
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
        isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")


def _walk_runtime(node: ast.AST):
    """ast.walk skipping TYPE_CHECKING-guarded subtrees."""
    yield node
    for child in ast.iter_child_nodes(node):
        if _is_type_checking_if(child):
            for orelse in child.orelse:  # the else branch DOES run
                yield from _walk_runtime(orelse)
            continue
        yield from _walk_runtime(child)


def run_project(root, package: str = PACKAGE,
                layers: Optional[Dict[str, Set[str]]] = None
                ) -> List[Finding]:
    index = as_index(root)
    root = index.root
    layers = LAYERS if layers is None else layers
    files = index.files_under(package)
    mod_of = {rel: _module_name(root, root / rel, package) for rel in files}
    rel_of = {mod_of[rel]: rel for rel in files}
    modules = set(mod_of.values())
    findings: List[Finding] = []
    graph: Dict[str, Set[str]] = {m: set() for m in modules}
    edge_line: Dict[Tuple[str, str], int] = {}

    for rel in files:
        module = mod_of[rel]
        is_pkg = rel.endswith("__init__.py")
        src_sub = _subpackage(module)
        tree = index.tree(rel)
        imports: List[Tuple[str, int]] = []
        for node in _walk_runtime(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == package or alias.name.startswith(
                            package + "."):
                        imports.append((alias.name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                for tgt in _resolve_from(module, is_pkg, node, package):
                    imports.append((tgt, node.lineno))
        for name, lineno in imports:
            target = _to_module(name, modules)
            if target is None or target == module:
                continue
            graph[module].add(target)
            edge_line.setdefault((module, target), lineno)
            tgt_sub = _subpackage(target)
            if src_sub == "" or tgt_sub == "" or src_sub == tgt_sub:
                continue  # package-root surface / intra-subpackage
            allowed = layers.get(src_sub)
            if src_sub in LIBRARY and binary_twin(rel, package) is not None:
                allowed = LIBRARY  # a binary nested in a library layer
            if allowed is not None and tgt_sub not in allowed:
                findings.append(
                    (rel_of[module], lineno, "ARC001",
                     f"layer violation: {src_sub} may not import {tgt_sub} "
                     f"(allowed: {', '.join(sorted(allowed)) or 'nothing'})"))

    # cycle rejection over the module graph (DFS, 3-color); one finding
    # per back edge, reported at the import that closes the cycle
    WHITE, GREY, BLACK = 0, 1, 2
    color = {m: WHITE for m in graph}
    path_stack: List[str] = []

    def visit(m: str) -> None:
        color[m] = GREY
        path_stack.append(m)
        for nxt in sorted(graph[m]):
            if color[nxt] == GREY:
                cycle = path_stack[path_stack.index(nxt):] + [nxt]
                findings.append(
                    (rel_of[m], edge_line.get((m, nxt), 1), "ARC001",
                     "import cycle: " + " -> ".join(cycle)))
            elif color[nxt] == WHITE:
                visit(nxt)
        path_stack.pop()
        color[m] = BLACK

    for m in sorted(graph):
        if color[m] == WHITE:
            visit(m)
    return findings


register(Check(name="import-layering", codes=CODES, scope="project",
               run=run_project, domain=True))
