"""SYN001: host-sync hygiene — the decode and training hot loops stay async.

The batcher reads the device back ONCE per step: ``_decode`` runs its n
single-token ticks on the card and copies the [n, slots] token matrix
back at the end, ``_spec_round`` copies one slab per speculative round.
The trainer waits for the device only at its ``_sync`` boundary, every
``metrics_sync_every`` steps. Both are one-line regressions away: an
innocent ``loss.item()``, ``float(logits[...])`` or ``toks.cpu()`` in the
loop makes the host wait for the card every tick and the step time
quietly decays. This pass pins the boundary statically, over the shared
:class:`~.index.ProjectIndex` (the torch twin of the JAX package's
SYN001, whose device model is JAX's compiled-call idiom):

- **hot paths** (:data:`HOT_FUNCTIONS`): the trainer step loop
  (``CheckpointingTrainer.run``), the batcher's step paths
  (``ContinuousBatcher._step_inner`` / ``_step_spec_round``) and the two
  helpers that hold their readbacks (``_decode`` / ``_spec_round``).
- **device values**: names bound from a model forward
  (``self._fwd(...)``, the draft's ``self._dfwd(...)``), from a
  train-step callable (``*step_fn(...)``) or from a ``torch.*`` factory
  or reduction call (:data:`TORCH_DEVICE_CALLS`), and any expression
  built on a live one (a method call other than a readback, a subscript,
  an attribute, arithmetic or a comparison). Tracking is lexical with
  line ordering: rebinding a name to a host value ends its device life.
- **what fires inside a hot path**:
  - ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a device
    value — a synchronous copy to the host per step;
  - ``float()`` / ``int()`` / ``bool()`` of a device value;
- **what fires anywhere in a hot file**: a ``torch.cuda.synchronize``
  or ``.synchronize`` reference outside the ``_sync`` boundary function
  — all waiting funnels through the one audited choke point.

Escape hatch: each hot path is allowed its *deliberate* readback — the
one sync that defines the step boundary — marked ``# syn: readback`` on
the line (see models/serve.py). The mark silences the finding; the names
that line binds hold host values from there on.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from .astutil import dotted
from .index import as_index
from .registry import Check, register

CODES = {
    "SYN001": "device->host sync on a hot path outside the _sync/"
              "readback boundary (re-serializes the device stream)",
}

# (file, class-qualified function) pairs forming the guarded hot paths
HOT_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "k8s_operator_libs_tpu_torch/train/harness.py": (
        "CheckpointingTrainer.run",),
    "k8s_operator_libs_tpu_torch/models/serve.py": (
        "ContinuousBatcher._step_inner",
        "ContinuousBatcher._step_spec_round",
        "ContinuousBatcher._decode",
        "ContinuousBatcher._spec_round"),
}

# the audited blocking choke point (may reference .synchronize)
BOUNDARY_FUNCTIONS = {"_sync"}

HATCH = "# syn: readback"

HOST_CASTS = {"float", "int", "bool"}
READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}
FORWARD_TAILS = {"_fwd", "_dfwd"}
STEP_TAILS = {"_step_fn", "step_fn"}
# torch.<fn>(...) calls whose result is a tensor on the caller's device
TORCH_DEVICE_CALLS = {
    # factories
    "tensor", "as_tensor", "zeros", "ones", "full", "empty", "arange",
    "zeros_like", "ones_like", "full_like", "empty_like", "rand", "randn",
    "randint", "stack", "cat", "where", "gather", "pad",
    # reductions
    "argmax", "argmin", "sum", "mean", "max", "min", "amax", "amin",
    "prod", "any", "all", "cumsum", "softmax", "log_softmax", "topk",
}

Finding = Tuple[str, int, str, str]
Span = Tuple[int, Optional[int]]          # (birth line, death line)


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    return []


def _pairs(target: ast.AST, value: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(name, the expression bound to it): ``a, b = x, y`` pairs element
    by element, any other unpacking binds every name to the whole
    value."""
    if isinstance(target, (ast.Tuple, ast.List)) \
            and isinstance(value, (ast.Tuple, ast.List)) \
            and len(target.elts) == len(value.elts):
        out: List[Tuple[str, ast.AST]] = []
        for t, v in zip(target.elts, value.elts):
            out.extend(_pairs(t, v))
        return out
    return [(n, value) for n in _target_names(target)]


class _HotScan:
    """One hot function: find device-value lifetimes, then syncs on
    them. Lexical line ordering stands in for control flow — the hot
    loops are straight-line code by design."""

    def __init__(self, rel: str, fn: ast.AST, lines: List[str]):
        self.rel = rel
        self.fn = fn
        self.lines = lines
        self.device: Dict[str, List[Span]] = {}
        self.findings: List[Finding] = []

    def _hatched(self, lineno: int) -> bool:
        return 0 < lineno <= len(self.lines) \
            and HATCH in self.lines[lineno - 1]

    def _walk_fn(self):
        """Same-function walk (nested defs excluded — a nested def runs
        later, under its own rules)."""
        def rec(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                yield child
                yield from rec(child)
        yield from rec(self.fn)

    # ------------------------------------------------------ device values

    def _live(self, name: str, lineno: int) -> bool:
        for birth, death in self.device.get(name, []):
            if birth < lineno and (death is None or lineno <= death):
                return True
        return False

    def _is_device(self, node: ast.AST, lineno: int) -> bool:
        if isinstance(node, ast.Name):
            return self._live(node.id, lineno)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in READBACK_METHODS:
                return False
            parts = dotted(func)
            if parts:
                if len(parts) >= 2 and parts[-1] in FORWARD_TAILS:
                    return True
                if parts[-1] in STEP_TAILS:
                    return True
                if parts[0] == "torch" and parts[-1] in TORCH_DEVICE_CALLS:
                    return True
            return isinstance(func, ast.Attribute) \
                and self._is_device(func.value, lineno)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self._is_device(node.value, lineno)
        if isinstance(node, ast.BinOp):
            return self._is_device(node.left, lineno) \
                or self._is_device(node.right, lineno)
        if isinstance(node, ast.UnaryOp):
            return self._is_device(node.operand, lineno)
        if isinstance(node, ast.Compare):
            return any(self._is_device(n, lineno)
                       for n in [node.left, *node.comparators])
        return False

    def collect_lifetimes(self) -> None:
        assigns = sorted((n for n in self._walk_fn()
                          if isinstance(n, (ast.Assign, ast.AnnAssign))
                          and n.value is not None),
                         key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for name, value in _pairs(target, node.value):
                    spans = self.device.setdefault(name, [])
                    # a rebinding ends the live span (its right-hand side
                    # still reads the old value on this line)
                    for i, (birth, death) in enumerate(spans):
                        if death is None and birth < node.lineno:
                            spans[i] = (birth, node.lineno)
                    if self._is_device(value, node.lineno):
                        spans.append((node.end_lineno or node.lineno, None))

    # ------------------------------------------------------------ checking

    def _describe(self, expr: ast.AST, lineno: int) -> str:
        names = sorted({n.id for n in ast.walk(expr)
                        if isinstance(n, ast.Name)
                        and self._live(n.id, lineno)})
        if names:
            return repr(names[0])
        text = ast.unparse(expr)
        return repr(text if len(text) <= 40 else text[:37] + "...")

    def check(self) -> List[Finding]:
        self.collect_lifetimes()
        qual = getattr(self.fn, "name", "?")
        for node in self._walk_fn():
            if not isinstance(node, ast.Call) or self._hatched(node.lineno):
                continue
            func, line = node.func, node.lineno
            if isinstance(func, ast.Attribute) \
                    and func.attr in READBACK_METHODS \
                    and self._is_device(func.value, line):
                self.findings.append(
                    (self.rel, line, "SYN001",
                     f".{func.attr}() on device value "
                     f"{self._describe(func.value, line)} in hot path "
                     f"{qual}() is a device->host sync per step — fold it "
                     f"into the existing `{HATCH}` boundary or _sync"))
                continue
            parts = dotted(func)
            if parts and len(parts) == 1 and parts[0] in HOST_CASTS:
                hit = next((a for a in node.args
                            if self._is_device(a, line)
                            or any(isinstance(n, ast.Name)
                                   and self._live(n.id, line)
                                   for n in ast.walk(a))), None)
                if hit is not None:
                    self.findings.append(
                        (self.rel, line, "SYN001",
                         f"{parts[0]}() on device value "
                         f"{self._describe(hit, line)} in hot path "
                         f"{qual}() is a device->host sync per step — "
                         f"fold it into the existing `{HATCH}` boundary "
                         f"or _sync"))
        return self.findings


def _function_node(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    parts = qualname.split(".")
    body = tree.body
    node: Optional[ast.AST] = None
    for part in parts:
        node = next((n for n in body
                     if isinstance(n, (ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == part), None)
        if node is None:
            return None
        body = node.body
    return node


def _synchronize_refs(rel: str, tree: ast.Module) -> List[Finding]:
    """``torch.cuda.synchronize`` / ``.synchronize`` references outside
    the boundary functions, in a hot file — all waiting goes through
    ``_sync``."""
    boundary_spans = [
        (n.lineno, n.end_lineno or n.lineno)
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name in BOUNDARY_FUNCTIONS]
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and node.attr == "synchronize" \
                and not any(a <= node.lineno <= b
                            for a, b in boundary_spans):
            findings.append(
                (rel, node.lineno, "SYN001",
                 f"{ast.unparse(node)} outside the _sync boundary — "
                 f"waiting for the device funnels through the one "
                 f"audited choke point"))
    return findings


def check_tree(rel: str, tree: ast.Module, lines: List[str],
               quals: Sequence[str]) -> List[Finding]:
    """SYN001 over one hot file: its ``.synchronize`` references and each
    hot function in ``quals``."""
    findings = _synchronize_refs(rel, tree)
    for qual in quals:
        fn = _function_node(tree, qual)
        if fn is None:
            findings.append(
                (rel, 1, "SYN001",
                 f"hot-path function {qual} not found in {rel} — "
                 f"update lint/sync_check.py HOT_FUNCTIONS when renaming "
                 f"hot paths"))
            continue
        findings.extend(_HotScan(rel, fn, lines).check())
    return findings


def check_source(source: str, quals: Sequence[str],
                 rel: str = "case.py") -> List[Finding]:
    """:func:`check_tree` over a source string (the fixtures' entry)."""
    return check_tree(rel, ast.parse(source), source.splitlines(), quals)


def run_project(root) -> List[Finding]:
    index = as_index(root)
    findings: List[Finding] = []
    for rel, quals in HOT_FUNCTIONS.items():
        if not index.exists(rel):
            continue  # fixture roots carry a subset of the hot files
        try:
            tree = index.tree(rel)
        except SyntaxError:
            continue
        findings.extend(check_tree(rel, tree, index.lines(rel), quals))
    return findings


register(Check(name="sync-hygiene", codes=CODES, scope="project",
               run=run_project, domain=True))


# ------------------------------------------------------- self-test fixtures
# One offender and one clean twin per sync form, each a hot function
# ``Loop.step`` (FIXTURE_QUALS) over a forward's device values.

FIXTURE_QUALS = ("Loop.step",)

_FIXTURE = '''
import numpy as np
import torch


class Loop:
    def _sync(self, event=None):
        if event is not None:
            event.synchronize()
        else:
            torch.cuda.synchronize()

    def step(self, batch):
        logits, cache = self._fwd(batch)
        toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        host = np.zeros(4)
{use}
        return out
'''


def _fixture(*use: str) -> str:
    return _FIXTURE.format(use="".join(f"        {u}\n" for u in use))


OFFENDERS = {
    ".item()": _fixture("out = toks.sum().item()"),
    ".tolist()": _fixture("out = toks.tolist()"),
    ".cpu()": _fixture("out = cache.lengths.cpu()"),
    ".numpy()": _fixture("out = logits.numpy()"),
    "float()": _fixture("out = float(logits[0, -1, 0])"),
    "int()": _fixture("out = int(toks[0])"),
    "bool()": _fixture("out = bool((toks == 0).any())"),
    "torch.cuda.synchronize": _fixture("torch.cuda.synchronize()",
                                       "out = toks"),
    ".synchronize()": _fixture("out = self._done.synchronize()"),
}

CLEAN = {
    ".item()": _fixture("out = host.sum().item()"),
    ".tolist()": _fixture("out = host.tolist()"),
    ".cpu()": _fixture("out = toks.cpu()  # syn: readback — the one sync"),
    ".numpy()": _fixture(
        "out = torch.stack([toks]).cpu().numpy()  # syn: readback"),
    "float()": _fixture("out = float(host[0])"),
    "int()": _fixture("toks = toks.cpu().numpy()  # syn: readback",
                      "out = int(toks[0])"),
    "bool()": _fixture("out = bool(host.any())"),
    "torch.cuda.synchronize": _fixture("self._sync()", "out = toks"),
    ".synchronize()": _fixture("self._sync(self._done)", "out = toks"),
}
