"""DET001/DET002: determinism discipline — injected clocks, seeded RNG.

The chaos harness (``chaos/``) replays whole fault campaigns from one
seed: every clock read flows through an injected ``utils/clock.py``
``Clock`` and every random draw through a ``random.Random(seed)`` /
``np.random.default_rng(seed)`` instance, so a failing seed reproduces
bit-for-bit. That guarantee used to be convention; these codes make it
enforced:

  DET001  bare wall/monotonic clock read or sleep —
          ``time.time()``/``time.sleep()``/``time.monotonic()``/
          ``time.perf_counter()`` (and the ``_ns`` twins), or
          ``datetime.now()``/``utcnow()``/``today()`` — anywhere in the
          library outside ``utils/clock.py``. Route through an injected
          ``Clock`` (``clock.wall()`` / ``clock.now()`` /
          ``clock.sleep()``).
  DET002  unseeded randomness — module-level ``random.*`` draws (global
          RNG state), ``random.Random()`` / ``np.random.default_rng()``
          with no seed argument, ``random.seed()`` (global-state
          seeding), ``random.SystemRandom`` (entropy by design), and
          module-level ``np.random.*`` draws. Construct a seeded
          ``random.Random(seed)`` / ``np.random.default_rng(seed)`` (or
          take one injected) instead; a ``torch.Generator`` seeded by
          ``manual_seed`` never fires.

Scope: files under the library package (``k8s_operator_libs_tpu_torch/``)
only — that is the surface the chaos campaign replays. ``utils/clock.py``
(the boundary that legitimately reads real time) is exempt inside it, and
so are the modules of :data:`~.index.BINARY_TWINS`: the port's entry
points and developer tools (the process edge where real wall time
enters), which live inside the package where the reference keeps them in
``cmd/`` and ``tools/``. ``tests/`` and ``chip_smoke.py`` sit outside the
package and are out of scope by construction.

Escape hatch: genuine wall-time needs (OAuth token expiry against a
real-world deadline, a real rendezvous or compiler run timed) carry a
``# det: allow — <why>`` comment on the flagged line. Both detections
are import-alias aware (``import time as _time`` still fires).
"""

from __future__ import annotations

import ast
from pathlib import PurePath
from typing import Dict, List, Optional, Tuple

from .astutil import dotted
from .index import binary_twin
from .registry import Check, FileContext, register

CODES = {
    "DET001": "bare clock read/sleep outside utils/clock.py (inject a "
              "Clock; chaos seed replay depends on it)",
    "DET002": "unseeded randomness (use random.Random(seed) / "
              "np.random.default_rng(seed) or an injected generator)",
}

HATCH = "# det: allow"

TIME_FUNCS = {"time", "time_ns", "monotonic", "monotonic_ns",
              "perf_counter", "perf_counter_ns", "sleep"}
DATETIME_FUNCS = {"now", "utcnow", "today"}

PACKAGE = "k8s_operator_libs_tpu_torch"


def _in_scope(path: str) -> bool:
    p = PurePath(path)
    if PACKAGE not in p.parts or binary_twin(path, PACKAGE) is not None:
        return False
    return not p.as_posix().endswith("utils/clock.py")


class _Aliases:
    """Alias-aware module tracking: which local names mean ``time``,
    ``datetime`` (module or class), ``random``, and ``numpy.random``."""

    def __init__(self, tree: ast.Module):
        self.time: set = set()
        self.datetime_mod: set = set()
        self.datetime_cls: set = set()
        self.date_cls: set = set()
        self.random_mod: set = set()
        self.np: set = set()
        self.np_random: set = set()
        # from-imported bare names: local name -> (module, original)
        self.names: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    if target == "time":
                        self.time.add(local)
                    elif target == "datetime":
                        self.datetime_mod.add(local)
                    elif target == "random":
                        self.random_mod.add(local)
                    elif target in ("numpy", "np"):
                        self.np.add(local)
                    elif target == "numpy.random":
                        self.np_random.add(local)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                for alias in node.names:
                    local = alias.asname or alias.name
                    if node.module == "datetime":
                        if alias.name == "datetime":
                            self.datetime_cls.add(local)
                        elif alias.name == "date":
                            self.date_cls.add(local)
                    elif node.module in ("time", "random"):
                        self.names[local] = (node.module, alias.name)
                    elif node.module == "numpy" and alias.name == "random":
                        self.np_random.add(local)


def _check_call(al: _Aliases, parts: List[str], call: ast.Call
                ) -> Optional[Tuple[str, str]]:
    """→ (code, message) when the dotted call is a determinism leak."""
    name = ".".join(parts)
    # --- DET001: clock reads / sleeps -------------------------------------
    if len(parts) == 2 and parts[0] in al.time and parts[1] in TIME_FUNCS:
        return ("DET001",
                f"bare {name}() — route through an injected Clock "
                "(utils/clock.py) so chaos seed replay stays deterministic")
    if len(parts) == 1 and parts[0] in al.names:
        mod, orig = al.names[parts[0]]
        if mod == "time" and orig in TIME_FUNCS:
            return ("DET001",
                    f"bare {orig}() (from time) — route through an "
                    "injected Clock (utils/clock.py)")
        if mod == "random":
            if orig == "Random":
                if call.args or call.keywords:
                    return None
                return ("DET002", "random.Random() without a seed — pass "
                                  "an explicit seed")
            return ("DET002",
                    f"module-level random.{orig}() draws from global RNG "
                    "state — use a seeded random.Random(seed) instance")
    # datetime.now() / datetime.datetime.now() / date.today()
    if len(parts) >= 2 and parts[-1] in DATETIME_FUNCS:
        head = parts[:-1]
        if (head[0] in al.datetime_cls or head[0] in al.date_cls
                or (head[0] in al.datetime_mod and len(head) >= 2
                    and head[1] in ("datetime", "date"))):
            return ("DET001",
                    f"{name}() reads the wall clock — route through an "
                    "injected Clock (utils/clock.py)")
    # --- DET002: unseeded randomness --------------------------------------
    if len(parts) == 2 and parts[0] in al.random_mod:
        fn = parts[1]
        if fn == "Random":
            if call.args or call.keywords:
                return None  # seeded instance: the blessed idiom
            return ("DET002", "random.Random() without a seed — pass an "
                              "explicit seed")
        if fn == "SystemRandom":
            return ("DET002", "random.SystemRandom is entropy by design — "
                              "not replayable; seed a random.Random "
                              "instead (or `# det: allow` with why)")
        return ("DET002",
                f"module-level random.{fn}() draws from global RNG state — "
                "use a seeded random.Random(seed) instance")
    np_random_head = None
    if len(parts) >= 2 and parts[0] in al.np and parts[1] == "random":
        np_random_head = 2
    elif parts[0] in al.np_random and len(parts) >= 2:
        np_random_head = 1
    if np_random_head is not None and len(parts) == np_random_head + 1:
        fn = parts[np_random_head]
        if fn == "default_rng":
            if call.args or call.keywords:
                return None  # np.random.default_rng(seed): blessed
            return ("DET002", "np.random.default_rng() without a seed — "
                              "pass an explicit seed")
        if fn == "Generator":
            return None  # wrapping an explicit bit generator
        return ("DET002",
                f"module-level np.random.{fn}() draws from numpy's global "
                "RNG state — use np.random.default_rng(seed)")
    return None


def _run(ctx: FileContext) -> List[Tuple[int, str, str]]:
    if not _in_scope(ctx.path):
        return []
    al = _Aliases(ctx.tree)
    findings: List[Tuple[int, str, str]] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        parts = dotted(node.func)
        if not parts:
            continue
        hit = _check_call(al, parts, node)
        if hit is None:
            continue
        lineno = node.lineno
        if 0 < lineno <= len(ctx.lines) and HATCH in ctx.lines[lineno - 1]:
            continue  # documented wall-time/entropy escape hatch
        findings.append((lineno, hit[0], hit[1]))
    return findings


register(Check(name="determinism", codes=CODES, scope="file", run=_run,
               domain=True))


# ------------------------------------------------------- self-test fixtures
# Replayed by tests/test_torch_lint_det_arc.py under a package-shaped
# path (the pass is scoped to the library tree; see _in_scope).

OFFENDERS = {
    "DET001": '''
import time as _time
import datetime


def stamp(obj):
    obj["created"] = _time.time()
    obj["seen"] = datetime.datetime.now().isoformat()
    _time.sleep(0.1)
    return obj
''',
    "DET002": '''
import random
import numpy as np


def shuffle_nodes(nodes):
    random.shuffle(nodes)
    jitter = np.random.rand()
    rng = np.random.default_rng()
    return nodes, jitter, rng
''',
}

CLEAN = {
    "DET001": '''
import time
from ..utils.clock import Clock


def stamp(obj, clock: Clock):
    obj["created"] = clock.wall()
    clock.sleep(0.1)
    parsed = time.strptime("2026-01-01T00:00:00Z",
                           "%Y-%m-%dT%H:%M:%SZ")   # formatting, not a read
    expiry = time.time()  # det: allow — real-world token expiry deadline
    return obj, parsed, expiry
''',
    "DET002": '''
import random
import numpy as np
import torch


def shuffle_nodes(nodes, seed):
    rng = random.Random(seed)
    rng.shuffle(nodes)
    nprng = np.random.default_rng([seed, 1])
    gen = torch.Generator().manual_seed(seed)   # seeded: always fine
    return nodes, nprng.random(), gen
''',
}
