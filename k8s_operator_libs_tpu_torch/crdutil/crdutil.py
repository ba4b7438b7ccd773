"""CRD apply/reconcile from YAML directories.

Rebuild of reference pkg/crdutil/crdutil.go: install or update
CustomResourceDefinitions from one or more directories of YAML files, working
around Helm's CRD-handling limitations (crdutil README.md:6-13 — Helm installs
CRDs once and never upgrades them; shipping this as a pre-install/pre-upgrade
hook Job keeps CRDs current). Semantics preserved:

- repeatable ``--crds-dir`` flags, fatal if missing/nonexistent (:55-68);
- recursive walk collecting ``*.yaml``/``*.yml`` (:93-115);
- multi-document YAML decode, silently skipping non-CRD objects so mixed
  manifests work (:126-141);
- per-CRD create-or-update: Get → NotFound ? Create : carry over the live
  ``resourceVersion`` and Update (:160-183);
- exponential backoff retry around each apply (:144-156).

A copy of the JAX package's ``crdutil/crdutil.py``; the port imports
nothing of that package. The repo's CRDs (``crds/`` at its root) are
applied through this path; PyYAML is imported when a file is read.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, List, Protocol

logger = logging.getLogger(__name__)

CRD_KIND = "CustomResourceDefinition"

# Backoff mirroring wait.Backoff{Steps:4, Duration:10ms, Factor:5.0}
# (crdutil.go:144-149): 10ms, 50ms, 250ms pauses between 4 attempts.
BACKOFF_STEPS = 4
BACKOFF_INITIAL = 0.010
BACKOFF_FACTOR = 5.0


class EnsureCRDsError(RuntimeError):
    pass


class CRDClient(Protocol):
    """The slice of the apiextensions client we need."""

    def get_crd(self, name: str) -> dict: ...
    def create_crd(self, crd: dict) -> dict: ...
    def update_crd(self, crd: dict) -> dict: ...


def walk_crds_dir(crds_dir: str) -> List[str]:
    """Recursive *.yaml walk (:93-115). Raises if the dir doesn't exist."""
    if not os.path.isdir(crds_dir):
        raise EnsureCRDsError(f"CRDs directory {crds_dir} does not exist")
    files: List[str] = []
    for root, _, names in os.walk(crds_dir):
        for name in sorted(names):
            if name.endswith((".yaml", ".yml")):
                files.append(os.path.join(root, name))
    return files


def _iter_crd_docs(path: str) -> Iterable[dict]:
    """Multi-doc decode; skip empty docs and non-CRD kinds (:126-141)."""
    import yaml
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if not doc:
                continue
            if doc.get("kind") != CRD_KIND:
                logger.info("skipping non-CRD object %s/%s in %s",
                            doc.get("kind"), doc.get("metadata", {}).get("name"),
                            path)
                continue
            yield doc


def _apply_crd(client: CRDClient, crd: dict) -> None:
    """Create-or-update with resourceVersion carry-over (:160-183)."""
    name = crd["metadata"]["name"]
    try:
        live = client.get_crd(name)
    except KeyError:
        logger.info("creating CRD %s", name)
        client.create_crd(crd)
        return
    logger.info("updating CRD %s", name)
    updated = dict(crd)
    updated["metadata"] = dict(crd["metadata"])
    updated["metadata"]["resourceVersion"] = live.get("metadata", {}).get(
        "resourceVersion", "")
    client.update_crd(updated)


def _with_backoff(fn: Callable[[], None], sleep: Callable[[float], None]) -> None:
    delay = BACKOFF_INITIAL
    for attempt in range(BACKOFF_STEPS):
        try:
            fn()
            return
        except Exception as exc:
            if attempt == BACKOFF_STEPS - 1:
                raise EnsureCRDsError(str(exc)) from exc
            logger.warning("apply failed (attempt %d): %s; retrying",
                           attempt + 1, exc)
            sleep(delay)
            delay *= BACKOFF_FACTOR


def ensure_crds(client: CRDClient, crds_dirs: List[str],
                sleep: Callable[[float], None] = None) -> int:
    """EnsureCRDsCmd (:72-90). Applies every CRD found under each dir;
    returns the number applied. Any failure after retries raises."""
    import time as _time
    sleep = sleep or _time.sleep
    if not crds_dirs:
        raise EnsureCRDsError("at least one CRDs directory is required")
    count = 0
    for d in crds_dirs:
        for path in walk_crds_dir(d):
            for crd in _iter_crd_docs(path):
                _with_backoff(lambda c=crd: _apply_crd(client, c), sleep)
                count += 1
    return count
