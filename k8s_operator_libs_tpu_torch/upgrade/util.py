"""Shared upgrade utilities (a copy of the JAX package's ``upgrade/util.py``;
reference pkg/upgrade/util.go).

The thread-safe StringSet (util.go:26-66) and KeyedMutex (util.go:69-85),
event helpers (util.go:137-153), and the label/annotation key getters
(util.go:97-134), which come from an instance-scoped :class:`KeyFactory`
instead of the reference's process-wide ``DriverName`` global.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..core.client import EventRecorder
from ..utils import threads
from . import consts


class StringSet:
    """Thread-safe string set used to dedup in-flight async work, e.g. nodes
    currently draining (reference util.go:26-66, drain_manager.go:98-108)."""

    def __init__(self):
        self._set: Set[str] = set()
        self._lock = threads.make_lock("string-set")

    def add(self, s: str) -> None:
        with self._lock:
            self._set.add(s)

    def remove(self, s: str) -> None:
        with self._lock:
            self._set.discard(s)

    def has(self, s: str) -> bool:
        with self._lock:
            return s in self._set

    def add_if_absent(self, s: str) -> bool:
        """Atomically add; returns True if it was absent (lets callers claim
        a node exactly once, replacing the reference's Has+Add pair under the
        caller's single-threaded reconcile)."""
        with self._lock:
            if s in self._set:
                return False
            self._set.add(s)
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._set)


class KeyedMutex:
    """Per-key mutex serializing writes to one node's object
    (reference util.go:69-85; used at node_upgrade_state_provider.go:43-78)."""

    def __init__(self):
        self._locks: Dict[str, object] = {}
        self._guard = threads.make_lock("keyed-mutex-guard")

    def _lock_for(self, key: str):
        with self._guard:
            lock = self._locks.get(key)
            if lock is None:
                lock = threads.make_lock(f"keyed-mutex-{key}")
                self._locks[key] = lock
            return lock

    def lock(self, key: str):
        """Context manager: ``with keyed_mutex.lock(node_name): ...``"""
        return self._lock_for(key)


class KeyFactory:
    """Produces the label/annotation keys for one managed component
    ("libtpu", "tpu-device-plugin", "gpu", "ofed", ...). Replaces the
    reference's SetDriverName/DriverName process global (util.go:87-95) and
    key getters (util.go:97-134)."""

    def __init__(self, component: str, domain: str = consts.DEFAULT_DOMAIN):
        if not component:
            raise ValueError("component name must be non-empty")
        self.component = component
        self.domain = domain

    def _fmt(self, template: str) -> str:
        return template.format(domain=self.domain, component=self.component)

    @property
    def state_label(self) -> str:
        return self._fmt(consts.STATE_LABEL_FMT)

    @property
    def skip_node_label(self) -> str:
        return self._fmt(consts.SKIP_NODE_LABEL_FMT)

    @property
    def safe_load_annotation(self) -> str:
        return self._fmt(consts.SAFE_LOAD_ANNOTATION_FMT)

    @property
    def upgrade_requested_annotation(self) -> str:
        return self._fmt(consts.UPGRADE_REQUESTED_ANNOTATION_FMT)

    @property
    def initial_state_annotation(self) -> str:
        return self._fmt(consts.INITIAL_STATE_ANNOTATION_FMT)

    @property
    def wait_for_completion_start_annotation(self) -> str:
        return self._fmt(consts.WAIT_FOR_COMPLETION_START_FMT)

    @property
    def validation_start_annotation(self) -> str:
        return self._fmt(consts.VALIDATION_START_FMT)

    @property
    def journey_annotation(self) -> str:
        return self._fmt(consts.JOURNEY_ANNOTATION_FMT)

    @property
    def stuck_reported_annotation(self) -> str:
        return self._fmt(consts.STUCK_REPORTED_ANNOTATION_FMT)

    @property
    def event_reason(self) -> str:
        """GetEventReason (util.go:137-139): ``<COMPONENT>DriverUpgrade``."""
        return f"{self.component.upper().replace('-', '')}DriverUpgrade"


def parse_selector(selector: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse a "k1=v1,k2=v2" label selector string (the policy's PodSelector
    fields are strings — upgrade_spec.go:57-60, :95-97)."""
    if not selector:
        return None
    out: Dict[str, str] = {}
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid selector term {part!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def log_event(recorder: Optional[EventRecorder], obj, event_type: str,
              reason: str, message: str) -> None:
    """Nil-safe event emit (reference util.go:141-153)."""
    if recorder is not None:
        recorder.event(obj, event_type, reason, message)
