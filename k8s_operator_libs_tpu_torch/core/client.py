"""The cluster client interface and its error family.

A copy of the JAX package's ``core/client.py``, cut to what the port
calls: the :class:`Client` ABC (a cached read/write view whose
``direct()`` is the uncached one), the apiserver error family, the
:class:`EventRecorder` ABC with its :class:`NullRecorder` and
:class:`ClientEventRecorder`, :func:`method_verb_kind` (which
``core/resilience.py`` classifies calls by) and :class:`CountingClient`,
the apiserver-call accounting the tick profiler reads. ``ApiError`` is the root of the family. The serving
tier catches it (and ``TimeoutError``) around every cluster read and
write, so a client handed to the tier must raise these two for an
apiserver failure; every error :class:`~.liveclient.LiveClient` raises
is one of them. Unlike the reference, the watch errors are ``ApiError``
subclasses too (they stay ``RuntimeError`` subclasses, as there).
"""

from __future__ import annotations

import abc
import logging
from typing import Dict, List, Optional, Tuple

from ..utils import threads
from ..utils.clock import Clock, RealClock
from .objects import ControllerRevision, DaemonSet, Event, Job, Node, Pod

logger = logging.getLogger(__name__)


class ApiError(RuntimeError):
    """An apiserver call failed with a status (404, 409, 429, 5xx, ...).
    A ``RuntimeError`` subclass, as in the reference."""


class NotFoundError(ApiError, KeyError):
    """Object does not exist (apierrors.IsNotFound analog)."""


class TooManyRequestsError(ApiError):
    """HTTP 429 from the eviction subresource: a PodDisruptionBudget is
    blocking the eviction right now."""


class ConflictError(ApiError):
    """resourceVersion conflict on update (apierrors.IsConflict analog)."""


class ServerError(ApiError):
    """HTTP 5xx from the apiserver, or no answer from it: a transient
    failure (overload, rolling restart, etcd leader change). Retryable."""


class InvalidError(ApiError, ValueError):
    """HTTP 422 Unprocessable Entity: the object failed apiserver
    validation (apierrors.IsInvalid analog)."""


class WatchError(ApiError):
    """A watch stream delivered an ERROR event (e.g. 410 Gone: the
    resource version expired). Consumers must re-list and re-establish
    the watch."""


class ExpiredError(WatchError):
    """410 Gone: the requested resourceVersion predates the server's
    replay window. The only recovery is a fresh LIST."""


class Client(abc.ABC):
    """Cached read / write client (controller-runtime client.Client analog)."""

    # -- reads (may be stale on a cached implementation) --------------------

    @abc.abstractmethod
    def get_node(self, name: str) -> Node: ...

    @abc.abstractmethod
    def list_nodes(self, label_selector: Optional[Dict[str, str]] = None) -> List[Node]: ...

    @abc.abstractmethod
    def get_pod(self, namespace: str, name: str) -> Pod: ...

    @abc.abstractmethod
    def list_pods(self, namespace: Optional[str] = None,
                  label_selector: Optional[Dict[str, str]] = None,
                  field_node_name: Optional[str] = None) -> List[Pod]: ...

    @abc.abstractmethod
    def list_daemonsets(self, namespace: Optional[str] = None,
                        label_selector: Optional[Dict[str, str]] = None) -> List[DaemonSet]: ...

    @abc.abstractmethod
    def list_controller_revisions(self, namespace: Optional[str] = None,
                                  label_selector: Optional[Dict[str, str]] = None
                                  ) -> List[ControllerRevision]: ...

    @abc.abstractmethod
    def get_job(self, namespace: str, name: str) -> Job: ...

    # -- writes (always go to the apiserver; cache lags behind) -------------

    @abc.abstractmethod
    def patch_node_metadata(self, name: str,
                            labels: Optional[Dict[str, Optional[str]]] = None,
                            annotations: Optional[Dict[str, Optional[str]]] = None) -> Node:
        """Strategic-merge-patch labels/annotations; a ``None`` value
        deletes the key."""

    @abc.abstractmethod
    def patch_node_unschedulable(self, name: str, unschedulable: bool) -> Node: ...

    @abc.abstractmethod
    def patch_node_taints(self, name: str, taint_patch) -> Node:
        """Strategic-merge-patch the taints list: entries merge BY KEY,
        ``{"$patch": "delete", "key": K}`` removes one."""

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str,
                   grace_period_seconds: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def evict_pod(self, namespace: str, name: str,
                  grace_period_seconds: Optional[int] = None) -> None:
        """Eviction-API delete (respects PDBs on a real cluster)."""

    # -- cache control ------------------------------------------------------

    @abc.abstractmethod
    def direct(self) -> "Client":
        """The uncached view of the same cluster: reads are never stale."""


class EventRecorder(abc.ABC):
    """record.EventRecorder analog (reference util.go:141-153 wraps it with
    nil-safe helpers; we use a NullRecorder instead of nil)."""

    @abc.abstractmethod
    def event(self, obj, event_type: str, reason: str, message: str) -> None: ...


class NullRecorder(EventRecorder):
    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        pass


class ClientEventRecorder(EventRecorder):
    """An event recorder that persists Event objects through the client's ``create_event`` (or its
    ``direct()`` view's). Failures are swallowed: an event is advisory,
    never worth failing the caller over."""

    def __init__(self, client: Client, namespace: str = "default"):
        self._client = client
        self._namespace = namespace

    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        create = getattr(self._client, "create_event", None)
        if create is None:
            direct = getattr(self._client, "direct", None)
            if direct is not None:
                create = getattr(direct(), "create_event", None)
        if create is None:
            logger.debug("client cannot create Events; dropping %s/%s",
                         reason, event_type)
            return
        try:
            create(make_event(obj, event_type, reason, message),
                   namespace=self._namespace)
        except Exception as exc:  # exc: allow — events are advisory; an event write must never fail the caller
            logger.debug("event write failed (%s); dropping %s", exc, reason)


def make_event(obj, event_type: str, reason: str, message: str) -> Event:
    kind = getattr(obj, "kind", type(obj).__name__)
    name = getattr(getattr(obj, "metadata", None), "name", "")
    return Event(object_kind=kind, object_name=name, event_type=event_type,
                 reason=reason, message=message)


# method prefixes that are apiserver requests; anything else on a client
# (start/stop/set_event_hook/flush_cache) is client machinery
API_VERBS = ("get", "list", "watch", "create", "update", "patch",
             "delete", "evict")

# method-name token after the verb -> Kubernetes kind (longest first so
# "controller_revisions" never resolves as a bare prefix of something
# shorter)
_KIND_TOKENS = (
    ("controller_revisions", "ControllerRevision"),
    ("daemonsets", "DaemonSet"),
    ("daemonset", "DaemonSet"),
    ("services", "Service"),
    ("service", "Service"),
    ("events", "Event"),
    ("event", "Event"),
    ("leases", "Lease"),
    ("lease", "Lease"),
    ("nodes", "Node"),
    ("node", "Node"),
    ("pods", "Pod"),
    ("pod", "Pod"),
    ("jobs", "Job"),
    ("job", "Job"),
)


def method_verb_kind(name: str) -> Optional[Tuple[str, str]]:
    """Client method name → (verb, kind), or None for non-API machinery:
    ``patch_node_metadata`` → ("patch", "Node"), ``list_pods`` →
    ("list", "Pod"), ``evict_pod`` → ("evict", "Pod"). Unknown kinds
    under a known verb count as kind "" rather than going dark."""
    verb, _, rest = name.partition("_")
    if verb not in API_VERBS:
        return None
    for token, kind in _KIND_TOKENS:
        if rest == token or rest.startswith(token + "_"):
            return verb, kind
    return verb, ""


class CountingClient:
    """Transparent accounting wrapper at the client boundary — the same
    ``__getattr__`` shape as chaos's ChaosClient, and composes with it
    (wrap the ChaosClient, never the reverse, so fault decisions see the
    exact call sequence an unwrapped operator would issue). Every API
    call is counted per (verb, kind), timed on the injected clock, and —
    when a tracer is wired — attributed to the span that issued it (the
    ``api_calls`` / ``api_time_s`` span attributes the tick profiler
    reads). Pure accounting: no call is ever delayed, reordered, or
    failed."""

    def __init__(self, inner, metrics=None, tracer=None,
                 clock: Optional[Clock] = None,
                 duration_buckets: Optional[Tuple[float, ...]] = None,
                 _counts=None, _lock=None):
        self._inner = inner
        self._metrics = metrics
        self._tracer = tracer
        self._clock = clock or RealClock()
        self._duration_buckets = duration_buckets
        # shared across direct() views so one tally covers both paths
        self._counts: Dict[Tuple[str, str], int] = (
            {} if _counts is None else _counts)
        self._counts_lock = _lock or threads.make_lock("counting-client")

    def direct(self) -> "CountingClient":
        return CountingClient(self._inner.direct(), metrics=self._metrics,
                              tracer=self._tracer, clock=self._clock,
                              duration_buckets=self._duration_buckets,
                              _counts=self._counts,
                              _lock=self._counts_lock)

    def counts(self) -> Dict[Tuple[str, str], int]:
        """Cumulative {(verb, kind): calls} since construction (shared
        with every direct() view)."""
        with self._counts_lock:
            return dict(self._counts)

    def total_calls(self) -> int:
        with self._counts_lock:
            return sum(self._counts.values())

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr
        vk = method_verb_kind(name)
        if vk is None:
            return attr
        verb, kind = vk

        def call(*args, **kwargs):
            t0 = self._clock.now()
            try:
                return attr(*args, **kwargs)
            finally:
                dt = max(0.0, self._clock.now() - t0)
                with self._counts_lock:
                    self._counts[(verb, kind)] = \
                        self._counts.get((verb, kind), 0) + 1
                if self._metrics is not None:
                    labels = {"verb": verb, "kind": kind}
                    self._metrics.inc("apiserver_requests_total",
                                      labels=labels)
                    self._metrics.observe(
                        "apiserver_request_duration_seconds", dt,
                        labels=labels, buckets=self._duration_buckets)
                if self._tracer is not None:
                    span = self._tracer.current()
                    if span is not None:
                        calls = span.attrs.setdefault("api_calls", {})
                        key = f"{verb} {kind}".rstrip()
                        calls[key] = calls.get(key, 0) + 1
                        span.attrs["api_time_s"] = \
                            span.attrs.get("api_time_s", 0.0) + dt

        return call
