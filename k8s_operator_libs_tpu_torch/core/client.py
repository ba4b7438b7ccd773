"""The cluster client interface and its error family.

A copy of the JAX package's ``core/client.py``, cut to what the port
calls: the :class:`Client` ABC (a cached read/write view whose
``direct()`` is the uncached one), the apiserver error family and
:class:`ClientEventRecorder`. ``ApiError`` is the root of the family. The serving
tier catches it (and ``TimeoutError``) around every cluster read and
write, so a client handed to the tier must raise these two for an
apiserver failure; every error :class:`~.liveclient.LiveClient` raises
is one of them. Unlike the reference, the watch errors are ``ApiError``
subclasses too (they stay ``RuntimeError`` subclasses, as there).
"""

from __future__ import annotations

import abc
import logging
from typing import Dict, List, Optional

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


class ClientEventRecorder:
    """An event recorder (record.EventRecorder analog) that persists
    Event objects through the client's ``create_event`` (or its
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
