"""The cluster client boundary: the object model (``objects.py``) and its
wire JSON (``serde.py``), the client interface, its errors and event
recorders (``client.py``), the kubectl-drain helper (``drain.py``), the
in-process apiserver with envtest semantics (``fakecluster.py``), the
informer-backed cached client (``cachedclient.py``) and the live
apiserver client (``liveclient.py``)."""

from .objects import (ContainerStatus, ControllerRevision, DaemonSet, Event,
                      Node, ObjectMeta, OwnerReference, Pod, PodCondition)
from .client import (ApiError, Client, ClientEventRecorder, ConflictError,
                     EventRecorder, ExpiredError, InvalidError, NotFoundError,
                     NullRecorder, ServerError, TooManyRequestsError,
                     WatchError)
from .cachedclient import CachedClient
from .fakecluster import FakeCluster, FakeRecorder

__all__ = ["ApiError", "CachedClient", "Client", "ClientEventRecorder",
           "ConflictError", "ContainerStatus", "ControllerRevision",
           "DaemonSet", "Event", "EventRecorder", "ExpiredError",
           "FakeCluster", "FakeRecorder", "InvalidError", "Node",
           "NotFoundError", "NullRecorder", "ObjectMeta", "OwnerReference",
           "Pod", "PodCondition", "ServerError", "TooManyRequestsError",
           "WatchError"]
