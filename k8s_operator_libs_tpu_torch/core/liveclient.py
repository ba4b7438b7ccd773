"""Live-cluster Kubernetes client over stdlib HTTP(S).

A copy of the JAX package's ``core/liveclient.py``: the :class:`~.client.
Client` ABC and a CRD client against a real apiserver using only
``urllib`` and ``ssl``, parsed into the object model by :mod:`.serde`.
The router binary (``router.py --kubeconfig``) reads its replicas' nodes
and stamps its drain intents through it, and the capacity arbiter
(``market/``) stamps its trades.

Auth config resolution (client-go loading-rules analog):

- :meth:`KubeConfig.from_kubeconfig`: a kubeconfig's current context to
  the cluster server and CA (file or base64 ``-data``), the user's client
  cert/key (file or ``-data``), bearer token or exec plugin. A kubeconfig
  in JSON (valid YAML, and the same dict) is read with the standard
  library; other text needs PyYAML, imported only then;
- :meth:`KubeConfig.in_cluster`: ``KUBERNETES_SERVICE_HOST`` and the
  mounted serviceaccount token and CA.

Errors: every apiserver failure is raised as this package's
:class:`~.client.ApiError` family (404, 409, 422, 429 by class; 5xx and
an unreachable apiserver as :class:`~.client.ServerError`; any other
status as ``ApiError``), so the serving tier's ``except ApiError`` sees
it; a timeout while reading the response stays ``TimeoutError``.

The client is uncached: every read reaches the apiserver and
``direct()`` returns itself.
"""

from __future__ import annotations

import atexit
import base64
import json
import os
import ssl
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import serde
from .client import (ApiError, Client, ConflictError, EventRecorder,
                     ExpiredError, InvalidError, NotFoundError, ServerError,
                     TooManyRequestsError, WatchError)
from .objects import ControllerRevision, DaemonSet, Job, Node, Pod

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class KubeConfig:
    server: str
    ca_file: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    token: Optional[str] = None
    insecure_skip_tls_verify: bool = False
    # client-go credential-plugin config (kubeconfig user.exec). When set,
    # KubeHTTP refreshes the token through it — exec tokens expire (GKE:
    # ~1 h), so a one-shot fetch would start 401ing mid-run.
    exec_cfg: Optional[Dict] = None
    token_expiry: Optional[float] = None  # epoch seconds, None = no expiry

    def refresh_exec_token(self) -> None:
        if self.exec_cfg is not None:
            self.token, self.token_expiry = _run_exec_plugin(self.exec_cfg)

    def token_expired(self) -> bool:
        # Genuine wall time: the expiry races a real-world OAuth deadline
        # issued by the credential plugin, not any simulated timeline — an
        # injected FakeClock here would stop refresh against a live
        # apiserver. 60 s slack covers the request's flight time.
        import time as _time
        return (self.token_expiry is not None
                and _time.time() >= self.token_expiry - 60.0)  # det: allow — real OAuth token expiry

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "KubeConfig":
        if path is None:
            # $KUBECONFIG is a colon-separated list (client-go loading
            # rules); full merging is out of scope — use the first file
            # that exists, falling back to ~/.kube/config
            env = os.environ.get("KUBECONFIG", "")
            candidates = ([p for p in env.split(os.pathsep) if p]
                          or [os.path.expanduser("~/.kube/config")])
            path = next((p for p in candidates if os.path.exists(p)),
                        candidates[0])
        with open(path) as f:
            cfg = _parse_config(f.read())
        ctx_name = context or cfg.get("current-context")
        ctx = _named(cfg.get("contexts"), ctx_name, "context")
        cluster = _named(cfg.get("clusters"), ctx["cluster"], "cluster")
        user = _named(cfg.get("users"), ctx["user"], "user")
        token = user.get("token")
        cert = _file_or_data(user, "client-certificate")
        key = _file_or_data(user, "client-key")
        exec_cfg = None
        token_expiry = None
        if token is None and cert is None and "exec" in user:
            # GKE kubeconfigs authenticate via an exec plugin
            # (gke-gcloud-auth-plugin): run it and use the returned
            # ExecCredential token, instead of silently loading no
            # credentials and failing later with opaque 401s
            exec_cfg = user["exec"]
            token, token_expiry = _run_exec_plugin(exec_cfg)
        server = cluster["server"].rstrip("/")
        if token is None and cert is None and server.startswith("https"):
            # http:// servers (kubectl proxy) legitimately need no creds;
            # an https cluster with none would fail later with opaque 401s
            raise RuntimeError(
                f"kubeconfig user {ctx['user']!r} has no usable credentials: "
                "no client certificate, no static token, and no (working) "
                "exec plugin. Supported auth: client-certificate[-data] + "
                "client-key[-data], token, or an exec plugin on PATH "
                "(e.g. gke-gcloud-auth-plugin).")
        return cls(
            server=server,
            ca_file=_file_or_data(cluster, "certificate-authority"),
            client_cert_file=cert,
            client_key_file=key,
            token=token,
            insecure_skip_tls_verify=bool(
                cluster.get("insecure-skip-tls-verify", False)),
            exec_cfg=exec_cfg,
            token_expiry=token_expiry,
        )

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a cluster "
                               "(KUBERNETES_SERVICE_HOST unset)")
        with open(os.path.join(SA_DIR, "token")) as f:
            token = f.read().strip()
        return cls(server=f"https://{host}:{port}",
                   ca_file=os.path.join(SA_DIR, "ca.crt"), token=token)


def _parse_config(text: str) -> Dict:
    """A kubeconfig's text to its dict: JSON with the standard library,
    anything else with PyYAML (imported here, so a JSON kubeconfig needs
    no PyYAML)."""
    try:
        return json.loads(text)
    except ValueError:
        import yaml
        return yaml.safe_load(text)


def _run_exec_plugin(exec_cfg: Dict):
    """client-go credential-plugin protocol: run the configured command and
    parse the ExecCredential JSON it prints ({"status": {"token": ...}}).
    Returns (token, expiration_epoch_or_None). Raises with a clear message
    when the plugin is missing or misbehaves."""
    import subprocess
    cmd = [exec_cfg.get("command", "")]
    cmd += list(exec_cfg.get("args") or [])
    env = dict(os.environ)
    for e in exec_cfg.get("env") or []:
        env[e.get("name", "")] = e.get("value", "")
    api_version = exec_cfg.get("apiVersion",
                               "client.authentication.k8s.io/v1beta1")
    env["KUBERNETES_EXEC_INFO"] = json.dumps({
        "apiVersion": api_version, "kind": "ExecCredential",
        "spec": {"interactive": False}})
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError:
        raise RuntimeError(
            f"kubeconfig exec plugin {cmd[0]!r} not found on PATH — install "
            "it (for GKE: gke-gcloud-auth-plugin) or use cert/token auth")
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"kubeconfig exec plugin {cmd[0]!r} timed out")
    if out.returncode != 0:
        raise RuntimeError(
            f"kubeconfig exec plugin {cmd[0]!r} failed (rc={out.returncode}): "
            f"{out.stderr.strip()[:500]}")
    try:
        cred = json.loads(out.stdout)
        status = cred["status"]
        token = status["token"]
    except (ValueError, KeyError, TypeError):
        raise RuntimeError(
            f"kubeconfig exec plugin {cmd[0]!r} did not print an "
            "ExecCredential with status.token")
    expiry = None
    ts = status.get("expirationTimestamp")
    if ts:
        import calendar
        import time as _time
        try:
            expiry = calendar.timegm(
                _time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
        except ValueError:
            pass  # unparseable expiry → treat as non-expiring
    return token, expiry


def _named(entries, name, kind) -> Dict:
    for e in entries or []:
        if e.get("name") == name:
            return e.get(kind, {})
    raise KeyError(f"kubeconfig has no {kind} named {name!r}")


def _file_or_data(section: Dict, key: str) -> Optional[str]:
    """Resolve ``<key>`` (a path) or ``<key>-data`` (base64 inline, written
    to a 0600 temp file so ssl can load it — key material must not outlive
    the process, so removal is registered with atexit)."""
    if section.get(key):
        return section[key]
    data = section.get(f"{key}-data")
    if not data:
        return None
    tmp = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
    tmp.write(base64.b64decode(data))
    tmp.close()
    atexit.register(_unlink_quiet, tmp.name)
    return tmp.name


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class KubeHTTP:
    """Minimal REST transport: JSON in/out, k8s status → typed errors."""

    def __init__(self, config: KubeConfig):
        self.config = config
        self._ctx: Optional[ssl.SSLContext] = None
        if config.server.startswith("https"):
            ctx = ssl.create_default_context(cafile=config.ca_file)
            if config.insecure_skip_tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if config.client_cert_file:
                ctx.load_cert_chain(config.client_cert_file,
                                    config.client_key_file)
            self._ctx = ctx

    def _build_request(self, method: str, path: str,
                       params: Optional[Dict[str, str]] = None,
                       data: Optional[bytes] = None
                       ) -> urllib.request.Request:
        if self.config.token_expired():
            self.config.refresh_exec_token()
        url = self.config.server + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        return req

    def stream_lines(self, path: str,
                     params: Optional[Dict[str, str]] = None,
                     read_timeout: float = 60.0):
        """GET a line-delimited JSON stream (the k8s watch wire format),
        yielding one parsed dict per line until the server closes the
        connection. Used by :meth:`LiveClient.watch_nodes`."""
        req = self._build_request("GET", path, params)
        with urllib.request.urlopen(req, context=self._ctx,
                                    timeout=read_timeout) as resp:
            for raw in resp:
                raw = raw.strip()
                if raw:
                    yield json.loads(raw)

    def request(self, method: str, path: str,
                body: Optional[Dict] = None,
                params: Optional[Dict[str, str]] = None,
                content_type: str = "application/json") -> Dict:
        data = json.dumps(body).encode() if body is not None else None
        for attempt in (0, 1):
            req = self._build_request(method, path, params, data)
            if data is not None:
                req.add_header("Content-Type", content_type)
            try:
                with urllib.request.urlopen(req, context=self._ctx,
                                            timeout=30) as resp:
                    payload = resp.read()
                break
            except urllib.error.HTTPError as exc:
                detail = exc.read().decode(errors="replace")
                if (exc.code == 401 and attempt == 0
                        and self.config.exec_cfg is not None):
                    # exec token revoked before its stated expiry —
                    # re-run the plugin once and retry
                    self.config.refresh_exec_token()
                    continue
                if exc.code == 404:
                    raise NotFoundError(f"{method} {path}: {detail}") from exc
                if exc.code == 409:
                    raise ConflictError(f"{method} {path}: {detail}") from exc
                if exc.code == 422:
                    raise InvalidError(
                        f"{method} {path}: {detail}") from exc
                if exc.code == 429:
                    # PDB-blocked eviction; drain retries until timeout
                    raise TooManyRequestsError(
                        f"{method} {path}: {detail}") from exc
                error = ServerError if exc.code >= 500 else ApiError
                raise error(
                    f"{method} {path}: HTTP {exc.code}: {detail}") from exc
            except urllib.error.URLError as exc:
                # no answer at all (refused, reset, DNS): the apiserver
                # is unreachable, a transient server-side failure
                raise ServerError(
                    f"{method} {path}: apiserver unreachable: "
                    f"{exc.reason}") from exc
        return json.loads(payload) if payload else {}


def _check_watch_error(ev: Dict) -> None:
    if ev.get("type") == "ERROR":
        obj = ev.get("object") or {}
        if isinstance(obj, dict) and obj.get("code") == 410:
            raise ExpiredError(str(obj))
        raise WatchError(str(obj))


def _list_rv(j: Dict) -> str:
    return str((j.get("metadata") or {}).get("resourceVersion", "") or "")


def _selector_params(label_selector: Optional[Dict[str, str]] = None,
                     field_node_name: Optional[str] = None
                     ) -> Optional[Dict[str, str]]:
    params = {}
    if label_selector:
        params["labelSelector"] = ",".join(
            f"{k}={v}" for k, v in sorted(label_selector.items()))
    if field_node_name:
        params["fieldSelector"] = f"spec.nodeName={field_node_name}"
    return params or None


class LiveClient(Client):
    """:class:`~.client.Client` over a real apiserver. Uncached — see the
    module docstring for how that interacts with the cache-sync barrier."""

    def __init__(self, http: KubeHTTP):
        self._http = http

    @property
    def http(self) -> KubeHTTP:
        """The underlying transport (shared with LiveCRDClient by a
        binary that does both)."""
        return self._http

    # ------------------------------------------------------------- reads

    def get_node(self, name: str) -> Node:
        return serde.node_from_json(
            self._http.request("GET", f"/api/v1/nodes/{name}"))

    def list_nodes(self, label_selector=None) -> List[Node]:
        return self.list_nodes_with_rv(label_selector)[0]

    def list_nodes_with_rv(self, label_selector=None
                           ) -> Tuple[List[Node], str]:
        """LIST plus the collection resourceVersion (ListMeta) — the resume
        point the informer hands to the next watch (controller-runtime
        ListWatch protocol)."""
        j = self._http.request("GET", "/api/v1/nodes",
                               params=_selector_params(label_selector))
        return ([serde.node_from_json(i) for i in j.get("items", [])],
                _list_rv(j))

    def get_pod(self, namespace: str, name: str) -> Pod:
        return serde.pod_from_json(self._http.request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}"))

    def list_pods(self, namespace=None, label_selector=None,
                  field_node_name=None) -> List[Pod]:
        return self.list_pods_with_rv(namespace, label_selector,
                                      field_node_name)[0]

    def list_pods_with_rv(self, namespace=None, label_selector=None,
                          field_node_name=None) -> Tuple[List[Pod], str]:
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        j = self._http.request("GET", path, params=_selector_params(
            label_selector, field_node_name))
        return ([serde.pod_from_json(i) for i in j.get("items", [])],
                _list_rv(j))

    def list_daemonsets(self, namespace=None,
                        label_selector=None) -> List[DaemonSet]:
        return self.list_daemonsets_with_rv(namespace, label_selector)[0]

    def list_daemonsets_with_rv(self, namespace=None, label_selector=None
                                ) -> Tuple[List[DaemonSet], str]:
        path = (f"/apis/apps/v1/namespaces/{namespace}/daemonsets"
                if namespace else "/apis/apps/v1/daemonsets")
        j = self._http.request("GET", path,
                               params=_selector_params(label_selector))
        return ([serde.daemonset_from_json(i) for i in j.get("items", [])],
                _list_rv(j))

    def list_controller_revisions(self, namespace=None, label_selector=None
                                  ) -> List[ControllerRevision]:
        path = (f"/apis/apps/v1/namespaces/{namespace}/controllerrevisions"
                if namespace else "/apis/apps/v1/controllerrevisions")
        j = self._http.request("GET", path,
                               params=_selector_params(label_selector))
        return [serde.controller_revision_from_json(i)
                for i in j.get("items", [])]

    def get_job(self, namespace: str, name: str) -> Job:
        return serde.job_from_json(self._http.request(
            "GET", f"/apis/batch/v1/namespaces/{namespace}/jobs/{name}"))

    # ------------------------------------------------------------- watch

    def _watch_stream(self, path: str, from_json,
                      label_selector=None, timeout_seconds: float = 30.0,
                      resource_version: Optional[str] = None,
                      allow_bookmarks: bool = False):
        """Shared watch protocol: one ("ADDED"|"MODIFIED"|"DELETED"|
        "BOOKMARK", obj) per line until the server ends the window
        (controller-runtime informer analog: consumers loop, reconnecting
        per window). ``resource_version`` resumes from a prior LIST/event
        RV so nothing is missed between windows; ``allow_bookmarks``
        requests BOOKMARK events (objects carrying only a fresh RV) so an
        idle watch's resume point doesn't expire. ERROR events raise
        :class:`WatchError` — 410 Gone specifically raises
        :class:`ExpiredError` → consumers re-list."""
        params = _selector_params(label_selector) or {}
        params.update({"watch": "true",
                       # int string: the real apiserver ParseInts this
                       "timeoutSeconds": str(int(timeout_seconds))})
        if resource_version:
            params["resourceVersion"] = str(resource_version)
        if allow_bookmarks:
            params["allowWatchBookmarks"] = "true"
        for ev in self._http.stream_lines(path, params,
                                          read_timeout=timeout_seconds + 30):
            _check_watch_error(ev)
            yield ev.get("type", ""), from_json(ev.get("object") or {})

    def watch_nodes(self, label_selector=None, timeout_seconds: float = 30.0,
                    resource_version: Optional[str] = None,
                    allow_bookmarks: bool = False):
        return self._watch_stream("/api/v1/nodes", serde.node_from_json,
                                  label_selector, timeout_seconds,
                                  resource_version, allow_bookmarks)

    def watch_pods(self, namespace: Optional[str] = None,
                   label_selector=None, timeout_seconds: float = 30.0,
                   resource_version: Optional[str] = None,
                   allow_bookmarks: bool = False):
        """Driver-pod recreation is what unblocks pod-restart-required, so
        operators watch their pods as well as nodes."""
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        return self._watch_stream(path, serde.pod_from_json,
                                  label_selector, timeout_seconds,
                                  resource_version, allow_bookmarks)

    def watch_daemonsets(self, namespace: Optional[str] = None,
                         label_selector=None,
                         timeout_seconds: float = 30.0,
                         resource_version: Optional[str] = None,
                         allow_bookmarks: bool = False):
        """The informer cache watches driver DaemonSets so revision bumps
        appear without polling (reference: the controller-runtime cache
        informs on every GVK it reads — upgrade_state.go:127-130)."""
        path = (f"/apis/apps/v1/namespaces/{namespace}/daemonsets"
                if namespace else "/apis/apps/v1/daemonsets")
        return self._watch_stream(path, serde.daemonset_from_json,
                                  label_selector, timeout_seconds,
                                  resource_version, allow_bookmarks)

    # ------------------------------------------------------------ writes

    def patch_node_metadata(self, name, labels=None,
                            annotations=None) -> Node:
        meta: Dict = {}
        if labels is not None:
            meta["labels"] = labels          # None values → JSON null deletes
        if annotations is not None:
            meta["annotations"] = annotations
        return serde.node_from_json(self._http.request(
            "PATCH", f"/api/v1/nodes/{name}", body={"metadata": meta},
            content_type="application/strategic-merge-patch+json"))

    def patch_node_unschedulable(self, name: str, unschedulable: bool
                                 ) -> Node:
        return serde.node_from_json(self._http.request(
            "PATCH", f"/api/v1/nodes/{name}",
            body={"spec": {"unschedulable": unschedulable}},
            content_type="application/strategic-merge-patch+json"))

    def patch_node_taints(self, name: str, taint_patch) -> Node:
        """Strategic-merge-patch the node's taints list. ``taint_patch``
        entries are wire-format dicts ({key, value, effect}, or
        {"$patch": "delete", "key": K} to remove one) — the server merges
        by ``key`` (patchMergeKey), it does NOT replace the list."""
        return serde.node_from_json(self._http.request(
            "PATCH", f"/api/v1/nodes/{name}",
            body={"spec": {"taints": taint_patch}},
            content_type="application/strategic-merge-patch+json"))

    def create_pod(self, pod: Pod) -> Pod:
        """POST a pod (the SliceScheduler's placement write)."""
        ns = pod.metadata.namespace or "default"
        return serde.pod_from_json(self._http.request(
            "POST", f"/api/v1/namespaces/{ns}/pods",
            body=serde.pod_to_json(pod)))

    def create_service(self, service):
        """POST a Service (the scheduler's headless Service for workload-pod
        DNS: the JAX/MEGASCALE coordinator address resolves via it)."""
        ns = service.metadata.namespace or "default"
        return serde.service_from_json(self._http.request(
            "POST", f"/api/v1/namespaces/{ns}/services",
            body=serde.service_to_json(service)))

    def create_event(self, event, namespace: str = "default"):
        """POST an already-built :class:`~.objects.Event`
        (ClientEventRecorder's write path). Name uniqueness follows
        LiveEventRecorder: a time_ns suffix never collides across recorder
        restarts (the --once Job case)."""
        import time as _time
        uid = f"{_time.time_ns():x}"  # det: allow — cross-restart unique Event name
        name = (f"{event.object_name or 'obj'}."
                f"{(event.reason or 'event').lower()}.{uid}")
        body = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": {
                "kind": event.object_kind, "name": event.object_name,
                "namespace": namespace if event.object_kind != "Node"
                else ""},
            "type": event.event_type, "reason": event.reason,
            "message": event.message,
            "reportingComponent": "tpu-operator",
        }
        self._http.request(
            "POST", f"/api/v1/namespaces/{namespace}/events", body=body)
        return event

    # ------------------------------------------------ leases (leader election)

    _LEASES = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"

    def get_lease(self, namespace, name):
        return serde.lease_from_json(self._http.request(
            "GET", self._LEASES.format(ns=namespace) + f"/{name}"))

    def create_lease(self, lease):
        ns = lease.metadata.namespace or "default"
        return serde.lease_from_json(self._http.request(
            "POST", self._LEASES.format(ns=ns),
            body=serde.lease_to_json(lease)))

    def update_lease(self, lease):
        """PUT with the lease's resourceVersion — a stale version 409s,
        which is the compare-and-swap leader election depends on."""
        ns = lease.metadata.namespace or "default"
        return serde.lease_from_json(self._http.request(
            "PUT", self._LEASES.format(ns=ns) + f"/{lease.metadata.name}",
            body=serde.lease_to_json(lease)))

    def delete_pod(self, namespace, name, grace_period_seconds=None) -> None:
        body = None
        if grace_period_seconds is not None:
            body = {"gracePeriodSeconds": grace_period_seconds}
        self._http.request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}", body)

    def evict_pod(self, namespace, name, grace_period_seconds=None) -> None:
        body: Dict = {"apiVersion": "policy/v1", "kind": "Eviction",
                      "metadata": {"name": name, "namespace": namespace}}
        if grace_period_seconds is not None:
            body["deleteOptions"] = {
                "gracePeriodSeconds": grace_period_seconds}
        self._http.request(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{name}/eviction", body)

    def direct(self) -> "LiveClient":
        return self


class LiveEventRecorder(EventRecorder):
    """record.EventRecorder analog posting real k8s Events (the reference
    emits one per state/annotation change and drain result —
    util.go:141-153). Event objects land in the object's namespace (nodes →
    "default"). Failures are swallowed: an event is advisory, never worth
    failing a reconcile over."""

    def __init__(self, http: KubeHTTP, namespace: str = "default"):
        import itertools
        self._http = http
        self._default_ns = namespace
        self._seq = itertools.count()  # itertools.count is thread-safe

    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        import time as _time
        kind = getattr(obj, "kind", type(obj).__name__)
        meta = getattr(obj, "metadata", None)
        name = getattr(meta, "name", "")
        ns = getattr(meta, "namespace", "") or self._default_ns
        # unique across drain threads AND process restarts (client-go's
        # recorder uses a timestamp suffix for the same reason): a reused
        # name would 409 against Events persisted from a prior --once run
        uid = f"{_time.time_ns():x}.{next(self._seq)}"  # det: allow — cross-restart unique Event name
        body = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": f"{name}.{reason.lower()}.{uid}",
                         "namespace": ns},
            "involvedObject": {"kind": kind, "name": name,
                               "namespace": ns if kind != "Node" else ""},
            "type": event_type, "reason": reason, "message": message,
            "reportingComponent": "tpu-operator",
        }
        try:
            self._http.request("POST", f"/api/v1/namespaces/{ns}/events",
                               body=body)
        except Exception:  # exc: allow — events are advisory; an event POST must never fail the caller
            pass


CRD_PATH = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"


class LiveCRDClient:
    """crdutil ``CRDClient`` over a real apiserver (the apiextensions
    clientset analog — reference pkg/crdutil/crdutil.go:77-85)."""

    def __init__(self, http: KubeHTTP):
        self._http = http

    def get_crd(self, name: str) -> dict:
        return self._http.request("GET", f"{CRD_PATH}/{name}")

    def create_crd(self, crd: dict) -> dict:
        return self._http.request("POST", CRD_PATH, body=crd)

    def update_crd(self, crd: dict) -> dict:
        name = crd["metadata"]["name"]
        return self._http.request("PUT", f"{CRD_PATH}/{name}", body=crd)
