"""HTTP apiserver façade over :class:`~.fakecluster.FakeCluster`.

A copy of the JAX package's ``core/httpapi.py`` over the port's own
``FakeCluster``; the port imports nothing of that package.

The envtest analog for the wire path: serves the Kubernetes REST routes the
framework touches (nodes, pods + eviction, daemonsets, controllerrevisions,
jobs, CRDs) in real k8s JSON over real HTTP, backed by a FakeCluster. Tests
point :mod:`.liveclient` at it, so the exact client code that talks to a GKE
apiserver is exercised end-to-end — routing, JSON, patch semantics, status
codes — without a cluster in the image (SURVEY.md §8: stands in for the
kind-based e2e).

Routes (subset of the real API; reference's client-go usage maps 1:1):
  GET    /api/v1/nodes[?labelSelector=k=v,...]
  GET    /api/v1/nodes/{name}
  PATCH  /api/v1/nodes/{name}            (strategic-merge: metadata labels/
                                          annotations w/ null-deletes, spec)
  GET    /api/v1/pods | /api/v1/namespaces/{ns}/pods
           [?labelSelector=...&fieldSelector=spec.nodeName=...]
  GET    /api/v1/namespaces/{ns}/pods/{name}
  DELETE /api/v1/namespaces/{ns}/pods/{name}
  POST   /api/v1/namespaces/{ns}/pods/{name}/eviction
  GET    /apis/apps/v1/[namespaces/{ns}/]daemonsets
  GET    /apis/apps/v1/[namespaces/{ns}/]controllerrevisions
  GET    /apis/batch/v1/namespaces/{ns}/jobs/{name}
  GET/POST  /apis/apiextensions.k8s.io/v1/customresourcedefinitions
  GET/PUT   /apis/apiextensions.k8s.io/v1/customresourcedefinitions/{name}

Optional bearer-token auth (`token=`): requests must carry
``Authorization: Bearer <token>`` — exercising the client's auth header.
"""

from __future__ import annotations

import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..utils import threads
from . import serde
from .client import ConflictError, InvalidError
from .fakecluster import FakeCluster

_TO_JSON = {"Node": serde.node_to_json, "Pod": serde.pod_to_json,
            "DaemonSet": serde.daemonset_to_json,
            "ControllerRevision": serde.controller_revision_to_json,
            "Job": serde.job_to_json}


_SET_REQ_RE = re.compile(
    r"^([A-Za-z0-9._/-]+)\s+(in|notin)\s+\(\s*([^()]*?)\s*\)$")
_KEY_RE = re.compile(r"^!?[A-Za-z0-9._/-]+$")


def _split_requirements(raw: str):
    """Split a selector on commas NOT inside parentheses — `a in (x,y),b=c`
    is two requirements."""
    parts, depth, cur = [], 0, []
    for ch in raw:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _parse_label_selector(qs: Dict):
    """The real apiserver's label-selector grammar (labels.Parse):
    equality (`k=v`, `k==v`, `k!=v`), set (`k in (a,b)`, `k notin (a)`),
    and existence (`k`, `!k`) requirements, comma-conjoined. Returns a list
    of (key, op, values) requirements (None = no selector); raises
    ValueError on malformed input — the route maps that to the real
    apiserver's 400."""
    raw = qs.get("labelSelector", [None])[0]
    if not raw:
        return None
    reqs = []
    for part in _split_requirements(raw):
        m = _SET_REQ_RE.match(part)
        if m:
            vals = [v.strip() for v in m.group(3).split(",") if v.strip()]
            if not vals:
                # labels.Parse: "for 'in', 'notin' operators, values set
                # can't be empty" — a silent match-all here would hide
                # client bugs a real cluster 400s
                raise ValueError(f"unable to parse requirement {part!r}: "
                                 "values set can't be empty")
            reqs.append((m.group(1), m.group(2), vals))
            continue
        if "!=" in part:
            k, _, v = part.partition("!=")
            k, v = k.strip(), v.strip()
            if not _KEY_RE.match(k) or k.startswith("!"):
                raise ValueError(f"unable to parse requirement: {part!r}")
            reqs.append((k, "neq", [v]))
            continue
        if "=" in part:
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip().lstrip("=").strip()
            if not _KEY_RE.match(k) or k.startswith("!"):
                raise ValueError(f"unable to parse requirement: {part!r}")
            reqs.append((k, "eq", [v]))
            continue
        if _KEY_RE.match(part):
            if part.startswith("!"):
                reqs.append((part[1:], "nexists", []))
            else:
                reqs.append((part, "exists", []))
            continue
        raise ValueError(f"unable to parse requirement: {part!r}")
    return reqs


def _match_selector(labels: Dict[str, str], reqs) -> bool:
    """Real matching semantics worth pinning: `!=` and `notin` also match
    objects that LACK the key; `in`/`=` require it present."""
    labels = labels or {}
    for key, op, vals in reqs:
        if op == "eq" and labels.get(key) != vals[0]:
            return False
        if op == "neq" and key in labels and labels[key] == vals[0]:
            return False
        if op == "in" and labels.get(key) not in vals:
            return False
        if op == "notin" and key in labels and labels[key] in vals:
            return False
        if op == "exists" and key not in labels:
            return False
        if op == "nexists" and key in labels:
            return False
    return True


_FIELD_GETTERS = {
    "metadata.name": lambda o: o.metadata.name,
    "metadata.namespace": lambda o: o.metadata.namespace,
    "spec.nodeName": lambda o: getattr(o.spec, "node_name", ""),
    "status.phase": lambda o: getattr(getattr(o, "status", None),
                                      "phase", ""),
}


def _apply_field_selector(objs, raw: Optional[str]):
    """Comma-conjoined `field=value` / `field!=value` terms over the small
    set of fields the real apiserver indexes. Unsupported fields raise
    ValueError → 400 ('field label not supported'), matching a real
    apiserver rather than silently returning everything."""
    if not raw:
        return objs
    for term in raw.split(","):
        term = term.strip()
        if not term:
            continue
        if "!=" in term:
            field, _, want = term.partition("!=")
            neq = True
        else:
            field, _, want = term.partition("=")
            neq = False
        field = field.strip()
        if field not in _FIELD_GETTERS:
            raise ValueError(f'field label not supported: "{field}"')
        getter = _FIELD_GETTERS[field]
        objs = [o for o in objs
                if (getter(o) != want if neq else getter(o) == want)]
    return objs


class _Handler(BaseHTTPRequestHandler):
    # quiet: the test suite doesn't want per-request stderr lines
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -------------------------------------------------------- plumbing

    @property
    def cluster(self) -> FakeCluster:
        return self.server.cluster  # type: ignore[attr-defined]

    def _authorized(self) -> bool:
        token = self.server.token  # type: ignore[attr-defined]
        if not token:
            return True
        return self.headers.get("Authorization") == f"Bearer {token}"

    def _send(self, code: int, body: Dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, reason: str, message: str) -> None:
        self._send(code, {"kind": "Status", "apiVersion": "v1",
                          "status": "Failure", "reason": reason,
                          "code": code, "message": message})

    def _body(self) -> Dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def _list(self, kind: str, namespace: Optional[str], qs: Dict) -> None:
        try:
            reqs = _parse_label_selector(qs)
            # snapshot + RV atomically: a separate current_rv() read could
            # postdate the snapshot and make the watch skip the gap forever
            objs, rv = self.cluster.list_with_rv(kind, namespace=namespace)
            if reqs:
                objs = [o for o in objs
                        if _match_selector(o.metadata.labels, reqs)]
            objs = _apply_field_selector(
                objs, qs.get("fieldSelector", [None])[0])
        except ValueError as exc:
            return self._error(400, "BadRequest", str(exc))
        self._send(200, serde.list_to_json(
            kind, [_TO_JSON[kind](o) for o in objs], resource_version=rv))

    def _get_one(self, kind: str, namespace: str, name: str) -> None:
        try:
            obj = self.cluster.get(kind, namespace, name)
        except KeyError:
            return self._error(404, "NotFound", f"{kind} {name} not found")
        self._send(200, _TO_JSON[kind](obj))

    # -------------------------------------------------------- dispatch

    def _route(self, method: str) -> None:  # noqa: C901
        if not self._authorized():
            return self._error(401, "Unauthorized", "bearer token required")
        url = urlparse(self.path)
        path, qs = url.path.rstrip("/"), parse_qs(url.query)
        crd_base = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"

        m = re.fullmatch(r"/api/v1/nodes", path)
        if m and method == "GET":
            if qs.get("watch", ["false"])[0] == "true":
                return self._watch("Node", None, qs)
            return self._list("Node", None, qs)
        m = re.fullmatch(r"/api/v1/nodes/([^/]+)", path)
        if m and method == "GET":
            return self._get_one("Node", "", m.group(1))
        if m and method == "PATCH":
            return self._patch_node(m.group(1), self._body())
        m = re.fullmatch(r"/api/v1(?:/namespaces/([^/]+))?/pods", path)
        if m and method == "GET":
            if qs.get("watch", ["false"])[0] == "true":
                return self._watch("Pod", m.group(1), qs)
            return self._list("Pod", m.group(1), qs)
        if m and method == "POST" and m.group(1):
            return self._create_pod(m.group(1), self._body())
        m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/pods/([^/]+)", path)
        if m and method == "GET":
            return self._get_one("Pod", m.group(1), m.group(2))
        if m and method == "DELETE":
            return self._delete_pod(m.group(1), m.group(2))
        m = re.fullmatch(
            r"/api/v1/namespaces/([^/]+)/pods/([^/]+)/eviction", path)
        if m and method == "POST":
            return self._delete_pod(m.group(1), m.group(2), evict=True)
        m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/services", path)
        if m and method == "POST":
            return self._create_service(m.group(1), self._body())
        m = re.fullmatch(
            r"/apis/coordination\.k8s\.io/v1/namespaces/([^/]+)/leases",
            path)
        if m and method == "POST":
            return self._create_lease(m.group(1), self._body())
        m = re.fullmatch(
            r"/apis/coordination\.k8s\.io/v1/namespaces/([^/]+)/leases/([^/]+)",
            path)
        if m and method == "GET":
            return self._get_lease(m.group(1), m.group(2))
        if m and method == "PUT":
            return self._update_lease(m.group(1), m.group(2), self._body())
        m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/events", path)
        if m and method == "POST":
            return self._record_event(self._body())
        m = re.fullmatch(
            r"/apis/apps/v1(?:/namespaces/([^/]+))?/daemonsets", path)
        if m and method == "GET":
            if qs.get("watch", ["false"])[0] == "true":
                return self._watch("DaemonSet", m.group(1), qs)
            return self._list("DaemonSet", m.group(1), qs)
        m = re.fullmatch(
            r"/apis/apps/v1(?:/namespaces/([^/]+))?/controllerrevisions",
            path)
        if m and method == "GET":
            return self._list("ControllerRevision", m.group(1), qs)
        m = re.fullmatch(r"/apis/batch/v1/namespaces/([^/]+)/jobs/([^/]+)",
                         path)
        if m and method == "GET":
            return self._get_one("Job", m.group(1), m.group(2))
        if path == crd_base and method == "GET":
            return self._send(200, serde.list_to_json(
                "CustomResourceDefinition", self.cluster.list_crds()))
        if path == crd_base and method == "POST":
            return self._crd_create(self._body())
        m = re.fullmatch(re.escape(crd_base) + r"/([^/]+)", path)
        if m and method == "GET":
            try:
                return self._send(200, self.cluster.get_crd(m.group(1)))
            except KeyError:
                return self._error(404, "NotFound",
                                   f"CRD {m.group(1)} not found")
        if m and method == "PUT":
            return self._crd_update(self._body())
        self._error(404, "NotFound", f"no route for {method} {path}")

    # ---------------------------------------------------------- writes

    def _patch_node(self, name: str, patch: Dict) -> None:
        client = self.cluster.client.direct()
        try:
            # taints FIRST: it is the only sub-patch that can fail
            # validation, and the real apiserver validates the merged
            # object atomically — a 422 must leave the node fully
            # untouched, so the validating operation runs before any
            # other mutation lands
            spec = patch.get("spec") or {}
            node = self.cluster.get("Node", "", name)
            if "taints" in spec:
                if spec["taints"] is None:
                    # explicit JSON null deletes the FIELD (clears the
                    # list) — same SMP edge as the null-map handling below
                    node = client.patch_node_taints(
                        name, [{"$patch": "delete", "key": t.key}
                               for t in node.spec.taints])
                else:
                    # list field with patchStrategy=merge/patchMergeKey=
                    # key — merge-by-key + $patch:delete, NOT replace
                    node = client.patch_node_taints(name, spec["taints"])
            meta = patch.get("metadata") or {}
            labels, annotations = meta.get("labels"), meta.get("annotations")
            # strategic-merge edge: an explicit JSON null for the whole MAP
            # clears it on a real apiserver (distinct from per-key nulls,
            # which delete individual keys)
            if "labels" in meta and labels is None:
                cur = self.cluster.get("Node", "", name)
                labels = {k: None for k in cur.metadata.labels}
            if "annotations" in meta and annotations is None:
                cur = self.cluster.get("Node", "", name)
                annotations = {k: None for k in cur.metadata.annotations}
            if "labels" in meta or "annotations" in meta:
                node = client.patch_node_metadata(
                    name, labels=labels, annotations=annotations)
            if "unschedulable" in spec:
                node = client.patch_node_unschedulable(
                    name, bool(spec["unschedulable"]))
        except KeyError:
            return self._error(404, "NotFound", f"node {name} not found")
        except InvalidError as exc:
            return self._error(422, "Invalid", str(exc))
        self._send(200, serde.node_to_json(node))

    def _create_pod(self, ns: str, body: Dict) -> None:
        pod = serde.pod_from_json(body)
        pod.metadata.namespace = ns
        try:
            # route through the direct client (same create semantics as the
            # in-process path — one definition of pod creation)
            created = self.cluster.client.direct().create_pod(pod)
        except ConflictError as exc:
            return self._error(409, "AlreadyExists", str(exc))
        self._send(201, serde.pod_to_json(created))

    def _get_lease(self, ns: str, name: str) -> None:
        try:
            lease = self.cluster.client.direct().get_lease(ns, name)
        except KeyError:
            return self._error(404, "NotFound",
                               f"lease {ns}/{name} not found")
        self._send(200, serde.lease_to_json(lease))

    _MICROTIME_RE = re.compile(
        r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{6}Z$")

    def _check_lease_microtime(self, body: Dict) -> bool:
        """Real-apiserver strictness: LeaseSpec acquireTime/renewTime are
        metav1.MicroTime and MUST carry exactly six fractional digits
        (RFC3339Micro). client-go and kubectl always emit that format;
        second-precision values are rejected with 400, as a real cluster
        rejects a client that serializes lease times to the second."""
        spec = body.get("spec") or {}
        for field in ("acquireTime", "renewTime"):
            val = spec.get(field)
            if val is not None and not self._MICROTIME_RE.match(str(val)):
                self._error(
                    400, "BadRequest",
                    f'unable to decode spec.{field}: parsing time "{val}" '
                    f'as "2006-01-02T15:04:05.000000Z07:00": cannot parse '
                    f'"{str(val)[19:]}" as ".000000"')
                return False
        return True

    def _create_lease(self, ns: str, body: Dict) -> None:
        if not self._check_lease_microtime(body):
            return
        lease = serde.lease_from_json(body)
        lease.metadata.namespace = ns
        try:
            created = self.cluster.client.direct().create_lease(lease)
        except ConflictError as exc:
            return self._error(409, "AlreadyExists", str(exc))
        self._send(201, serde.lease_to_json(created))

    def _update_lease(self, ns: str, name: str, body: Dict) -> None:
        if not self._check_lease_microtime(body):
            return
        lease = serde.lease_from_json(body)
        lease.metadata.namespace = ns
        lease.metadata.name = name
        try:
            updated = self.cluster.client.direct().update_lease(lease)
        except ConflictError as exc:
            return self._error(409, "Conflict", str(exc))
        except KeyError:
            return self._error(404, "NotFound",
                               f"lease {ns}/{name} not found")
        self._send(200, serde.lease_to_json(updated))

    def _create_service(self, ns: str, body: Dict) -> None:
        svc = serde.service_from_json(body)
        svc.metadata.namespace = ns
        try:
            created = self.cluster.client.direct().create_service(svc)
        except ConflictError as exc:
            return self._error(409, "AlreadyExists", str(exc))
        self._send(201, serde.service_to_json(created))

    def _delete_pod(self, ns: str, name: str, evict: bool = False) -> None:
        try:
            self.cluster.get("Pod", ns, name)
        except KeyError:
            # a real apiserver 404s a missing pod before consulting PDBs
            return self._error(404, "NotFound", f"pod {ns}/{name} not found")
        if evict and self.cluster.consume_eviction_block(ns, name):
            # the apiserver's PDB response to a blocked eviction
            return self._error(429, "TooManyRequests",
                               f"Cannot evict pod {ns}/{name}: disruption "
                               "budget would be violated")
        try:
            self.cluster.delete("Pod", ns, name)
        except KeyError:
            return self._error(404, "NotFound", f"pod {ns}/{name} not found")
        self._send(200, {"kind": "Status", "status": "Success"})

    def _watch(self, kind: str, namespace: Optional[str], qs: Dict) -> None:
        """Streaming watch: one JSON object per line, connection held open
        until ``timeoutSeconds`` (default 30) or client disconnect — the
        real apiserver's chunked watch shape (client-go reconnects on
        timeout; so does our client).

        Resume protocol: ``resourceVersion=N`` replays buffered events with
        RV > N before streaming live ones; a version older than the replay
        window gets the real apiserver's 410 Gone as an ERROR event.
        ``allowWatchBookmarks=true`` emits a BOOKMARK carrying the current
        collection RV at window end, so an idle client's resume point stays
        fresh."""
        import json as _json
        import queue as _queue
        import time as _time

        from .client import ExpiredError
        try:
            reqs = _parse_label_selector(qs)
        except ValueError as exc:
            return self._error(400, "BadRequest", str(exc))
        timeout = float(qs.get("timeoutSeconds", ["30"])[0])
        rv_param = qs.get("resourceVersion", [None])[0]
        bookmarks = qs.get("allowWatchBookmarks", ["false"])[0] == "true"

        def matches(ekind, obj) -> bool:
            if ekind != kind:
                return False
            if namespace is not None and obj.metadata.namespace != namespace:
                return False
            return not reqs or _match_selector(obj.metadata.labels, reqs)

        def write_line(payload: Dict) -> None:
            self.wfile.write(_json.dumps(payload).encode() + b"\n")
            self.wfile.flush()

        q = self.cluster.subscribe()  # subscribe BEFORE replay: no gap
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.flush()
            # events already in the replay buffer are also about to arrive
            # on the queue if they raced the subscribe; dedup by RV floor.
            # max_seen tracks the highest RV OBSERVED on this stream
            # (replayed or dequeued, matching or not) — the only safe
            # bookmark value: the global current_rv() could exceed events
            # still sitting undelivered in our queue, and bookmarking past
            # them would skip them forever.
            max_seen = 0
            if rv_param and rv_param != "0":
                try:
                    events = self.cluster.events_since(rv_param)
                except ExpiredError as exc:
                    write_line({"type": "ERROR", "object": {
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure", "reason": "Expired",
                        "code": 410, "message": str(exc)}})
                    return
                max_seen = int(rv_param)
                for etype, ekind, obj in events:
                    rv = int(obj.metadata.resource_version)
                    max_seen = max(max_seen, rv)
                    if matches(ekind, obj):
                        write_line({"type": etype,
                                    "object": _TO_JSON[kind](obj)})
            replayed_past = max_seen
            # det: allow — a REAL HTTP long-poll deadline on a live
            # socket thread; the chaos-replayed surface drives the
            # client boundary, never this server loop
            deadline = _time.monotonic() + timeout  # det: allow — real socket deadline
            while True:
                remaining = deadline - _time.monotonic()  # det: allow — real socket deadline
                if remaining <= 0:
                    break
                try:
                    etype, ekind, obj = q.get(timeout=min(remaining, 0.25))
                except _queue.Empty:
                    continue
                try:
                    rv = int(obj.metadata.resource_version)
                except (TypeError, ValueError):
                    rv = None
                if rv is not None:
                    if rv <= replayed_past:
                        continue  # already replayed from the buffer
                    max_seen = max(max_seen, rv)
                if not matches(ekind, obj):
                    continue
                write_line({"type": etype, "object": _TO_JSON[kind](obj)})
            if bookmarks and max_seen > 0:
                write_line({"type": "BOOKMARK", "object": {
                    "kind": kind,
                    "metadata": {"resourceVersion": str(max_seen)}}})
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up — normal watch termination
        finally:
            self.cluster.unsubscribe(q)
            self.close_connection = True

    def _record_event(self, ev: Dict) -> None:
        from .objects import Event
        # real apiserver semantics: Event names must be unique; a recorder
        # that reuses names (e.g. a resettable counter) must see the 409
        name = (ev.get("metadata") or {}).get("name", "")
        with self.server.event_lock:  # type: ignore[attr-defined]
            seen = self.server.event_names  # type: ignore[attr-defined]
            if name in seen:
                return self._error(409, "AlreadyExists",
                                   f"events \"{name}\" already exists")
            seen.add(name)
        inv = ev.get("involvedObject") or {}
        self.cluster.recorder.record(Event(
            object_kind=inv.get("kind", ""),
            object_name=inv.get("name", ""),
            event_type=ev.get("type", "Normal"),
            reason=ev.get("reason", ""),
            message=ev.get("message", "")))
        self._send(201, ev)

    def _crd_create(self, crd: Dict) -> None:
        try:
            self._send(201, self.cluster.create_crd(crd))
        except ConflictError as exc:
            self._error(409, "AlreadyExists", str(exc))

    def _crd_update(self, crd: Dict) -> None:
        try:
            self._send(200, self.cluster.update_crd(crd))
        except KeyError as exc:
            self._error(404, "NotFound", str(exc))
        except ConflictError as exc:
            self._error(409, "Conflict", str(exc))

    # http.server entry points
    def do_GET(self):     # noqa: N802
        self._route("GET")

    def do_POST(self):    # noqa: N802
        self._route("POST")

    def do_PUT(self):     # noqa: N802
        self._route("PUT")

    def do_PATCH(self):   # noqa: N802
        self._route("PATCH")

    def do_DELETE(self):  # noqa: N802
        self._route("DELETE")


class FakeAPIServer:
    """Threaded HTTP apiserver over a FakeCluster. Use as a context manager
    or call start()/stop(); ``base_url`` is http://127.0.0.1:{port}."""

    def __init__(self, cluster: FakeCluster, token: Optional[str] = None):
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._server.cluster = cluster          # type: ignore[attr-defined]
        self._server.token = token              # type: ignore[attr-defined]
        self._server.event_names = set()        # type: ignore[attr-defined]
        self._server.event_lock = threads.make_lock(  # type: ignore[attr-defined]
            "fake-apiserver-events")
        self._thread = threads.spawn("fake-apiserver",
                                     self._server.serve_forever, start=False)

    @property
    def base_url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FakeAPIServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "FakeAPIServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
