"""The port's apiserver client (``core/liveclient.py``) and its object
model (``core/objects.py``, ``core/serde.py``) against the JAX
package's, over the reference's ``FakeAPIServer(FakeCluster)``.

Each call runs through the reference's ``LiveClient`` and the port's on
the same cluster; the objects they return are compared field for field
(``dataclasses.asdict``: both models spell every field alike). The
port's errors are its own ``ApiError`` family, so the serving tier's
``except ApiError`` catches them; the reference's are not.
"""

import dataclasses
import json
import socket
import sys

import pytest
import yaml

from k8s_operator_libs_tpu.core import serde as jserde
from k8s_operator_libs_tpu.core.client import ApiError as JApiError
from k8s_operator_libs_tpu.core.fakecluster import FakeCluster
from k8s_operator_libs_tpu.core.httpapi import FakeAPIServer
from k8s_operator_libs_tpu.core.liveclient import KubeConfig as JKubeConfig
from k8s_operator_libs_tpu.core.liveclient import KubeHTTP as JKubeHTTP
from k8s_operator_libs_tpu.core.liveclient import LiveClient as JLiveClient
from k8s_operator_libs_tpu_torch.core import client as tclient
from k8s_operator_libs_tpu_torch.core import serde as tserde
from k8s_operator_libs_tpu_torch.core.client import ApiError as TApiError
from k8s_operator_libs_tpu_torch.core.liveclient import (KubeConfig,
                                                         KubeHTTP,
                                                         LiveClient,
                                                         LiveEventRecorder)
from k8s_operator_libs_tpu_torch.core.objects import Taint


def _seed(cluster):
    ds = cluster.add_daemonset("libtpu", namespace="tpu",
                               labels={"app": "d"}, revision_hash="v1")
    for i in range(2):
        cluster.add_node(f"n{i}", labels={"pool": "tpu", "i": str(i)})
        cluster.add_pod(f"d-{i}", f"n{i}", namespace="tpu", owner_ds=ds,
                        revision_hash="v1")
    cluster.add_node("other")
    return ds


@pytest.fixture
def live():
    """(cluster, the reference's client, the port's) over one apiserver."""
    cluster = FakeCluster()
    _seed(cluster)
    with FakeAPIServer(cluster) as srv:
        yield (cluster,
               JLiveClient(JKubeHTTP(JKubeConfig(server=srv.base_url))),
               LiveClient(KubeHTTP(KubeConfig(server=srv.base_url))))


# the fields a cluster mints per object: equal only within one cluster
MINTED = ("uid", "resource_version", "creation_timestamp")


def _fields(obj, strip=()):
    out = dataclasses.asdict(obj)
    for key in strip:
        out["metadata"].pop(key, None)
    return out


def _same(a, b, strip=()):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, strip)
        return
    assert type(a).__name__ == type(b).__name__
    assert _fields(a, strip) == _fields(b, strip)


# -------------------------------------------------------------- reads

READS = {
    "list_nodes": lambda c: c.list_nodes(),
    "list_nodes_selected": lambda c: c.list_nodes(
        label_selector={"pool": "tpu"}),
    "get_node": lambda c: c.get_node("n1"),
    "list_pods": lambda c: c.list_pods(namespace="tpu"),
    "list_pods_on_node": lambda c: c.list_pods(namespace="tpu",
                                               field_node_name="n1"),
    "get_pod": lambda c: c.get_pod("tpu", "d-0"),
    "list_daemonsets": lambda c: c.list_daemonsets(namespace="tpu"),
    "list_controller_revisions":
        lambda c: c.list_controller_revisions(namespace="tpu"),
    "direct_get_node": lambda c: c.direct().get_node("n0"),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_return_the_reference_objects(live, name):
    _, jcli, tcli = live
    _same(READS[name](jcli), READS[name](tcli))


# ------------------------------------------------------------- writes

WRITES = {
    "labels_and_annotations": lambda c: c.patch_node_metadata(
        "n0", labels={"state": "cordon-required"},
        annotations={"why": "upgrade", "keep": "1"}),
    "null_deletes": lambda c: (
        c.patch_node_metadata("n0", labels={"state": "x"},
                              annotations={"a": "1", "b": "2"}),
        c.patch_node_metadata("n0", labels={"state": None},
                              annotations={"a": None, "zz": None}))[-1],
    "unschedulable": lambda c: c.patch_node_unschedulable("n1", True),
    "taints": lambda c: (
        c.patch_node_taints("n1", [{"key": "k", "value": "v",
                                    "effect": "NoSchedule"}]),
        c.patch_node_taints("n1", [{"key": "k", "value": "w",
                                    "effect": "NoSchedule"},
                                   {"key": "j", "effect": "NoExecute"}]),
        c.patch_node_taints("n1", [{"$patch": "delete", "key": "k"}]))[-1],
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_writes_land_as_the_reference_writes(name):
    """The same patch through each client, on a cluster of its own: the
    returned node and the node stored on the cluster are equal."""
    out, stored = [], []
    for make in (JLiveClient, LiveClient):
        cluster = FakeCluster()
        _seed(cluster)
        with FakeAPIServer(cluster) as srv:
            cfg = (JKubeConfig if make is JLiveClient else KubeConfig)(
                server=srv.base_url)
            http = (JKubeHTTP if make is JLiveClient else KubeHTTP)(cfg)
            out.append(WRITES[name](make(http)))
        stored.append([_fields(n, MINTED) for n in cluster.client.direct()
                       .list_nodes()])
    _same(out[0], out[1], MINTED)
    assert stored[0] == stored[1]


def test_pod_delete_evict_and_events(live):
    cluster, _, cli = live
    cli.evict_pod("tpu", "d-1", grace_period_seconds=5)
    cli.delete_pod("tpu", "d-0")
    assert cli.list_pods(namespace="tpu") == []
    node = cli.get_node("n0")
    tclient.ClientEventRecorder(cli).event(node, "Normal", "Drain", "m1")
    LiveEventRecorder(cli.http).event(node, "Warning", "Stuck", "m2")
    got = [(e.object_kind, e.object_name, e.event_type, e.reason, e.message)
           for e in cluster.recorder.events
           if e.reason in ("Drain", "Stuck")]
    assert got == [("Node", "n0", "Normal", "Drain", "m1"),
                   ("Node", "n0", "Warning", "Stuck", "m2")]


def test_watch_nodes_streams_typed_events(live):
    import threading
    import time

    cluster, _, cli = live
    got = []
    done = threading.Event()

    def consume():
        for etype, node in cli.watch_nodes(label_selector={"pool": "tpu"},
                                           timeout_seconds=5):
            got.append((etype, node.metadata.name,
                        node.metadata.labels.get("state")))
            if len(got) >= 2:
                break
        done.set()

    threading.Thread(target=consume, daemon=True).start()
    deadline = time.monotonic() + 10
    while not cluster._watchers and time.monotonic() < deadline:
        time.sleep(0.02)
    cli.patch_node_metadata("n0", labels={"state": "a"})
    cli.patch_node_metadata("other", labels={"state": "x"})
    cli.patch_node_metadata("n0", labels={"state": "b"})
    assert done.wait(10), got
    assert got == [("MODIFIED", "n0", "a"), ("MODIFIED", "n0", "b")]


# ------------------------------------------------------------- errors


def _taint_without_effect(c):
    c.patch_node_taints("n0", [{"key": "k", "value": "v", "effect": ""}])


def _duplicate_event(c):
    body = {"metadata": {"name": "fixed", "namespace": "default"},
            "involvedObject": {"kind": "Node", "name": "n0"},
            "type": "Normal", "reason": "R", "message": "m"}
    c.http.request("POST", "/api/v1/namespaces/default/events", body=body)
    c.http.request("POST", "/api/v1/namespaces/default/events", body=body)


def _blocked_eviction(c, cluster):
    cluster.block_eviction("tpu", "d-0", times=1)
    c.evict_pod("tpu", "d-0")


ERRORS = {
    "not_found": (lambda c, cl: c.get_node("missing"), "NotFoundError"),
    "conflict": (lambda c, cl: _duplicate_event(c), "ConflictError"),
    "invalid": (lambda c, cl: _taint_without_effect(c), "InvalidError"),
    "too_many_requests": (_blocked_eviction, "TooManyRequestsError"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_are_the_ports_own_classes(live, name):
    """The same failing call raises the same class name in both
    packages; the port's is a subclass of the port's ``ApiError`` and of
    nothing of the reference's family."""
    cluster, jcli, tcli = live
    fn, cls = ERRORS[name]
    with pytest.raises(JApiError) as jerr:
        fn(jcli, cluster)
    cluster2 = FakeCluster()
    _seed(cluster2)
    with FakeAPIServer(cluster2) as srv:
        cli = LiveClient(KubeHTTP(KubeConfig(server=srv.base_url)))
        with pytest.raises(TApiError) as terr:
            fn(cli, cluster2)
    assert type(jerr.value).__name__ == type(terr.value).__name__ == cls
    assert type(terr.value) is getattr(tclient, cls)
    assert not isinstance(terr.value, JApiError)
    assert str(jerr.value) == str(terr.value)


def test_not_found_is_also_a_key_error(live):
    _, _, cli = live
    with pytest.raises(KeyError):
        cli.get_node("missing")


def test_unauthorized_and_unreachable_raise_api_errors():
    cluster = FakeCluster()
    cluster.add_node("n0")
    with FakeAPIServer(cluster, token="sekrit") as srv:
        denied = LiveClient(KubeHTTP(KubeConfig(server=srv.base_url)))
        with pytest.raises(TApiError, match="401"):
            denied.list_nodes()
        ok = LiveClient(KubeHTTP(KubeConfig(server=srv.base_url,
                                            token="sekrit")))
        assert [n.metadata.name for n in ok.list_nodes()] == ["n0"]
    # a port nothing listens on: refused, no answer at all
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    gone = LiveClient(KubeHTTP(KubeConfig(server=f"http://127.0.0.1:{port}")))
    with pytest.raises(tclient.ServerError, match="unreachable"):
        gone.get_node("n0")
    assert issubclass(tclient.ServerError, TApiError)
    assert issubclass(tclient.WatchError, TApiError)
    assert issubclass(TApiError, RuntimeError)


# -------------------------------------------------------------- serde


def _cluster_objects():
    cluster = FakeCluster()
    ds = _seed(cluster)
    cluster.bump_daemonset_revision("libtpu", "tpu", "v2")
    direct = cluster.client.direct()
    direct.patch_node_unschedulable("n1", True)
    direct.patch_node_metadata("n0", annotations={"a": "b"})
    direct.patch_node_taints("n0", [{"key": "k", "value": "v",
                                     "effect": "NoSchedule"}])
    cluster.set_pod_status("tpu", "d-0", phase="Succeeded")
    out = [("node", n) for n in direct.list_nodes()]
    out += [("pod", p) for p in direct.list_pods()]
    out += [("daemonset", ds)]
    out += [("controller_revision", r)
            for r in direct.list_controller_revisions()]
    return out


@pytest.mark.parametrize("kind", ["node", "pod", "daemonset",
                                  "controller_revision"])
def test_serde_round_trips_the_reference_objects(kind):
    """A reference object to JSON (reference serde), back through the
    port's serde and out again: the same fields as the reference's own
    round trip, and the same JSON."""
    objs = [o for k, o in _cluster_objects() if k == kind]
    assert objs
    for obj in objs:
        wire = getattr(jserde, f"{kind}_to_json")(obj)
        ref = getattr(jserde, f"{kind}_from_json")(wire)
        got = getattr(tserde, f"{kind}_from_json")(wire)
        assert _fields(ref, ("uid",)) == _fields(got, ("uid",))
        assert getattr(tserde, f"{kind}_to_json")(got) == wire


def test_serde_round_trips_leases_services_and_jobs():
    from k8s_operator_libs_tpu.core import objects as jo
    from k8s_operator_libs_tpu_torch.core import objects as to

    cases = (
        ("lease", lambda m: m.Lease(
            metadata=m.ObjectMeta(name="l", namespace="ns"),
            spec=m.LeaseSpec(holder_identity="me", acquire_time=12.5,
                             renew_time=13.25, lease_transitions=2))),
        ("service", lambda m: m.Service(
            metadata=m.ObjectMeta(name="s"),
            spec=m.ServiceSpec(cluster_ip="None", selector={"a": "b"},
                               ports=[m.ServicePort(name="p", port=80)]))),
        ("job", lambda m: m.Job(metadata=m.ObjectMeta(name="j"),
                                status=m.JobStatus(active=1, succeeded=2,
                                                   failed=3))),
    )
    def minted_out(wire):
        out = json.loads(json.dumps(wire))
        for key in ("uid", "creationTimestamp"):
            out["metadata"].pop(key, None)
        return out

    for kind, make in cases:
        wire = getattr(jserde, f"{kind}_to_json")(make(jo))
        assert minted_out(getattr(tserde, f"{kind}_to_json")(make(to))) == \
            minted_out(wire)
        ref = getattr(jserde, f"{kind}_from_json")(wire)
        got = getattr(tserde, f"{kind}_from_json")(wire)
        assert _fields(ref, ("uid",)) == _fields(got, ("uid",)), kind
    assert Taint().effect == "NoSchedule"


# --------------------------------------------------------- kubeconfig


def _kubeconfig(tmp_path, user, cluster=None, fmt="yaml"):
    cfg = {
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl",
                                               "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": cluster or {
            "server": "https://example:6443/"}}],
        "users": [{"name": "u", "user": user}],
    }
    path = tmp_path / f"kubeconfig.{fmt}"
    path.write_text(yaml.safe_dump(cfg) if fmt == "yaml"
                    else json.dumps(cfg))
    return str(path)


USERS = {
    "token": ({"token": "sekret"}, None),
    "cert_files": ({"client-certificate": "/c.pem", "client-key": "/k.pem"},
                   {"server": "https://example:6443",
                    "certificate-authority": "/ca.pem"}),
    "insecure_http": ({}, {"server": "http://127.0.0.1:8001",
                           "insecure-skip-tls-verify": True}),
}


@pytest.mark.parametrize("fmt", ["yaml", "json"])
@pytest.mark.parametrize("user", sorted(USERS))
def test_kubeconfig_equals_the_reference(tmp_path, user, fmt):
    u, cluster = USERS[user]
    path = _kubeconfig(tmp_path, u, cluster, fmt)
    assert dataclasses.asdict(KubeConfig.from_kubeconfig(path)) == \
        dataclasses.asdict(JKubeConfig.from_kubeconfig(path))


def test_kubeconfig_inline_data_is_written_to_files(tmp_path):
    import base64
    data = base64.b64encode(b"PEM").decode()
    path = _kubeconfig(tmp_path, {"client-certificate-data": data,
                                  "client-key-data": data})
    kc = KubeConfig.from_kubeconfig(path)
    for f in (kc.client_cert_file, kc.client_key_file):
        with open(f, "rb") as fh:
            assert fh.read() == b"PEM"


def test_json_kubeconfig_needs_no_pyyaml(tmp_path, monkeypatch):
    """With PyYAML unimportable, a JSON kubeconfig still loads; a YAML
    one needs it."""
    json_path = _kubeconfig(tmp_path, {"token": "t"}, fmt="json")
    yaml_path = _kubeconfig(tmp_path, {"token": "t"}, fmt="yaml")
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert KubeConfig.from_kubeconfig(json_path).token == "t"
    with pytest.raises(ImportError):
        KubeConfig.from_kubeconfig(yaml_path)


def test_kubeconfig_without_credentials_fails_fast(tmp_path):
    with pytest.raises(RuntimeError, match="no usable credentials"):
        KubeConfig.from_kubeconfig(_kubeconfig(tmp_path, {}))
