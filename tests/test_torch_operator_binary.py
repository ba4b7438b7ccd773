"""The port's operator binary (``python -m k8s_operator_libs_tpu_torch.
operator``) held against the JAX package's ``cmd/operator.py``.

1. The reference's own tests of the binary run on the port through
   :mod:`torch_twin`, over the port's ``FakeAPIServer``: from
   ``tests/test_liveclient.py`` the ``--once`` upgrade with
   ``--ensure-crds``, metrics and shutdown, the loud failure against an
   unreachable apiserver, events, ``--watch`` without resync, the
   leader handover and the standby's ``/healthz``; from
   ``tests/test_obs_metrics.py`` the simulated operator's exposition
   through ``render_metrics`` (its TPU slice recast as an H100 clique)
   and the binary's identity gauges and trace; from
   ``tests/test_health_e2e.py`` the YAML ``health:`` section; from
   ``tests/test_market.py`` the ``/market`` envelope.
2. Tick by tick: identically seeded clusters, each behind its own
   package's ``FakeAPIServer``, are reconciled by ``cmd/operator.py
   --once`` and by the port's binary, with each package's clock frozen
   to a fake one; after every tick node labels, annotations, taints,
   cordons, events and leases are compared with ``==`` (under the name
   map of ``tests/torch_operator_twin.py``), and so are the billing
   ledgers; the ``/metrics`` family set and the ``/slo``, ``/alerts``,
   ``/usage`` and ``/profile`` bodies' keys at the end.
3. The flags and defaults equal the reference's, and ``python -m`` runs
   the binary without JAX.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from torch_operator_twin import NS, TICK, Twin, add_ds, first_difference
from torch_twin import (PORT, REFERENCE, argparse_actions,
                        load_reference_binary, reference_tests)

REPO = Path(__file__).resolve().parent.parent

# ------------------------------------------------ the reference's tests

_LIVE = reference_tests("test_liveclient.py",
                        binaries=["operator", "apply_crds"])
for _name in ("test_operator_binary_once_drives_upgrade",
              "test_operator_binary_metrics_and_shutdown",
              "test_operator_binary_once_fails_loudly_when_unreachable",
              "test_live_event_recorder_posts_events",
              "test_operator_watch_mode_reconciles_without_resync",
              "test_operator_binary_leader_election",
              "test_operator_standby_replica_healthz_stays_200"):
    globals()[_name] = _LIVE[_name]

# the simulated operator's fleet: a 4-host v5e slice becomes a clique of
# 4 H100 nodes (an NVLink domain whose size the labels do not fix), the
# slice's job a 4-node H100 job
_METRICS = reference_tests(
    "test_obs_metrics.py", keep=["tpu.topology"], binaries=["operator"],
    renames=[
        ("from k8s_operator_libs_tpu_torch.tpu.operator import "
         "(ManagedComponent,\n                                          "
         "      TPUOperator)",
         "from k8s_operator_libs_tpu_torch.gpu.operator import "
         "(ManagedComponent,\n    GPUOperator as TPUOperator)"),
        ("from k8s_operator_libs_tpu_torch.tpu.scheduler import TPUWorkload",
         "from k8s_operator_libs_tpu_torch.gpu.scheduler import GPUWorkload"),
        ('SLICE_LABELS = {GKE_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",\n'
         '                GKE_TOPOLOGY_LABEL: "4x4", GKE_NODEPOOL_LABEL: '
         '"pool-a"}',
         'SLICE_LABELS = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",\n'
         '                "nvidia.com/gpu.count": "8",\n'
         '                "nvidia.com/gpu.clique": "u.pool-a"}'),
        ('    op.submit(TPUWorkload(name="train",\n'
         '                          accelerator="tpu-v5-lite-podslice",\n'
         '                          topology="4x4"))',
         '    op.submit(GPUWorkload(name="train",\n'
         '                          product="NVIDIA-H100-80GB-HBM3",\n'
         '                          gpus_per_node=8, num_nodes=4))')])
test_simulated_operator_metrics_expose_four_histograms = _METRICS[
    "test_simulated_operator_metrics_expose_four_histograms"]
test_operator_binary_serves_identity_and_histograms = _METRICS[
    "test_operator_binary_serves_identity_and_histograms"]

_HEALTH = reference_tests(
    "test_health_e2e.py", keep=["tpu.topology"], binaries=["operator"],
    renames=[("k8s_operator_libs_tpu_torch.tpu.operator import",
              "k8s_operator_libs_tpu_torch.gpu.operator import"),
             ("TPUOperator)\n", "GPUOperator as TPUOperator)\n")])
test_operator_binary_health_config_quarantines_and_exports_metrics = \
    _HEALTH["test_operator_binary_health_config_quarantines_and_exports_"
            "metrics"]

_MARKET = reference_tests("test_market.py", binaries=["operator"])
test_metrics_server_market_endpoint_envelope = _MARKET[
    "test_metrics_server_market_endpoint_envelope"]

from k8s_operator_libs_tpu_torch.core.fakecluster import (  # noqa: E402
    FakeCluster as PortCluster)
from k8s_operator_libs_tpu_torch.upgrade.util import (  # noqa: E402
    KeyFactory as PortKeys)
from k8s_operator_libs_tpu_torch.utils.clock import (  # noqa: E402
    FakeClock as PortClock)


@pytest.fixture
def clock():
    return PortClock()


@pytest.fixture
def cluster(clock):
    return PortCluster(clock=clock, cache_lag=0.5)


@pytest.fixture
def keys():
    return PortKeys("gpu")


# --------------------------------------------------- tick-by-tick parity

ROOTS = {"reference": REFERENCE, "port": PORT}


def _binary(side):
    if side == "reference":
        return load_reference_binary("operator")
    return importlib.import_module(f"{PORT}.operator")


def _freeze_clocks(monkeypatch, side, clock):
    """Every ``RealClock()`` the side's package makes is ``clock``, so
    both binaries stamp annotations, journeys, spans and ledger records
    with the same fake time."""
    root = ROOTS[side]
    for name, module in list(sys.modules.items()):
        if (name == root or name.startswith(root + ".")) and \
                isinstance(getattr(module, "RealClock", None), type):
            monkeypatch.setattr(module, "RealClock", lambda: clock)


def _env(tw, tmp, seed, health):
    kc = tmp / "kubeconfig"
    kc.write_text(json.dumps({
        "current-context": "fake",
        "contexts": [{"name": "fake",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": tw.srv.base_url}}],
        "users": [{"name": "u", "user": {}}]}))
    rng = np.random.default_rng(seed)
    config = {
        "components": [{
            "name": "drv", "namespace": NS, "driverLabels": {"app": "drv"},
            "policy": {"autoUpgrade": True,
                       "maxParallelUpgrades": int(rng.integers(1, 3)),
                       "maxUnavailable": "50%",
                       "drain": {"enable": True, "force": True,
                                 "timeoutSecond": 60}}}],
        "slo": {},
        "usage": {"ledger": str(tmp / "usage.jsonl")},
        "resilience": {"retries": 1, "retryBaseSeconds": 0.01},
    }
    if health:
        config["health"] = {"repairComponent": "drv", "dampingSeconds": 0,
                            "persistSeconds": 100000}
    cfg = tmp / "operator.yaml"
    cfg.write_text(yaml.safe_dump(config))
    return kc, cfg


def _snapshot(tw):
    direct = tw.cluster.client.direct()
    nodes = [(n.metadata.name,
              sorted((k, v) for k, v in n.metadata.labels.items()
                     if k not in tw.topology_keys),
              sorted(n.metadata.annotations.items()),
              sorted((t.key, t.value, t.effect) for t in n.spec.taints),
              n.spec.unschedulable)
             for n in direct.list_nodes()]
    # a tick's workers record concurrently: its events compare as a set
    events = sorted((tw.name(e.object_kind), e.object_name, e.event_type,
                     e.reason, tw.name(e.message))
                    for e in tw.cluster.recorder.drain())
    leases = [(le.metadata.namespace, le.metadata.name,
               le.spec.holder_identity, le.spec.lease_transitions)
              for le in tw.cluster.list("Lease")]
    return {"nodes": tw.norm(nodes), "events": events, "leases": leases}


def _run_binaries(monkeypatch, tmp_path, seed, ticks=24):
    """Both binaries ``--once`` per tick over twin fleets; returns the
    per-tick snapshots and each side's last endpoint bodies."""
    rng = np.random.default_rng(seed)
    hosts = int(rng.integers(2, 5))
    sick = bool(seed % 2)
    out = {}
    for side in ("reference", "port"):
        tw = Twin(side)
        ds = add_ds(tw)
        for i in range(hosts):
            tw.add_host(f"z-{i}", ds)
        if sick:
            tw.cluster.set_pod_status(NS, "drv-z-0", ready=False,
                                      restart_count=12)
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        tw.srv = importlib.import_module(
            f"{ROOTS[side]}.core.httpapi").FakeAPIServer(tw.cluster).start()
        tmp = tmp_path / side
        tmp.mkdir()
        kc, cfg = _env(tw, tmp, seed, health=sick)
        binary = _binary(side)
        threading_mod = importlib.import_module(f"{ROOTS[side]}.utils.threads")
        with monkeypatch.context() as mp:
            _freeze_clocks(mp, side, tw.clock)
            snaps, bodies = [], {}
            try:
                for t in range(ticks):
                    # the endpoints serve the last tick only (a metrics
                    # server's shutdown waits out its half-second poll)
                    servers = []
                    rc = binary.main(
                        ["--config", str(cfg), "--kubeconfig", str(kc),
                         "--once", "--profile",
                         "--metrics-port", "0" if t == ticks - 1 else "-1",
                         "--ensure-crds", str(REPO / "crds")],
                        on_ready=servers.append)
                    assert rc == 0, side
                    # the tick's drain, eviction and pod-check workers
                    # finish before the fleet is read
                    for prefix in ("drain-", "evict-", "podcheck-"):
                        assert threading_mod.join_all(prefix, 30.0) == []
                    tw.cluster.reconcile_daemonsets()
                    snaps.append(_snapshot(tw))
                    if servers[0] is not None:
                        bodies = dict(servers[0].snapshot)
                    tw.clock.advance(TICK)
            finally:
                tw.srv.stop()
        ledger = (tmp / "usage.jsonl").read_text().splitlines()
        out[side] = (snaps, bodies, [json.loads(r) for r in ledger], tw)
    return out


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}


def _keys(body):
    """The key paths of a JSON body: every dict's keys, lists by their
    first element (the rows' shape)."""
    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield f"{path}.{k}"
                yield from walk(v, f"{path}.{k}")
        elif isinstance(obj, list) and obj:
            yield from walk(obj[0], f"{path}[]")
    return sorted(set(walk(json.loads(body), "")))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_ticks_equal_the_reference_binary(seed, tmp_path,
                                                 monkeypatch):
    out = _run_binaries(monkeypatch, tmp_path, seed)
    want, got = out["reference"][0], out["port"][0]
    for t, (a, b) in enumerate(zip(want, got)):
        for key in a:
            assert b[key] == a[key], (
                f"tick {t}: {key} differs\n" + first_difference(a[key],
                                                                b[key]))
    tw = out["port"][3]
    state = PortKeys("drv").state_label
    assert all(n.metadata.labels.get(state) == "upgrade-done"
               for n in tw.cluster.client.direct().list_nodes()), \
        "the rollout never finished"
    assert any("tpuslicepolicies" in c["metadata"]["name"]
               for c in tw.cluster.list_crds())
    # the billing ledgers: the same records, tick for tick
    assert out["port"][2] == out["reference"][2]
    assert len(out["port"][2]) >= 2
    ref_bodies, port_bodies = out["reference"][1], out["port"][1]
    assert _families(port_bodies["text"]) == \
        _families(ref_bodies["text"])
    for endpoint in ("slo", "alerts", "usage", "profile", "causes",
                     "resilience"):
        assert port_bodies[endpoint] is not None, endpoint
        assert _keys(port_bodies[endpoint]) == \
            _keys(ref_bodies[endpoint]), endpoint
    profile = json.loads(port_bodies["profile"])["data"]
    assert profile["ticks_profiled"] >= 1
    calls = json.loads(port_bodies["profile"])
    assert "api_calls" in json.dumps(calls)


# ------------------------------------------------- flags and ``-m``


def test_flags_and_defaults_equal_the_reference_binary():
    want = argparse_actions(load_reference_binary("operator").main)
    got = argparse_actions(_binary("port").main)
    assert got == want
    names = {opt for action in got for opt in action[0]}
    assert {"--config", "--kubeconfig", "--watch", "--leader-elect",
            "--profile", "--ensure-crds", "--metrics-port"} <= names


def test_loaders_read_a_config_as_the_reference_does(tmp_path):
    """Every section of one config through both binaries' loaders."""
    cfg = tmp_path / "operator.yaml"
    cfg.write_text(yaml.safe_dump({
        "components": [{"name": "gpu", "namespace": "gpu-operator",
                        "driverLabels": {"app": "nvidia-driver"},
                        "policy": {"autoUpgrade": True,
                                   "maxParallelUpgrades": 2,
                                   "maxUnavailable": "25%",
                                   "drain": {"enable": True}}}],
        "health": {"repairComponent": "gpu", "dampingSeconds": 5},
        "slo": {"alerting": {"pageFor": 60}},
        "resilience": {"retries": 2, "breakerOpenSeconds": 12},
        "reconcile": {"shardWorkers": 4, "verifyIncremental": True},
        "usage": {"maxWasteBuckets": 7},
        "market": {"routerUrl": "http://router:8300",
                   "slices": [{"id": "pool-7", "nodes": ["a", "b"]}],
                   "config": {"sustain_ticks": 3}}}))
    sides = {}
    for side in ("reference", "port"):
        b = _binary(side)
        comps = b.load_components(str(cfg))
        sides[side] = (
            [(c.name, c.namespace, c.driver_labels, c.policy.to_dict())
             for c in comps],
            repr(b.load_health(str(cfg))),
            [s.name for s in b.load_slo(str(cfg)).specs],
            b.load_slo(str(cfg)).page_for_s,
            vars(b.load_resilience(str(cfg))),
            b.load_reconcile(str(cfg)), b.load_usage(str(cfg)),
            b.load_market(str(cfg)))
    assert sides["port"] == sides["reference"]


def test_build_market_wires_the_reference_arbiter(tmp_path):
    from k8s_operator_libs_tpu_torch.market import (CapacityArbiter,
                                                    HTTPLaneDemand)
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    section = {"routerUrl": "http://router:8300/",
               "goodputLedger": str(tmp_path / "missing.jsonl"),
               "slices": [{"id": 7, "nodes": ["a", "b"]}],
               "config": {"sustain_ticks": 5}}
    arb = _binary("port").build_market(section, None, None, MetricsHub(),
                                       None, PortClock())
    assert isinstance(arb, CapacityArbiter)
    assert [(s.slice_id, s.nodes) for s in arb.supply] == [("7", ["a", "b"])]
    assert isinstance(arb.demand, HTTPLaneDemand)
    assert arb.demand.url == "http://router:8300/lanes"
    assert arb.config.sustain_ticks == 5
    assert arb.goodput_fn() == 0.0          # a missing ledger prices 0


def test_python_dash_m_runs_the_binary(tmp_path):
    """``python -m k8s_operator_libs_tpu_torch.operator --once`` against
    the port's apiserver: one tick reconciled, exit 0, no JAX."""
    from k8s_operator_libs_tpu_torch.core.httpapi import FakeAPIServer
    tw = Twin("port")
    ds = add_ds(tw)
    tw.add_host("z-0", ds)
    with FakeAPIServer(tw.cluster) as srv:
        tw.srv = srv
        kc, cfg = _env(tw, tmp_path, 0, health=False)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import runpy, sys\n"
             "sys.argv[0] = 'operator'\n"
             "try:\n"
             "    runpy.run_module('k8s_operator_libs_tpu_torch.operator',"
             " run_name='__main__')\n"
             "finally:\n"
             "    print('JAX' if 'jax' in sys.modules else 'NOJAX')\n",
             "--config", str(cfg), "--kubeconfig", str(kc), "--once",
             "--metrics-port", "-1"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert json.loads(proc.stdout.splitlines()[0]) == \
        {"ticks": 1, "last_tick_ok": True}
    assert lines[-1] == "NOJAX"
    # and plainly, as a user types it
    bad = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.operator",
         "--config", str(tmp_path / "none.yaml"), "--once"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "error:" in bad.stderr
