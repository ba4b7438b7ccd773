"""Module twins of the port's upgrade layer against the JAX package's:
the in-process apiserver (``core/fakecluster.py``), the informer cache's
delta surface (``core/cachedclient.py``), the drain helper
(``core/drain.py``), the journey choke point (``obs/journey.py``), the
policy API (``api/v1alpha1.py``), the shard runner
(``upgrade/sharding.py``) and the manager mocks (``upgrade/mocks.py``).

Each test runs one operation sequence on both packages and compares what
comes out: objects as nested dicts with their uids named by order of
first appearance (each package counts uids process-wide) and creation
stamps (the host's wall clock) only as present or not, errors by type
name and message.
"""

import dataclasses
import importlib


NS = "gpu-operator"


class Side:
    def __init__(self, side: str, cache_lag: float = 0.5):
        root = {"reference": "k8s_operator_libs_tpu",
                "port": "k8s_operator_libs_tpu_torch"}[side]
        self.mod = lambda name: importlib.import_module(f"{root}.{name}")
        self.clock = self.mod("utils.clock").FakeClock(1000.0)
        self.cluster = self.mod("core.fakecluster").FakeCluster(
            clock=self.clock, cache_lag=cache_lag)
        self.out = []
        self._uids = {}

    def canon(self, x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            out = {f.name: self.canon(getattr(x, f.name))
                   for f in dataclasses.fields(x)}
            if "uid" in out:
                out["uid"] = self._uid(out["uid"])
            if "creation_timestamp" in out:
                out["creation_timestamp"] = out["creation_timestamp"] is not None
            return out
        if isinstance(x, dict):
            return {self.canon(k): self.canon(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self.canon(v) for v in x)
        if isinstance(x, BaseException):
            return (type(x).__name__, str(x))
        if hasattr(x, "metadata") and not dataclasses.is_dataclass(x):
            return ("bookmark", x.metadata.resource_version)
        return x

    def _uid(self, uid):
        if not uid:
            return uid
        return self._uids.setdefault(uid, f"uid#{len(self._uids)}")

    def put(self, label, fn, *args, **kwargs):
        """Record ``fn(*args)``'s result (or its error) under ``label``."""
        try:
            value = fn(*args, **kwargs)
        except Exception as exc:  # compared across the packages
            value = exc
        self.out.append((label, self.canon(value)))
        return value


def both(script, **kw):
    sides = [Side("reference", **kw), Side("port", **kw)]
    for s in sides:
        script(s)
    ref, port = (s.out for s in sides)
    assert len(ref) == len(port)
    for want, got in zip(ref, port):
        assert got == want, f"reference {want}\nport      {got}"
    return sides


def test_store_versions_cache_lag_and_watches_equal_the_reference():
    def script(s):
        c, direct = s.cluster, s.cluster.client.direct()
        q = c.subscribe()
        s.put("node", c.add_node, "n0", labels={"a": "1"})
        s.put("node", c.add_node, "n1", unschedulable=True, ready=False)
        ds = s.put("ds", c.add_daemonset, "drv", namespace=NS,
                   labels={"app": "drv"}, revision_hash="v1")
        s.put("pod", c.add_pod, "drv-n0", "n0", namespace=NS, owner_ds=ds,
              revision_hash="v1")
        s.put("pod", c.add_pod, "web", "n0", annotations={"x": "y"},
              phase="Pending", ready=False, restart_count=3)
        rv = c.current_rv()
        s.put("rv", lambda: rv)
        # a write through the cached view lags by cache_lag
        s.put("patch", c.client.patch_node_metadata, "n0",
              labels={"a": "2", "b": "3"}, annotations={"k": "v"})
        s.put("stale", c.client.get_node, "n0")
        s.put("fresh", direct.get_node, "n0")
        s.put("watch", direct.watch_nodes, resource_version=rv,
              allow_bookmarks=True)
        s.clock.sleep(0.6)
        s.put("synced", c.client.get_node, "n0")
        s.put("watch", direct.watch_nodes, resource_version=rv,
              allow_bookmarks=True)
        s.put("watch pods", direct.watch_pods, namespace=NS,
              resource_version="0")
        s.put("since", c.events_since, rv)
        s.put("unsched", direct.patch_node_unschedulable, "n1", False)
        s.put("taints", direct.patch_node_taints, "n1",
              [{"key": "k", "value": "v", "effect": "NoSchedule"}])
        s.put("taints", direct.patch_node_taints, "n1",
              [{"key": "k", "value": "w"}, {"key": "j",
                                            "effect": "NoExecute"}])
        s.put("bad taint", direct.patch_node_taints, "n1",
              [{"key": "z", "value": "v"}])
        s.put("taints", direct.patch_node_taints, "n1",
              [{"$patch": "delete", "key": "k"}])
        s.put("list", direct.list_nodes, label_selector={"b": "3"})
        s.put("list pods", direct.list_pods, field_node_name="n0")
        s.put("list with rv", direct.list_pods_with_rv, namespace=NS)
        s.put("status", c.set_pod_status, "default", "web", phase="Running",
              ready=True, restart_count=4)
        stale = c.get("Pod", "default", "web")
        s.put("update", c.update, stale)
        s.put("conflict", c.update, stale)
        s.put("dup", c.create, c.get("Node", "", "n0"))
        s.put("delete", direct.delete_pod, "default", "web")
        s.put("missing", direct.get_pod, "default", "web")
        s.put("queue", lambda: [q.get_nowait() for _ in range(q.qsize())])
        c.unsubscribe(q)
        s.put("rv", c.current_rv)

    both(script)


def test_history_window_eviction_blocks_and_events_equal_the_reference():
    def script(s):
        c, direct = s.cluster, s.cluster.client.direct()
        c.add_node("n0")
        c.add_pod("web", "n0")
        c.add_pod("gone", "n0")
        c.block_eviction("default", "web", times=2)
        c.block_eviction("default", "gone", times=10)
        s.put("evict", direct.evict_pod, "default", "web")
        s.put("evict", direct.evict_pod, "default", "web")
        s.put("evict", direct.evict_pod, "default", "web")
        s.put("pods", direct.list_pods)
        c.delete("Pod", "default", "gone")
        s.put("404 first", direct.evict_pod, "default", "gone")
        c._history_limit = 4
        for i in range(8):
            direct.patch_node_metadata("n0", labels={"i": str(i)})
        s.put("410", c.events_since, "1")
        s.put("410", direct.watch_nodes, resource_version="2")
        s.put("bad rv", c.events_since, "x")
        s.put("tail", c.events_since, str(int(c.current_rv()) - 2))
        s.put("event", direct.create_event,
              s.mod("core.objects").Event(object_kind="Node",
                                          object_name="n0",
                                          event_type="Normal", reason="R",
                                          message="m"))
        rec = s.mod("core.client").ClientEventRecorder(c.client)
        rec.event(direct.get_node("n0"), "Warning", "W", "text")
        s.put("events", c.recorder.drain)

    both(script)


def test_daemonset_controller_equals_the_reference():
    def script(s):
        c, direct = s.cluster, s.cluster.client.direct()
        ds = c.add_daemonset("drv", namespace=NS, labels={"app": "drv"},
                             revision_hash="v1")
        for i in range(3):
            c.add_node(f"n{i}")
            c.add_pod(f"drv-n{i}", f"n{i}", namespace=NS, owner_ds=ds,
                      revision_hash="v1")
        c.add_node("extra")
        c.bump_daemonset_revision("drv", NS, "v2")
        s.put("revs", direct.list_controller_revisions, namespace=NS)
        direct.delete_pod(NS, "drv-n1")
        s.put("created", c.reconcile_daemonsets)
        s.put("again", c.reconcile_daemonsets)
        s.put("pods", direct.list_pods, namespace=NS)
        s.put("ds", direct.list_daemonsets, namespace=NS)

    both(script)


def test_cached_client_deltas_equal_the_reference():
    def script(s):
        c, direct = s.cluster, s.cluster.client.direct()
        ds = c.add_daemonset("drv", namespace=NS, labels={"app": "drv"},
                             revision_hash="v1")
        c.add_node("n0")
        c.add_pod("drv-n0", "n0", namespace=NS, owner_ds=ds)
        cc = s.mod("core.cachedclient").CachedClient(
            direct, namespaces=[NS], pumped=True, clock=s.clock).start()

        def deltas():
            return {k: (sorted(d.changed.items()), d.resynced)
                    for k, d in sorted(cc.drain_deltas().items())}

        s.put("first", deltas)
        direct.patch_node_metadata("n0", labels={"x": "1"})
        c.add_node("n1")
        c.add_pod("p", "n1", namespace=NS)
        direct.delete_pod(NS, "p")
        cc.pump()
        s.put("lagged", deltas)
        s.put("stale read", cc.get_node, "n0")
        s.clock.sleep(1.0)
        cc.pump()
        s.put("due", deltas)
        s.put("read", cc.get_node, "n0")
        s.put("pods", cc.list_pods, namespace=NS)
        s.put("revs", cc.list_controller_revisions, namespace=NS)
        c._history_limit = 2
        for i in range(6):
            direct.patch_node_metadata("n1", labels={"i": str(i)})
        s.clock.sleep(1.0)
        cc.pump()
        s.put("resynced", deltas)
        s.put("nodes", cc.list_nodes)

    both(script)


def test_drain_helper_equals_the_reference():
    def script(s):
        c = s.cluster
        objects = s.mod("core.objects")
        Helper = s.mod("core.drain").Helper
        ds = c.add_daemonset("drv", namespace=NS, labels={"app": "drv"})
        c.add_node("n0")
        c.add_pod("drv-n0", "n0", namespace=NS, owner_ds=ds)
        c.add_pod("bare", "n0")
        c.add_pod("done", "n0", phase="Succeeded")
        owned = c.get("Pod", "default", "bare")
        owned.metadata.name = "owned"
        owned.metadata.resource_version = ""
        owned.metadata.owner_references = [objects.OwnerReference(
            kind="ReplicaSet", name="rs", uid="rs-1")]
        owned.spec.volumes = [objects.Volume(name="v", empty_dir=True)]
        c.create(owned)
        c.block_eviction("default", "bare", times=2)
        h = Helper(c.client, clock=s.clock, timeout_seconds=60)
        s.put("strict", h.get_pods_for_deletion, "n0")
        s.put("drain refused", h.run_node_drain, "n0")
        h = Helper(c.client, clock=s.clock, force=True,
                   delete_empty_dir_data=True, timeout_seconds=60)
        t0 = s.clock.now()
        s.put("drain", h.run_node_drain, "n0")
        s.put("waited", lambda: s.clock.now() - t0)
        s.put("left", c.client.direct().list_pods)
        c.add_pod("stuck", "n0")
        c.block_eviction("default", "stuck", times=100)
        h = Helper(c.client, clock=s.clock, force=True, timeout_seconds=20)
        s.put("timeout", h.run_node_drain, "n0")
        s.put("cordon", h.run_cordon_or_uncordon, "n0", True)
        s.put("node", c.client.direct().get_node, "n0")

    both(script)


def test_journey_and_stuck_detector_equal_the_reference():
    def script(s):
        c = s.cluster
        keys = s.mod("upgrade.util").KeyFactory("gpu")
        S = s.mod("upgrade.consts").UpgradeState
        journey = s.mod("obs.journey")
        hub = s.mod("obs.metrics").MetricsHub()
        rec = journey.JourneyRecorder("gpu", keys.journey_annotation,
                                      keys.stuck_reported_annotation,
                                      clock=s.clock, metrics=hub,
                                      max_entries=4)
        node = c.add_node("n0")
        for state in (S.UPGRADE_REQUIRED, S.UPGRADE_REQUIRED,
                      S.CORDON_REQUIRED, S.DRAIN_REQUIRED,
                      S.POD_RESTART_REQUIRED, S.UNCORDON_REQUIRED):
            s.clock.sleep(7.5)
            patch = s.put("record", rec.record, node, "", state)
            node.metadata.annotations.update(
                {k: v for k, v in patch.items() if v is not None})
        s.put("parsed", journey.parse_journey_full,
              node.metadata.annotations[keys.journey_annotation])
        s.put("entered", rec.entered_at, node, S.UNCORDON_REQUIRED)
        s.put("entered", rec.entered_at, node, S.DONE)
        c.client.patch_node_metadata(
            "n0", labels={keys.state_label: S.UNCORDON_REQUIRED},
            annotations=node.metadata.annotations)
        c.flush_cache()
        det = journey.StuckNodeDetector(
            c.client, "gpu", keys.state_label, keys.journey_annotation,
            keys.stuck_reported_annotation,
            thresholds={S.UNCORDON_REQUIRED: 30.0}, recorder=c.recorder,
            clock=s.clock, metrics=hub)
        s.put("fresh", det.check, c.client.direct().list_nodes())
        s.clock.sleep(60.0)
        s.put("stuck", det.check, c.client.direct().list_nodes())
        c.flush_cache()
        s.put("quiet", det.check, c.client.direct().list_nodes())
        s.put("events", c.recorder.drain)
        s.put("metrics", hub.render, prefix="tpu_operator")
        s.put("thresholds", lambda: journey.DEFAULT_STUCK_THRESHOLDS)
        s.put("closed", lambda: set(journey.DEFAULT_STUCK_THRESHOLDS)
              == set(S.ALL))

    both(script)


def test_policy_api_equals_the_reference():
    def script(s):
        api = s.mod("api.v1alpha1")
        for value, total in (("25%", 8), ("25%", 3), (2, 8), ("0%", 5),
                             ("100%", 7), ("x%", 4), (-1, 4)):
            s.put("scaled", api.scaled_int_or_percent, value, total)
            s.put("scaled down", api.scaled_int_or_percent, value, total,
                  round_up=False)
        d = {"autoUpgrade": True, "maxParallelUpgrades": 2,
             "maxUnavailable": "50%",
             "waitForCompletion": {"podSelector": "job=batch",
                                   "timeoutSecond": 30},
             "podDeletion": {"force": True, "deleteEmptyDir": True},
             "drain": {"enable": True, "force": True, "podSelector": "a=b",
                       "timeoutSecond": 60}}
        spec = s.put("from_dict", api.DriverUpgradePolicySpec.from_dict, d)
        s.put("to_dict", spec.to_dict)
        s.put("default", api.DriverUpgradePolicySpec)
        s.put("invalid", api.DriverUpgradePolicySpec(
            max_parallel_upgrades=-1).validate)
        s.put("invalid", api.DrainSpec(timeout_second=-1).validate)

    both(script)


def test_shard_runner_and_budget_equal_the_reference():
    def script(s):
        sharding = s.mod("upgrade.sharding")
        keys = [f"clique/{i}" for i in range(9)] + ["h0", "h1"]
        s.put("index", lambda: [sharding.shard_index(k, 4) for k in keys])
        runner = sharding.ShardRunner(workers=4, parallel=False, name="t")
        s.put("run", runner.run, keys, key_fn=lambda k: k,
              work_fn=lambda items: [k.upper() for k in items])
        budget = sharding.BudgetAccountant(3)
        s.put("reserve", lambda: [budget.try_reserve(n) for n in (2, 2, 1)])
        s.put("available", lambda: budget.available)
        s.put("oversized", budget.try_admit_oversized, False)

    both(script)


def test_manager_mocks_equal_the_reference():
    def script(s):
        mocks = s.mod("upgrade.mocks")
        keys = s.mod("upgrade.util").KeyFactory("gpu")
        c = s.cluster
        node = c.add_node("n0")
        prov = mocks.MockNodeUpgradeStateProvider(keys)
        prov.change_node_upgrade_state(node, "cordon-required")
        prov.change_node_upgrade_annotation(node, "k", "v")
        prov.change_node_upgrade_annotation(node, "k", "null")
        s.put("node", lambda: node)
        s.put("calls", lambda: prov.calls)
        pods = mocks.MockPodManager()
        s.put("hash", pods.get_pod_controller_revision_hash,
              c.add_pod("p", "n0", revision_hash="v1"))
        pods.fail_on("schedule_pods_restart", RuntimeError("boom"))
        s.put("fails", pods.schedule_pods_restart, [])
        s.put("calls", lambda: pods.calls_to("schedule_pods_restart"))
        val = mocks.MockValidationManager()
        s.put("validate", val.validate, node)
        safe = mocks.MockSafeDriverLoadManager(keys)
        node.metadata.annotations[keys.safe_load_annotation] = "true"
        s.put("safe", safe.is_waiting_for_safe_driver_load, node)
        safe.unblock_loading(node)
        s.put("unblocked", safe.is_waiting_for_safe_driver_load, node)
        cordon = mocks.MockCordonManager()
        cordon.cordon(node)
        s.put("cordon", lambda: (node.spec.unschedulable, cordon.calls))

    both(script)


def test_mocked_state_machine_equals_the_reference():
    """Every side-effect manager mocked, one node per state bucket held in
    memory: one ``apply_state`` pass makes the same calls and the same
    in-memory label writes in both packages."""
    def script(s):
        mocks = s.mod("upgrade.mocks")
        us = s.mod("upgrade.upgrade_state")
        objects = s.mod("core.objects")
        S = s.mod("upgrade.consts").UpgradeState
        keys = s.mod("upgrade.util").KeyFactory("gpu")
        api = s.mod("api.v1alpha1")
        ds = objects.DaemonSet(metadata=objects.ObjectMeta(name="driver"))
        mgr = us.ClusterUpgradeStateManager(
            s.cluster.client, keys, clock=s.clock, synchronous=True,
            state_provider=mocks.MockNodeUpgradeStateProvider(keys),
            cordon_manager=mocks.MockCordonManager(),
            drain_manager=mocks.MockDrainManager(),
            pod_manager=mocks.MockPodManager(ds_revision_hash="rev-2"),
            validation_manager=mocks.MockValidationManager(result=True),
            safe_load_manager=mocks.MockSafeDriverLoadManager(keys))
        mgr.with_validation_enabled("role=validator")
        state = us.ClusterUpgradeState()
        for i, label in enumerate((S.UNKNOWN, S.UPGRADE_REQUIRED,
                                   S.CORDON_REQUIRED, S.DRAIN_REQUIRED,
                                   S.POD_RESTART_REQUIRED,
                                   S.VALIDATION_REQUIRED,
                                   S.UNCORDON_REQUIRED)):
            node = objects.Node(metadata=objects.ObjectMeta(
                name=f"n{i}", namespace="",
                labels={keys.state_label: label} if label else {}))
            node.spec.unschedulable = label == S.UNCORDON_REQUIRED
            pod = objects.Pod(metadata=objects.ObjectMeta(
                name=f"p{i}", labels={"controller-revision-hash": "rev-1"},
                owner_references=[objects.OwnerReference(
                    kind="DaemonSet", name="driver", uid=ds.metadata.uid)]))
            pod.spec.node_name = f"n{i}"
            pod.status.container_statuses = [objects.ContainerStatus()]
            pod.status.conditions = [objects.PodCondition(type="Ready",
                                                          status="True")]
            state.node_states.setdefault(label, []).append(
                us.NodeUpgradeState(node=node, driver_pod=pod,
                                    driver_daemonset=ds))
        mgr.apply_state(state, api.DriverUpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=0,
            drain=api.DrainSpec(enable=True)))
        for m in (mgr.node_upgrade_state_provider, mgr.cordon_manager,
                  mgr.drain_manager, mgr.pod_manager,
                  mgr.validation_manager, mgr.safe_driver_load_manager):
            s.put(type(m).__name__, lambda: m.calls)
        s.put("nodes", lambda: {b: [(e.node.metadata.labels,
                                     e.node.spec.unschedulable)
                                    for e in entries]
                                for b, entries in state.node_states.items()})
        s.put("cordon fails", lambda: (
            mgr.cordon_manager.fail_on("cordon", RuntimeError("down")),
            mgr.process_cordon_required_nodes(state)))

    sides = both(script)
    calls = dict(sides[1].out)
    assert calls["MockDrainManager"] and calls["MockCordonManager"]
