"""The port's operator (``gpu/operator.py:GPUOperator``) held against the
JAX package's ``TPUOperator``, tick by tick.

One harness builds the same seeded fleet in each package's
``FakeCluster`` (a ``FakeClock(1000.0)`` each, advanced together), wires
the same operator (upgrade pipeline, fleet health, stuck detectors,
placement, usage meter, SLO stack) over it and reconciles both. At every
tick it requires equality (``==``) of every node's labels, annotations,
taints, ``unschedulable`` and resource version, of the pods present
(phase, readiness, restarts, labels, requests, env, uid by order of
first appearance), of the events recorded, of ``last_health``'s
verdicts and actions, of ``last_slo`` and of the metrics hub's text.

Where the two operators differ by design, the comparison goes through
this explicit name map (:class:`Twin`) and nowhere else:

- a single H100 node (GFD labels, 8 GPUs) is the twin of a single-host
  TPU node (v5e ``2x4``, 8 chips): both group by node name;
- a GB200 NVL72 clique ``clique/u.<g>`` (18 nodes of 4 GPUs) is the twin
  of an 18-host v5p slice ``slice/<g>`` (topology ``2x6x6``, 4 chips a
  host): 72 accelerators, one upgrade and repair group, in both. The
  reference's own tests use a 4-host slice; a GB200 clique is 18 nodes,
  so the twin slice is 18 hosts;
- a workload pod requests ``nvidia.com/gpu`` where the reference's
  requests ``google.com/tpu``; the port's env adds ``LOCAL_WORLD_SIZE``
  and lacks ``TPU_ACCELERATOR_TYPE``/``TPU_TOPOLOGY``;
- the topology labels themselves (GKE's, GFD's) are the setup's and are
  left out of the label comparison;
- the operator's own event object is ``GPUOperator`` where the
  reference's is ``TPUOperator``; the placement latency is labelled with
  the GPU product where the reference labels the TPU accelerator.

The scenarios twin ``tests/test_operator.py``, the first four tests of
``tests/test_health_e2e.py`` and the degraded-mode tests of
``tests/test_resilience.py``; each also keeps the reference test's own
assertions on the port.
"""

import importlib

import pytest

from torch_operator_twin import (CLIQUE_NODES, H100, NS, ROOTS, add_ds,
                                 in_progress, run_twins)


# ----------------------------------------------------- tests/test_operator.py

def test_four_node_rolling_upgrade_one_node_at_a_time():
    """``test_config2_four_node_rolling_upgrade``: 4 single nodes, one at
    a time, through the operator's reconcile alone (SLO and usage on)."""
    names = [f"node{i}" for i in range(4)]
    seen = {}

    def setup(tw):
        ds = add_ds(tw)
        for n in names:
            tw.add_host(n, ds)
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        tw.build([("drv", tw.policy())])

    def check(tw, t):
        keys = tw.KeyFactory("drv")
        seen[tw.side] = max(seen.get(tw.side, 0),
                            in_progress(tw, keys, names))

    def done(tw):
        keys = tw.KeyFactory("drv")
        return all(tw.node(n).metadata.labels.get(keys.state_label)
                   == tw.S.DONE for n in names)

    ref, port = run_twins(setup, 60, check=check, stop=done)
    assert seen == {"reference": 1, "port": 1}
    assert sorted(p.metadata.labels["controller-revision-hash"]
                  for p in port.direct.list_pods(namespace=NS)) == ["v2"] * 4
    # every tick was scraped and every default objective evaluated
    assert set(port.op.last_slo) == {s["name"] for s in
                                     port.slo.DEFAULT_SLO_SPECS}
    assert port.op.usage.ticks == ref.op.usage.ticks > 0


def test_workload_waits_until_its_clique_is_upgraded():
    """``test_workload_waits_until_slice_upgraded``: a clique mid-upgrade
    is cordoned, so its workload is placed only after the upgrade."""
    placed_while_cordoned = []

    def setup(tw):
        ds = add_ds(tw)
        tw.add_group(ds, "pool-a")
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        tw.build([("drv", tw.policy(0, "100%"))])
        tw.op.submit(tw.workload("train", CLIQUE_NODES))

    def check(tw, t):
        cordoned = any(n.spec.unschedulable
                       for n in tw.direct.list_nodes())
        if cordoned and tw.op.placements:
            placed_while_cordoned.append(tw.side)

    ref, port = run_twins(setup, 60, check=check,
                          stop=lambda tw: bool(tw.op.placements))
    assert not placed_while_cordoned
    assert not port.op.pending_workloads
    assert port.op.placements[0].slice_id == "clique/u.pool-a"
    pods = port.direct.list_pods(label_selector={"tpu.dev/workload":
                                                 "train"})
    assert len(pods) == CLIQUE_NODES
    assert all(p.spec.resource_requests == {"nvidia.com/gpu": 4}
               for p in pods)


def test_two_components_upgrade_one_clique_together():
    """``test_two_component_concurrent_upgrade_same_slice``: one operator,
    the driver and the device plugin over the same clique; neither
    component's uncordon puts a node in service while the other is past
    its drain point."""
    hosts = [f"pool-a-h{i}" for i in range(CLIQUE_NODES)]
    down = ("drain-required", "pod-restart-required", "validation-required",
            "upgrade-failed")
    uncordons = {}

    def setup(tw):
        ds_a = add_ds(tw, "drv")
        ds_b = add_ds(tw, "plugin")
        for h in hosts:
            tw.add_host(h, ds_a, group="pool-a")
            tw.cluster.add_pod(f"plugin-{h}", h, namespace=NS, owner_ds=ds_b,
                               revision_hash="v1")
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        tw.cluster.bump_daemonset_revision("plugin", NS, "v2")
        policy = tw.policy(0, "100%")
        tw.build([("drv", policy), ("plugin", policy)])
        tw.prev = {h: False for h in hosts}
        uncordons[tw.side] = {h: 0 for h in hosts}

    def check(tw, t):
        ka, kb = tw.KeyFactory("drv"), tw.KeyFactory("plugin")
        for h in hosts:
            n = tw.node(h)
            if tw.prev[h] and not n.spec.unschedulable:
                uncordons[tw.side][h] += 1
            tw.prev[h] = n.spec.unschedulable
            sa = n.metadata.labels.get(ka.state_label, "")
            sb = n.metadata.labels.get(kb.state_label, "")
            assert not ((sa in down or sb in down)
                        and not n.spec.unschedulable), (tw.side, h, sa, sb)

    def done(tw):
        ka, kb = tw.KeyFactory("drv"), tw.KeyFactory("plugin")
        return all(tw.node(h).metadata.labels.get(k.state_label)
                   == tw.S.DONE for h in hosts for k in (ka, kb))

    ref, port = run_twins(setup, 120, check=check, stop=done)
    for app in ("drv", "plugin"):
        pods = port.direct.list_pods(namespace=NS,
                                     label_selector={"app": app})
        assert sorted(p.metadata.labels["controller-revision-hash"]
                      for p in pods) == ["v2"] * CLIQUE_NODES
    assert uncordons["port"] == uncordons["reference"]
    assert all(1 <= c <= 2 for c in uncordons["port"].values())


def test_single_nodes_are_placed_one_workload_each():
    """Two single-node workloads over three single nodes: the port's
    scheduler places them as the reference's places its single-host
    slices, and the third workload waits for a free node."""
    def setup(tw):
        ds = add_ds(tw)
        for i in range(3):
            tw.add_host(f"n{i}", ds)
        tw.build([("drv", tw.policy())])
        for name in ("a", "b", "c", "d"):
            tw.op.submit(tw.workload(name, 0))

    ref, port = run_twins(setup, 3)
    assert [p.node_names for p in port.op.placements] == \
        [["n0"], ["n1"], ["n2"]]
    assert [w.name for w in port.op.pending_workloads] == ["d"]
    with pytest.raises(ValueError):
        port.op.submit(port.Workload(name="bad", product=H100,
                                     gpus_per_node=8, num_nodes=0))


# ------------------------------------------- tests/test_health_e2e.py (1-4)

def test_crashloop_quarantines_and_repairs_the_whole_clique():
    """``test_crashloop_quarantines_and_repairs_whole_slice``: one sick
    host of a clique quarantines the whole clique, which is repaired
    clique-atomically through the upgrade pipeline and uncordoned."""
    hosts = [f"pool-a-h{i}" for i in range(CLIQUE_NODES)]
    repairs = {"reference": [], "port": []}
    states_seen = {}
    quarantined = {"reference": 0, "port": 0}

    def setup(tw):
        ds = add_ds(tw)
        tw.add_group(ds, "pool-a")
        tw.old_uid = tw.direct.get_pod(NS, "drv-pool-a-h0").metadata.uid
        tw.build([("drv", tw.policy(0, "100%"))],
                 health=tw.health_options())
        tw.cluster.set_pod_status(NS, "drv-pool-a-h0", ready=False,
                                  restart_count=12)
        states_seen[tw.side] = {h: set() for h in hosts}

    def check(tw, t):
        keys = tw.KeyFactory("drv")
        nodes = {h: tw.node(h) for h in hosts}
        q = {h for h, n in nodes.items()
             if tw.hconsts.QUARANTINE_LABEL in n.metadata.labels}
        if q:
            assert q == set(hosts)
            assert all(n.spec.unschedulable for n in nodes.values())
            assert all(any(x.key == tw.hconsts.QUARANTINE_TAINT_KEY
                           for x in n.spec.taints) for n in nodes.values())
            quarantined[tw.side] += 1
        for h, n in nodes.items():
            states_seen[tw.side][h].add(
                n.metadata.labels.get(keys.state_label, ""))
        repairs[tw.side].extend(tw.op.last_health.actions.repairs_injected)

    def done(tw):
        return quarantined[tw.side] and all(
            not tw.node(h).spec.unschedulable
            and tw.hconsts.QUARANTINE_LABEL not in tw.node(h).metadata.labels
            for h in hosts)

    ref, port = run_twins(setup, 120, check=check, stop=done)
    assert repairs == {"reference": ["slice/pool-a"],
                       "port": ["clique/u.pool-a"]}
    keys = port.KeyFactory("drv")
    S = port.S
    for h in hosts:
        assert (S.DRAIN_REQUIRED in states_seen["port"][h]
                or S.WAIT_FOR_JOBS_REQUIRED in states_seen["port"][h])
        assert port.node(h).metadata.labels.get(keys.state_label) == S.DONE
    pods = port.direct.list_pods(namespace=NS, field_node_name="pool-a-h0")
    assert len(pods) == 1 and pods[0].metadata.uid != port.old_uid
    assert all(cs.ready for cs in pods[0].status.container_statuses)
    n0 = port.node(hosts[0])
    assert port.hconsts.REPAIR_ANNOTATION not in n0.metadata.annotations
    assert n0.metadata.annotations[
        port.hconsts.REPAIR_ATTEMPTS_ANNOTATION] == "1"
    assert n0.spec.taints == []
    reasons = [e.message for e in port.events
               if e.reason == "FleetHealth"]
    assert any("Quarantined clique/u.pool-a" in m for m in reasons)
    assert any("slice-atomic repair" in m for m in reasons)
    assert any("Quarantine lifted" in m for m in reasons)


def test_flapping_signal_triggers_no_remediation():
    """A signal bouncing faster than the damping window holds the node at
    degraded: no cordon, taint, quarantine or repair."""
    hosts = [f"pool-a-h{i}" for i in range(CLIQUE_NODES)]
    saw = set()

    def setup(tw):
        ds = add_ds(tw)
        tw.add_group(ds, "pool-a")
        tw.build([("drv", tw.policy(0, "100%"))],
                 health=tw.health_options(damping=100.0, persist=200.0))

    def hook(tw, t):
        tw.cluster.set_pod_status(NS, "drv-pool-a-h0", ready=(t % 2 == 1),
                                  restart_count=12)

    def check(tw, t):
        keys = tw.KeyFactory("drv")
        for h in hosts:
            n = tw.node(h)
            assert not n.spec.unschedulable and n.spec.taints == []
            assert tw.hconsts.QUARANTINE_LABEL not in n.metadata.labels
            assert tw.hconsts.REPAIR_ANNOTATION not in n.metadata.annotations
            assert keys.upgrade_requested_annotation not in \
                n.metadata.annotations
            verdict = n.metadata.labels.get(tw.hconsts.VERDICT_LABEL)
            assert verdict in (None, "degraded")
            if verdict == "degraded":
                saw.add(tw.side)

    ref, port = run_twins(setup, 40, hook=hook, check=check)
    assert saw == {"reference", "port"}
    assert port.op.last_health.actions.repairs_injected == []


def test_remediation_and_rolling_upgrade_share_one_budget():
    """Two cliques, maxUnavailable 50%: pool-a needs the new driver,
    pool-b is sick. Health defers pool-b's quarantine while the upgrade
    holds the budget, then repairs it; no tick has more than half the
    fleet out of service."""
    half = CLIQUE_NODES
    flags = {"reference": set(), "port": set()}
    worst = {"reference": 0, "port": 0}

    def setup(tw):
        ds = add_ds(tw)
        tw.hosts_a = tw.add_group(ds, "pool-a", "v1")
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        tw.hosts_b = tw.add_group(ds, "pool-b", "v2")
        tw.build([("drv", tw.policy(0, "50%"))],
                 health=tw.health_options(damping=15.0, persist=30.0,
                                          recovery=30.0,
                                          max_unavailable="50%"))
        tw.cluster.set_pod_status(NS, "drv-pool-b-h0", ready=False,
                                  restart_count=12)

    def check(tw, t):
        keys = tw.KeyFactory("drv")
        nodes = [tw.node(h) for h in tw.hosts_a + tw.hosts_b]
        down = sum(1 for n in nodes if n.spec.unschedulable
                   or not n.is_ready())
        assert down <= half, (tw.side, t, down)
        worst[tw.side] = max(worst[tw.side], down)
        actions = tw.op.last_health.actions
        if actions.deferred_slices:
            flags[tw.side].add("deferred")
            assert any(tw.node(h).spec.unschedulable
                       or tw.node(h).metadata.labels.get(keys.state_label)
                       == tw.S.CORDON_REQUIRED for h in tw.hosts_a)
        if actions.repairs_injected:
            flags[tw.side].add("repaired")

    def done(tw):
        keys = tw.KeyFactory("drv")
        nodes = [tw.node(h) for h in tw.hosts_a + tw.hosts_b]
        pods = tw.direct.list_pods(namespace=NS,
                                   label_selector={"app": "drv"})
        return (len(pods) == 2 * half
                and all(p.metadata.labels["controller-revision-hash"] == "v2"
                        and all(c.ready for c in p.status.container_statuses)
                        for p in pods)
                and all(not n.spec.unschedulable
                        and tw.hconsts.QUARANTINE_LABEL
                        not in n.metadata.labels
                        and n.metadata.labels.get(keys.state_label)
                        == tw.S.DONE for n in nodes))

    run_twins(setup, 200, check=check, stop=done)
    assert flags["port"] == {"deferred", "repaired"} == flags["reference"]
    assert worst == {"reference": half, "port": half}


def test_operator_without_health_writes_no_health_keys():
    """health=None: no monitor, no health writes, the same result shape."""
    def setup(tw):
        ds = add_ds(tw)
        tw.add_group(ds, "pool-a")
        tw.build([("drv", tw.policy())], slo=False, usage=False)

    ref, port = run_twins(setup, 2)
    assert port.op.health_monitor is None and port.op.last_health is None
    assert set(port.op.reconcile()) == {"drv"}
    for n in port.direct.list_nodes():
        assert port.hconsts.VERDICT_LABEL not in n.metadata.labels
        assert port.hconsts.QUARANTINE_LABEL not in n.metadata.labels


# ------------------------------- degraded mode (tests/test_resilience.py)

class Outage:
    """A client that forwards to the cluster's, failing every apiserver
    call with the package's ``ServerError`` while ``down``."""

    def __init__(self, inner, errors, down=None):
        self._inner = inner
        self._errors = errors
        self.down = down if down is not None else [False]

    def _gate(self, name, attr):
        if not callable(attr) or name.startswith("_"):
            return attr
        verb = name.split("_", 1)[0]
        if verb not in ("get", "list", "watch", "create", "update",
                        "patch", "delete", "evict") or \
                name == "create_event":
            return attr

        def call(*args, **kwargs):
            if self.down[0]:
                raise self._errors.ServerError(f"{name}: apiserver down")
            return attr(*args, **kwargs)
        return call

    def direct(self):
        return Outage(self._inner.direct(), self._errors, self.down)

    def __getattr__(self, name):
        return self._gate(name, getattr(self._inner, name))


@pytest.mark.parametrize("planted", ["none", "skip_safety_pass"])
def test_degraded_safety_writes_land_and_close_the_breaker(planted,
                                                          monkeypatch):
    """``test_degraded_safety_writes_land_and_double_as_probes``: with the
    apiserver down the breaker opens and the operator fails static (health
    masked, no state-advancing write); when the apiserver answers again,
    only the safety pass can reach it (the breaker's open window is 600
    s): it uncordons a node parked at uncordon-required, finishes a
    quarantine lift whose intent is durable, and its success closes the
    breaker, so the same tick runs in full. Then the upgrade goes on as
    usual. With the safety pass skipped the port stays degraded and the
    comparison fails."""
    names = [f"h{i}" for i in range(4)]

    def setup(tw):
        ds = add_ds(tw)
        for n in names:
            tw.add_host(n, ds)
        tw.cluster.bump_daemonset_revision("drv", NS, "v2")
        keys = tw.KeyFactory("drv")
        direct = tw.direct
        direct.patch_node_unschedulable("h0", True)
        direct.patch_node_metadata(
            "h0", labels={keys.state_label: tw.S.UNCORDON_REQUIRED})
        direct.patch_node_unschedulable("h1", True)
        direct.patch_node_metadata(
            "h1", labels={tw.hconsts.QUARANTINE_LABEL:
                          "unhealthy-transient"},
            annotations={tw.hconsts.QUARANTINE_LIFT_ANNOTATION: "123.0",
                         tw.hconsts.QUARANTINE_REASON_ANNOTATION: "x"})
        tw.cluster.flush_cache()
        tw.down = [False]
        tw.res = tw.resilience.ResilientClient(
            Outage(tw.cluster.client, tw.client_mod, tw.down),
            clock=tw.clock, retries=0, failure_threshold=3,
            open_seconds=600.0, metrics=tw.hub)
        cached = importlib.import_module(
            f"{ROOTS[tw.side]}.core.cachedclient").CachedClient(
                tw.res, namespaces=[NS], pumped=True,
                clock=tw.clock).start()
        tw.build([("drv", tw.policy(1, "50%"))], client=cached,
                 resilience=tw.res, health=tw.health_options())
        if planted == "skip_safety_pass" and tw.side == "port":
            monkeypatch.setattr(tw.op, "_degraded_safety_pass",
                                lambda: None)

    def hook(tw, t):
        if t == 0:
            tw.down[0] = True
            for _ in range(3):
                with pytest.raises(tw.client_mod.ServerError):
                    tw.res.list_nodes()
            assert tw.res.breaker.state == tw.resilience.OPEN
        if t == 1:
            tw.down[0] = False

    def check(tw, t):
        if t == 0:
            assert tw.op.degraded
            assert "tpu_operator_degraded 1\n" in tw.hub.render(
                prefix="tpu_operator")
            assert tw.node("h0").spec.unschedulable
        if t == 1:
            assert not tw.op.degraded
            assert not tw.node("h0").spec.unschedulable
            h1 = tw.node("h1")
            assert not h1.spec.unschedulable
            assert tw.hconsts.QUARANTINE_LABEL not in h1.metadata.labels

    def done(tw):
        keys = tw.KeyFactory("drv")
        return all(tw.node(n).metadata.labels.get(keys.state_label)
                   == tw.S.DONE for n in names)

    if planted == "none":
        ref, port = run_twins(setup, 60, hook=hook, check=check, stop=done)
        assert [e.reason for e in port.events
                if e.reason.startswith("Operator")] == \
            ["OperatorDegraded", "OperatorRecovered"]
        assert "tpu_operator_degraded 0\n" in port.hub.render(
            prefix="tpu_operator")
    else:
        with pytest.raises(AssertionError):
            run_twins(setup, 60, hook=hook, check=check, stop=done)


# ------------------------------- placement (tests/test_operator.py's rest)
#
# The reference places a multi-host job on one whole ICI slice; the
# port's scheduler places each slice of a job inside one NVLink clique
# (a GB200 clique here, 4 nodes of 4 GPUs; the reference's 4-host v5e
# slice, 4 chips a host), and never across two.

def place_side(side, cliques, busy=(), num_slices=1, conflict=None):
    """Both packages' schedulers on a fleet of 4-host groups named
    ``cliques``; ``busy`` hosts run a pod holding their accelerators;
    ``conflict`` a pod name taken beforehand. Returns the placement (or
    None), the workload pods and the services, in the port's words."""
    root = ROOTS[side]
    mod = importlib.import_module
    clock = mod(f"{root}.utils.clock").FakeClock(1000.0)
    cluster = mod(f"{root}.core.fakecluster").FakeCluster(clock=clock)
    for group in cliques:
        for i in range(4):
            name = f"{group}-h{i}"
            if side == "reference":
                t = mod(f"{root}.tpu.topology")
                labels = {t.GKE_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                          t.GKE_TOPOLOGY_LABEL: "4x4",
                          t.GKE_NODEPOOL_LABEL: group}
            else:
                t = mod(f"{root}.gpu.topology")
                labels = {t.PRODUCT_LABEL: "NVIDIA-GB200",
                          t.COUNT_LABEL: "4", t.CLIQUE_LABEL: f"u.{group}"}
            cluster.add_node(name, labels=labels)
    resource = "google.com/tpu" if side == "reference" else "nvidia.com/gpu"
    for host in busy:
        pod = cluster.add_pod(f"other-{host}", host)
        pod.spec.resource_requests = {resource: 4}
        cluster.update(pod)
    if conflict:
        cluster.add_pod(conflict[0], conflict[1])
    cluster.flush_cache()
    if side == "reference":
        sched = mod(f"{root}.tpu.scheduler").SliceScheduler(cluster.client)
        wl = mod(f"{root}.tpu.scheduler").TPUWorkload(
            name="ms", accelerator="tpu-v5-lite-podslice", topology="4x4",
            num_slices=num_slices)
    else:
        sched = mod(f"{root}.gpu.scheduler").GPUScheduler(cluster.client)
        wl = mod(f"{root}.gpu.scheduler").GPUWorkload(
            name="ms", product="NVIDIA-GB200", gpus_per_node=4, num_nodes=4,
            num_slices=num_slices)
    placement = sched.place(wl)
    skip = {"TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY", "LOCAL_WORLD_SIZE"}
    pods = sorted(
        (p.metadata.name, p.spec.node_name, p.spec.hostname,
         p.spec.subdomain, sorted(p.spec.resource_requests.values()),
         sorted((k, v) for k, v in p.spec.env.items() if k not in skip))
        for p in cluster.client.direct().list_pods()
        if p.metadata.labels.get("tpu.dev/workload") == "ms")
    if placement is None:
        return None, pods
    ids = [sid if side == "port" else f"clique/u.{sid}"
           for sid in placement.slice_ids]
    return (placement.node_names, placement.pods, ids), pods


def placed_alike(**kw):
    want, got = place_side("reference", **kw), place_side("port", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("num_slices", [1, 2])
def test_a_job_lands_in_one_clique_as_in_one_slice(num_slices):
    """One or two 4-node slices of a job over two GB200 cliques: the same
    nodes, pods, names, DNS and env as the reference's over two 4-host
    slices, and each slice inside one clique."""
    placement, pods = placed_alike(cliques=("pool-a", "pool-b"),
                                   num_slices=num_slices)
    assert placement[2] == ["clique/u.pool-a", "clique/u.pool-b"][
        :num_slices]
    assert len(pods) == 4 * num_slices


def test_a_job_never_spans_two_cliques():
    """Two cliques with two busy nodes each: four nodes are free, but no
    clique holds a 4-node slice, so nothing is placed (the reference's
    two half-busy slices likewise); with one clique free it lands there."""
    assert placed_alike(cliques=("pool-a", "pool-b"),
                        busy=("pool-a-h0", "pool-a-h1", "pool-b-h2",
                              "pool-b-h3")) == (None, [])
    placement, _ = placed_alike(cliques=("pool-a", "pool-b"),
                                busy=("pool-a-h0", "pool-a-h1"))
    assert placement[0] == [f"pool-b-h{i}" for i in range(4)]


def test_a_failed_create_rolls_back_both_slices():
    """The sixth pod's name is taken: no pod of the two-slice job
    remains, as in the reference."""
    assert placed_alike(cliques=("pool-a", "pool-b"), num_slices=2,
                        conflict=("ms-1-1", "pool-b-h1")) == (None, [])


def test_h100_nodes_without_a_clique_form_one_pool():
    """Nodes without a clique (H100 HGX) are one pool joined by the
    data-centre network: a 3-node slice takes any 3 of them, in name
    order, but never mixes them with a clique's nodes."""
    from k8s_operator_libs_tpu_torch.core.fakecluster import FakeCluster
    from k8s_operator_libs_tpu_torch.gpu import (CLIQUE_LABEL, COUNT_LABEL,
                                                 PRODUCT_LABEL, GPUScheduler,
                                                 GPUWorkload)
    cluster = FakeCluster()
    for name in ("a", "b"):
        cluster.add_node(name, labels={PRODUCT_LABEL: H100,
                                       COUNT_LABEL: "8"})
    cluster.add_node("c", labels={PRODUCT_LABEL: H100, COUNT_LABEL: "8",
                                  CLIQUE_LABEL: "u.x"})
    sched = GPUScheduler(cluster.client)
    job = GPUWorkload(name="j", product=H100, gpus_per_node=8, num_nodes=3)
    assert sched.place(job) is None
    cluster.add_node("d", labels={PRODUCT_LABEL: H100, COUNT_LABEL: "8"})
    placement = sched.place(job)
    assert placement.node_names == ["a", "b", "d"]
    assert placement.slice_id == "a,b,d"
