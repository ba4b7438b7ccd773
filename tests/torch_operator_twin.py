"""Harness that holds the port's operator against the JAX package's,
tick by tick (``tests/test_torch_operator.py`` describes what it
compares and the by-design name map; ``tests/test_torch_slo.py`` and
``tests/test_torch_operator_config5.py`` use it too)."""

import dataclasses
import difflib
import importlib
import re

NS = "kube-system"
TICK = 15.0
H100 = "NVIDIA-H100-80GB-HBM3"
GB200 = "NVIDIA-GB200"
CLIQUE_NODES = 18

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}


class Twin:
    """One package's operator stack on a fleet of its own."""

    def __init__(self, side: str):
        root = ROOTS[side]

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.side = side
        self.api = mod("api.v1alpha1")
        self.S = mod("upgrade.consts").UpgradeState
        self.KeyFactory = mod("upgrade.util").KeyFactory
        self.hconsts = mod("health.consts")
        self.classifier = mod("health.classifier")
        self.monitor = mod("health.monitor")
        self.remediation = mod("health.remediation")
        self.slo = mod("obs.slo")
        self.usage = mod("obs.usage")
        self.metrics = mod("obs.metrics")
        self.resilience = mod("core.resilience")
        self.client_mod = mod("core.client")
        self.clock = mod("utils.clock").FakeClock(1000.0)
        self.cluster = mod("core.fakecluster").FakeCluster(
            clock=self.clock, cache_lag=0.5)
        if side == "reference":
            self.opmod = mod("tpu.operator")
            self.Operator = self.opmod.TPUOperator
            topo = mod("tpu.topology")
            self.topology_keys = (topo.GKE_ACCELERATOR_LABEL,
                                  topo.GKE_TOPOLOGY_LABEL,
                                  topo.GKE_NODEPOOL_LABEL)
            self.Workload = mod("tpu.scheduler").TPUWorkload
        else:
            self.opmod = mod("gpu.operator")
            self.Operator = self.opmod.GPUOperator
            topo = mod("gpu.topology")
            self.topology_keys = (topo.PRODUCT_LABEL, topo.COUNT_LABEL,
                                  topo.CLIQUE_LABEL)
            self.Workload = mod("gpu.scheduler").GPUWorkload
        self.topo = topo
        self.hub = self.metrics.MetricsHub()
        self.op = None
        self._uids = {}
        self.groups = {}          # reference group key -> port group key
        self.events = []          # every event recorded, in order

    # ---------------------------------------------------------- the fleet

    def single_labels(self):
        t = self.topo
        if self.side == "reference":
            return {t.GKE_ACCELERATOR_LABEL: "tpu-v5-lite-device",
                    t.GKE_TOPOLOGY_LABEL: "2x4"}
        return {t.PRODUCT_LABEL: H100, t.COUNT_LABEL: "8"}

    def group_labels(self, group):
        t = self.topo
        if self.side == "reference":
            return {t.GKE_ACCELERATOR_LABEL: "tpu-v5p-slice",
                    t.GKE_TOPOLOGY_LABEL: "2x6x6",
                    t.GKE_NODEPOOL_LABEL: group}
        return {t.PRODUCT_LABEL: GB200, t.COUNT_LABEL: "4",
                t.CLIQUE_LABEL: f"u.{group}"}

    def add_host(self, name, ds, revision_hash="v1", group=None,
                 pod=None):
        labels = (self.group_labels(group) if group
                  else self.single_labels())
        self.cluster.add_node(name, labels=labels)
        if group:
            self.groups[f"slice/{group}"] = f"clique/u.{group}"
        self.cluster.add_pod(pod or f"drv-{name}", name, namespace=NS,
                             owner_ds=ds, revision_hash=revision_hash)

    def add_group(self, ds, group, revision_hash="v1"):
        hosts = [f"{group}-h{i}" for i in range(CLIQUE_NODES)]
        for h in hosts:
            self.add_host(h, ds, revision_hash, group=group)
        return hosts

    def workload(self, name, group_hosts):
        """A job taking one whole group (``group_hosts`` hosts) or, with
        0, one single host."""
        if self.side == "reference":
            if group_hosts:
                return self.Workload(name=name, accelerator="tpu-v5p-slice",
                                     topology="2x6x6", namespace=NS)
            return self.Workload(name=name, accelerator="tpu-v5-lite-device",
                                 topology="2x4", namespace=NS)
        if group_hosts:
            return self.Workload(name=name, product=GB200, gpus_per_node=4,
                                 num_nodes=group_hosts, namespace=NS)
        return self.Workload(name=name, product=H100, gpus_per_node=8,
                             namespace=NS)

    # ------------------------------------------------------- the operator

    def policy(self, max_parallel=1, max_unavailable="25%"):
        return self.api.DriverUpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=max_parallel,
            max_unavailable=max_unavailable,
            drain=self.api.DrainSpec(enable=True, force=True,
                                     timeout_second=60))

    def health_options(self, damping=30.0, persist=60.0, recovery=45.0,
                       backoff=60.0, max_unavailable=None):
        return self.monitor.HealthOptions(
            classifier=self.classifier.ClassifierConfig(
                damping_seconds=damping, persist_seconds=persist),
            policy=self.remediation.RemediationPolicy(
                recovery_seconds=recovery, backoff_base_seconds=backoff,
                max_unavailable=max_unavailable))

    def build(self, components, health=None, slo=True, usage=True,
              client=None, **kw):
        """The operator over ``components`` ((name, policy) pairs); ``slo``
        True for the default objectives, a dict for ``SLOOptions``'s
        config section, False for none."""
        comps = [self.opmod.ManagedComponent(
            name=name, namespace=NS, driver_labels={"app": name},
            policy=policy) for name, policy in components]
        self.op = self.Operator(
            client or self.cluster.client, comps,
            recorder=self.cluster.recorder, clock=self.clock,
            synchronous=True, health=health, metrics=self.hub,
            slo=(self.slo.SLOOptions.from_dict(
                slo if isinstance(slo, dict) else {}) if slo else None),
            usage=(self.usage.UsageMeter(clock=self.clock, metrics=self.hub)
                   if usage else None), **kw)
        return self.op

    # --------------------------------------------------------- comparison

    def uid(self, uid):
        if not uid:
            return uid
        return self._uids.setdefault(uid, f"uid#{len(self._uids)}")

    def name(self, text):
        """The reference's words mapped onto the port's (only the
        by-design differences of the module docstring)."""
        if self.side != "reference":
            return text
        text = re.sub(r"slice/([A-Za-z0-9.-]+)",
                      lambda m: self.groups.get(m.group(0), m.group(0)),
                      text)
        if text in ("TPUOperator", "tpu-operator"):
            return text.replace("tpu", "gpu").replace("TPU", "GPU")
        text = text.replace("tpu-v5p-slice", GB200)
        return text.replace("tpu-v5-lite-device", H100)

    def norm(self, obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return self.norm(dataclasses.asdict(obj))
        if isinstance(obj, dict):
            return {self.norm(k): self.norm(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self.norm(v) for v in obj]
        if isinstance(obj, str):
            return self.name(obj)
        return obj

    @property
    def direct(self):
        return self.cluster.client.direct()

    def node(self, name):
        return self.direct.get_node(name)

    def snapshot(self):
        nodes = [(n.metadata.name, n.metadata.resource_version,
                  sorted((k, v) for k, v in n.metadata.labels.items()
                         if k not in self.topology_keys),
                  sorted(n.metadata.annotations.items()),
                  sorted((t.key, t.value, t.effect) for t in n.spec.taints),
                  n.spec.unschedulable)
                 for n in self.direct.list_nodes()]
        env_skip = {"TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY",
                    "LOCAL_WORLD_SIZE"}
        pods = [(p.metadata.namespace, p.metadata.name, p.spec.node_name,
                 self.uid(p.metadata.uid), p.status.phase,
                 [(c.ready, c.restart_count)
                  for c in p.status.container_statuses],
                 sorted(p.metadata.labels.items()),
                 sorted(("accelerator", v) if k in ("google.com/tpu",
                                                     "nvidia.com/gpu")
                        else (k, v)
                        for k, v in p.spec.resource_requests.items()),
                 sorted((k, v) for k, v in (p.spec.env or {}).items()
                        if k not in env_skip))
                for p in self.direct.list_pods()]
        drained = self.cluster.recorder.drain()
        self.events.extend(drained)
        events = [(self.name(e.object_kind), e.object_name, e.event_type,
                   e.reason, self.name(e.message)) for e in drained]
        op = self.op
        health = None
        if op.last_health is not None:
            health = self.norm(op.last_health)
        return {"nodes": nodes, "pods": pods, "events": events,
                "health": health, "slo": self.norm(op.last_slo),
                "pending": [w.name for w in op.pending_workloads],
                "placed": [(p.workload, p.node_names, p.pods)
                           for p in op.placements],
                "metrics": self.name(self.hub.render(prefix="tpu_operator"))}


def first_difference(want, got):
    """The first place two snapshots part, for the failure message."""
    if isinstance(want, str) and isinstance(got, str):
        return "\n".join(difflib.unified_diff(
            want.splitlines(), got.splitlines(), "reference", "port",
            lineterm="", n=0))
    if isinstance(want, list) and isinstance(got, list):
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                return f"[{i}] reference {a}\n[{i}] port      {b}"
        return f"lengths {len(want)} != {len(got)}"
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(want) | set(got), key=str):
            if want.get(k) != got.get(k):
                return f"[{k}] " + first_difference(want.get(k), got.get(k))
    return f"reference {want}\nport      {got}"


def run_twins(setup, ticks, hook=None, check=None, stop=None):
    """Build both twins with ``setup(twin)`` (which builds the operator),
    reconcile both for up to ``ticks`` ticks and compare every tick.
    ``hook(twin, t)`` runs before each tick, ``check(twin, t)`` after it
    on both; ``stop(twin)`` ends the run once it holds on the reference
    (and the port then agrees by the comparison). Returns the twins."""
    twins = [Twin("reference"), Twin("port")]
    for tw in twins:
        setup(tw)
    for t in range(ticks):
        snaps = []
        for tw in twins:
            if hook is not None:
                hook(tw, t)
            tw.op.reconcile()
            tw.cluster.reconcile_daemonsets()
            snaps.append(tw.snapshot())
            if check is not None:
                check(tw, t)
        want, got = snaps
        for key in want:
            assert got[key] == want[key], (
                f"tick {t}: {key} differs\n" + first_difference(want[key],
                                                                got[key]))
        if stop is not None and stop(twins[0]):
            assert stop(twins[1])
            break
        for tw in twins:
            tw.clock.advance(TICK)
    else:
        if stop is not None:
            raise AssertionError(f"no convergence in {ticks} ticks")
    return twins


def add_ds(tw, name="drv", revision_hash="v1"):
    return tw.cluster.add_daemonset(name, namespace=NS,
                                    labels={"app": name},
                                    revision_hash=revision_hash)


def in_progress(tw, keys, names):
    idle = ("", tw.S.DONE, tw.S.UPGRADE_REQUIRED)
    return sum(1 for n in names
               if tw.node(n).metadata.labels.get(keys.state_label, "")
               not in idle)
