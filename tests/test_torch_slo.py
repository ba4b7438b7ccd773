"""The port's SLO stack (``obs/tsdb.py``, ``obs/slo.py``,
``obs/alerts.py``) held against the JAX package's.

The reference's own tests (``tests/test_slo.py``) run on the port through
:mod:`torch_twin`, its operator being the port's ``GPUOperator`` and its
operator binary the port's ``operator.py``; one is left out: the
slow-drain episode reads ``/alerts`` through ``cmd/status.py --slo`` in
its middle, so its operator part is twinned below, tick by tick.
Seeded streams of gauges, counters and histograms then go through both
packages' ``TimeSeriesStore``, ``SLOEngine`` and ``AlertManager``, and
every query, evaluation, alert state and event is compared with ``==``.
"""

import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

globals().update(reference_tests(
    "test_slo.py",
    renames=[("k8s_operator_libs_tpu_torch.tpu.operator import",
              "k8s_operator_libs_tpu_torch.gpu.operator import"),
             ("TPUOperator)\n", "GPUOperator as TPUOperator)\n"),
             # the port's hub renders under the workload prefix unless
             # told (its first users were the serving metrics)
             ("hub.render()", 'hub.render(prefix="tpu_operator")')],
    binaries=["operator"],
    exclude={"test_slow_drain_episode_fires_and_resolves_drain_latency_alert":
             "reads /alerts through cmd/status.py --slo; its operator part "
             "is test_slow_drain_pages_resolves_and_recovers_like_the_"
             "reference below"}))

from torch_operator_twin import NS, add_ds, run_twins  # noqa: E402

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def test_every_family_the_stack_reads_or_writes_has_help_text():
    """The default objectives' metric families and the families the SLO
    engine, the alert manager, the resilient client and the usage meter
    emit all have HELP entries (as in the reference), and every
    ``tpu_operator_slo_*``/``alert_*`` HELP entry is one of them."""
    help_texts = mod("port", "obs.metrics").HELP_TEXTS
    slo, alerts = mod("port", "obs.slo"), mod("port", "obs.alerts")
    res, usage = mod("port", "core.resilience"), mod("port", "obs.usage")
    emitted = (set(slo.SLO_GAUGE_FAMILIES) | set(alerts.ALERT_GAUGE_FAMILIES)
               | set(res.RESILIENCE_GAUGE_FAMILIES)
               | set(res.RESILIENCE_COUNTER_FAMILIES)
               | {f"tpu_operator_{f}" for f in
                  usage.USAGE_COUNTER_FAMILIES + usage.USAGE_GAUGE_FAMILIES})
    read = {spec["metric"] for spec in slo.DEFAULT_SLO_SPECS}
    assert (emitted | read) <= set(help_texts)
    assert {k for k in help_texts
            if k.startswith(("tpu_operator_slo_", "tpu_operator_alert_"))
            and not k.endswith("_attributed_total")} <= emitted
    ref = mod("reference", "obs.metrics").HELP_TEXTS
    assert all(help_texts[k] == ref[k] for k in emitted | read)


def feed(side, seed, ticks=120):
    """One seeded stream: per tick a gauge per component, a counter and
    drain-latency and TTFT histograms into a hub, scraped into a tsdb
    (small raw ring so downsampling runs) and evaluated by an engine over
    the default objectives plus a tight drain objective, whose alert
    conditions drive an alert manager. Returns what each tick read."""
    clock = mod(side, "utils.clock").FakeClock(10_000.0)
    hub = mod(side, "obs.metrics").MetricsHub()
    tsdb_mod, slo = mod(side, "obs.tsdb"), mod(side, "obs.slo")
    alerts = mod(side, "obs.alerts")
    tsdb = tsdb_mod.TimeSeriesStore(clock=clock, raw_points=32,
                                    downsample_every=4, coarse_points=64)
    opts = slo.SLOOptions.from_dict({
        "objectives": [{"name": "drain-tight",
                        "metric": "tpu_operator_drain_duration_seconds",
                        "kind": "events", "threshold": 30, "target": 0.9,
                        "window": "2h"}],
        "alerting": {"pageFor": 60, "ticketFor": 300}})
    engine = slo.SLOEngine(tsdb, opts.specs, clock=clock, metrics=hub)
    recorder = mod(side, "core.fakecluster").FakeCluster(
        clock=clock).recorder
    am = alerts.AlertManager(clock=clock, metrics=hub, recorder=recorder)
    gen = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        for comp in ("gpu", "plugin"):
            hub.set_gauge("unavailable_nodes", float(gen.integers(0, 3)),
                          labels={"component": comp})
        hub.inc("evictions_total", by=float(gen.integers(0, 4)))
        for _ in range(int(gen.integers(0, 3))):
            hub.observe("drain_duration_seconds",
                        float(gen.exponential(25.0)))
        for _ in range(int(gen.integers(0, 5))):
            hub.observe("serve_ttft_seconds", float(gen.exponential(1.0)))
        tsdb.scrape(hub=hub, extra_gauges={
            "tpu_operator_unavailable_nodes": [
                ({}, float(gen.integers(0, 2)))]})
        statuses = engine.evaluate()
        conds = engine.alert_conditions(statuses, page_for_s=opts.page_for_s,
                                        ticket_for_s=opts.ticket_for_s)
        am.evaluate(conds)
        out.append({
            "slo": statuses,
            "alerts": am.status(),
            "firing": am.firing(),
            "events": [(e.reason, e.object_name, e.event_type, e.message)
                       for e in recorder.drain()],
            "series": (tsdb.series_count(), tsdb.point_count(),
                       tsdb.dropped_series),
            "q": [tsdb.quantile("tpu_operator_drain_duration_seconds", q,
                                window_s=w)
                  for q in (0.5, 0.99) for w in (600.0, 7200.0)],
            "inc": tsdb.increase("tpu_operator_evictions_total",
                                 window_s=900.0),
            "frac": tsdb.time_fraction("tpu_operator_unavailable_nodes",
                                       None, 3600.0, lambda v: v > 0.0),
            "hub": hub.render(prefix="tpu_operator"),
        })
        clock.advance(float(gen.integers(10, 90)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tsdb_engine_and_alerts_agree_on_a_seeded_stream(seed):
    want, got = feed("reference", seed), feed("port", seed)
    for t, (a, b) in enumerate(zip(want, got)):
        for key in a:
            assert b[key] == a[key], f"tick {t}: {key}"
    assert any(tick["firing"] for tick in got)
    assert any(ev for tick in got for ev in tick["events"])


def test_a_planted_long_window_misread_is_caught(monkeypatch):
    """A planted fault: the engine reads each burn window's long half
    only (the short half replaced by it). The seeded stream's statuses
    then differ from the reference's."""
    slo = mod("port", "obs.slo")
    real = slo.SLOEngine.bad_fraction
    longs = {}

    def long_only(self, spec, window_s):
        for bw in spec.burn_windows:
            if window_s == bw.short_s:
                window_s = bw.long_s
        longs[spec.name] = True
        return real(self, spec, window_s)

    monkeypatch.setattr(slo.SLOEngine, "bad_fraction", long_only)
    want, got = feed("reference", 0), feed("port", 0)
    assert longs and any(a["slo"] != b["slo"] for a, b in zip(want, got))


SLOW_DRAIN = {
    "defaults": False,
    "objectives": [
        {"name": "drain-latency",
         "metric": "tpu_operator_drain_duration_seconds",
         "kind": "events", "threshold": 60, "target": 0.99,
         "window": "1d"}],
    "alerting": {"pageFor": 60, "ticketFor": 600},
}


def test_slow_drain_pages_resolves_and_recovers_like_the_reference():
    """``test_slow_drain_episode_fires_and_resolves_drain_latency_alert``'s
    operator part: 25 blocked evictions stretch one drain past the 60 s
    objective; the page alert goes pending, then fires with one Event; the
    episode ends, the alert resolves with one Event, and the budget
    recovers when the drain ages out of the window. Both operators, every
    tick compared (last_slo, the metrics text, events, nodes, pods)."""
    page = {}

    def setup(tw):
        ds = add_ds(tw, "libtpu")
        tw.add_host("n0", ds)
        tw.cluster.add_pod("workload", "n0")
        tw.cluster.block_eviction("default", "workload", times=25)
        tw.cluster.bump_daemonset_revision("libtpu", NS, "v2")
        tw.build([("libtpu", tw.api.DriverUpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=1,
            max_unavailable="100%",
            drain=tw.api.DrainSpec(enable=True, force=True,
                                   timeout_second=3600)))],
            slo=SLOW_DRAIN, usage=False)
        page[tw.side] = []

    def check(tw, t):
        page[tw.side].append(next(
            (a["state"] for a in tw.op.alert_manager.status()
             if a["rule"] == "drain-latency:burn:page"), "absent"))

    def hook(tw, t):
        if t >= 40:
            tw.clock.advance(600.0 if t < 50 else 3600.0)

    ref, port = run_twins(setup, 80, hook=hook, check=check)
    states = page["port"]
    assert states == page["reference"]
    assert "pending" in states and "firing" in states
    assert states.index("pending") < states.index("firing")
    assert states[-1] == "resolved"
    reasons = [e.reason for e in port.events
               if e.object_name == "drain-latency:burn:page"
               and e.reason in ("SLOAlertFiring", "SLOAlertResolved")]
    assert reasons == ["SLOAlertFiring", "SLOAlertResolved"]
    assert port.op.last_slo["drain-latency"]["error_budget_remaining"] == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_hub_snapshot_equals_the_reference(seed):
    """``MetricsHub.snapshot`` (what the tsdb scrapes) and
    ``histogram_families`` after the same seeded gauges, counters and
    observations, labelled and not, default and custom buckets."""
    seen = {}
    for side in ROOTS:
        hub = mod(side, "obs.metrics").MetricsHub()
        gen = np.random.default_rng(seed)
        for _ in range(200):
            r = gen.random()
            labels = ({"component": str(int(gen.integers(0, 3)))}
                      if gen.random() < 0.5 else None)
            value = float(gen.exponential(3.0))
            if r < 0.3:
                hub.set_gauge(f"g{int(gen.integers(0, 4))}", value, labels)
            elif r < 0.6:
                hub.inc(f"c{int(gen.integers(0, 3))}_total", value,
                        labels=labels)
            elif r < 0.8:
                hub.observe(f"h{int(gen.integers(0, 3))}", value, labels)
            else:
                hub.observe("b", value, labels, buckets=(0.5, 1.0, 4.0))
        seen[side] = (hub.snapshot(), hub.histogram_families())
    assert seen["port"] == seen["reference"]
