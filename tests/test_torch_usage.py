"""The port's usage meter (``obs/usage.py``) held against the JAX
package's.

The reference's own tests (``tests/test_usage.py``) run on the port
through :mod:`torch_twin`, billing (``obs/billing.py``) included, except
those of ``cmd/status.py``'s usage views, which come with its port. Then seeded node-signal schedules (serving lanes,
training, maintenance states, quarantine, the market, degraded ticks)
go through both meters and every sealed record, payload, efficiency and
metrics text is compared with ``==``; a recording stand-in for the
billing engine sees the same calls from both.
"""

import importlib

import numpy as np
import pytest

from torch_twin import reference_tests

STATUS = "cmd/status.py's usage views"
globals().update(reference_tests(
    "test_usage.py",
    exclude={"test_render_usage_tables_and_waste_events": STATUS,
             "test_run_usage_view_exit_codes": STATUS,
             "test_efficiency_banner_contents_and_best_effort": STATUS,
             "test_banner_lines_precedence_is_pinned": STATUS,
             "test_dashboard_frame_leads_with_banners": STATUS}))

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}
LANES = ("interactive", "batch", "best-effort")
STATES = ("", "upgrade-required", "cordon-required", "drain-required",
          "pod-restart-required", "upgrade-done", "upgrade-failed")
OWNERS = ("", "training", "serving", "draining")


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


class RecordingBilling:
    """A billing engine with the reference's surface that records each
    call and prices nothing."""

    def __init__(self):
        self.calls = []

    def tail(self):
        self.calls.append(("tail",))
        return None

    def standby(self):
        self.calls.append(("standby",))

    def settle(self, record, lane_tokens=None):
        self.calls.append(("settle", record["tick"], lane_tokens))
        return record

    def summary(self):
        self.calls.append(("summary",))
        return {"tenants": {}}

    def fleet_goodput_fraction(self):
        self.calls.append(("fleet_goodput_fraction",))
        return 0.5


def run_meter(side, seed, billing=None, ticks=50):
    usage = mod(side, "obs.usage")
    clock = mod(side, "utils.clock").FakeClock(1000.0)
    hub = mod(side, "obs.metrics").MetricsHub()
    meter = usage.UsageMeter(clock=clock, metrics=hub, billing=billing,
                             max_waste_buckets=6)
    gen = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(int(gen.integers(6, 14)))]
    out = []
    for t in range(ticks):
        if gen.random() < 0.1 and t:
            record = meter.observe_degraded()
        else:
            signals = []
            for name in nodes:
                if gen.random() < 0.05:
                    continue        # a node missing from this tick's view
                signals.append(usage.NodeSignals(
                    node=name,
                    quarantined=bool(gen.random() < 0.08),
                    upgrade_state=STATES[int(gen.integers(len(STATES)))],
                    market_owner=OWNERS[int(gen.integers(len(OWNERS)))],
                    lane=(LANES[int(gen.integers(len(LANES)))]
                          if gen.random() < 0.5 else usage.LANE_NONE),
                    replica=bool(gen.random() < 0.5),
                    training=bool(gen.random() < 0.3)))
            tokens = {lane: int(gen.integers(0, 500)) for lane in LANES}
            record = meter.observe(signals, lane_tokens=tokens)
        out.append((record, meter.efficiency(), meter.kind_seconds(),
                    meter.lane_seconds(), meter.waste_buckets(top=3)))
        clock.advance(float(gen.integers(1, 30)))
    return out, meter.payload(), hub.render(prefix="tpu_operator")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_meters_seal_the_same_records(seed):
    """Every tick's sealed record (counts by kind and lane, capacity and
    running totals), efficiency, per-kind and per-lane seconds and the
    worst waste buckets; then the payload and the metrics text."""
    want, got = run_meter("reference", seed), run_meter("port", seed)
    for t, (a, b) in enumerate(zip(want[0], got[0])):
        assert b == a, f"tick {t}"
    assert got[1] == want[1]
    assert got[2] == want[2]
    record = got[0][-1][0]
    assert record["cum"]["capacity_s"] == pytest.approx(
        sum(got[0][-1][2].values()))


def test_a_billing_engine_sees_the_same_calls():
    """``billing=`` is a seam: the same engine surface is called in the
    same order with the same records by both meters."""
    calls = {}
    for side in ROOTS:
        billing = RecordingBilling()
        run_meter(side, 5, billing=billing, ticks=20)
        calls[side] = billing.calls
    assert calls["port"] == calls["reference"]
    assert ("tail",) in calls["port"]


@pytest.mark.parametrize("seed", [0, 1])
def test_billing_ledgers_are_byte_identical(seed, tmp_path):
    """Both packages' ``BillingEngine`` over their own ``UsageLedger``,
    fed by the seeded meters above with a small rotation cap: every
    ledger generation is the same bytes, and the summaries, the
    headline fraction and the tail agree."""
    out = {}
    for side in ROOTS:
        billing_mod = mod(side, "obs.billing")
        path = tmp_path / side / "usage.jsonl"
        engine = billing_mod.BillingEngine(
            billing_mod.UsageLedger(str(path), max_bytes=16384),
            clock=mod(side, "utils.clock").FakeClock(1000.0),
            lane_weights={"interactive": 4.0, "batch": 2.0,
                          "best-effort": 1.0})
        run_meter(side, seed, billing=engine, ticks=40)
        rotated = path.with_name(path.name + ".1")
        summary = engine.summary()
        assert summary.pop("ledger_path") == str(path)
        out[side] = (path.read_bytes(),
                     rotated.read_bytes() if rotated.exists() else None,
                     summary, engine.fleet_goodput_fraction(),
                     engine.ledger.tail())
    assert out["port"] == out["reference"]
    assert out["port"][1] is not None, "the cap never rotated the ledger"
