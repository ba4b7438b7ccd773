"""The port's downtime attribution (``obs/attribution.py``) held against
the JAX package's: seeded goodput ledgers (runs drained and resumed,
with drain saves, restores, re-warmups, compiles and idle gaps) and
seeded upgrade journeys go through both packages' ``windows_from_journey``,
``slice_window``, ``attribute_downtime`` and ``downtime_summary``, and
every report is compared with ``==``. Nothing here runs a model.
"""

import importlib
import json

import numpy as np
import pytest

ROOTS = {"reference": "k8s_operator_libs_tpu",
         "port": "k8s_operator_libs_tpu_torch"}
BADPUT = ("drain_save", "ckpt_restore", "rewarmup", "compile", "ckpt_save")


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def write_ledger(side, path, seed):
    """One seeded ledger: 2-4 runs, each but the last drained, with
    badput phases and goodput steps between gaps, written by the side's
    own ``GoodputLedger`` on its own ``FakeClock``."""
    gen = np.random.default_rng(seed)
    clock = mod(side, "utils.clock").FakeClock(1000.0)
    ledger_cls = mod(side, "obs.goodput").GoodputLedger
    step = 0
    runs = int(gen.integers(2, 5))
    for run in range(runs):
        ledger = ledger_cls(path, clock=clock)
        ledger.run_started(step)
        if run:
            for name in ("ckpt_restore", "compile", "rewarmup"):
                if gen.random() < 0.8:
                    with ledger.phase(name):
                        clock.advance(float(gen.uniform(0.1, 4.0)))
        for _ in range(int(gen.integers(1, 4))):
            wall = float(gen.uniform(0.2, 3.0))
            clock.advance(wall)
            n = int(gen.integers(1, 20))
            step += n
            ledger.steps(step, n, wall, 64 * n)
            if gen.random() < 0.3:
                with ledger.phase("ckpt_save"):
                    clock.advance(float(gen.uniform(0.1, 2.0)))
        last = run == runs - 1
        if not last:
            with ledger.phase("drain_save"):
                clock.advance(float(gen.uniform(0.5, 5.0)))
        ledger.run_ended(step, preempted=not last)
        ledger.close()
        clock.advance(float(gen.uniform(5.0, 60.0)))
    return mod(side, "obs.goodput").read_ledger(path)


def journey(seed, t0, t1):
    """A seeded journey spanning [t0, t1]: one or two passes through the
    pipeline, some states skipped, each entry a seeded dwell after the
    last."""
    gen = np.random.default_rng(seed + 1000)
    states = list(mod("port", "obs.attribution").WINDOW_PHASES)
    out, t = [], t0 + float(gen.uniform(-5.0, 5.0))
    for _ in range(int(gen.integers(1, 3))):
        for state in states[1:]:
            if gen.random() < 0.75:
                out.append([state, round(t, 3)])
                t += float(gen.uniform(0.0, (t1 - t0) / 8))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_attribution_equals_the_reference(tmp_path, seed):
    got = {}
    for side in ROOTS:
        att = mod(side, "obs.attribution")
        records = write_ledger(side, str(tmp_path / f"{side}.jsonl"), seed)
        t0, t1 = records[0]["t"], records[-1]["t"]
        entries = [tuple(e) for e in journey(seed, t0, t1)]
        others = [[tuple(e) for e in journey(seed + 50 + k, t0, t1)]
                  for k in range(2)]
        windows = att.windows_from_journey(entries, now=t1)
        window = att.slice_window([entries] + others, now=t1)
        reports = att.attribute_downtime(records, entries, now=t1)
        summaries = [att.downtime_summary(
            w, ckpt_fetch_s=1.5, ckpt_write_s=float(k * 7),
            ckpt_restore_s=2.25, rewarmup_s=0.5, baseline_replay_s=30.0)
            for k, w in enumerate(windows)]
        got[side] = json.loads(json.dumps({
            "records": records, "windows": [w.__dict__ for w in windows],
            "slice": window and window.__dict__, "reports": reports,
            "summaries": summaries}))
        for rep in reports:
            assert sum(rep["phases"].values()) == pytest.approx(
                rep["total_s"], abs=1e-9)
    assert got["port"] == got["reference"]
    assert got["port"]["reports"], "no window to attribute"


def test_window_phases_closed_over_upgrade_states():
    """``WINDOW_PHASES`` names every state of the port's ``UpgradeState``
    and no other, and equals the reference's table."""
    phases = mod("port", "obs.attribution").WINDOW_PHASES
    states = {v for k, v in vars(mod("port", "upgrade.consts").UpgradeState)
              .items() if not k.startswith("_") and isinstance(v, str)}
    assert set(phases) == states
    assert phases == mod("reference", "obs.attribution").WINDOW_PHASES
    assert set(phases.values()) == {"outside", "to_gate", "gate_to_restart",
                                    "after_restart"}
