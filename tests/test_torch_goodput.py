"""The port's goodput ledger and the trainer's telemetry, checkpoint and
profiler surface on the CPU: the ledger's records against the JAX
reference's (each package's ``summarize`` reads the other's file), the
run loop's sync discipline, the drain-save phase, asynchronous periodic
saves, the CLI's ``--metrics-textfile`` and ``--profile``."""

import dataclasses
import json
import threading
import types

import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.obs import goodput as jgoodput
from k8s_operator_libs_tpu.train.harness import (
    CheckpointingTrainer as JTrainer)
from k8s_operator_libs_tpu.utils.clock import FakeClock as JFakeClock
from k8s_operator_libs_tpu_torch import train
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
from k8s_operator_libs_tpu_torch.obs import goodput as tgoodput
from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
from k8s_operator_libs_tpu_torch.parallel import fsdp
from k8s_operator_libs_tpu_torch.train import harness
from k8s_operator_libs_tpu_torch.train.harness import CheckpointingTrainer
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _script(ledger_cls, clock, path):
    """Two runs on one ledger file: a fresh run that checkpoints and is
    drained, then a resumed run, every phase kind and record kind."""
    led = ledger_cls(path, clock=clock, flops_per_token=6e6,
                     peak_flops=1e12)
    led.run_started(0)
    clock.sleep(2.5)
    led.first_step(1, 2.5, 64)
    clock.sleep(1.0)
    led.steps(5, 4, 1.0, 256)
    with led.phase("ckpt_save"):
        clock.sleep(0.25)
    led.record_phase("degraded", clock.wall(), 3.0, devices_before=4,
                     devices_after=2, seconds_lost=1.5)
    with led.phase("drain_save"):
        clock.sleep(0.75)
    led.run_ended(5, True)
    led.close()
    clock.sleep(40.0)
    led = ledger_cls(path, clock=clock)
    assert led.resumed
    led.run_started(5)
    with led.phase("ckpt_restore"):
        clock.sleep(0.5)
    clock.sleep(1.5)
    led.first_step(6, 1.5, 64)
    clock.sleep(2.0)
    led.steps(10, 4, 2.0, 256)
    led.run_ended(10, False)
    led.close()


def test_ledger_records_and_summaries_match_reference(tmp_path):
    """The same scripted fake-clock runs give the same bytes in both
    packages' ledgers, and each package's ``summarize`` reads the other's
    file to the same summary."""
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    _script(tgoodput.GoodputLedger, FakeClock(1000.0), str(ours))
    _script(jgoodput.GoodputLedger, JFakeClock(1000.0), str(theirs))
    assert ours.read_text() == theirs.read_text()
    kinds = [json.loads(line)["kind"] for line in ours.read_text().split()]
    assert kinds.count("run_start") == 2 and kinds.count("phase") == 6
    mine = tgoodput.summarize(tgoodput.read_ledger(str(theirs)))
    ref = jgoodput.summarize(jgoodput.read_ledger(str(ours)))
    assert mine == ref
    assert mine["runs"] == 2 and mine["steps"] == 8
    assert mine["badput_s"]["rewarmup"] == 1.5
    assert mine["badput_s"]["degraded"] == 1.5
    assert mine["idle_gap_s"] == pytest.approx(42.75)  # drain -> first step
    hub = MetricsHub()
    tgoodput.publish_summary(mine, hub)
    assert hub.gauge("goodput_fraction") == pytest.approx(
        mine["goodput_fraction"])
    assert hub.gauge("badput_phase_seconds", {"phase": "idle_gap"}) == \
        pytest.approx(42.75)


def test_ledger_rotates_and_reads_across_the_rotation(tmp_path):
    """Past ``max_bytes`` the live file moves to ``.1``; ``read_ledger``
    reads the rotated generation first, and a new ledger on the path
    counts as resumed."""
    path = str(tmp_path / "g.jsonl")
    clock = FakeClock()
    led = tgoodput.GoodputLedger(path, clock=clock, max_bytes=300)
    led.run_started(0)
    for i in range(1, 8):
        clock.sleep(1.0)
        led.steps(i, 1, 1.0, 10)
    led.close()
    assert (tmp_path / "g.jsonl.1").exists()
    recs = tgoodput.read_ledger(path)
    steps = [r["step"] for r in recs if r["kind"] == "step"]
    assert len(steps) >= 2 and steps == list(range(8 - len(steps), 8))
    assert tgoodput.GoodputLedger(path, clock=clock).resumed


class _Leaf:
    """Stands in for an in-flight device scalar: counts host
    conversions, which would each wait for the device."""

    def __init__(self, counters):
        self._counters = counters

    def __float__(self):
        self._counters["convert"] += 1
        return 0.0

    def __int__(self):
        self._counters["convert"] += 1
        return 0

    def item(self):
        self._counters["convert"] += 1
        return 0.0


def _fake_trainer(tmp_path, clock, counters, **kw):
    led = tgoodput.GoodputLedger(str(tmp_path / "goodput.jsonl"),
                                 clock=clock)

    def step_fn(state, batch):
        clock.sleep(0.1)
        state.step += 1
        return state, {"step": _Leaf(counters), "loss": _Leaf(counters)}

    trainer = CheckpointingTrainer(None, str(tmp_path / "ckpt"),
                                   device="cpu", step_fn=step_fn,
                                   init_fn=lambda seed: None, ledger=led,
                                   **kw)
    trainer._sync = lambda: counters.__setitem__("sync",
                                                 counters["sync"] + 1)
    return trainer, led


def _batches():
    while True:
        yield np.zeros((2, 5), np.int32)


def test_trainer_blocks_only_at_sync_boundaries(tmp_path):
    """The port of the reference's sync-counting test: 20 steps at
    sync_every=5 wait for the device exactly 5 times (first step, every
    5th window, the end) and never convert a metric on the host."""
    clock = FakeClock()
    counters = {"sync": 0, "convert": 0}
    trainer, led = _fake_trainer(tmp_path, clock, counters,
                                 checkpoint_interval=10_000,
                                 metrics_sync_every=5)
    seen = []
    result = trainer.run(types.SimpleNamespace(step=0), _batches(),
                         num_steps=20, on_step=lambda s, m: seen.append(s))
    trainer.close()
    led.close()
    assert result.steps_done == 20
    assert seen == list(range(1, 21))
    assert counters == {"sync": 5, "convert": 0}
    records = tgoodput.read_ledger(led.path)
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["n"] for r in steps] == [5, 5, 5, 4]
    assert sum(r["wall_s"] for r in steps) == pytest.approx(1.9)
    assert sum(r["tokens"] for r in steps) == 19 * 8
    first = [r for r in records if r["kind"] == "phase"]
    assert first[0]["phase"] == "compile"
    assert first[0]["duration_s"] == pytest.approx(0.1)


def test_trainer_drain_records_drain_save_phase(tmp_path):
    clock = FakeClock()
    counters = {"sync": 0, "convert": 0}
    trainer, led = _fake_trainer(tmp_path, clock, counters,
                                 checkpoint_interval=10_000)
    saves = []
    trainer.save = lambda state, wait=False: saves.append(wait) or 7
    result = trainer.run(types.SimpleNamespace(step=0), _batches(),
                         num_steps=50,
                         drain_signal=lambda: not saves and
                         clock.now() > 0.25)
    trainer.close()
    led.close()
    assert result.preempted and saves == [True]
    assert result.last_checkpoint_step == 7
    records = tgoodput.read_ledger(led.path)
    assert any(r.get("phase") == "drain_save" for r in records)
    end = [r for r in records if r["kind"] == "run_end"]
    assert end and end[0]["preempted"] is True and end[0]["step"] == 3


def test_drain_books_every_step_the_reference_drops(tmp_path):
    """A drain between sync boundaries: the port books the steps since
    the last sync as goodput before the save, so the ledger holds every
    step but the first (badput); the reference's loop leaves them out."""
    counts = {}
    for name, make in (("port", None), ("reference", JTrainer)):
        clock = FakeClock() if make is None else JFakeClock()
        ledger_cls = (tgoodput.GoodputLedger if make is None
                      else jgoodput.GoodputLedger)
        led = ledger_cls(str(tmp_path / f"{name}.jsonl"), clock=clock)

        def step_fn(state, batch, clock=clock):
            clock.sleep(0.1)
            return state, {"loss": 0.0}

        saves = []
        if make is None:
            trainer = CheckpointingTrainer(
                None, str(tmp_path / name), device="cpu", step_fn=step_fn,
                init_fn=lambda seed: None, checkpoint_interval=10_000,
                ledger=led)
        else:
            trainer = make(None, str(tmp_path / name), step_fn=step_fn,
                           init_fn=lambda rng: None,
                           checkpoint_interval=10_000, ledger=led)
        trainer.save = lambda state, wait=False, saves=saves: (
            saves.append(wait) or 0)
        result = trainer.run(types.SimpleNamespace(step=0), _batches(),
                             num_steps=50,
                             drain_signal=lambda clock=clock, saves=saves:
                             not saves and clock.now() > 0.45)
        trainer.close()
        led.close()
        assert result.preempted and result.steps_done == 5
        counts[name] = sum(r["n"] for r in tgoodput.read_ledger(led.path)
                           if r["kind"] == "step")
    assert counts == {"port": 4, "reference": 0}


def _tokens(seed, B=2, T=9):
    return np.random.default_rng(seed).integers(0, 512, size=(B, T)
                                                ).astype(np.int32)


def test_async_save_holds_its_own_step(tmp_path, monkeypatch):
    """A periodic checkpoint whose write is held back until two later
    steps have updated the state in place holds exactly its own step's
    parameters and moments; ``latest_step`` does not see it while it is
    in flight; the drain save is on disk when ``run`` returns; ``close``
    waits for a write in flight."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert release.wait(60), "the write was never released"
        real_save(obj, path)

    monkeypatch.setattr(harness.torch, "save", held_save)
    trainer = CheckpointingTrainer(cfg, str(tmp_path / "ck"),
                                   optimizer=fsdp.default_optimizer(LR),
                                   checkpoint_interval=2, device="cpu")
    state = trainer.init_or_resume(0)
    snaps, latest = {}, {}

    def on_step(step, metrics):
        snaps[step] = {k: [t.clone() for t in fsdp.param_leaves(tree)]
                       for k, tree in (("params", state.params),
                                       ("mu", state.opt_state.mu),
                                       ("nu", state.opt_state.nu))}
        latest[step] = trainer.latest_step
        if step == 4:
            release.set()

    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return calls["n"] == 6               # before the 6th step

    data = (_tokens(s) for s in range(100))
    result = trainer.run(state, data, 10, drain_signal=drain,
                         on_step=on_step)
    assert result.preempted and result.last_checkpoint_step == 5
    assert (tmp_path / "ck" / "5" / "state.pt").exists()
    # step 2's write was held while steps 3 and 4 ran: not visible then
    assert latest[3] is None and latest[4] is None
    for step in (2, 4, 5):
        d = torch.load(tmp_path / "ck" / str(step) / "state.pt",
                       weights_only=True)
        assert d["step"] == step and d["opt"]["count"] == step
        for key, tree in (("params", d["params"]), ("mu", d["opt"]["mu"]),
                          ("nu", d["opt"]["nu"])):
            for got, want in zip(fsdp.param_leaves(tree), snaps[step][key]):
                assert torch.equal(got, want), (step, key)
    # after the drain, no save is in flight and no temporary is left
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith(".tmp-")]
    release.clear()
    trainer.save(dataclasses.replace(result.state, step=6))   # held
    assert trainer.latest_step == 5
    threading.Timer(0.2, release.set).start()
    trainer.close()
    assert trainer.latest_step == 6


def _cli_argv(tmp_path, *extra, model="tiny", steps=4):
    data = tmp_path / "tokens.bin"
    if not data.exists():
        tloader.write_token_file(str(data), _tokens(8, B=1, T=4000)[0])
    return ["--data", str(data), "--ckpt", str(tmp_path / "ck"), "--model",
            model, "--steps", str(steps), "--batch", "2", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu", *extra]


def test_cli_textfile_holds_the_goodput_gauges(tmp_path, capsys):
    """``--metrics-textfile`` at exit: the ledger's families and the
    summary gauges under ``tpu_workload``; the summary line printed; a
    ``--goodput-log`` path gets the ledger."""
    text = tmp_path / "train.prom"
    log = tmp_path / "g" / "goodput.jsonl"
    assert train.main(_cli_argv(tmp_path, "--metrics-textfile", str(text),
                                "--goodput-log", str(log),
                                "--goodput-sync-every", "1")) == 0
    out = capsys.readouterr().out
    assert "goodput: " in out and "of accounted time" in out
    prom = text.read_text()
    for family in ("tpu_workload_goodput_fraction",
                   "tpu_workload_goodput_seconds",
                   'tpu_workload_badput_phase_seconds{phase="compile"}',
                   'tpu_workload_badput_phase_seconds{phase="ckpt_save"}',
                   'tpu_workload_badput_phase_seconds{phase="idle_gap"}',
                   "tpu_workload_step_duration_seconds_count 3",
                   'tpu_workload_badput_seconds_count{phase="ckpt_save"} 2',
                   "tpu_workload_tokens_per_s"):
        assert family in prom, family
    assert "# HELP tpu_workload_goodput_fraction Productive" in prom
    s = tgoodput.summarize(tgoodput.read_ledger(str(log)))
    assert s["steps"] == 3 and s["last_step"] == 4
    assert not (tmp_path / "ck" / "goodput.jsonl").exists()


def test_cli_drain_and_resume_book_every_phase(tmp_path, capsys):
    """A run drained at step 3 and resumed to 6 on one ledger: compile,
    the periodic saves, the drain save with its fetch/write split, the
    restore, the re-warmup and one unavailability window from the drain
    save to the resumed run's first goodput step."""
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return calls["n"] == 4               # before the 4th step

    argv = _cli_argv(tmp_path, "--goodput-sync-every", "1", steps=6)
    assert train.main(argv, drain_signal=drain) == 0
    assert train.main(argv) == 0
    capsys.readouterr()
    records = tgoodput.read_ledger(str(tmp_path / "ck" / "goodput.jsonl"))
    phases = [r["phase"] for r in records if r["kind"] == "phase"]
    # the interval counts the steps of each run: the resumed run (steps
    # 4-6) saves after its second, step 5, as the reference's loop does
    assert phases == ["compile", "ckpt_save", "drain_save", "ckpt_restore",
                      "rewarmup", "ckpt_save"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name.isdigit()) == ["2", "3", "5"]
    drain_rec = next(r for r in records if r.get("phase") == "drain_save")
    assert drain_rec["fetch_s"] >= 0 and drain_rec["write_s"] > 0
    assert drain_rec["duration_s"] >= drain_rec["write_s"]
    s = tgoodput.summarize(records)
    assert s["runs"] == 2 and s["steps"] == 4 and s["last_step"] == 6
    (start, end), = s["unavailability_windows"]
    assert start == drain_rec["t"] and end > start
    assert s["phases"]["drain_save"]["write_s"] == drain_rec["write_s"]


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert train.main(_cli_argv(tmp_path, "--profile", str(prof),
                                "--goodput-log", "off")) == 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert not torch._C._autograd._profiler_enabled()


def test_cli_profile_stops_when_a_step_raises(tmp_path, monkeypatch):
    """A step that raises after the trace started: the trace is still
    written, the profiler is off again, and the exception propagates."""
    real = harness.make_train_step

    def failing(cfg, optimizer=None, **kw):
        step = real(cfg, optimizer, **kw)
        calls = {"n": 0}

        def wrapped(state, tokens):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("step 3 failed")
            return step(state, tokens)

        return wrapped

    monkeypatch.setattr(harness, "make_train_step", failing)
    prof = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="step 3 failed"):
        train.main(_cli_argv(tmp_path, "--profile", str(prof)))
    assert len(list(prof.glob("*.pt.trace.json"))) == 1
    assert not torch._C._autograd._profiler_enabled()
    records = tgoodput.read_ledger(str(tmp_path / "ck" / "goodput.jsonl"))
    assert [r["kind"] for r in records][:2] == ["run_start", "phase"]
