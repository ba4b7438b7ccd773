"""The port's elastic trainer (shrink and grow over a re-formed process
group) against the JAX package's.

- One process, injected factories and string members: the reference's
  own cases (``tests/test_elastic.py``), branch for branch.
- The ledger: the same clock script through both packages'
  ``GoodputLedger.degraded`` reads alike in both ``summarize``s.
- Ranks (gloo, ``parallel/launch.py``): the group re-formed over a file
  and over a TCP rendezvous; the tiny fp32 Llama trained 4 -> 2 -> 4
  ranks, the shrink reclaiming rank 0, two joiners started into the
  grow's generation. After each resize the losses and final parameters
  equal a cold start from the same checkpoint (the reference's bounds,
  rel 1e-5 / atol 1e-6), and a resize whose restore re-initializes the
  moments fails that check; the losses match the JAX elastic trainer on
  ``devices[:4] -> [:2] -> [:4]`` of the virtual CPU mesh on the same
  weights and batches; the ledger is one run through the writer's move.
- The market: the JAX package's ``CapacityArbiter`` trades the port
  trainer's devices away and back.
"""

import dataclasses
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.data.loader import TokenDataset as JaxTokenDataset
from k8s_operator_libs_tpu.market import (CapacityArbiter, ManagedSlice,
                                          MarketConfig)
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.obs import goodput as jgoodput
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_operator_libs_tpu.serving import (LANES, Replica, ReplicaPool,
                                           RequestRouter, SimReplicaRuntime)
from k8s_operator_libs_tpu.train import harness as jharness
from k8s_operator_libs_tpu.utils.clock import FakeClock as JaxFakeClock
from k8s_operator_libs_tpu_torch.data.loader import write_token_file
from k8s_operator_libs_tpu_torch.obs import goodput as tgoodput
from k8s_operator_libs_tpu_torch.parallel import distributed as tdist
from k8s_operator_libs_tpu_torch.parallel import launch
from k8s_operator_libs_tpu_torch.train.harness import (CheckpointingTrainer,
                                                       GrowNotice,
                                                       ReclaimNotice)
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

GROUP_TIMEOUT = 120.0
LR = 3e-4
BATCH, SEED, STEPS = 4, 3, 6
SHRINK_AT, GROW_AT = 2, 4
START = launch.Job.members(0, 4)            # localhost/0 .. localhost/3
SURVIVORS = START[2:]                      # the shrink reclaims rank 0
GROWN = SURVIVORS + launch.Job.members(4, 2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- one process

def _zeros():
    while True:
        yield np.zeros((1, 2), np.int32)


def _stub_trainer(tmp_path, clock, ledger, elastic, **kwargs):
    def step_factory(mesh):
        def step_fn(state, batch):
            clock.sleep(0.1)
            return types.SimpleNamespace(step=state.step + 1), {"loss": 0.0}
        return step_fn

    trainer = CheckpointingTrainer(
        None, str(tmp_path / "ckpt"), device="cpu",
        step_fn=step_factory(None),
        init_fn=lambda seed: types.SimpleNamespace(step=0),
        step_factory=step_factory,
        init_factory=lambda mesh: (lambda seed: types.SimpleNamespace(
            step=0)),
        checkpoint_interval=10_000, ledger=ledger, elastic=elastic,
        mesh_factory=lambda members: ("mesh", len(members)), **kwargs)
    saves = []
    trainer.save = (lambda state, wait=False:
                    saves.append((int(state.step), wait))
                    or int(state.step))
    trainer._saves = saves
    return trainer


@pytest.mark.parametrize("missing", ["step_factory", "init_factory"])
def test_elastic_requires_factories_with_a_custom_step_or_init(tmp_path,
                                                               missing):
    kwargs = {"step_factory": lambda m: (lambda s, b: (s, {})),
              "init_factory": lambda m: (lambda seed: None)}
    del kwargs[missing]
    with pytest.raises(ValueError, match=missing):
        CheckpointingTrainer(None, str(tmp_path / "c"), device="cpu",
                             elastic=True, step_fn=lambda s, b: (s, {}),
                             init_fn=lambda seed: None, **kwargs)


@pytest.mark.parametrize("elastic,survivors", [(False, ["a", "b"]),
                                               (True, [])])
def test_inelastic_or_total_reclaim_exits_preempted(tmp_path, elastic,
                                                    survivors):
    """A reclaim of an inelastic trainer, or a total one, is a drain: a
    synchronous save and a preempted run end, whose unavailability window
    the resumed run closes."""
    clock = FakeClock(1000.0)
    led = tgoodput.GoodputLedger(str(tmp_path / "goodput.jsonl"),
                                 clock=clock)
    trainer = _stub_trainer(tmp_path, clock, led, elastic=elastic)
    notices = iter([None, None, ReclaimNotice(surviving_devices=survivors)])
    result = trainer.run(types.SimpleNamespace(step=0), _zeros(),
                         num_steps=50,
                         reclaim_signal=lambda: next(notices, None))
    led.close()
    assert result.preempted and result.steps_done == 2
    assert result.reshards == 0 and not result.reclaimed
    assert trainer._saves == [(2, True)]
    records = tgoodput.read_ledger(led.path)
    assert [r["preempted"] for r in records if r["kind"] == "run_end"] \
        == [True]
    assert any(r.get("phase") == "drain_save" for r in records)
    clock.sleep(40.0)
    led2 = tgoodput.GoodputLedger(led.path, clock=clock)
    led2.run_started(2)
    clock.sleep(1.0)
    led2.steps(3, 1, 1.0, 64)
    led2.close()
    windows = tgoodput.unavailability_windows(tgoodput.read_ledger(led.path))
    assert len(windows) == 1
    assert windows[0][1] - windows[0][0] == pytest.approx(40.0, abs=0.3)


def _shrink_then_grow(tmp_path, shrink_to, grow_to, num_steps, grow_after):
    clock = FakeClock(5000.0)
    led = tgoodput.GoodputLedger(str(tmp_path / "goodput.jsonl"),
                                 clock=clock)
    trainer = _stub_trainer(tmp_path, clock, led, elastic=True)
    trainer.init_or_resume = lambda seed: types.SimpleNamespace(step=4)
    trainer._device_count = 8
    notices = iter([None] * 3 + [ReclaimNotice(surviving_devices=shrink_to)])
    seen, grown = [], []

    def grow():
        if (grow_to and trainer._device_count == len(shrink_to)
                and len(seen) >= grow_after and not grown):
            grown.append(True)
            return GrowNotice(devices=grow_to)
        return None

    result = trainer.run(types.SimpleNamespace(step=0), _zeros(),
                         num_steps=num_steps,
                         on_step=lambda s, m: seen.append(s),
                         reclaim_signal=lambda: next(notices, None),
                         grow_signal=grow)
    led.close()
    return trainer, result, tgoodput.read_ledger(led.path)


@pytest.mark.parametrize("shrink_to,grow_to,lost", [
    (list("abcd"), None, [0.5]),                 # a shrink alone
    (list("abcd"), list("abcdefgh"), [0.5]),     # and back: closed
    (list("ab"), list("abcd"), [0.75, 0.5]),     # partial: re-priced
])
def test_elastic_resizes_keep_one_run_and_price_degraded(tmp_path,
                                                         shrink_to, grow_to,
                                                         lost):
    """One run, no unavailability window, every resize a synchronous
    save; each window on fewer members than the baseline (8) is one
    ``degraded`` record priced duration x the capacity share lost, which
    ``summarize`` (either package's) charges instead of the duration."""
    trainer, result, records = _shrink_then_grow(tmp_path, shrink_to,
                                                 grow_to, 12, 6)
    resizes = 1 + (grow_to is not None)
    assert not result.preempted and result.steps_done == 12
    assert result.reshards == resizes
    assert result.device_count == len(grow_to or shrink_to)
    assert [w for _, w in trainer._saves] == [True] * resizes
    assert len(tgoodput.split_runs(records)) == 1
    assert tgoodput.unavailability_windows(records) == []
    degraded = [r for r in records if r.get("phase") == "degraded"]
    assert [d["devices_before"] for d in degraded] == [8] * len(lost)
    for d, share in zip(degraded, lost):
        assert d["duration_s"] > 0
        assert d["seconds_lost"] == pytest.approx(d["duration_s"] * share)
    want = sum(d["seconds_lost"] for d in degraded)
    for summarize in (tgoodput.summarize, jgoodput.summarize):
        s = summarize(records)
        assert s["runs"] == 1
        assert s["badput_s"]["degraded"] == pytest.approx(want)


@pytest.mark.parametrize("elastic,devices", [(False, list("abcdefgh")),
                                             (True, [])])
def test_grow_ignored_when_inelastic_or_not_larger(tmp_path, elastic,
                                                   devices):
    trainer = _stub_trainer(tmp_path, FakeClock(), None, elastic=elastic)
    result = trainer.run(types.SimpleNamespace(step=0), _zeros(),
                         num_steps=3,
                         grow_signal=lambda: GrowNotice(devices=devices))
    assert result.reshards == 0 and result.steps_done == 3
    assert trainer._saves == []


def test_degraded_record_matches_the_reference(tmp_path):
    """The same clock script through both ledgers: the same records, and
    each package's ``summarize`` reads the other's file alike."""
    paths = {}
    for name, ledger_cls, clock in (
            ("port", tgoodput.GoodputLedger, FakeClock(100.0)),
            ("ref", jgoodput.GoodputLedger, JaxFakeClock(100.0))):
        led = ledger_cls(str(tmp_path / f"{name}.jsonl"), clock=clock)
        led.run_started(0)
        clock.sleep(2.0)
        led.steps(4, 4, 2.0, 256)
        for before, after, seconds in ((8, 4, 3.3), (8, 6, 1.7),
                                       (3, 1, 2.0 / 3.0)):
            t0 = clock.wall()
            clock.sleep(seconds)
            led.degraded(t0, clock.wall() - t0, before, after)
        led.run_ended(8, False)
        led.close()
        paths[name] = led.path
    port = tgoodput.read_ledger(paths["port"])
    ref = jgoodput.read_ledger(paths["ref"])
    assert port == ref
    degraded = [r for r in port if r.get("phase") == "degraded"]
    for d, share in zip(degraded, (0.5, 0.25, 2.0 / 3.0)):
        assert d["seconds_lost"] == round(d["duration_s"] * share, 6)
    assert tgoodput.summarize(ref) == jgoodput.summarize(port)


def test_the_market_trades_the_port_trainer_away_and_back(tmp_path):
    """The JAX package's capacity arbiter, over a flash crowd on the
    serving simulator, preempts the training slice (the port trainer
    shrinks 8 -> 4) and returns it (it grows back): one run, priced
    degraded, never downtime."""
    clock = JaxFakeClock(10_000.0)
    ledger = tgoodput.GoodputLedger(str(tmp_path / "goodput.jsonl"),
                                    clock=clock)
    pool = ReplicaPool(component="libtpu", clock=clock)
    for i in range(2):
        pool.register(Replica(f"srv-{i}", f"n-s{i}", SimReplicaRuntime(
            max_slots=2, tokens_per_step=4)))
    router = RequestRouter(pool, clock=clock, shed_high=24)
    devices = [f"chip{i}" for i in range(8)]
    burst = {"id": None, "n": 0}

    def grant(ms):
        burst["n"] += 1
        replica = Replica(f"burst-{burst['n']}", ms.anchor,
                          SimReplicaRuntime(max_slots=2, tokens_per_step=4))
        pool.register(replica)
        burst["id"] = replica.id

    def revoke(ms):
        replica = pool.replicas.get(burst["id"]) if burst["id"] else None
        if replica is None:
            return True
        if not replica.draining:
            router.drain_replica(replica, "market-return")
        if replica.drained:
            pool.deregister(replica.id)
            burst["id"] = None
            return True
        return False

    flags = {"preempted": False, "returned": False}
    arb = CapacityArbiter(
        [ManagedSlice("train-0", ["n-t0"])], demand=router,
        goodput_fn=lambda: 1.0,
        preempt=lambda ms: flags.__setitem__("preempted", True),
        vacated=lambda ms: trainer._device_count == 4,
        grant=grant, revoke=revoke,
        returned=lambda ms: flags.__setitem__("returned", True),
        clock=clock,
        config=MarketConfig(preempt_rate=1.2, return_rate=0.3,
                            sustain_ticks=2, cooldown_seconds=25.0,
                            queue_high=4.0))
    tick = {"n": 0, "rid": 0}

    def world_tick():
        arrivals = 16 if 10 <= tick["n"] < 30 else 1
        for _ in range(arrivals):
            router.submit([tick["rid"] % 311, 7], 4,
                          lane=LANES[tick["rid"] % 3])
            tick["rid"] += 1
        router.tick()
        arb.tick()
        for r in pool.replicas.values():
            if not r.failed:
                r.runtime.step()

    def step_factory(mesh):
        def step_fn(state, batch):
            clock.advance(1.0)
            tick["n"] += 1
            world_tick()
            return types.SimpleNamespace(step=state.step + 1), {}
        return step_fn

    trainer = CheckpointingTrainer(
        None, str(tmp_path / "ckpt"), device="cpu",
        step_fn=step_factory(None),
        init_fn=lambda seed: types.SimpleNamespace(step=0),
        step_factory=step_factory,
        init_factory=lambda mesh: (lambda seed: types.SimpleNamespace(
            step=0)),
        mesh_factory=lambda members: ("mesh", len(members)),
        checkpoint_interval=10_000, ledger=ledger, elastic=True)
    trainer.save = lambda state, wait=False: int(state.step)
    trainer.init_or_resume = lambda seed: types.SimpleNamespace(
        step=tick["n"])
    trainer._device_count = 8

    def reclaim_signal():
        if flags["preempted"] and trainer._device_count == 8:
            flags["preempted"] = False
            return ReclaimNotice(surviving_devices=devices[:4])
        return None

    def grow_signal():
        if flags["returned"] and trainer._device_count == 4:
            flags["returned"] = False
            return GrowNotice(devices=devices)
        return None

    result = trainer.run(types.SimpleNamespace(step=0), _zeros(),
                         num_steps=90, reclaim_signal=reclaim_signal,
                         grow_signal=grow_signal)
    ledger.close()
    assert arb.trades == 1 and arb.returns == 1, arb.decisions
    assert result.reshards == 2 and result.device_count == 8
    assert not result.preempted and result.steps_done == 90
    records = tgoodput.read_ledger(ledger.path)
    assert len(tgoodput.split_runs(records)) == 1
    assert tgoodput.unavailability_windows(records) == []
    degraded = [r for r in records if r.get("phase") == "degraded"]
    assert [(d["devices_before"], d["devices_after"]) for d in degraded] \
        == [(8, 4)]
    assert degraded[0]["seconds_lost"] == pytest.approx(
        degraded[0]["duration_s"] * 0.5)
    assert jgoodput.summarize(records)["badput_s"]["degraded"] == \
        pytest.approx(degraded[0]["seconds_lost"])


# ------------------------------------------------------------- ranks

@pytest.mark.parametrize("rendezvous", ["file", "tcp"])
def test_the_group_reforms_without_a_leaving_rank(tmp_path, rendezvous):
    """Generation 0 over 3 ranks, 1 over the two that survive rank 0's
    reclaim, 2 over those and a joiner: each generation's members see
    each other in the list's order, and generation g's TCP store is
    served by its first member at the job's port + g."""
    start = launch.Job.members(0, 3)
    grown = start[1:] + launch.Job.members(3, 1)
    with launch.Job(timeout=GROUP_TIMEOUT, workdir=str(tmp_path),
                    rendezvous=rendezvous) as job:
        job.start(ranks.reform_member, start, start[1:], grown)
        job.start(ranks.reform_joiner, grown, generation=2,
                  only=grown[-1:])
        out = job.wait()
        base = job.rendezvous
    assert out[start[0]] == {"left_at": 1, "seen": [out[start[0]]["seen"][0]]}
    views = {name: {v["generation"]: v for v in r["seen"]}
             for name, r in out.items()}
    for g, members in ((0, start), (1, start[1:]), (2, grown)):
        n = len(members)
        for rank, name in enumerate(members):
            v = views[name][g]
            assert v["rank"] == rank and v["names"] == members
            assert v["sum"] == n * (n + 1) / 2
            if g == 0:
                assert v["init"] == base
            elif rendezvous == "file":
                assert v["init"] == f"{base}.g{g}"
            else:
                port = int(base.rsplit(":", 1)[1])
                assert v["init"] == f"tcp://localhost:{port + g}"


@pytest.mark.parametrize("worker", [0, 3])
def test_cluster_membership_serves_each_generation_from_its_first_member(
        worker):
    """The scheduler's env as a membership: generation 0 meets at the
    coordinator (rank 0's pod), as ``cluster_env`` says; after a shrink
    that reclaims rank 0, generation 1's store is served by its first
    member's host at the coordinator's port + 1."""
    env = {"TPU_WORKER_ID": str(worker),
           "TPU_WORKER_HOSTNAMES": "j-0.j,j-1.j,j-2.j,j-3.j",
           "JAX_COORDINATOR_ADDRESS": "j-0.j:8476"}
    m = tdist.cluster_membership(env, backend="gloo")
    want = tdist.cluster_env(env)
    assert m.init_method() == want["init_method"]
    assert (len(m.members), m.rank) == (want["world_size"], want["rank"])
    assert m.me == f"j-{worker}.j/cuda:0"
    nxt = dataclasses.replace(m, members=m.members[2:], generation=1)
    assert nxt.init_method() == "tcp://j-2.j:8477"
    assert tdist.cluster_membership(
        dict(env, MEGASCALE_NUM_SLICES="2")) is None



def test_a_taken_rendezvous_port_fails_the_join_and_the_reform(tmp_path):
    """Generation g's TCP store is served at the job's port + g by its
    first member. With another socket on that port, the first member's
    join raises a clear error, and a re-formation onto it raises on every
    member before any leaves the old group: none waits at a store that
    will never answer."""
    import socket
    with socket.socket() as squatter:
        squatter.bind(("localhost", 0))
        squatter.listen()
        port = squatter.getsockname()[1]
        m = tdist.Membership(f"tcp://localhost:{port - 1}",
                             ("localhost/0", "localhost/1"), "localhost/0",
                             "gloo", generation=1)
        assert m.port_taken() and f"port {port}" in m.port_taken()
        assert dataclasses.replace(m, me="localhost/1").port_taken() is None
        with pytest.raises(tdist.RendezvousPortTaken,
                           match=f"generation 1's rendezvous port {port} "):
            m.join()
    with launch.Job("gloo", 60.0, str(tmp_path), rendezvous="tcp") as job:
        job.start(ranks.reform_onto_a_taken_port, job.members(0, 2))
        out = job.wait()
    for res in out.values():
        assert res["left"] and "generation 1's rendezvous port" in \
            res["raised"], res

def _jax_elastic(data, tmp_path):
    """The JAX elastic trainer on 4 -> 2 -> 4 virtual CPU devices: the
    initial parameters and the losses by step."""
    devices = jax.devices()
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    ds = JaxTokenDataset(data, native=False)
    trainer = jharness.CheckpointingTrainer(
        cfg, str(tmp_path / "jax_ckpt"), mesh=jmake_mesh(devices=devices[:4]),
        optimizer=jfsdp.default_optimizer(LR), checkpoint_interval=100,
        elastic=True)
    state = trainer.init_or_resume(jax.random.PRNGKey(0))
    tree = jax.device_get(state.params)
    losses = {}

    def batches():
        step = 0
        while True:
            yield jnp.asarray(ds.sample_at(BATCH, ranks.ELASTIC_SEQ + 1,
                                           SEED, step))
            step += 1

    def notice(at, make, devs):
        fired = []

        def signal():
            if max(losses, default=0) == at and not fired:
                fired.append(True)
                return make(devs)
            return None
        return signal

    result = trainer.run(
        state, batches(), STEPS,
        on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])),
        reclaim_signal=notice(SHRINK_AT, jharness.ReclaimNotice,
                              devices[:2]),
        grow_signal=notice(GROW_AT, jharness.GrowNotice, devices[:4]))
    trainer.close()
    ds.close()
    assert result.reshards == 2 and result.device_count == 4
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(result.state.params))
    return tree, losses, params


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-6):
    """Every leaf of ``got`` within the reference's bounds of ``ref``."""
    ref = dict(_leaves(ref))
    return all(np.allclose(g, ref[name], rtol=rtol, atol=atol)
               for name, g in _leaves(got))


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The port's 4 -> 2 -> 4 run, its cold starts and its planted
    fault, and the JAX elastic run, on the same weights and token file."""
    tmp = tmp_path_factory.mktemp("elastic")
    data = str(tmp / "tokens.bin")
    write_token_file(data, np.random.default_rng(5).integers(
        0, 512, size=20_000))
    tree, jax_losses, jax_params = _jax_elastic(data, tmp)
    ckpt = str(tmp / "ckpt")
    args = (tree, data, ckpt, LR, BATCH, SEED, STEPS)
    with launch.Job(timeout=GROUP_TIMEOUT, workdir=str(tmp)) as job:
        job.start(ranks.elastic_member, START, *args,
                  (0, SHRINK_AT, SURVIVORS), (1, GROW_AT, GROWN))
        job.start(ranks.elastic_joiner, GROWN, *args, generation=2,
                  only=GROWN[2:])
        run = job.wait()
    steps = sorted(int(p) for p in os.listdir(ckpt) if p.isdigit())
    # the shrink's save alone, for a cold start at 2 ranks from it
    shrunk = str(tmp / "shrunk")
    os.makedirs(shrunk)
    shutil.copytree(os.path.join(ckpt, str(SHRINK_AT)),
                    os.path.join(shrunk, str(SHRINK_AT)))
    with launch.Job(timeout=GROUP_TIMEOUT, workdir=str(tmp)) as grown, \
            launch.Job(timeout=GROUP_TIMEOUT, workdir=str(tmp)) as small:
        grown.start(ranks.elastic_cold, GROWN, *args, True)
        small.start(ranks.elastic_cold, launch.Job.members(0, 2), tree,
                    data, shrunk, LR, BATCH, SEED, GROW_AT, False)
        cold4 = grown.wait()
        cold2 = small.wait()
    return {"run": run, "steps": steps, "ckpt": ckpt,
            "cold4": [cold4[m] for m in GROWN],
            "cold2": [cold2[m] for m in launch.Job.members(0, 2)],
            "jax_losses": jax_losses, "jax_params": jax_params}


def test_shrink_and_grow_keep_steps_and_members(elastic):
    run = elastic["run"]
    assert elastic["steps"] == [SHRINK_AT, GROW_AT]
    for name in START[:2]:                      # reclaimed after the save
        r = run[name]
        assert r["reclaimed"] and r["preempted"] and not r["writer"]
        assert sorted(r["losses"]) == [1, 2] and r["reshards"] == 0
    for name in SURVIVORS:
        r = run[name]
        assert not r["preempted"] and not r["reclaimed"]
        assert r["reshards"] == 2 and r["device_count"] == 4
        assert sorted(r["losses"]) == list(range(1, STEPS + 1))
        assert r["generation"] == 2 and r["steps_done"] == STEPS
    for name in GROWN[2:]:
        r = run[name]
        assert r["start"] == GROW_AT and sorted(r["losses"]) == [5, 6]
        assert r["device_count"] == 4 and r["generation"] == 2
    # every rank of a generation saw the same loss at each step
    for s in range(1, STEPS + 1):
        vals = {r["losses"][s] for r in run.values() if s in r["losses"]}
        assert len(vals) == 1, (s, vals)
    # the writer moved from the old rank 0 to the shrink's first member
    assert [n for n, r in run.items() if r["writer"]] == [SURVIVORS[0]]


def test_resizes_equal_cold_starts_from_their_checkpoints(elastic):
    """After the shrink (cold start at 2 ranks from step 2) and after the
    grow (at 4 ranks from step 4): the same losses and final
    parameters; a resize whose restore re-initializes both moments
    fails the same check."""
    run = elastic["run"]
    losses = run[SURVIVORS[0]]["losses"]
    final = run[SURVIVORS[0]]["params"]
    cold2 = elastic["cold2"][0]["cold"]
    cold4 = elastic["cold4"][0]["cold"]
    assert cold2["start"] == SHRINK_AT and cold4["start"] == GROW_AT
    for cold in (cold2, cold4):
        for s, loss in cold["losses"].items():
            assert loss == pytest.approx(losses[s], rel=1e-5), s
    assert _close(final, cold4["params"])
    planted = elastic["cold4"][0]["planted"]
    assert planted["reshards"] == 1 and planted["start"] == GROW_AT
    assert not _close(planted["params"], cold4["params"])


def test_elastic_ledger_is_one_run_through_the_writers_move(elastic):
    records = tgoodput.read_ledger(
        os.path.join(elastic["ckpt"], tgoodput.LEDGER_BASENAME))
    assert len(tgoodput.split_runs(records)) == 1
    assert tgoodput.unavailability_windows(records) == []
    degraded = [r for r in records if r.get("phase") == "degraded"]
    assert [(d["devices_before"], d["devices_after"]) for d in degraded] \
        == [(4, 2)]
    assert degraded[0]["seconds_lost"] == pytest.approx(
        degraded[0]["duration_s"] * 0.5, abs=1e-6)
    phases = [r["phase"] for r in records if r["kind"] == "phase"]
    assert phases.count("drain_save") == 2
    assert phases.count("ckpt_restore") == 2
    # the reference reads it: one run, both saves and the priced window
    s = jgoodput.summarize(records)
    assert s["runs"] == 1 and s["phases"]["drain_save"]["count"] == 2
    assert s["badput_s"]["degraded"] == pytest.approx(
        degraded[0]["seconds_lost"])
    assert [r["step"] for r in records if r["kind"] == "run_end"] == [STEPS]


def test_elastic_matches_the_jax_elastic_trainer(elastic):
    """Per-step losses within 1e-5 relative of the JAX trainer's across
    both resizes; final parameters to Adam's sign flips (an element whose
    gradient is near summation noise may step the other way: 2 lr per
    step, on at most 0.1% of a leaf)."""
    losses = elastic["run"][SURVIVORS[0]]["losses"]
    for s, ref in elastic["jax_losses"].items():
        assert losses[s] == pytest.approx(ref, rel=1e-5), s
    got = dict(_leaves(elastic["run"][SURVIVORS[0]]["params"]))
    for name, ref in _leaves(elastic["jax_params"]):
        d = np.abs(got[name] - ref)
        assert d.max() <= 2 * LR * STEPS + 1e-6, name
        assert (d > 1e-6).sum() <= max(1, ref.size // 1000), name
