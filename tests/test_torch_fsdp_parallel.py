"""FSDP (ZeRO-3) training of the port against the JAX package on the CPU,
and the CLI across world sizes.

The port's step runs in gloo ranks started by ``launch.run`` (one group
per rank count, ``GROUP_TIMEOUT`` each); the reference is
``make_train_step(cfg, mesh=make_mesh(fsdp=n))`` on the virtual CPU
devices of ``tests/conftest.py``, from the same parameters and zero
moments on the same batches. fp32; the bounds are ``tests/
test_torch_train.py``'s: loss and gradient norm to 1e-5, moments to rtol
1e-4 / atol 1e-5 of the leaf's max, parameters up to Adam's sign flips
(see ``_assert_params_close``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu.parallel.mesh import make_mesh
from k8s_operator_libs_tpu_torch import convert, train
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.parallel import launch

GROUP_TIMEOUT = 120.0
LR = 3e-4
N_STEPS = 3
REMAT = {2: True, 4: False}       # the gather inside checkpoint at n 2
ACCUM_N = 2                        # grad_accum 2 is checked once, at n 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


def _assert_params_close(got, ref, steps):
    """Adam's first updates are ~sign(g) * lr: an element whose gradient
    is near the summation-order noise may take the other sign, so its
    value may differ by up to 2 * lr per step. Every other element agrees
    to 1e-6; at most 0.1% of each leaf (and at least one element) may be
    such a flip."""
    got = dict(_leaves(got))
    for name, r in _leaves(ref):
        d = np.abs(got[name] - r)
        assert d.max() <= 2 * LR * steps + 1e-6, name
        assert (d > 1e-6).sum() <= max(1, r.size // 1000), name


def _assert_moments_close(got, ref):
    got = dict(_leaves(got))
    for name, r in _leaves(ref):
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def _batches(seed, n_batches, B=4, T=17, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, T)).astype(np.int32)
            for _ in range(n_batches)]


def _jax_run(n, batches, remat, grad_accum=1):
    """(tree of the initial params, [(metrics, host state) per step])."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=remat)
    mesh = make_mesh(fsdp=n, devices=jax.devices()[:n])
    state = jfsdp.init_train_state(jax.random.PRNGKey(0), cfg, mesh=mesh)
    tree = jax.device_get(state.params)
    step = jfsdp.make_train_step(cfg, jfsdp.default_optimizer(LR), mesh=mesh,
                                 grad_accum=grad_accum)
    out = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        host = jax.device_get(state)
        adam = convert._adam_state(host.opt_state)
        out.append(({k: float(v) for k, v in m.items()},
                    {"params": host.params, "mu": adam.mu, "nu": adam.nu,
                     "count": int(adam.count)}))
    return tree, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per rank count: the JAX runs and the port's group."""
    out = {}
    for n in (2, 4):
        batches = _batches(n, N_STEPS)
        tree, ref = _jax_run(n, batches, REMAT[n])
        accum, ref_accum = None, None
        if n == ACCUM_N:
            accum = _batches(10 + n, 1, B=8)[0]
            _, ref_accum = _jax_run(n, [accum], REMAT[n], grad_accum=2)
        port = launch.run(ranks.fsdp_group, n, tree, batches, LR, REMAT[n],
                          accum, 5, timeout=GROUP_TIMEOUT,
                          workdir=str(tmp_path_factory.mktemp("rdv")))
        out[n] = {"ref": ref, "ref_accum": ref_accum, "port": port}
    return out


def _check_step(got_metrics, got_state, ref_metrics, ref_state, steps):
    assert abs(got_metrics["loss"] - ref_metrics["loss"]) <= 1e-5
    assert abs(got_metrics["grad_norm"] - ref_metrics["grad_norm"]) <= 1e-5
    assert got_metrics["step"] == int(ref_metrics["step"]) == steps
    _assert_params_close(got_state["params"], ref_state["params"], steps)
    assert got_state["count"] == ref_state["count"] == steps
    _assert_moments_close(got_state["mu"], ref_state["mu"])
    _assert_moments_close(got_state["nu"], ref_state["nu"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("steps", [1, N_STEPS])
def test_fsdp_steps_match_reference(runs, n, steps):
    """After 1 and 3 steps: loss, gradient norm (summed over the shards),
    parameters and both moments, gathered whole, on every rank. At n 2
    under remat (the weights gathered inside the checkpointed regions)."""
    run = runs[n]
    ref_metrics, ref_state = run["ref"][steps - 1]
    for rank, res in enumerate(run["port"]):
        got = res["steps"]
        _check_step(got["metrics"][steps - 1], got["states"][steps - 1],
                    ref_metrics, ref_state, steps)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_its_slices(runs, n):
    """A rank holds 1/n of each split leaf (embed's vocab rows, wo's
    output columns) and the whole of a replicated one (the norms)."""
    cfg = tllama.LlamaConfig.tiny()
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    for res in runs[n]["port"]:
        assert res["steps"]["shapes"] == {
            "embed": (V // n, D), "wo": (L, D, D // n), "attn_norm": (L, D)}


def test_fsdp_grad_accum_matches_reference(runs):
    """grad_accum 2: the global batch's microbatches, each split over the
    ranks, as the reference splits before sharding."""
    ref_metrics, ref_state = runs[ACCUM_N]["ref_accum"][0]
    for res in runs[ACCUM_N]["port"]:
        got = res["accum"]
        _check_step(got["metrics"][0], got["states"][0], ref_metrics,
                    ref_state, 1)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_local_norm_is_caught(runs, n):
    """A planted fault: the clip and the metric on each rank's own shards'
    norm. The norm the same check reads must then miss the reference's by
    far more than its 1e-5 bound, and differ between ranks."""
    ref_metrics, _ = runs[n]["ref"][0]
    norms = [res["planted"]["metrics"][0]["grad_norm"]
             for res in runs[n]["port"]]
    assert all(abs(x - ref_metrics["grad_norm"]) > 1e-3 for x in norms)
    assert len(set(norms)) > 1


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_init_is_the_one_rank_init(runs, n):
    """``init_train_state(mesh=...)`` gives each rank its slices of the
    one-rank ``init_params(seed)`` and zero moments made from the slices:
    each rank holds 1/n of the split leaves."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    whole = convert.to_numpy(tllama.init_params(cfg, seed=5, device="cpu"))
    total = sum(x.size for _, x in _leaves(whole))
    norms = sum(x.size for name, x in _leaves(whole) if "norm" in name)
    for res in runs[n]["port"]:
        init = res["init"]
        for name, x in _leaves(whole):
            np.testing.assert_array_equal(dict(_leaves(init["full"]["params"]
                                                        ))[name], x)
            assert not dict(_leaves(init["full"]["mu"]))[name].any()
        assert init["held"] == init["moments"] == (total - norms) // n + norms


# ------------------------------------------------------------ the CLI

def _cli_argv(data, ckpt):
    return ["--data", str(data), "--ckpt", str(ckpt), "--model", "tiny",
            "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu", "--parallel", "fsdp"]


def _step6_loss(out):
    m = re.search(r"\(step 6 loss ([0-9.]+)\)", out)
    assert m is not None, out
    return float(m.group(1))


def _in_process(argv, capsys, drain_at=None):
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return drain_at is not None and calls["n"] == drain_at

    assert train.main(argv, drain_signal=drain) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.bin"
    tloader.write_token_file(str(path), np.random.default_rng(8).integers(
        0, 512, size=4000))
    return path


@pytest.fixture(scope="module")
def straight_loss(token_file, tmp_path_factory):
    """The uninterrupted 6-step run, one rank (``tiny`` is bf16)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(_cli_argv(token_file, tmp_path_factory.mktemp(
            "straight") / "ck")) == 0
    return _step6_loss(buf.getvalue())


# bf16: the 2-rank steps sum each gradient's two halves in fp32 and round
# once, the 1-rank step rounds the whole batch's gradient; an element may
# differ by a bf16 ulp (2^-8 relative) and Adam's first steps take its
# sign. Measured: 1.9e-4 of the step-6 loss (the same runs in fp32 agree
# to 1e-7), so 1e-3.
CLI_RTOL = 1e-3


def test_cli_drains_at_two_ranks_and_resumes_at_one(token_file, tmp_path,
                                                    capsys, straight_loss):
    """Checkpoint at 2 and a drain at 3 signalled on rank 0 only (the
    other rank follows at the same step: one drain save, by rank 0); the
    same command at one rank reads the whole tensors and trains 4-6."""
    ckpt = tmp_path / "ck"
    argv = _cli_argv(token_file, ckpt)
    res = launch.run(ranks.cli, 2, argv, 4, timeout=GROUP_TIMEOUT,
                     workdir=str(tmp_path))
    assert [r["rc"] for r in res] == [0, 0]
    assert "preempted at step 3; checkpoint 3 saved" in res[0]["out"]
    assert res[1]["out"] == ""                  # only rank 0 prints
    assert sorted(p.name for p in ckpt.iterdir()
                  if p.name.isdigit()) == ["2", "3"]
    records = (ckpt / "goodput.jsonl").read_text().splitlines()
    assert sum('"run_start"' in r for r in records) == 1   # rank 0 only
    out = _in_process(argv, capsys)
    assert "done: 3 steps" in out
    assert abs(_step6_loss(out) - straight_loss) <= CLI_RTOL * straight_loss


def test_cli_drains_at_one_rank_and_resumes_at_two(token_file, tmp_path,
                                                   capsys, straight_loss):
    ckpt = tmp_path / "ck"
    argv = _cli_argv(token_file, ckpt)
    assert "preempted at step 3" in _in_process(argv, capsys, drain_at=4)
    res = launch.run(ranks.cli, 2, argv, None, timeout=GROUP_TIMEOUT,
                     workdir=str(tmp_path))
    assert [r["rc"] for r in res] == [0, 0]
    assert "done: 3 steps" in res[0]["out"]
    assert abs(_step6_loss(res[0]["out"]) - straight_loss) \
        <= CLI_RTOL * straight_loss


def test_cli_ranks_resume_from_the_writers_checkpoint(token_file,
                                                      tmp_path):
    """A drained run and the same command again in one process group,
    rank 0's writes held back 1 s: the other rank reaches the resume
    while the drain save is still being written, and must still resume
    at rank 0's step 3 (not at the step it could list) and train 4-6."""
    argv = _cli_argv(token_file, tmp_path / "ck")
    res = launch.run(ranks.cli_slow_writer, 2, [(argv, 4), (argv, None)],
                     1.0, timeout=GROUP_TIMEOUT, workdir=str(tmp_path))
    assert [[r["rc"] for r in rank] for rank in res] == [[0, 0], [0, 0]]
    assert "preempted at step 3; checkpoint 3 saved" in res[0][0]["out"]
    assert "done: 3 steps" in res[0][1]["out"]


def test_cli_joins_the_process_group_from_the_env(token_file, tmp_path,
                                                  straight_loss):
    """Two processes started as ``torchrun`` starts them (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, a store on localhost): the CLI
    joins their group itself, over gloo for CPU ranks, trains to step 6
    equal to the one-rank run, leaves the group, and only rank 0
    prints."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    argv = _cli_argv(token_file, tmp_path / "ck")
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "k8s_operator_libs_tpu_torch.train",
             *argv], env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=GROUP_TIMEOUT))
    finally:
        for proc in procs:
            proc.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "done: 6 steps" in outs[0][0]
    assert outs[1][0] == ""                     # only rank 0 prints
    assert abs(_step6_loss(outs[0][0]) - straight_loss) \
        <= CLI_RTOL * straight_loss


@pytest.mark.parametrize("extra,msg", [
    (["--batch", "3"], "--batch 3 must be divisible by the 2-way"),
    (["--parallel", "sp", "--seq", "15"], "--seq 15 must be divisible"),
    (["--parallel", "sp", "--sp-attn", "ulysses", "--model", "small"],
     "needs head count 12 divisible by 8"),
    (["--parallel", "sp", "--model", "moe_tiny"],
     re.escape("--model moe_tiny supports --parallel none|ep|3d, not sp"))])
def test_cli_rejects_what_the_reference_rejects(token_file, tmp_path, extra,
                                                msg):
    """The reference's checks: the batch over fsdp, the sequence over
    seq, the heads for Ulysses; and the MoE under sp, with the
    reference's message (``cmd/train.py:90-92``)."""
    import argparse
    from k8s_operator_libs_tpu_torch.models.moe import MoEConfig
    from k8s_operator_libs_tpu_torch.parallel.fsdp import default_optimizer
    from k8s_operator_libs_tpu_torch.train import cli
    args = _cli_argv(token_file, tmp_path / "ck") + extra
    ns = argparse.Namespace(**{a[2:].replace("-", "_"): b for a, b in
                               zip(args[::2], args[1::2])})
    ns.batch, ns.seq = int(ns.batch), int(ns.seq)
    ns.sp_attn = getattr(ns, "sp_attn", "ring")
    ns.moe_dispatch = getattr(ns, "moe_dispatch", "dense")
    cfg = (MoEConfig.tiny() if ns.model == "moe_tiny"
           else cli.MODELS[ns.model]())
    n = 8 if "ulysses" in extra else 2
    with pytest.raises(SystemExit, match=msg):
        cli.build_parallel(cfg, ns, default_optimizer(), "cpu", n)


def test_cli_default_is_fsdp_as_the_reference(token_file, tmp_path):
    """``--parallel`` defaults to fsdp, as ``cmd/train.py``'s does: two
    CLI ranks started without it each hold 1/2 of every split leaf of the
    state (the norms whole), and ``--model moe_tiny`` without it exits
    with the reference's message, whatever the rank count."""
    argv = _cli_argv(token_file, tmp_path / "ck")[:-2]      # no --parallel
    argv[argv.index("--steps") + 1] = "2"
    res = launch.run(ranks.cli_held, 2, argv, timeout=GROUP_TIMEOUT,
                     workdir=str(tmp_path))
    cfg = tllama.LlamaConfig.tiny()
    whole = tllama.init_params(cfg, seed=0, device="cpu")
    total = tllama.param_count(whole)
    norms = sum(x.numel() for k, x in whole["blocks"].items()
                if k.endswith("norm")) + whole["final_norm"].numel()
    for r in res:
        assert r["rc"] == 0
        assert r["params"] == r["moments"] == (total - norms) // 2 + norms
    moe = argv[:]
    moe[moe.index("--model") + 1] = "moe_tiny"
    with pytest.raises(SystemExit, match=re.escape(
            "--model moe_tiny supports --parallel none|ep|3d, not fsdp")):
        train.main(moe)
