"""The port's training slice against the JAX reference on the CPU: the
training forward, the loss and its gradients, the clipped-AdamW train
step from the same carried state, gradient accumulation, the token
loader, remat's launch count, and the trainer's checkpoint, drain and
resume (library and CLI)."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.data import loader as jloader
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu_torch import convert, train
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.ops import attention as tattn
from k8s_operator_libs_tpu_torch.parallel import fsdp as tfsdp
from k8s_operator_libs_tpu_torch.train.harness import CheckpointingTrainer

REPO = Path(__file__).resolve().parent.parent
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(dtype="float32", **kw):
    return (jllama.LlamaConfig.tiny(dtype=jnp.dtype(dtype), **kw),
            tllama.LlamaConfig.tiny(dtype=convert.torch_dtype(dtype), **kw))


def _tokens(seed, B=2, T=33, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)
                                                ).astype(np.int32)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """fp32: summation order and XLA's CPU exp (see the RoPE test), 1e-5
    of max |logit|. bf16: the two frameworks round activations at
    different points (one bf16 ulp is 2^-8 relative) through two blocks,
    3% of max |logit| (measured ~1.2%)."""
    jcfg, tcfg = _configs(dtype)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    params = convert.to_torch(tree, device="cpu")
    toks = _tokens(0)
    ref = np.asarray(jllama.forward(tree, jnp.asarray(toks), jcfg))
    got = tllama.forward(params, torch.as_tensor(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert np.abs(got.detach().numpy() - ref).max() <= tol * np.abs(ref).max()
    assert tllama.param_count(params) == jllama.param_count(tree)


def test_loss_and_grads_match_reference():
    jcfg, tcfg = _configs()
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(1), jcfg))
    toks = _tokens(1)
    ref_loss, ref_grads = jax.value_and_grad(jfsdp.causal_lm_loss)(
        tree, jnp.asarray(toks), jcfg)
    params = convert.to_torch(tree, device="cpu")
    loss, grads = tfsdp.value_and_grad(
        lambda p, t: tfsdp.causal_lm_loss(p, t, tcfg), params,
        torch.as_tensor(toks))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    got = dict(_leaves(convert.to_numpy(grads)))
    for name, ref in _leaves(jax.device_get(ref_grads)):
        np.testing.assert_allclose(got[name], ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


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


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(n_steps):
    """From the same carried state (JAX init + optax moments bridged by
    ``tfsdp.train_state_to_torch``), n clipped-AdamW steps on the same
    batches give the same losses, gradient norms, parameters and
    moments."""
    jcfg, tcfg = _configs()
    jstate = jfsdp.init_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = tfsdp.train_state_to_torch(jax.device_get(jstate),
                                        device="cpu")
    assert tstate.step == 0 and tstate.opt_state.count == 0
    jstep = jfsdp.make_train_step(jcfg, jfsdp.default_optimizer(LR))
    tstep = tfsdp.make_train_step(tcfg, tfsdp.default_optimizer(LR))
    for i in range(n_steps):
        toks = _tokens(10 + i, B=4)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.as_tensor(toks))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
        assert tm["step"] == int(jm["step"]) == i + 1
    host = jax.device_get(jstate)
    _assert_params_close(convert.to_numpy(tstate.params), host.params,
                         n_steps)
    adam = convert._adam_state(host.opt_state)
    assert tstate.opt_state.count == int(adam.count) == n_steps
    for got, ref in ((tstate.opt_state.mu, adam.mu),
                     (tstate.opt_state.nu, adam.nu)):
        got = dict(_leaves(convert.to_numpy(got)))
        for name, r in _leaves(ref):
            # the gradients' own tolerance: summation order, 1e-5 of the
            # leaf's largest element
            np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)


def test_clip_follows_optax_rule():
    """Below max_norm the gradient passes unchanged; above it becomes
    g / norm * max_norm (no epsilon), as optax's clip_by_global_norm: the
    first moment after one step is (1 - b1) times the clipped gradient,
    and Adam's first step is -lr * sign(g) either way."""
    opt = tfsdp.default_optimizer(1e-3)
    for scale in (0.5, 3.0):
        p = {"w": torch.zeros(4)}
        g = {"w": torch.tensor([1.0, -2.0, 2.0, 4.0]) * scale / 5.0}
        norm = tfsdp.global_norm(g)
        state = opt.update(g, opt.init(p), p, norm)
        clipped = g["w"] if float(norm) < 1.0 else g["w"] / norm
        torch.testing.assert_close(state.mu["w"], (1 - opt.b1) * clipped)
        torch.testing.assert_close(p["w"], -1e-3 * torch.sign(g["w"]))
        assert state.count == 1


def test_grad_accum_matches_full_batch():
    """Two equal microbatches: fp32 gradient sums in another order, the
    same mean, so the same loss and norm to 1e-6 and the same update up
    to Adam's sign flips (see _assert_params_close)."""
    _, tcfg = _configs()
    toks = torch.as_tensor(_tokens(5, B=4))
    states, metrics = [], []
    for accum in (1, 2):
        state = tfsdp.init_train_state(tcfg, seed=3, device="cpu")
        state, m = tfsdp.make_train_step(tcfg, tfsdp.default_optimizer(LR),
                                         grad_accum=accum)(state, toks)
        states.append(state)
        metrics.append(m)
    assert abs(float(metrics[0]["loss"]) - float(metrics[1]["loss"])) < 1e-6
    assert abs(float(metrics[0]["grad_norm"])
               - float(metrics[1]["grad_norm"])) < 1e-5
    _assert_params_close(convert.to_numpy(states[1].params),
                         convert.to_numpy(states[0].params), 1)
    with pytest.raises(ValueError, match="grad_accum"):
        tfsdp.make_train_step(tcfg, grad_accum=3)(states[0], toks)


def test_remat_runs_the_forward_once_per_layer():
    """Under cfg.remat the backward recomputes the blocks but not the
    attention: the forward's (plain-path) count is n_layers per step, and
    the gradients equal those without remat."""
    grads = {}
    toks = torch.as_tensor(_tokens(6))
    for remat in (False, True):
        _, tcfg = _configs(remat=remat, n_layers=3)
        params = tllama.init_params(tcfg, seed=0, device="cpu")
        tattn.reset_launch_counts()
        _, grads[remat] = tfsdp.value_and_grad(
            lambda p, t: tfsdp.causal_lm_loss(p, t, tcfg), params, toks)
        assert tattn.PLAIN_CALLS == {"flash_forward": 3, "flash_bwd_dq": 3,
                                     "flash_bwd_dkv": 3}
    for (name, a), (_, b) in zip(_leaves(convert.to_numpy(grads[True])),
                                 _leaves(convert.to_numpy(grads[False]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("vocab", [512, 70000])     # uint16 and int32 files
def test_token_dataset_matches_reference(tmp_path, vocab):
    toks = np.random.default_rng(7).integers(0, vocab, size=5000)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    tloader.write_token_file(str(ours), toks)
    jloader.write_token_file(str(theirs), toks)
    assert ours.read_bytes() == theirs.read_bytes()
    t = tloader.TokenDataset(str(ours))
    j = jloader.TokenDataset(str(ours), native=False)
    try:
        assert t.num_tokens == j.num_tokens == 5000
        for step in (0, 1, 17):
            np.testing.assert_array_equal(t.sample_at(3, 65, 11, step),
                                          j.sample_at(3, 65, 11, step))
        ts, js = t.batches(2, 33, seed=5, start_step=4), \
            j.batches(2, 33, seed=5, start_step=4)
        for _ in range(3):
            np.testing.assert_array_equal(next(ts), next(js))
        ts.close()
        js.close()
    finally:
        t.close()
        j.close()
    with pytest.raises(ValueError, match="closed"):
        t.gather(np.zeros(1), 4)


def _run_trainer(tmp_path, name, num_steps, drain_at=None, interval=2):
    _, tcfg = _configs()
    trainer = CheckpointingTrainer(tcfg, str(tmp_path / name),
                                   optimizer=tfsdp.default_optimizer(LR),
                                   checkpoint_interval=interval,
                                   device="cpu")
    state = trainer.init_or_resume(0)
    start = state.step
    losses = {}
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return drain_at is not None and start + calls["n"] - 1 == drain_at

    data = (_tokens(100 + s) for s in range(start, 10 ** 6))
    result = trainer.run(state, data, num_steps - start, drain_signal=drain,
                         on_step=lambda s, m: losses.update({s: float(
                             m["loss"])}))
    trainer.close()
    return trainer, result, losses


def test_trainer_drain_then_resume_continues_the_same_run(tmp_path):
    """Checkpoint at step 2, drained at step 3 (a synchronous checkpoint),
    resumed to step 6: the losses and the final parameters are those of
    an uninterrupted 6-step run."""
    _, straight, ref = _run_trainer(tmp_path, "a", 6)
    assert not straight.preempted and straight.state.step == 6

    trainer, first, losses = _run_trainer(tmp_path, "b", 6, drain_at=3)
    assert first.preempted and first.steps_done == 3
    assert first.last_checkpoint_step == 3 and trainer.latest_step == 3
    assert sorted(int(p.name) for p in (tmp_path / "b").iterdir()) == [2, 3]
    _, second, more = _run_trainer(tmp_path, "b", 6)
    assert not second.preempted and second.steps_done == 3
    losses.update(more)
    assert losses == ref
    for (name, a), (_, b) in zip(
            _leaves(convert.to_numpy(second.state.params)),
            _leaves(convert.to_numpy(straight.state.params))):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert second.state.opt_state.count == 6


def test_cli_trains_drains_and_resumes(tmp_path, capsys):
    data = tmp_path / "tokens.bin"
    tloader.write_token_file(str(data), _tokens(8, B=1, T=4000)[0])
    argv = ["--data", str(data), "--ckpt", str(tmp_path / "ck"),
            "--model", "tiny", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu"]
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return calls["n"] == 4               # before the 4th step

    handler = signal.getsignal(signal.SIGTERM)
    assert train.main(argv, drain_signal=drain) == 0
    assert "preempted at step 3; checkpoint 3 saved" in capsys.readouterr().out
    assert train.main(argv) == 0
    assert "done: 1 steps" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is handler


def test_cli_drains_on_sigterm(tmp_path):
    """The real signal: SIGTERM after the first checkpoint makes the
    process save a checkpoint and exit 0 with ``preempted at step``."""
    data = tmp_path / "tokens.bin"
    tloader.write_token_file(str(data), _tokens(9, B=1, T=4000)[0])
    ckpt = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.train",
         "--data", str(data), "--ckpt", str(ckpt), "--model", "tiny",
         "--steps", "1000000", "--batch", "2", "--seq", "16",
         "--ckpt-interval", "1", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        while not (ckpt / "1").exists():
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "no checkpoint in 120 s"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "preempted at step" in out
    step = int(out.split("preempted at step ")[1].split(";")[0])
    assert step >= 1 and (ckpt / str(step) / "state.pt").exists()
