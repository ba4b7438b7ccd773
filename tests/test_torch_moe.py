"""The port's MoE family against the JAX reference on the CPU
(``MoEConfig.tiny``): the router, the dense-dispatch expert layer in fp32
and bf16, the training forward with and without remat, the loss and its
gradients, the train step through ``make_train_step_from_loss``, greedy
decoding (contiguous and on the continuous batcher), and the CLI's
``--model moe_tiny`` drain and resume."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import moe as jmoe
from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu.models.serve import ContinuousBatcher as JBatcher
from k8s_operator_libs_tpu.parallel import expert as jexpert
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu_torch import convert, train
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models import moe as tmoe
from k8s_operator_libs_tpu_torch.models.llama import param_leaves
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.ops import attention as tattn
from k8s_operator_libs_tpu_torch.parallel import expert as texpert
from k8s_operator_libs_tpu_torch.parallel import fsdp as tfsdp

LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(dtype="float32", **kw):
    return (jmoe.MoEConfig.tiny(dtype=jnp.dtype(dtype), **kw),
            tmoe.MoEConfig.tiny(dtype=convert.torch_dtype(dtype), **kw))


def _weights(seed=0, dtype="float32", **kw):
    jcfg, tcfg = _configs(dtype, **kw)
    tree = jax.device_get(jmoe.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree, convert.to_torch(tree, device="cpu")


def _layer(tree, params, i=0):
    return ({k: v[i] for k, v in tree["blocks"].items()},
            {k: v[i] for k, v in params["blocks"].items()})


def _hidden(seed, dtype, shape=(2, 16, 128)):
    h = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(h).astype(jnp.dtype(dtype)),
            torch.as_tensor(h).to(convert.torch_dtype(dtype)))


def _tokens(seed, B=2, T=17, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)
                                                ).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


@pytest.mark.parametrize("name", ["tiny", "llama3_8b"])
def test_config_matches_reference(name):
    """Every field, ``head_dim`` and the dtype: ``llama3_8b`` is the
    inherited Llama-3-8B attention with eight d_ff-14336 experts."""
    j = getattr(jmoe.MoEConfig, name)()
    t = getattr(tmoe.MoEConfig, name)()
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.head_dim == j.head_dim
    assert convert.dtype_name(t.dtype) == jnp.dtype(j.dtype).name


def test_init_params_layout_matches_reference():
    """Same tree, shapes and dtypes as the reference's init (router fp32,
    expert stacks [L, E, ...]); fan-in scaled like it."""
    jcfg, tcfg = _configs("bfloat16")
    ref = jax.eval_shape(lambda k: jmoe.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    got = tmoe.init_params(tcfg, seed=0, device="cpu")
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_ref) == sum(1 for _ in param_leaves(got))
    for path, leaf in flat_ref.items():
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert convert.dtype_name(t.dtype) == jnp.dtype(leaf.dtype).name, path
    wg = got["blocks"]["w_gate"].float()
    assert abs(float(wg.std()) - 128 ** -0.5) < 0.01
    assert not torch.equal(wg[0, 0], wg[0, 1])     # one draw per slab


def test_router_weights_match_reference():
    """fp32: the routing masks equal (asserted first, so a flip names the
    routing), weights and probs within 1e-6, exactly top_k experts kept
    per token (no ties in this data), each row summing to 1."""
    _, tcfg, tree, params = _weights()
    lj, lt = _layer(tree, params)
    hj, ht = _hidden(3, "float32")
    wj, pj = jmoe.router_weights(hj, lj["router"], tcfg.top_k)
    wt, pt = tmoe.router_weights(ht, lt["router"], tcfg.top_k)
    np.testing.assert_array_equal(_f32(wt) > 0, _f32(wj) > 0)
    np.testing.assert_allclose(_f32(wt), _f32(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_f32(pt), _f32(pj), rtol=0, atol=1e-6)
    assert ((wt > 0).sum(-1) == tcfg.top_k).all()
    torch.testing.assert_close(wt.sum(-1), torch.ones(2, 16), rtol=0,
                               atol=1e-6)


def test_router_ties_admit_more_than_top_k():
    """The threshold rule: experts whose prob equals the k-th value all
    stay, as in the reference (torch.topk indices would keep exactly k)."""
    h = np.zeros((1, 2, 4), np.float32)
    h[0, 0] = [1.0, 0, 0, 0]
    h[0, 1] = [0, 1.0, 0, 0]
    router = np.array([[2.0, 1.0, 1.0, 1.0], [0, 0, 0, 0],
                       [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    wj, _ = jmoe.router_weights(jnp.asarray(h), jnp.asarray(router), 2)
    wt, _ = tmoe.router_weights(torch.as_tensor(h), torch.as_tensor(router),
                                2)
    np.testing.assert_array_equal(_f32(wt) > 0, _f32(wj) > 0)
    assert (wt[0] > 0).sum(-1).tolist() == [4, 4]
    np.testing.assert_allclose(_f32(wt), _f32(wj), rtol=0, atol=1e-6)


def test_moe_ffn_matches_reference_fp32():
    """fp32: out within 1e-5 of max |out| (summation order), aux within
    1e-6."""
    jcfg, tcfg, tree, params = _weights()
    lj, lt = _layer(tree, params, 1)
    hj, ht = _hidden(4, "float32")
    oj, aj = jmoe.moe_ffn(hj, lj, jcfg)
    ot, at = tmoe.moe_ffn(ht, lt, tcfg)
    assert ot.dtype == torch.float32 and tuple(ot.shape) == oj.shape
    assert np.abs(_f32(ot) - _f32(oj)).max() <= 1e-5 * np.abs(_f32(oj)).max()
    assert abs(float(at) - float(aj)) <= 1e-6


def _gate_up_rounded_to_bf16(h, layer, cfg):
    """The layer with gate and up rounded to bf16 before the silu and the
    product, the error ``preferred_element_type=jnp.float32`` rules out."""
    weights, _ = tmoe.router_weights(h, layer["router"], cfg.top_k)
    x = h.reshape(-1, h.shape[-1])
    w = weights.reshape(-1, cfg.n_experts).to(h.dtype).float()
    out = 0
    for e in range(cfg.n_experts):
        gate = torch.nn.functional.silu(x @ layer["w_gate"][e])
        y = (gate * (x @ layer["w_up"][e])) @ layer["w_down"][e]
        out = out + w[:, e:e + 1] * y.float()
    return out.to(h.dtype).reshape(h.shape)


def test_moe_ffn_matches_reference_bf16():
    """bf16 with fp32 gate/up: bound 2^-8 of max |out| (half a bf16 ulp at
    the top binade; measured 0, the same bits), aux within 1e-6. The
    bound rejects the layer with gate and up rounded to bf16 first."""
    jcfg, tcfg, tree, params = _weights(dtype="bfloat16")
    lj, lt = _layer(tree, params, 1)
    hj, ht = _hidden(4, "bfloat16")
    oj, aj = jmoe.moe_ffn(hj, lj, jcfg)
    ot, at = tmoe.moe_ffn(ht, lt, tcfg)
    assert ot.dtype == torch.bfloat16
    bound = 2.0 ** -8 * np.abs(_f32(oj)).max()
    assert np.abs(_f32(ot) - _f32(oj)).max() <= bound
    assert abs(float(at) - float(aj)) <= 1e-6
    wrong = _gate_up_rounded_to_bf16(ht, lt, tcfg)
    assert np.abs(_f32(wrong) - _f32(oj)).max() > bound


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", False)])
def test_forward_matches_reference(dtype, remat):
    """Logits and aux. fp32: 1e-5 of max |logit|, aux 1e-5. bf16: the
    frameworks round attention activations at different points (see the
    Llama forward test), 3% of max |logit| (measured 0.8%), aux 1e-3."""
    jcfg, tcfg, tree, params = _weights(dtype=dtype, remat=remat)
    toks = _tokens(0)
    lj, aj = jmoe.forward(tree, jnp.asarray(toks), jcfg)
    lt, at = tmoe.forward(params, torch.as_tensor(toks), tcfg)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    tol, aux_tol = (1e-5, 1e-5) if dtype == "float32" else (3e-2, 1e-3)
    assert np.abs(_f32(lt) - _f32(lj)).max() <= tol * np.abs(_f32(lj)).max()
    assert abs(float(at) - float(aj)) <= aux_tol
    assert float(at) > 0


def test_loss_and_grads_match_reference():
    """``moe_reference_loss`` and every gradient against ``jax.grad``,
    fp32: loss within 1e-5, each leaf within rtol 1e-4 and 1e-5 of its
    largest element (summation order; the router's gradient flows through
    the renormalized weights and the aux term's mean_prob)."""
    jcfg, tcfg, tree, params = _weights(seed=1)
    toks = _tokens(1)
    ref_loss, ref_grads = jax.value_and_grad(
        jexpert.moe_reference_loss(jcfg))(tree, jnp.asarray(toks))
    loss, grads = tfsdp.value_and_grad(texpert.moe_reference_loss(tcfg),
                                       params, torch.as_tensor(toks))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    got = dict(_leaves(convert.to_numpy(grads)))
    for name, ref in _leaves(jax.device_get(ref_grads)):
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got[name], ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def _assert_params_close(got, ref, steps):
    """As the Llama step test: Adam's first updates are ~sign(g) * lr, so
    an element whose gradient sits in the summation-order noise may take
    the other sign (up to 2 * lr per step); every other element agrees to
    1e-6, and at most 0.1% of each leaf (at least one element) flips."""
    got = dict(_leaves(got))
    for name, r in _leaves(ref):
        d = np.abs(got[name] - r)
        assert d.max() <= 2 * LR * steps + 1e-6, name
        assert (d > 1e-6).sum() <= max(1, r.size // 1000), name


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(n_steps):
    """From the same carried state (JAX init + optax moments), n steps of
    ``make_train_step_from_loss(moe_reference_loss)`` give the same
    losses, gradient norms, parameters and moments."""
    jcfg, tcfg = _configs()
    opt = jfsdp.default_optimizer(LR)
    params = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jfsdp.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32))
    tstate = convert.train_state_to_torch(jax.device_get(jstate),
                                          device="cpu")
    jstep = jexpert.make_train_step_from_loss(
        jexpert.moe_reference_loss(jcfg), opt)
    tstep = tfsdp.make_train_step_from_loss(
        texpert.moe_reference_loss(tcfg), tfsdp.default_optimizer(LR))
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
            np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)


def test_remat_runs_the_forward_once_per_layer():
    """Under cfg.remat the backward recomputes both halves of each block
    (the fp32 gate/up products among them) but not the attention: n_layers
    forward calls per step, and the loss and gradients equal those
    without remat."""
    toks = torch.as_tensor(_tokens(6))
    out = {}
    for remat in (False, True):
        _, tcfg = _configs(remat=remat, n_layers=3)
        params = tmoe.init_params(tcfg, seed=0, device="cpu")
        tattn.reset_launch_counts()
        out[remat] = tfsdp.value_and_grad(texpert.moe_reference_loss(tcfg),
                                          params, toks)
        assert tattn.PLAIN_CALLS == {"flash_forward": 3, "flash_bwd_dq": 3,
                                     "flash_bwd_dkv": 3}
    assert float(out[True][0]) == float(out[False][0])
    for (name, a), (_, b) in zip(_leaves(convert.to_numpy(out[True][1])),
                                 _leaves(convert.to_numpy(out[False][1]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_moe_generate_matches_reference_and_full_forward():
    """fp32 greedy: token-identical to the reference's ``moe_generate``,
    and each token the argmax of the port's own uncached forward."""
    jcfg, tcfg, tree, params = _weights()
    prompt = _tokens(2, B=2, T=8)
    ref = np.asarray(jmoe.moe_generate(tree, jnp.asarray(prompt), jcfg,
                                       max_new_tokens=6))
    out = tmoe.moe_generate(params, torch.as_tensor(prompt), tcfg,
                            max_new_tokens=6)
    assert tuple(out.shape) == (2, 14)
    np.testing.assert_array_equal(out.numpy(), ref)
    full, _ = tmoe.forward(params, out[:, :-1], tcfg)
    np.testing.assert_array_equal(full[:, 7:13].argmax(-1).numpy(),
                                  out[:, 8:14].numpy())


def test_moe_batcher_matches_solo_and_reference():
    """The ``forward=moe_paged_forward`` hook puts the family on the
    batcher: every request's tokens equal its solo ``moe_generate`` and
    the JAX batcher's on the same hook (its paged kernel in interpret
    mode), fp32."""
    jcfg, tcfg, tree, params = _weights(seed=2)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (5, 8, 6)]
    news = [5, 4, 6]

    def drive(srv):
        rids = [srv.submit(p, n) for p, n in zip(prompts, news)]
        done, ticks = {}, 0
        while not srv.idle:
            srv.step(3)
            done.update(srv.poll())
            ticks += 1
            assert ticks < 60
        done.update(srv.poll())
        return [np.asarray(done[r]) for r in rids]

    got = drive(ContinuousBatcher(params, tcfg, max_slots=2,
                                  capacity_per_slot=48, block_size=8,
                                  forward=tmoe.moe_paged_forward))
    jpaged.INTERPRET = True
    try:
        ref = drive(JBatcher(tree, jcfg, max_slots=2, capacity_per_slot=48,
                             block_size=8, forward=jmoe.moe_paged_forward))
    finally:
        jpaged.INTERPRET = False
    for g, r, p, n in zip(got, ref, prompts, news):
        solo = tmoe.moe_generate(params, torch.as_tensor(p[None]), tcfg,
                                 max_new_tokens=n)[0].numpy()
        np.testing.assert_array_equal(g, solo)
        np.testing.assert_array_equal(g, r)


def _cli(tmp_path, ckpt, *extra, drain_signal=None, steps=6):
    data = tmp_path / "tokens.bin"
    if not data.exists():
        tloader.write_token_file(str(data), _tokens(8, B=1, T=4000)[0])
    argv = ["--data", str(data), "--ckpt", str(tmp_path / ckpt), "--model",
            "moe_tiny", "--steps", str(steps), "--batch", "2", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu", "--parallel", "none",
            *extra]
    return train.main(argv, drain_signal=drain_signal)


def test_cli_moe_drains_and_resumes_to_the_same_loss(tmp_path, capsys):
    """``--model moe_tiny``: checkpoint at 2, drained at 3, resumed to 6,
    the step-6 loss of an uninterrupted run (to the printed digit)."""
    assert _cli(tmp_path, "straight") == 0
    straight = capsys.readouterr().out
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return calls["n"] == 4               # before the 4th step

    assert _cli(tmp_path, "drained", drain_signal=drain) == 0
    assert "preempted at step 3; checkpoint 3 saved" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "drained").iterdir()
                  if p.name.isdigit()) == ["2", "3"]
    assert _cli(tmp_path, "drained") == 0
    resumed = capsys.readouterr().out
    assert "done: 3 steps" in resumed

    def loss(out):
        return re.search(r"\(step 6 loss ([0-9.]+)\)", out).group(1)

    assert loss(resumed) == loss(straight)


def test_cli_refuses_a2a_dispatch(tmp_path):
    with pytest.raises(SystemExit, match="a2a requires"):
        _cli(tmp_path, "a2a", "--moe-dispatch", "a2a")
