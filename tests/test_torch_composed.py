"""Composed 3-D parallelism (pipeline x FSDP x tensor + data, and the
MoE's pipeline x experts) of the port against the JAX package on the
CPU, and ``--parallel 3d`` through the CLI.

One ``launch.run`` group of gloo ranks per mesh shape (``GROUP_TIMEOUT``
each): stage 2 x data 2 x tensor 2 and stage 2 x fsdp 2 x tensor 2 (8
ranks each) for Llama, stage 2 x tensor 2 (4 ranks) for the MoE and the
CLI. The reference is ``make_composed_loss`` / ``make_moe_composed_loss``
and their train steps on the same mesh shapes of the virtual CPU devices
of ``tests/conftest.py``, on the same parameters and tokens. fp32 at
``LlamaConfig.tiny()`` / ``MoEConfig.tiny()``. Bounds: the loss to 1e-5
relative, every gradient leaf to 1e-4 of its largest element; steps as
in ``tests/test_torch_fsdp_parallel.py``; the CLI's bf16 step-6 loss to
1e-3 relative, that file's ``CLI_RTOL``."""

import argparse
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.models import moe as jmoe
from k8s_operator_libs_tpu.parallel import composed as jcomposed
from k8s_operator_libs_tpu.parallel import expert as jexpert
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu.parallel import pipeline as jpipe
from k8s_operator_libs_tpu.parallel.mesh import make_mesh
from k8s_operator_libs_tpu_torch import convert, train
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.models import moe as tmoe
from k8s_operator_libs_tpu_torch.parallel import composed as tcomposed
from k8s_operator_libs_tpu_torch.parallel import expert as texpert
from k8s_operator_libs_tpu_torch.parallel import launch
from k8s_operator_libs_tpu_torch.parallel import pipeline as tpipe
from k8s_operator_libs_tpu_torch.parallel.fsdp import default_optimizer
from k8s_operator_libs_tpu_torch.train import cli
from test_torch_fsdp_parallel import (CLI_RTOL, _assert_moments_close,
                                      _assert_params_close, _leaves)
from test_torch_pipeline import (assert_grads_close, assert_loss_close,
                                 jax_loss_grads, worst_grad)

GROUP_TIMEOUT = 120.0
GRAD_TOL = 1e-4
LR = 3e-4
REPO = Path(__file__).resolve().parents[1]
MESHES = {"pp_dp_tp": dict(stage=2, data=2, fsdp=1, tensor=2),
          "pp_fsdp_tp": dict(stage=2, data=1, fsdp=2, tensor=2)}
CASES = {"pp_dp_tp": ((2, False), (2, True)),        # (microbatches, remat)
         "pp_fsdp_tp": ((4, False), (2, False))}
MOE_MESH = dict(stage=2, data=1, fsdp=1, tensor=2)
MOE_COEFS = (0.0, 0.01)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(remat=False, **kw):
    return jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=remat, **kw)


def _moe_cfg(**kw):
    return jmoe.MoEConfig.tiny(dtype=jnp.float32, **kw)


def _tokens(seed, B=8, T=17, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, T)).astype(np.int32)


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return make_mesh(devices=jax.devices()[:n], **sizes)


def _jax_steps(step, tree, batches):
    """[(metrics, host state with adam moments)] after each step."""
    opt = jfsdp.default_optimizer(LR)
    state = jfsdp.TrainState(params=tree, opt_state=opt.init(tree),
                             step=jnp.zeros((), jnp.int32))
    out = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        host = jax.device_get(state)
        out.append((m, host.params, convert._adam_state(host.opt_state)))
    return out


def _check_steps(got, ref, moments_steps=3):
    """Loss and gradient norm to 1e-5 and the parameters up to Adam's
    sign flips after every step; the moments, by
    ``_assert_moments_close``, after the first ``moments_steps``."""
    for steps, (m, params, adam) in enumerate(ref, start=1):
        got_m, got_s = got["metrics"][steps - 1], got["states"][steps - 1]
        assert_loss_close(got_m["loss"], float(m["loss"]))
        assert abs(got_m["grad_norm"] - float(m["grad_norm"])) <= 1e-5
        assert got_m["step"] == steps == got_s["count"]
        _assert_params_close(got_s["params"], params, steps)
        if steps <= moments_steps:
            _assert_moments_close(got_s["mu"], adam.mu)
            _assert_moments_close(got_s["nu"], adam.nu)


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(jllama.init_params(jax.random.PRNGKey(0), _cfg()))


@pytest.fixture(scope="module")
def moe_tree():
    return jax.device_get(jmoe.init_params(jax.random.PRNGKey(0),
                                           _moe_cfg()))


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.bin"
    tloader.write_token_file(str(path), np.random.default_rng(8).integers(
        0, 512, size=4000))
    return path


def _cli_argv(data, ckpt, parallel, model="tiny", steps=6):
    return ["--data", str(data), "--ckpt", str(ckpt), "--model", model,
            "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu", "--parallel",
            parallel]


@pytest.fixture(scope="module")
def runs(tree, moe_tree, token_file, tmp_path_factory):
    """The port's groups: one per mesh shape."""
    tokens = _tokens(1)
    batches = [_tokens(10 + i) for i in range(3)]
    out = {"tokens": tokens, "batches": batches, "cli_ckpt":
           tmp_path_factory.mktemp("cli") / "ck"}
    rdv = str(tmp_path_factory.mktemp("rdv"))
    out["pp_dp_tp"] = launch.run(
        ranks.composed_group, 8, tree, tokens, MESHES["pp_dp_tp"],
        CASES["pp_dp_tp"], batches, LR, True, None,
        timeout=GROUP_TIMEOUT, workdir=rdv)
    out["pp_fsdp_tp"] = launch.run(
        ranks.composed_group, 8, tree, tokens, MESHES["pp_fsdp_tp"],
        CASES["pp_fsdp_tp"], None, LR, False,
        str(tmp_path_factory.mktemp("resume") / "ck"),
        timeout=GROUP_TIMEOUT, workdir=rdv)
    out["moe"] = launch.run(
        ranks.moe_composed_group, 4, moe_tree, tokens, MOE_MESH, MOE_COEFS,
        batches, LR, _cli_argv(token_file, out["cli_ckpt"], "3d"),
        timeout=GROUP_TIMEOUT, workdir=rdv)
    return out


@pytest.fixture(scope="module")
def ref(runs, tree):
    """The reference's loss and gradients per mesh and M (remat changes
    no value: the port's cases with and without it share one)."""
    return {(name, M): jax_loss_grads(jcomposed.make_composed_loss(
        _cfg(), _jmesh(MESHES[name]), M), tree, runs["tokens"])
        for name, cases in CASES.items() for M in {M for M, _ in cases}}


ALL_CASES = [(name, M, remat) for name, cases in CASES.items()
             for M, remat in cases]


@pytest.mark.parametrize("name,M,remat", ALL_CASES)
def test_composed_loss_and_every_gradient_match_reference(runs, ref, name,
                                                          M, remat):
    """Every rank's loss and every gradient leaf (gathered whole over
    stage, fsdp and tensor) against ``make_composed_loss``'s."""
    loss, grads = ref[(name, M)]
    for res in runs[name]:
        assert_loss_close(res[(M, remat)]["loss"], loss)
        assert_grads_close(res[(M, remat)]["grads"], grads)


@pytest.mark.parametrize("name,M,remat", ALL_CASES)
def test_composed_launches_and_vocab_shards(runs, name, M, remat):
    """A rank runs its stage's L/S layers at each of the S + M - 1 ticks
    at its H/tp heads: each flash kernel (L/S)(S + M - 1) times per step,
    each direction; and no op makes a full-vocab tensor (embed and
    lm_head are vocab-sharded over tensor)."""
    S = MESHES[name]["stage"]
    want = _cfg().n_layers // S * (S + M - 1)
    for res in runs[name]:
        assert res[(M, remat)]["calls"] == {
            "flash_forward": want, "flash_bwd_dq": want,
            "flash_bwd_dkv": want}
        assert res[(M, remat)]["full_vocab"] == []


def test_composed_missing_column_replicate_is_caught(runs, ref):
    """A planted fault: the normed input of the column-parallel matmuls
    not replicated over tensor. The loss is unchanged; the gradient check
    must see it."""
    loss, grads = ref[("pp_dp_tp", 2)]
    for res in runs["pp_dp_tp"]:
        assert_loss_close(res["planted"]["loss"], loss)
        assert worst_grad(res["planted"]["grads"], grads) > 10 * GRAD_TOL


def test_composed_steps_match_reference(runs, tree):
    """``make_composed_train_step`` at stage 2 x data 2 x tensor 2, M 2:
    loss, gradient norm (each leaf's squares over exactly the axes that
    split it), parameters and moments after each of 3 steps."""
    jm = _jmesh(MESHES["pp_dp_tp"])
    ref = _jax_steps(jcomposed.make_composed_train_step(
        _cfg(), jm, 2, jfsdp.default_optimizer(LR)), tree, runs["batches"])
    for res in runs["pp_dp_tp"]:
        _check_steps(res["steps"], ref)


def test_sharded_state_survives_checkpoint_resume(runs):
    """stage 2 x fsdp 2 x tensor 2: a checkpoint at step 2 (whole tensors
    from rank 0) restored onto the mesh is the state that was saved, and
    the resumed step 3 equals the uninterrupted one."""
    for res in runs["pp_fsdp_tp"]:
        r = res["resume"]
        for key in ("params", "mu", "nu"):
            for (name, a), (_, b) in zip(_leaves(r["restored"][key]),
                                         _leaves(r["at2"][key])):
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert r["restored"]["count"] == 2
        assert r["resumed_loss"] == r["losses"][2]


@pytest.mark.parametrize("coef", MOE_COEFS)
def test_moe_composed_matches_reference(runs, moe_tree, coef):
    """stage 2 x tensor 2, M 2: the loss (with the aux term off, and on:
    accumulated over the real microbatch ticks only) and every gradient
    leaf against ``make_moe_composed_loss``."""
    loss, grads = jax_loss_grads(jcomposed.make_moe_composed_loss(
        _moe_cfg(router_aux_coef=coef), _jmesh(MOE_MESH), 2), moe_tree,
        runs["tokens"])
    for res in runs["moe"]:
        assert_loss_close(res[coef]["loss"], loss)
        assert_grads_close(res[coef]["grads"], grads)


def test_moe_composed_steps_match_reference(runs, moe_tree):
    """3 steps of ``make_moe_composed_train_step``. The moments are held
    after the first step: the later steps' gradients are taken at
    parameters that Adam's sign flips (allowed above) may move, and a
    router moved near a top-k tie reroutes tokens; measured, the third
    step's first moment of wq differs by 9.3e-5 of its largest element,
    the first two steps' by under 4e-6."""
    ref = _jax_steps(jcomposed.make_moe_composed_train_step(
        _moe_cfg(), _jmesh(MOE_MESH), 2, jfsdp.default_optimizer(LR)),
        moe_tree, runs["batches"])
    for res in runs["moe"]:
        _check_steps(res["steps"], ref, moments_steps=1)


def _same_error(ref_call, port_call):
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [
    {"n_layers": 3}, {"n_kv_heads": 1}, {"d_ff": 255}, {"vocab_size": 511}])
def test_composed_rejects_what_the_reference_rejects(overrides):
    sizes = MESHES["pp_dp_tp"]
    _same_error(
        lambda: jcomposed.make_composed_loss(_cfg(**overrides),
                                             _jmesh(sizes), 2),
        lambda: tcomposed.make_composed_loss(
            tllama.LlamaConfig.tiny(**overrides), ranks.fake_mesh(**sizes),
            2))


def test_composed_rejects_an_indivisible_batch(tree):
    sizes = MESHES["pp_dp_tp"]
    tokens = _tokens(1, B=6)
    _same_error(
        lambda: jcomposed.make_composed_loss(_cfg(), _jmesh(sizes), 2)(
            tree, jnp.asarray(tokens)),
        lambda: tcomposed.make_composed_loss(
            tllama.LlamaConfig.tiny(), ranks.fake_mesh(**sizes), 2)(
            convert.to_torch(tree, device="cpu"), torch.as_tensor(tokens)))


@pytest.mark.parametrize("sizes,overrides", [
    (dict(stage=2, data=1, fsdp=2, tensor=2), {}),
    (dict(stage=2, data=2, fsdp=1, tensor=2), {"n_experts": 3}),
    (dict(stage=2, data=2, fsdp=1, tensor=2), {"n_layers": 3})])
def test_moe_composed_rejects_what_the_reference_rejects(sizes, overrides):
    _same_error(
        lambda: jcomposed.make_moe_composed_loss(_moe_cfg(**overrides),
                                                 _jmesh(sizes), 2),
        lambda: tcomposed.make_moe_composed_loss(
            tmoe.MoEConfig.tiny(**overrides), ranks.fake_mesh(**sizes), 2))


@pytest.mark.parametrize("path", ["composed", "moe_composed", "pp", "ep"])
def test_param_specs_follow_the_reference_rule(path):
    """Each path's spec tree is the reference's PartitionSpecs, entry for
    entry, on the same parameter tree."""
    if path in ("composed", "pp"):
        tree = jllama.init_params(jax.random.PRNGKey(0), _cfg())
    else:
        tree = jmoe.init_params(jax.random.PRNGKey(0), _moe_cfg())
    want = {"composed": jcomposed.composed_param_specs,
            "moe_composed": jcomposed.moe_composed_param_specs,
            "pp": lambda: jpipe.pp_param_specs(tree),
            "ep": jexpert.ep_param_specs}[path]()
    got = {"composed": tcomposed.composed_param_specs,
           "moe_composed": tcomposed.moe_composed_param_specs,
           "pp": tpipe.pp_param_specs,
           "ep": texpert.ep_param_specs}[path]()
    flat = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(list(tllama.param_leaves(got)))
    for keys, spec in flat:
        node = got
        for key in keys:
            node = node[key.key]
        leaf = tree
        for key in keys:
            leaf = leaf[key.key]
        assert tuple(spec) + (None,) * (leaf.ndim - len(spec)) == node, keys


# ------------------------------------------------------------ the CLI

def _step6_loss(out):
    m = re.search(r"\(step 6 loss ([0-9.]+)\)", out)
    assert m is not None, out
    return float(m.group(1))


def test_cli_3d_drains_at_four_ranks_and_resumes_at_one(runs, token_file,
                                                        tmp_path, capsys):
    """``--parallel 3d`` on 4 ranks (stage 2 x tensor 2, M 2), checkpoint
    at 2, a drain at 3 signalled on rank 0 only; the same command at one
    rank (``--parallel none``) reads the whole tensors and trains 4-6, to
    the step-6 loss of an uninterrupted one-rank run (bf16: CLI_RTOL)."""
    res = [r["cli"] for r in runs["moe"]]
    ckpt = runs["cli_ckpt"]
    assert [r["rc"] for r in res] == [0] * 4
    assert "preempted at step 3; checkpoint 3 saved" in res[0]["out"]
    assert all(r["out"] == "" for r in res[1:])
    assert sorted(p.name for p in ckpt.iterdir()
                  if p.name.isdigit()) == ["2", "3"]
    assert train.main(_cli_argv(token_file, ckpt, "none")) == 0
    resumed = capsys.readouterr().out
    assert "done: 3 steps" in resumed
    assert train.main(_cli_argv(token_file, tmp_path / "ck", "none")) == 0
    straight = _step6_loss(capsys.readouterr().out)
    assert abs(_step6_loss(resumed) - straight) <= CLI_RTOL * straight


def _reference_cli():
    spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                  REPO / "cmd" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**kw):
    base = dict(model="tiny", parallel="fsdp", moe_dispatch="dense",
                sp_attn="ring", batch=8, seq=16)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [
    dict(parallel="pp", batch=3),
    dict(parallel="3d", batch=3),
    dict(parallel="ep"),
    dict(moe_dispatch="a2a"),
    dict(model="moe_tiny"),
    dict(model="moe_tiny", parallel="sp"),
    dict(model="moe_tiny", parallel="pp"),
    dict(model="moe_tiny", parallel="3d", batch=6),
    dict(model="moe_tiny", parallel="ep", moe_dispatch="a2a", batch=6)])
def test_cli_rejects_what_the_reference_rejects(kw, capsys):
    """``build_parallel`` at 8 ranks against the reference's at its 8
    devices: the same SystemExit, message for message."""
    ref = _reference_cli()
    args = _args(**kw)
    jcfg = (jmoe.MoEConfig.tiny() if args.model == "moe_tiny"
            else jllama.LlamaConfig.tiny())
    tcfg = (tmoe.MoEConfig.tiny() if args.model == "moe_tiny"
            else tllama.LlamaConfig.tiny())
    with pytest.raises(SystemExit) as want:
        ref.build_parallel(jcfg, args, jfsdp.default_optimizer())
    with pytest.raises(SystemExit) as got:
        cli.build_parallel(tcfg, args, default_optimizer(), "cpu", 8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("parallel,n,msg", [
    ("3d", 6, "--parallel 3d needs a multiple of 4 devices (stage=2 x "
              "tensor=2), have 6"),
    ("pp", 3, "pipeline needs gcd(devices=3, layers=2) ≥ 2")])
def test_cli_rejects_rank_counts_the_reference_rejects(parallel, n, msg):
    """World sizes the conftest's 8 devices cannot give the reference: its
    messages, as written in ``cmd/train.py``."""
    with pytest.raises(SystemExit, match=re.escape(msg)):
        cli.build_parallel(tllama.LlamaConfig.tiny(),
                           _args(parallel=parallel), default_optimizer(),
                           "cpu", n)
