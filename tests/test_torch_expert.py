"""Expert parallelism (the MoE's experts over ``tensor``, dense and
all-to-all dispatch) of the port against the JAX package on the CPU, and
``--parallel ep --moe-dispatch a2a`` through the CLI.

One ``launch.run`` group of gloo ranks per rank count, 2 and 4
(``GROUP_TIMEOUT`` each); the reference is ``make_ep_loss`` /
``make_ep_a2a_loss`` / ``make_ep_train_step`` on a tensor mesh of as many
virtual CPU devices (``tests/conftest.py``), on the same parameters and
tokens. fp32 at ``MoEConfig.tiny()`` (4 experts, top-2). Bounds: the loss
to 1e-5 relative, every gradient leaf to 1e-4 of its largest element;
steps as in ``tests/test_torch_composed.py`` (moments after the first
step). At a tight capacity the dropped (token, expert) pairs must be the
reference's, read from its own output."""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import moe as jmoe
from k8s_operator_libs_tpu.parallel import expert as jexpert
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu.parallel.mesh import make_mesh
from k8s_operator_libs_tpu_torch.data import loader as tloader
from k8s_operator_libs_tpu_torch.models import moe as tmoe
from k8s_operator_libs_tpu_torch.parallel import expert as texpert
from k8s_operator_libs_tpu_torch.parallel import launch
from test_torch_composed import _check_steps, _jax_steps
from test_torch_pipeline import (assert_grads_close, assert_loss_close,
                                 jax_loss_grads, worst_grad)

GROUP_TIMEOUT = 120.0
GRAD_TOL = 1e-4
LR = 3e-4
NS = (2, 4)
TIGHT = 0.5                 # capacity factor: C = G/4 at E 4, top-2
LOSSLESS = 2.0              # E / top_k: C = G
# (dispatch, capacity factor, router aux coef, remat)
CASES = (("dense", None, 0.01, False), ("dense", None, 0.01, True),
         ("a2a", LOSSLESS, 0.0, False), ("a2a", TIGHT, 0.01, False),
         ("a2a", TIGHT, 0.01, True))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    return jmoe.MoEConfig.tiny(dtype=jnp.float32, **kw)


def _tokens(seed, B=4, T=17, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, T)).astype(np.int32)


def _jmesh(n):
    return make_mesh(tensor=n, fsdp=1, devices=jax.devices()[:n])


LAYER_B, LAYER_T = 8, 16


def _layer_case(tree, n):
    """h [8, 16, D] and layer 0's router and experts, at the tight
    capacity of one rank's 8/n x 16 tokens."""
    cfg = _cfg()
    h = np.random.default_rng(5).standard_normal(
        (LAYER_B, LAYER_T, cfg.d_model)).astype(np.float32)
    layer = {k: np.asarray(tree["blocks"][k][0])
             for k in ("router", "w_gate", "w_up", "w_down")}
    G = LAYER_B // n * LAYER_T
    cap = min(G, int(np.ceil(TIGHT * cfg.top_k * G / cfg.n_experts)))
    return h, layer, cap


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(jmoe.init_params(jax.random.PRNGKey(0), _cfg()))


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.bin"
    tloader.write_token_file(str(path), np.random.default_rng(8).integers(
        0, 512, size=4000))
    return path


def _cli_argv(data, ckpt):
    return ["--data", str(data), "--ckpt", str(ckpt), "--model", "moe_tiny",
            "--steps", "6", "--batch", "2", "--seq", "16",
            "--ckpt-interval", "2", "--device", "cpu", "--parallel", "ep",
            "--moe-dispatch", "a2a"]


@pytest.fixture(scope="module")
def runs(tree, token_file, tmp_path_factory):
    tokens = _tokens(1)
    batches = [_tokens(10 + i) for i in range(3)]
    out = {"tokens": tokens, "batches": batches}
    rdv = str(tmp_path_factory.mktemp("rdv"))
    ck = tmp_path_factory.mktemp("cli")
    for n in NS:
        cli_runs = ()
        if n == 2:
            cli_runs = ((_cli_argv(token_file, ck / "straight"), None),
                        (_cli_argv(token_file, ck / "drained"), 4),
                        (_cli_argv(token_file, ck / "drained"), None))
        out[n] = launch.run(ranks.ep_group, n, tree, tokens, CASES, batches,
                            LR, _layer_case(tree, n), cli_runs,
                            timeout=GROUP_TIMEOUT, workdir=rdv)
    return out


def _jax_loss(case, n):
    dispatch, cf, coef, _ = case
    cfg = _cfg(router_aux_coef=coef)
    if dispatch == "dense":
        return jexpert.make_ep_loss(cfg, _jmesh(n))
    return jexpert.make_ep_a2a_loss(cfg, _jmesh(n), cf)


@pytest.fixture(scope="module")
def ref(runs, tree):
    """The reference's loss and gradients per rank count and case (remat
    changes no value: a case with it shares the one without)."""
    out = {}
    for n in NS:
        for case in CASES:
            key = (n, *case[:3])
            if key not in out:
                out[key] = jax_loss_grads(_jax_loss(case, n), tree,
                                          runs["tokens"])
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ep_loss_and_every_gradient_match_reference(runs, ref, n, case):
    """Dense dispatch, lossless a2a and tight a2a (with and without
    remat): every rank's loss and every gradient leaf (the expert stacks
    gathered whole) against the reference's same dispatch."""
    loss, grads = ref[(n, *case[:3])]
    for res in runs[n]:
        assert_loss_close(res[case]["loss"], loss)
        assert_grads_close(res[case]["grads"], grads)


@pytest.mark.parametrize("n", NS)
def test_lossless_a2a_is_dense_dispatch(runs, tree, n):
    """At capacity factor E/top_k no pair is dropped, so with the aux term
    off (its per-shard estimate differs from the global-batch one) the
    a2a loss and gradients are the one-device dense reference's."""
    loss, grads = jax_loss_grads(jexpert.moe_reference_loss(
        _cfg(router_aux_coef=0.0)), tree, runs["tokens"])
    case = ("a2a", LOSSLESS, 0.0, False)
    for res in runs[n]:
        assert_loss_close(res[case]["loss"], loss)
        assert_grads_close(res[case]["grads"], grads)
        for routed, kept in zip(res[case]["routed"], res[case]["kept"]):
            np.testing.assert_array_equal(kept, routed)


def _reference_kept(h, layer, cap, n):
    """The reference's kept (token, expert) pairs, read from its own
    output: its ``moe_ffn_a2a`` over n devices gives y; each token's
    output is the gate-weighted sum of the experts that kept it, so the
    subset of its routed experts whose sum is nearest y is its kept set."""
    cfg = _cfg()
    mesh = _jmesh(n)
    w_spec = {"router": P(), "w_gate": P("tensor"), "w_up": P("tensor"),
              "w_down": P("tensor")}
    fn = jax.jit(jax.shard_map(
        lambda hh, ll: jmoe.moe_ffn_a2a(hh, ll, cfg, n, cap, "tensor")[0],
        mesh=mesh, in_specs=(P("tensor"), w_spec), out_specs=P("tensor")))
    y = np.asarray(fn(jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray,
                                                             layer)))
    w, _ = jmoe.router_weights(jnp.asarray(h), jnp.asarray(layer["router"]),
                               cfg.top_k)
    w = np.asarray(w).reshape(-1, cfg.n_experts)
    x = h.reshape(-1, cfg.d_model).astype(np.float64)
    per = []
    for e in range(cfg.n_experts):
        g = x @ layer["w_gate"][e]
        per.append((g / (1 + np.exp(-g)) * (x @ layer["w_up"][e]))
                   @ layer["w_down"][e])
    per = np.stack(per, 1)                                  # [G, E, D]
    y = y.reshape(len(x), -1)
    kept = np.zeros(w.shape, bool)
    for g in range(len(x)):
        routed = np.flatnonzero(w[g] > 0)
        best = min((s for k in range(len(routed) + 1)
                    for s in itertools.combinations(routed, k)),
                   key=lambda s: np.abs(y[g] - sum(
                       (w[g, e] * per[g, e] for e in s),
                       np.zeros(per.shape[-1]))).max())
        kept[g, list(best)] = True
    return kept, w > 0, y


@pytest.mark.parametrize("n", NS)
def test_tight_capacity_drops_the_reference_pairs(runs, tree, n):
    """``moe_ffn_a2a`` at capacity G/4 on each rank's rows: the output,
    and the kept (token, expert) pairs against the reference's. The order
    that decides the drops is a cumsum over each rank's B/n x T tokens,
    row-major; a [T, B] order keeps other pairs, which the same check
    tells apart."""
    h, layer, cap = _layer_case(tree, n)
    kept_ref, routed, y_ref = _reference_kept(h, layer, cap, n)
    got = np.concatenate([r["layer"]["kept"] for r in runs[n]])
    y = np.concatenate([r["layer"]["y"] for r in runs[n]]).reshape(
        y_ref.shape)
    np.testing.assert_allclose(y, y_ref, atol=1e-5 * np.abs(y_ref).max())
    assert (routed & ~kept_ref).sum() > 0              # pairs were dropped
    np.testing.assert_array_equal(got, kept_ref)
    # the planted order: tokens [T, B] within each rank's shard
    Bl, T = LAYER_B // n, LAYER_T
    shard = routed.reshape(n, Bl, T, -1).transpose(0, 2, 1, 3).reshape(
        n, Bl * T, -1)
    pos = np.cumsum(shard, axis=1) - 1
    other = (shard & (pos < cap)).reshape(n, T, Bl, -1).transpose(
        0, 2, 1, 3).reshape(routed.shape)
    assert not np.array_equal(other, kept_ref)


@pytest.mark.parametrize("n", NS)
def test_ep_missing_router_replicate_is_caught(runs, ref, n):
    """A planted fault: the gate weights and ``mean_prob`` cut to the
    local experts without being replicated first. The loss is unchanged;
    the router's gradient misses the other ranks' experts."""
    loss, grads = ref[(n, "dense", None, 0.01)]
    for res in runs[n]:
        assert_loss_close(res["planted"]["loss"], loss)
        assert worst_grad(res["planted"]["grads"], grads) > 10 * GRAD_TOL


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dispatch", ["dense", "a2a"])
def test_ep_steps_match_reference(runs, tree, n, dispatch):
    """3 steps of ``make_ep_train_step`` (a2a at its default capacity
    factor 2.0), held as the composed MoE steps are."""
    ref = _jax_steps(jexpert.make_ep_train_step(
        _cfg(), _jmesh(n), jfsdp.default_optimizer(LR), dispatch=dispatch),
        tree, runs["batches"])
    for res in runs[n]:
        _check_steps(res[("steps", dispatch)], ref, moments_steps=1)


def test_cli_a2a_drains_and_resumes_at_two_ranks(runs):
    """``--parallel ep --moe-dispatch a2a`` on 2 ranks: checkpoint at 2,
    a drain at 3 signalled on rank 0, the same command resumed, to the
    uninterrupted run's step-6 loss (to the printed digit)."""
    straight, drained, resumed = (c["out"] for c in runs[2][0]["cli"])
    assert all(c["rc"] == 0 for r in runs[2] for c in r["cli"])
    assert all(c["out"] == "" for c in runs[2][1]["cli"])
    assert "preempted at step 3; checkpoint 3 saved" in drained
    assert "done: 3 steps" in resumed

    def loss(out):
        return re.search(r"\(step 6 loss ([0-9.]+)\)", out).group(1)

    assert loss(resumed) == loss(straight)


@pytest.mark.parametrize("what", ["experts", "a2a_batch", "dispatch"])
def test_ep_rejects_what_the_reference_rejects(tree, what):
    """The reference's checks and messages: experts over the ranks, the
    a2a batch over the ranks, the dispatch's name."""
    tokens = _tokens(1, B=3)
    cfg3 = dict(n_experts=3) if what == "experts" else {}
    ref_call = {
        "experts": lambda: jexpert.make_ep_loss(_cfg(**cfg3), _jmesh(2)),
        "a2a_batch": lambda: jexpert.make_ep_a2a_loss(_cfg(), _jmesh(2))(
            tree, jnp.asarray(tokens)),
        "dispatch": lambda: jexpert.make_ep_train_step(
            _cfg(), _jmesh(2), dispatch="ring")}[what]
    mesh = ranks.fake_mesh(tensor=2, fsdp=1)
    tcfg = tmoe.MoEConfig.tiny(**cfg3)
    port_call = {
        "experts": lambda: texpert.make_ep_loss(tcfg, mesh),
        "a2a_batch": lambda: texpert.make_ep_a2a_loss(tcfg, mesh)(
            None, torch.as_tensor(tokens)),
        "dispatch": lambda: texpert.make_ep_train_step(
            tcfg, mesh, dispatch="ring")}[what]
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_moe_ffn_keeps_the_dense_path_on_the_local_experts():
    """``moe_ffn`` with ``experts_slice`` on one device: the stacks cut to
    the slice, one product per local expert; the two halves' outputs sum
    to the whole layer's and their aux terms to its aux."""
    cfg = tmoe.MoEConfig.tiny(dtype=torch.float32)
    params = tmoe.init_params(cfg, 0, device="cpu")
    layer = {k: v[0] for k, v in params["blocks"].items()}
    h = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    whole, aux = tmoe.moe_ffn(h, layer, cfg)
    parts = [tmoe.moe_ffn(h, layer, cfg, experts_slice=(s, 2))
             for s in (0, 2)]
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(parts[0][1] + parts[1][1], aux, rtol=1e-6,
                               atol=1e-7)
