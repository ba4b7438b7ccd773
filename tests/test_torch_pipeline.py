"""Pipeline parallelism (GPipe over the ``stage`` axis) of the port
against the JAX package on the CPU.

The port's loss runs in 2 gloo ranks started by ``launch.run`` (one
group, ``GROUP_TIMEOUT``); the reference is ``make_pp_loss`` /
``make_pp_train_step`` on 2 of the virtual CPU devices of
``tests/conftest.py``, on the same parameters (carried over by
``convert.py``) and tokens. fp32 at ``LlamaConfig.tiny()``. Bounds: the
loss to 1e-5 relative, every gradient leaf to 1e-4 of its largest
element; steps as in ``tests/test_torch_fsdp_parallel.py`` (Adam's sign
flips bounded, not a looser tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from k8s_operator_libs_tpu.models import llama as jllama
from k8s_operator_libs_tpu.parallel import fsdp as jfsdp
from k8s_operator_libs_tpu.parallel import pipeline as jpipe
from k8s_operator_libs_tpu.parallel.mesh import make_mesh
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.parallel import pipeline as tpipe
from k8s_operator_libs_tpu_torch.parallel import launch
from k8s_operator_libs_tpu_torch.utils.mesh import local_mesh
from test_torch_fsdp_parallel import (_assert_moments_close,
                                      _assert_params_close, _leaves)

GROUP_TIMEOUT = 120.0
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 3e-4
S = 2
CASES = ((2, False), (4, True))       # (microbatches, remat)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def assert_loss_close(got, ref):
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)


def assert_grads_close(got, ref, tol=GRAD_TOL):
    """Every leaf: max |got - ref| within ``tol`` of the leaf's largest
    |ref|."""
    got = dict(_leaves(got))
    for name, r in _leaves(ref):
        err = np.abs(got[name] - r).max()
        assert err <= tol * np.abs(r).max(), (name, err, np.abs(r).max())


def worst_grad(got, ref):
    got = dict(_leaves(got))
    return max(np.abs(got[n] - r).max() / np.abs(r).max()
               for n, r in _leaves(ref))


def _cfg(remat=False, **kw):
    return jllama.LlamaConfig.tiny(dtype=jnp.float32, remat=remat, **kw)


def _tokens(seed, B=8, T=17, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(jllama.init_params(jax.random.PRNGKey(0), _cfg()))


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(stage=S, fsdp=1, devices=jax.devices()[:S])


@pytest.fixture(scope="module")
def run(tree, tmp_path_factory):
    tokens = _tokens(1)
    batches = [_tokens(10 + i) for i in range(3)]
    (res, *others) = launch.run(ranks.pp_group, S, tree, tokens, CASES,
                                batches, LR, timeout=GROUP_TIMEOUT,
                                workdir=str(tmp_path_factory.mktemp("rdv")))
    return {"tokens": tokens, "batches": batches, "ranks": [res, *others]}


def jax_loss_grads(loss_fn, params, tokens):
    """(loss, gradients on the host) of a reference loss, jitted."""
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                       jnp.asarray(tokens))
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def ref(run, tree, jmesh):
    """The reference's loss and gradients per (M, remat)."""
    return {(M, remat): jax_loss_grads(jpipe.make_pp_loss(
        _cfg(remat), jmesh, M), tree, run["tokens"]) for M, remat in CASES}


@pytest.mark.parametrize("M,remat", CASES)
def test_pp_loss_and_every_gradient_match_reference(run, ref, M, remat):
    """Both stages' loss and every gradient leaf (gathered whole) against
    ``make_pp_loss``'s, at M 2 and at M 4 under remat."""
    loss, grads = ref[(M, remat)]
    for res in run["ranks"]:
        assert_loss_close(res[(M, remat)]["loss"], loss)
        assert_grads_close(res[(M, remat)]["grads"], grads)


@pytest.mark.parametrize("M,remat", CASES)
def test_pp_launches_each_kernel_per_layer_per_tick(run, M, remat):
    """A stage runs its L/S layers at every one of the S + M - 1 ticks,
    bubbles included, and every tick's output reaches the loss: each
    flash kernel (its plain version here) (L/S)(S + M - 1) times per
    step, forward and backward, remat re-running none."""
    L = _cfg().n_layers
    want = L // S * (S + M - 1)
    for res in run["ranks"]:
        assert res[(M, remat)]["calls"] == {
            "flash_forward": want, "flash_bwd_dq": want,
            "flash_bwd_dkv": want}


@pytest.mark.parametrize("M,remat", CASES)
def test_pp_never_makes_full_vocab_logits(run, M, remat):
    """embed and lm_head are vocab-sharded over the stages: no op of the
    forward or backward returns a tensor whose last dim is the whole
    vocabulary (the reference's test walks its jaxpr for the same)."""
    for res in run["ranks"]:
        assert res[(M, remat)]["full_vocab"] == []


def test_pp_missing_head_replicate_is_caught(run, ref):
    """A planted fault: the head's input not replicated over the stages.
    The loss is unchanged; the gradient check must see it."""
    loss, grads = ref[(2, False)]
    for res in run["ranks"]:
        assert_loss_close(res["planted"]["loss"], loss)
        assert worst_grad(res["planted"]["grads"], grads) > 10 * GRAD_TOL


@pytest.mark.parametrize("steps", [1, 3])
def test_pp_steps_match_reference(run, tree, jmesh, steps):
    """``make_pp_train_step`` at M 4: loss, gradient norm (each stage's
    leaves counted once), parameters and both moments after 1 and 3
    steps."""
    opt = jfsdp.default_optimizer(LR)
    state = jfsdp.TrainState(params=tree, opt_state=opt.init(tree),
                             step=jnp.zeros((), jnp.int32))
    step = jpipe.make_pp_train_step(_cfg(), jmesh, 4, opt)
    for b in run["batches"][:steps]:
        state, m = step(state, jnp.asarray(b))
    host = jax.device_get(state)
    adam = convert._adam_state(host.opt_state)
    for res in run["ranks"]:
        got_m = res["steps"]["metrics"][steps - 1]
        got = res["steps"]["states"][steps - 1]
        assert_loss_close(got_m["loss"], float(m["loss"]))
        assert abs(got_m["grad_norm"] - float(m["grad_norm"])) <= 1e-5
        assert got_m["step"] == steps == got["count"]
        _assert_params_close(got["params"], host.params, steps)
        _assert_moments_close(got["mu"], adam.mu)
        _assert_moments_close(got["nu"], adam.nu)


def test_pp_init_keeps_the_one_rank_init(run):
    """``init_pp_state`` gives each stage its slices of the one-rank
    ``init_params(seed)``: gathered, they are that tree."""
    whole = convert.to_numpy(tllama.init_params(
        tllama.LlamaConfig.tiny(dtype=torch.float32), seed=3, device="cpu"))
    for res in run["ranks"]:
        got = dict(_leaves(res["init"]))
        for name, x in _leaves(whole):
            np.testing.assert_array_equal(got[name], x)


@pytest.mark.parametrize("M", [1, 4])
def test_pp_single_stage_matches_reference(tree, M):
    """S 1 (no warm-up ticks, the window is every tick) on one rank: the
    loss and gradients of ``make_pp_loss`` on one device."""
    jm = make_mesh(stage=1, fsdp=1, devices=jax.devices()[:1])
    tokens = _tokens(2)
    loss, grads = jax_loss_grads(jpipe.make_pp_loss(_cfg(), jm, M), tree,
                                 tokens)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    got_loss, got = ranks.tfsdp.value_and_grad(
        tpipe.make_pp_loss(tcfg, local_mesh(), M),
        convert.to_torch(tree, device="cpu"), torch.as_tensor(tokens))
    assert_loss_close(float(got_loss), loss)
    assert_grads_close(convert.to_numpy(got), grads)


@pytest.mark.parametrize("overrides", [{"n_layers": 3}, {"vocab_size": 511}])
def test_pp_rejects_what_the_reference_rejects(overrides):
    """Layers and vocabulary must divide over the stages; the reference's
    messages."""
    with pytest.raises(ValueError) as ref:
        jpipe.make_pp_loss(_cfg(**overrides),
                           make_mesh(stage=S, fsdp=1,
                                     devices=jax.devices()[:S]), 2)
    with pytest.raises(ValueError) as got:
        tpipe.make_pp_loss(tllama.LlamaConfig.tiny(**overrides),
                           ranks.fake_mesh(stage=S, fsdp=1), 2)
    assert str(got.value) == str(ref.value)
