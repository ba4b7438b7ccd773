"""The port's speculative decoding against the JAX reference on the CPU:
``models/speculative.py`` (greedy token-identical, sampled by
distribution, ``accept_counts`` on edge rows) and the batcher's draft
mode (token-identical to the plain batcher and to JAX's draft batcher,
round by round; a slot filled to its last row; migration in draft mode).
Weights are the reference's own, carried over by ``convert.py``."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.models import generate as jgen
from k8s_operator_libs_tpu.models import paged as jpaged
from k8s_operator_libs_tpu.models import speculative as jspec
from k8s_operator_libs_tpu.models.llama import LlamaConfig as JConfig
from k8s_operator_libs_tpu.models.llama import init_params
from k8s_operator_libs_tpu.models.serve import ContinuousBatcher as JBatcher
from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import generate as tgen
from k8s_operator_libs_tpu_torch.models import paged as tpaged
from k8s_operator_libs_tpu_torch.models import speculative as tspec
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig as TConfig
from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub

JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = TConfig.tiny(dtype=torch.float32)
JDCFG = JConfig.tiny(dtype=jnp.float32, n_layers=1)
TDCFG = TConfig.tiny(dtype=torch.float32, n_layers=1)
PREFIX = np.arange(100, 113, dtype=np.int32)   # 1 whole block of 8 + 5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU pool small beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    """(JAX target, port target, JAX draft, port draft): the draft is the
    target's first layer alone (with its embedding and head), so it
    agrees with the target on some tokens and not on others."""
    tree = jax.device_get(init_params(jax.random.PRNGKey(0), JCFG))
    dtree = dict(tree, blocks={n: w[:1] for n, w in tree["blocks"].items()})
    return (tree, convert.to_torch(tree, device="cpu"), dtree,
            convert.to_torch(dtree, device="cpu"))


def _prompt(B=2, T=7, seed=1):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, size=(B, T)).astype(np.int32)


# ------------------------------------------------------------ accept_counts

@pytest.mark.parametrize("rows", [
    [[True, True, True], [False, False, False], [False, True, True],
     [True, False, True], [True, True, False]],
    [[True], [False]],
    [[False, True, True, True, True, True]],
])
def test_accept_counts_edge_rows(rows):
    match = np.asarray(rows)
    ref = np.asarray(jspec.accept_counts(jnp.asarray(match)))
    got = tspec.accept_counts(torch.as_tensor(match)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [next((i for i, m in enumerate(r) if not m),
                                 len(r)) for r in rows]


# ------------------------------------------------------------ greedy

def _argmin_draft_j(params, tokens, cache, cfg):
    logits, cache = jgen._forward_cached(params, tokens, cache, cfg)
    return -logits, cache


def _argmin_draft_t(params, tokens, cache, cfg):
    """The target's own forward with negated logits: every proposal is
    the target's argmin, so no draft token is ever accepted."""
    logits, cache = tgen._forward_cached(params, tokens, cache, cfg)
    return -logits, cache


@pytest.mark.parametrize("draft", ["other", "self-int8", "zero-accept"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_greedy_speculative_token_identical(weights, draft, k):
    tree, params, dtree, dparams = weights
    prompt = _prompt()
    if draft == "other":
        j_args, t_args = (dtree, JDCFG, None), (dparams, TDCFG, None)
    elif draft == "self-int8":
        jd, jf = jspec.quantized_self_draft(tree)
        td, tf = tspec.quantized_self_draft(params)
        j_args, t_args = (jd, JCFG, jf), (td, TCFG, tf)
    else:
        j_args = (tree, JCFG, _argmin_draft_j)
        t_args = (params, TCFG, _argmin_draft_t)
    ref = np.asarray(jspec.speculative_generate(
        tree, j_args[0], jnp.asarray(prompt), JCFG, j_args[1],
        max_new_tokens=17, k=k, draft_forward=j_args[2]))
    got = tspec.speculative_generate(
        params, t_args[0], torch.as_tensor(prompt), TCFG, t_args[1],
        max_new_tokens=17, k=k, draft_forward=t_args[2]).numpy()
    plain = tgen.generate(params, torch.as_tensor(prompt), TCFG,
                          max_new_tokens=17).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, plain)


def test_speculative_refuses_zero_depth(weights):
    _, params, _, dparams = weights
    with pytest.raises(ValueError):
        tspec.speculative_generate(params, dparams,
                                   torch.as_tensor(_prompt()), TCFG, TDCFG,
                                   max_new_tokens=4, k=0)


# ------------------------------------------------------------ sampled

SAMPLING = dict(temperature=0.5, top_k=8, top_p=0.9)
N_SEQ, TP, NEW = 8192, 5, 3
# the sampled test's threshold, as a multiple of the sampling-noise floor:
# a correct emission reads 1.0-1.3 of the floor on these drafts; drawing
# the rejected token from p_t instead of the residual reads about 4 with
# the layer-skip draft at this N
NOISE_MULTIPLE = 3.0


def _tied_uniform_draft(params, tokens, cache, cfg):
    """All-zero (exactly tied) logits: top_k keeps the whole vocabulary,
    so the draft proposes uniformly."""
    B, T = tokens.shape
    return (torch.zeros((B, T, cfg.vocab_size)),
            dataclasses.replace(cache, length=cache.length + T))


def _point_mass_draft(params, tokens, cache, cfg):
    """Nearly all mass on token 0, which the target almost never picks:
    every round rejects and draws from the residual."""
    B, T = tokens.shape
    logits = torch.zeros((B, T, cfg.vocab_size))
    logits[..., 0] = 20.0
    return logits, dataclasses.replace(cache, length=cache.length + T)


def _tempered_draft(params, tokens, cache, cfg):
    """The target's own logits halved: a flatter proposal that overlaps
    the target's distribution without matching it."""
    logits, cache = tgen._forward_cached(params, tokens, cache, cfg)
    return logits * 0.5, cache


def _target_dist(params, seqs):
    """The filtered sampling distribution [B, V] after each sequence."""
    seqs = torch.as_tensor(np.asarray(seqs, np.int32))
    cache = tgen.init_cache(TCFG, seqs.shape[0], seqs.shape[1],
                            device="cpu")
    logits, _ = tgen._forward_cached(params, seqs, cache, TCFG)
    scaled = tgen.filter_logits(logits[:, -1] / SAMPLING["temperature"],
                                SAMPLING["top_k"], SAMPLING["top_p"])
    return torch.softmax(scaled.double(), dim=-1).numpy()


def _exact_marginals(params, base):
    """The exact marginal of each of the NEW positions under target-only
    sampling, by enumerating every context the filters leave open."""
    ctxs, weights_ = [list(base)], [1.0]
    out = []
    for _ in range(NEW):
        dist = _target_dist(params, ctxs)
        out.append(np.einsum("c,cv->v", np.asarray(weights_), dist))
        nxt, nw = [], []
        for ctx, w, row in zip(ctxs, weights_, dist):
            for tok in np.nonzero(row)[0]:
                nxt.append(ctx + [int(tok)])
                nw.append(w * row[tok])
        ctxs, weights_ = nxt, nw
    return out


def _noise_floor(p, n):
    """E[TV(empirical of n draws, p)] under the normal approximation of
    each count: 0.5 * sum_i sqrt(2 p_i (1 - p_i) / (pi n))."""
    return 0.5 * float(np.sum(np.sqrt(2 * p * (1 - p) / (math.pi * n))))


@pytest.mark.parametrize("draft", ["other", "tempered", "tied-uniform",
                                   "point-mass"])
def test_sampled_speculative_keeps_target_distribution(weights, draft):
    """Rejection sampling is distributed as target-only sampling for any
    draft: the layer-skip draft, a flattened copy of the target, and two
    adversarial ones.
    N_SEQ independent sequences decode NEW tokens in one call (the batch
    minimum of acceptance is ~0 each round, so nearly every token goes
    through the per-sequence accept-or-residual emission). Each
    position's empirical marginal must lie within NOISE_MULTIPLE times
    the sampling-noise floor (in total variation) of the exact marginal,
    which enumerates every context the filters leave open, and no token
    outside its support may appear."""
    _, params, _, dparams = weights
    base = _prompt(1, TP, seed=2)[0]
    prompt = torch.as_tensor(np.broadcast_to(base, (N_SEQ, TP)).copy())
    if draft == "other":
        d_params, d_cfg, d_fwd = dparams, TDCFG, None
    else:
        d_params, d_cfg = params, TCFG
        d_fwd = {"tempered": _tempered_draft,
                 "tied-uniform": _tied_uniform_draft,
                 "point-mass": _point_mass_draft}[draft]
    gen = torch.Generator().manual_seed(11)
    spec = tspec.speculative_generate(
        params, d_params, prompt, TCFG, d_cfg, max_new_tokens=NEW, k=3,
        draft_forward=d_fwd, generator=gen, **SAMPLING).numpy()
    V = TCFG.vocab_size
    for pos, exact in enumerate(_exact_marginals(params, base)):
        counts = np.bincount(spec[:, TP + pos], minlength=V)
        assert counts[exact == 0].sum() == 0, \
            f"position {pos}: a token outside the target's support"
        tv = 0.5 * np.abs(counts / N_SEQ - exact).sum()
        floor = _noise_floor(exact, N_SEQ)
        assert tv <= NOISE_MULTIPLE * floor, (
            f"{draft} draft, position {pos}: TV {tv:.4f} > "
            f"{NOISE_MULTIPLE} x noise floor {floor:.4f}")


def test_sampled_speculative_is_seeded(weights):
    _, params, _, dparams = weights
    prompt = torch.as_tensor(_prompt())

    def run():
        gen = torch.Generator().manual_seed(5)
        return tspec.speculative_generate(params, dparams, prompt, TCFG,
                                          TDCFG, max_new_tokens=9, k=2,
                                          generator=gen, **SAMPLING)

    assert torch.equal(run(), run())


# ------------------------------------------------------------ batcher

class _AcceptLog:
    """A duck-typed metrics hub that keeps every ``spec_accept_ratio``
    sample in order: one per running slot per round."""

    def __init__(self):
        self.samples = []

    def observe(self, name, value, labels=None, buckets=None):
        if name == "spec_accept_ratio":
            self.samples.append(value)

    def set_gauge(self, name, value, labels=None):
        pass


def _requests(n=5, seed=11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 20, size=n)
    news = rng.integers(4, 12, size=n)
    return [(rng.integers(0, JCFG.vocab_size, size=int(t)).astype(np.int32),
             int(m)) for t, m in zip(lens, news)]


def _drive(srv, reqs):
    """Two requests up front, then one more per step."""
    pending = list(reqs)
    rids, out = [], {}
    for _ in range(2):
        p, m = pending.pop(0)
        rids.append(srv.submit(p, m))
    steps = 0
    while not srv.idle or pending:
        srv.step()
        out.update(srv.poll())
        if pending:
            p, m = pending.pop(0)
            rids.append(srv.submit(p, m))
        steps += 1
        assert steps < 300, "server did not converge"
    out.update(srv.poll())
    return [out[r] for r in rids]


@pytest.mark.parametrize("draft", ["self-int8", "other"])
def test_draft_batcher_token_identical_round_by_round(weights, draft):
    """The draft batcher's tokens equal the plain batcher's and JAX's
    draft batcher's, and every round accepts as many drafts per slot as
    JAX's does (the same ratio samples in the same order)."""
    tree, params, dtree, dparams = weights
    reqs = _requests()
    kw = dict(max_slots=2, capacity_per_slot=40, block_size=8,
              shared_prefix=PREFIX, spec_k=3)
    jdraft = draft if draft == "self-int8" else (dtree, JDCFG, None)
    tdraft = draft if draft == "self-int8" else (dparams, TDCFG, None)
    jlog, tlog = _AcceptLog(), _AcceptLog()
    ref = _drive(JBatcher(tree, JCFG, metrics=jlog, draft=jdraft, **kw),
                 reqs)
    srv = ContinuousBatcher(params, TCFG, metrics=tlog, draft=tdraft, **kw)
    got = _drive(srv, reqs)
    kw.pop("spec_k")
    plain = _drive(ContinuousBatcher(params, TCFG, **kw), reqs)
    for (p, m), r, g, q in zip(reqs, ref, got, plain):
        assert len(g) == len(p) + m
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, q)
    assert srv.spec_rounds > 0 and tlog.samples == jlog.samples
    assert srv.spec_accepted == round(3 * sum(tlog.samples))
    if draft == "other":
        assert 0 < srv.spec_accepted < 3 * len(tlog.samples)


def test_draft_batcher_metrics(weights):
    _, params, _, _ = weights
    hub = MetricsHub()
    srv = ContinuousBatcher(params, TCFG, max_slots=2, capacity_per_slot=32,
                            block_size=8, metrics=hub, draft="self-int8",
                            spec_k=2)
    _drive(srv, _requests(3, seed=4))
    text = hub.render()
    assert "tpu_workload_spec_accept_ratio_bucket" in text
    assert hub.gauge("weight_stream_gbs") > 0
    assert srv._draft_stream_bytes < srv._stream_bytes


def test_draft_batcher_slot_filled_to_its_last_row(weights):
    """A request whose prompt and tokens fill its slot to capacity: near
    the end the (k+1)-wide round no longer fits its table row, the step
    runs plain ticks, and the tokens do not change (held against the
    plain batcher and JAX's draft batcher). A second slot runs beside
    it, and the slot reaches capacity - 1 before it retires."""
    tree, params, _, _ = weights
    cap, k = 24, 3
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, JCFG.vocab_size, size=10).astype(np.int32),
             cap - 10),
            (rng.integers(0, JCFG.vocab_size, size=4).astype(np.int32), 9)]
    kw = dict(max_slots=2, capacity_per_slot=cap, block_size=8)
    srv = ContinuousBatcher(params, TCFG, draft="self-int8", spec_k=k, **kw)
    seen = []
    real_step = srv.step

    def step(n=1):
        real_step(n)
        seen.extend(int(srv._lengths[r.slot])
                    for r in srv._running.values())

    srv.step = step
    got = _drive(srv, reqs)
    ref = _drive(JBatcher(tree, JCFG, draft="self-int8", spec_k=k, **kw),
                 reqs)
    plain = _drive(ContinuousBatcher(params, TCFG, **kw), reqs)
    for g, r, q in zip(got, ref, plain):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, q)
    assert len(got[0]) == cap
    assert cap - 1 in seen
    assert srv.spec_rounds > 0 and srv.decode_steps > 0


@pytest.mark.parametrize("spec_k", [0, -1])
def test_draft_batcher_refuses_spec_k_below_one(weights, spec_k):
    _, params, _, _ = weights
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatcher(params, TCFG, max_slots=2, capacity_per_slot=16,
                          block_size=8, draft="self-int8", spec_k=spec_k)


def _run_to_end(srv, rid):
    out = {}
    while rid not in out:
        srv.step()
        out.update(srv.poll())
    return out[rid]


@pytest.mark.parametrize("donor,peer", [("torch", "torch"),
                                        ("torch", "jax"), ("jax", "torch")])
def test_draft_batcher_migration_finishes_identically(weights, donor, peer):
    """Export from a draft batcher after two rounds, adopt into a peer
    draft batcher (either package): the draft pools stay behind, the
    peer's draft starts cold for the slot, and the tokens equal the
    peer's own undisturbed run."""
    tree, params, _, _ = weights
    prompt, max_new = _requests(1, seed=13)[0][0], 15
    kw = dict(max_slots=2, capacity_per_slot=40, block_size=8,
              shared_prefix=PREFIX, draft="self-int8", spec_k=3)

    def make(kind):
        return (JBatcher(tree, JCFG, **kw) if kind == "jax"
                else ContinuousBatcher(params, TCFG, **kw))

    src, dst = make(donor), make(peer)
    expected = _run_to_end(dst, dst.submit(prompt, max_new))
    rid = src.submit(prompt, max_new)
    src.step()
    src.step()
    payload = src.export_slot(rid)
    assert 2 <= len(payload["generated"]) < max_new
    encode = jpaged.encode_kv_payload if donor == "jax" else \
        tpaged.encode_kv_payload
    decode = jpaged.decode_kv_payload if peer == "jax" else \
        tpaged.decode_kv_payload
    payload["kv"] = encode(payload["kv"])
    wire = json.loads(json.dumps(payload))
    wire["kv"] = decode(wire["kv"])
    assert set(wire["kv"]) >= {"k", "v"} and "dk" not in wire["kv"]
    np.testing.assert_array_equal(_run_to_end(dst, dst.adopt_slot(wire)),
                                  expected)
