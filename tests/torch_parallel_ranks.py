"""Rank bodies of the port's multi-process tests
(``test_torch_distributed.py``, ``test_torch_ring.py``,
``test_torch_fsdp_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_composed.py``, ``test_torch_expert.py``,
``test_torch_elastic.py``, ``test_torch_gpu.py``,
``test_torch_tp_generate.py``), run by ``parallel/launch.py``.

A spawned rank re-imports the module its function lives in, so this one
imports torch, numpy and the port only: no JAX, no conftest. Every
function takes numpy inputs, runs on the CPU over the gloo group the
launcher joined, and returns numpy results.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from torch.utils._python_dispatch import TorchDispatchMode

from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.models import moe as tmoe
from k8s_operator_libs_tpu_torch.ops import attention as tattn
from k8s_operator_libs_tpu_torch.parallel import comm, composed, expert
from k8s_operator_libs_tpu_torch.parallel import fsdp as tfsdp
from k8s_operator_libs_tpu_torch.parallel import long_context, pipeline
from k8s_operator_libs_tpu_torch.parallel.mesh import (AXES, Mesh,
                                                       coordinates,
                                                       make_mesh, mesh_shape,
                                                       shard)
from k8s_operator_libs_tpu_torch.parallel.ring_attention import ring_attention
from k8s_operator_libs_tpu_torch.parallel.ulysses import ulysses_attention


def _setup():
    torch.set_num_threads(1)
    return dist.get_rank(), dist.get_world_size()


def _np(tree):
    return convert.to_numpy(tree)


def _cfg(**kw):
    return tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def attention(cases, q, k, v, dout):
    """For each (impl, causal): this rank's chunk of the output and of
    dq, dk, dv for the cotangent ``dout``, and the flash calls it made
    (plain versions on the CPU)."""
    rank, n = _setup()
    mesh = make_mesh(seq=n, fsdp=1)
    group = mesh.groups["seq"]
    Tl = q.shape[1] // n
    chunk = slice(rank * Tl, (rank + 1) * Tl)
    out = {}
    for impl, causal in cases:
        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
        qc, kc, vc = (torch.tensor(x[:, chunk]).requires_grad_()
                      for x in (q, k, v))
        tattn.reset_launch_counts()
        o = fn(qc, kc, vc, group, causal=causal)
        o.backward(torch.tensor(dout[:, chunk]))
        out[(impl, causal)] = {
            "out": o.detach().numpy(), "dq": qc.grad.numpy(),
            "dk": kc.grad.numpy(), "dv": vc.grad.numpy(),
            "calls": dict(tattn.PLAIN_CALLS)}
    return out


def sp_loss(impls, tree, tokens):
    """For each attention impl: the SP loss and every gradient of it."""
    _setup()
    n = dist.get_world_size()
    mesh = make_mesh(seq=n, fsdp=1)
    params = convert.to_torch(tree, device="cpu")
    out = {}
    for impl in impls:
        loss_fn = long_context.make_sp_loss(_cfg(), mesh, attn_impl=impl)
        loss, grads = tfsdp.value_and_grad(loss_fn, params,
                                           torch.tensor(tokens))
        out[impl] = {"loss": float(loss), "grads": _np(grads)}
    return out


def attention_and_sp_loss(cases, q, k, v, dout, impls, tree, tokens):
    """:func:`attention` and :func:`sp_loss` in one group."""
    return (attention(cases, q, k, v, dout),
            sp_loss(impls, tree, tokens))


def _whole(tree, specs, mesh):
    """Every leaf gathered whole over the axes its spec splits."""
    return tfsdp._tree_map(lambda x, s: tfsdp.full_leaf(x, s, mesh), tree,
                           specs)


def _full_state(state, mesh, specs=None):
    specs = specs or tfsdp.param_specs()
    whole = lambda t: _whole(t, specs, mesh)  # noqa: E731
    opt = state.opt_state
    return {"params": _np(whole(state.params)), "mu": _np(whole(opt.mu)),
            "nu": _np(whole(opt.nu)), "count": opt.count}


def fsdp_steps(tree, batches, lr, grad_accum=1, remat=False,
               planted=None):
    """FSDP over every rank from the one-rank parameters ``tree`` (zero
    moments): the metrics of each step on the global ``batches``, the
    whole state after each step (gathered), and this rank's leaf shapes.
    ``planted="local_norm"`` clips by the shard-local norm instead (a
    planted fault the tests must catch)."""
    rank, n = _setup()
    mesh = make_mesh()
    specs = tfsdp.param_specs()
    params = tfsdp._tree_map(
        lambda x, s: tfsdp.shard(x, s, mesh),
        convert.to_torch(tree, device="cpu"), specs)
    opt = tfsdp.default_optimizer(lr)
    state = tfsdp.TrainState(params=params, opt_state=opt.init(params),
                             step=0)
    real_norm = tfsdp.sharded_global_norm
    if planted == "local_norm":
        tfsdp.sharded_global_norm = lambda mesh, specs: tfsdp.global_norm
    try:
        step = tfsdp.make_train_step(_cfg(remat=remat), opt, grad_accum,
                                     mesh=mesh)
    finally:
        tfsdp.sharded_global_norm = real_norm
    metrics, states = [], []
    for b in batches:
        state, m = step(state, torch.tensor(b))
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "step": m["step"]})
        states.append(_full_state(state, mesh))
    shapes = {k: tuple(v.shape) for k, v in
              [("embed", state.params["embed"]),
               ("wo", state.params["blocks"]["wo"]),
               ("attn_norm", state.params["blocks"]["attn_norm"])]}
    return {"metrics": metrics, "states": states, "shapes": shapes}


def fsdp_group(tree, batches, lr, remat, accum_batch, seed):
    """In one group: 3 FSDP steps, one step with grad_accum 2 (when
    ``accum_batch`` is given), one with the planted shard-local norm, and
    the sharded init."""
    return {"steps": fsdp_steps(tree, batches, lr, remat=remat),
            "accum": (None if accum_batch is None else
                      fsdp_steps(tree, [accum_batch], lr, grad_accum=2,
                                 remat=remat)),
            "planted": fsdp_steps(tree, batches[:1], lr,
                                  planted="local_norm"),
            "init": fsdp_init(seed)}


def fsdp_init(seed):
    """This rank's state from ``init_train_state(mesh=...)``, gathered
    whole, and the elements it holds."""
    _setup()
    mesh = make_mesh()
    state = tfsdp.init_train_state(_cfg(), seed, device="cpu", mesh=mesh)
    held = sum(x.numel() for x in tllama.param_leaves(state.params))
    moments = sum(x.numel() for x in tllama.param_leaves(state.opt_state.mu))
    return {"full": _full_state(state, mesh), "held": held,
            "moments": moments}


def collectives(xs, ws):
    """Each of comm's collectives on this rank's ``xs[kind][rank]``: its
    result and the gradient of ``sum(result * ws[kind][rank])``; and the
    bytes counted."""
    rank, n = _setup()
    group = dist.group.WORLD
    fns = {
        "ppermute": lambda x: comm.ppermute(
            x, group, [(i, (i + 1) % n) for i in range(n)]),
        "all_gather": lambda x: comm.all_gather(x, group, 0),
        "reduce_scatter": lambda x: comm.reduce_scatter(x, group, 0),
        "all_to_all": lambda x: comm.all_to_all(x, group, 0, 1),
        "psum": lambda x: comm.psum(x, group),
        "replicate": lambda x: comm.replicate(x, group),
        "pmean": lambda x: comm.pmean(x, (group, None)),
    }
    comm.reset_counts()
    out = {}
    for kind, fn in fns.items():
        x = torch.tensor(xs[kind][rank]).requires_grad_()
        y = fn(x)
        (y * torch.tensor(ws[kind][rank])).sum().backward()
        out[kind] = (y.detach().numpy(), x.grad.numpy())
    x = torch.tensor(xs["pmax"][rank]).requires_grad_()
    y = comm.pmax(x, group)
    out["pmax"] = (y.numpy(), y.requires_grad)
    out["bytes"] = dict(comm.BYTES)
    return out


def cli(argv, drain_at=None):
    """``train.main(argv)`` in this rank, drained before step ``drain_at``
    on rank 0 only (the others must follow). Returns rank 0's output."""
    import contextlib
    import io

    from k8s_operator_libs_tpu_torch import train
    rank, _ = _setup()
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return rank == 0 and drain_at is not None and calls["n"] == drain_at

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, drain_signal=drain)
    return {"rc": rc, "out": buf.getvalue()}


def cli_held(argv):
    """:func:`cli` recording the elements of parameters and of first
    moments this rank's trainer holds when its run starts."""
    from k8s_operator_libs_tpu_torch.train import harness
    held = {}
    real = harness.CheckpointingTrainer.run

    def run(self, state, *args, **kwargs):
        held["params"] = sum(x.numel()
                             for x in tllama.param_leaves(state.params))
        held["moments"] = sum(x.numel() for x in
                              tllama.param_leaves(state.opt_state.mu))
        return real(self, state, *args, **kwargs)

    harness.CheckpointingTrainer.run = run
    try:
        return {**cli(argv), **held}
    finally:
        harness.CheckpointingTrainer.run = real


def cli_slow_writer(runs, delay):
    """:func:`cli` for each (argv, drain_at) in turn, with each of rank
    0's checkpoint writes held back ``delay`` seconds (a slow disk)."""
    import time

    from k8s_operator_libs_tpu_torch.train import harness
    real = harness.torch.save

    def slow(*args, **kwargs):
        time.sleep(delay)
        return real(*args, **kwargs)

    if dist.get_rank() == 0:
        harness.torch.save = slow
    try:
        return [cli(argv, drain_at) for argv, drain_at in runs]
    finally:
        harness.torch.save = real


def hang():
    """Rank 0 waits in a collective that rank 1 does not join for ten
    minutes."""
    import time
    rank, _ = _setup()
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(600)
    return rank


def fail():
    rank, _ = _setup()
    if rank == 1:
        raise ValueError("rank 1 planted failure")
    dist.barrier()
    return rank



# ------------------------------------------------- pipeline, 3-D, experts

def fake_mesh(**sizes):
    """Rank 0's view of a mesh of these sizes with no process group (each
    collective the identity): enough for the shape checks a loss makes
    when it is built."""
    world = 1
    for n in sizes.values():
        world *= n
    shape = mesh_shape(world, **sizes)
    return Mesh(shape=shape, rank=0, coords=coordinates(shape, 0),
                groups={a: None for a in AXES})


class VocabWatch(TorchDispatchMode):
    """Records the shape of every tensor an op returns whose last dim is
    the whole vocabulary (the [*, V] logits a vocab-sharded loss must
    never make)."""

    def __init__(self, vocab):
        super().__init__()
        self.vocab, self.hits = vocab, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[-1] == self.vocab):
                self.hits.append((str(func), tuple(t.shape)))
        return out


def _local(tree, specs, mesh):
    """This rank's slices of the one-rank ``tree``."""
    return tfsdp._tree_map(lambda x, s: shard(x, s, mesh),
                           convert.to_torch(tree, device="cpu"), specs)


def _loss_grads(loss_fn, params, tokens, specs, mesh, vocab=None):
    """The loss, every gradient gathered whole, the plain flash calls and
    (``vocab``) the ops that made a full-vocab tensor."""
    tattn.reset_launch_counts()
    watch = VocabWatch(vocab) if vocab else None
    if watch is not None:
        with watch:
            loss, grads = tfsdp.value_and_grad(loss_fn, params,
                                               torch.tensor(tokens))
    else:
        loss, grads = tfsdp.value_and_grad(loss_fn, params,
                                           torch.tensor(tokens))
    return {"loss": float(loss), "grads": _np(_whole(grads, specs, mesh)),
            "calls": dict(tattn.PLAIN_CALLS),
            "full_vocab": None if watch is None else watch.hits}


def _steps(step, params, batches, specs, mesh, lr):
    """Optimizer steps from ``params`` and zero moments: each step's
    metrics and the whole state after it."""
    opt = tfsdp.default_optimizer(lr)
    state = tfsdp.TrainState(params=params, opt_state=opt.init(params),
                             step=0)
    metrics, states = [], []
    for b in batches:
        state, m = step(state, torch.tensor(b))
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "step": m["step"]})
        states.append(_full_state(state, mesh, specs))
    return {"metrics": metrics, "states": states}


def _planted(module, name, fn, run):
    """``run()`` with ``module.name`` replaced by ``fn``."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        return run()
    finally:
        setattr(module, name, real)


def pp_group(tree, tokens, cases, batches, lr):
    """Pipeline over every rank (stage = world): for each (M, remat) the
    loss and whole gradients (and any full-vocab tensor made); the same
    with the head's replicate planted away; 3 steps at M 4."""
    _setup()
    mesh = make_mesh(stage=dist.get_world_size(), fsdp=1)
    specs = pipeline.pp_param_specs()
    out = {}
    for M, remat in cases:
        cfg = _cfg(remat=remat)
        out[(M, remat)] = _loss_grads(
            pipeline.make_pp_loss(cfg, mesh, M),
            _local(tree, specs, mesh), tokens, specs, mesh,
            vocab=cfg.vocab_size)
    out["planted"] = _planted(
        pipeline, "head_input", lambda h, group: h,
        lambda: _loss_grads(pipeline.make_pp_loss(_cfg(), mesh, 2),
                            _local(tree, specs, mesh), tokens, specs, mesh))
    out["steps"] = _steps(
        pipeline.make_pp_train_step(_cfg(), mesh, 4,
                                    tfsdp.default_optimizer(lr)),
        _local(tree, specs, mesh), batches, specs, mesh, lr)
    out["init"] = _np(_whole(pipeline.init_pp_state(
        _cfg(), 3, mesh, device="cpu").params, specs, mesh))
    return out


def composed_group(tree, tokens, mesh_sizes, cases, batches, lr,
                   plant=False, ckpt_dir=None):
    """The composed Llama loss on a ``mesh_sizes`` mesh: for each (M,
    remat) the loss and whole gradients; with ``plant``, the same with
    the column-parallel input's replicate planted away; 3 steps at M 2
    (``batches``); with ``ckpt_dir``, a checkpointed run resumed."""
    _setup()
    mesh = make_mesh(**mesh_sizes)
    specs = composed.composed_param_specs()
    out = {}
    for M, remat in cases:
        cfg = _cfg(remat=remat)
        out[(M, remat)] = _loss_grads(
            composed.make_composed_loss(cfg, mesh, M),
            _local(tree, specs, mesh), tokens, specs, mesh,
            vocab=cfg.vocab_size)
    if plant:
        out["planted"] = _planted(
            composed, "column_input", lambda h, group: h,
            lambda: _loss_grads(composed.make_composed_loss(_cfg(), mesh, 2),
                                _local(tree, specs, mesh), tokens, specs,
                                mesh))
    if batches:
        out["steps"] = _steps(
            composed.make_composed_train_step(_cfg(), mesh, 2,
                                              tfsdp.default_optimizer(lr)),
            _local(tree, specs, mesh), batches, specs, mesh, lr)
    if ckpt_dir:
        out["resume"] = _composed_resume(mesh, specs, tokens, ckpt_dir)
    return out


def _composed_resume(mesh, specs, tokens, ckpt_dir):
    """3 steps checkpointed at 2 (rank 0 writes whole tensors), then a new
    trainer restores step 2 onto the mesh and takes step 3 again: its
    loss and the restored state against the uninterrupted run's."""
    from k8s_operator_libs_tpu_torch.train.harness import (
        CheckpointingTrainer)
    cfg = _cfg()
    opt = tfsdp.default_optimizer()
    step = composed.make_composed_train_step(cfg, mesh, 2, opt)

    def trainer():
        return CheckpointingTrainer(
            cfg, ckpt_dir, optimizer=opt, checkpoint_interval=2,
            device="cpu", step_fn=step, mesh=mesh, specs=specs,
            init_fn=lambda seed: composed.init_composed_state(
                cfg, seed, mesh, opt, device="cpu"))

    t1 = trainer()
    losses, at2 = [], None
    state = t1.init_or_resume(0)
    for _ in range(3):
        state, m = step(state, torch.tensor(tokens))
        losses.append(float(m["loss"]))
        if state.step == 2:
            t1.save(state, wait=True)
            at2 = _full_state(state, mesh, specs)
    t1.close()
    t2 = trainer()
    state = t2.init_or_resume(0)
    restored = _full_state(state, mesh, specs)
    _, m = step(state, torch.tensor(tokens))
    t2.close()
    return {"losses": losses, "resumed_loss": float(m["loss"]),
            "at2": at2, "restored": restored, "step": 2}


def _moe_cfg(**kw):
    return tmoe.MoEConfig.tiny(dtype=torch.float32, **kw)


def moe_composed_group(tree, tokens, mesh_sizes, coefs, batches, lr,
                       cli_argv=None):
    """The composed MoE loss for each router aux coefficient: the loss
    and whole gradients; 3 steps; then, with ``cli_argv``, ``train.main``
    drained before step 4 on rank 0 (:func:`cli`)."""
    _setup()
    mesh = make_mesh(**mesh_sizes)
    specs = composed.moe_composed_param_specs()
    out = {}
    for coef in coefs:
        out[coef] = _loss_grads(
            composed.make_moe_composed_loss(
                _moe_cfg(router_aux_coef=coef), mesh, 2),
            _local(tree, specs, mesh), tokens, specs, mesh)
    out["steps"] = _steps(
        composed.make_moe_composed_train_step(_moe_cfg(), mesh, 2,
                                              tfsdp.default_optimizer(lr)),
        _local(tree, specs, mesh), batches, specs, mesh, lr)
    if cli_argv is not None:
        out["cli"] = cli(cli_argv, 4)
    return out


def ep_group(tree, tokens, cases, batches, lr, layer_case=None,
             cli_runs=()):
    """Expert parallelism over every rank (tensor = world). ``cases``:
    (dispatch, capacity factor or None, aux coef, remat); each gives the
    loss, the whole gradients and, for a2a, every layer's kept (token,
    expert) mask on this rank's rows; then the dense loss with the
    router's replicate planted away, 3 dense and 3 a2a steps,
    ``moe_ffn_a2a`` alone on ``layer_case``, and :func:`cli` for each
    (argv, drain_at) of ``cli_runs`` in turn."""
    rank, n = _setup()
    mesh = make_mesh(tensor=n, fsdp=1)
    specs = expert.ep_param_specs()
    out = {}
    for dispatch, cf, coef, remat in cases:
        cfg = _moe_cfg(router_aux_coef=coef, remat=remat)
        record = []
        loss_fn = (expert.make_ep_loss(cfg, mesh) if dispatch == "dense"
                   else expert.make_ep_a2a_loss(cfg, mesh, cf, record))
        res = _loss_grads(loss_fn, _local(tree, specs, mesh), tokens,
                          specs, mesh)
        res["routed"] = [m.numpy() for m, _ in record]
        res["kept"] = [k.numpy() for _, k in record]
        out[(dispatch, cf, coef, remat)] = res
    out["planted"] = _planted(
        tmoe, "_local_experts",
        lambda t, start, count, group: t.narrow(-1, start, count),
        lambda: _loss_grads(expert.make_ep_loss(_moe_cfg(), mesh),
                            _local(tree, specs, mesh), tokens, specs, mesh))
    for dispatch in ("dense", "a2a"):
        out[("steps", dispatch)] = _steps(
            expert.make_ep_train_step(_moe_cfg(), mesh,
                                      tfsdp.default_optimizer(lr),
                                      dispatch=dispatch),
            _local(tree, specs, mesh), batches, specs, mesh, lr)
    if layer_case is not None:
        h, layer, cap = layer_case
        Bl = h.shape[0] // n
        local = {k: (torch.tensor(v).chunk(n)[rank]
                     if k.startswith("w_") else torch.tensor(v))
                 for k, v in layer.items()}
        record = []
        y, aux = tmoe.moe_ffn_a2a(
            torch.tensor(h[rank * Bl:(rank + 1) * Bl]), local, _moe_cfg(),
            mesh.groups["tensor"], cap, record)
        out["layer"] = {"y": y.numpy(), "aux": float(aux),
                        "kept": record[0][1].numpy()}
    out["cli"] = [cli(argv, drain_at) for argv, drain_at in cli_runs]
    return out


# ------------------------------------------------------------- elastic

ELASTIC_SEQ = 16          # tokens per row the elastic runs train on

def reform_member(shrink_to, grow_to):
    """The members of each generation as every rank of it sees them (an
    all-gather of names) and an all-reduce over it: the launch's group,
    then the group re-formed over ``shrink_to``, then over ``grow_to``
    (which adds joiners: :func:`reform_joiner`)."""
    from k8s_operator_libs_tpu_torch.parallel import launch
    _setup()
    m = launch.membership()
    seen = [_generation_view(m)]
    for members in (shrink_to, grow_to):
        m = m.reform(members)
        if m is None:
            return {"left_at": len(seen), "seen": seen}
        seen.append(_generation_view(m))
    return {"left_at": None, "seen": seen}


def reform_joiner():
    from k8s_operator_libs_tpu_torch.parallel import launch
    _setup()
    return {"left_at": None, "seen": [_generation_view(launch.membership())]}


def _generation_view(m):
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, m.me)
    total = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(total)
    return {"generation": m.generation, "rank": dist.get_rank(),
            "names": names, "sum": float(total), "init": m.init_method()}


def _elastic_trainer(tree, ckpt, lr, ledger=True):
    """An elastic FSDP trainer of the tiny fp32 Llama over the launched
    group, its state initialized from ``tree`` (the JAX parameters),
    every rank holding the ledger beside the checkpoints."""
    from k8s_operator_libs_tpu_torch.obs.goodput import GoodputLedger
    from k8s_operator_libs_tpu_torch.parallel import launch
    from k8s_operator_libs_tpu_torch.train.harness import CheckpointingTrainer
    opt = tfsdp.default_optimizer(lr)

    def init_factory(mesh):
        return lambda seed: tfsdp.init_train_state(
            _cfg(), seed, opt, "cpu", mesh,
            params_init=lambda cfg, seed, device: convert.to_torch(
                tree, device=device))

    mesh = make_mesh()
    book = GoodputLedger.for_checkpoint_dir(ckpt) if ledger else None
    trainer = CheckpointingTrainer(
        _cfg(), ckpt, optimizer=opt, device="cpu", mesh=mesh,
        checkpoint_interval=100, ledger=book, metrics_sync_every=2,
        elastic=True, membership=launch.membership(),
        init_fn=init_factory(mesh), init_factory=init_factory)
    return trainer, book


def _elastic_run(trainer, data, batch, seed, steps, reclaim=None,
                 grow=None, plant=None):
    """``trainer.run`` to step ``steps`` on the native token stream from
    the state's step; rank 0's notices as ``reclaim`` / ``grow`` plan
    them ((generation, step, members): after that step, in that
    generation of the group, so that a new rank 0 does not repeat one;
    or None); ``plant`` wraps the
    trainer's restore after the first. The losses by step, the result
    and, on rank 0 of the last group, the whole parameters (gathered,
    every rank still in the group joining)."""
    from k8s_operator_libs_tpu_torch.data.loader import TokenDataset
    from k8s_operator_libs_tpu_torch.parallel.fsdp import _tree_map, full_leaf
    from k8s_operator_libs_tpu_torch.train.harness import (GrowNotice,
                                                           ReclaimNotice)
    from k8s_operator_libs_tpu_torch.parallel.mesh import param_specs
    state = trainer.init_or_resume(0)
    start = int(state.step)
    if plant is not None:
        trainer._restore = plant(trainer._restore)
    losses = {}

    def notice(plan, make):
        if plan is None or trainer.membership.generation != plan[0]:
            return None
        if max(losses, default=start) == plan[1]:
            return make(plan[2])
        return None

    ds = TokenDataset(data, native=True)
    try:
        result = trainer.run(
            state, ds.batches(batch, ELASTIC_SEQ + 1, seed=seed,
                              start_step=start),
            steps - start,
            on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])),
            reclaim_signal=lambda: notice(reclaim, ReclaimNotice),
            grow_signal=lambda: notice(grow, GrowNotice))
    finally:
        ds.close()
        trainer.close()
    out = {"start": start, "losses": losses, "reshards": result.reshards,
           "device_count": result.device_count,
           "preempted": result.preempted, "reclaimed": result.reclaimed,
           "steps_done": result.steps_done,
           "writer": trainer._writer_rank,
           "generation": (trainer.membership.generation
                          if trainer.membership else None)}
    if not result.reclaimed:
        whole = _tree_map(lambda t, s: full_leaf(t, s, trainer.mesh),
                          result.state.params, param_specs())
        out["params"] = _np(whole) if trainer._writer_rank else None
    return out


def elastic_member(tree, data, ckpt, lr, batch, seed, steps, reclaim,
                   grow):
    """A rank of the job from its start: shrinks and grows as rank 0's
    notices say."""
    _setup()
    trainer, book = _elastic_trainer(tree, ckpt, lr)
    try:
        return _elastic_run(trainer, data, batch, seed, steps, reclaim,
                            grow)
    finally:
        book.close()


def elastic_joiner(tree, data, ckpt, lr, batch, seed, steps):
    """A rank a grow added: restores the grow's save and trains the
    steps left on the stream from there."""
    _setup()
    trainer, book = _elastic_trainer(tree, ckpt, lr)
    try:
        return _elastic_run(trainer, data, batch, seed, steps)
    finally:
        book.close()


def elastic_cold(tree, data, ckpt, lr, batch, seed, steps, plant):
    """A cold start from the latest checkpoint to step ``steps``; with
    ``plant``, then a resize (a reclaim that keeps every member) whose
    restore re-initializes both moments, from the same checkpoint."""
    _setup()
    trainer, _ = _elastic_trainer(tree, ckpt, lr, ledger=False)
    out = {"cold": _elastic_run(trainer, data, batch, seed, steps)}
    if plant:
        from k8s_operator_libs_tpu_torch.parallel import launch
        trainer, _ = _elastic_trainer(tree, ckpt, lr, ledger=False)

        def moments_reset(real):
            def restore(step):
                s = real(step)
                for m in (s.opt_state.mu, s.opt_state.nu):
                    for leaf in tllama.param_leaves(m):
                        leaf.zero_()
                return s
            return restore

        out["planted"] = _elastic_run(
            trainer, data, batch, seed, steps, plant=moments_reset,
            reclaim=(0, out["cold"]["start"],
                     list(launch.membership().members)))
    return out


def reform_onto_a_taken_port():
    """Generation 0 over the launch's TCP store, then a re-formation over
    the same members while another socket holds generation 1's port (the
    job's + 1, on rank 0's host): every rank must raise, none wait."""
    import socket

    from k8s_operator_libs_tpu_torch.parallel import launch
    from k8s_operator_libs_tpu_torch.parallel.distributed import (
        RendezvousPortTaken)
    rank, _ = _setup()
    m = launch.membership()
    port = int(m.init_method().rsplit(":", 1)[1]) + 1
    with socket.socket() as squatter:
        if rank == 0:
            squatter.bind(("localhost", port))
            squatter.listen()
        dist.barrier()
        try:
            m.reform(m.members)
        except RendezvousPortTaken as exc:
            return {"raised": str(exc), "left": not dist.is_initialized()}
    return {"raised": None, "left": not dist.is_initialized()}


# ------------------------------------------ placed by the GPU scheduler

def placed_member():
    """A rank started from a placed pod's env: its rank and world, and an
    all-reduce of every rank's number."""
    rank, world = _setup()
    total = torch.tensor([float(rank)])
    dist.all_reduce(total)
    return {"rank": rank, "world": world, "sum": float(total)}


# --------------------------------------------- tensor-parallel decoding

def tp_generate(tree, prompt, max_new):
    """Greedy tensor-parallel decode of ``prompt`` on this rank's slices
    of ``tree`` (fp32 tiny Llama), the mesh's tensor axis over every
    rank: the tokens, the KV cache's shape and the sums' calls and
    bytes."""
    from k8s_operator_libs_tpu_torch.models import generate as tgen
    from k8s_operator_libs_tpu_torch.parallel.fsdp import _tree_map
    _, world = _setup()
    cfg = _cfg()
    mesh = make_mesh(tensor=world, fsdp=1)
    params = _tree_map(lambda x, spec: shard(x, spec, mesh),
                       convert.to_torch(tree, device="cpu"),
                       tgen.tp_generate_param_specs())
    caches = []
    real = tgen.init_cache

    def init_cache(*args, **kwargs):
        caches.append(real(*args, **kwargs))
        return caches[-1]

    tgen.init_cache = init_cache
    comm.reset_counts()
    try:
        out = tgen.make_tp_generate(cfg, mesh, max_new_tokens=max_new)(
            params, torch.as_tensor(prompt))
    finally:
        tgen.init_cache = real
    return {"tokens": out.numpy(), "cache_shape": tuple(caches[0].k.shape),
            "psum_calls": comm.CALLS["psum"],
            "psum_bytes": comm.BYTES["psum"]}
