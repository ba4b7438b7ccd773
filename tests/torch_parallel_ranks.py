"""Rank bodies of the port's multi-process tests
(``test_torch_distributed.py``, ``test_torch_ring.py``,
``test_torch_fsdp_parallel.py``), run by ``parallel/launch.py``.

A spawned rank re-imports the module its function lives in, so this one
imports torch, numpy and the port only: no JAX, no conftest. Every
function takes numpy inputs, runs on the CPU over the gloo group the
launcher joined, and returns numpy results.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from k8s_operator_libs_tpu_torch import convert
from k8s_operator_libs_tpu_torch.models import llama as tllama
from k8s_operator_libs_tpu_torch.ops import attention as tattn
from k8s_operator_libs_tpu_torch.parallel import comm
from k8s_operator_libs_tpu_torch.parallel import fsdp as tfsdp
from k8s_operator_libs_tpu_torch.parallel import long_context
from k8s_operator_libs_tpu_torch.parallel.mesh import make_mesh
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


def _full_state(state, mesh):
    specs = tfsdp.param_specs()
    whole = lambda t: tfsdp._tree_map(  # noqa: E731
        lambda x, s: tfsdp.full_leaf(x, s, mesh), t, specs)
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
    }
    comm.reset_counts()
    out = {}
    for kind, fn in fns.items():
        x = torch.tensor(xs[kind][rank]).requires_grad_()
        y = fn(x)
        (y * torch.tensor(ws[kind][rank])).sum().backward()
        out[kind] = (y.detach().numpy(), x.grad.numpy())
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

