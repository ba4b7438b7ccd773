"""Collectives over a process group, differentiable: what ``shard_map``
and XLA's SPMD partitioner insert in the reference.

The reference writes its parallel code as per-device bodies under
``jax.shard_map`` (``lax.ppermute``, ``lax.all_to_all``, ``lax.psum``)
or lets XLA insert all-gathers and reduce-scatters from sharding
annotations, and JAX derives each collective's transpose. Here each one
is a ``torch.autograd.Function`` over a ``torch.distributed`` process
group, with the transpose written out:

=====================  ==========================  =======================
function               forward                     backward
=====================  ==========================  =======================
:func:`ppermute`       send to the pair's dst      the inverse permutation
:func:`all_to_all`     tiled, split -> concat      all_to_all concat -> split
:func:`psum`           sum over the group          identity (the cotangent
                                                   is the same on every
                                                   rank: one loss)
:func:`replicate`      identity                    psum (a replicated input's
                                                   gradient sums the ranks')
:func:`all_gather`     concatenate the shards      reduce_scatter
:func:`reduce_scatter` sum, keep this rank's part  all_gather
:func:`tie`            ``x`` (the others unused)   zeros for the others
:func:`pmean`          the mean over several       g / n (psum's, scaled)
                       groups
:func:`pmax`           the max over the group      none (not differentiable:
                                                   the reference's
                                                   ``pmax(stop_gradient)``)
=====================  ==========================  =======================

A group of None (an axis of size 1 inside a larger world) makes each of
them the identity. Every rank of a group must call the same collectives
in the same order, forward and backward, as every device runs the same
program under ``shard_map``. :func:`tie` keeps that true where a rank's
data leave a received tensor unused (a causal ring's masked chunk): it
puts the tensor in the graph with a zero cotangent, so every rank runs
its transpose.

Backends. NCCL takes CUDA tensors directly. gloo takes CPU tensors; a
CUDA tensor on a gloo group (several ranks sharing one card, where NCCL
refuses two ranks on one device) is staged through host memory and the
result copied back. :func:`reduce_scatter` is an all-to-all followed by
an fp32 sum over the ranks in rank order, the same bits on both backends.

:data:`BYTES` counts, per kind, the bytes this rank sends for each call
under the usual ring algorithms: all-gather (n - 1) shards, reduce-scatter
and all-to-all (n - 1)/n of the input, all-reduce 2 (n - 1)/n of it, a
ppermute the tensor when its destination is another rank. A group of one
rank sends nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BYTES = {"ppermute": 0, "all_to_all": 0, "psum": 0, "all_gather": 0,
         "reduce_scatter": 0, "pmax": 0}
CALLS = {k: 0 for k in BYTES}


def reset_counts() -> None:
    for counts in (BYTES, CALLS):
        for k in counts:
            counts[k] = 0


def _count(kind: str, nbytes: float) -> None:
    BYTES[kind] += int(nbytes)
    CALLS[kind] += 1


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, x: torch.Tensor) -> bool:
    """A CUDA tensor on a gloo group goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(group, x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if _staged(group, x) else x


# ------------------------------------------------------------ raw collectives

def _all_reduce(x: torch.Tensor, group, kind: str = "psum",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    n = size(group)
    _count(kind, 2 * (n - 1) / n * x.nelement() * x.element_size())
    # a buffer of its own: all_reduce writes its input
    buf = x.cpu() if _staged(group, x) else x.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _all_to_all_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: row i goes to rank i; row j of the result came from
    rank j."""
    n = size(group)
    _count("all_to_all", (n - 1) / n * x.nelement() * x.element_size())
    src = _host(group, x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def _all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """x [...] -> [n, ...], row j from rank j."""
    n = size(group)
    _count("all_gather", (n - 1) * x.nelement() * x.element_size())
    src = _host(group, x).contiguous()
    out = src.new_empty((n, *src.shape))
    if src.is_cuda:
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(x.device)


def _reduce_scatter_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] -> [...]: the sum over ranks of their row ``rank``,
    accumulated in fp32 in rank order, in x's dtype."""
    n = size(group)
    _count("reduce_scatter", (n - 1) / n * x.nelement() * x.element_size())
    src = _host(group, x).contiguous()
    parts = torch.empty_like(src)
    dist.all_to_all_single(parts, src, group=group)
    parts = parts.to(x.device)              # the sum runs where x lives
    total = parts[0].float()
    for j in range(1, n):
        total = total + parts[j].float()
    return total.to(x.dtype)


def _ppermute(x: torch.Tensor, group,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute {perm}: a rank sends and receives at "
                         f"most once")
    if dst and dst[0] != me:
        _count("ppermute", x.nelement() * x.element_size())
    if src and src[0] == me:
        return x.clone()
    staged = _host(group, x).contiguous()
    out = torch.zeros_like(staged)
    ops = []
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, staged,
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


# ------------------------------------------------------------ autograd

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: each (src, dst) pair of group ranks sends src's
    ``x`` to dst; a rank no pair sends to gets zeros."""
    if group is None:
        return x
    return _PPermute.apply(x, group, tuple(perm))


def _tiles(x: torch.Tensor, n: int, split_axis: int) -> torch.Tensor:
    """x split n ways along ``split_axis`` -> [n, ...] (tile i first)."""
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"not divisible by the group's {n} ranks")
    return torch.stack(x.chunk(n, dim=split_axis))


def _a2a(x, group, split_axis, concat_axis):
    n = size(group)
    parts = _all_to_all_dim0(_tiles(x, n, split_axis), group)
    return torch.cat(parts.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    x is split n ways along ``split_axis``, tile i goes to rank i, and the
    tiles received are concatenated along ``concat_axis`` in rank
    order."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the group, on every rank. Its
    backward passes the cotangent through: every rank backpropagates the
    same loss, so the sum's gradient reaches each rank's input once."""
    if group is None:
        return x
    return _PSum.apply(x, group)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as an input replicated over the group (``P()`` under
    ``shard_map``): the identity, whose gradient is summed over the
    group's ranks, as shard_map's transpose sums it."""
    if group is None:
        return x
    return _Replicate.apply(x, group)


def _gather(x, group, dim):
    return torch.cat(_all_gather_dim0(x, group).unbind(0), dim=dim)


def _scatter(x, group, dim):
    return _reduce_scatter_dim0(_tiles(x, size(group), dim), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _scatter(g, group, dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather(g, group, dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' shards concatenated along ``dim`` in rank order; the
    backward reduce-scatters the gradient (each rank's shard gets the sum
    of every rank's gradient of it)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ranks of ``x``, split n ways along ``dim``; this rank
    keeps its part. The backward all-gathers."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.shapes))


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, with ``others`` in its graph at a zero cotangent: a rank
    that does not use a received tensor still runs the backward of the
    collective that brought it."""
    return _Tie.apply(x, *others)


def pmean(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``lax.pmean`` over several axes: the psum over each group in turn,
    divided by the product of their sizes (groups of None count as one
    rank). Its backward is psum's, scaled: g / n on every rank."""
    n = 1
    for group in groups:
        x = psum(x, group)
        n *= size(group)
    return x / n


@torch.no_grad()
def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, on every rank, with
    no gradient: the reference's ``pmax(stop_gradient(x))``, a numerical
    stabilizer whose value cancels where it is used."""
    x = x.detach()
    if group is None:
        return x
    return _all_reduce(x, group, "pmax", dist.ReduceOp.MAX)


def all_reduce_(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """In-place sum of ``x`` over the group (not differentiable); the
    identity for ``group=None``."""
    if group is not None:
        x.copy_(_all_reduce(x, group))
    return x
