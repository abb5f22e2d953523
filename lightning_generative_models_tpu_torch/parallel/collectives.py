"""Collectives over a process group, the differentiable ones as autograd functions.

The JAX package states a layout and lets GSPMD insert the psums; here each strategy
places its collectives itself (Megatron's conjugate pairs, Shoeybi et al. 2019,
arXiv:1909.08053; Korthikanti et al. 2022, arXiv:2205.05198):

- ``all_reduce_sum``: forward sum, backward sum (BatchNorm's statistics over the data
  ranks, the MoE load-balancing means): with every rank's loss a mean over its rows and
  the optimizer averaging the gradients over the data ranks, the gradient is the
  global batch's;
- ``copy_to``: forward identity, backward sum (a replicated tensor entering a
  tensor-parallel region: each rank's gradient holds only its heads' or experts' share);
- ``reduce_from``: forward sum, backward identity (a row-parallel output leaving it);
- ``gather_tokens`` / ``scatter_tokens``: sequence parallelism's pair, forward all-gather
  with backward reduce-scatter over the token axis, and the reverse;
- ``split_tokens`` / ``join_tokens``: this rank's token chunk of a replicated tensor
  (backward all-gather), and the replicated tensor from the chunks (backward: the chunk).

A group of None is one process: every function is then the identity. The tensors
handed to a collective are made contiguous; a reduce-scatter is NCCL's own on an NCCL
group, and an all-reduce then the rank's chunk on gloo, which has none.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (``x`` contiguous); returns it."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of the ranks' ``x``."""
    if group is None:
        return x
    n = size(group)
    if dist.get_backend(group) == "nccl":
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
        dist.reduce_scatter_tensor(out, front, group=group)
        return out.movedim(0, dim)
    total = all_reduce_(x.clone(memory_format=torch.contiguous_format), group)
    return total.chunk(n, dim=dim)[rank(group)].contiguous()


def chunk(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``."""
    if group is None:
        return x
    return x.chunk(size(group), dim=dim)[rank(group)].contiguous()


def broadcast_(x: torch.Tensor, src_index: int, group: Group) -> torch.Tensor:
    """``x`` (contiguous) from the ``src_index``-th rank of ``group``, in place."""
    if group is not None:
        dist.broadcast(x, dist.get_global_rank(group, src_index), group=group)
    return x


def flat_all_reduce_(tensors: List[torch.Tensor], group: Group) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, one collective per dtype
    (the tensors packed into one buffer)."""
    if group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(same, [part.view_as(t) for part, t in
                                    zip(flat.split([t.numel() for t in same]), same)])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _JoinTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.group, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_tokens(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _GatherTokens.apply(x, group, dim)


def scatter_tokens(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _ScatterTokens.apply(x, group, dim)


def split_tokens(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _SplitTokens.apply(x, group, dim)


def join_tokens(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _JoinTokens.apply(x, group, dim)
