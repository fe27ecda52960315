"""Megatron's conjugate collectives as autograd functions over a group.

Counterpart of ``models/parallel_layers.py`` in the JAX package, with a
``ProcessGroup`` (``DeviceMesh.get_group``) where JAX takes an axis
name:

- :func:`f_tp`, where a replicated activation fans out into tensor-sharded
  branches: identity forward, all-reduce of the gradient backward;
- :func:`g_tp`, after a row-sharded matmul: all-reduce forward, identity
  backward (the transpose must not reduce again);
- :func:`gather_seq`, sequence-sharded K/V gathered for attention:
  all-gather forward, reduce-scatter of the gradient backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


# torch 2.13 renames reduce_scatter_tensor (older releases have only it)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class _FTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        # the rank-ordered chunks of g along dim, laid end to end along dim
        # 0, which the reduce-scatter cuts into n and sums
        chunks = g.chunk(n, dim=ctx.dim)
        out = torch.empty_like(chunks[0],
                               memory_format=torch.contiguous_format)
        _REDUCE_SCATTER(out, torch.cat([c.contiguous() for c in chunks]),
                        group=ctx.group)
        return out, None, None


def f_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _FTp.apply(x, group)


def g_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; the gradient as is backward."""
    return _GTp.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim``, concatenated in group-rank
    order (forward); the gradient's block of this rank, summed over the
    group (backward)."""
    return _GatherSeq.apply(x, group, dim)
