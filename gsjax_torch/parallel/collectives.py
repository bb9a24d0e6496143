"""Differentiable collectives of the multi-device path, on `torch.distributed`.

gsjax's sharded step differentiates through `jax.lax.all_gather` (whose
transpose autodiff derives as a reduce-scatter, gsjax/parallel/shard.py:
336-338) and sums loss partials with `jax.lax.psum`. Here those are:

  - `all_gather(x, dim)`: every rank's `x` (same shape on each) concatenated
    along `dim`. Its backward sums the cotangent over ranks and keeps this
    rank's slice: a reduce-scatter built from `all_reduce` and a slice;
  - `all_sum(x)`: a sum over ranks without a gradient (loss sums, counts);
  - `all_sum_many(tensors)`: the sums of a list of tensors through one
    flat buffer (the gradients after the backward).

They are written on `all_reduce` and `all_gather` only, the two collectives
that the `gloo` backend runs on both CPU and CUDA tensors (it has no
reduce-scatter), so the same code serves ranks on the CPU, ranks that share
one card over `gloo` and ranks with a card each over `nccl`. A collective
that the backend refuses raises; nothing falls back. Every rank must call
the same collectives in the same order: the step's forward and backward do,
since every rank runs the same graph on its own band.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world(group=None) -> tuple[int, int]:
    """(ranks, this rank) of `group` (default: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


def _gather_list(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return torch.cat(_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order;
    differentiable (the backward is the reduce-scatter of the cotangent).
    Each rank must pass the same shape."""
    if not x.requires_grad:
        return torch.cat(_gather_list(x, group), dim=dim)
    return _AllGather.apply(x, dim, group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over ranks (a new tensor, no gradient)."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_sum_many(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Sum each tensor of `tensors` (one dtype and device) over ranks through
    one flat buffer; returns the summed tensors, shaped as given."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out
