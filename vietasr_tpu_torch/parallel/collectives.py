"""The all-reduce with a chosen autograd rule, for the data- and
tensor-parallel forwards.

`_AllReduce` sums over a process group in the forward pass, in the
backward pass, or in both:
- `all_reduce_sum` (both): a statistic summed over the data-parallel
  ranks, each of which owns a share of the loss (the BN sums). The loss is
  the sum of the ranks' shares, so the gradient of the sum reaching each
  rank's input is the sum of the ranks' gradients.
- `copy_to_group` (backward only) and `reduce_from_group` (forward only):
  Megatron's f / g pair around a tensor-parallel region, whose loss every
  rank computes whole. f marks the replicated input of the column-sharded
  products: each rank's input gradient is a partial sum. g completes the
  partial sums after a row-sharded product; its output gradient is the
  same on every rank.
With `group=None` each is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, forward: bool, backward: bool):
        ctx.group, ctx.backward = group, backward
        if not forward:
            return x.view_as(x)
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        if ctx.backward:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`, forward and backward."""
    return x if group is None else _AllReduce.apply(x, group, True, True)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity, whose gradient is summed over `group`."""
    return x if group is None else _AllReduce.apply(x, group, False, True)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over `group`, whose gradient passes as it is."""
    return x if group is None else _AllReduce.apply(x, group, True, False)
