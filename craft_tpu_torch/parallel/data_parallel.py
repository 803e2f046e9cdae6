"""Data-parallel training across ranks (the port's counterpart of
``craft_tpu.parallel.mesh`` and of the data-parallel step in
``craft_tpu/train.py``; SURVEY section 5.8): one process per rank (under
torchrun), each taking --batch_size samples, joined by the group of
``parallel/sp.py`` (``sp.init``: NCCL when every rank has a card of its
own, gloo when ranks share one or run on the CPU).

The JAX step shards one global batch over a 'data' mesh, so each of its
reductions runs over the global batch.  The port's step makes the same
reductions across ranks:
  * cnet's train-mode BatchNorm takes its moments over every rank's
    samples through ``all_sum``, an all-reduce whose backward all-reduces
    the cotangent, so the moments' gradient crosses ranks as the JAX
    step's does;
  * the gradients are summed in one flat all-reduce and divided by the
    world size (the global batch's mean) before the global-norm clip;
  * the loss and the flow metrics are reduced as numerators and
    denominators (``sum_over_ranks``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable: the gradient of each
    rank's input is the sum of every rank's cotangent."""
    return _AllSum.apply(x)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def average_gradients(params: List[torch.nn.Parameter], world: int) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one all-reduce of the gradients laid end to end."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
