"""Optimizer, learning-rate schedule and gradient clipping (PyTorch port of
``craft_tpu.training.optim``; reference train.py:76-85).

AdamW(lr, wdecay, eps) over every parameter (the tied Q/K projection is
one parameter, counted once), OneCycleLR with a linear anneal, pct_start
0.05 and total_steps = num_steps + 100, and global-norm clipping.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 5e-5,
                   epsilon: float = 1e-8):
    """(AdamW, OneCycleLR).  ``cycle_momentum=False`` keeps Adam's beta1 at
    0.9 (the default would cycle it between 0.85 and 0.95), as optax's
    adamw under the JAX package's one-cycle schedule."""
    opt = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999),
                            eps=epsilon, weight_decay=wdecay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=num_steps + 100, pct_start=0.05,
        anneal_strategy="linear", cycle_momentum=False)
    return opt, sched


def clip_by_global_norm(params: List[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / norm when the global norm reaches
    max_norm (optax.clip_by_global_norm; torch's clip_grad_norm_ divides
    by norm + 1e-6 instead).  Returns the norm before clipping, a 0-d fp32
    tensor; nothing syncs the host."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
