"""Optimizer, learning-rate schedule and gradient clipping (PyTorch port of
``craft_tpu.training.optim``; reference train.py:76-85).

AdamW(lr, wdecay, eps) over every parameter (the tied Q/K projection is
one parameter, counted once), OneCycleLR with a linear anneal, pct_start
0.05 and total_steps = num_steps + 100, and global-norm clipping.

The JAX package ends the warm-up at the whole step round(pct_start *
total) - 1, where torch's OneCycleLR ends it at pct_start * total - 1; the
two agree where that is a whole step (every stage of the curriculum:
num_steps a multiple of 20).  The port's schedule takes the JAX package's
end, so the two packages' rates agree at every step of every run.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch

PCT_START = 0.05


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 5e-5,
                   epsilon: float = 1e-8):
    """(AdamW, OneCycleLR).  ``cycle_momentum=False`` keeps Adam's beta1 at
    0.9 (the default would cycle it between 0.85 and 0.95), as optax's
    adamw under the JAX package's one-cycle schedule."""
    opt = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999),
                            eps=epsilon, weight_decay=wdecay)
    total = num_steps + 100
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=total, pct_start=PCT_START,
        anneal_strategy="linear", cycle_momentum=False)
    # The warm-up's end at the JAX package's whole step (the phases are
    # saved with the scheduler's state, so a checkpoint keeps it).
    sched._schedule_phases[0]["end_step"] = float(warmup_end(total))
    return opt, sched


def warmup_end(total_steps: int, pct_start: float = PCT_START) -> int:
    """The step at which the JAX package's one-cycle warm-up peaks."""
    return max(int(round(pct_start * total_steps)) - 1, 1)


def onecycle_linear_host(max_lr: float, total_steps: int,
                         pct_start: float = 0.05, div_factor: float = 25.0,
                         final_div_factor: float = 1e4
                         ) -> Callable[[int], float]:
    """The one-cycle schedule as a function of the step, on the host (the
    JAX package's host twin of its optax schedule): the learning rate the
    logger prints, equal to the rate of ``make_optimizer``'s schedule after
    that many steps."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    warm = warmup_end(total_steps, pct_start)

    def lr(step: int) -> float:
        if step <= warm:
            return initial + (max_lr - initial) * min(step / warm, 1.0)
        t = min((step - warm) / (total_steps - 1 - warm), 1.0)
        return max_lr + (final - max_lr) * t

    return lr


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
