"""Sequence loss and flow metrics (PyTorch port of
``craft_tpu.training.loss``; reference train.py:44-73).

Exponentially weighted (gamma^(N-1-i)) L1 over every refinement
iteration's prediction, masked by validity and a 400 px magnitude cutoff.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MAX_FLOW = 400.0


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: [iters, B, H, W, 2]; flow_gt: [B, H, W, 2]; valid:
    [B, H, W] (>= 0.5 = supervised pixel).  Returns (0-d loss, metrics
    epe/1px/3px/5px as 0-d tensors); nothing syncs the host."""
    n = flow_preds.shape[0]
    mag = torch.sqrt((flow_gt ** 2).sum(-1))
    valid = (valid >= 0.5) & (mag < MAX_FLOW)
    vmask = valid[None, ..., None].to(flow_preds.dtype)
    weights = gamma ** (n - 1 - torch.arange(
        n, dtype=flow_preds.dtype, device=flow_preds.device))
    i_loss = (flow_preds - flow_gt[None]).abs()
    # The mean runs over ALL elements, invalid zeros included (reference).
    per_iter = (vmask * i_loss).mean(dim=(1, 2, 3, 4))
    loss = (weights * per_iter).sum()

    epe_map = torch.sqrt(((flow_preds[-1] - flow_gt) ** 2).sum(-1))
    vm = valid.float()
    denom = vm.sum().clamp(min=1.0)
    metrics = {"epe": (epe_map * vm).sum() / denom}
    for px in (1, 3, 5):
        metrics[f"{px}px"] = ((epe_map < px) * vm).sum() / denom
    return loss, metrics
