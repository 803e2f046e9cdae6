"""Sequence loss and flow metrics (PyTorch port of
``craft_tpu.training.loss``; reference train.py:44-73).

Exponentially weighted (gamma^(N-1-i)) L1 over every refinement
iteration's prediction, masked by validity and a 400 px magnitude cutoff.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from craft_tpu_torch.ops.geometry import pack_fullres

MAX_FLOW = 400.0


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  metric_sum: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: [iters, B, H, W, 2]; flow_gt: [B, H, W, 2]; valid:
    [B, H, W] (>= 0.5 = supervised pixel).  Returns (0-d loss, metrics
    epe/1px/3px/5px as 0-d tensors); nothing syncs the host.
    `metric_sum` (data parallelism: a sum over the ranks) reduces the
    metrics' numerators and denominator, so they are the global batch's."""
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
    return loss, _metrics(epe_map, valid.float(), metric_sum)


def sequence_loss_packed(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                         valid: torch.Tensor, gamma: float = 0.8,
                         metric_sum: Optional[Callable] = None,
                         factor: int = 8
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sequence_loss on packed predictions (upsample_mode='packed': [iters,
    B, H/f, W/f, 2*f^2], the x sub-pixel block then the y one): the
    ground truth and the mask are packed once, with ``pack_fullres``.  The
    same terms as sequence_loss, summed in another pixel order (the JAX
    package's ``sequence_loss_packed``)."""
    n, c2 = flow_preds.shape[0], flow_preds.shape[-1]
    f2 = c2 // 2
    gtp = pack_fullres(flow_gt, factor)                     # [B, h, w, 2*f2]
    vp = pack_fullres(valid[..., None], factor)[..., :f2]   # [B, h, w, f2]
    mag = torch.sqrt(gtp[..., :f2] ** 2 + gtp[..., f2:] ** 2)
    validp = (vp >= 0.5) & (mag < MAX_FLOW)
    vmask = torch.cat([validp, validp], -1)[None].to(flow_preds.dtype)
    weights = gamma ** (n - 1 - torch.arange(
        n, dtype=flow_preds.dtype, device=flow_preds.device))
    i_loss = (flow_preds - gtp[None]).abs()
    per_iter = (vmask * i_loss).mean(dim=(1, 2, 3, 4))
    loss = (weights * per_iter).sum()

    dx = flow_preds[-1, ..., :f2] - gtp[..., :f2]
    dy = flow_preds[-1, ..., f2:] - gtp[..., f2:]
    epe_map = torch.sqrt(dx ** 2 + dy ** 2)
    return loss, _metrics(epe_map, validp.float(), metric_sum)


def _metrics(epe_map, vm, metric_sum) -> Dict[str, torch.Tensor]:
    """epe/1px/3px/5px over the pixels where vm is 1, the numerators and
    the count reduced by `metric_sum` when given."""
    sums = torch.stack([(epe_map * vm).sum()] + [
        ((epe_map < px) * vm).sum() for px in (1, 3, 5)] + [vm.sum()])
    sums = sums.detach()
    if metric_sum is not None:
        sums = metric_sum(sums)
    denom = sums[-1].clamp(min=1.0)
    return {key: sums[i] / denom
            for i, key in enumerate(("epe", "1px", "3px", "5px"))}
