"""Shared layers: convolutions and linears run in a compute dtype over fp32
parameters, the norms of the JAX package (``craft_tpu.nn.layers``), and the
training dropouts, which draw from an explicit ``torch.Generator``.

Parameters stay fp32; under mixed precision the weights are cast to bf16 at
the call, as flax does with ``dtype=bf16, param_dtype=fp32``.  The bias is
added after the product in the compute dtype, as flax does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from craft_tpu_torch.parallel.data_parallel import all_sum


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, dtype=torch.float32) -> torch.Tensor:
    """NCHW convolution in `dtype`; `padding` is an int, a pair, or the
    ``(left, right, top, bottom)`` quadruple of ``F.pad``."""
    x = x.to(dtype)
    if isinstance(padding, tuple) and len(padding) == 4:
        x = F.pad(x, padding)
        padding = 0
    y = F.conv2d(x, weight.to(dtype), None, stride, padding)
    if bias is not None:
        y = y + bias.to(dtype).view(1, -1, 1, 1)
    return y


def conv(module: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply an ``nn.Conv2d``'s parameters with torch-SAME padding."""
    return conv2d(x, module.weight, module.bias, module.stride,
                  module.padding, dtype)


def linear(module: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    y = F.linear(x.to(dtype), module.weight.to(dtype))
    if module.bias is not None:
        y = y + module.bias.to(dtype)
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW in the E[x^2]-E[x]^2 form with
    fp32 accumulators (``craft_tpu.nn.layers.InstanceNorm``): x^2 is taken
    in x's dtype, the moments are summed in fp32 (fp64 for fp64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    mean = x.to(acc).mean(dim=(2, 3), keepdim=True)
    mean_sq = (x * x).to(acc).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-12,
               dtype=None) -> torch.Tensor:
    """LayerNorm over the trailing axis in fp32 (SETrans eps 1e-12), with an
    optional affine, cast to `dtype` (default: x's dtype)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y.to(dtype or x.dtype)


def folded_conv_bn(conv_m: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Conv followed by eval-mode BatchNorm, with the BN affine folded into
    the conv weights (``craft_tpu.nn.encoder._conv_bn_folded``):
    W' = W*g, b' = (b - mean)*g + beta, g = gamma/sqrt(var + eps)."""
    g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    w = conv_m.weight * g.view(-1, 1, 1, 1)
    b0 = conv_m.bias if conv_m.bias is not None else 0.0
    b = (b0 - bn.running_mean) * g + bn.bias
    return conv2d(x, w, b, conv_m.stride, conv_m.padding, dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, dtype,
                     momentum: float = 0.9,
                     data_parallel=None) -> torch.Tensor:
    """Train-mode BatchNorm on NCHW with flax's semantics
    (``flax.linen.BatchNorm(momentum=0.9)``): batch moments in fp32, and
    the running averages updated in place with momentum 0.9 and the
    *biased* batch variance (``nn.BatchNorm2d`` would take the unbiased
    one).  The variance is taken in two passes, E[(x - E[x])^2]: flax's
    E[x^2] - E[x]^2 is the same value up to rounding, but its gradient
    cancels badly in fp32 where |E[x]| >> std.  With `data_parallel` (a
    group of more than one rank) the moments run over every rank's batch,
    as the JAX step's over its global batch, and their gradient crosses the
    ranks.  Returns the normalized x in `dtype`."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if data_parallel is None or data_parallel.world == 1:
        mean = x32.mean(dim=(0, 2, 3))
        var = (x32 - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    else:
        n = x32.numel() // x32.shape[1] * data_parallel.world
        mean = all_sum(x32.sum(dim=(0, 2, 3))) / n
        var = all_sum((x32 - mean.view(1, -1, 1, 1)).square().sum(
            dim=(0, 2, 3))) / n
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.running_var.mul_(momentum).add_((1.0 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
        + bn.bias.view(1, -1, 1, 1)
    return y.to(dtype)


def _keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """Bool mask, each element True with probability `keep`, drawn from
    `generator` one leading slice at a time (the fp32 uniforms of a
    [B, M, U, U] probs tensor never exist whole)."""
    mask = torch.empty(shape, dtype=torch.bool, device=device)
    for i in range(shape[0]):
        mask[i] = torch.rand(shape[1:], generator=generator,
                             device=device) < keep
    return mask


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate).  ``F.dropout`` takes no generator, so the mask
    is drawn here from `generator` (a ``torch.Generator`` on x's device, or
    None for the default one); autograd keeps only the bool mask."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x * (1.0 / keep),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout2d(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Channel dropout on NHWC (torch Dropout2d): one keep draw per (sample,
    channel), scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    B, C = x.shape[0], x.shape[-1]
    mask = _keep_mask((B, 1, 1, C), keep, generator, x.device)
    return x * mask.to(x.dtype) / keep


def drop_path(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Stochastic depth per sample (``craft_tpu.nn.setrans.drop_path``;
    reference setrans.py:42-69): each sample (the leading axis) kept with
    probability 1 - rate, as x / (1 - rate), else zero; the keeps drawn
    from `generator`."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x / keep * mask.to(x.dtype)
