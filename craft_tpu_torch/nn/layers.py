"""Shared layers: convolutions and linears run in a compute dtype over fp32
parameters, and the norms of the JAX package (``craft_tpu.nn.layers``).

Parameters stay fp32; under mixed precision the weights are cast to bf16 at
the call, as flax does with ``dtype=bf16, param_dtype=fp32``.  The bias is
added after the product in the compute dtype, as flax does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    in x's dtype, the moments are summed in fp32."""
    mean = x.float().mean(dim=(2, 3), keepdim=True)
    mean_sq = (x * x).float().mean(dim=(2, 3), keepdim=True)
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
