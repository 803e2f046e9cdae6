"""Correlation volume, pyramid and windowed lookup (PyTorch port of
``craft_tpu.ops.corr``, one-way D=1 volumes): the plain all-pairs volume of
RAFT and GMA, and the pyramids of the plain and the TransCorr volumes.

Pyramid level l is stored [B*H1*W1, h_l, w_l].  The per-iteration lookup
samples a (2r+1)^2 bilinear window around coords/2^l on every level and
returns [B, H1, W1, L*(2r+1)^2] in the reference channel order: level, then
x-offset i, then y-offset j (reference corr.py:47-71).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from craft_tpu_torch.ops.kernels import corr_lookup as lk


class CorrPyramid(NamedTuple):
    levels: tuple  # [B*H1*W1, h_l, w_l] per level
    batch: int
    h1: int
    w1: int
    radius: int


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of [N, h, w] in fp32; an odd last row or column is
    dropped (a level may shrink to zero rows, as in the JAX package).  The
    four corners are summed in order into one fp32 tensor of the output's
    size, each converted as it is read: no fp32 copy of the whole input
    (7.58 GB for HD1K's level 0, twice the level itself)."""
    h, w = (x.shape[1] // 2) * 2, (x.shape[2] // 2) * 2
    x = x[:, :h, :w]
    acc = x[:, 0::2, 0::2].to(torch.float32, copy=True)
    acc.add_(x[:, 1::2, 0::2])
    acc.add_(x[:, 0::2, 1::2])
    acc.add_(x[:, 1::2, 1::2])
    return acc.mul_(0.25)


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """[B, H*W, H*W] dot-product correlation of two NHWC maps in fp32,
    divided by sqrt(C) (reference corr.py:73-81)."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    f2 = fmap2.reshape(B, H * W, C).float()
    return torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(C)


def global_layer_norm(vol: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Layer-norm over the flat volume per (batch, dim) slice (reference
    corr.py:27-30, 200-204).  vol: [B, D, N]."""
    mean = vol.mean(dim=-1, keepdim=True)
    var = (vol - mean).square().mean(dim=-1, keepdim=True)
    return (vol - mean) * torch.rsqrt(var + eps)


def build_pyramid(corr: torch.Tensor, batch: int, h1: int, w1: int,
                  num_levels: int = 4, radius: int = 4,
                  do_global_norm: bool = False,
                  level_dtype=torch.float32) -> CorrPyramid:
    """Average-pool pyramid from a raw [B, U1, 1, U2] fp32 volume."""
    B, U1, D, U2 = corr.shape
    assert D == 1 and U1 == h1 * w1 and U2 == h1 * w1
    if do_global_norm:
        corr = global_layer_norm(corr.reshape(B, 1, U1 * U2))
    levels = [corr.reshape(B * U1, h1, w1)]
    for _ in range(num_levels - 1):
        levels.append(_pool2x2(levels[-1]))
    return CorrPyramid(tuple(l.to(level_dtype) for l in levels), batch, h1,
                       w1, radius)


def pyramid_from_level0(level0: torch.Tensor, batch: int, h1: int, w1: int,
                        num_levels: int = 4, radius: int = 4,
                        level_dtype=torch.bfloat16) -> CorrPyramid:
    """Pyramid from an already-normalized [B, U1, U2] base volume.  Pooling
    accumulates in fp32; an odd last row or column is dropped."""
    B, U1, U2 = level0.shape
    cur = level0.reshape(B * U1, h1, w1)
    levels = [cur.to(level_dtype)]
    for _ in range(num_levels - 1):
        cur = _pool2x2(cur).to(level_dtype)
        levels.append(cur)
    return CorrPyramid(tuple(levels), batch, h1, w1, radius)


def plain_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4, radius: int = 4,
                       level_dtype=torch.float32) -> CorrPyramid:
    """RAFT's CorrBlock (reference corr.py:16-45): the pyramid of the plain
    volume, without the global norm."""
    B, H, W, _ = fmap1.shape
    corr = all_pairs_correlation(fmap1, fmap2)
    return build_pyramid(corr.reshape(B, H * W, 1, H * W), B, H, W,
                         num_levels, radius, level_dtype=level_dtype)


def corr_lookup(pyr: CorrPyramid, coords: torch.Tensor) -> torch.Tensor:
    """The windowed multi-scale lookup (B5), [B, H1, W1, L*(2r+1)^2] fp32,
    differentiable in the levels.

    coords: [B, H1, W1, 2] (x, y) fp32; they get no gradient.  CPU tensors
    take the plain gather forward and backward; CUDA tensors take the hand
    kernels, forward and backward, or raise."""
    return lk.corr_lookup_diff(pyr.levels, coords, pyr.radius)
