"""Correlation volume, pyramid and windowed lookup (PyTorch port of
``craft_tpu.ops.corr``): the plain all-pairs volume of RAFT and GMA, and
the pyramids of the plain and the TransCorr volumes, one-way (D = 1) or
two-way (D = 2, --f1: [f1'.f2, f1.f2'], ``craft_tpu/models/
flow_model.py:67-96``).

Level l of a pyramid is D planes, each stored [B*H1*W1, h_l, w_l], held in
(level, d) order (the JAX package interleaves D into one array's lane axis,
[B*H1*W1, h_l, w_l*D], a TPU tiling choice).  The per-iteration lookup
samples a (2r+1)^2 bilinear window around coords/2^l on every plane and
returns [B, H1, W1, L*D*(2r+1)^2] in the reference channel order: level,
then d, then x-offset i, then y-offset j (reference corr.py:47-71).

Under sequence parallelism (a ``RowShard``, ``parallel/sp.py``) a volume
and its pyramid hold the shard's query rows against every key: U1 = rows
* W1 query tokens, each level [B*U1, h_l, w_l].  Pooling runs over the key
axes, so it stays row-local; the global norm takes its moments over every
rank's rows (``RowShard.layer_norm_moments``), as the JAX package's
``sp_shard(corr, 1)`` before its norm (``craft_tpu/ops/corr.py:95-101``).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from craft_tpu_torch.ops.kernels import corr_lookup as lk


class CorrPyramid(NamedTuple):
    levels: tuple  # [B*H1*W1, h_l, w_l] per plane, (level, d) order
    batch: int
    h1: int
    w1: int
    radius: int
    dim: int = 1  # D, the planes a level


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
    """[B, H1*W1, H*W] dot-product correlation of two NHWC maps in fp32,
    divided by sqrt(C) (reference corr.py:73-81); fmap1 may hold some grid
    rows of the frame (a shard's), fmap2 holds every one."""
    B, H, W, C = fmap2.shape
    f1 = fmap1.reshape(B, -1, C).float()
    f2 = fmap2.reshape(B, H * W, C).float()
    return torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(C)


def global_layer_norm(vol: torch.Tensor, eps: float = 1e-12,
                      shard=None) -> torch.Tensor:
    """Layer-norm over the flat volume per (batch, dim) slice (reference
    corr.py:27-30, 200-204).  vol: [B, D, N]; under `shard` (a RowShard)
    N is this rank's part and the moments are every rank's."""
    if shard is None:
        mean = vol.mean(dim=-1, keepdim=True)
        var = (vol - mean).square().mean(dim=-1, keepdim=True)
    else:
        mean, var = shard.layer_norm_moments(vol)
    return (vol - mean) * torch.rsqrt(var + eps)


def build_pyramid(corr: torch.Tensor, batch: int, h1: int, w1: int,
                  num_levels: int = 4, radius: int = 4,
                  do_global_norm: bool = False,
                  level_dtype=torch.float32, shard=None) -> CorrPyramid:
    """Average-pool pyramid from a raw [B, U1, D, U2] fp32 volume (D = 1,
    or 2 for the two-way volume), normed per (batch, d) when asked, as the
    JAX package's (``craft_tpu/ops/corr.py:87-129``).  Each d becomes its
    own contiguous plane of every level.  Under `shard` U1 is the shard's
    rows of the h1 x w1 grid, and the norm's moments are every rank's."""
    B, U1, D, U2 = corr.shape
    rows = h1 if shard is None else shard.rows
    assert U1 == rows * w1 and U2 == h1 * w1
    planes = []
    for d in range(D):
        plane = corr[:, :, d]
        if do_global_norm:
            plane = global_layer_norm(plane.reshape(B, 1, U1 * U2),
                                      shard=shard)
        planes.append(plane.reshape(B * U1, h1, w1).contiguous())
    return _pooled(planes, batch, h1, w1, num_levels, radius, level_dtype,
                   cast_each=False)


def _pooled(planes, batch, h1, w1, num_levels, radius, level_dtype,
            cast_each):
    """The pyramid of level-0 planes [B*U1, h1, w1] (one per d): each plane
    pooled on its own, the levels in (level, d) order.  With `cast_each`
    every level is cast to `level_dtype` before the next is pooled from it
    (the pyramid of an already-normed bf16 level 0); otherwise the levels
    are pooled in the planes' type and cast at the end."""
    chain = [[p] for p in planes]
    for _ in range(num_levels - 1):
        for c in chain:
            nxt = _pool2x2(c[-1])
            c.append(nxt.to(level_dtype) if cast_each else nxt)
    levels = tuple(c[l].to(level_dtype) for l in range(num_levels)
                   for c in chain)
    return CorrPyramid(levels, batch, h1, w1, radius, len(planes))


def pyramid_from_level0(level0, batch: int, h1: int, w1: int,
                        num_levels: int = 4, radius: int = 4,
                        level_dtype=torch.bfloat16) -> CorrPyramid:
    """Pyramid from an already-normalized [B, U1, U2] base volume, or a
    sequence of them, one per d of a two-way volume.  Pooling accumulates
    in fp32; an odd last row or column is dropped."""
    if isinstance(level0, torch.Tensor):
        level0 = (level0,)
    planes = [v.reshape(v.shape[0] * v.shape[1], h1, w1) for v in level0]
    return _pooled(planes, batch, h1, w1, num_levels, radius, level_dtype,
                   cast_each=True)


def plain_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4, radius: int = 4,
                       level_dtype=torch.float32, shard=None) -> CorrPyramid:
    """RAFT's CorrBlock (reference corr.py:16-45): the pyramid of the plain
    volume, without the global norm; under `shard` the volume and pyramid
    of the shard's rows of fmap1."""
    B, H, W, _ = fmap2.shape
    if shard is not None:
        fmap1 = fmap1[:, shard.h0:shard.h1]
    corr = all_pairs_correlation(fmap1, fmap2)
    return build_pyramid(corr[:, :, None], B, H, W, num_levels, radius,
                         level_dtype=level_dtype, shard=shard)


def corr_lookup(pyr: CorrPyramid, coords: torch.Tensor) -> torch.Tensor:
    """The windowed multi-scale lookup (B5), [B, H1, W1, L*D*(2r+1)^2]
    fp32, differentiable in the levels.

    coords: [B, H1, W1, 2] (x, y) fp32; they get no gradient.  CPU tensors
    take the plain gather forward and backward; CUDA tensors take the hand
    kernels, forward and backward, or raise."""
    return lk.corr_lookup_diff(pyr.levels, coords, pyr.radius, pyr.dim)
