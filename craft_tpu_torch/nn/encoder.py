"""Feature / context encoders (PyTorch port of ``craft_tpu.nn.encoder``;
reference core/extractor.py:6-196).

BasicEncoder: 7x7 stride-2 stem -> three 2-block residual stages (64, 96,
128 at strides 1, 2, 2) -> 1x1 output conv; overall stride 8.  Module and
parameter names are the reference's, so its state_dict loads as is.  In
eval mode 'batch' norm runs on its running statistics, folded into the
preceding conv; in train mode it normalizes with the batch statistics and
updates the running ones (flax semantics, ``batch_norm_train``), and
Dropout2d follows the output conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from craft_tpu_torch.nn.layers import (batch_norm_train, conv, dropout2d,
                                      folded_conv_bn, instance_norm)

STEM_DIM = 64
STAGE_DIMS = ((64, 1), (96, 2), (128, 2))


def _norm(norm_fn: str, planes: int):
    if norm_fn == "batch":
        return nn.BatchNorm2d(planes)
    if norm_fn in ("instance", "none"):
        return None  # parameter-free (reference InstanceNorm2d affine=False)
    raise NotImplementedError(f"norm_fn {norm_fn}")


def _conv_norm(conv_m, norm_m, norm_fn, x, dtype, train=False,
               data_parallel=None):
    """conv -> norm in the compute dtype (NCHW).  `data_parallel`: the group
    whose ranks share train-mode BatchNorm's moments."""
    if norm_fn == "batch" and not train:
        return folded_conv_bn(conv_m, norm_m, x, dtype)
    y = conv(conv_m, x, dtype)
    if norm_fn == "batch":
        return batch_norm_train(y, norm_m, dtype,
                                data_parallel=data_parallel)
    return instance_norm(y) if norm_fn == "instance" else y


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm + ReLU and a strided 1x1 downsample
    (reference extractor.py:6-64)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            ds = [nn.Conv2d(in_planes, planes, 1, stride)]
            norm3 = _norm(norm_fn, planes)
            if norm3 is not None:
                ds.append(norm3)
            self.downsample = nn.Sequential(*ds)

    def forward(self, x, dtype, data_parallel=None):
        def cn(conv_m, norm_m, h):
            return _conv_norm(conv_m, norm_m, self.norm_fn, h, dtype,
                              self.training, data_parallel)
        y = torch.relu(cn(self.conv1, self.norm1, x))
        y = torch.relu(cn(self.conv2, self.norm2, y))
        if self.downsample is not None:
            norm3 = self.downsample[1] if len(self.downsample) > 1 else None
            x = cn(self.downsample[0], norm3, x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 encoder.  fnet: output_dim=256, 'instance'; cnet:
    output_dim=256, 'batch' (reference network.py:64-65)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.norm_fn = norm_fn
        self.dtype = dtype
        self.dropout = dropout
        self.conv1 = nn.Conv2d(3, STEM_DIM, 7, 2, 3)
        self.norm1 = _norm(norm_fn, STEM_DIM)
        in_planes = STEM_DIM
        for i, (dim, stride) in enumerate(STAGE_DIMS):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.conv2 = nn.Conv2d(in_planes, output_dim, 1)

    def forward(self, x: torch.Tensor, generator=None,
                data_parallel=None) -> torch.Tensor:
        """x: [B, H, W, 3] NHWC -> [B, H/8, W/8, output_dim] NHWC.
        `generator` draws the training Dropout2d mask; `data_parallel` (a
        group) gives train-mode BatchNorm its ranks' moments."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = torch.relu(_conv_norm(self.conv1, self.norm1, self.norm_fn, x, dt,
                                  self.training, data_parallel))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, dt, data_parallel)
        x = conv(self.conv2, x, dt).permute(0, 2, 3, 1)
        if self.training:
            x = dropout2d(x, self.dropout, generator)
        return x
