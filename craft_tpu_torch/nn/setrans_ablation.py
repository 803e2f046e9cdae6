"""The SETrans research ablations (PyTorch port of
``craft_tpu.nn.setrans_ablation``; reference core/setrans_ablation.py:8-251):
the positional codes 'zero', 'rand' and 'sinu' of ``InputFeatEncoder``, and
the standard multi-head attention in place of ExpandedFeatTrans
(``ablate_multihead``; num_modes is read as the head count).

None of the codes gives a sliding bias, so a site under them routes as a
site under 'lsinu' does: the dense-table kernels without a table in eval
(B8 at the f2 site, B6 dense at the inter site, B4 dense at the intra
site), the plain sites in training.  A site under ``ablate_multihead``
takes the plain path, eval and training, as the JAX package's XLA path
(``craft_tpu/nn/setrans.py:550, 624``).

The 'rand' table is sized at construction for RAND_GRID, the reference
RandPosEmbedder's default of 36 x 36 tokens (H/8 x W/8).  The JAX package
sizes it by the grid of its init (``craft_tpu/nn/setrans.py:253-257``), so a state dict loaded into
the port brings its own table, and the parameter takes that table's size,
whatever it is.  A forward reads its first H W rows and raises past the
table, as the JAX lookup cannot read past it either.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from craft_tpu_torch.config import SETransSiteConfig
from craft_tpu_torch.nn.layers import dropout, layer_norm, linear

RAND_GRID = (36, 36)


@functools.lru_cache(maxsize=16)
def positional_encoding_2d(pos_embed_dim: int, height: int,
                           width: int) -> np.ndarray:
    """Fixed 2D sinusoidal table [H, W, C]: the first half of the channels
    encodes x (width), the second half y (height), sin and cos interleaved
    (reference setrans_ablation.py:8-30)."""
    assert pos_embed_dim % 4 == 0
    pe = np.zeros((pos_embed_dim, height, width), np.float32)
    half = pos_embed_dim // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(width, axis=2)
    pe[half + 1::2] = np.cos(pos_h * div).T[:, :, None].repeat(width,
                                                                axis=2)
    return pe.transpose(1, 2, 0)


class ZeroEmbedder(nn.Module):
    """pos_code_type='zero': no positional code (zeros)."""

    def __init__(self, pos_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.pos_embed_dim, self.dtype = pos_embed_dim, dtype

    def forward(self, pos_normed: torch.Tensor, H: int, W: int):
        return pos_normed.new_zeros(1, H * W, self.pos_embed_dim,
                                    dtype=self.dtype)


class SinuPosEmbedder(nn.Module):
    """pos_code_type='sinu': the fixed 2D sinusoidal table of the forward's
    grid, cast to `dtype` (reference setrans_ablation.py:49-61)."""

    def __init__(self, pos_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.pos_embed_dim, self.dtype = pos_embed_dim, dtype

    def forward(self, pos_normed: torch.Tensor, H: int, W: int):
        pe = positional_encoding_2d(self.pos_embed_dim, H, W)
        return torch.from_numpy(pe.reshape(1, H * W, -1)).to(
            pos_normed.device, self.dtype)


class RandPosEmbedder(nn.Module):
    """pos_code_type='rand': a learned table of one row a token, N(0, 1) at
    init, read in token order and layer-normed without affine (reference
    setrans_ablation.py:32-47).  See the module docstring for its size."""

    def __init__(self, pos_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pos_embed = nn.Parameter(
            torch.randn(RAND_GRID[0] * RAND_GRID[1], pos_embed_dim))

    def _load_from_state_dict(self, state_dict, prefix, *args):
        table = state_dict.get(prefix + "pos_embed")
        if table is not None and table.shape != self.pos_embed.shape:
            self.pos_embed = nn.Parameter(torch.empty_like(
                table, device=self.pos_embed.device))
        super()._load_from_state_dict(state_dict, prefix, *args)

    def forward(self, pos_normed: torch.Tensor, H: int, W: int):
        N = H * W
        if N > self.pos_embed.shape[0]:
            raise ValueError(
                f"pos_code_type 'rand': a {H} x {W} grid reads {N} rows of "
                f"a table of {self.pos_embed.shape[0]}")
        return layer_norm(self.pos_embed[None, :N], dtype=self.dtype)


class MultiHeadFeatTrans(nn.Module):
    """ablate_multihead: the standard multi-head attention output in place
    of ExpandedFeatTrans (reference setrans_ablation.py:181-251): values of
    feat_dim / num_modes a head, the probs product, then per head a shared
    intermediate linear + exact GELU + output linear with the residual,
    dropout (training) and a layer norm with affine (fp32 out), and the
    heads concatenated, not pooled.  input_feat: [B, U2, C]; attention:
    probs [B, M, U1, U2]; returns [B, U1, F] fp32."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        M, dh = cfg.num_modes, cfg.feat_dim // cfg.num_modes
        self.first_linear = nn.Linear(cfg.in_feat_dim, dh * M)
        self.intermediate = nn.Linear(dh, dh)
        self.output = nn.Linear(dh, dh)
        self.resout_norm = nn.LayerNorm(dh, eps=1e-12)

    def forward(self, input_feat, attention, generator=None):
        cfg, dt = self.cfg, self.dtype
        B, U2, _ = input_feat.shape
        M = cfg.num_modes
        dh = cfg.feat_dim // M
        v = linear(self.first_linear, input_feat, dt)
        v = v.reshape(B, U2, M, dh).permute(0, 2, 1, 3)  # [B, M, U2, dh]
        x = attention.to(dt) @ v                          # [B, M, U1, dh]
        mid = F.gelu(linear(self.intermediate, x, dt))
        out = linear(self.output, mid, dt) + x
        if self.training:
            out = dropout(out, cfg.hidden_dropout_prob, generator)
        out = layer_norm(out, self.resout_norm.weight, self.resout_norm.bias,
                         dtype=torch.float32)
        U1 = out.shape[2]
        return out.permute(0, 2, 1, 3).reshape(B, U1, M * dh)
