"""SETrans attention stack, the three sites of the CRAFT model (PyTorch port
of ``craft_tpu.nn.setrans``; reference core/setrans.py:71-800).

In eval mode (serving):
  * inter-frame correlation (out_attn_scores_only): the clamped,
    mode-aggregated, globally normed volume from kernel B3;
  * f2 semantic smoothing (feature output, input skip): flash attention B2
    feeding ExpandedFeatTrans;
  * intra-frame attention (out_attn_probs_only): probs from B4, int8 with a
    row scale (QuantizedProbs) when the site quantizes.
In train mode every site is differentiable: the inter site gives the raw
aggregated volume of B6 (its backward a kernel too), the f2 and intra sites
float probs in the compute dtype from B4 with B7 as their backward
(``quantize_probs`` is ignored), then attention dropout; the f2 site feeds
the materialized probs to ExpandedFeatTrans.  Hidden dropout follows the
token layer norm of every site.  The conditional clamp (only when the
batch-global max exceeds attn_clip, reference setrans.py:527-529) takes its
predicate from B1 on detached q and k, and stays on the device.  Module and
parameter names are the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from craft_tpu_torch.config import SETransSiteConfig
from craft_tpu_torch.nn.layers import dropout, layer_norm, linear
from craft_tpu_torch.ops.kernels.corr_vjp import fused_agg_corr_diff
from craft_tpu_torch.ops.kernels.mode_attention import (
    flash_mode_attention, fused_agg_corr_norm, mode_softmax_probs,
    scores_global_max)
from craft_tpu_torch.ops.kernels.probs_vjp import mode_softmax_probs_diff


class SlidingBias(NamedTuple):
    """The (2R+1)^2 sliding-bias window plus the token grid it spans."""

    biases: torch.Tensor  # [2R+1, 2R+1]
    H: int
    W: int


class QuantizedProbs(NamedTuple):
    """int8 fixed-point probs: probs = num * scale, num = round(exp(s -
    rowmax) * 127), scale = 1 / (127 * l) per row."""

    num: torch.Tensor    # [B, M, U, U] int8
    scale: torch.Tensor  # [B, M, U, 1] fp32


class SlidingPosBiases2D(nn.Module):
    """Learnable (2R+1)x(2R+1) relative position bias (reference
    setrans.py:644-708)."""

    def __init__(self, radius: int = 7):
        super().__init__()
        self.biases = nn.Parameter(torch.zeros(2 * radius + 1,
                                               2 * radius + 1))

    def forward(self, H: int, W: int) -> SlidingBias:
        return SlidingBias(self.biases, H, W)


class InputFeatEncoder(nn.Module):
    """NHWC -> [B, U, C] layer-normed tokens (hidden dropout in training),
    plus the sliding bias (reference SETransInputFeatEncoder,
    setrans.py:710-800)."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        if cfg.pos_code_type != "bias":
            raise NotImplementedError(f"pos_code_type {cfg.pos_code_type}")
        self.dtype = dtype
        self.hidden_dropout_prob = cfg.hidden_dropout_prob
        self.pos_coder = SlidingPosBiases2D(cfg.pos_bias_radius)

    def forward(self, vis_feat: torch.Tensor, generator=None):
        B, H, W, C = vis_feat.shape
        tokens = layer_norm(vis_feat.reshape(B, H * W, C), dtype=self.dtype)
        if self.training:
            tokens = dropout(tokens, self.hidden_dropout_prob, generator)
        return tokens, self.pos_coder(H, W)


class LearnedSoftAggregate(nn.Module):
    """Learned softmax pooling over the modes axis (reference
    setrans.py:279-300) with a linear score over the trailing features.
    With num_feat=1 (the attention sites) only its scalar (w, b) is used,
    by kernel B3."""

    def __init__(self, num_feat: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.feat2score = nn.Linear(num_feat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scores = linear(self.feat2score, x, self.dtype)  # [.., 1]
        probs = torch.softmax(scores.float(), dim=1).to(x.dtype)
        return (x * probs).sum(dim=1)

    def scalar_wb(self):
        """(w, b) of the scalar score function, as device tensors."""
        return self.feat2score.weight[0, 0], self.feat2score.bias[0]


class ExpandedFeatTrans(nn.Module):
    """Multi-mode value expansion + mode pooling + input skip (reference
    setrans.py:304-410), without the FFN (has_FFN=False on every main-path
    site) and with softmax mode pooling (every site's).  input_feat:
    [B, U2, C]; attention: probs [B, M, U1, U2], QuantizedProbs, or None with
    `attention_fn` mapping v [B, M, U2, F] to [B, M, U1, F]."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        if cfg.has_FFN or cfg.pool_modes_feat != "softmax":
            raise NotImplementedError(
                "ExpandedFeatTrans with has_FFN or pool_modes_feat="
                f"{cfg.pool_modes_feat!r}")
        self.cfg = cfg
        self.dtype = dtype
        M, F = cfg.num_modes, cfg.feat_dim
        self.first_linear = nn.Linear(cfg.in_feat_dim, M * F,
                                      bias=cfg.v_has_bias)
        self.feat_softaggr = LearnedSoftAggregate(F, dtype=dtype)
        if cfg.has_input_skip:
            self.input_skip_coeff = nn.Parameter(torch.ones(1))

    def forward(self, input_feat, attention=None, attention_fn=None):
        cfg, dt = self.cfg, self.dtype
        B, U2, _ = input_feat.shape
        M, F = cfg.num_modes, cfg.feat_dim
        v = linear(self.first_linear, input_feat, dt)
        v = v.reshape(B, U2, M, F).permute(0, 2, 1, 3)  # [B, M, U2, F]
        if attention_fn is not None:
            fused = attention_fn(v.contiguous())
        elif isinstance(attention, QuantizedProbs):
            # The per-row dequant scale is linear in the row: it lands on
            # the product's output (setrans.py:841-849).
            fused = (attention.num.to(dt) @ v) * attention.scale.to(dt)
        else:
            fused = attention.to(dt) @ v
        pooled = self.feat_softaggr(fused)
        if cfg.has_input_skip:
            pooled = self.input_skip_coeff.to(dt) * input_feat + pooled
            pooled = layer_norm(pooled, dtype=dt)
        return pooled


class CrossAttFeatTrans(nn.Module):
    """Multi-mode attention (reference setrans.py:412-566) for the three
    main-path sites; see the module docstring."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        M, md = cfg.num_modes, cfg.mode_dim
        self.query = nn.Linear(cfg.in_feat_dim, M * md,
                               bias=cfg.qk_have_bias)
        if cfg.tie_qk_scheme == "shared":
            self.key = self.query  # one parameter (reference tie_qk)
        else:
            self.key = nn.Linear(cfg.in_feat_dim, M * md,
                                 bias=cfg.qk_have_bias)
        if M > 1 and cfg.out_attn_only:
            # Used by the scores-only site; the probs-only site keeps it for
            # state-dict parity with the reference (setrans.py:432-436).
            self.attn_softaggr = LearnedSoftAggregate(1)
        if not cfg.out_attn_only:
            self.out_trans = ExpandedFeatTrans(cfg, dtype)

    def _qk(self, query_feat, key_feat):
        cfg = self.cfg
        M, md = cfg.num_modes, cfg.mode_dim
        B, U1, _ = query_feat.shape
        U2 = key_feat.shape[1]
        q = linear(self.query, query_feat, self.dtype)
        k = linear(self.key, key_feat, self.dtype)
        q = q.reshape(B, U1, M, md).permute(0, 2, 1, 3).contiguous()
        k = k.reshape(B, U2, M, md).permute(0, 2, 1, 3).contiguous()
        return q, k

    def _clip(self, q, k):
        gmax = scores_global_max(q.detach(), k.detach(),
                                 1.0 / math.sqrt(self.cfg.mode_dim))
        return torch.where(gmax > self.cfg.attn_clip,
                           torch.full_like(gmax, self.cfg.attn_clip),
                           torch.full_like(gmax, 1e30))

    def forward(self, query_feat, key_feat=None, pos_biases=None,
                out_dtype=None, generator=None):
        """Scores-only site: the normed [B, U1, U2] volume in `out_dtype`
        (eval), or the raw fp32 one (train).  Probs-only site: [B, M, U1,
        U2] probs or QuantizedProbs.  Feature site: [B, U1, F].
        `generator` draws the attention dropout in training."""
        cfg = self.cfg
        if key_feat is None:
            key_feat = query_feat
        q, k = self._qk(query_feat, key_feat)
        if self.training:
            return self._train_forward(q, k, key_feat, pos_biases, generator)
        grid_hw = (pos_biases.H, pos_biases.W)
        if cfg.out_attn_scores_only:
            agg_w, agg_b = self.attn_softaggr.scalar_wb()
            vol, _ = fused_agg_corr_norm(
                q, k, pos_biases.biases, grid_hw, cfg.attn_clip,
                cfg.pos_code_weight, agg_w, agg_b,
                out_dtype=out_dtype or torch.float32)
            return vol
        clip = self._clip(q, k)
        if cfg.out_attn_probs_only:
            if cfg.quantize_probs:
                return QuantizedProbs(*mode_softmax_probs(
                    q, k, pos_biases.biases, grid_hw, clip,
                    cfg.pos_code_weight, quantized=True))
            return mode_softmax_probs(q, k, pos_biases.biases, grid_hw, clip,
                                      cfg.pos_code_weight,
                                      out_dtype=self.dtype)

        def attention_fn(v):
            return flash_mode_attention(q, k, v, pos_biases.biases, grid_hw,
                                        clip, cfg.pos_code_weight)

        return self.out_trans(key_feat, attention_fn=attention_fn)

    def _train_forward(self, q, k, key_feat, pos_biases, generator):
        cfg = self.cfg
        grid_hw = (pos_biases.H, pos_biases.W)
        clip = self._clip(q, k)
        if cfg.out_attn_scores_only:
            agg_w, agg_b = self.attn_softaggr.scalar_wb()
            return fused_agg_corr_diff(q, k, pos_biases.biases, clip,
                                       cfg.pos_code_weight, agg_w, agg_b,
                                       grid_hw)
        probs = mode_softmax_probs_diff(q, k, pos_biases.biases, clip,
                                        cfg.pos_code_weight, grid_hw)
        probs = dropout(probs, cfg.attention_probs_dropout_prob, generator)
        if cfg.out_attn_probs_only:
            return probs
        return self.out_trans(key_feat, attention=probs)


class SelfAttVisPosTrans(nn.Module):
    """Self-attention over an NHWC feature map (reference setrans.py:568-619):
    encode -> CrossAttFeatTrans -> NHWC (unless attention-only output)."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.vispos_encoder = InputFeatEncoder(cfg, dtype)
        self.setrans = CrossAttFeatTrans(cfg, dtype)

    def forward(self, x: torch.Tensor, generator=None):
        B, H, W, C = x.shape
        tokens, pos_biases = self.vispos_encoder(x, generator)
        out = self.setrans(tokens, pos_biases=pos_biases,
                           generator=generator)
        if not self.cfg.out_attn_only:
            out = out.reshape(B, H, W, C)
        return out
