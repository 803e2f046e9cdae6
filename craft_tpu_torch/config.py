"""Typed configuration for the CRAFT model (PyTorch port).

A copy of the attention-site and model dataclasses of ``craft_tpu.config``
with torch dtypes, carrying the fields the port consumes.  Every attention
site (inter / f2 / intra) gets its own frozen dataclass with the reference
defaults baked in (reference core/network.py:44-130, core/setrans.py:71-157).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class SETransSiteConfig:
    """Config for one attention site (inter / f2 / intra)."""

    in_feat_dim: int = 256
    feat_dim: int = 256
    num_modes: int = 4
    # 'shared' ties the K projection to Q (one parameter, used twice).
    tie_qk_scheme: Optional[str] = "shared"
    qk_have_bias: bool = False
    v_has_bias: bool = False
    attn_clip: float = 100.0
    # 'bias' (the sliding window), 'lsinu' (learned sinusoid codes), or the
    # ablations 'zero', 'rand' (a learned table) and 'sinu' (fixed 2D
    # sinusoids), nn/setrans_ablation.py.
    pos_code_type: str = "bias"
    pos_code_weight: float = 1.0
    pos_bias_radius: int = 7
    # Output selector: at most one of these may be True.
    out_attn_scores_only: bool = False  # inter-frame correlation site
    out_attn_probs_only: bool = False   # intra-frame attention site
    has_FFN: bool = True
    has_input_skip: bool = False
    pool_modes_feat: str = "softmax"    # only softmax pooling is ported
    # The standard multi-head attention output (heads = num_modes) in place
    # of ExpandedFeatTrans at a feature site (nn/setrans_ablation.py).
    ablate_multihead: bool = False
    # Local attention mask radius in 1/8-res cells (<= 0 disables); f2 only.
    attn_mask_radius: int = -1
    # int8 fixed-point probs (p*127 with a per-row scale) for the
    # probs-only site; serving only (training takes float probs).
    quantize_probs: bool = False
    # Training dropout (reference setrans.py:110-111): on the layer-normed
    # tokens of every site, and on the probs of the f2 and intra sites.
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.2
    # Stochastic depth on the pooled output before the input skip
    # (reference setrans.py:42-69; off by default).
    drop_path_prob: float = 0.0

    @property
    def mode_dim(self) -> int:
        return self.in_feat_dim // self.num_modes

    @property
    def out_attn_only(self) -> bool:
        return self.out_attn_scores_only or self.out_attn_probs_only


def inter_corr_config(num_modes: int = 4, qk_have_bias: bool = True,
                      pos_code_type: str = "bias",
                      pos_code_weight: float = 0.5,
                      pos_bias_radius: int = 7) -> SETransSiteConfig:
    """Inter-frame attentional-correlation site (reference network.py:44-61)."""
    return SETransSiteConfig(
        in_feat_dim=256, feat_dim=256, num_modes=num_modes,
        tie_qk_scheme="shared", qk_have_bias=qk_have_bias,
        pos_code_type=pos_code_type, pos_code_weight=pos_code_weight,
        pos_bias_radius=pos_bias_radius,
        out_attn_scores_only=True, has_FFN=False, has_input_skip=False)


def f2_trans_config(num_modes: int = 4, pos_code_type: str = "bias",
                    pos_code_weight: float = 0.5, pos_bias_radius: int = 7,
                    attn_mask_radius: int = -1) -> SETransSiteConfig:
    """F2 semantic-smoothing self-attention site (reference network.py:67-92)."""
    return SETransSiteConfig(
        in_feat_dim=256, feat_dim=256, num_modes=num_modes,
        tie_qk_scheme=None, qk_have_bias=False, pos_code_type=pos_code_type,
        pos_code_weight=pos_code_weight, pos_bias_radius=pos_bias_radius,
        has_FFN=False, has_input_skip=True,
        attn_mask_radius=attn_mask_radius)


def intra_attn_config(num_modes: int = 4, pos_code_type: str = "bias",
                      pos_code_weight: float = 1.0,
                      pos_bias_radius: int = 7) -> SETransSiteConfig:
    """Intra-frame (--setrans) attention site (reference network.py:108-128)."""
    return SETransSiteConfig(
        in_feat_dim=128, feat_dim=128, num_modes=num_modes,
        tie_qk_scheme=None, qk_have_bias=False, pos_code_type=pos_code_type,
        pos_code_weight=pos_code_weight, pos_bias_radius=pos_bias_radius,
        out_attn_probs_only=True, has_FFN=False, has_input_skip=True)


def intra_aggregator_config(cfg: SETransSiteConfig) -> SETransSiteConfig:
    """The motion aggregator reuses the intra config but consumes the probs
    it is given (reference update.py:129-135): same dims, feature output.
    It runs deterministic in the JAX package (craft_tpu/nn/update.py:349),
    so it takes no drop_path."""
    return dataclasses.replace(cfg, out_attn_probs_only=False,
                               out_attn_scores_only=False, drop_path_prob=0.0)


@dataclass(frozen=True)
class ModelConfig:
    """Top-level model configuration (mirrors the reference CLI surface)."""

    arch: str = "craft"  # 'raft' | 'craft_nogma' | 'craft'
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    craft: bool = True
    f2trans: str = "full"   # 'none' | 'full' | 'half'
    f1trans: str = "none"   # 'none' | 'shared' | 'private'
    use_setrans: bool = True
    num_heads: int = 1            # GMA attention heads
    position_only: bool = False   # GMA attention: positions, no content
    position_and_content: bool = False
    gma_max_pos_size: int = 160   # GMA RelPosEmb tables of 2 * 160 - 1 rows
    inter: SETransSiteConfig = field(default_factory=inter_corr_config)
    f2: SETransSiteConfig = field(default_factory=f2_trans_config)
    intra: SETransSiteConfig = field(default_factory=intra_attn_config)
    dropout: float = 0.0          # fnet/cnet Dropout2d rate (training)
    mixed_precision: bool = True  # bf16 compute islands, fp32 correlation
    # 'all' (one [B, 8H, 8W, 2] field per iteration), 'packed' (the same
    # values as [B, H, W, 128], unpacked by the consumer) or 'final' (the
    # last iteration only; serving).
    upsample_mode: str = "all"
    # Training recomputes the f2 and intra sites in the backward
    # (torch.utils.checkpoint) instead of keeping their activations, as the
    # JAX package's nn.remat (the inter site is recomputed always).
    remat_att_sites: bool = True

    @property
    def corr_multiplier(self) -> int:
        return 2 if (self.f1trans != "none" and self.arch == "craft") else 1

    @property
    def cor_planes(self) -> int:
        return (self.corr_levels * self.corr_multiplier
                * (2 * self.corr_radius + 1) ** 2)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def raft_config(mixed_precision: bool = True,
                corr_radius: int = 4) -> ModelConfig:
    return ModelConfig(arch="raft", craft=False, f2trans="none",
                       f1trans="none", use_setrans=False,
                       corr_radius=corr_radius,
                       mixed_precision=mixed_precision)


def gma_config(mixed_precision: bool = True,
               num_heads: int = 1) -> ModelConfig:
    """GMA: the plain volume, GMA attention and GMAUpdateBlock."""
    return ModelConfig(arch="craft", craft=False, f2trans="none",
                       f1trans="none", use_setrans=False, num_heads=num_heads,
                       mixed_precision=mixed_precision)


def craft_nogma_config(mixed_precision: bool = True,
                       f2trans: str = "full") -> ModelConfig:
    """TransCorr and the f2 site without intra attention, and
    BasicUpdateBlock."""
    return ModelConfig(arch="craft_nogma", craft=True, f2trans=f2trans,
                       f1trans="none", use_setrans=False,
                       mixed_precision=mixed_precision)


def craft_config(mixed_precision: bool = True, use_setrans: bool = True,
                 f2trans: str = "full", f1trans: str = "none") -> ModelConfig:
    # int8 fixed-point intra probs ride with mixed precision (the serving
    # config); fp32 keeps exact float probs.
    intra = intra_attn_config()
    if mixed_precision:
        intra = dataclasses.replace(intra, quantize_probs=True)
    return ModelConfig(arch="craft", craft=True, f2trans=f2trans,
                       f1trans=f1trans, use_setrans=use_setrans,
                       mixed_precision=mixed_precision, intra=intra)
