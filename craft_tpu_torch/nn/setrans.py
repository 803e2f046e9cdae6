"""SETrans attention stack, the three sites of the CRAFT model (PyTorch port
of ``craft_tpu.nn.setrans``; reference core/setrans.py:71-800).

In eval mode (serving), with the sliding positional bias
(pos_code_type='bias'):
  * inter-frame correlation (out_attn_scores_only): the clamped,
    mode-aggregated, globally normed volume from kernel B3;
  * f2 semantic smoothing (feature output, input skip): flash attention B2
    feeding ExpandedFeatTrans;
  * intra-frame attention (out_attn_probs_only): probs from B4, int8 with a
    row scale (QuantizedProbs) when the site quantizes; or, when the probs
    would pass LAZY_PROBS_BYTES (B * M * U1 * U2 * the compute dtype's
    itemsize, as the JAX package counts them: HD1K, 1088x1920 frames,
    Sintel batches of 11, or 6 under fp32), no probs at all but a
    LazyModeAttention (q, k, the window, the clamp), which the motion
    aggregator applies through B2 against each iteration's values.
With learned sinusoid codes (pos_code_type='lsinu') the positions are added
to the tokens and no bias reaches the scores, and an f2 site with
attn_mask_radius > 0 (--f2radius) adds a dense table: pos_w * the dense
sliding bias + the -1e9 mask, built once per forward on the device.  Those
sites take the dense-table kernels: the inter site the raw fp32 volume of
B6 dense (normed by the caller's build_pyramid), the f2 site B8, the intra
site float probs in the compute dtype from B4 dense (``quantize_probs`` is
ignored, as the JAX package's XLA softmax does).
Under sequence parallelism (eval, sliding bias) each site takes `shard`, this
rank's RowShard of the grid: queries from its rows, keys and values from
every token, through the same kernels with the shard's row offset and the
clamp predicate all-maxed over the ranks; the inter site gives the shard's
rows of the normed volume (B9 in place of B3,
``craft_tpu_torch.parallel.sequence_parallel``), the intra site the shard's
rows of the probs, and the f2 site its rows of the output gathered to every
rank.
In train mode every site is differentiable.  With the sliding bias and no
mask the sites take the training kernels: the inter site gives the raw
aggregated volume of B6 (its backward a kernel too), the f2 and intra sites
float probs in the compute dtype from B4 with B7 as their backward
(``quantize_probs`` is ignored), then attention dropout; the f2 site feeds
the materialized probs to ExpandedFeatTrans.  A site without a sliding
bias (lsinu) or with a mask (--f2radius), and every site when an
AttentionDiagnostics collects (--attn_diag), trains through stock autograd
over the materialised fp32 scores instead, the JAX package's XLA path:
clamp, + pos_w * the dense sliding bias, + the mask, then the mode
aggregation (inter) or the softmax and dropout (f2, intra).  Hidden
dropout follows the token layer norm of every site; drop_path_prob drops
whole samples of the f2 site's pooled output before its input skip.  The
conditional clamp (only when the batch-global max exceeds attn_clip,
reference setrans.py:527-529) takes its predicate from B1 on detached q
and k on the kernel paths, and stays on the device.  Module and parameter
names are the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from craft_tpu_torch.config import SETransSiteConfig
from craft_tpu_torch.nn.layers import (drop_path, dropout, layer_norm,
                                       linear)
from craft_tpu_torch.ops.kernels.corr_vjp import (fused_agg_corr_dense,
                                                  fused_agg_corr_diff)
from craft_tpu_torch.ops.kernels.mode_attention import (
    flash_mode_attention, flash_mode_attention_dense, fused_agg_corr_norm,
    mode_softmax_probs, mode_softmax_probs_dense, scores_global_max,
    sliding_pos_biases)
from craft_tpu_torch.ops.kernels.probs_vjp import mode_softmax_probs_diff
from craft_tpu_torch.parallel.sequence_parallel import \
    sp_fused_agg_corr_norm_mt

NOT_PORTED_SP = (
    "sequence parallelism in training, with pos_code_type='lsinu' or with "
    "an f2 attention mask (--seq_parallel with --interpos/--intrapos lsinu "
    "or --f2radius) is not ported to craft_tpu_torch yet: see ROADMAP.md "
    "section 2, item 8.")


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


# The intra site hands its consumer a LazyModeAttention in place of probs
# whose B * M * U1 * U2 * itemsize(compute dtype) bytes would pass this:
# the JAX package's threshold (craft_tpu/nn/setrans.py:725-726).
LAZY_PROBS_BYTES = 4e9


def probs_go_lazy(B: int, M: int, U1: int, U2: int, dtype) -> bool:
    """Whether [B, M, U1, U2] intra probs in the site's compute dtype would
    pass LAZY_PROBS_BYTES (counted in that dtype even where the stored
    probs are int8, as the JAX package counts them)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return B * M * U1 * U2 * itemsize > LAZY_PROBS_BYTES


class LazyModeAttention(NamedTuple):
    """The intra attention held as (q, k, the sliding window, the clamp)
    in place of [B, M, U, U] probs (the JAX package's LazyModeAttention,
    craft_tpu/nn/setrans.py:131-160): the motion aggregator re-runs the
    attention (B2) against each iteration's values, so the probs never
    exist."""

    q: torch.Tensor       # [B, M, U, md]
    k: torch.Tensor       # [B, M, U, md]
    biases: torch.Tensor  # [2R+1, 2R+1] sliding window
    H: int
    W: int
    clip: torch.Tensor    # 0-d: attn_clip, or 1e30 (no clamp)
    pos_w: float


class AttentionDiagnostics:
    """Attention-health telemetry of one forward (the JAX package's
    'diagnostics' sows, craft_tpu/nn/setrans.py:347-354, and their summary,
    craft_tpu/training/train_step.py:52-72).  Passed down a training
    forward, it sends every site through the plain path, where each records
    its raw max score, its mean |score| after the clamp and the share of
    scores at the clip, as 0-d device tensors (no host copy).  Read
    ``summary()`` before the backward: under remat_att_sites the recompute
    records the sites again."""

    def __init__(self):
        self.sites = []

    def record(self, max_attn: torch.Tensor, scores: torch.Tensor,
               clip: float) -> None:
        with torch.no_grad():
            a = scores.abs()
            clamped = (a >= clip).sum(dtype=torch.float64) / a.numel()
            self.sites.append((max_attn.float(), a.mean(),
                               clamped.float()))

    def summary(self) -> dict:
        """attn_max (the max over the sites), attn_clamp_frac and
        attn_avg_abs (their means)."""
        max_attn, avg_abs, clamp_frac = (torch.stack(v)
                                         for v in zip(*self.sites))
        return {"attn_max": max_attn.max(),
                "attn_clamp_frac": clamp_frac.mean(),
                "attn_avg_abs": avg_abs.mean()}


class SlidingPosBiases2D(nn.Module):
    """Learnable (2R+1)x(2R+1) relative position bias (reference
    setrans.py:644-708)."""

    def __init__(self, radius: int = 7):
        super().__init__()
        self.biases = nn.Parameter(torch.zeros(2 * radius + 1,
                                               2 * radius + 1))

    def forward(self, H: int, W: int) -> SlidingBias:
        return SlidingBias(self.biases, H, W)


def attention_mask(H: int, W: int, radius: int, device=None) -> torch.Tensor:
    """The f2 site's local attention mask (reference setrans.py:568-619, the
    JAX package's setrans.py:922-928): fp32 [H*W, H*W], -1e9 where the
    Chebyshev distance of two tokens exceeds `radius`, else 0."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    coords = torch.stack([ys, xs], dim=-1).reshape(H * W, 2)
    diff = (coords[None] - coords[:, None]).abs().amax(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(diff > radius, torch.full_like(zero, -1e9), zero)


class LearnedSinuPosEmbedder(nn.Module):
    """pos_code_type='lsinu' (reference setrans.py:623-642): Linear(2 -> C)
    in fp32, sin of the even columns and cos of the odd ones, interleaved
    (out[2i] = sin(p[2i]), out[2i+1] = cos(p[2i+1])), then a layer norm
    without affine, cast to `dtype`."""

    def __init__(self, pos_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pos_fc = nn.Linear(2, pos_embed_dim)

    def forward(self, pos_normed: torch.Tensor) -> torch.Tensor:
        p = linear(self.pos_fc, pos_normed.float(), torch.float32)
        mixed = torch.stack([torch.sin(p[..., 0::2]),
                             torch.cos(p[..., 1::2])], dim=-1).reshape(p.shape)
        return layer_norm(mixed, dtype=self.dtype)


class InputFeatEncoder(nn.Module):
    """NHWC -> [B, U, C] layer-normed tokens (hidden dropout in training),
    plus the positional code (reference SETransInputFeatEncoder,
    setrans.py:710-800): the sliding bias for pos_code_type='bias', or, for
    'lsinu', learned sinusoid codes of the token coordinates added to the
    tokens before the layer norm, and no bias (None)."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pos_code_type = cfg.pos_code_type
        self.pos_code_weight = cfg.pos_code_weight
        self.hidden_dropout_prob = cfg.hidden_dropout_prob
        if cfg.pos_code_type == "bias":
            self.pos_coder = SlidingPosBiases2D(cfg.pos_bias_radius)
        elif cfg.pos_code_type == "lsinu":
            self.pos_coder = LearnedSinuPosEmbedder(cfg.in_feat_dim, dtype)
        else:
            raise NotImplementedError(f"pos_code_type {cfg.pos_code_type}")

    def forward(self, vis_feat: torch.Tensor, generator=None):
        B, H, W, C = vis_feat.shape
        tokens = vis_feat.reshape(B, H * W, C)
        pos_biases = None
        if self.pos_code_type == "bias":
            pos_biases = self.pos_coder(H, W)
        else:
            # (y, x) over the one global max of both axes, as the reference.
            ys, xs = torch.meshgrid(
                torch.arange(H, dtype=torch.float32, device=tokens.device),
                torch.arange(W, dtype=torch.float32, device=tokens.device),
                indexing="ij")
            coords = torch.stack([ys, xs], dim=-1).reshape(1, H * W, 2)
            coords = coords / max(H - 1, W - 1, 1)
            tokens = tokens + self.pos_code_weight * self.pos_coder(coords)
        tokens = layer_norm(tokens, dtype=self.dtype)
        if self.training:
            tokens = dropout(tokens, self.hidden_dropout_prob, generator)
        return tokens, pos_biases


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
    [B, U2, C]; attention: probs [B, M, U1, U2], QuantizedProbs,
    LazyModeAttention (B2 against v, its output in the compute dtype, as
    craft_tpu/nn/setrans.py:826-836), or None with `attention_fn` mapping
    v [B, M, U2, F] to [B, M, U1, F].  In training, drop_path_prob drops
    whole samples of the pooled output (drawn from `generator`) before the
    input skip.  Under
    sequence parallelism U1 is the `shard`'s rows: the input skip takes
    those rows of input_feat, and the output is gathered to every rank as
    [B, U2, F]."""

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

    def forward(self, input_feat, attention=None, attention_fn=None,
                shard=None, generator=None):
        cfg, dt = self.cfg, self.dtype
        B, U2, _ = input_feat.shape
        M, F = cfg.num_modes, cfg.feat_dim
        v = linear(self.first_linear, input_feat, dt)
        v = v.reshape(B, U2, M, F).permute(0, 2, 1, 3)  # [B, M, U2, F]
        if attention_fn is not None:
            fused = attention_fn(v.contiguous())
        elif isinstance(attention, LazyModeAttention):
            la = attention
            fused = flash_mode_attention(
                la.q.to(dt), la.k.to(dt), v.contiguous(), la.biases,
                (la.H, la.W), la.clip, la.pos_w).to(dt)
        elif isinstance(attention, QuantizedProbs):
            # The per-row dequant scale is linear in the row: it lands on
            # the product's output (setrans.py:841-849).
            fused = (attention.num.to(dt) @ v) * attention.scale.to(dt)
        else:
            fused = attention.to(dt) @ v
        pooled = self.feat_softaggr(fused)
        if cfg.has_input_skip:
            if self.training:
                pooled = drop_path(pooled, cfg.drop_path_prob, generator)
            skip = input_feat if shard is None else shard.tokens(input_feat)
            pooled = self.input_skip_coeff.to(dt) * skip + pooled
            pooled = layer_norm(pooled, dtype=dt)
        return pooled if shard is None else shard.gather(pooled)


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

    def _clip(self, q, k, shard=None):
        """The clamp: attn_clip where the raw max of the scores (over every
        rank's rows under `shard`) exceeds it, else none (1e30)."""
        scale = 1.0 / math.sqrt(self.cfg.mode_dim)
        gmax = scores_global_max(q.detach(), k.detach(), scale)
        if shard is not None:
            gmax = shard.all_max(gmax)
        return torch.where(gmax > self.cfg.attn_clip,
                           torch.full_like(gmax, self.cfg.attn_clip),
                           torch.full_like(gmax, 1e30))

    def forward(self, query_feat, key_feat=None, pos_biases=None,
                out_dtype=None, generator=None, attention_mask=None,
                shard=None, diagnostics=None):
        """Scores-only site: the normed [B, U1, U2] volume in `out_dtype`
        (eval with the sliding bias), or the raw fp32 one (train, or no
        sliding bias).  Probs-only site: [B, M, U1, U2] probs or
        QuantizedProbs, or a LazyModeAttention where the probs would pass
        LAZY_PROBS_BYTES (eval with the sliding bias, no `shard`: under
        sequence parallelism the JAX package materialises them too).
        Feature site: [B, U1, F].  `pos_biases` is a
        SlidingBias or None (pos_code_type 'lsinu'); `attention_mask` an
        additive fp32 [U1, U2] table (the f2 site's --f2radius) or None.
        `generator` draws the attention dropout in training.  `shard` (a
        RowShard) takes the queries from this rank's rows of query_feat.
        `diagnostics` (an AttentionDiagnostics, training) records the
        scores' telemetry and sends the site through the plain path."""
        cfg = self.cfg
        if key_feat is None:
            key_feat = query_feat
        dense = pos_biases is None or attention_mask is not None
        if shard is not None and (self.training or dense):
            raise NotImplementedError(NOT_PORTED_SP)
        q, k = self._qk(query_feat if shard is None
                        else shard.tokens(query_feat), key_feat)
        if self.training:
            if dense or diagnostics is not None:
                return self._plain_train_forward(q, k, key_feat, pos_biases,
                                                 attention_mask, generator,
                                                 diagnostics)
            return self._train_forward(q, k, key_feat, pos_biases, generator)
        if dense:
            return self._dense_forward(q, k, key_feat, pos_biases,
                                       attention_mask)
        grid_hw = (pos_biases.H, pos_biases.W)
        q_row0 = 0 if shard is None else shard.h0
        if cfg.out_attn_scores_only:
            agg_w, agg_b = self.attn_softaggr.scalar_wb()
            out_dtype = out_dtype or torch.float32
            if shard is not None:
                return sp_fused_agg_corr_norm_mt(
                    shard, q, k, pos_biases.biases, cfg.attn_clip,
                    cfg.pos_code_weight, agg_w, agg_b, out_dtype=out_dtype)
            vol, _ = fused_agg_corr_norm(
                q, k, pos_biases.biases, grid_hw, cfg.attn_clip,
                cfg.pos_code_weight, agg_w, agg_b, out_dtype=out_dtype)
            return vol
        clip = self._clip(q, k, shard)
        if cfg.out_attn_probs_only:
            if shard is None and probs_go_lazy(*q.shape[:3], k.shape[2],
                                               self.dtype):
                return LazyModeAttention(q, k, pos_biases.biases, *grid_hw,
                                         clip, cfg.pos_code_weight)
            if cfg.quantize_probs:
                return QuantizedProbs(*mode_softmax_probs(
                    q, k, pos_biases.biases, grid_hw, clip,
                    cfg.pos_code_weight, quantized=True, q_row0=q_row0))
            return mode_softmax_probs(q, k, pos_biases.biases, grid_hw, clip,
                                      cfg.pos_code_weight,
                                      out_dtype=self.dtype, q_row0=q_row0)

        def attention_fn(v):
            return flash_mode_attention(q, k, v, pos_biases.biases, grid_hw,
                                        clip, cfg.pos_code_weight,
                                        q_row0=q_row0)

        return self.out_trans(key_feat, attention_fn=attention_fn,
                              shard=shard)

    def _dense_forward(self, q, k, key_feat, pos_biases, attention_mask):
        """Eval mode without a sliding bias (lsinu) or with an attention
        mask: the dense-table kernels.  A mask becomes one table, pos_w *
        the dense sliding bias (if any) + the mask, applied with pos_w = 1:
        the JAX package's XLA sum (setrans.py:675-680), computed by the
        kernel.  The inter site returns the raw fp32 volume, the intra site
        float probs in the compute dtype."""
        cfg = self.cfg
        table, pos_w = None, cfg.pos_code_weight
        if attention_mask is not None:
            table, pos_w = attention_mask, 1.0
            if pos_biases is not None:
                table = table + cfg.pos_code_weight * sliding_pos_biases(
                    pos_biases.biases.float(), pos_biases.H, pos_biases.W)
        clip = self._clip(q, k)
        if cfg.out_attn_scores_only:
            agg_w, agg_b = self.attn_softaggr.scalar_wb()
            return fused_agg_corr_dense(q, k, table, clip, pos_w, agg_w,
                                        agg_b)
        if cfg.out_attn_probs_only:
            return mode_softmax_probs_dense(q, k, table, clip, pos_w,
                                            out_dtype=self.dtype)

        def attention_fn(v):
            return flash_mode_attention_dense(q, k, v, table, clip, pos_w)

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
        return self.out_trans(key_feat, attention=probs, generator=generator)

    def _plain_train_forward(self, q, k, key_feat, pos_biases,
                             attention_mask, generator, diagnostics):
        """Training through stock autograd over the materialised scores,
        the JAX package's XLA path (craft_tpu/nn/setrans.py:335-367,
        437-470): scores in fp32, the clamp, + pos_w * the dense sliding
        bias, + the mask; the inter site's mode aggregation, or the f2 and
        intra sites' softmax, cast to the compute dtype, and dropout."""
        cfg = self.cfg
        # fp32 operands (an exact cast): the JAX einsum accumulates and
        # returns fp32, where a bf16 matmul would round the scores to bf16.
        scores = q.float() @ k.float().transpose(-1, -2) \
            / math.sqrt(cfg.mode_dim)
        max_attn = scores.detach().amax()
        scores = torch.where(max_attn > cfg.attn_clip,
                             scores.clamp(-cfg.attn_clip, cfg.attn_clip),
                             scores)
        if diagnostics is not None:
            diagnostics.record(max_attn, scores, cfg.attn_clip)
        if pos_biases is not None:
            scores = scores + cfg.pos_code_weight * sliding_pos_biases(
                pos_biases.biases.float(), pos_biases.H, pos_biases.W)
        if attention_mask is not None:
            scores = scores + attention_mask
        if cfg.out_attn_scores_only:
            agg_w, agg_b = self.attn_softaggr.scalar_wb()
            probs = torch.softmax(scores * agg_w + agg_b, dim=1)
            return (scores * probs).sum(dim=1)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        probs = dropout(probs, cfg.attention_probs_dropout_prob, generator)
        if cfg.out_attn_probs_only:
            return probs
        return self.out_trans(key_feat, attention=probs, generator=generator)


class SelfAttVisPosTrans(nn.Module):
    """Self-attention over an NHWC feature map (reference setrans.py:568-619):
    encode -> CrossAttFeatTrans -> NHWC (unless attention-only output), with
    the local attention mask when attn_mask_radius > 0.  Under sequence
    parallelism (`shard`) a feature site's output is the whole grid, gathered
    before the reshape; an attention-only site gives the shard's rows."""

    def __init__(self, cfg: SETransSiteConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.vispos_encoder = InputFeatEncoder(cfg, dtype)
        self.setrans = CrossAttFeatTrans(cfg, dtype)

    def forward(self, x: torch.Tensor, generator=None, shard=None,
                diagnostics=None):
        B, H, W, C = x.shape
        mask = None
        if self.cfg.attn_mask_radius > 0:
            mask = attention_mask(H, W, self.cfg.attn_mask_radius, x.device)
        tokens, pos_biases = self.vispos_encoder(x, generator)
        out = self.setrans(tokens, pos_biases=pos_biases,
                           generator=generator, attention_mask=mask,
                           shard=shard, diagnostics=diagnostics)
        if not self.cfg.out_attn_only:
            out = out.reshape(B, H, W, C)
        return out
