"""The CRAFT flow model (PyTorch port of ``craft_tpu.models.flow_model``
for arch='craft' with f1trans='none'; reference core/network.py:26-267).

Forward: fnet/cnet encoders -> f2 transformer on frame 2 -> SETrans intra
attention probs (B4) -> the inter-frame volume as the pyramid base -> 12
refinement iterations of windowed lookup + GMAUpdateBlock + convex
upsampling.  In eval mode the volume is clamped, aggregated and normed in
one kernel call (B3).  In train mode (``model.train()``) it is the raw
differentiable volume of B6, normed by ``build_pyramid``; cnet's BatchNorm
takes batch statistics unless ``freeze_bn``; dropout draws from the
`generator` passed to forward.  The correlation is an fp32 island; pyramid
levels are stored bf16 under mixed precision; coords stay fp32 and are
detached every iteration.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from craft_tpu_torch import resolve_device
from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.nn.encoder import BasicEncoder
from craft_tpu_torch.nn.setrans import (CrossAttFeatTrans, InputFeatEncoder,
                                        SelfAttVisPosTrans)
from craft_tpu_torch.nn.update import GMAUpdateBlock
from craft_tpu_torch.ops.corr import (build_pyramid, corr_lookup,
                                      pyramid_from_level0)
from craft_tpu_torch.ops.geometry import convex_upsample, coords_grid


class TransCorr(nn.Module):
    """Cross-frame attentional correlation volume (reference
    corr.py:132-207): in eval mode the globally layer-normed [B, U1, U2]
    volume in `out_dtype`, ready to be the pyramid base; in train mode the
    raw [B, U1, U2] fp32 volume."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.vispos_encoder = InputFeatEncoder(cfg.inter, dtype)
        self.setrans = CrossAttFeatTrans(cfg.inter, dtype)

    def forward(self, fmap1, fmap2, out_dtype=torch.float32, generator=None):
        vispos1, pos_biases = self.vispos_encoder(fmap1, generator)
        vispos2, _ = self.vispos_encoder(fmap2, generator)
        return self.setrans(vispos1, vispos2, pos_biases=pos_biases,
                            out_dtype=out_dtype, generator=generator)


class FlowModel(nn.Module):
    """Full CRAFT: f2 transformer, SETrans intra attention, TransCorr.

    With ``freeze_bn`` set, train mode keeps cnet as in eval (BatchNorm on
    its running statistics, folded; no Dropout2d), as the JAX package's
    ``FlowModel(freeze_bn=True)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not (cfg.arch == "craft" and cfg.craft and cfg.use_setrans
                and cfg.f1trans == "none" and cfg.f2trans != "none"):
            raise NotImplementedError(
                "the port runs arch='craft' with TransCorr, SETrans intra "
                "attention, the f2 transformer and f1trans='none'")
        self.cfg = cfg
        self.freeze_bn = False
        cdt = cfg.compute_dtype
        self.fnet = BasicEncoder(256, "instance", cdt, cfg.dropout)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch",
                                 cdt, cfg.dropout)
        self.f2_trans = SelfAttVisPosTrans(cfg.f2, cdt)
        self.att = SelfAttVisPosTrans(cfg.intra, cdt)
        self.corr_fn = TransCorr(cfg, cdt)
        self.update_block = GMAUpdateBlock(cfg, cdt)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.freeze_bn:
            self.cnet.eval()
        return self

    def forward(self, image1, image2, iters: Optional[int] = None,
                flow_init=None, upsample_mode: Optional[str] = None,
                generator=None):
        """image1/image2: [B, H, W, 3] floats in [0, 255] on the model's
        device.  Returns (flow_lowres [B, H/8, W/8, 2], flows_up
        [iters, B, H, W, 2]); with upsample_mode='final' only the last
        iteration is upsampled and flows_up is [1, B, H, W, 2].
        `generator` (a ``torch.Generator`` on the model's device) draws
        every training dropout mask."""
        cfg = self.cfg
        iters = iters or cfg.iters
        upsample_mode = upsample_mode or cfg.upsample_mode
        if upsample_mode not in ("all", "final"):
            raise NotImplementedError(f"upsample_mode {upsample_mode}")
        cdt = cfg.compute_dtype
        lvl_dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        image1 = 2.0 * (image1.float() / 255.0) - 1.0
        image2 = 2.0 * (image2.float() / 255.0) - 1.0
        B, H, W, _ = image1.shape
        H8, W8 = H // 8, W // 8
        hdim = cfg.hidden_dim

        # The record_function ranges name the phases in a profiler trace.
        with record_function("craft.encoders"):
            fmaps = self.fnet(torch.cat([image1, image2], dim=0), generator)
            fmap1, fmap2 = fmaps[:B], fmaps[B:]
            cnet = self.cnet(image1, generator)
            net = torch.tanh(cnet[..., :hdim])
            inp = torch.relu(cnet[..., hdim:])
        with record_function("craft.f2_trans"):
            fmap2 = self.f2_trans(fmap2, generator)
            fmap1, fmap2 = fmap1.float(), fmap2.float()
        with record_function("craft.intra_attention"):
            attention = self.att(inp, generator)
        with record_function("craft.corr_volume"):
            if self.training:
                vol = self.corr_fn(fmap1, fmap2, generator=generator)
                pyramid = build_pyramid(
                    vol.reshape(B, H8 * W8, 1, H8 * W8), B, H8, W8,
                    cfg.corr_levels, cfg.corr_radius, do_global_norm=True,
                    level_dtype=lvl_dtype)
            else:
                vol = self.corr_fn(fmap1, fmap2, out_dtype=lvl_dtype)
                pyramid = pyramid_from_level0(vol, B, H8, W8,
                                              cfg.corr_levels,
                                              cfg.corr_radius,
                                              level_dtype=lvl_dtype)
            del vol

        coords0 = coords_grid(B, H8, W8, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        gru_static = self.update_block.precompute_gru_static(inp.to(cdt))

        flows_up = []
        for _ in range(iters):
            coords1 = coords1.detach()
            with record_function("craft.lookup"):
                corr = corr_lookup(pyramid, coords1)
            flow = coords1 - coords0
            with record_function("craft.update_block"):
                net, up_mask, delta = self.update_block(
                    net, inp, corr.to(cdt), flow.to(cdt), attention,
                    gru_static=gru_static)
            coords1 = coords1 + delta.float()
            if upsample_mode == "all":
                with record_function("craft.upsample"):
                    flows_up.append(convex_upsample(coords1 - coords0,
                                                    up_mask.float()))
        if upsample_mode == "final":
            up_mask = self.update_block.upsample_mask(net)
            flows_up.append(convex_upsample(coords1 - coords0,
                                            up_mask.float()))
        return coords1 - coords0, torch.stack(flows_up)


def create_model(cfg: ModelConfig, device=None) -> FlowModel:
    """The model in eval mode on `device` (default: CUDA; raises when CUDA
    is absent and no device was asked for)."""
    dev = resolve_device(device)
    return FlowModel(cfg).to(dev).eval()
