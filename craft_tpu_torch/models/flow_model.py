"""The CRAFT flow model (PyTorch port of ``craft_tpu.models.flow_model``
for arch='craft' with f1trans='none'; reference core/network.py:26-267).

Forward: fnet/cnet encoders -> f2 transformer on frame 2 -> SETrans intra
attention probs (B4; past 4e9 bytes of probs, as at HD1K's grid, a
LazyModeAttention instead, which each iteration's aggregator applies
through B2) -> the inter-frame volume as the pyramid base -> 12
refinement iterations of windowed lookup (B5, forward and, in training,
backward) + GMAUpdateBlock + convex upsampling.  In eval mode with the
sliding bias at the inter site the volume is clamped, aggregated and normed
in one kernel call (B3).  Otherwise (train mode, or an inter site under
pos_code_type 'lsinu') it is the raw volume (B6, or B6 dense in eval),
normed by ``build_pyramid``.  In train mode (``model.train()``) cnet's
BatchNorm takes batch statistics unless ``freeze_bn``; dropout draws from
the `generator` passed to forward.  In train mode the inter site, and with
``remat_att_sites`` (the default) the f2 and intra sites, keep none of
their activations: the backward recomputes them (``torch.utils.
checkpoint``) from the same dropout draws, as the JAX package's
``nn.remat``.  A forward given an ``AttentionDiagnostics`` (train mode)
runs every site through the plain path and records its telemetry.  The
correlation is an fp32 island; pyramid
levels are stored bf16 under mixed precision; coords stay fp32 and are
detached every iteration.

Under sequence parallelism (eval, sliding bias; ``seq_parallel``, a
``craft_tpu_torch.parallel.sp.SeqParallel`` group) each rank holds its
RowShard's query rows of the O(U^2) tensors: the intra probs, the normed
level 0 (B9) and the pyramid pooled from it (pooling runs over the key axis
only), and it runs the lookup on its rows of coords1 and the aggregator's
probs product on its rows; the f2 output, the lookup features and the
aggregated motion are gathered to every rank, and everything else (the
encoders, the projections, the update block's convs, GRU and upsampling)
runs on every rank as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

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
    corr.py:132-207): when ``prenormed()``, the globally layer-normed
    [B, U1, U2] volume in `out_dtype`, ready to be the pyramid base (B3);
    otherwise the raw [B, U1, U2] fp32 volume."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.pos_code_type = cfg.inter.pos_code_type
        self.vispos_encoder = InputFeatEncoder(cfg.inter, dtype)
        self.setrans = CrossAttFeatTrans(cfg.inter, dtype)

    def prenormed(self) -> bool:
        """Whether forward gives the normed volume: eval mode with the
        sliding bias, the static decision of ``craft_tpu/models/
        flow_model.py:219-225`` (there fp32 also takes the raw volume; the
        port keeps B3 for fp32, whose output it normalizes exactly)."""
        return not self.training and self.pos_code_type == "bias"

    def forward(self, fmap1, fmap2, out_dtype=torch.float32, generator=None,
                shard=None, diagnostics=None):
        vispos1, pos_biases = self.vispos_encoder(fmap1, generator)
        vispos2, _ = self.vispos_encoder(fmap2, generator)
        return self.setrans(vispos1, vispos2, pos_biases=pos_biases,
                            out_dtype=out_dtype, generator=generator,
                            shard=shard, diagnostics=diagnostics)


def recomputed(fn, generator, /, *args, **kwargs):
    """fn(*args, **kwargs) under ``torch.utils.checkpoint``: its activations
    are freed and recomputed in the backward.  ``checkpoint`` restores only
    the default generators, so the recompute also runs from `generator`'s
    state at this call (the same dropout masks), and leaves it where the
    backward found it."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    start = generator.get_state()
    calls = 0

    def run(*a, **kw):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a, **kw)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, **kw)
        finally:
            generator.set_state(resume)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


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
                generator=None, seq_parallel=None, data_parallel=None,
                diagnostics=None):
        """image1/image2: [B, H, W, 3] floats in [0, 255] on the model's
        device.  Returns (flow_lowres [B, H/8, W/8, 2], flows_up
        [iters, B, H, W, 2]); with upsample_mode='final' only the last
        iteration is upsampled and flows_up is [1, B, H, W, 2].
        `generator` (a ``torch.Generator`` on the model's device) draws
        every training dropout mask.  `seq_parallel` (a SeqParallel group,
        eval only) splits the grid's rows across its ranks; every rank
        returns the whole flow.  `data_parallel` (a group, training) makes
        cnet's BatchNorm take its moments over every rank's batch.
        `diagnostics` (an AttentionDiagnostics, training) collects the
        attention sites' telemetry."""
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
        shard = None if seq_parallel is None else seq_parallel.shard(H8, W8)

        # The record_function ranges name the phases in a profiler trace.
        with record_function("craft.encoders"):
            fmaps = self.fnet(torch.cat([image1, image2], dim=0), generator)
            fmap1, fmap2 = fmaps[:B], fmaps[B:]
            cnet = self.cnet(image1, generator, data_parallel)
            net = torch.tanh(cnet[..., :hdim])
            inp = torch.relu(cnet[..., hdim:])

        def site(module, remat, *args, **kwargs):
            if self.training and remat:
                return recomputed(module, generator, *args, **kwargs)
            return module(*args, **kwargs)

        with record_function("craft.f2_trans"):
            fmap2 = site(self.f2_trans, cfg.remat_att_sites, fmap2,
                         generator, shard, diagnostics)
            fmap1, fmap2 = fmap1.float(), fmap2.float()
        with record_function("craft.intra_attention"):
            attention = site(self.att, cfg.remat_att_sites, inp, generator,
                             shard, diagnostics)
        with record_function("craft.corr_volume"):
            vol = site(self.corr_fn, True, fmap1, fmap2, out_dtype=lvl_dtype,
                       generator=generator, shard=shard,
                       diagnostics=diagnostics)
            if self.corr_fn.prenormed():
                pyramid = pyramid_from_level0(vol, B, H8, W8,
                                              cfg.corr_levels,
                                              cfg.corr_radius,
                                              level_dtype=lvl_dtype)
            else:
                pyramid = build_pyramid(
                    vol.reshape(B, H8 * W8, 1, H8 * W8), B, H8, W8,
                    cfg.corr_levels, cfg.corr_radius, do_global_norm=True,
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
                if shard is None:
                    corr = corr_lookup(pyramid, coords1)
                else:
                    corr = corr_lookup(pyramid,
                                       coords1[:, shard.h0:shard.h1])
                    corr = shard.gather(corr.reshape(B, -1, corr.shape[-1])
                                        ).reshape(B, H8, W8, -1)
            flow = coords1 - coords0
            with record_function("craft.update_block"):
                net, up_mask, delta = self.update_block(
                    net, inp, corr.to(cdt), flow.to(cdt), attention,
                    gru_static=gru_static, shard=shard)
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
