"""The RAFT / GMA / craft_nogma / CRAFT flow model (PyTorch port of
``craft_tpu.models.flow_model``; reference core/raft.py:24-146,
core/craft_nogma.py:25-203, core/network.py:26-267).  One module covers
every family, driven by the ModelConfig as the JAX one is, and builds only
the modules the JAX tree has:
  * the f2 transformer (``f2_trans``) on frame 2 when f2trans != 'none'
    (arch 'craft' or 'craft_nogma');
  * the f1 transformer (``f1_trans``) on frame 1 and two-way correlation
    when f1trans != 'none' (arch 'craft'; see FlowModel);
  * intra attention (``att``, arch 'craft' only): SETrans probs
    (use_setrans) or GMA ``Attention``;
  * the volume: TransCorr (``corr_fn``, cfg.craft) or RAFT's plain
    all-pairs volume (no parameters);
  * ``update_block``: GMAUpdateBlock (arch 'craft': the SETrans aggregator
    or GMA ``Aggregate``) or BasicUpdateBlock (RAFT, craft_nogma).
RAFT and GMA run B5 alone; a TransCorr family adds the inter site's
kernels, and each SETrans site its own, as below.

Full CRAFT's forward: fnet/cnet encoders -> f2 transformer on frame 2 ->
SETrans intra attention probs (B4; past 4e9 bytes of probs, as at HD1K's
grid, a LazyModeAttention instead, which each iteration's aggregator applies
through B2) -> the inter-frame volume as the pyramid base -> 12
refinement iterations of windowed lookup (B5, forward and, in training,
backward) + GMAUpdateBlock + convex upsampling.  In eval mode with the
sliding bias at the inter site the volume is clamped, aggregated and normed
in one kernel call (B3).  Otherwise (train mode, or an inter site under
pos_code_type 'lsinu') it is the raw volume (B6, or B6 dense in eval),
normed by ``build_pyramid``.  In train mode (``model.train()``) cnet's
BatchNorm takes batch statistics unless ``freeze_bn``; dropout draws from
the `generator` passed to forward.  In train mode the inter site, and with
``remat_att_sites`` (the default) the f1, f2 and intra sites, keep none of
their activations: the backward recomputes them (``torch.utils.
checkpoint``) from the same dropout draws, as the JAX package's
``nn.remat``.  A forward given an ``AttentionDiagnostics`` (train mode)
runs every site through the plain path and records its telemetry.  The
correlation is an fp32 island; pyramid
levels are stored bf16 under mixed precision; coords stay fp32 and are
detached every iteration.

Under sequence parallelism (eval, every family; ``seq_parallel``, a
``craft_tpu_torch.parallel.sp.SeqParallel`` group) each rank holds its
RowShard's query rows of the O(U^2) tensors: the intra probs (SETrans or
GMA attention), the volume (B9's normed level 0 with the sliding bias, B6
dense's raw one under lsinu, RAFT's plain one), each direction's under
two-way correlation, and the pyramid pooled from it (pooling runs over the
key axes only; a raw volume's global norm takes every rank's moments), and
it runs the lookup on its rows of coords1 and the aggregator's product on
its rows; the f1 and f2 outputs, the lookup features and the aggregated
motion are gathered to every rank, and everything else (the encoders, the
projections, the update block's convs, GRU and upsampling) runs on every
rank as it is.  The lazy intra path stays off under a shard: the JAX
package materialises the probs under sequence parallelism too.
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
from craft_tpu_torch.nn.gma import Attention
from craft_tpu_torch.nn.setrans import (NOT_PORTED_SP, CrossAttFeatTrans,
                                        InputFeatEncoder, SelfAttVisPosTrans,
                                        Sow)
from craft_tpu_torch.nn.update import BasicUpdateBlock, GMAUpdateBlock
from craft_tpu_torch.ops.corr import (all_pairs_correlation, build_pyramid,
                                      corr_lookup, plain_corr_pyramid,
                                      pyramid_from_level0)
from craft_tpu_torch.ops.geometry import (convex_upsample,
                                          convex_upsample_packed,
                                          coords_grid)


class TransCorr(nn.Module):
    """Cross-frame attentional correlation volume (reference
    corr.py:132-207): when ``prenormed()``, the globally layer-normed
    [B, U1, U2] volume in `out_dtype`, ready to be the pyramid base (B3);
    otherwise the raw [B, U1, U2] fp32 volume.  Given the untransformed
    maps fmap1o and fmap2o too (two-way correlation, --f1), the two
    directions (f1'.f2, f1.f2') as a pair of such volumes, in the JAX
    package's order (``craft_tpu/models/flow_model.py:67-96``); the
    encoder runs four times, the sliding bias from its first call."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.pos_code_type = cfg.inter.pos_code_type
        self.vispos_encoder = InputFeatEncoder(cfg.inter, dtype)
        self.setrans = CrossAttFeatTrans(cfg.inter, dtype)

    def prenormed(self) -> bool:
        """Whether forward gives the normed volume: eval mode with the
        sliding bias, the static decision of ``craft_tpu/models/
        flow_model.py:219-225`` (there fp32, the two-way volume and one
        mode (no fused norm, ``craft_tpu/nn/setrans.py:86``) take the raw
        volume and ``build_pyramid``'s global norm; the port keeps B3 for
        all three, one launch a direction, whose output it normalizes
        exactly per (batch, d); at one mode B3's mode softmax is 1 and its
        volume the raw scores)."""
        return not self.training and self.pos_code_type == "bias"

    def forward(self, fmap1, fmap2, fmap1o=None, fmap2o=None,
                out_dtype=torch.float32, generator=None, shard=None,
                diagnostics=None, sow=None):
        """`sow` (a ``Sow``, eval) captures the raw volume, [B, D, U1, U2],
        as 'corr_volume' and sends the site through the plain path, which
        gives it raw."""
        vispos1, pos_biases = self.vispos_encoder(fmap1, generator)
        vispos2, _ = self.vispos_encoder(fmap2, generator)

        def one_way(v1, v2):
            return self.setrans(v1, v2, pos_biases=pos_biases,
                                out_dtype=out_dtype, generator=generator,
                                shard=shard, diagnostics=diagnostics,
                                sow=sow)

        if fmap1o is None:
            vol = one_way(vispos1, vispos2)
            if sow is not None:
                sow("corr_volume", vol[:, None])
            return vol
        vispos1o, _ = self.vispos_encoder(fmap1o, generator)
        vispos2o, _ = self.vispos_encoder(fmap2o, generator)
        vols = (one_way(vispos1, vispos2o), one_way(vispos1o, vispos2))
        if sow is not None:
            sow("corr_volume", torch.stack(vols, dim=1))
        return vols


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


def two_way(cfg: ModelConfig) -> bool:
    """Two-way correlation: --f1 shared|private, read by arch 'craft'
    only."""
    return cfg.arch == "craft" and cfg.f1trans != "none"


def _scope(sow, name):
    return None if sow is None else sow.scope(name)


class FlowModel(nn.Module):
    """Every family, one-way or (arch 'craft', --f1) two-way correlation.

    With ``freeze_bn`` set, train mode keeps cnet as in eval (BatchNorm on
    its running statistics, folded; no Dropout2d), as the JAX package's
    ``FlowModel(freeze_bn=True)``.

    Two-way correlation builds the f1 transformer (``f1_trans``) on frame
    1: under 'shared' the very module of ``f2_trans`` (one set of
    parameters, which the state dict lists under both names, as the
    reference's does; a dict with ``f2_trans.*`` alone, as the JAX tree
    gives, loads too), under 'private' its own.  It runs before the f2
    site, as in JAX.  The inter site then correlates both ways (TransCorr)
    into a D = 2 pyramid: in eval with the sliding bias one B3 launch a
    direction writes its normed plane of level 0 (the JAX package takes the
    raw volume and ``build_pyramid`` for --f1; the norm is per (batch, d),
    so the two are the same arithmetic and the pair of fp32 volumes is never
    materialised); otherwise B6 (B6 dense in eval without the sliding
    bias) a direction and ``build_pyramid``.  The lookup (B5) reads the
    L D planes and gives L D (2r+1)^2 = 648 channels, which the motion
    encoder takes (``cfg.cor_planes``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.arch not in ("raft", "craft_nogma", "craft"):
            raise ValueError(f"unknown arch {cfg.arch!r}")
        if two_way(cfg) and (cfg.f2trans == "none" or not cfg.craft):
            raise ValueError(
                f"f1trans={cfg.f1trans!r} correlates the f1 and f2 "
                f"transformers' outputs both ways: it needs TransCorr and "
                f"the f2 transformer (f2trans={cfg.f2trans!r}, "
                f"craft={cfg.craft})")
        self.cfg = cfg
        self.freeze_bn = False
        cdt = cfg.compute_dtype
        self.fnet = BasicEncoder(256, "instance", cdt, cfg.dropout)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch",
                                 cdt, cfg.dropout)
        self.f2_trans = (SelfAttVisPosTrans(cfg.f2, cdt)
                         if cfg.f2trans != "none" and cfg.arch != "raft"
                         else None)
        self.f1_trans = None
        if two_way(cfg):
            self.f1_trans = self.f2_trans if cfg.f1trans == "shared" \
                else SelfAttVisPosTrans(cfg.f2, cdt)
            if cfg.f1trans == "shared":
                self._register_load_state_dict_pre_hook(_share_f1_keys)
        self.att = None
        if cfg.arch == "craft":
            self.att = SelfAttVisPosTrans(cfg.intra, cdt) \
                if cfg.use_setrans else Attention(
                    dim=cfg.context_dim, max_pos_size=cfg.gma_max_pos_size,
                    heads=cfg.num_heads, dim_head=cfg.context_dim,
                    position_only=cfg.position_only,
                    position_and_content=cfg.position_and_content,
                    dtype=cdt)
        self.corr_fn = TransCorr(cfg, cdt) if cfg.craft else None
        self.update_block = (GMAUpdateBlock(cfg, cdt) if cfg.arch == "craft"
                             else BasicUpdateBlock(cfg, cdt))

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.freeze_bn:
            self.cnet.eval()
        return self

    def forward(self, image1, image2, iters: Optional[int] = None,
                flow_init=None, upsample_mode: Optional[str] = None,
                generator=None, seq_parallel=None, data_parallel=None,
                diagnostics=None, intermediates=None):
        """image1/image2: [B, H, W, 3] floats in [0, 255] on the model's
        device.  Returns (flow_lowres [B, H/8, W/8, 2], flows_up
        [iters, B, H, W, 2]); with upsample_mode='final' only the last
        iteration is upsampled and flows_up is [1, B, H, W, 2]; with
        'packed' the same values as 'all' in the [iters, B, H/8, W/8, 128]
        layout (``ops.geometry.unpack_upsampled`` unpacks a frame).
        `generator` (a ``torch.Generator`` on the model's device) draws
        every training dropout mask.  `seq_parallel` (a SeqParallel group,
        eval) splits the grid's rows across its ranks; every rank returns
        the whole flow.  `data_parallel` (a group, training) makes cnet's
        BatchNorm take its moments over every rank's batch.  `diagnostics` (an AttentionDiagnostics, training)
        collects the SETrans sites' telemetry.  `intermediates` (a dict,
        eval) takes what the JAX package sows into its 'intermediates'
        collection: the raw volume [B, D, U1, U2] ('corr_fn/corr_volume')
        and each SETrans site's [B, M, U, U] probs ('<site>/setrans/
        attn_probs'; under 'shared' the f1 call's, the first), the value
        of each key's first call; while it captures, every SETrans site
        takes the plain path, as JAX's XLA sites (no B2, B3 or B4)."""
        cfg = self.cfg
        iters = iters or cfg.iters
        upsample_mode = upsample_mode or cfg.upsample_mode
        if upsample_mode not in ("all", "final", "packed"):
            raise ValueError(f"upsample_mode {upsample_mode!r}")
        if seq_parallel is not None and self.training:
            raise NotImplementedError(NOT_PORTED_SP)
        sow = None if intermediates is None else Sow(intermediates)
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

        # Training recomputes the inter site always, and the f2 and intra
        # SETrans sites under remat_att_sites, as the JAX package's
        # nn.remat; GMA attention is kept.
        def site(module, remat, *args, **kwargs):
            if self.training and remat:
                return recomputed(module, generator, *args, **kwargs)
            return module(*args, **kwargs)

        fmap1o = fmap2o = None
        if self.f1_trans is not None:
            fmap1o = fmap1
            with record_function("craft.f1_trans"):
                # Under 'shared' the module is f2_trans, as its sow keys.
                fmap1 = site(self.f1_trans, cfg.remat_att_sites, fmap1,
                             generator, shard, diagnostics,
                             _scope(sow, "f2_trans" if cfg.f1trans ==
                                    "shared" else "f1_trans"))
        if self.f2_trans is not None:
            if self.f1_trans is not None:
                fmap2o = fmap2
            with record_function("craft.f2_trans"):
                fmap2 = site(self.f2_trans, cfg.remat_att_sites, fmap2,
                             generator, shard, diagnostics,
                             _scope(sow, "f2_trans"))
        fmap1, fmap2 = fmap1.float(), fmap2.float()
        if fmap1o is not None:
            fmap1o, fmap2o = fmap1o.float(), fmap2o.float()
        attention = None
        if self.att is not None:
            with record_function("craft.intra_attention"):
                if cfg.use_setrans:
                    attention = site(self.att, cfg.remat_att_sites, inp,
                                     generator, shard, diagnostics,
                                     _scope(sow, "att"))
                else:
                    attention = self.att(inp.to(cdt), shard=shard)
        with record_function("craft.corr_volume"):
            if self.corr_fn is None:
                if sow is not None:
                    sow("corr_volume", all_pairs_correlation(
                        fmap1, fmap2)[:, None])
                pyramid = plain_corr_pyramid(fmap1, fmap2, cfg.corr_levels,
                                             cfg.corr_radius,
                                             level_dtype=lvl_dtype,
                                             shard=shard)
            else:
                vol = site(self.corr_fn, True, fmap1, fmap2, fmap1o, fmap2o,
                           out_dtype=lvl_dtype, generator=generator,
                           shard=shard, diagnostics=diagnostics,
                           sow=_scope(sow, "corr_fn"))
                if self.corr_fn.prenormed() and sow is None:
                    pyramid = pyramid_from_level0(vol, B, H8, W8,
                                                  cfg.corr_levels,
                                                  cfg.corr_radius,
                                                  level_dtype=lvl_dtype)
                else:
                    raw = torch.stack(vol, dim=2) if fmap1o is not None \
                        else vol[:, :, None]
                    pyramid = build_pyramid(
                        raw, B, H8, W8, cfg.corr_levels, cfg.corr_radius,
                        do_global_norm=True, level_dtype=lvl_dtype,
                        shard=shard)
                    del raw
                del vol

        coords0 = coords_grid(B, H8, W8, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        gru_static = self.update_block.precompute_gru_static(inp.to(cdt))
        upsample = convex_upsample_packed if upsample_mode == "packed" \
            else convex_upsample

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
                if self.att is None:
                    net, up_mask, delta = self.update_block(
                        net, inp, corr.to(cdt), flow.to(cdt),
                        gru_static=gru_static)
                else:
                    net, up_mask, delta = self.update_block(
                        net, inp, corr.to(cdt), flow.to(cdt), attention,
                        gru_static=gru_static, shard=shard)
            coords1 = coords1 + delta.float()
            if upsample_mode != "final":
                with record_function("craft.upsample"):
                    flows_up.append(upsample(coords1 - coords0,
                                             up_mask.float()))
        if upsample_mode == "final":
            up_mask = self.update_block.upsample_mask(net)
            flows_up.append(convex_upsample(coords1 - coords0,
                                            up_mask.float()))
        return coords1 - coords0, torch.stack(flows_up)


def _share_f1_keys(state_dict, prefix, *args):
    """Under f1trans='shared': a state dict that lists the shared module
    under ``f2_trans.*`` alone (as the JAX tree, through
    ``state_dict_from_flax``) gets its entries under ``f1_trans.*`` too; one
    that lists both (the reference's) loads as it is."""
    f2, f1 = prefix + "f2_trans.", prefix + "f1_trans."
    if any(k.startswith(f1) for k in state_dict):
        return
    for key in [k for k in state_dict if k.startswith(f2)]:
        state_dict[f1 + key[len(f2):]] = state_dict[key]


def create_model(cfg: ModelConfig, device=None) -> FlowModel:
    """The model in eval mode on `device` (default: CUDA; raises when CUDA
    is absent and no device was asked for)."""
    dev = resolve_device(device)
    return FlowModel(cfg).to(dev).eval()
