"""Refinement update block (PyTorch port of ``craft_tpu.nn.update``;
reference core/update.py:8-162): SepConvGRU, BasicMotionEncoder, the flow
and upsample-mask heads, RAFT's BasicUpdateBlock, and GMAUpdateBlock with
the SETrans aggregator or GMA's Aggregate.

The arithmetic is restructured as in the JAX package, with the reference's
parameters: each GRU gate conv is linear over its [h, x] input split, so
per direction one conv over h gives the z|r halves and one conv over the
per-iteration x gives the z|r|q thirds; the context features' share is
computed once per forward (``static_contrib``); the flow head's and mask
head's first convs (both reading `net`) run as one conv.  Tensors are NHWC
at the module boundaries and NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from craft_tpu_torch.config import ModelConfig, intra_aggregator_config
from craft_tpu_torch.nn.gma import Aggregate
from craft_tpu_torch.nn.layers import conv, conv2d
from craft_tpu_torch.nn.setrans import ExpandedFeatTrans
from craft_tpu_torch.ops.kernels.sep_conv_gru import (fused_gru_vmem_ok,
                                                      gru_pass)

_PAD = {"h": (2, 2, 0, 0), "v": (0, 0, 2, 2)}  # F.pad (left, right, top, bottom)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class SepConvGRU(nn.Module):
    """Separable ConvGRU: horizontal (1x5) then vertical (5x1) gated update
    (reference update.py:37-64).

    fused = 'on' runs each direction as one pass of B10 (``gru_pass``: the
    three gate convs and the update in hand kernels on a CUDA tensor, their
    plain version on a CPU one), with the same parameters split into taps;
    'auto' does so on a CUDA tensor; 'off' (the default, as in the JAX
    package) runs the conv form.  The fused pass runs only where the JAX
    module takes its kernel: no `static` contribution, and a shape that
    ``fused_gru_vmem_ok`` admits.  Its io type is h's, as in the JAX
    package."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 384,
                 dtype=torch.float32, fused: str = "off"):
        super().__init__()
        if fused not in ("off", "on", "auto"):
            raise ValueError(f"fused must be 'off', 'on' or 'auto', got "
                             f"{fused!r}")
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.fused = fused
        cin = hidden_dim + input_dim
        for g in ("z", "r", "q"):
            setattr(self, f"conv{g}1",
                    nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2)))
            setattr(self, f"conv{g}2",
                    nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0)))

    def _gates(self, d: str):
        idx = 1 if d == "h" else 2
        return [getattr(self, f"conv{g}{idx}") for g in ("z", "r", "q")]

    def static_contrib(self, x_static: torch.Tensor) -> dict:
        """Gate contributions of the iteration-invariant input channels
        (NHWC [B, H, W, cs]): one NCHW [B, 3*hidden, H, W] tensor per
        direction, added inside forward(static=...)."""
        ch, cs = self.hidden_dim, x_static.shape[-1]
        x = _nchw(x_static).to(self.dtype)
        out = {"cs": cs}
        for d in ("h", "v"):
            w = torch.cat([m.weight[:, ch:ch + cs] for m in self._gates(d)])
            out[d] = conv2d(x, w, None, 1, _PAD[d], self.dtype)
        return out

    def _fused_pass(self, h, x, d: str, stride: int, width: int):
        """One direction as a B10 pass over the rows of h [B, HW, Ch], x
        [B, HW, Cx]: each gate's [Ch, Ch + Cx, kh, kw] kernel as taps [5,
        Ch + Cx, Ch], split at Ch."""
        hd = self.hidden_dim
        parts = []
        for m in self._gates(d):
            taps = m.weight.reshape(hd, -1, 5).permute(2, 1, 0)
            parts += [taps[:, :hd], taps[:, hd:]]
        biases = [m.bias for m in self._gates(d)]
        return gru_pass(h, x, *parts, *biases, stride, width)

    def forward(self, h, x, static=None):
        """h: [B, H, W, hidden]; x: the per-iteration input channels (all of
        them when static is None).  Returns the new h (NHWC)."""
        dt = self.dtype
        cs = static["cs"] if static is not None else 0
        B, H, W, Ch = h.shape
        use_fused = self.fused == "on" or (self.fused == "auto"
                                           and h.is_cuda)
        if use_fused and static is None and fused_gru_vmem_ok(
                H * W, Ch, cs + x.shape[-1], 1, torch.finfo(dt).bits // 8):
            # The vertical pass reads the same row-major rows W apart (one
            # "image row" of H * W: only the image bounds mask its taps).
            rows = (B, H * W, -1)
            hr, xr = h.reshape(rows), x.reshape(rows)
            hr = self._fused_pass(hr, xr, "h", 1, W)
            return self._fused_pass(hr, xr, "v", W, H * W).reshape(B, H, W,
                                                                  Ch)
        h = _nchw(h)
        x = _nchw(x).to(dt)
        for d in ("h", "v"):
            h = self.conv_pass(h, x, d, static)
        return _nhwc(h)

    def conv_pass(self, h, x, d: str, static=None):
        """One direction in the conv form, NCHW: the merged convs over x
        (z|r|q thirds, plus the static share) and over h (z|r halves), the
        q conv over r h, and the update."""
        dt, hd = self.dtype, self.hidden_dim
        cs = static["cs"] if static is not None else 0
        cz, cr, cq = self._gates(d)
        w_x = torch.cat([m.weight[:, hd + cs:] for m in (cz, cr, cq)])
        a = conv2d(x, w_x, None, 1, _PAD[d], dt)
        if static is not None:
            a = a + static[d].to(a.dtype)
        w_h = torch.cat([cz.weight[:, :hd], cr.weight[:, :hd]])
        g = conv2d(h, w_h, None, 1, _PAD[d], dt)
        z = torch.sigmoid(g[:, :hd] + a[:, :hd]
                          + cz.bias.to(dt).view(1, -1, 1, 1))
        r = torch.sigmoid(g[:, hd:] + a[:, hd:2 * hd]
                          + cr.bias.to(dt).view(1, -1, 1, 1))
        q = torch.tanh(conv2d(r * h, cq.weight[:, :hd], None, 1, _PAD[d], dt)
                       + a[:, 2 * hd:] + cq.bias.to(dt).view(1, -1, 1, 1))
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """(corr window, flow) -> 126 channels + the raw 2-channel flow
    (reference update.py:67-87)."""

    def __init__(self, cor_planes: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        """flow [B, H, W, 2], corr [B, H, W, cor_planes] -> [B, H, W, 128]."""
        dt = self.dtype
        flow = _nchw(flow).to(dt)
        cor = torch.relu(conv(self.convc1, _nchw(corr), dt))
        cor = torch.relu(conv(self.convc2, cor, dt))
        flo = torch.relu(conv(self.convf1, flow, dt))
        flo = torch.relu(conv(self.convf2, flo, dt))
        out = torch.relu(conv(self.conv, torch.cat([cor, flo], dim=1), dt))
        return _nhwc(torch.cat([out, flow], dim=1))


class FlowHead(nn.Module):
    """conv3x3(128->256) -> ReLU -> conv3x3(256->2) (reference
    update.py:8-16)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class _UpdateBlock(nn.Module):
    """What both update blocks share: the motion encoder, the GRU over
    128 + `dyn_channels` input channels (the context features' 128 among
    them), the flow head and the upsample-mask head (conv3x3 -> ReLU ->
    conv1x1, scaled by 0.25; reference update.py:98-101, 112).  An
    `aggregator` is registered after the encoder, the reference's order
    (which the optimizer state of a checkpoint follows)."""

    def __init__(self, cfg: ModelConfig, dyn_channels: int,
                 dtype=torch.float32, aggregator=None):
        super().__init__()
        self.dtype = dtype
        hd = cfg.hidden_dim
        self.encoder = BasicMotionEncoder(cfg.cor_planes, dtype)
        if aggregator is not None:
            self.aggregator = aggregator
        self.gru = SepConvGRU(hd, 128 + dyn_channels, dtype)
        self.flow_head = FlowHead(hd, 256)
        self.mask = nn.Sequential(nn.Conv2d(hd, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def precompute_gru_static(self, inp: torch.Tensor) -> dict:
        return self.gru.static_contrib(inp)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        """The mask head alone (NHWC), for upsample_mode='final'."""
        dt = self.dtype
        m = torch.relu(conv(self.mask[0], _nchw(net), dt))
        return _nhwc(0.25 * conv(self.mask[2], m, dt))

    def _heads(self, net):
        """Flow head + mask head with their first convs merged (the JAX
        package's ``_merged_heads``)."""
        dt = self.dtype
        fh, m0, m2 = self.flow_head, self.mask[0], self.mask[2]
        nf = fh.conv1.out_channels
        y = torch.relu(conv2d(_nchw(net),
                              torch.cat([fh.conv1.weight, m0.weight]),
                              torch.cat([fh.conv1.bias, m0.bias]), 1, 1, dt))
        delta = conv(fh.conv2, y[:, :nf], dt)
        mask = 0.25 * conv(m2, y[:, nf:], dt)
        return _nhwc(delta), _nhwc(mask)

    def _step(self, net, inp, dyn, gru_static):
        """The GRU over [inp, dyn] (inp's share from `gru_static` when
        given), then the heads: (net, up_mask, delta_flow)."""
        if gru_static is None:
            net = self.gru(net, torch.cat([inp, dyn], -1))
        else:
            net = self.gru(net, dyn, static=gru_static)
        delta, mask = self._heads(net)
        return net, mask, delta


class BasicUpdateBlock(_UpdateBlock):
    """RAFT's update block (reference update.py:90-113), also craft_nogma's:
    the GRU takes the context and motion features (x 256 wide)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__(cfg, 128, dtype)

    def forward(self, net, inp, corr, flow, gru_static=None):
        """NHWC in and out: returns (net, up_mask, delta_flow)."""
        return self._step(net, inp, self.encoder(flow, corr), gru_static)


class GMAUpdateBlock(_UpdateBlock):
    """GMA update block with global motion aggregation (reference
    update.py:116-162): the SETrans aggregator (``cfg.use_setrans``) or GMA
    ``Aggregate``, the GRU over the context, motion and aggregated motion
    features (x 384 wide).  `attention` (the intra probs, a
    LazyModeAttention that the SETrans aggregator applies through B2 each
    iteration, or GMA's [B, heads, U, U] attention) and `gru_static` are
    computed once per forward, outside the refinement loop.  Under
    sequence parallelism `attention` holds the `shard`'s rows (probs,
    never lazy, or GMA's attention), and the aggregator gathers its output
    to every rank."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        if cfg.use_setrans:
            aggregator = ExpandedFeatTrans(
                intra_aggregator_config(cfg.intra), dtype)
        else:
            aggregator = Aggregate(dim=128, heads=cfg.num_heads,
                                   dim_head=128, dtype=dtype)
        super().__init__(cfg, 256, dtype, aggregator)
        self.use_setrans = cfg.use_setrans

    def forward(self, net, inp, corr, flow, attention, gru_static=None,
                shard=None):
        """NHWC in and out: returns (net, up_mask, delta_flow)."""
        motion = self.encoder(flow, corr)
        B, H, W, C = motion.shape
        if self.use_setrans:
            motion_global = self.aggregator(
                motion.reshape(B, H * W, C), attention,
                shard=shard).reshape(B, H, W, C)
        else:
            motion_global = self.aggregator(attention, motion, shard=shard)
        return self._step(net, inp, torch.cat([motion, motion_global], -1),
                          gru_static)
