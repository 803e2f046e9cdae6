"""FLOPs of the forward (port of ``craft_tpu.eval.flops``): the analytic
per-module breakdown (the reference's fvcore table,
logs/craft-intra4-flops.txt: update_block 615G, aggregator 310G, f2 66G,
fnet 62G, cnet 31G, corr 13.8G at Sintel size / 12 iters), and a counted
total over one forward (``count_model_flops``).

Counts multiply-adds as 2 FLOPs for convs/matmuls (fvcore counts MACs as 1
FLOP — divide by 2 to compare against the reference table).

The counted total is the port's counterpart of the JAX package's XLA cost
analysis, in two parts printed apart: what
``torch.utils.flop_counter.FlopCounterMode`` counts over the PyTorch ops
(convolutions and matrix products; it counts no elementwise work), and
what the hand kernels' wrappers add where they launch a kernel (the
operations of each kernel's bound in PERF.md), since the mode cannot see
inside a kernel.  On the CPU the wrappers run their plain versions, which
the mode counts itself, and add nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from craft_tpu_torch.config import ModelConfig


def _conv(h, w, cin, cout, kh, kw, stride=1):
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * cin * cout * kh * kw, oh, ow


def encoder_flops(H: int, W: int, out_dim: int) -> int:
    f = 0
    fl, h, w = _conv(H, W, 3, 64, 7, 7, 2)
    f += fl
    cin = 64
    for dim, stride in [(64, 1), (96, 2), (128, 2)]:
        # block 0 (stride): conv1(s) + conv2 + downsample(1x1, s)
        fl, h2, w2 = _conv(h, w, cin, dim, 3, 3, stride)
        f += fl
        f += _conv(h2, w2, dim, dim, 3, 3)[0]
        if stride != 1:
            f += _conv(h, w, cin, dim, 1, 1, stride)[0]
        h, w = h2, w2
        # block 1
        f += _conv(h, w, dim, dim, 3, 3)[0] * 2
        cin = dim
    f += _conv(h, w, 128, out_dim, 1, 1)[0]
    return f


def setrans_qk_flops(U: int, in_dim: int) -> int:
    # Q + K projections and the [M, U, md] x [M, md, U] score matmuls;
    # md * M == in_dim so scores cost 2*U^2*in_dim regardless of M.
    proj = 2 * 2 * U * in_dim * in_dim
    scores = 2 * U * U * in_dim
    return proj + scores


def f2_flops(U: int, dim: int = 256, modes: int = 4) -> int:
    qk = setrans_qk_flops(U, dim)
    v = 2 * U * dim * (dim * modes)  # first_linear
    av = 2 * modes * U * U * dim    # probs @ V
    return qk + v + av


def aggregator_flops(U: int, dim: int = 128, modes: int = 4) -> int:
    v = 2 * U * dim * (dim * modes)
    av = 2 * modes * U * U * dim
    return v + av


def update_block_flops(H8: int, W8: int, cor_planes: int,
                       use_setrans: bool, modes: int = 4) -> int:
    U = H8 * W8
    f = 0
    f += _conv(H8, W8, cor_planes, 256, 1, 1)[0]   # convc1
    f += _conv(H8, W8, 256, 192, 3, 3)[0]          # convc2
    f += _conv(H8, W8, 2, 128, 7, 7)[0]            # convf1
    f += _conv(H8, W8, 128, 64, 3, 3)[0]           # convf2
    f += _conv(H8, W8, 256, 126, 3, 3)[0]          # conv
    if use_setrans:
        f += aggregator_flops(U, 128, modes)
    else:
        f += 2 * U * 128 * 128 + 2 * U * U * 128   # to_v + attn@V
    gru_in = 128 + 128 + 128
    for k in (5, 5):  # 1x5 + 5x1 passes, 3 gates each
        f += 3 * _conv(H8, W8, 128 + gru_in, 128, 1, k)[0]
    f += _conv(H8, W8, 128, 256, 3, 3)[0]          # flow head
    f += _conv(H8, W8, 256, 2, 3, 3)[0]
    f += _conv(H8, W8, 128, 256, 3, 3)[0]          # mask head
    f += _conv(H8, W8, 256, 576, 1, 1)[0]
    return f


def model_flops_breakdown(cfg: ModelConfig, H: int, W: int,
                          iters: int = 12) -> Dict[str, float]:
    """Forward FLOPs per component at input HxW (GFLOPs)."""
    H8, W8 = H // 8, W // 8
    U = H8 * W8
    out = {}
    out["fnet"] = 2 * encoder_flops(H, W, 256)  # two frames
    out["cnet"] = encoder_flops(H, W, 256)
    if cfg.f2trans != "none":
        out["f2_trans"] = f2_flops(U, 256, cfg.f2.num_modes)
    if cfg.craft:
        out["corr_fn"] = setrans_qk_flops(U, 256)
    else:
        out["corr_fn"] = 2 * U * U * 256
    if cfg.arch == "craft":
        out["att"] = setrans_qk_flops(U, 128) if cfg.use_setrans else \
            (2 * U * 128 * 256 + 2 * U * U * 128)
    per_iter = update_block_flops(H8, W8, cfg.cor_planes, cfg.use_setrans,
                                  cfg.intra.num_modes)
    out["update_block (x%d)" % iters] = per_iter * iters
    # lookup matmuls (hat interpolation, level 0 dominates)
    lookup = 0
    h, w = H8, W8
    for _ in range(cfg.corr_levels):
        n = 2 * cfg.corr_radius + 1
        lookup += 2 * U * n * w * h + 2 * U * n * n * w
        h, w = h // 2, w // 2
    out["corr_lookup (x%d)" % iters] = lookup * iters
    out["total"] = sum(out.values())
    return {k: v / 1e9 for k, v in out.items()}


def print_breakdown(cfg: ModelConfig, H: int, W: int, iters: int = 12):
    bd = model_flops_breakdown(cfg, H, W, iters)
    print(f"Forward FLOPs breakdown @ {H}x{W}, {iters} iters "
          f"(GFLOPs; MACs x2 — halve to compare with fvcore):")
    for k, v in sorted(bd.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {v:9.1f}")
    return bd


def count_model_flops(cfg: ModelConfig, weights, image_shape=(440, 1024),
                      iters: int = 12, device=None) -> Tuple[float, float]:
    """(FLOPs that FlopCounterMode counts over one forward at image_shape,
    FLOPs the hand kernels' wrappers add in the same forward), on `device`
    (default the card), with zero frames and the weights loaded."""
    from torch.utils.flop_counter import FlopCounterMode

    from craft_tpu_torch import resolve_device
    from craft_tpu_torch.models.flow_model import create_model
    from craft_tpu_torch.ops.kernels import launch

    device = resolve_device(device)
    model = create_model(cfg, device=device)
    model.load_state_dict(weights, strict=True)
    img = torch.zeros(1, *image_shape, 3, device=device)
    # The counters stay as they are: the kernels' share is the difference.
    before = sum(launch.launch_flops().values())
    counter = FlopCounterMode(display=False)
    # no_grad, not inference_mode: the mode's module hooks need autograd.
    with torch.no_grad(), counter:
        model(img, img, iters=iters, upsample_mode=cfg.upsample_mode)
    return float(counter.get_total_flops()), float(
        sum(launch.launch_flops().values()) - before)
