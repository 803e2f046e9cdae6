"""B6: the raw aggregated inter-frame volume and its backward, each beside
its plain PyTorch version, joined into the differentiable
``fused_agg_corr_diff`` (counterparts of ``craft_tpu/ops/pallas/
corr_vjp.py`` and of ``fused_agg_corr_mt`` in ``craft_tpu/ops/pallas/
mode_attention.py``); and B6 dense, the forward with a dense [U1, U2] table
or none (``fused_agg_corr_dense``, the counterpart of ``fused_agg_corr``
there: the inter site in eval mode under pos_code_type 'lsinu').

Per sample, with s_m = clamp(c_m, +-clip) + pos_w * bias and c_m = scale *
q_m k_m^T:
  vol             = sum_m p_m s_m,  p = softmax_m(agg_w * s_m + agg_b)
  dvol/ds_m       = t_m = p_m * (1 + agg_w * (s_m - vol))
  dc_m            = g * t_m * 1[|c_m| < clip]
  dq_m, dk_m      = (dc_m @ k_m, dc_m^T @ q_m) * scale
  dbias           = pos_w * masked diagonal sums of g   (sum_m t_m == 1)
  dagg_w          = sum g * sum_m p_m s_m (s_m - vol);  dagg_b = 0
The kernels (csrc/agg_corr.cu) compute vol and (dc, dagg_w); the products
dq/dk run as plain fp32 matrix products, as the JAX package leaves them to
XLA.  The bf16 bodies at four modes (wgmma tiles: the forward B3's sweep
in csrc/agg_modes.cuh, the backward its own) take a mode dim that is a
multiple of 16 and 16-byte aligned q and k; every other mode count (1, 2,
8, ..., 256, with M * md <= 256, md 1 to 8 past 16 modes) and fp32 take
the FMA bodies; the backward's
fp64 partials of dagg_w are bwd_partials(...), one a block of the grid
that it launches.  At one mode p = 1: vol = s, dc = g * the clamp mask,
dagg_w = 0.
pos_w is a config constant and gets no gradient; clip comes from B1 on
detached q and k, so the clamp predicate carries none either.
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.launch import (F, I, P, call, check_cuda,
                                                counted, f32, prep, ptr,
                                                stream)
from craft_tpu_torch.ops.kernels.mode_attention import (acc_dtype,
                                                        agg_mma_body,
                                                        biased_scores,
                                                        check_agg_modes,
                                                        check_mma_tiles,
                                                        check_table,
                                                        table_ptr,
                                                        table_scores)

_FWD_SIG = [P, P, P, P, P, I, I, I, I, I, I, F, I, P]
_DENSE_SIG = [P, P, P, P, P, I, I, I, I, I, F, I, P]
_BWD_SIG = [P, P, P, P, P, P, P, P, I, P, I, I, I, I, I, I, F, I, P]
_TILE, _KGROUP = 64, 8  # csrc/common.cuh TILE, agg_modes.cuh KGROUP
# The backward's bf16 body (csrc/agg_corr.cu): query rows and keys a
# block's tile, key tiles a block.
B6B_ROWS, B6B_KEYS, B6B_KGROUP = 64, 64, 9


def bwd_partials(B: int, U: int, bf16: int) -> int:
    """The backward's fp64 partials of dagg_w: one a block, (q tiles, key
    groups, samples) of the body that bf16 selects (1: the wgmma body,
    agg_mma_body; the kernel refuses another count)."""
    if bf16:
        nq = -(-U // B6B_ROWS)
        return B * nq * -(-(-(-U // B6B_KEYS)) // B6B_KGROUP)
    nq = -(-U // _TILE)
    return B * nq * -(-nq // _KGROUP)


def _scal(q, clip, pos_w, agg_w, agg_b):
    """The kernels' [clip, pos_w, agg_w, agg_b] fp32 device array (no host
    sync: clip and agg_w may be device tensors)."""
    return torch.cat([f32(x, q).detach() for x in (clip, pos_w, agg_w,
                                                   agg_b)])


def _shape_check(q, k, name):
    B, M, U, md = q.shape
    if k.shape != q.shape:
        raise ValueError(f"{name}: q, k must be [B, M, U, md] alike, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    check_agg_modes(name, M, md)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def fused_agg_corr_plain(q, k, biases, grid_hw, clip, pos_w, agg_w, agg_b):
    _, s = biased_scores(q, k, biases, grid_hw, clip, pos_w)
    p = torch.softmax(agg_w * s + agg_b, dim=1)
    return (p * s).sum(dim=1)


@counted
def fused_agg_corr(q, k, biases, grid_hw, clip, pos_w: float, agg_w, agg_b):
    """vol[b] = sum_m softmax_m(agg_w s_m + agg_b) s_m, s_m = clamp(scale
    q_m k_m^T, +-clip) + pos_w * bias, as [B, U, U] fp32 (fp64 for fp64
    inputs on the CPU).  q, k: [B, M, U, md], M in AGG_MODES with M * md
    <= 256 (bf16: md a multiple of 16 or below 16, 16-byte aligned);
    biases: the [2R+1, 2R+1] window over the (H8, W8) token grid; clip: 0-d
    tensor or float."""
    if not q.is_cuda:
        return fused_agg_corr_plain(q, k, biases, grid_hw, clip, pos_w,
                                    agg_w, agg_b)
    _shape_check(q, k, "fused_agg_corr")
    (q, k), bf16 = prep(q, k)
    B, M, U, md = q.shape
    check_mma_tiles("fused_agg_corr", bf16, md, "q and k", q, k)
    R = (biases.shape[0] - 1) // 2
    out = torch.empty(B, U, U, dtype=torch.float32, device=q.device)
    win, scal = f32(biases, q), _scal(q, clip, pos_w, agg_w, agg_b)
    call("agg_corr", "agg_corr_launch", _FWD_SIG, ptr(q), ptr(k), ptr(win),
         ptr(scal), ptr(out), B, M, U, md, grid_hw[1], R,
         1.0 / math.sqrt(md), bf16, stream(q))
    fused_agg_corr.launches += 1
    fused_agg_corr.flops += 2.0 * B * M * U * U * md
    return out


def fused_agg_corr_dense_plain(q, k, table, clip, pos_w, agg_w, agg_b):
    s = table_scores(q, k, table, clip, pos_w)
    p = torch.softmax(agg_w * s + agg_b, dim=1)
    return (p * s).sum(dim=1)


@counted
def fused_agg_corr_dense(q, k, table, clip, pos_w: float, agg_w, agg_b):
    """vol[b] = sum_m softmax_m(agg_w s_m + agg_b) s_m with s_m = clamp(scale
    q_m k_m^T, +-clip) + pos_w * table, as [B, U1, U2] fp32: the counterpart
    of ``craft_tpu.ops.pallas.mode_attention.fused_agg_corr`` (B6 dense).
    q: [B, M, U1, md]; k: [B, M, U2, md] (M and md as B6; bf16: md a
    multiple of 16 or below 16, q and k 16-byte aligned); table: fp32
    [U1, U2] or None
    (no bias); clip: 0-d tensor or float."""
    check_table(table, q, k)
    if not q.is_cuda:
        return fused_agg_corr_dense_plain(q, k, table, clip, pos_w, agg_w,
                                          agg_b)
    (q, k), bf16 = prep(q, k)
    B, M, U1, md = q.shape
    U2 = k.shape[2]
    if k.shape[:2] != (B, M):
        raise ValueError(f"fused_agg_corr_dense: q, k must be [B, M, U, md],"
                         f" got {tuple(q.shape)} and {tuple(k.shape)}")
    check_agg_modes("fused_agg_corr_dense", M, md)
    check_mma_tiles("fused_agg_corr_dense", bf16, md, "q and k", q, k)
    out = torch.empty(B, U1, U2, dtype=torch.float32, device=q.device)
    table = None if table is None else table.contiguous()
    scal = _scal(q, clip, pos_w, agg_w, agg_b)
    call("agg_corr", "agg_corr_dense_launch", _DENSE_SIG, ptr(q), ptr(k),
         table_ptr(table), ptr(scal), ptr(out), B, M, U1, U2, md,
         1.0 / math.sqrt(md), bf16, stream(q))
    fused_agg_corr_dense.launches += 1
    fused_agg_corr_dense.flops += 2.0 * B * M * U1 * U2 * md
    return out


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def agg_corr_bwd_plain(q, k, g, vol, biases, grid_hw, clip, pos_w, agg_w):
    c, s = biased_scores(q, k, biases, grid_hw, clip, pos_w)
    p = torch.softmax(agg_w * s, dim=1)  # agg_b cancels over the modes
    sv = s - vol.to(s.dtype)[:, None]
    g = g.to(s.dtype)[:, None]
    t = p * (1.0 + agg_w * sv)
    clip = torch.as_tensor(clip, dtype=c.dtype, device=c.device)
    dc = torch.where(c.abs() < clip, g * t, torch.zeros((), dtype=c.dtype,
                                                        device=c.device))
    da = (g * p * s * sv).sum()
    return dc, da


@counted
def agg_corr_bwd(q, k, g, vol, biases, grid_hw, clip, pos_w: float, agg_w):
    """The clamp-masked score cotangent dc [B, M, U, U] fp32 and the agg_w
    cotangent da (0-d fp32) from the volume's cotangent g and the saved
    volume vol, both [B, U, U] fp32."""
    if not q.is_cuda:
        return agg_corr_bwd_plain(q, k, g, vol, biases, grid_hw, clip, pos_w,
                                  agg_w)
    _shape_check(q, k, "agg_corr_bwd")
    (q, k), bf16 = prep(q, k)
    check_cuda(q, g, vol)
    B, M, U, md = q.shape
    if g.shape != (B, U, U) or vol.shape != (B, U, U) or \
            g.dtype != torch.float32 or vol.dtype != torch.float32:
        raise ValueError("agg_corr_bwd: g and vol must be [B, U, U] fp32")
    check_mma_tiles("agg_corr_bwd", bf16, md, "q and k", q, k)
    g, vol = g.contiguous(), vol.contiguous()
    R = (biases.shape[0] - 1) // 2
    dev = q.device
    dc = torch.empty(B, M, U, U, dtype=torch.float32, device=dev)
    n_partial = bwd_partials(B, U, agg_mma_body(bf16, M, md))
    partial = torch.empty(n_partial, dtype=torch.float64, device=dev)
    da = torch.empty(1, dtype=torch.float32, device=dev)
    win, scal = f32(biases, q), _scal(q, clip, pos_w, agg_w, 0.0)
    call("agg_corr", "agg_corr_bwd_launch", _BWD_SIG, ptr(q), ptr(k), ptr(g),
         ptr(vol), ptr(win), ptr(scal), ptr(dc), ptr(partial), n_partial,
         ptr(da), B, M, U, md, grid_hw[1], R, 1.0 / math.sqrt(md), bf16,
         stream(q))
    agg_corr_bwd.launches += 1
    return dc, da[0]


def sliding_bias_grad(g: torch.Tensor, H: int, W: int, R: int,
                      pos_w: float) -> torch.Tensor:
    """d biases[dh + R, dw + R] = pos_w * sum over tokens u = (i, j) of
    g[..., u, u + dh * W + dw], summed over any leading dims, where
    (i + dh, j + dw) stays on the H x W grid: a diagonal of the [U, U]
    table wraps across token rows, and the wrapped entries are masked.
    Sums run in fp32 (fp64 for fp64 g)."""
    U = H * W
    g2 = g.reshape(-1, U, U).to(acc_dtype(g)).sum(0)
    dev = g.device
    u = torch.arange(U, device=dev)
    off = torch.arange(-R, R + 1, device=dev)
    ii = (u // W)[None, None, :] + off[:, None, None]  # [dh, dw, u]
    jj = (u % W)[None, None, :] + off[None, :, None]
    valid = (ii >= 0) & (ii < H) & (jj >= 0) & (jj < W)
    u2 = ii.clamp(0, H - 1) * W + jj.clamp(0, W - 1)
    vals = g2[u.expand_as(u2), u2]
    return pos_w * (vals * valid).sum(-1)


# ---------------------------------------------------------------------------
# The differentiable volume
# ---------------------------------------------------------------------------

class _FusedAggCorr(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, biases, clip, agg_w, agg_b, grid_hw, pos_w):
        vol = fused_agg_corr(q, k, biases, grid_hw, clip, pos_w, agg_w,
                             agg_b)
        ctx.save_for_backward(q, k, biases, clip, agg_w, agg_b, vol)
        ctx.grid_hw, ctx.pos_w = grid_hw, pos_w
        return vol

    @staticmethod
    def backward(ctx, g):
        q, k, biases, clip, agg_w, agg_b, vol = ctx.saved_tensors
        (H, W), pos_w = ctx.grid_hw, ctx.pos_w
        dc, da = agg_corr_bwd(q, k, g.contiguous(), vol, biases, (H, W),
                              clip, pos_w, agg_w)
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq = torch.matmul(dc, k.to(dc.dtype)) * scale
        dk = torch.matmul(dc.transpose(-1, -2), q.to(dc.dtype)) * scale
        del dc
        dbias = sliding_bias_grad(g, H, W, (biases.shape[0] - 1) // 2, pos_w)
        return (dq.to(q.dtype), dk.to(k.dtype), dbias.to(biases.dtype), None,
                da.reshape(agg_w.shape).to(agg_w.dtype), torch.zeros_like(
                    agg_b), None, None)


def fused_agg_corr_diff(q, k, biases, clip, pos_w: float, agg_w, agg_b,
                        grid_hw):
    """The raw aggregated volume [B, U, U] fp32 (B6), differentiable in q,
    k, biases, agg_w and agg_b (whose gradient is 0)."""
    clip = torch.as_tensor(clip, dtype=torch.float32, device=q.device)
    agg_w = torch.as_tensor(agg_w, device=q.device)
    agg_b = torch.as_tensor(agg_b, device=q.device)
    return _FusedAggCorr.apply(q, k, biases, clip, agg_w, agg_b,
                               tuple(grid_hw), pos_w)
