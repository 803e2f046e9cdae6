"""The four SETrans attention kernels of the inference path, each beside its
plain PyTorch version (counterparts of ``craft_tpu/ops/pallas/
mode_attention.py``):

  B1 scores_global_max      max of scale * q k^T (the clamp predicate)
  B2 flash_mode_attention   softmax(clamp(s) + pos_w * bias) @ v, f2 site
  B3 fused_agg_corr_norm    clamped, mode-aggregated, globally normed
                            volume, inter site
  B4 mode_softmax_probs     softmax probs (float, or int8 + row scale),
                            intra site

q and k are [B, M, U, md] with U = H8 * W8 row-major tokens; the sliding
bias is the (2R+1)^2 window `biases`.  The tensor decides the route: CUDA
tensors launch the hand-written kernel (csrc/*.cu) or raise, CPU tensors
take the plain version.  Each kernel's launches are counted in
``<wrapper>.launches`` where the kernel is launched: B1's count includes
the B1 launch that B3 makes as its phase 0.  The clamp value `clip` is a device tensor, so the
predicate never syncs the host.
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.launch import (F as _F, I as _I,
                                                MAX_MODE_DIM, P as _P,
                                                call, counted, f32 as _f32,
                                                prep as _prep, ptr as _ptr,
                                                stream as _stream)

_SIGNATURES = {
    "scores_max_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "flash_attn_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _F, _I, _P],
    "corr_norm_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _F, _F, _I, _I, _P],
    "probs_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                     _I, _P],
}
_LIB_OF = {"scores_max_launch": "scores_max",
           "flash_attn_launch": "flash_attn",
           "corr_norm_launch": "corr_norm",
           "probs_launch": "softmax_probs"}
FLASH_FEAT = 256  # csrc/flash_attn.cu FEAT: the f2 site's feature width
# Scratch sizes follow the kernels' tiling (csrc/common.cuh TILE,
# csrc/corr_norm.cu KGROUP).
_TILE, _KGROUP = 64, 8
assert MAX_MODE_DIM == 64  # csrc/common.cuh MAXMD


def _call(fn_name: str, *args) -> None:
    call(_LIB_OF[fn_name], fn_name, _SIGNATURES[fn_name], *args)


# ---------------------------------------------------------------------------
# Plain PyTorch pieces shared by the plain versions
# ---------------------------------------------------------------------------

def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: fp32, or fp64 for fp64 inputs (the
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def sliding_pos_biases(biases: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Dense [H*W, H*W] table of the (2R+1)^2 window: pos[i*W+j, h*W+w] =
    biases[h-i+R, w-j+R] when |h-i| <= R and |w-j| <= R, else 0."""
    R = (biases.shape[0] - 1) // 2
    ar_h = torch.arange(H, device=biases.device)
    ar_w = torch.arange(W, device=biases.device)
    dh = ar_h[None, :] - ar_h[:, None]
    dw = ar_w[None, :] - ar_w[:, None]
    ih = (dh + R).clamp(0, 2 * R)
    iw = (dw + R).clamp(0, 2 * R)
    table = biases[ih][:, :, iw]  # [i, h, j, w]
    mask = (dh.abs() <= R)[:, :, None, None] & (dw.abs() <= R)[None, None]
    return (table * mask).permute(0, 2, 1, 3).reshape(H * W, H * W)


def scores(q, k, scale):
    """scale * q k^T, [B, M, U, U] in acc_dtype(q)."""
    dt = acc_dtype(q)
    return torch.einsum("bmid,bmjd->bmij", q.to(dt), k.to(dt)) * scale


def biased_scores(q, k, biases, grid_hw, clip, pos_w):
    """(c, clamp(c, +-clip) + pos_w * bias) with c = scale * q k^T, both
    [B, M, U, U] in acc_dtype(q)."""
    c = scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    clip = torch.as_tensor(clip, dtype=c.dtype, device=c.device)
    s = torch.minimum(torch.maximum(c, -clip), clip)
    return c, s + pos_w * sliding_pos_biases(biases.to(c.dtype), *grid_hw)


# ---------------------------------------------------------------------------
# B1: global max of the scores
# ---------------------------------------------------------------------------

def _launch_scores_max(q, k, scale) -> torch.Tensor:
    (q, k), bf16 = _prep(q, k)
    B, M, U, md = q.shape
    nq = -(-U // _TILE)
    partial = torch.empty(B * M * nq, dtype=torch.float32, device=q.device)
    out = torch.empty(1, dtype=torch.float32, device=q.device)
    _call("scores_max_launch", _ptr(q), _ptr(k), _ptr(partial), _ptr(out),
          B * M, U, md, scale, bf16, _stream(q))
    scores_global_max.launches += 1
    return out


def scores_global_max_plain(q, k, scale: float) -> torch.Tensor:
    return scores(q, k, scale).amax()


@counted
def scores_global_max(q: torch.Tensor, k: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Max of scale * q_m k_m^T over batch, modes and tokens, as a 0-d fp32
    tensor on q's device.  q, k: [B, M, U, md]."""
    if not q.is_cuda:
        return scores_global_max_plain(q, k, scale)
    return _launch_scores_max(q, k, scale)[0]


# ---------------------------------------------------------------------------
# B2: flash multi-mode attention with the sliding bias
# ---------------------------------------------------------------------------

def flash_mode_attention_plain(q, k, v, biases, grid_hw, clip, pos_w):
    p = torch.softmax(biased_scores(q, k, biases, grid_hw, clip, pos_w)[1],
                      -1)
    return (p @ v.float()).to(v.dtype)


@counted
def flash_mode_attention(q, k, v, biases, grid_hw, clip, pos_w: float):
    """out[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * bias) @ v.

    q, k: [B, M, U, md]; v: [B, M, U, F]; biases: [2R+1, 2R+1];
    clip: 0-d tensor.  Returns [B, M, U, F] in v's dtype."""
    if not q.is_cuda:
        return flash_mode_attention_plain(q, k, v, biases, grid_hw, clip,
                                          pos_w)
    (q, k, v), bf16 = _prep(q, k, v)
    B, M, U, md = q.shape
    F = v.shape[-1]
    if F != FLASH_FEAT:
        raise ValueError(f"flash_mode_attention: feature dim {F}, the kernel "
                         f"takes {FLASH_FEAT}")
    R = (biases.shape[0] - 1) // 2
    out = torch.empty_like(v)
    win, clip_t = _f32(biases, q), _f32(clip, q)
    _call("flash_attn_launch", _ptr(q), _ptr(k), _ptr(v), _ptr(out),
          _ptr(win), _ptr(clip_t), B * M, U, md, F, grid_hw[1], R,
          1.0 / math.sqrt(md), pos_w, bf16, _stream(q))
    flash_mode_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# B3: fused clamp + mode aggregation + global layer norm
# ---------------------------------------------------------------------------

def fused_agg_corr_norm_plain(q, k, biases, grid_hw, attn_clip, pos_w,
                              agg_w, agg_b, out_dtype=torch.bfloat16,
                              eps: float = 1e-12):
    B, M, U, md = q.shape
    c = scores(q, k, 1.0 / math.sqrt(md))
    gmax = c.amax()
    clip = torch.where(gmax > attn_clip, attn_clip, 1e30)
    s = torch.minimum(torch.maximum(c, -clip), clip) \
        + pos_w * sliding_pos_biases(biases.float(), *grid_hw)
    del c
    lg = agg_w * s + agg_b
    e = torch.exp(lg - lg.amax(dim=1, keepdim=True))
    del lg
    vol = (e * s).sum(dim=1) / e.sum(dim=1)
    del e, s
    mean = vol.double().mean(dim=(1, 2))
    ex2 = vol.double().square().mean(dim=(1, 2))
    rstd = torch.rsqrt((ex2 - mean * mean).clamp(min=0.0) + eps)
    out = (vol - mean.float().view(B, 1, 1)) * rstd.float().view(B, 1, 1)
    stats = torch.stack([gmax.expand(B), mean.float(), ex2.float(),
                         torch.zeros_like(gmax).expand(B)], dim=-1)
    return out.to(out_dtype), stats.view(B, 1, 4)


@counted
def fused_agg_corr_norm(q, k, biases, grid_hw, attn_clip: float,
                        pos_w: float, agg_w, agg_b,
                        out_dtype=torch.bfloat16, eps: float = 1e-12):
    """The inter-frame volume in one call.

    s_m = clamp(scale q_m k_m^T, +-clip) + pos_w * bias with clip =
    attn_clip if the batch-global raw max exceeds attn_clip (else 1e30);
    vol = sum_m softmax_m(agg_w s_m + agg_b) s_m; returns
    ((vol - mean) * rsqrt(var + eps) as [B, U, U] out_dtype,
     stats [B, 1, 4] fp32 = (raw max, mean, E[x^2], 0)), with per-sample
    moments over the whole volume.  q, k: [B, M, U, md]."""
    if not q.is_cuda:
        return fused_agg_corr_norm_plain(q, k, biases, grid_hw, attn_clip,
                                         pos_w, agg_w, agg_b, out_dtype, eps)
    B, M, U, md = q.shape
    scale = 1.0 / math.sqrt(md)
    if M != 4:
        raise ValueError(f"fused_agg_corr_norm: {M} modes, the kernel takes 4")
    (q, k), bf16 = _prep(q, k)
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            out_dtype == torch.bfloat16 and not bf16):
        raise ValueError(f"fused_agg_corr_norm: {q.dtype} -> {out_dtype}; "
                         "the kernel takes bf16 -> bf16, bf16 -> fp32 and "
                         "fp32 -> fp32")
    gmax = _launch_scores_max(q, k, scale)  # phase 0: the raw max (B1)
    R = (biases.shape[0] - 1) // 2
    nq = -(-U // _TILE)
    nblk = nq * -(-nq // _KGROUP)
    dev = q.device
    partial = torch.empty(B * nblk * 2, dtype=torch.float64, device=dev)
    stats = torch.empty(B, 1, 4, dtype=torch.float32, device=dev)
    norm = torch.empty(B, 2, dtype=torch.float32, device=dev)
    out = torch.empty(B, U, U, dtype=out_dtype, device=dev)
    win = _f32(biases, q)
    scal = torch.cat([_f32(attn_clip, q), _f32(pos_w, q), _f32(agg_w, q),
                      _f32(agg_b, q)])
    _call("corr_norm_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(scal),
          _ptr(gmax), _ptr(partial), _ptr(stats), _ptr(norm), _ptr(out), B,
          U, md, grid_hw[1], R, scale, eps, bf16,
          int(out_dtype == torch.bfloat16), _stream(q))
    fused_agg_corr_norm.launches += 1
    return out, stats


# ---------------------------------------------------------------------------
# B4: blockwise softmax probabilities
# ---------------------------------------------------------------------------

def mode_softmax_probs_plain(q, k, biases, grid_hw, clip, pos_w,
                             out_dtype=torch.bfloat16, quantized=False):
    _, s = biased_scores(q, k, biases, grid_hw, clip, pos_w)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    l = e.sum(dim=-1, keepdim=True)
    if quantized:
        return torch.round(e * 127.0).to(torch.int8), 1.0 / (127.0 * l)
    return (e / l).to(out_dtype)


@counted
def mode_softmax_probs(q, k, biases, grid_hw, clip, pos_w: float,
                       out_dtype=torch.bfloat16, quantized: bool = False):
    """probs[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * bias).

    Returns [B, M, U, U] out_dtype, or with quantized=True the int8
    numerators round(exp(s - rowmax) * 127) [B, M, U, U] and fp32 row
    scales 1 / (127 * l) [B, M, U, 1] (probs = num * scale)."""
    if not q.is_cuda:
        return mode_softmax_probs_plain(q, k, biases, grid_hw, clip, pos_w,
                                        out_dtype, quantized)
    (q, k), bf16 = _prep(q, k)
    if not bf16 and (quantized or out_dtype != torch.float32):
        raise ValueError("mode_softmax_probs: fp32 inputs take fp32 output "
                         "only")
    B, M, U, md = q.shape
    R = (biases.shape[0] - 1) // 2
    dev = q.device
    if quantized:
        out = torch.empty(B, M, U, U, dtype=torch.int8, device=dev)
        row_scale = torch.empty(B, M, U, 1, dtype=torch.float32, device=dev)
        kind = 2
    else:
        kind = {torch.float32: 0, torch.bfloat16: 1}[out_dtype]
        out = torch.empty(B, M, U, U, dtype=out_dtype, device=dev)
        row_scale = out  # not written
    win, clip_t = _f32(biases, q), _f32(clip, q)
    _call("probs_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(clip_t),
          _ptr(out), _ptr(row_scale), B * M, U, md, grid_hw[1], R,
          1.0 / math.sqrt(md), pos_w, bf16, kind, _stream(q))
    mode_softmax_probs.launches += 1
    return (out, row_scale) if quantized else out


KERNELS = (scores_global_max, flash_mode_attention, fused_agg_corr_norm,
           mode_softmax_probs)
