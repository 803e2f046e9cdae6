"""B7: the softmax-probs backward of the f2 and intra attention sites,
beside its plain PyTorch version, joined with B4 into the differentiable
``mode_softmax_probs_diff`` (counterpart of ``craft_tpu/ops/pallas/
probs_vjp.py``).

    c     = scale * q k^T
    l     = clamp(c, +-clip) + pos_w * bias         (clamp before the bias)
    p     = softmax_row(l)                           (B4, float output)
    dl    = p * (g - sum_j g * p)                    (softmax VJP)
    dc    = dl * 1[|c| < clip]
    dq    = dc @ k * scale;  dk = dc^T @ q * scale
    dbias = pos_w * masked diagonal sums of sum_{b,m} dl

The backward starts from the saved probs (what the JAX rule keeps) and
recomputes only c, for the clamp mask.  The kernel (csrc/probs_bwd.cu)
computes dc in the io type and dlsum = sum_{b,m} dl in fp32; dq/dk run as
plain products in the io type with fp32 accumulation, as the JAX package
leaves them to XLA.  Attention dropout stays outside (nn/layers.py).  The
bf16 body (a row-term pass, then wgmma tiles; up to md 64) takes a mode
dim that is a multiple of 16 and 16-byte aligned q, k, p, g and dc, and
its row-term scratch is probs_rowterm_size(...) floats; fp32, and bf16
past md 64 (128 and 256: one or two modes at a 256-wide site), take the
FMA body.
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.corr_vjp import sliding_bias_grad
from craft_tpu_torch.ops.kernels.launch import (F, I, L, P, call, counted,
                                                f32, prep, ptr, stream)
from craft_tpu_torch.ops.kernels.mode_attention import (acc_dtype,
                                                        check_mma_tiles,
                                                        mma_body,
                                                        mode_softmax_probs,
                                                        scores)

_BWD_SIG = [P, P, P, P, P, P, P, P, L, I, I, I, F, I, P]
_B7_ROWS = 64  # csrc/probs_bwd.cu B7_ROWS


def probs_rowterm_size(BM: int, U: int, bf16: int) -> int:
    """The wgmma body's row-term scratch (bf16 = 1 names that body,
    mma_body): one fp32 a row of each of the BM probs matrices, the rows
    padded to its 64-row tiles; none for the FMA body (the kernel refuses
    another size)."""
    return BM * -(-U // _B7_ROWS) * _B7_ROWS if bf16 else 0


def probs_bwd_plain(q, k, p, g, clip):
    dt = acc_dtype(p)
    c = scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    p32, g32 = p.to(dt), g.to(dt)
    dl = p32 * (g32 - (g32 * p32).sum(-1, keepdim=True))
    clip = torch.as_tensor(clip, dtype=c.dtype, device=c.device)
    dc = torch.where(c.abs() < clip, dl, torch.zeros((), dtype=dt,
                                                     device=dl.device))
    return dc.to(p.dtype), dl.reshape(-1, *dl.shape[-2:]).sum(0)


@counted
def probs_bwd(q, k, p, g, clip):
    """(dc [B, M, U, U] in the io type, dlsum [U, U] fp32) from the saved
    probs p and their cotangent g.  q, k: [B, M, U, md]; q, k, p, g share
    one type, bf16 or fp32 (fp64 on the CPU for the gradient checks);
    clip: 0-d tensor or float."""
    if not q.is_cuda:
        return probs_bwd_plain(q, k, p, g, clip)
    (q, k, p, g), bf16 = prep(q, k, p, g)
    B, M, U, md = q.shape
    if k.shape != q.shape or p.shape != (B, M, U, U) or g.shape != p.shape:
        raise ValueError("probs_bwd: q, k [B, M, U, md] and p, g "
                         "[B, M, U, U]")
    dc = torch.empty_like(p)
    check_mma_tiles("probs_bwd", bf16, md, "q, k, p, g and dc", q, k, p, g,
                    dc)
    dlsum = torch.empty(U, U, dtype=torch.float32, device=q.device)
    n_row = probs_rowterm_size(B * M, U, mma_body(bf16, md))
    rowt = torch.empty(n_row, dtype=torch.float32, device=q.device)
    call("probs_bwd", "probs_bwd_launch", _BWD_SIG, ptr(q), ptr(k), ptr(p),
         ptr(g), ptr(f32(clip, q)), ptr(dc), ptr(dlsum), ptr(rowt), n_row,
         B * M, U, md, 1.0 / math.sqrt(md), bf16, stream(q))
    probs_bwd.launches += 1
    return dc, dlsum


class _ModeSoftmaxProbs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, biases, clip, grid_hw, pos_w):
        p = mode_softmax_probs(q, k, biases, grid_hw, clip, pos_w,
                               out_dtype=q.dtype)
        ctx.save_for_backward(q, k, biases, clip, p)
        ctx.grid_hw, ctx.pos_w = grid_hw, pos_w
        return p

    @staticmethod
    def backward(ctx, g):
        q, k, biases, clip, p = ctx.saved_tensors
        (H, W), pos_w = ctx.grid_hw, ctx.pos_w
        dc, dlsum = probs_bwd(q, k, p, g.to(p.dtype), clip)
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq = torch.matmul(dc, k) * scale
        dk = torch.matmul(dc.transpose(-1, -2), q) * scale
        del dc
        dbias = sliding_bias_grad(dlsum, H, W, (biases.shape[0] - 1) // 2,
                                  pos_w)
        return dq, dk, dbias.to(biases.dtype), None, None, None


def mode_softmax_probs_diff(q, k, biases, clip, pos_w: float, grid_hw):
    """Softmax probs [B, M, U, U] in q's type (B4 float), differentiable in
    q, k and biases through B7."""
    clip = torch.as_tensor(clip, dtype=torch.float32, device=q.device)
    return _ModeSoftmaxProbs.apply(q, k, biases, clip, tuple(grid_hw), pos_w)
