"""B5: the windowed multi-level lookup of the correlation pyramid and its
backward, each beside its plain PyTorch version, joined into the
differentiable ``corr_lookup_diff`` (counterparts of
``craft_tpu/ops/pallas/corr_lookup.py``: ``corr_lookup_pallas`` forward and
the XLA VJP that ``corr_lookup_tpu`` takes as its backward).

The pyramid is a sequence of planes [Q, h, w] (Q = B * H1 * W1 queries,
bf16 or fp32) in (level, d) order: L levels of `dim` = D planes each, D = 1
for the one-way volume and D = 2 for the two-way one (--f1), plane p
belonging to level p // D.  (The JAX package interleaves D into the lane
axis of one [Q, h, w * D] array per level, ``craft_tpu/ops/corr.py:24-30``,
a TPU tiling choice; the lookup's values are the same.)  coords are
[B, H1, W1, 2] (x, y) fp32.  For every plane the lookup samples the
(2r+1)^2 window around coords / 2^(p // D) bilinearly, align_corners
semantics, zero outside the level, and returns [B, H1, W1, L * D * (2r+1)^2]
fp32 in the reference channel order: level, then d, then x-offset i, then
y-offset j (reference corr.py:47-71).  The backward returns the dense plane
gradients in the level type, zero outside the windows; coords get none (the
model detaches them every iteration, and the JAX VJP returns zeros).

CUDA tensors launch the hand-written kernels (csrc/corr_lookup.cu) or raise;
CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from craft_tpu_torch.ops.kernels.launch import (I, P, call, check_cuda,
                                                counted, ptr, stream)
from craft_tpu_torch.ops.kernels.mode_attention import acc_dtype

_SIG = [P, P, I, I, P, P, I, I, I, P]  # both launchers of the .cu
MAX_PLANES, MAX_RADIUS = 8, 7  # csrc/corr_lookup.cu MAXP, MAXR


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def corr_lookup_plain(levels, coords: torch.Tensor, radius: int,
                      dim: int = 1) -> torch.Tensor:
    """The lookup by gather.  All (2r+1)^2 taps of a query share one
    fractional offset, so each plane gathers the (2r+2)^2 integer grid
    around the window once and blends it with one bilinear lerp; taps
    outside the level read zero (grid_sample zero padding).  Plane p is
    sampled at coords / 2^(p // dim).  Sums run in fp32 (fp64 for fp64
    levels)."""
    r = radius
    B, H1, W1, _ = coords.shape
    n = 2 * r + 1
    Q = B * H1 * W1
    acc = acc_dtype(levels[0])
    flat = coords.reshape(Q, 2).to(acc)
    t = torch.arange(n + 1, device=coords.device)
    out = []
    for i, level in enumerate(levels):
        h, w = level.shape[1], level.shape[2]
        if h == 0 or w == 0:  # a level pooled away reads zero everywhere
            out.append(flat.new_zeros(B, H1, W1, n * n))
            continue
        base = flat / (2.0 ** (i // dim))
        x0, y0 = torch.floor(base[:, 0]), torch.floor(base[:, 1])
        fx = (base[:, 0] - x0)[:, None, None]
        fy = (base[:, 1] - y0)[:, None, None]
        cols = x0.long()[:, None] - r + t[None]  # [Q, n+1]
        rows = y0.long()[:, None] - r + t[None]
        valid = (((rows >= 0) & (rows < h))[:, :, None]
                 & ((cols >= 0) & (cols < w))[:, None, :])
        idx = rows.clamp(0, h - 1)[:, :, None] * w \
            + cols.clamp(0, w - 1)[:, None, :]  # [Q, y, x]
        g = torch.gather(level.reshape(Q, h * w), 1, idx.reshape(Q, -1))
        g = g.reshape(Q, n + 1, n + 1).to(acc) * valid
        # g[q, y, x]: blend rows (y) then columns (x).
        gy = (1 - fy) * g[:, :n] + fy * g[:, 1:]          # [Q, j, x]
        win = (1 - fx) * gy[:, :, :n] + fx * gy[:, :, 1:]  # [Q, j, i]
        out.append(win.transpose(1, 2).reshape(B, H1, W1, n * n))
    return torch.cat(out, dim=-1)


def corr_lookup_bwd_plain(coords, g, shapes, dtype, radius: int,
                          dim: int = 1):
    """Dense plane gradients (one per shape in `shapes`, in `dtype`) of the
    plain lookup for the output cotangent g: autograd through the gather.
    The lookup is linear in the planes, so their values do not matter."""
    with torch.enable_grad():
        levels = [torch.zeros(s, dtype=dtype, device=coords.device,
                              requires_grad=True) for s in shapes]
        out = corr_lookup_plain(levels, coords.detach(), radius, dim)
        grads = torch.autograd.grad(out, levels, g.to(out.dtype),
                                    allow_unused=True)
    # A level pooled to zero rows takes no part: its gradient is empty.
    return tuple(torch.zeros_like(lv) if d is None else d
                 for lv, d in zip(levels, grads))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _prep(levels, coords, radius, dim, what):
    """Check the kernel's inputs: one CUDA device, fp32 coords [B, H1, W1,
    2], 1..8 planes of one type (bf16 or fp32) [Q, h, w], a whole number of
    levels of `dim` planes, r <= 7.  Returns (contiguous planes, [Q, 2]
    coords, Q, the host arrays of the plane pointers and of their sizes
    h_0, w_0, h_1, ...)."""
    check_cuda(coords, *levels)
    B, H1, W1, two = coords.shape
    Q = B * H1 * W1
    dt = levels[0].dtype
    if two != 2 or coords.dtype != torch.float32:
        raise ValueError(f"{what}: coords must be [B, H1, W1, 2] fp32")
    if not 1 <= len(levels) <= MAX_PLANES or dim < 1 or len(levels) % dim \
            or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{what}: 1..{MAX_PLANES} planes, whole levels of "
                         f"{dim}, and radius <= {MAX_RADIUS}")
    for lv in levels:
        if lv.dim() != 3 or lv.shape[0] != Q or lv.dtype != dt or \
                dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{what}: levels must be [{Q}, h, w] of one "
                             f"type, bf16 or fp32")
    levels = [lv.contiguous() for lv in levels]
    ptrs = (ctypes.c_void_p * len(levels))(*[lv.data_ptr() for lv in levels])
    hw = (ctypes.c_int * (2 * len(levels)))(
        *[d for lv in levels for d in lv.shape[1:]])
    return levels, coords.reshape(Q, 2).contiguous(), Q, ptrs, hw


@counted
def corr_lookup(levels, coords: torch.Tensor, radius: int,
                dim: int = 1) -> torch.Tensor:
    """The windowed lookup [B, H1, W1, L D (2r+1)^2] fp32 (fp64 for fp64
    levels on the CPU) of the L D planes `levels`."""
    if not coords.is_cuda:
        return corr_lookup_plain(levels, coords, radius, dim)
    levels, flat, Q, ptrs, hw = _prep(levels, coords, radius, dim,
                                      "corr_lookup")
    n = 2 * radius + 1
    out = torch.empty(*coords.shape[:3], len(levels) * n * n,
                      dtype=torch.float32, device=coords.device)
    call("corr_lookup", "corr_lookup_launch", _SIG, ptrs, hw,
         len(levels), dim, ptr(flat), ptr(out), Q, radius,
         int(levels[0].dtype == torch.bfloat16), stream(coords))
    corr_lookup.launches += 1
    # 12 per tap: the bilinear blend of its four corners.
    corr_lookup.flops += 12.0 * Q * len(levels) * n * n
    return out


@counted
def corr_lookup_bwd(coords: torch.Tensor, g: torch.Tensor, shapes, dtype,
                    radius: int, dim: int = 1):
    """The dense plane gradients, one [Q, h, w] tensor in `dtype` per entry
    of `shapes` (the planes in (level, d) order, `dim` a level), for the
    output cotangent g [B, H1, W1, L D (2r+1)^2] fp32."""
    if not coords.is_cuda:
        return corr_lookup_bwd_plain(coords, g, shapes, dtype, radius, dim)
    dlevels = [torch.empty(s, dtype=dtype, device=coords.device)
               for s in shapes]
    dlevels, flat, Q, ptrs, hw = _prep(dlevels, coords, radius, dim,
                                       "corr_lookup_bwd")
    n = 2 * radius + 1
    if g.shape != (*coords.shape[:3], len(shapes) * n * n) or \
            g.dtype != torch.float32 or g.device != coords.device:
        raise ValueError("corr_lookup_bwd: g must be [B, H1, W1, "
                         "L D (2r+1)^2] fp32 on the coords' device")
    g = g.contiguous()
    call("corr_lookup", "corr_lookup_bwd_launch", _SIG, ptrs, hw,
         len(dlevels), dim, ptr(flat), ptr(g), Q, radius,
         int(dtype == torch.bfloat16), stream(coords))
    corr_lookup_bwd.launches += 1
    return tuple(dlevels)


# ---------------------------------------------------------------------------
# The differentiable lookup
# ---------------------------------------------------------------------------

class _CorrLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, coords, radius, dim, *levels):
        out = corr_lookup(levels, coords, radius, dim)
        ctx.save_for_backward(coords)
        ctx.radius, ctx.dim = radius, dim
        ctx.shapes = [tuple(lv.shape) for lv in levels]
        ctx.dtype = levels[0].dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        dlevels = corr_lookup_bwd(coords, g.to(acc_dtype(g)), ctx.shapes,
                                  ctx.dtype, ctx.radius, ctx.dim)
        return (None, None, None, *dlevels)


def corr_lookup_diff(levels, coords: torch.Tensor, radius: int,
                     dim: int = 1) -> torch.Tensor:
    """The lookup (B5), differentiable in the planes; coords get no
    gradient."""
    return _CorrLookup.apply(coords.detach(), radius, dim, *levels)
