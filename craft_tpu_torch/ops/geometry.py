"""Sampling, coordinate grids, convex upsampling and padding (PyTorch port of
``craft_tpu.ops.geometry``).

Image-like tensors are NHWC; flow/coords tensors carry their 2-vector in the
trailing axis in (x, y) order (reference core/utils/utils.py:14-139).  The
shift protocol and the forward splat of the warm start work on the host in
numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 2] pixel-coordinate grid, channels (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(ht, device=device, dtype=dtype),
                            torch.arange(wd, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, ht, wd, 2)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling at pixel coordinates, zero outside the image.

    Equals ``F.grid_sample(align_corners=True, padding_mode='zeros')`` on
    pixel coordinates.  img [B, H, W, C], coords [B, h, w, 2] (x, y);
    returns [B, h, w, C] float32."""
    B, H, W, C = img.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(B, H * W, C).float()

    def tap(yi, xi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        v = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return v.reshape(*idx.shape, C) * (w * valid)[..., None]

    return (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))


def _convex_parts(flow: torch.Tensor, mask: torch.Tensor,
                  factor: int) -> torch.Tensor:
    """The convex combination both layouts share: [B, H, W, 2, f^2], the x
    then the y component of each (fr, fc) sub-pixel, row-major."""
    B, H, W, _ = flow.shape
    f2 = factor * factor
    w = torch.softmax(mask.reshape(B, H, W, 9, f2), dim=3)
    fp = F.pad(factor * flow, (0, 0, 1, 1, 1, 1))
    # The 9 neighbours in F.unfold's order: row-major offsets (-1,-1)..(1,1).
    nb = torch.stack([fp[:, di:di + H, dj:dj + W, :]
                      for di in range(3) for dj in range(3)], dim=3)
    return torch.einsum("bhwkf,bhwkc->bhwcf", w, nb)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Convex 9-neighbour upsampling (reference network.py:151-162).

    flow [B, H, W, 2]; mask [B, H, W, 9*factor^2] logits laid out
    (9, factor, factor) row-major.  Returns [B, factor*H, factor*W, 2]."""
    B, H, W, _ = flow.shape
    return unpack_upsampled(
        _convex_parts(flow, mask, factor).reshape(B, H, W, -1), factor)


def convex_upsample_packed(flow: torch.Tensor, mask: torch.Tensor,
                           factor: int = 8) -> torch.Tensor:
    """convex_upsample without the pixel shuffle: [B, H, W, 2*factor^2],
    the x sub-pixel block (row-major (fr, fc)) in channels [:f^2] and y in
    [f^2:], the same bits as convex_upsample's values."""
    B, H, W, _ = flow.shape
    return _convex_parts(flow, mask, factor).reshape(B, H, W, -1)


def unpack_upsampled(packed: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """[B, H, W, 2*factor^2] packed flow -> [B, factor*H, factor*W, 2]."""
    B, H, W, c2 = packed.shape
    assert c2 == 2 * factor * factor
    up = packed.reshape(B, H, W, 2, factor, factor).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, factor * H, factor * W, 2)


def pack_fullres(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Inverse of unpack_upsampled, for the ground truth: [B, fH, fW, C] ->
    [B, H, W, C*factor^2], each channel's (fr, fc) block contiguous."""
    B, FH, FW, C = x.shape
    H, W = FH // factor, FW // factor
    x = x.reshape(B, H, factor, W, factor, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, H, W, C * factor * factor)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool on NHWC, odd edges dropped (floor)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class InputPadder:
    """Pads NHWC images so H, W divide by `mod` (reference utils.py:14-31).

    mode='sintel' pads symmetrically; otherwise ('kitti') width is centred
    and height is padded at the bottom.  Replicate-edge padding."""

    def __init__(self, dims: Sequence[int], mode: str = "sintel",
                 mod: int = 8):
        self.ht, self.wd = dims[-3], dims[-2]
        pad_ht = (((self.ht // mod) + 1) * mod - self.ht) % mod
        pad_wd = (((self.wd // mod) + 1) * mod - self.wd) % mod
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        return [F.pad(x.permute(0, 3, 1, 2), self._pad,
                      mode="replicate").permute(0, 2, 3, 1)
                for x in inputs]

    def unpad(self, x):
        ht, wd = x.shape[1], x.shape[2]
        l, r, t, b = self._pad
        return x[:, t:ht - b, l:wd - r, :]


def shift_pixels(img1: np.ndarray, flow: np.ndarray, valid, dx: int,
                 dy: int):
    """The shift-robustness protocol (reference evaluate.py:44-89), on the
    host in numpy: image1 and the ground-truth flow translated by (dx, dy)
    (positive dx moves content right, positive dy down), the flow less the
    offset, the vacated border zero and invalid.

    img1 [H, W, 3]; flow [H, W, 2]; valid [H, W] or None (dense ground
    truth: all valid).  Returns (img1, flow, valid) shifted."""
    H, W = img1.shape[:2]
    if valid is None:
        valid = np.ones((H, W), dtype=np.float32)
    out_img = np.zeros_like(img1)
    out_flow = np.zeros_like(flow)
    out_valid = np.zeros_like(valid)
    sy0, sy1 = max(0, dy), min(H, H + dy)
    sx0, sx1 = max(0, dx), min(W, W + dx)
    ty0, ty1 = max(0, -dy), min(H, H - dy)
    tx0, tx1 = max(0, -dx), min(W, W - dx)
    # Content at source [ty0:ty1, tx0:tx1] lands at target [sy0:sy1, sx0:sx1].
    out_img[sy0:sy1, sx0:sx1] = img1[ty0:ty1, tx0:tx1]
    out_flow[sy0:sy1, sx0:sx1] = flow[ty0:ty1, tx0:tx1]
    out_flow[sy0:sy1, sx0:sx1, 0] -= dx
    out_flow[sy0:sy1, sx0:sx1, 1] -= dy
    out_valid[sy0:sy1, sx0:sx1] = valid[ty0:ty1, tx0:tx1]
    return out_img, out_flow, out_valid


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """A [H, W, 2] flow splatted forward to the next frame by nearest
    neighbour (reference utils.py:34-62; the Sintel submission's warm
    start), on the host with scipy, as the JAX package."""
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest",
                                  fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest",
                                  fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)
