"""Optical-flow visualisation with the Baker colour wheel (port of
``craft_tpu.data.flow_viz``; reference core/utils/flow_viz.py:21-143).

``flow_to_image`` maps a [H, W, 2] flow to a uint8 [H, W, 3] image in
numpy, with the JAX package's arithmetic, so both give the same bytes.
``warp_flow`` backward-warps an image by a flow through
``torch.nn.functional.grid_sample`` (the JAX package calls ``cv2.remap``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SECTORS = (("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13),
            ("MR", 6))


def make_colorwheel() -> np.ndarray:
    """The 55 colours of the wheel over its RY/YG/GC/CB/BM/MR sectors,
    float64 [55, 3] in [0, 255]."""
    wheel = np.zeros((sum(n for _, n in _SECTORS), 3))
    col = 0
    for name, n in _SECTORS:
        ramp = np.floor(255 * np.arange(n) / n)
        # (channel held at 255, channel ramped, rising or falling)
        full, moving, rising = {"RY": (0, 1, True), "YG": (1, 0, False),
                                "GC": (1, 2, True), "CB": (2, 1, False),
                                "BM": (2, 0, True), "MR": (0, 2, False)}[name]
        wheel[col:col + n, full] = 255
        wheel[col:col + n, moving] = ramp if rising else 255 - ramp
        col += n
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Colours of normalised flow components (|(u, v)| <= 1 inside the
    wheel; beyond it the colour dimmed by 0.75).  uint8 [H, W, 3]."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = np.where(k0 + 1 == ncols, 0, k0 + 1)
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] / 255.0 + f * wheel[k1] / 255.0
    in_range = (rad <= 1)[..., None]
    col = np.where(in_range, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col).astype(np.uint8)
    return img[..., ::-1] if convert_to_bgr else img


def flow_to_image(flow_uv: np.ndarray, clip_flow=None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> uint8 [H, W, 3], scaled by its largest radius."""
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow_uv.shape}")
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    scale = np.sqrt(u ** 2 + v ** 2).max() + 1e-5
    return flow_uv_to_colors(u / scale, v / scale, convert_to_bgr)


def warp_flow(image2: np.ndarray, flowgt: np.ndarray) -> np.ndarray:
    """image2 sampled bilinearly at x + flow (reference flow_viz.py:135-143):
    [H, W, C] -> [H, W, C] of image2's dtype, zero outside the image.
    OpenCV's remap, which the JAX package calls, rounds the coordinates to
    1/32 px and uint8 results to integers: within 1/32 of the largest step
    between neighbours (plus 0.5 for uint8) of it."""
    H, W, C = image2.shape
    xs = flowgt[..., 0].astype(np.float32) + np.arange(W, dtype=np.float32)
    ys = flowgt[..., 1].astype(np.float32) + \
        np.arange(H, dtype=np.float32)[:, None]
    grid = torch.from_numpy(np.stack([2 * xs / max(W - 1, 1) - 1,
                                      2 * ys / max(H - 1, 1) - 1], -1))
    img = torch.from_numpy(np.ascontiguousarray(image2, np.float32))
    out = F.grid_sample(img.permute(2, 0, 1)[None].double(),
                        grid[None].double(), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    out = out[0].permute(1, 2, 0).numpy()
    if image2.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(image2.dtype)
