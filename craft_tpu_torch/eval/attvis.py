"""Attention and correlation dumps and their heat maps (PyTorch port of
``craft_tpu.eval.attvis``; reference attvis.py:33-138).

``dump_attention`` runs the model once in eval mode with a capture dict
(``FlowModel.forward(intermediates=...)``, the port's stand-in for flax's
``sow`` into the 'intermediates' collection) and saves what it holds to an
.npz: the raw correlation volume [B, D, U1, U2] under 'corr_fn/corr_volume'
and each SETrans site's [B, M, U, U] probs under '<site>/setrans/
attn_probs', the keys and shapes of the JAX dump on the CPU.  While it
captures, every SETrans site takes the plain path (no B2, B3 or B4), as the
JAX package's sites take XLA's.  Arrays are saved as fp32.

``vis_attention`` renders per-query heat maps (median-subtracted, JET)
over frame 2 in numpy, with PIL's bilinear resize of a uint8 map
(``resize_bilinear_pil``, Pillow's fixed-point two-pass resampler) and the
port's PNG writer, since the card's machine has neither PIL nor OpenCV.
"""

from __future__ import annotations

import math
import os
import os.path as osp
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from craft_tpu_torch.data import imgio

# Pillow's Resample.c: fixed-point coefficients of 32 - 8 - 2 bits.
_PRECISION_BITS = 22


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear (triangle) filter: per output index its first input index and
    the int coefficients of its window [out, ksize]."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale))
             for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            v = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = int((-0.5 if v < 0 else 0.5)
                            + v * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One uint8 resampling pass of Pillow's along `axis` (0 rows, 1
    columns): each output the rounded, clipped fixed-point sum."""
    first, kk = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]),
                     src.shape[0] - 1)
    acc = (src[idx] * kk.reshape(*kk.shape, *([1] * (src.ndim - 1)))).sum(1)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.moveaxis(np.clip(acc, 0, 255).astype(np.uint8), 0, axis)


def resize_bilinear_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.array(PIL.Image.fromarray(img).resize(size, Image.BILINEAR))``
    of a uint8 [H, W] image, size = (W', H'): the horizontal pass, then the
    vertical, each skipped where its size is unchanged."""
    out = img
    if size[0] != img.shape[1]:
        out = _pil_pass(out, size[0], 1)
    if size[1] != img.shape[0]:
        out = _pil_pass(out, size[1], 0)
    return out


def dump_attention(cfg, state_dict, image1: np.ndarray, image2: np.ndarray,
                   save_path: str, iters: int = 12,
                   device=None) -> Dict[str, np.ndarray]:
    """Run the model on one batch (NHWC frames in [0, 255]) capturing the
    volume and the attention probs; save them to `save_path` (.npz) and
    return them.  `state_dict` holds the model's weights (reference keys);
    `device` as ``create_model``'s."""
    from craft_tpu_torch.models.flow_model import create_model

    model = create_model(cfg, device)
    model.load_state_dict(state_dict, strict=True)
    dev = next(model.parameters()).device
    inter: Dict[str, torch.Tensor] = {}
    with torch.inference_mode():
        model(torch.as_tensor(image1, dtype=torch.float32, device=dev),
              torch.as_tensor(image2, dtype=torch.float32, device=dev),
              iters=iters, intermediates=inter)
    dumps = {k: v.float().cpu().numpy() for k, v in inter.items()}
    np.savez_compressed(save_path, **dumps)
    print(f"Attention dumps saved to {save_path}: "
          f"{ {k: v.shape for k, v in dumps.items()} }")
    return dumps


def _jet(x: np.ndarray) -> np.ndarray:
    """JET colormap on [0, 1] -> uint8 RGB."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def vis_attention(attn: np.ndarray, image2: np.ndarray,
                  query_points: Sequence[Tuple[int, int]],
                  out_dir: str, grid_hw: Tuple[int, int],
                  alpha: float = 0.5, prefix: str = "att") -> int:
    """Render attention heat maps for query points; returns how many PNGs
    it wrote (``{prefix}_{qy}_{qx}.png`` under `out_dir`).

    attn: [U, U] (or [M, U, U]: modes averaged) attention over a grid_hw
    1/8-resolution grid; image2: [H, W, 3] in [0, 255]; query_points as
    1/8-resolution (row, col) cells."""
    if attn.ndim == 3:
        attn = attn.mean(0)
    H8, W8 = grid_hw
    H, W = image2.shape[:2]
    os.makedirs(out_dir, exist_ok=True)
    n_saved = 0
    for (qy, qx) in query_points:
        if not (0 <= qy < H8 and 0 <= qx < W8):
            print(f"query point ({qy},{qx}) outside the {H8}x{W8} 1/8-res "
                  "grid; skipped")
            continue
        amap = attn[qy * W8 + qx].reshape(H8, W8)
        # Median-subtracted for contrast (reference attvis.py:70-80).
        amap = amap - np.median(amap)
        amap = np.maximum(amap, 0)
        amap = amap / (amap.max() + 1e-8)
        amap_img = resize_bilinear_pil((amap * 255).astype(np.uint8),
                                       (W, H))
        heat = _jet(amap_img / 255.0).astype(np.float32)
        overlay = ((1 - alpha) * image2.astype(np.float32)
                   + alpha * heat).astype(np.uint8)
        # The query's 8 x 8 cell, outlined in white.
        y0, x0 = qy * 8, qx * 8
        overlay[y0:y0 + 8, x0] = 255
        overlay[y0:y0 + 8, min(x0 + 7, W - 1)] = 255
        overlay[y0, x0:x0 + 8] = 255
        overlay[min(y0 + 7, H - 1), x0:x0 + 8] = 255
        imgio.write_png(osp.join(out_dir, f"{prefix}_{qy}_{qx}.png"),
                        overlay)
        n_saved += 1
    print(f"Saved {n_saved} attention maps to {out_dir}")
    return n_saved
