"""Flow for one image pair (port of ``craft_tpu.eval.demo``; reference
gen_flow, evaluate.py:1251-1384): read both frames, optionally scale them
down and shift image1 (the shift protocol), pad to a multiple of 8, run
the model, unpad, and write the flow's flow_viz PNG.  With a ground-truth
flow it prints the EPE and clips the drawn radii to the ground truth's
largest.  With calc_flop it prints the FLOPs of the forward instead.
Under sequence parallelism every rank computes the flow and rank 0 prints
and writes it.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.data import flow_viz, frame_utils, imgio
from craft_tpu_torch.data.augmentor import resize_linear
from craft_tpu_torch.eval.evaluate import Evaluator, _epe, _pad
from craft_tpu_torch.ops.geometry import InputPadder, shift_pixels
from craft_tpu_torch.parallel import sp


def _read_rgb(path: str) -> np.ndarray:
    img = np.asarray(frame_utils.read_gen(path), np.uint8)
    img = np.tile(img[..., None], (1, 1, 3)) if img.ndim == 2 \
        else img[..., :3]
    return img.astype(np.float32)


def _clip_radii(flow: np.ndarray, flow_gt: np.ndarray, n_valid: int):
    """The drawn flow with radii beyond the ground truth's largest scaled
    down to it, unless more than a tenth of the valid pixels exceed it
    (reference evaluate.py:1357-1377)."""
    gt_max = np.sqrt((flow_gt ** 2).sum(-1)).max()
    flow_rad = np.sqrt((flow ** 2).sum(-1))
    exceed = flow_rad > gt_max
    ratio = exceed.sum() / max(n_valid, 1)
    if not 0 < ratio <= 0.1:
        return flow
    scales = np.ones_like(flow_rad)
    scales[exceed] = gt_max / flow_rad[exceed]
    return flow * scales[..., None]


def count_flops(cfg: ModelConfig, weights, H: int, W: int, iters: int,
                device=None) -> dict:
    """Print the analytic breakdown at H x W and the counted FLOPs of one
    forward at H x W padded to a multiple of 8 (``eval/flops.py``);
    returns them."""
    from craft_tpu_torch.eval.flops import count_model_flops, print_breakdown

    out = {"analytic_gflops": print_breakdown(cfg, H, W, iters)}
    padded = (-(-H // 8) * 8, -(-W // 8) * 8)
    torch_flops, kernel_flops = count_model_flops(cfg, weights, padded,
                                                  iters, device)
    print(f"Counted forward FLOPs: PyTorch ops (FlopCounterMode) "
          f"{torch_flops / 1e9:.1f} G; hand kernels (their wrappers) "
          f"{kernel_flops / 1e9:.1f} G")
    out.update(torch_flops=torch_flops, kernel_flops=kernel_flops)
    return out


def gen_flow(cfg: ModelConfig, weights, image1_path: str, image2_path: str,
             flow_path=None, output_path="output", iters: int = 12,
             model_name="craft", scale: float = 1.0, xy_shift=None,
             calc_flop: bool = False, device=None, seq_parallel=False):
    """The flow [H, W, 2] of one pair (scaled frames when scale < 1; with
    xy_shift the offset added and the shifted-out pixels zero; with a
    ground truth its radii clipped as drawn), its flow_viz PNG written to
    `output_path`/<image1 name>-<model_name>-<iters>.png.  With calc_flop:
    the FLOPs (``count_flops``) and no flow."""
    img1, img2 = _read_rgb(image1_path), _read_rgb(image2_path)
    flow_gt = None
    if flow_path:
        flow_gt = np.asarray(frame_utils.read_gen(flow_path), np.float32)
    if scale < 1:
        img1, img2 = (resize_linear(x, scale, scale) for x in (img1, img2))
        if flow_gt is not None:
            flow_gt = resize_linear(flow_gt, scale, scale) * scale
    val_mask = np.ones(img1.shape[:2], bool)
    offset = np.zeros(2, np.float32)
    if xy_shift is not None and tuple(xy_shift) != (0, 0):
        gt = flow_gt if flow_gt is not None else \
            np.zeros(img1.shape[:2] + (2,), np.float32)
        img1, flow_gt, val_mask = shift_pixels(img1, gt, None, *xy_shift)
        val_mask = val_mask.astype(bool)
        offset = np.array(xy_shift, np.float32)
    if calc_flop:
        return count_flops(cfg, weights, img1.shape[0], img1.shape[1],
                           iters, device)

    padder = InputPadder((1,) + img1.shape, mode="sintel")
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    _, flows = evaluator(*_pad(padder, img1[None], img2[None]))
    flow = padder.unpad(flows[-1])[0] + offset
    flow[~val_mask] = 0
    if not sp.is_main_rank():
        return flow
    if flow_gt is not None:
        print(f"EPE: {_epe(flow, flow_gt)[val_mask].mean():.4f}")
        flow = _clip_radii(flow, flow_gt, int(val_mask.sum()))
    os.makedirs(output_path, exist_ok=True)
    name = osp.splitext(osp.basename(image1_path))[0]
    out = osp.join(output_path, f"{name}-{model_name}-{iters}.png")
    imgio.write_png(out, flow_viz.flow_to_image(flow))
    print(f"Generated flow {out}.")
    return flow
