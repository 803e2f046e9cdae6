"""Flow for one image pair (port of ``craft_tpu.eval.demo.gen_flow``;
reference evaluate.py:1251-1384): read both frames, pad to a multiple of 8,
run the model, unpad and write the flow as a Middlebury ``.flo`` (with an
optional ground-truth flow, print the EPE).  Under sequence parallelism
every rank computes the flow and rank 0 prints and writes it.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.data import frame_utils
from craft_tpu_torch.eval.evaluate import Evaluator, _epe, _pad
from craft_tpu_torch.ops.geometry import InputPadder
from craft_tpu_torch.parallel import sp


def _read_rgb(path: str) -> np.ndarray:
    img = np.asarray(frame_utils.read_gen(path), np.uint8)
    img = np.tile(img[..., None], (1, 1, 3)) if img.ndim == 2 \
        else img[..., :3]
    return img.astype(np.float32)


def gen_flow(cfg: ModelConfig, weights, image1_path: str, image2_path: str,
             flow_path=None, output_path="output", iters: int = 12,
             model_name="craft", device=None,
             seq_parallel=False) -> np.ndarray:
    """The flow [H, W, 2] of one pair, also written to
    `output_path`/<image1 name>-<model_name>-<iters>.flo."""
    img1, img2 = _read_rgb(image1_path), _read_rgb(image2_path)
    padder = InputPadder((1,) + img1.shape, mode="sintel")
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    _, flows = evaluator(*_pad(padder, img1[None], img2[None]))
    flow = padder.unpad(flows[-1])[0]
    if not sp.is_main_rank():
        return flow
    if flow_path:
        gt = np.asarray(frame_utils.read_gen(flow_path), np.float32)
        print(f"EPE: {float(_epe(flow, gt).mean()):.4f}")
    os.makedirs(output_path, exist_ok=True)
    name = osp.splitext(osp.basename(image1_path))[0]
    out = osp.join(output_path, f"{name}-{model_name}-{iters}.flo")
    frame_utils.write_flo(out, flow)
    print(f"Generated flow {out}.")
    return flow
