"""Leaderboard submission writers (port of ``craft_tpu.eval.submission``;
reference evaluate.py:106-245).

Sintel: 32 iterations, and with warm_start the previous pair's low-res flow
splatted forward (``forward_interpolate``) as the next pair's flow_init
within a scene (the Evaluator takes it, so the JAX package's
``_InitEvaluator`` has no counterpart here); one .flo per frame.  KITTI: 24 iterations, 16-bit KITTI
PNGs.  VIPER: 24 iterations at half resolution, the flow resized back and
divided by the scale, one .flo per frame.  With do_vis each writer also
writes the flow_viz PNG of every flow.  Under sequence parallelism every
rank computes the flows and rank 0 writes them.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.data import datasets as ds
from craft_tpu_torch.data import flow_viz, frame_utils, imgio
from craft_tpu_torch.data.augmentor import resize_linear
from craft_tpu_torch.eval.evaluate import Evaluator, _pad
from craft_tpu_torch.ops.geometry import InputPadder, forward_interpolate
from craft_tpu_torch.parallel import sp


def _vis(path: str, flow: np.ndarray) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    imgio.write_png(path, flow_viz.flow_to_image(flow))


def create_sintel_submission(cfg: ModelConfig, weights, model_name="craft",
                             data_root="datasets", warm_start=False,
                             output_path="sintel_submission", iters=32,
                             do_vis=False, split="test", device=None,
                             seq_parallel=False):
    """<output_path>/<pass>/<scene>/frameNNNN.flo for the Sintel `split`;
    with do_vis also vis_sintel/<split>/<model_name>/<pass>/<scene>/."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    for dstype in ["clean", "final"]:
        dataset = ds.MpiSintel(split=split, dstype=dstype,
                               root=f"{data_root}/Sintel")
        dataset.is_test = True
        flow_prev, scene_prev = None, None
        for i in range(len(dataset)):
            item = dataset[i]
            scene, frame_id = item["extra_info"]
            if scene != scene_prev:
                flow_prev = None
            img1, img2 = item["image1"], item["image2"]
            padder = InputPadder((1,) + img1.shape, mode="sintel")
            lowres, flows = evaluator(
                *_pad(padder, img1[None], img2[None]), flow_prev)
            flow = padder.unpad(flows[-1])[0]
            if warm_start:
                flow_prev = forward_interpolate(lowres[0])[None]
            scene_prev = scene
            if not sp.is_main_rank():
                continue
            out_dir = osp.join(output_path, dstype, scene)
            os.makedirs(out_dir, exist_ok=True)
            frame_utils.write_flo(
                osp.join(out_dir, "frame%04d.flo" % (frame_id + 1)), flow)
            if do_vis:
                _vis(osp.join(f"vis_sintel/{split}/{model_name}/{dstype}",
                              scene, f"frame_{frame_id + 1:04d}.png"), flow)
    print("Created sintel submission.")


def create_kitti_submission(cfg: ModelConfig, weights, model_name="craft",
                            data_root="datasets",
                            output_path="kitti_submission", iters=24,
                            do_vis=False, device=None, seq_parallel=False):
    """<output_path>/<frame>_10.png (KITTI's 16-bit flow PNGs) for KITTI's
    testing split; with do_vis also vis_kitti/<model_name>/."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    dataset = ds.KITTI(split="testing", root=f"{data_root}/KITTI")
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(dataset)):
        item = dataset[i]
        (frame_id,) = item["extra_info"]
        img1, img2 = item["image1"], item["image2"]
        padder = InputPadder((1,) + img1.shape, mode="kitti")
        _, flows = evaluator(*_pad(padder, img1[None], img2[None]))
        flow = padder.unpad(flows[-1])[0]
        if not sp.is_main_rank():
            continue
        frame_utils.write_flow_kitti(osp.join(output_path, frame_id), flow)
        if do_vis:
            _vis(f"vis_kitti/{model_name}/{frame_id}", flow)
    print("Created KITTI submission.")


def create_viper_submission(cfg: ModelConfig, weights, model_name="craft",
                            data_root="datasets",
                            output_path="viper_submission", iters=24,
                            do_vis=False, device=None, seq_parallel=False):
    """<output_path>/<frame>.flo for VIPER's test frames, estimated at half
    resolution; with do_vis also vis_viper/<model_name>/."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    dataset = ds.VIPER(split="test", root=f"{data_root}/viper/")
    os.makedirs(output_path, exist_ok=True)
    scale = 0.5
    for i in range(len(dataset)):
        item = dataset[i]
        (frame_id,) = item["extra_info"]
        img1, img2 = (resize_linear(item[k], scale, scale)
                      for k in ("image1", "image2"))
        padder = InputPadder((1,) + img1.shape, mode="kitti")
        _, flows = evaluator(*_pad(padder, img1[None], img2[None]))
        flow = padder.unpad(flows[-1])[0]
        flow = resize_linear(flow, 1 / scale, 1 / scale) / scale
        if not sp.is_main_rank():
            continue
        frame_utils.write_flo(osp.join(output_path, frame_id + ".flo"), flow)
        if do_vis:
            _vis(f"vis_viper/{model_name}/{frame_id}.png", flow)
    print("Created VIPER submission.")
