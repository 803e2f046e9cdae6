"""Validation on every dataset of the JAX package (port of
``craft_tpu.eval.evaluate``; reference evaluate.py:106-1239).

The reference protocols: mod-8 padding (Sintel centred, KITTI bottom), one
forward per pair or per batch of consecutive same-shape pairs, test_mode 1
(the final flow) or 2 (every iteration's flow, for per-iteration EPE
curves), magnitude-bucketed EPE over [0, 1, 10, 20, 30, inf), KITTI F1-all
(epe > 3 and epe / |flow| > 0.05 over valid pixels), Sintel's occluded and
non-occluded split, VIPER at half resolution, the shift-robustness protocol
(``xy_shift``: image1 and the ground truth translated, the vacated border
left out, magnitudes taken with the offset added back) and max_val_count
truncation.  The model runs on the card (or the device asked for) under
``torch.inference_mode``; metrics are computed in numpy on the host, as in
the JAX package, so both report the same statistics.

With ``seq_parallel`` the evaluator runs as one rank of a sequence-parallel
group (``craft_tpu_torch.parallel.sp``: torchrun's ranks, or one rank
without torchrun): each rank holds its share of the grid rows of the
O(U^2) tensors, every rank computes the same metrics, and rank 0 prints.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from craft_tpu_torch import resolve_device
from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.data import datasets as ds
from craft_tpu_torch.data.augmentor import resize_linear
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.ops.geometry import (InputPadder, shift_pixels,
                                          unpack_upsampled)
from craft_tpu_torch.parallel import sp

MAG_ENDPOINTS = [1, 10, 20, 30, np.inf]

def _say(*args) -> None:
    """print, on the rank that prints (all output outside sequence
    parallelism)."""
    if sp.is_main_rank():
        print(*args)


class Evaluator:
    """The model in eval mode on `device` (default CUDA; raises without
    one), with the reference state_dict `weights` loaded strictly.  With
    `seq_parallel` the grid's rows are split across the ranks of this
    process's SeqParallel group, made on first use, and the model runs on
    the rank's device."""

    def __init__(self, cfg: ModelConfig, weights: Mapping, iters: int = 12,
                 test_mode: int = 1, device=None, seq_parallel=False):
        self.seq_parallel = sp.init(device) if seq_parallel else None
        self.device = (self.seq_parallel.device if seq_parallel
                       else resolve_device(device))
        self.model = create_model(cfg, device=self.device)
        self.model.load_state_dict(weights, strict=True)
        self.cfg, self.iters, self.test_mode = cfg, iters, test_mode

    def __call__(self, image1, image2, flow_init=None
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """image1/2: [B, H, W, 3] in [0, 255], already padded (numpy or
        torch); flow_init: None or the starting low-res flow [B, H/8, W/8,
        2].  Returns (flow_lowres, per-iteration upsampled flows) as
        numpy: one entry for test_mode 1, `iters` for test_mode 2."""
        a, b = (torch.as_tensor(x, dtype=torch.float32).to(self.device)
                for x in (image1, image2))
        if flow_init is not None:
            flow_init = torch.as_tensor(flow_init, dtype=torch.float32).to(
                self.device)
        mode = self.cfg.upsample_mode if self.test_mode == 1 else "all"
        with torch.inference_mode():
            lowres, flows = self.model(a, b, iters=self.iters,
                                       flow_init=flow_init,
                                       upsample_mode=mode,
                                       seq_parallel=self.seq_parallel)
            if self.test_mode == 1:
                flows = flows[-1:]
                if mode == "packed":
                    flows = unpack_upsampled(flows[0])[None]
            flows = flows.cpu().numpy()
        return lowres.cpu().numpy(), [flows[i] for i in range(len(flows))]


def _mag_bucket_stats(epe_all: np.ndarray, mag_all: np.ndarray) -> Dict:
    out = {}
    prev = 0
    for end in MAG_ENDPOINTS:
        sel = (mag_all >= prev) & (mag_all < end)
        out[f"mag_{prev}_{end}"] = float(epe_all[sel].mean()) if sel.any() \
            else 0.0
        prev = end
    return out


def _prefetch(gen, depth: int = 3):
    """Run a generator on a background thread with a bounded buffer, so
    that decoding the next pair overlaps the card's work on this one (only
    where the host has a spare core).  An exception in the generator is
    raised on the consumer's side."""
    if (os.cpu_count() or 1) < 2:
        yield from gen
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end, err = object(), object()

    def run():
        try:
            for item in gen:
                q.put(item)
            q.put(end)
        except Exception as e:  # surfaced on the consumer side
            q.put((err, e))

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
            raise item[1]
        yield item


def _iter_pairs(dataset, max_val_count=-1, prefetch: bool = True):
    n = len(dataset)
    if max_val_count > 0:
        n = min(n, max_val_count)
    gen = (dataset[i] for i in range(n))
    return _prefetch(gen) if prefetch else gen


def _iter_batches(dataset, batch_size, max_val_count=-1):
    """Consecutive same-shape items in batches of up to batch_size (the
    reference's DataLoader batch eval, evaluate.py:469-472)."""
    def gen():
        buf = []
        for item in _iter_pairs(dataset, max_val_count, prefetch=False):
            if buf and item["image1"].shape != buf[0]["image1"].shape:
                yield buf
                buf = []
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

    return _prefetch(gen(), depth=2)


def _pad(padder: InputPadder, *batches: np.ndarray):
    return [padder.pad(torch.from_numpy(np.ascontiguousarray(b)))[0]
            for b in batches]


def _epe(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.sqrt(((flow - gt) ** 2).sum(-1))


def _shifted(item, xy_shift):
    """(image1, ground truth, mask of pixels kept) of an item under the
    shift protocol; the item's own with an all-true mask without a shift."""
    img1, gt = item["image1"], item["flow"]
    if xy_shift is None or tuple(xy_shift) == (0, 0):
        return img1, gt, np.ones(gt.shape[:2], bool)
    img1, gt, mask = shift_pixels(img1, gt, None, *xy_shift)
    return img1, gt, mask.astype(bool)


def _offset(xy_shift) -> np.ndarray:
    """The shift added back to the ground truth for the magnitudes."""
    return np.array(xy_shift if xy_shift else (0, 0), np.float32)


def validate_chairs(cfg, weights, iters=12, data_root="datasets",
                    xy_shift=None, max_val_count=-1, device=None,
                    seq_parallel=False) -> Dict[str, float]:
    """FlyingChairs validation split EPE (reference evaluate.py:247-280)."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    dataset = ds.FlyingChairs(
        split="validation", root=f"{data_root}/FlyingChairs_release/data",
        split_file=f"{data_root}/FlyingChairs_release/"
                   "FlyingChairs_train_val.txt")
    epe_list = []
    for item in _iter_pairs(dataset, max_val_count):
        img1, gt, mask = _shifted(item, xy_shift)
        # Chairs is 384x512: already a multiple of 8.
        _, flows = evaluator(img1[None], item["image2"][None])
        epe_list.append(_epe(flows[-1][0], gt)[mask].reshape(-1))
    epe = float(np.concatenate(epe_list).mean())
    _say(f"Validation Chairs EPE: {epe:.6f}")
    return {"chairs_epe": epe}


def _validate_dense(cfg, weights, dataset, name, iters=12, xy_shift=None,
                    max_val_count=-1, pad_mode="sintel", batch_size=1,
                    test_mode=1, device=None,
                    seq_parallel=False) -> Dict[str, float]:
    """The dense-GT validation loop (reference evaluate.py:444-602):
    batch_size > 1 batches consecutive same-shape pairs into one forward;
    test_mode 2 adds per-iteration EPE (reference :317-323)."""
    evaluator = Evaluator(cfg, weights, iters=iters, test_mode=test_mode,
                          device=device, seq_parallel=seq_parallel)
    iter_epes: Dict[int, list] = {}
    epe_list, mag_list = [], []
    off = _offset(xy_shift)
    for items in _iter_batches(dataset, batch_size, max_val_count):
        img1s, gts, masks = zip(*(_shifted(item, xy_shift)
                                  for item in items))
        b1 = np.stack(img1s)
        b2 = np.stack([item["image2"] for item in items])
        padder = InputPadder(b1.shape, mode=pad_mode)
        _, flows = evaluator(*_pad(padder, b1, b2))
        if test_mode == 2:
            for it, fl in enumerate(flows):
                for flow, gt, mask in zip(padder.unpad(fl), gts, masks):
                    iter_epes.setdefault(it, []).append(
                        _epe(flow, gt)[mask].reshape(-1))
        for flow, gt, mask in zip(padder.unpad(flows[-1]), gts, masks):
            epe_list.append(_epe(flow, gt)[mask].reshape(-1))
            mag_list.append(
                np.sqrt(((gt + off) ** 2).sum(-1))[mask].reshape(-1))
    epe_all = np.concatenate(epe_list)
    mag_all = np.concatenate(mag_list)
    res = {
        f"{name}_epe": float(epe_all.mean()),
        f"{name}_1px": float((epe_all < 1).mean()),
        f"{name}_3px": float((epe_all < 3).mean()),
        f"{name}_5px": float((epe_all < 5).mean()),
    }
    res.update({f"{name}_{k}": v
                for k, v in _mag_bucket_stats(epe_all, mag_all).items()})
    _say(f"Validation ({name}) EPE: {res[f'{name}_epe']:.6f}, "
          f"1px: {res[f'{name}_1px']:.4f}, 3px: {res[f'{name}_3px']:.4f}, "
          f"5px: {res[f'{name}_5px']:.4f}")
    if test_mode == 2:
        for it in sorted(iter_epes):
            e = float(np.concatenate(iter_epes[it]).mean())
            res[f"{name}_iter{it}_epe"] = e
            _say(f"  Iter {it}, EPE: {e:.6f}")
    return res


def validate_sintel(cfg, weights, iters=12, data_root="datasets",
                    dstype="both", xy_shift=None, max_val_count=-1,
                    batch_size=1, test_mode=1, device=None,
                    seq_parallel=False) -> Dict[str, float]:
    """Sintel training split, clean and final passes (reference
    evaluate.py:444-602)."""
    dstypes = ["clean", "final"] if dstype == "both" else [dstype]
    results = {}
    for dt in dstypes:
        dataset = ds.MpiSintel(split="training", dstype=dt,
                               root=f"{data_root}/Sintel")
        results.update(_validate_dense(
            cfg, weights, dataset, f"sintel_{dt}", iters, xy_shift,
            max_val_count, batch_size=batch_size, test_mode=test_mode,
            device=device, seq_parallel=seq_parallel))
    return results


def validate_sintel_occ(cfg, weights, iters=12, data_root="datasets",
                        max_val_count=-1, device=None,
                        seq_parallel=False) -> Dict[str, float]:
    """Sintel's EPE over all pixels and over the occluded and non-occluded
    ones, per pass present (clean, final, albedo; reference
    evaluate.py:604-700)."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    results = {}
    for dt in ["clean", "final", "albedo"]:
        try:
            dataset = ds.MpiSintel(split="training", dstype=dt,
                                   root=f"{data_root}/Sintel",
                                   occlusion=True)
        except FileNotFoundError:
            continue
        epe_list, occ_list, noc_list = [], [], []
        for item in _iter_pairs(dataset, max_val_count):
            padder = InputPadder((1,) + item["image1"].shape, mode="sintel")
            _, flows = evaluator(*_pad(padder, item["image1"][None],
                                       item["image2"][None]))
            epe = _epe(padder.unpad(flows[-1])[0], item["flow"])
            occ = item["occ"]
            epe_list.append(epe.reshape(-1))
            occ_list.append(epe[occ].reshape(-1))
            noc_list.append(epe[~occ].reshape(-1))
        if not epe_list:
            continue
        key = f"sintel_occ_{dt}"
        results[f"{key}_epe"] = float(np.concatenate(epe_list).mean())
        results[f"{key}_occ_epe"] = float(np.concatenate(occ_list).mean())
        results[f"{key}_noc_epe"] = float(np.concatenate(noc_list).mean())
        _say(f"Sintel occ split ({dt}): epe {results[f'{key}_epe']:.4f}, "
             f"occ {results[f'{key}_occ_epe']:.4f}, noc "
             f"{results[f'{key}_noc_epe']:.4f}")
    return results


def validate_things(cfg, weights, iters=12, data_root="datasets",
                    dstype="both", xy_shift=None, max_val_count=-1,
                    test_mode=1, device=None,
                    seq_parallel=False) -> Dict[str, float]:
    """FlyingThings3D's validation pairs (things_val_test_set.txt), clean
    and final passes."""
    type_map = {"clean": "frames_cleanpass", "final": "frames_finalpass"}
    dstypes = ["clean", "final"] if dstype == "both" else [dstype]
    results = {}
    for dt in dstypes:
        dataset = ds.FlyingThings3D(
            split="validation", dstype=type_map[dt],
            root=f"{data_root}/FlyingThings3D",
            val_filter_file=f"{data_root}/things_val_test_set.txt")
        results.update(_validate_dense(
            cfg, weights, dataset, f"things_{dt}", iters, xy_shift,
            max_val_count, test_mode=test_mode, device=device,
            seq_parallel=seq_parallel))
    return results


def validate_slowflow(cfg, weights, iters=12, data_root="datasets",
                      blur_mag=100, blur_num_frames=0, xy_shift=None,
                      max_val_count=-1, test_mode=1, device=None,
                      seq_parallel=False) -> Dict[str, float]:
    """SlowFlow at one blur magnitude and blur frame count."""
    dataset = ds.SlowFlow(root=f"{data_root}/slowflow/", blur_mag=blur_mag,
                          blur_num_frames=blur_num_frames)
    return _validate_dense(cfg, weights, dataset, "slowflow", iters,
                           xy_shift, max_val_count, test_mode=test_mode,
                           device=device, seq_parallel=seq_parallel)


def _sparse_metrics(name, epe_list, out_list) -> Dict[str, float]:
    epe_all = np.concatenate(epe_list)
    out_all = np.concatenate(out_list)
    return {f"{name}_epe": float(epe_all.mean()),
            f"{name}_f1": float(100 * out_all.mean())}


def _outliers(epe, mag, valid):
    """(EPE, F1 outliers) over the valid pixels: (epe > 3) & (epe / mag >
    0.05)."""
    val = valid.reshape(-1) >= 0.5
    out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
    return epe[val], out[val].astype(np.float32)


def _validate_sparse(cfg, weights, dataset, name, iters=12, xy_shift=None,
                     max_val_count=-1, device=None,
                     seq_parallel=False) -> Dict[str, float]:
    """Sparse-GT validation with F1-all (reference evaluate.py:770-900:
    out = (epe > 3) & (epe / mag > 0.05), over valid pixels)."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    epe_list, out_list = [], []
    off = _offset(xy_shift)
    for item in _iter_pairs(dataset, max_val_count):
        img1, gt, mask = _shifted(item, xy_shift)
        valid = item["valid"] * mask
        padder = InputPadder((1,) + img1.shape, mode="kitti")
        _, flows = evaluator(*_pad(padder, img1[None], item["image2"][None]))
        flow = padder.unpad(flows[-1])[0]
        epe = _epe(flow, gt).reshape(-1)
        mag = np.sqrt(((gt + off) ** 2).sum(-1)).reshape(-1)
        e, o = _outliers(epe, mag, valid)
        epe_list.append(e)
        out_list.append(o)
    res = _sparse_metrics(name, epe_list, out_list)
    _say(f"Validation {name}: EPE {res[f'{name}_epe']:.6f}, "
         f"F1-all {res[f'{name}_f1']:.4f}%")
    return res


def validate_kitti(cfg, weights, iters=12, data_root="datasets",
                   use_kitti_train=False, xy_shift=None, max_val_count=-1,
                   device=None, seq_parallel=False) -> Dict[str, float]:
    """KITTI 2015 training split (or, with use_kitti_train, the 30 % that
    the 70/30 re-split holds out): EPE and F1-all."""
    if use_kitti_train:
        dataset = ds.KITTITrain(split="validation", root=f"{data_root}/KITTI")
        name = "kittitrain"
    else:
        dataset = ds.KITTI(split="training", root=f"{data_root}/KITTI")
        name = "kitti"
    return _validate_sparse(cfg, weights, dataset, name, iters, xy_shift,
                            max_val_count, device=device,
                            seq_parallel=seq_parallel)


def validate_hd1k(cfg, weights, iters=12, data_root="datasets",
                  xy_shift=None, max_val_count=-1, device=None,
                  seq_parallel=False) -> Dict[str, float]:
    """HD1K (1080x2560 frames, sparse ground truth): EPE and F1-all."""
    dataset = ds.HD1K(root=f"{data_root}/HD1k")
    return _validate_sparse(cfg, weights, dataset, "hd1k", iters, xy_shift,
                            max_val_count, device=device,
                            seq_parallel=seq_parallel)


def validate_viper(cfg, weights, iters=12, data_root="datasets", scale=0.5,
                   xy_shift=None, max_val_count=-1, device=None,
                   seq_parallel=False) -> Dict[str, float]:
    """VIPER's validation split at `scale` of its 1920x1080 frames, the
    flow resized back to full size and divided by the scale (reference
    evaluate.py:199-245, 1050-1160).  xy_shift is accepted and not used,
    as in the JAX package."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    dataset = ds.VIPER(split="validation", root=f"{data_root}/viper/")
    epe_list, out_list = [], []
    for item in _iter_pairs(dataset, max_val_count):
        img1, img2 = item["image1"], item["image2"]
        gt, valid = item["flow"], item["valid"]
        if scale != 1.0:
            img1, img2 = (resize_linear(x, scale, scale)
                          for x in (img1, img2))
        padder = InputPadder((1,) + img1.shape, mode="kitti")
        _, flows = evaluator(*_pad(padder, img1[None], img2[None]))
        flow = padder.unpad(flows[-1])[0]
        if scale != 1.0:  # cv2.resize(flow, (W, H), INTER_LINEAR) / scale
            flow = resize_linear(flow, dsize=(gt.shape[1], gt.shape[0])) \
                / scale
        epe = _epe(flow, gt).reshape(-1)
        mag = np.sqrt((gt ** 2).sum(-1)).reshape(-1)
        e, o = _outliers(epe, mag, valid)
        epe_list.append(e)
        out_list.append(o)
    res = _sparse_metrics("viper", epe_list, out_list)
    _say(f"Validation VIPER: EPE {res['viper_epe']:.6f}, "
         f"F1-all {res['viper_f1']:.4f}%")
    return res


def validate_kittitrain(*args, **kwargs) -> Dict[str, float]:
    return validate_kitti(*args, use_kitti_train=True, **kwargs)


VALIDATORS = {
    "chairs": validate_chairs,
    "things": validate_things,
    "sintel": validate_sintel,
    "sintel_occ": validate_sintel_occ,
    "kitti": validate_kitti,
    "kittitrain": validate_kittitrain,
    "hd1k": validate_hd1k,
    "viper": validate_viper,
    "slowflow": validate_slowflow,
}
