"""Validation on Sintel, KITTI and FlyingChairs (port of
``craft_tpu.eval.evaluate``; reference evaluate.py:106-900).

The reference protocols: mod-8 padding (Sintel centred, KITTI bottom), one
forward per pair or per batch of consecutive same-shape pairs, test_mode 1
(the final flow) or 2 (every iteration's flow, for per-iteration EPE
curves), magnitude-bucketed EPE over [0, 1, 10, 20, 30, inf), KITTI F1-all
(epe > 3 and epe / |flow| > 0.05 over valid pixels) and max_val_count
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
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.ops.geometry import InputPadder
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

    def __call__(self, image1, image2) -> Tuple[np.ndarray, List[np.ndarray]]:
        """image1/2: [B, H, W, 3] in [0, 255], already padded (numpy or
        torch).  Returns (flow_lowres, per-iteration upsampled flows) as
        numpy: one entry for test_mode 1, `iters` for test_mode 2."""
        a, b = (torch.as_tensor(x, dtype=torch.float32).to(self.device)
                for x in (image1, image2))
        mode = self.cfg.upsample_mode if self.test_mode == 1 else "all"
        with torch.inference_mode():
            lowres, flows = self.model(a, b, iters=self.iters,
                                       upsample_mode=mode,
                                       seq_parallel=self.seq_parallel)
            if self.test_mode == 1:
                flows = flows[-1:]
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


def validate_chairs(cfg, weights, iters=12, data_root="datasets",
                    max_val_count=-1, device=None,
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
        # Chairs is 384x512: already a multiple of 8.
        _, flows = evaluator(item["image1"][None], item["image2"][None])
        epe_list.append(_epe(flows[-1][0], item["flow"]).reshape(-1))
    epe = float(np.concatenate(epe_list).mean())
    _say(f"Validation Chairs EPE: {epe:.6f}")
    return {"chairs_epe": epe}


def _validate_dense(cfg, weights, dataset, name, iters=12, max_val_count=-1,
                    pad_mode="sintel", batch_size=1, test_mode=1,
                    device=None, seq_parallel=False) -> Dict[str, float]:
    """The dense-GT validation loop (reference evaluate.py:444-602):
    batch_size > 1 batches consecutive same-shape pairs into one forward;
    test_mode 2 adds per-iteration EPE (reference :317-323)."""
    evaluator = Evaluator(cfg, weights, iters=iters, test_mode=test_mode,
                          device=device, seq_parallel=seq_parallel)
    iter_epes: Dict[int, list] = {}
    epe_list, mag_list = [], []
    for items in _iter_batches(dataset, batch_size, max_val_count):
        gts = [item["flow"] for item in items]
        b1 = np.stack([item["image1"] for item in items])
        b2 = np.stack([item["image2"] for item in items])
        padder = InputPadder(b1.shape, mode=pad_mode)
        _, flows = evaluator(*_pad(padder, b1, b2))
        if test_mode == 2:
            for it, fl in enumerate(flows):
                for flow, gt in zip(padder.unpad(fl), gts):
                    iter_epes.setdefault(it, []).append(
                        _epe(flow, gt).reshape(-1))
        for flow, gt in zip(padder.unpad(flows[-1]), gts):
            epe_list.append(_epe(flow, gt).reshape(-1))
            mag_list.append(np.sqrt((gt ** 2).sum(-1)).reshape(-1))
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
                    dstype="both", max_val_count=-1, batch_size=1,
                    test_mode=1, device=None,
                    seq_parallel=False) -> Dict[str, float]:
    """Sintel training split, clean and final passes (reference
    evaluate.py:444-602)."""
    dstypes = ["clean", "final"] if dstype == "both" else [dstype]
    results = {}
    for dt in dstypes:
        dataset = ds.MpiSintel(split="training", dstype=dt,
                               root=f"{data_root}/Sintel")
        results.update(_validate_dense(
            cfg, weights, dataset, f"sintel_{dt}", iters, max_val_count,
            batch_size=batch_size, test_mode=test_mode, device=device,
            seq_parallel=seq_parallel))
    return results


def _validate_sparse(cfg, weights, dataset, name, iters=12,
                     max_val_count=-1, device=None,
                     seq_parallel=False) -> Dict[str, float]:
    """Sparse-GT validation with F1-all (reference evaluate.py:770-900:
    out = (epe > 3) & (epe / mag > 0.05), over valid pixels)."""
    evaluator = Evaluator(cfg, weights, iters=iters, device=device,
                          seq_parallel=seq_parallel)
    epe_list, out_list = [], []
    for item in _iter_pairs(dataset, max_val_count):
        gt, valid = item["flow"], item["valid"]
        padder = InputPadder((1,) + item["image1"].shape, mode="kitti")
        _, flows = evaluator(*_pad(padder, item["image1"][None],
                                   item["image2"][None]))
        flow = padder.unpad(flows[-1])[0]
        epe = _epe(flow, gt).reshape(-1)
        mag = np.sqrt((gt ** 2).sum(-1)).reshape(-1)
        val = valid.reshape(-1) >= 0.5
        out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
        epe_list.append(epe[val])
        out_list.append(out[val].astype(np.float32))
    epe_all = np.concatenate(epe_list)
    out_all = np.concatenate(out_list)
    res = {f"{name}_epe": float(epe_all.mean()),
           f"{name}_f1": float(100 * out_all.mean())}
    _say(f"Validation {name}: EPE {res[f'{name}_epe']:.6f}, "
          f"F1-all {res[f'{name}_f1']:.4f}%")
    return res


def validate_kitti(cfg, weights, iters=12, data_root="datasets",
                   max_val_count=-1, device=None,
                   seq_parallel=False) -> Dict[str, float]:
    """KITTI 2015 training split: EPE and F1-all."""
    dataset = ds.KITTI(split="training", root=f"{data_root}/KITTI")
    return _validate_sparse(cfg, weights, dataset, "kitti", iters,
                            max_val_count, device=device,
                            seq_parallel=seq_parallel)


VALIDATORS = {
    "chairs": validate_chairs,
    "sintel": validate_sintel,
    "kitti": validate_kitti,
}
