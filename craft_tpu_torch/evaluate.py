"""Evaluation and single-pair CLI (port of ``craft_tpu.evaluate``;
reference evaluate.py:1418-1653).

Loads a reference ``.pth`` checkpoint straight into the port's model (its
modules use the reference key names), then validates on a dataset, writes
a leaderboard submission, sweeps the shift protocol, converts the
checkpoint or runs one image pair.  A checkpoint directory of the JAX
package is refused: tools/jax_checkpoint_to_pth.py converts it first.

  python -m craft_tpu_torch.evaluate --model checkpoints/craft-sintel.pth \\
      --craft --setrans --dataset sintel [--batch_size 2] [--test_mode 2]
  python -m craft_tpu_torch.evaluate --model raft-sintel.pth --raft ...
      (also --nogma [--f2 none], GMA attention without --setrans
      [--position_only | --position_and_content] [--num_heads 2],
      --f2 none, --upsample_mode packed)
  python -m craft_tpu_torch.evaluate --model ... --dataset \\
      {chairs,things,sintel,sintel_occ,kitti,kittitrain,hd1k,viper,slowflow}
  python -m craft_tpu_torch.evaluate --model ... --submission sintel \\
      --warm_start [--vis]                # also kitti, viper
  python -m craft_tpu_torch.evaluate --model ... --dataset sintel \\
      --xshifts 100,200,300 --yshifts 50,100,150     # shift robustness
  python -m craft_tpu_torch.evaluate --model ... --img1 a.png --img2 b.png \\
      [--flow gt.flo] [--scale 0.5] [--flop]
  python -m craft_tpu_torch.evaluate --model craft-chairs.pth --convert out
  torchrun --nproc_per_node N -m craft_tpu_torch.evaluate --seq_parallel \\
      --model ... --dataset kitti

Mixed precision is on unless --fullprec, which also turns TF32 off for
matrix products and convolutions.  It runs on the card unless --device
names another device (--device cpu).  --seq_parallel splits the grid rows
of the attention and correlation tensors across the ranks (under torchrun;
one rank without it): NCCL when every rank has a card of its own, gloo when
ranks share one; every rank computes the metrics and rank 0 prints them
(every family and flag the evaluator takes without it).
"""

from __future__ import annotations

import argparse
import os

import torch

from craft_tpu_torch import resolve_device
from craft_tpu_torch.cli import (add_model_args, model_config_from_args,
                                 refuse_jax_checkpoint)
from craft_tpu_torch.eval import submission
from craft_tpu_torch.eval.demo import gen_flow
from craft_tpu_torch.eval.evaluate import VALIDATORS
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.training.checkpoint import save_weights
from craft_tpu_torch.utils.weights import load_reference_checkpoint

_DATASETS = list(VALIDATORS)
# --test_mode 2 applies to the dense sets.
_TEST_MODE_SETS = ("sintel", "things", "slowflow")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="reference .pth checkpoint (a JAX package "
                        "checkpoint directory converts with "
                        "tools/jax_checkpoint_to_pth.py)")
    p.add_argument("--model_name", default="craft")
    add_model_args(p)
    p.add_argument("--dataset", default=None, choices=[None, *_DATASETS])
    p.add_argument("--submission", default=None,
                   choices=[None, "sintel", "kitti", "viper"])
    p.add_argument("--warm_start", action="store_true")
    p.add_argument("--output_path", default=None,
                   help="where the single pair's flow_viz PNG (default "
                        "output) or the submission (default "
                        "<name>_submission) is written")
    p.add_argument("--vis", dest="do_vis", action="store_true")
    p.add_argument("--img1", default=None)
    p.add_argument("--img2", default=None)
    p.add_argument("--flow", dest="flow_path", default=None,
                   help="ground truth of the single pair (.flo)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--flop", dest="calc_flop", action="store_true")
    p.add_argument("--xshifts", type=str, default=None)
    p.add_argument("--yshifts", type=str, default=None)
    p.add_argument("--max_val_count", type=int, default=-1)
    p.add_argument("--test_mode", type=int, default=1, choices=[1, 2],
                   help="2 = per-iteration EPE curves on dense sets")
    p.add_argument("--batch_size", type=int, default=1,
                   help="batch consecutive same-shape pairs (sintel)")
    p.add_argument("--data_root", type=str, default="datasets")
    p.add_argument("--convert", default=None, metavar="OUT_DIR",
                   help="write the loaded weights as a reference-format "
                        ".pth, OUT_DIR/<model_name>.pth (the JAX CLI loads "
                        "it as it is)")
    p.add_argument("--fullprec", dest="fullprec", action="store_true")
    p.add_argument("--seq_parallel", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)
    if not args.fullprec:
        args.mixed_precision = True
    return args


def _shifts(args):
    """The (dx, dy) pairs of --xshifts/--yshifts (zip of the two lists, a
    missing one read as 0), or [None] without a sweep."""
    if not (args.xshifts or args.yshifts):
        return [None]
    xs = [int(v) for v in (args.xshifts or "0").split(",")]
    ys = [int(v) for v in (args.yshifts or "0").split(",")]
    return list(zip(xs, ys))


def _submit(args, cfg, weights, device):
    out = args.output_path or f"{args.submission}_submission"
    common = dict(model_name=args.model_name, data_root=args.data_root,
                  output_path=out, do_vis=args.do_vis, device=device,
                  seq_parallel=args.seq_parallel)
    if args.submission == "sintel":
        submission.create_sintel_submission(
            cfg, weights, warm_start=args.warm_start, iters=32, **common)
    elif args.submission == "kitti":
        submission.create_kitti_submission(cfg, weights, iters=24, **common)
    else:
        submission.create_viper_submission(cfg, weights, iters=24, **common)
    return out


def main(argv=None):
    """Returns the validator's metrics (a list of them, one per shift, for
    a shift sweep), the submission's directory, the converted file, or the
    single pair's flow (its FLOPs with --flop)."""
    args = parse_args(argv)
    refuse_jax_checkpoint(args.model, "--model")
    cfg = model_config_from_args(args)
    device = resolve_device(args.device)
    if args.fullprec:
        # Exact fp32 products, the counterpart of the JAX CLI's "highest"
        # matmul precision (TF32 keeps about three decimal digits).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = FlowModel(cfg)
    load_reference_checkpoint(args.model, model, strict=False)
    weights = model.state_dict()

    if args.convert:
        os.makedirs(args.convert, exist_ok=True)
        out = os.path.join(args.convert, f"{args.model_name}.pth")
        save_weights(out, weights)
        print(f"Converted {args.model} -> {out}")
        return out
    if args.img1 and args.img2:
        return gen_flow(cfg, weights, args.img1, args.img2, args.flow_path,
                        output_path=args.output_path or "output",
                        iters=args.iters, model_name=args.model_name,
                        scale=args.scale, calc_flop=args.calc_flop,
                        device=device,
                        seq_parallel=args.seq_parallel)
    if args.submission:
        return _submit(args, cfg, weights, device)
    if args.dataset:
        extra = {}
        if args.dataset == "sintel" and args.batch_size > 1:
            extra["batch_size"] = args.batch_size
        if args.test_mode != 1:
            if args.dataset in _TEST_MODE_SETS:
                extra["test_mode"] = args.test_mode
            else:
                print(f"--test_mode {args.test_mode} only applies to dense "
                      "sets (sintel/things/slowflow); ignoring")
        results = []
        for shift in _shifts(args):
            if shift is not None:
                print(f"=== shift ({shift[0]}, {shift[1]}) ===")
                extra["xy_shift"] = shift
            results.append(VALIDATORS[args.dataset](
                cfg, weights, iters=args.iters, data_root=args.data_root,
                max_val_count=args.max_val_count, device=device,
                seq_parallel=args.seq_parallel, **extra))
        return results[0] if len(results) == 1 else results
    print("Nothing to do: pass --dataset, --submission, --convert or "
          "--img1/--img2")
    return None


if __name__ == "__main__":
    main()
