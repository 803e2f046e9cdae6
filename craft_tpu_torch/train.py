"""Training CLI (port of ``craft_tpu.train``; reference train.py:177-254 and
train_ddp.py:185-280): the chairs -> things -> sintel -> kitti curriculum
on the card, one stage a run.

  python -m craft_tpu_torch.train --name craft-chairs --stage chairs \\
      --craft --setrans --f2 full --mixed_precision --lr 2.5e-4 \\
      --num_steps 120000 --image_size 368 496 --batch_size 8 \\
      --val_freq 20000 --validation chairs
  torchrun --nproc_per_node N -m craft_tpu_torch.train ...   (data parallel)

The flags are the JAX CLI's, plus --device (default the card; --device cpu
runs the kernels' plain versions).  Each step's batch goes to the device
as [B, H, W, C] tensors; the metrics stay there until the logger's status
line, one host copy every --print_freq steps.  Every --val_freq steps rank
0 writes <output>/<step + 1>_<name>.pth, validates on --validation and
plots; at the end it writes <output>/<name>.pth.  Under torchrun each rank
takes --batch_size samples of its shard of each epoch, and the step is the
JAX package's step over all the ranks' samples (``parallel/
data_parallel.py``).  --attn_diag runs the diagnostics step every
--print_freq-th step, and the status line prints attn_max,
attn_clamp_frac and attn_avg_abs.  What the port does not run yet exits
before training starts, naming its ROADMAP.md item.  --restore_ckpt takes
a .pth; a checkpoint directory of the JAX package is refused, naming
tools/jax_checkpoint_to_pth.py, which converts it.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from craft_tpu_torch import resolve_device
from craft_tpu_torch.cli import (ROADMAP_ARCHS, add_model_args,
                                 model_config_from_args, not_ported,
                                 refuse_jax_checkpoint)
from craft_tpu_torch.data.datasets import (TRAINING_STAGES,
                                           fetch_training_dataset)
from craft_tpu_torch.data.loader import (InfiniteLoader, MultiprocessLoader,
                                         ShardedLoader)
from craft_tpu_torch.eval.evaluate import VALIDATORS
from craft_tpu_torch.parallel import sp
from craft_tpu_torch.training.checkpoint import (checkpoint_path,
                                                 load_checkpoint,
                                                 save_checkpoint)
from craft_tpu_torch.training.logger import Logger
from craft_tpu_torch.training.optim import onecycle_linear_host
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 make_train_step)
from craft_tpu_torch.utils.profiling import trace


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="craft")
    p.add_argument("--stage", required=True, choices=TRAINING_STAGES)
    add_model_args(p)
    p.add_argument("--validation", type=str, nargs="+", default=[])
    p.add_argument("--restore_ckpt", default=None)
    p.add_argument("--loadopt", dest="load_optimizer_state",
                   action="store_true")
    p.add_argument("--loadsched", dest="load_scheduler_state",
                   action="store_true")
    p.add_argument("--output", type=str, default="checkpoints")
    p.add_argument("--lr", type=float, default=0.00002)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=6,
                   help="per-process batch (global = batch * ranks)")
    p.add_argument("--workers", dest="num_workers", type=int, default=4)
    p.add_argument("--loader_backend", choices=("process", "thread"),
                   default="process",
                   help="worker processes (reference DataLoader) or "
                        "threads")
    p.add_argument("--image_size", type=int, nargs="+", default=[384, 512])
    p.add_argument("--wdecay", type=float, default=0.00005)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--shiftprob", dest="shift_aug_prob", type=float,
                   default=0.0)
    p.add_argument("--shiftsigmas", dest="shift_sigmas", default="16,10",
                   type=str)
    p.add_argument("--freeze_bn", action="store_true")
    p.add_argument("--val_freq", type=int, default=10000)
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--attn_diag", action="store_true",
                   help="attention-health telemetry every print_freq-th "
                        "step")
    p.add_argument("--data_root", type=str, default="datasets")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="a torch.profiler trace of steps [10, 10+N)")
    p.add_argument("--profile_dir", type=str, default="craft_torch_trace")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    """Exit, naming the ROADMAP.md item, on what training does not run:
    --upsample_mode final, which the JAX CLI trains as packed."""
    if args.upsample_mode == "final":
        raise not_ported("--upsample_mode final (trained as packed)",
                         ROADMAP_ARCHS)


def _to_device(batch, device):
    """Host batch (tensors or arrays) -> tensors on `device`; on a card
    from pinned memory (the loader's, else a pinned copy), without
    blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, dtype=torch.float32)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def main(argv=None):
    """Train one stage; returns the final TrainState."""
    args = parse_args(argv)
    refuse_jax_checkpoint(args.restore_ckpt, "--restore_ckpt")
    args.shift_sigmas = tuple(int(s) for s in args.shift_sigmas.split(","))
    _check_ported(args)
    cfg = model_config_from_args(args)

    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        group = sp.init(args.device)
    device = group.device if group is not None else resolve_device(
        args.device)
    rank = 0 if group is None else group.rank
    world = 1 if group is None else group.world
    is_main = rank == 0
    if is_main:
        os.makedirs(args.output, exist_ok=True)

    np.random.seed(args.seed)
    # Freeze BN on every stage after chairs (reference train.py:198-199).
    freeze_bn = args.freeze_bn and args.stage != "chairs"
    state = create_train_state(cfg, args.seed, device=device, lr=args.lr,
                               num_steps=args.num_steps, wdecay=args.wdecay,
                               epsilon=args.epsilon, clip=args.clip)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"Parameter Count: {n_params}")

    host_lr = onecycle_linear_host(args.lr, args.num_steps + 100)
    logger = Logger(args.num_steps, args.print_freq, args.output)
    if args.restore_ckpt:
        logger_state = load_checkpoint(
            args.restore_ckpt, state,
            load_optimizer_state=args.load_optimizer_state,
            load_scheduler_state=args.load_scheduler_state)
        if logger_state:
            logger.load_state_dict(logger_state)

    step_args = dict(iters=args.iters, gamma=args.gamma, freeze_bn=freeze_bn,
                     seed=args.seed + 7, data_parallel=group)
    train_step = make_train_step(cfg, **step_args)
    # --attn_diag: a second step (every attention site on the plain path,
    # the telemetry in its metrics) every print_freq-th step, as the JAX
    # CLI; the other steps keep the kernels.
    diag_step = make_train_step(cfg, attn_diag=True, **step_args) \
        if args.attn_diag else None
    dataset = fetch_training_dataset(
        args.stage, tuple(args.image_size), shift_prob=args.shift_aug_prob,
        shift_sigmas=args.shift_sigmas, data_root=args.data_root)
    print(f"Training with {len(dataset)} image pairs")
    loader_cls = ShardedLoader if args.loader_backend == "thread" \
        else MultiprocessLoader
    loader = loader_cls(dataset, args.batch_size,
                        num_workers=args.num_workers, process_index=rank,
                        process_count=world, seed=args.seed,
                        pin_memory=device.type == "cuda")

    noise_rng = np.random.RandomState(args.seed + 13)
    profiling = contextlib.ExitStack()
    t_prev = time.time()
    step = state.step
    with profiling:
        for batch in InfiniteLoader(loader):
            if args.add_noise:
                stdv = noise_rng.uniform(0.0, 5.0)
                for k in ("image1", "image2"):
                    batch[k] = np.clip(
                        np.asarray(batch[k])
                        + stdv * noise_rng.randn(*batch[k].shape),
                        0.0, 255.0).astype(np.float32)
            batch.pop("extra_info", None)
            batch = _to_device(batch, device)
            if args.profile_steps and step == 10:
                profiling.enter_context(trace(args.profile_dir))
            use_diag = diag_step is not None and step % args.print_freq == 0
            state, metrics = (diag_step if use_diag else train_step)(state,
                                                                     batch)
            step = state.step
            if args.profile_steps and step == 10 + args.profile_steps:
                profiling.close()
            t_now = time.time()
            metrics["time"] = t_now - t_prev
            t_prev = t_now
            if is_main:
                logger.push(metrics, host_lr(step))

            if step % args.val_freq == args.val_freq - 1 and is_main:
                save_checkpoint(checkpoint_path(args.output, args.name,
                                                step + 1),
                                state, logger.state_dict())
                _run_validation(args, cfg, state, logger, device)
                logger.plot_train()
                logger.plot_val()

            if step >= args.num_steps:
                break

    if is_main:
        save_checkpoint(checkpoint_path(args.output, args.name), state,
                        logger.state_dict())
        logger.plot_train()
        logger.plot_val()
    return state


def _run_validation(args, cfg, state, logger, device):
    """The --validation sets on the model's current weights (eval mode,
    the training config); an unknown name, or a set whose files are
    missing, is skipped, as in the JAX CLI."""
    weights = state.model.state_dict()
    results = {}
    for name in args.validation:
        if name not in VALIDATORS:
            print(f"unknown validation set {name}")
            continue
        try:
            results.update(VALIDATORS[name](cfg, weights, iters=args.iters,
                                            data_root=args.data_root,
                                            device=device))
        except FileNotFoundError as e:
            print(f"validation {name} skipped: {e}")
    logger.push_validation(results)


if __name__ == "__main__":
    main()
