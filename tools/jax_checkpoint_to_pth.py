"""Convert a checkpoint of the JAX package (an orbax directory written by
``python -m craft_tpu.train`` or the JAX evaluator's ``--convert``) into
the PyTorch port's checkpoint file.

    python tools/jax_checkpoint_to_pth.py CKPT_DIR OUT.pth \\
        --craft --setrans --lr 2.5e-4 --num_steps 120000 [--wdecay ..]

CKPT_DIR holds ``model`` ({step, params, batch_stats}, orbax), and, from
the training CLI, ``opt_state.pkl`` (the optax state) and ``logger.pkl``.
OUT.pth is then what ``craft_tpu_torch.training.checkpoint.
save_checkpoint`` writes:

  model         the reference state_dict, through ``state_dict_from_flax``
  optimizer     AdamW's state_dict: per port parameter exp_avg and
                exp_avg_sq from optax Adam's mu and nu (the same tree, so
                ``state_dict_from_flax`` lays them out), step from count
  lr_scheduler  OneCycleLR at the checkpoint's step, from the schedule
                flags (--lr, --num_steps), for --loadsched
  logger        logger.pkl's dict ({} without it)
  step          the checkpoint's step

Without ``opt_state.pkl`` (a converted or evaluation-only checkpoint) it
writes the weights alone, ``{"model": ...}`` (``save_weights``).  Both
files load with ``python -m craft_tpu_torch.evaluate --model OUT.pth`` and
``python -m craft_tpu_torch.train --restore_ckpt OUT.pth [--loadopt]
[--loadsched]``.  The model flags (--craft, --setrans, ...) are the
training run's: they build the port's model, whose parameter order
AdamW's state follows.

This script needs JAX, optax and orbax, so it runs where the JAX package
is installed; the port itself reads only the file it writes.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from craft_tpu_torch.cli import (add_model_args,  # noqa: E402
                                 model_config_from_args)
from craft_tpu_torch.models.flow_model import FlowModel  # noqa: E402
from craft_tpu_torch.training.checkpoint import (save_checkpoint,  # noqa: E402
                                                 save_weights)
from craft_tpu_torch.training.optim import make_optimizer  # noqa: E402
from craft_tpu_torch.training.train_step import TrainState  # noqa: E402
from craft_tpu_torch.utils.weights import state_dict_from_flax  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help="the JAX package's checkpoint directory")
    p.add_argument("out", help="the port's .pth file to write")
    add_model_args(p)
    # The schedule's flags, with the training CLIs' defaults.
    p.add_argument("--lr", type=float, default=0.00002)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--wdecay", type=float, default=0.00005)
    p.add_argument("--epsilon", type=float, default=1e-8)
    return p.parse_args(argv)


def restore_model(ckpt: str) -> dict:
    """{step, params, batch_stats} of <ckpt>/model as numpy trees."""
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer().restore(
        os.path.abspath(os.path.join(ckpt, "model")))


def adam_state(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside an optax state
    tree (``craft_tpu/training/optim.py``: clip, then adamw's chain)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    children = (opt_state.values() if isinstance(opt_state, dict)
                else opt_state if isinstance(opt_state, (tuple, list))
                else ())
    for child in children:
        found = adam_state(child)
        if found is not None:
            return found
    return None


def plain(x):
    """numpy scalars and arrays in the logger's dict as Python values, so
    that ``torch.load(weights_only=True)`` reads it."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def convert(args) -> str:
    """Write args.out from args.ckpt; returns what was written."""
    payload = restore_model(args.ckpt)
    weights = state_dict_from_flax({"params": payload["params"],
                                    "batch_stats": payload.get(
                                        "batch_stats") or {}})
    opt_path = os.path.join(args.ckpt, "opt_state.pkl")
    if not os.path.isfile(opt_path):
        save_weights(args.out, weights)
        return "weights"

    model = FlowModel(model_config_from_args(args))
    model.load_state_dict(weights, strict=True)
    opt, sched = make_optimizer(model.parameters(), args.lr, args.num_steps,
                                args.wdecay, args.epsilon)
    with open(opt_path, "rb") as f:
        adam = adam_state(pickle.load(f))
    if adam is None:
        raise SystemExit(f"{opt_path}: no optax Adam state (mu, nu, count)")
    mu = state_dict_from_flax({"params": adam.mu})
    nu = state_dict_from_flax({"params": adam.nu})
    count = torch.tensor(float(np.asarray(adam.count)))
    # named_parameters() names each parameter once (a tied query/key
    # projection by its query), in AdamW's order.
    for name, p in model.named_parameters():
        opt.state[p] = {"step": count.clone(), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
    step = int(np.asarray(payload["step"]))
    with warnings.catch_warnings():
        # The schedule is stepped without optimizer steps on purpose.
        warnings.simplefilter("ignore", UserWarning)
        for _ in range(step):
            sched.step()
    logger_state = {}
    log_path = os.path.join(args.ckpt, "logger.pkl")
    if os.path.isfile(log_path):
        with open(log_path, "rb") as f:
            logger_state = plain(pickle.load(f))
    save_checkpoint(args.out, TrainState(model, opt, sched, clip=1.0,
                                         step=step), logger_state)
    return "training state"


def main(argv=None) -> str:
    args = parse_args(argv)
    what = convert(args)
    print(f"Converted {args.ckpt} -> {args.out} ({what})")
    return args.out


if __name__ == "__main__":
    main()
