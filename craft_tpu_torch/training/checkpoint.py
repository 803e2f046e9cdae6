"""Checkpoints in the reference's format (port of
``craft_tpu.training.checkpoint``; reference train.py:132-175, SURVEY
section 5.4): one ``torch.save`` file of

  {"model": the reference state_dict, "optimizer": AdamW's state_dict,
   "lr_scheduler": OneCycleLR's state_dict, "logger": the logger's dict,
   "step": the step count}

written as <output>/<step + 1>_<name>.pth every val_freq steps and as
<output>/<name>.pth at the end.  "model" has the reference's keys, so a
reference-style loader reads it (``utils.weights.
load_reference_checkpoint``, and the JAX package's ``load_checkpoint`` of a
``.pth``).

Loading takes such a file or a bare reference checkpoint (weights only):
  * --loadopt: AdamW's moments, the schedule and the step;
  * --loadsched without --loadopt: the schedule and the step, with a fresh
    AdamW (the reference's lr_scheduler.load_state_dict beside a new
    optimizer);
  * neither: the weights (and BatchNorm statistics) only, at step 0.
The logger's dict is returned with --loadsched.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from craft_tpu_torch.utils.weights import load_reference_checkpoint


def checkpoint_path(output: str, name: str, step: Optional[int] = None):
    """<output>/<step>_<name>.pth, or <output>/<name>.pth."""
    stem = name if step is None else f"{step}_{name}"
    return os.path.join(output, f"{stem}.pth")


def save_checkpoint(path: str, state, logger_state: Optional[Dict] = None):
    """Save a TrainState (and the logger's dict) to `path`."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "lr_scheduler": state.schedule.state_dict(),
                "logger": logger_state or {},
                "step": state.step}, path)
    print(f"{path} saved")


def save_weights(path: str, weights) -> None:
    """Save a reference state_dict alone as {"model": weights}, the
    reference's own checkpoint layout (the evaluator's --convert), which
    the JAX package's converter and ``load_checkpoint`` both read."""
    torch.save({"model": dict(weights)}, path)


def load_checkpoint(path: str, state, load_optimizer_state: bool = False,
                    load_scheduler_state: bool = False):
    """Restore `path` into `state` in place.  Returns the logger's dict
    (with load_scheduler_state and a full checkpoint), else None."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_checkpoint(path, state.model, strict=False)
    if "optimizer" not in raw or "step" not in raw:
        print(f"Model weights loaded from {path} (no training state)")
        return None
    if load_optimizer_state:
        state.optimizer.load_state_dict(raw["optimizer"])
        print("Optimizer state loaded.")
    else:
        print("Optimizer state NOT loaded.")
    logger_state = None
    if load_optimizer_state or load_scheduler_state:
        state.schedule.load_state_dict(raw["lr_scheduler"])
        # The optimizer's rate is the schedule's at the restored step.
        for group, lr in zip(state.optimizer.param_groups,
                             state.schedule.get_last_lr()):
            group["lr"] = lr
        state.step = int(raw["step"])
        print(f"Scheduler state loaded (step {state.step}).")
    if load_scheduler_state:
        logger_state = raw["logger"]
        print("Logger loaded.")
    print(f"Model checkpoint loaded from {path}")
    return logger_state
