"""The training step (PyTorch port of ``craft_tpu.training.train_step``;
reference train.py:213-254 semantics).

State = the model (parameters and BatchNorm running statistics), AdamW and
its one-cycle schedule, and the step count.  A step: forward with every
refinement iteration's upsampled flow -> sequence loss -> backward ->
global-norm clip -> AdamW update -> schedule step.  Dropout draws from a
generator seeded from (seed, step), as the JAX step folds the step into
its key.  ``make_train_step(attn_diag=True)`` builds the JAX package's
second step: every attention site runs the plain path and the metrics gain
attn_max, attn_clamp_frac and attn_avg_abs (the training CLI runs it every
--print_freq-th step).

With a data-parallel group (``parallel/data_parallel.py``) the step is the
JAX step over the ranks' batches together: BatchNorm's moments, the
gradients (averaged before the clip) and the metrics run over the global
batch, and each rank's dropout generator folds in its rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Union

import torch
from torch.profiler import record_function

from craft_tpu_torch import resolve_device
from craft_tpu_torch.config import ModelConfig
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.nn.setrans import AttentionDiagnostics
from craft_tpu_torch.parallel.data_parallel import (average_gradients,
                                                    max_over_ranks,
                                                    sum_over_ranks)
from craft_tpu_torch.training.loss import sequence_loss
from craft_tpu_torch.training.optim import (clip_by_global_norm,
                                            make_optimizer)


@dataclass
class TrainState:
    model: FlowModel
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler
    clip: float
    step: int = 0


def create_train_state(cfg: ModelConfig,
                       weights: Union[Mapping[str, torch.Tensor], int],
                       device=None, lr: float = 2.5e-4,
                       num_steps: int = 100000, wdecay: float = 5e-5,
                       epsilon: float = 1e-8,
                       clip: float = 1.0) -> TrainState:
    """The model on `device` (default: CUDA; raises when CUDA is absent and
    no device was asked for) with `weights`, a reference state_dict (e.g.
    ``state_dict_from_flax``), or an int seed for PyTorch's default
    initialization; AdamW and OneCycleLR over its parameters."""
    dev = resolve_device(device)
    if isinstance(weights, int):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(weights)
            model = FlowModel(cfg)
    else:
        model = FlowModel(cfg)
        model.load_state_dict(weights, strict=True)
    model = model.to(dev)
    opt, sched = make_optimizer(model.parameters(), lr, num_steps, wdecay,
                                epsilon)
    return TrainState(model, opt, sched, clip)


def make_train_step(cfg: ModelConfig, iters: int = 12, gamma: float = 0.8,
                    freeze_bn: bool = False, seed: int = 0,
                    data_parallel=None, attn_diag: bool = False):
    """step(state, batch) -> (state, metrics).  batch: image1, image2
    [B, H, W, 3] in [0, 255], flow [B, H, W, 2], valid [B, H, W], on the
    model's device.  metrics: loss, epe, 1px, 3px, 5px and grad_norm (the
    global norm before clipping), 0-d tensors on the device.  The step
    updates the state's model and optimizer in place and returns it.
    `data_parallel`: this rank's group (``sp.init``), whose ranks each take
    their own batch; None or a world of 1 runs alone.  `attn_diag`: the
    diagnostics step (every site on the plain path), whose metrics add
    attn_max (the max over the sites, and the ranks), attn_clamp_frac and
    attn_avg_abs (means over the sites, then the ranks)."""
    dp = data_parallel if data_parallel is not None \
        and data_parallel.world > 1 else None
    rank = 0 if dp is None else dp.rank

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model = state.model
        model.freeze_bn = freeze_bn
        model.train()
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(_fold_in(seed + (rank << 32), state.step))
        params = [p for p in model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        diag = AttentionDiagnostics() if attn_diag else None
        _, flows = model(batch["image1"], batch["image2"], iters=iters,
                         upsample_mode="all", generator=gen,
                         data_parallel=dp, diagnostics=diag)
        loss, metrics = sequence_loss(
            flows.float(), batch["flow"], batch["valid"], gamma,
            metric_sum=None if dp is None else sum_over_ranks)
        if diag is not None:
            metrics.update(_diag_metrics(diag, dp))
        with record_function("craft.backward"):
            loss.backward()
        with record_function("craft.optimizer"):
            for p in params:
                # A parameter the step does not reach (the probs-only
                # site's attn_softaggr) gets a zero gradient, so AdamW still
                # decays it as optax does.
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if dp is not None:
                average_gradients(params, dp.world)
                loss = sum_over_ranks(loss) / dp.world
            grad_norm = clip_by_global_norm(params, state.clip)
            state.optimizer.step()
            state.schedule.step()
        state.step += 1
        out: Dict[str, torch.Tensor] = dict(metrics)
        out["loss"] = loss.detach()
        out["grad_norm"] = grad_norm
        return state, out

    return step


def _diag_metrics(diag, dp) -> Dict[str, torch.Tensor]:
    """The diagnostics' summary, over every rank's batch under `dp`."""
    out = diag.summary()
    if dp is not None:
        out["attn_max"] = max_over_ranks(out["attn_max"])
        for key in ("attn_clamp_frac", "attn_avg_abs"):
            out[key] = sum_over_ranks(out[key]) / dp.world
    return out


def _fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step), distinct for each pair."""
    return (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63)


def host_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as Python floats (one host sync)."""
    keys = tuple(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))
