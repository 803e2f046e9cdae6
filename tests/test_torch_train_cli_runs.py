"""The port's training CLI with --profile_steps, and data-parallel ranks
(gloo, spawned as processes, each run with its own time limit), on the
CPU: moved whole from ``tests/test_torch_train_cli.py``, whose fixtures
and helpers they take, so that the two files run on two workers.

A spawned rank imports this module, so it imports no JAX at module level.
"""

import os
import re

import numpy as np
import torch

from craft_tpu_torch import train as tcli
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.training.optim import onecycle_linear_host
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from test_torch_sp import run_ranks
from test_torch_train_cli import (ITERS, _batch, _cli_args, _no_dropout,
                                  _torch, chairs_tree, oracle_sd)  # noqa: F401


def test_cli_profiles_steps_ten_on(chairs_tree, tmp_path):
    """--profile_steps 1 writes a trace of step 10 (the JAX CLI's window,
    steps [10, 10 + N))."""
    trace_dir = tmp_path / "trace"
    state = tcli.main(_cli_args(chairs_tree, tmp_path / "run", "--num_steps",
                                "11", "--val_freq", "1000", "--profile_steps",
                                "1", "--profile_dir", str(trace_dir)))
    assert state.step == 11
    assert (trace_dir / "trace.json").stat().st_size > 0


# ------------------------------------------------------------ ranks

DP_BATCH = 4
# Two ranks of batch 2 against one process of batch 4: the same samples,
# the sums over the batch split in two and added.  The loss and the metrics
# within 1e-5 relative; each gradient (averaged over the ranks, clipped)
# within 1e-5 of its tensor's largest; each parameter after the AdamW step
# within 1e-5 of its tensor's largest, plus 2e-5 of the step's learning
# rate (Adam's step moved by a gradient within 1e-5 of itself), except
# where the element's gradient g has g^2 < G * eps (G the tensor's largest
# gradient, eps Adam's 1e-8): Adam divides each element's step by |g| +
# eps, so there a gradient error of 1e-5 G moves the step by up to its
# whole size, and the element is held within twice the rate; cnet's
# BatchNorm running statistics within 1e-5 relative (plus 1e-7).  The
# parameters whose gradient is rounding noise (the biases right before a
# normalization, feat2score's bias; see test_torch_training.py) take
# Adam's step from the noise's sign: they are held within 1e-5 of the
# model's largest gradient instead, and after the step within twice the
# step's learning rate.
DP_RTOL, ADAM_EPS = 1e-5, 1e-8
ZERO_GRAD = re.compile(r"^(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|"
                       r"downsample\.0))\.bias$|feat2score\.bias$")


def _dp_step(group, sd, batch):
    """One fp32 step (dropout off) of this rank's share of `batch`, or of
    all of it without a group: (metrics, gradients, parameters, running
    statistics), numpy."""
    cfg = _no_dropout(craft_config(mixed_precision=False))
    state = create_train_state(cfg, {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                               device="cpu", num_steps=100)
    if group is not None:
        n = DP_BATCH // group.world
        batch = {k: v[group.rank * n:(group.rank + 1) * n]
                 for k, v in batch.items()}
    step = make_train_step(cfg, iters=ITERS, data_parallel=group)
    state, metrics = step(state, _torch(batch))
    model = state.model
    return (host_metrics(metrics),
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()},
            {n: b.numpy().copy() for n, b in model.named_buffers()
             if "running_" in n})


def test_data_parallel_ranks_match_one_process(oracle_sd, tmp_path):
    sd = {k: v.numpy() for k, v in oracle_sd.items()}
    batch = _batch(DP_BATCH, seed=3)
    want_m, want_g, want_p, want_s = _dp_step(None, sd, batch)
    ranks = run_ranks(tmp_path, 2, _dp_step, sd, batch)
    lr = onecycle_linear_host(2.5e-4, 200)(0)
    gmax = max(float(np.abs(g).max()) for g in want_g.values())
    for r, (m, grads, params, stats) in enumerate(ranks):
        for key, w in want_m.items():
            assert abs(m[key] - w) <= DP_RTOL * abs(w) + 1e-7, (r, key)
        for name, w in want_g.items():
            err = float(np.abs(grads[name] - w).max())
            scale = gmax if ZERO_GRAD.search(name) else \
                max(float(np.abs(w).max()), 1e-30)
            assert err <= DP_RTOL * scale, (r, name, err / scale)
        for name, w in want_p.items():
            err = float(np.abs(params[name] - w).max())
            if ZERO_GRAD.search(name):
                assert err <= 2 * lr, (r, name, err)
                continue
            g = np.abs(want_g[name])
            bound = np.where(g * g < g.max() * ADAM_EPS, 2 * lr,
                             DP_RTOL * (float(np.abs(w).max()) + 2 * lr))
            excess = np.abs(params[name] - w) - bound
            assert excess.max() <= 0, (r, name, err)
        for name, w in want_s.items():
            np.testing.assert_allclose(stats[name], w, rtol=DP_RTOL,
                                       atol=1e-7, err_msg=f"{r} {name}")
    # The ranks end with the same replica.
    for name in want_p:
        np.testing.assert_array_equal(ranks[0][2][name], ranks[1][2][name])


def _cli_rank(group, argv):
    """tcli.main(argv) as one rank of `group`: its parameters and the
    paths it saved."""
    os.environ["WORLD_SIZE"] = str(group.world)
    saved, save = [], tcli.save_checkpoint
    tcli.save_checkpoint = lambda path, *a: (saved.append(path),
                                             save(path, *a))
    try:
        state = tcli.main(argv)
    finally:
        tcli.save_checkpoint = save
    return ({n: p.detach().numpy().copy()
             for n, p in state.model.named_parameters()}, saved)


def test_cli_ranks_train_together_and_rank_zero_writes(chairs_tree,
                                                       tmp_path):
    """Two ranks of the CLI (sp.init's group, as under torchrun) take 2
    steps of their shards of each epoch: the replicas stay equal, and only
    rank 0 saves (the checkpoint after step 1 and the final one)."""
    out = tmp_path / "out"
    argv = _cli_args(chairs_tree, out, "--num_steps", "2", "--val_freq", "2")
    (params0, saved0), (params1, saved1) = run_ranks(tmp_path, 2, _cli_rank,
                                                     argv)
    for name, w in params0.items():
        np.testing.assert_array_equal(params1[name], w, err_msg=name)
    assert saved0 == [str(out / "2_t.pth"), str(out / "t.pth")]
    assert saved1 == []
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == \
        ["2_t.pth", "t.pth"]
