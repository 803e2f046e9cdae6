"""The training CLI under the flags that once exited before training
(``python -m craft_tpu_torch.train --device cpu`` on the synthetic
FlyingChairs tree of tests/test_torch_train_cli.py): --attn_diag,
--interpos lsinu, --intrapos lsinu and --f2radius each train a step and
save a finite checkpoint of their config's weights; and with all of them
together at --print_freq 2 the diagnostics step runs at steps 0 and 2
(step % print_freq == 0, as the JAX CLI) and each status line prints
attn_max, attn_clamp_frac and attn_avg_abs.  Then the diagnostics step on
two data-parallel ranks (gloo, spawned) against one process of their two
samples: the metrics over the global batch, within 1e-5 relative.

A spawned rank imports this module, so it imports no JAX at module level.
"""

import math
import re

import numpy as np
import pytest
import torch

from craft_tpu_torch import train as tcli
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.training import train_step as ts
from test_torch_sp import run_ranks
from test_torch_train_cli import (ITERS, _batch, _cli_args,  # noqa: F401
                                  _no_dropout, _torch, chairs_tree,
                                  oracle_sd)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's steps: under pytest-xdist the
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [["--attn_diag"], ["--interpos", "lsinu"],
                                   ["--intrapos", "lsinu"],
                                   ["--f2radius", "3"]],
                         ids=lambda v: "_".join(v))
def test_cli_trains_a_step_under_each_flag(chairs_tree, tmp_path, flags):
    out = tmp_path / "out"
    state = tcli.main(_cli_args(chairs_tree, out, "--num_steps", "1",
                                "--val_freq", "1000") + flags)
    assert state.step == 1
    ckpt = torch.load(out / "t.pth", weights_only=True)
    assert ckpt["step"] == 1
    assert all(torch.isfinite(v).all() for v in ckpt["model"].values()
               if v.is_floating_point())
    lsinu = "lsinu" in flags
    assert any("pos_fc" in k for k in ckpt["model"]) == lsinu
    if "--interpos" in flags:
        assert state.model.cfg.inter.pos_code_type == "lsinu"
        assert state.model.cfg.f2.pos_code_type == "bias"
    if "--intrapos" in flags:  # the f2 site takes the intra site's code
        assert state.model.cfg.intra.pos_code_type == "lsinu"
        assert state.model.cfg.f2.pos_code_type == "lsinu"
    if "--f2radius" in flags:
        assert state.model.cfg.f2.attn_mask_radius == 3


def test_cli_prints_the_diagnostics_at_print_freq(chairs_tree, tmp_path,
                                                  capsys, monkeypatch):
    built = []
    make = ts.make_train_step

    def counted(*a, attn_diag=False, **kw):
        step = make(*a, attn_diag=attn_diag, **kw)

        def run(state, batch):
            built.append((state.step, attn_diag))
            return step(state, batch)
        return run
    monkeypatch.setattr(tcli, "make_train_step", counted)
    tcli.main(_cli_args(chairs_tree, tmp_path / "out", "--num_steps", "4",
                        "--val_freq", "1000", "--interpos", "lsinu",
                        "--intrapos", "lsinu", "--f2radius", "3",
                        "--attn_diag"))
    assert built == [(0, True), (1, False), (2, True), (3, False)]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")]
    assert len(lines) == 2
    for line in lines:
        vals = {k: float(v) for k, v in re.findall(
            r"(attn_max|attn_clamp_frac|attn_avg_abs) (\S+?),?(?= |$)",
            line)}
        assert sorted(vals) == ["attn_avg_abs", "attn_clamp_frac",
                                "attn_max"], line
        assert all(math.isfinite(v) for v in vals.values())
        assert vals["attn_max"] > 0


DIAG_KEYS = ("attn_max", "attn_clamp_frac", "attn_avg_abs", "loss")


def _diag_step(group, sd, batch):
    """One fp32 --attn_diag step (dropout off) of this rank's sample of
    `batch`, or of both without a group: its host metrics."""
    cfg = _no_dropout(craft_config(mixed_precision=False))
    state = ts.create_train_state(cfg, {k: torch.from_numpy(v)
                                        for k, v in sd.items()},
                                  device="cpu", num_steps=100)
    if group is not None:
        batch = {k: v[group.rank:group.rank + 1] for k, v in batch.items()}
    step = ts.make_train_step(cfg, iters=ITERS, data_parallel=group,
                              attn_diag=True)
    return ts.host_metrics(step(state, _torch(batch))[1])


def test_diagnostics_over_data_parallel_ranks(oracle_sd, tmp_path):
    sd = {k: v.numpy() for k, v in oracle_sd.items()}
    batch = _batch(2, seed=4)
    want = _diag_step(None, sd, batch)
    for got in run_ranks(tmp_path, 2, _diag_step, sd, batch):
        for key in DIAG_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
