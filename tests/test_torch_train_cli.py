"""The port's training entry point on the CPU: the host schedule, the
checkpoints and their --loadopt / --loadsched semantics, ``python -m
craft_tpu_torch.train --device cpu`` on a synthetic FlyingChairs tree (and
--stage viper, and --validation beyond chairs), the exits on what is not
ported, and data-parallel ranks (gloo, spawned as processes, each run with
its own time limit).  ``tests/test_torch_train_cli_runs.py`` holds the
--profile_steps run and the data-parallel ranks.

A spawned rank imports this module, so it imports no JAX at module level:
the tests that hold the port against the JAX package import it inside.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import write_chairs
from craft_tpu_torch import train as tcli
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from craft_tpu_torch.training.optim import (make_optimizer,
                                            onecycle_linear_host)
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

ORACLE = os.path.join(os.path.dirname(__file__), "data",
                      "oracle_craft_128.npz")
HW, ITERS = 64, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _no_dropout(cfg):
    return cfg.replace(**{site: dataclasses.replace(getattr(cfg, site),
                                                    **NO_DROPOUT)
                          for site in ("inter", "f2", "intra")})


@pytest.fixture(scope="module")
def oracle_sd():
    return state_dict_from_flax(load_oracle_npz(ORACLE)[3])


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image1": rng.uniform(0, 255, (n, HW, HW, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (n, HW, HW, 3)).astype(np.float32),
            "flow": (rng.randn(n, HW, HW, 2) * 3).astype(np.float32),
            "valid": (rng.uniform(size=(n, HW, HW)) > 0.2).astype(
                np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("num_steps", [2, 37, 100, 1900, 120000])
def test_host_schedule_matches_jax_and_onecycle(num_steps):
    """Every step's rate, exactly: the host schedule equals the JAX
    package's and the port's optimizer schedule; torch's OneCycleLR equals
    them where pct_start * total is a whole step (every stage's step
    count: 100, 1900, 120000), and elsewhere ends its warm-up a fraction
    of a step later."""
    from craft_tpu.training.optim import onecycle_linear_host as jax_host

    lr, total = 2.5e-4, num_steps + 100
    got, want = onecycle_linear_host(lr, total), jax_host(lr, total)
    param = torch.nn.Parameter(torch.zeros(1))
    opt, sched = make_optimizer([param], lr, num_steps)
    ref_opt = torch.optim.AdamW([param], lr=lr)
    ref = torch.optim.lr_scheduler.OneCycleLR(
        ref_opt, max_lr=lr, total_steps=total, pct_start=0.05,
        anneal_strategy="linear", cycle_momentum=False)
    whole = (0.05 * total).is_integer()
    differs = 0
    for step in range(total):
        assert got(step) == want(step) == opt.param_groups[0]["lr"], step
        if whole:
            assert ref.get_last_lr()[0] == got(step), step
        differs += ref.get_last_lr()[0] != got(step)
        for o, sc in ((opt, sched), (ref_opt, ref)):
            o.step()
            sc.step()
    assert whole or differs > 0


# ------------------------------------------------------------ logger

def test_logger_matches_jax(tmp_path, capsys):
    """The same float32 metrics (0-d tensors on the port's side, numpy
    scalars on the JAX side, as its device arrays): the same status lines
    and the same state."""
    from craft_tpu.training.logger import Logger as JaxLogger

    from craft_tpu_torch.training.logger import Logger

    rng = np.random.RandomState(0)
    logs = []
    for logger, wrap in ((JaxLogger(20, 3, str(tmp_path)), np.float32),
                         (Logger(20, 3, str(tmp_path)),
                          lambda v: torch.tensor(v, dtype=torch.float32))):
        for step in range(7):
            m = {k: wrap(float(v)) for k, v in zip(
                ("epe", "loss", "1px"), rng.uniform(0, 5, 3))}
            logger.push(dict(m, time=0.25), lr=1e-4 * (step + 1))
        logger.push_validation({"chairs_epe": 1.25})
        logs.append((capsys.readouterr().out, logger.state_dict()))
        rng = np.random.RandomState(0)
    assert logs[0][0] == logs[1][0] and logs[0][0].count("\n") == 2
    assert logs[0][1] == logs[1][1]


def test_trace_and_step_timer(tmp_path):
    from craft_tpu_torch.utils.profiling import StepTimer, trace

    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    timer = StepTimer(warmup=2)
    for _ in range(5):
        timer.tic()
        timer.toc()
    assert timer.count == 5 and 0 <= timer.mean <= timer.total


# ------------------------------------------------------------ checkpoints

@pytest.fixture(scope="module")
def trained(oracle_sd, tmp_path_factory):
    """Two fp32 steps from the oracle weights, saved as a checkpoint:
    (path, state, the logger's dict)."""
    cfg = _no_dropout(craft_config(mixed_precision=False))
    state = create_train_state(cfg, oracle_sd, device="cpu", num_steps=100)
    step = make_train_step(cfg, iters=ITERS)
    for seed in range(2):
        state, _ = step(state, _torch(_batch(2, seed)))
    logger = {"total_steps": 2, "train_epe_list": [1.5],
              "train_steps_list": [1], "val_steps_list": [],
              "val_results_dict": {}}
    path = str(tmp_path_factory.mktemp("ckpt") / "2_craft.pth")
    save_checkpoint(path, state, logger)
    return path, state, logger


def _fresh(oracle_sd):
    return create_train_state(_no_dropout(craft_config(mixed_precision=False)),
                              oracle_sd, device="cpu", num_steps=100)


def _same_weights(model, sd):
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("mode", ["loadopt", "loadsched", "neither", "bare"])
def test_checkpoint_restore_semantics(oracle_sd, trained, tmp_path, mode):
    """--loadopt: AdamW's moments, the schedule and the step; --loadsched
    alone: the schedule and the step beside a fresh AdamW, and the logger;
    neither: weights only at step 0; a bare reference .pth ('module.'
    keys): weights only."""
    path, saved, logger = trained
    if mode == "bare":
        path = str(tmp_path / "ref.pth")
        torch.save({f"module.{k}": v
                    for k, v in saved.model.state_dict().items()}, path)
    state = _fresh(oracle_sd)
    got_logger = load_checkpoint(path, state,
                                 load_optimizer_state=mode == "loadopt",
                                 load_scheduler_state=mode == "loadsched")
    _same_weights(state.model, saved.model.state_dict())
    lr = state.optimizer.param_groups[0]["lr"]
    if mode in ("loadopt", "loadsched"):
        assert state.step == saved.step == 2
        assert state.schedule.last_epoch == saved.schedule.last_epoch
        assert lr == saved.optimizer.param_groups[0]["lr"]
        assert lr == onecycle_linear_host(2.5e-4, 200)(2)
    else:
        assert state.step == 0 and state.schedule.last_epoch == 0
        assert lr == 2.5e-4 / 25
    if mode == "loadopt":
        for p, q in zip(state.model.parameters(), saved.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                torch.testing.assert_close(state.optimizer.state[p][key],
                                           saved.optimizer.state[q][key],
                                           rtol=0, atol=0)
    else:
        assert not state.optimizer.state
    assert got_logger == (logger if mode == "loadsched" else None)


def test_jax_load_checkpoint_reads_the_port_checkpoint(oracle_sd, trained):
    """The JAX package's load_checkpoint of the port's .pth gives the flax
    tree that maps back (state_dict_from_flax) to the port's trained
    state_dict exactly."""
    from craft_tpu.training.checkpoint import load_checkpoint as jax_load
    from craft_tpu.training.train_step import TrainState

    path, saved, _ = trained
    tree = load_oracle_npz(ORACLE)[3]
    template = TrainState(step=np.zeros((), np.int32), params=tree["params"],
                          batch_stats=tree["batch_stats"], opt_state=None)
    restored, _ = jax_load(path, template)
    sd = state_dict_from_flax({"params": restored.params,
                               "batch_stats": restored.batch_stats})
    want = saved.model.state_dict()
    assert sorted(sd) == sorted(want)
    changed = 0
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(),
                                      err_msg=k)
        changed += not torch.equal(v, oracle_sd[k])
    assert changed > 100  # the trained weights, not the oracle's


# ------------------------------------------------------------ the CLI

def _cli_args(data, out, *extra):
    return ["--stage", "chairs", "--craft", "--setrans", "--lr", "2.5e-4",
            "--image_size", str(HW), str(HW), "--batch_size", "2",
            "--workers", "1", "--iters", str(ITERS), "--print_freq", "2",
            "--data_root", str(data), "--output", str(out), "--name", "t",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def chairs_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    write_chairs(root, 6, 2, (80, 96))
    return root


def test_cli_trains_validates_saves_and_resumes(chairs_tree, tmp_path,
                                                capsys):
    """3 steps of the chairs stage: a status line, the checkpoint and the
    chairs validation at --val_freq, the final checkpoint; then a resume
    from the step-1 checkpoint with --loadsched ends at the uninterrupted
    run's step, learning rate and logger count."""
    out = tmp_path / "run"
    state = tcli.main(_cli_args(chairs_tree, out, "--num_steps", "3",
                                "--val_freq", "2", "--validation", "chairs"))
    log = capsys.readouterr().out
    assert re.search(r"\[     2,  0\.\d{7}\] 1px .* epe .* loss ", log)
    assert "Validation Chairs EPE" in log
    assert state.step == 3
    # The JAX CLI's cadence: after step 1 (1 % 2 == 2 - 1), "2_<name>".
    # It is saved before that validation runs, as in the JAX CLI.
    ckpt = torch.load(out / "2_t.pth", weights_only=True)
    assert ckpt["step"] == 1 and ckpt["logger"]["val_results_dict"] == {}
    final = torch.load(out / "t.pth", weights_only=True)
    assert final["step"] == 3 and final["logger"]["total_steps"] == 3
    # Steps 1 and 3 validate (step % 2 == 1).
    assert [len(v) for v in final["logger"]["val_results_dict"].values()
            ] == [2]
    assert sorted(os.listdir(out)) == sorted(
        ["2_t.pth", "4_t.pth", "t.pth"]
        + (["chairs_epe.png", "train_epe.png"] if _has_matplotlib() else []))

    resumed = tcli.main(_cli_args(
        chairs_tree, tmp_path / "resumed", "--num_steps", "3", "--val_freq",
        "1000", "--restore_ckpt", str(out / "2_t.pth"), "--loadsched"))
    assert resumed.step == state.step
    assert resumed.optimizer.param_groups[0]["lr"] == \
        state.optimizer.param_groups[0]["lr"]
    again = torch.load(tmp_path / "resumed" / "t.pth", weights_only=True)
    assert again["logger"]["total_steps"] == 3


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


# A mode count that does not divide its site's width (the JAX package's
# model cannot build it).
@pytest.mark.parametrize("flags,item", [
    (["--intermodes", "3"], "must divide")],
    ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_cli_exits_on_what_is_not_ported(tmp_path, flags, item):
    """Each exits before training starts (no data, no output written)."""
    argv = _cli_args(tmp_path / "none", tmp_path / "out")
    with pytest.raises(SystemExit, match=item):
        tcli.main(argv + flags)
    assert not (tmp_path / "out").exists()


# What exited naming ROADMAP item 6 (mode counts other than 4) trains; the
# mode dims below 16 train in tests/test_torch_modes_small_train_cli.py
# (this file is the tier-1 run's longest).
@pytest.mark.parametrize("flags", [
    ["--f2modes", "8"], ["--nogma", "--intramodes", "8"],
    ["--intermodes", "2"], ["--f1", "shared", "--f2modes", "2"],
    ["--intramodes", "2"]], ids=lambda v: "_".join(v))
def test_cli_trains_other_mode_counts(chairs_tree, tmp_path, flags):
    """The flags give the JAX CLI's config, field by field, and one step of
    the chairs stage runs with it (finite weights, the checkpoint
    written)."""
    import craft_tpu.cli as jcli
    from craft_tpu_torch import cli
    from test_torch_modes import parse, same_config
    argv = ["--craft", "--setrans"] + flags
    got = cli.model_config_from_args(parse(cli, argv))
    same_config(got, jcli.model_config_from_args(parse(jcli, argv)))
    out = tmp_path / "out"
    state = tcli.main(_cli_args(chairs_tree, out, "--num_steps", "1",
                                *flags))
    cfg = state.model.cfg
    assert state.step == 1 and (cfg.arch, cfg.inter, cfg.f2, cfg.intra) == (
        got.arch, got.inter, got.f2, got.intra)
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())
    assert (out / "t.pth").exists()


@pytest.mark.parametrize("case", ["stage_viper", "validation_things"])
def test_cli_runs_the_viper_stage_and_every_validation(tmp_path, case):
    """What exited naming ROADMAP item 4 trains: one step of --stage viper
    on a VIPER tree of JPEG frames, and one chairs step validated on
    things at --val_freq 1 (an unknown name is skipped, as in the JAX
    CLI)."""
    import io

    from PIL import Image

    from chip_smoke import write_things_tree, write_viper_tree

    rng = np.random.RandomState(5)
    data = tmp_path / "data"
    if case == "stage_viper":
        def jpeg():
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (160, 192, 3)).astype(
                np.uint8)).save(buf, "JPEG", quality=90)
            return buf.getvalue()
        write_viper_tree(data, [(jpeg(), jpeg()) for _ in range(2)],
                         [rng.uniform(-5, 5, (160, 192, 2)).astype(
                             np.float32) for _ in range(2)], split="train")
        argv = _cli_args(data, tmp_path / "out", "--num_steps", "1")
        argv[1] = "viper"
    else:
        write_chairs(data, 2, 1, (HW, HW))
        write_things_tree(data, [rng.randint(0, 256, (HW, HW, 3)).astype(
            np.uint8) for _ in range(2)], [rng.uniform(-3, 3, (
                HW, HW, 2)).astype(np.float32) for _ in range(2)])
        argv = _cli_args(data, tmp_path / "out", "--num_steps", "1",
                         "--val_freq", "1", "--validation", "things",
                         "nosuchset")
    state = tcli.main(argv)
    assert state.step == 1
    final = torch.load(tmp_path / "out" / "t.pth", weights_only=True)
    results = final["logger"]["val_results_dict"]
    if case == "validation_things":
        assert {"things_clean_epe", "things_final_epe"} <= set(results)
        assert not any(k.startswith("chairs") for k in results)


# ------------------------------------------------------------ against JAX

@pytest.mark.slow
def test_cli_matches_the_jax_cli(oracle_sd, chairs_tree, tmp_path,
                                 monkeypatch):
    """Both CLIs from one reference .pth (the oracle tree), 2 fp32 steps
    without dropout at 64x64, batch 2, on the same loader batches.  Each
    step's loss, EPE metrics and gradient norm within
    test_torch_training.py's fp32 step bounds (1e-5, 1e-5 + 1e-6, 1e-4
    relative).  The parameters' change over the 2 steps, per module group,
    within 5e-2 of the JAX change's norm: Adam's first steps move each
    element by about the rate whatever its gradient's size, so an element
    whose gradient lies inside the step bound (1e-3 of its tensor's
    largest) may step the other way."""
    import orbax.checkpoint as ocp

    from craft_tpu import train as jcli
    from craft_tpu.training import logger as jlogger

    ref = tmp_path / "ref.pth"
    torch.save({"model": oracle_sd}, ref)
    common = ["--stage", "chairs", "--craft", "--setrans", "--lr", "2.5e-4",
              "--image_size", str(HW), str(HW), "--batch_size", "2",
              "--workers", "1", "--iters", str(ITERS), "--num_steps", "2",
              "--val_freq", "1000", "--data_root", str(chairs_tree),
              "--restore_ckpt", str(ref), "--name", "t"]
    logged = {"jax": [], "port": []}
    for mod, logger, key in ((jcli, jlogger.Logger, "jax"),
                             (tcli, tcli.Logger, "port")):
        real = mod.model_config_from_args
        monkeypatch.setattr(mod, "model_config_from_args",
                            lambda args, real=real: _no_dropout(real(args)))
        push = logger.push
        monkeypatch.setattr(
            logger, "push", lambda self, m, lr, push=push, key=key: (
                logged[key].append({k: float(v) for k, v in m.items()}),
                push(self, m, lr)))
    jcli.main(common + ["--output", str(tmp_path / "jax")])
    state = tcli.main(common + ["--output", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert len(logged["jax"]) == len(logged["port"]) == 2
    for got, want in zip(logged["port"], logged["jax"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        for key in ("epe", "1px", "3px", "5px"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)

    payload = ocp.PyTreeCheckpointer().restore(
        str((tmp_path / "jax" / "t" / "model").resolve()))
    want = state_dict_from_flax({"params": payload["params"],
                                 "batch_stats": payload["batch_stats"]})
    got = dict(state.model.named_parameters())
    for group in ("fnet", "cnet", "f2_trans", "att", "corr_fn",
                  "update_block"):
        names = [n for n in got if n.startswith(group)]
        start = {n: oracle_sd[n].double().numpy() for n in names}
        d_port = {n: got[n].detach().double().numpy() - start[n]
                  for n in names}
        d_jax = {n: np.asarray(want[n], np.float64) - start[n]
                 for n in names}
        num = sum(float(((d_port[n] - d_jax[n]) ** 2).sum()) for n in names)
        den = sum(float((d_jax[n] ** 2).sum()) for n in names)
        print(f"{group}: parameter change vs JAX {(num / den) ** 0.5:.3e}")
        assert (num / den) ** 0.5 <= 5e-2, group
