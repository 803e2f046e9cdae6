"""The JAX package's checkpoints in the port, on the CPU.

The JAX package's ``save_checkpoint`` writes the oracle tree with an optax
state whose Adam moments are seeded arrays and whose count is 37;
``tools/jax_checkpoint_to_pth.py`` converts the directory; the port's
``load_checkpoint`` with --loadopt (and --loadsched) restores it.  The
weights and every Adam moment must come through bit for bit, the step and
the schedule at 37, the oracle's fp32 flow within 1e-3 px; without
opt_state.pkl the tool writes the weights alone.  Both CLIs refuse the
directory itself, naming the tool.
"""

import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from craft_tpu.training.checkpoint import save_checkpoint as jax_save
from craft_tpu.training.optim import make_optimizer as jax_make_optimizer
from craft_tpu.training.train_step import TrainState as JaxTrainState
from craft_tpu_torch import evaluate as evaluate_cli
from craft_tpu_torch import train as train_cli
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.training.checkpoint import load_checkpoint
from craft_tpu_torch.training.optim import onecycle_linear_host
from craft_tpu_torch.training.train_step import create_train_state
from craft_tpu_torch.utils.weights import (load_oracle_npz,
                                           load_reference_checkpoint,
                                           state_dict_from_flax)

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "tests" / "data" / "oracle_craft_128.npz"
TOOL = REPO / "tools" / "jax_checkpoint_to_pth.py"
STEP, LR, NUM_STEPS = 37, 2.5e-4, 1000
MODEL_FLAGS = ["--craft", "--setrans", "--mixed_precision"]
SCHEDULE_FLAGS = ["--lr", str(LR), "--num_steps", str(NUM_STEPS)]
LOGGER = {"total_steps": STEP, "train_epe_list": [np.float32(1.5), 2.0],
          "train_steps_list": [np.int64(10), 20], "val_steps_list": [],
          "val_results_dict": {}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_pth",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded(tree, rng, positive=False):
    def leaf(a):
        x = rng.randn(*np.shape(a)).astype(np.float32)
        return np.abs(x) * 1e-4 if positive else x * 1e-3
    return jax.tree.map(leaf, tree)


def _with_adam(opt_state, mu, nu, count):
    """The optax state with Adam's moments and every count replaced."""
    if hasattr(opt_state, "_fields"):
        fields = {f: getattr(opt_state, f) for f in opt_state._fields}
        if "count" in fields:
            fields["count"] = np.asarray(count, np.int32)
        if "mu" in fields:
            fields["mu"], fields["nu"] = mu, nu
        return type(opt_state)(**{
            f: v if f in ("count", "mu", "nu")
            else _with_adam(v, mu, nu, count) for f, v in fields.items()})
    if isinstance(opt_state, (tuple, list)):
        return type(opt_state)(_with_adam(s, mu, nu, count)
                               for s in opt_state)
    return opt_state


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(directory, flax tree, mu, nu): the JAX package's save of the
    oracle tree at step 37 with seeded Adam moments and a logger."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    params = tree["params"]
    tx, _ = jax_make_optimizer(LR, NUM_STEPS)
    rng = np.random.RandomState(5)
    mu, nu = _seeded(params, rng), _seeded(params, rng, positive=True)
    state = JaxTrainState(step=np.asarray(STEP, np.int32), params=params,
                          batch_stats=tree["batch_stats"],
                          opt_state=_with_adam(tx.init(params), mu, nu, STEP))
    path = str(tmp_path_factory.mktemp("jax") / f"{STEP}_craft")
    jax_save(path, state, LOGGER)
    return path, tree, mu, nu


@pytest.fixture(scope="module")
def converted(jax_checkpoint, tmp_path_factory):
    path = jax_checkpoint[0]
    out = str(tmp_path_factory.mktemp("pth") / "craft.pth")
    _tool().main([path, out] + MODEL_FLAGS + SCHEDULE_FLAGS)
    return out


def _port_state():
    return create_train_state(craft_config(mixed_precision=True), 0,
                              device="cpu", lr=LR, num_steps=NUM_STEPS)


def test_weights_and_adam_moments_bit_for_bit(jax_checkpoint, converted):
    _, tree, mu, nu = jax_checkpoint
    state = _port_state()
    logger = load_checkpoint(converted, state, load_optimizer_state=True,
                             load_scheduler_state=True)
    want = state_dict_from_flax(tree)
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    mu_sd = state_dict_from_flax({"params": mu})
    nu_sd = state_dict_from_flax({"params": nu})
    n = 0
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu_sd[name]), name
        assert torch.equal(st["exp_avg_sq"], nu_sd[name]), name
        assert float(st["step"]) == STEP, name
        n += 1
    assert n == len(state.optimizer.param_groups[0]["params"])
    assert state.step == STEP
    assert state.schedule.last_epoch == STEP
    lr = onecycle_linear_host(LR, NUM_STEPS + 100)(STEP)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(lr,
                                                                  rel=1e-6)
    assert logger == {k: [float(x) if isinstance(x, np.floating) else
                          int(x) if isinstance(x, np.integer) else x
                          for x in v] if isinstance(v, list) else v
                      for k, v in LOGGER.items()}


def test_converted_oracle_flow(converted):
    """The converted file as the evaluator loads it: the oracle's fp32
    flow within 1e-3 px."""
    from craft_tpu_torch.models.flow_model import FlowModel
    img1, img2, want, _ = load_oracle_npz(ORACLE)
    model = FlowModel(craft_config(mixed_precision=False))
    missing, unexpected = load_reference_checkpoint(converted, model)
    assert missing == [] and unexpected == []
    model.eval()
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                         iters=12)
    err = float(np.abs(flows[-1].numpy() - want).max())
    print(f"converted checkpoint: max |flow diff| {err:.3e} px")
    assert err < 1e-3


def test_without_opt_state_writes_weights_only(jax_checkpoint, tmp_path):
    path, tree, _, _ = jax_checkpoint
    bare = tmp_path / "bare"
    bare.mkdir()
    os.symlink(os.path.join(path, "model"), bare / "model")
    out = str(tmp_path / "weights.pth")
    _tool().main([str(bare), out] + MODEL_FLAGS)
    raw = torch.load(out, weights_only=True)
    assert sorted(raw) == ["model"]
    want = state_dict_from_flax(tree)
    assert all(torch.equal(raw["model"][k], v) for k, v in want.items())
    state = _port_state()
    assert load_checkpoint(out, state, load_optimizer_state=True) is None
    assert state.step == 0


@pytest.mark.parametrize("cli", ["evaluate", "train"])
def test_clis_refuse_the_directory(jax_checkpoint, cli):
    path = jax_checkpoint[0]
    if cli == "evaluate":
        argv = ["--model", path, "--craft", "--setrans", "--device", "cpu",
                "--dataset", "sintel"]
        main = evaluate_cli.main
    else:
        argv = ["--stage", "chairs", "--restore_ckpt", path, "--craft",
                "--setrans", "--device", "cpu"]
        main = train_cli.main
    with pytest.raises(SystemExit, match="tools/jax_checkpoint_to_pth.py"):
        main(argv)
