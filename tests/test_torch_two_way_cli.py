"""The two CLIs of the port with two-way correlation (--f1), on the CPU.

* ``python -m craft_tpu_torch.evaluate --f1 shared|private`` over a
  reference-format .pth (``test_torch_two_way.two_way_tree``) on a one-pair
  Sintel tree at 64x64: its EPE against the EPE of the JAX model's flow on
  the same pair (fp32, within 1e-4 px: the flows agree to 1e-5 px), and
  --convert writing a .pth that lists the shared module under both names.
* ``python -m craft_tpu_torch.train --f1 shared|private``: 2 steps of the
  chairs stage, finite weights, and under 'shared' one module for both
  sites.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu_torch import evaluate as teval
from craft_tpu_torch import train as ttrain
from craft_tpu_torch.utils.weights import state_dict_from_flax

import chip_smoke
from test_torch_train_cli import _cli_args
from test_torch_two_way import (HW, _one_thread, configs,  # noqa: F401
                                two_way_tree)

ITERS = 3


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_way")
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (*HW, 3)).astype(np.uint8)
              for _ in range(2)]
    gt = (rng.randn(*HW, 2) * 2).astype(np.float32)
    chip_smoke.write_sintel_tree(root, frames, [gt])
    return root, frames, gt


@pytest.mark.parametrize("f1", ["shared", "private"])
def test_evaluator_cli_runs_two_way(sintel, tmp_path, f1):
    root, frames, gt = sintel
    tree = two_way_tree(f1)
    pth = tmp_path / f"{f1}.pth"
    torch.save({"model": {"module." + k: v for k, v in
                          state_dict_from_flax(tree).items()}}, pth)
    argv = ["--model", str(pth), "--craft", "--setrans", "--f1", f1,
            "--dataset", "sintel", "--fullprec", "--iters", str(ITERS),
            "--data_root", str(root), "--device", "cpu"]
    got = teval.main(argv)
    jcfg, _ = configs(f1, False)
    img1, img2 = (jnp.asarray(f[None].astype(np.float32)) for f in frames)
    _, flows = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, tree), img1, img2, iters=ITERS)
    epe = float(np.sqrt(((np.asarray(flows[-1][0]) - gt) ** 2).sum(-1))
                .mean())
    print(f1, got, epe)
    assert abs(got["sintel_clean_epe"] - epe) <= 1e-4
    teval.main(argv[:6] + ["--device", "cpu", "--model_name", "conv",
                           "--convert", str(tmp_path / "out")])
    sd = torch.load(tmp_path / "out" / "conv.pth", weights_only=True)
    sd = sd.get("model", sd)
    assert any(k.startswith("f1_trans.") for k in sd)
    assert any(k.startswith("f2_trans.") for k in sd)


@pytest.fixture(scope="module")
def chairs_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("chairs")
    chip_smoke.write_chairs(root, 6, 2, (80, 96))
    return root


@pytest.mark.parametrize("f1", ["shared", "private"])
def test_train_cli_runs_two_way(chairs_tree, tmp_path, f1):
    state = ttrain.main(_cli_args(chairs_tree, tmp_path / f1, "--num_steps",
                                  "2", "--f1", f1))
    model = state.model
    assert state.step == 2 and model.cfg.f1trans == f1
    assert (model.f1_trans is model.f2_trans) == (f1 == "shared")
    for p in model.parameters():
        assert torch.isfinite(p).all()
