"""The port's evaluator CLI under the flags that take the dense-table
kernels: ``--interpos lsinu --intrapos lsinu`` (learned sinusoid codes at
all three sites) and ``--f2radius 3`` (the masked f2 attention), each over
a saved reference-format .pth with Sintel (one scene, 2 pairs), KITTI and
FlyingChairs synthetic trees at 64x128 (KITTI 60x124), and the single-pair
demo, fp32, against the JAX package's validators and demo with the same
variables: every metric within 1e-3 px, or 1e-3 of a share (KITTI's F1 is
a percentage); the demo's flow within 1e-3 px.

Variables: the JAX init (at 16x16: no parameter depends on the frame size)
with a seeded bias window and seeded pos_fc weights.  Each JAX validator
builds its own Evaluator; the fixture hands every validator (and the demo)
of a configuration one Evaluator, so each configuration compiles once.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.eval import demo as jdemo
from craft_tpu.eval import evaluate as jev
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu_torch import evaluate as tcli
from craft_tpu_torch.utils.weights import state_dict_from_flax

import test_torch_data as td
from test_torch_posenc import _with_codes

H, W, ITERS = 64, 128, 4

FLAGS = {"lsinu": ["--interpos", "lsinu", "--intrapos", "lsinu"],
         "f2radius 3": ["--f2radius", "3"]}


def _jax_config(variant):
    cfg = jconfig.craft_config(mixed_precision=False)
    if variant == "lsinu":
        return cfg.replace(**{site: dataclasses.replace(
            getattr(cfg, site), pos_code_type="lsinu")
            for site in ("inter", "f2", "intra")})
    return cfg.replace(f2=dataclasses.replace(cfg.f2, attn_mask_radius=3))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(data root holding the Sintel, KITTI and FlyingChairs trees,
    {variant: (JAX config, JAX variables, path of the saved .pth)})."""
    base = tmp_path_factory.mktemp("eval_dense")
    root = str(base / "data")
    rng = np.random.RandomState(0)
    td.write_sintel(os.path.join(root, "Sintel"), rng, scenes=("alley_1",),
                    H=H, W=W)
    td.write_kitti(os.path.join(root, "KITTI"), rng, H=H - 4, W=W - 4)
    td.write_chairs(os.path.join(root, "FlyingChairs_release"), rng, H=H,
                    W=W)
    models = {}
    for i, variant in enumerate(FLAGS):
        cfg = _jax_config(variant)
        zeros = jnp.zeros((1, 16, 16, 3))
        init = JaxFlowModel(cfg=cfg, train=False).init
        variables = jax.jit(lambda key: init(key, zeros, zeros, iters=1))(
            jax.random.PRNGKey(0))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        variables = {"params": _with_codes(variables["params"],
                                           np.random.RandomState(i)),
                     "batch_stats": variables["batch_stats"]}
        pth = str(base / f"{variant.replace(' ', '_')}.pth")
        sd = state_dict_from_flax(variables)
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, pth)
        models[variant] = (cfg, variables, pth)
    evaluators, make = {}, jev.Evaluator

    def shared(cfg, variables, iters=12, test_mode=1, seq_parallel=None):
        key = (cfg, iters, test_mode)
        if key not in evaluators:
            evaluators[key] = make(cfg, variables, iters, test_mode,
                                   seq_parallel)
        return evaluators[key]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "Evaluator", shared)
        yield root, models


@pytest.mark.parametrize("dataset", ["sintel", "kitti", "chairs"])
@pytest.mark.parametrize("variant", sorted(FLAGS))
def test_cli_matches_the_jax_validator(setup, variant, dataset):
    root, models = setup
    cfg, variables, pth = models[variant]
    got = tcli.main(["--model", pth, "--craft", "--setrans", "--fullprec",
                     "--iters", str(ITERS), "--device", "cpu", "--dataset",
                     dataset, "--data_root", root] + FLAGS[variant])
    validate = {"sintel": jev.validate_sintel, "kitti": jev.validate_kitti,
                "chairs": jev.validate_chairs}[dataset]
    want = validate(cfg, variables, iters=ITERS, data_root=root)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = 100.0 if key.endswith("_f1") else 1.0  # F1 in percent
        assert abs(got[key] - w) / scale <= 1e-3, (key, got[key], w)


@pytest.mark.parametrize("variant", sorted(FLAGS))
def test_demo_matches_the_jax_demo(setup, variant, tmp_path):
    root, models = setup
    cfg, variables, pth = models[variant]
    scene = os.path.join(root, "Sintel", "training", "clean", "alley_1")
    pair = [os.path.join(scene, f"frame_000{i}.png") for i in (1, 2)]
    got = tcli.main(["--model", pth, "--craft", "--setrans", "--fullprec",
                     "--iters", str(ITERS), "--device", "cpu", "--img1",
                     pair[0], "--img2", pair[1], "--output_path",
                     str(tmp_path / "port")] + FLAGS[variant])
    want = jdemo.gen_flow(cfg, variables, *pair,
                          output_path=str(tmp_path / "jax"), iters=ITERS)
    assert got.shape == want.shape == (H, W, 2)
    assert float(np.abs(got - np.asarray(want)).max()) < 1e-3
