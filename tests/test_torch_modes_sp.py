"""Sequence parallelism at 8 modes on the CPU: two ranks spawned as
processes (tests/test_torch_sp.py's runner: gloo over a FileStore), each
running the port's FlowModel of the modes8 configuration (8 modes at every
site: B9 at eight modes, B1, B2 and B4 on the rank's rows at md 32 and 16)
with its SeqParallel group, against the JAX package's
Evaluator(seq_parallel=True) on its 8 virtual devices: fp32 at 64x128, 3
iterations, the tree of tests/test_torch_modes.py with its sliding windows
made random, within 1e-3 px (test_torch_sp.py's bound), and the two ranks'
flows bit for bit equal.  A spawned rank imports this module, so it
imports no JAX at module level.
"""

import numpy as np
import torch

from craft_tpu_torch import cli as tcli
from craft_tpu_torch.models.flow_model import FlowModel
from test_torch_sp import H, ITERS, W, _randomize_windows, run_ranks

NAME = "modes8"


def _flags():
    import chip_smoke
    return chip_smoke.mode_flags(NAME)


def _sp_flow(group, flags, sd, img1, img2):
    import argparse
    p = argparse.ArgumentParser()
    tcli.add_model_args(p)
    model = FlowModel(tcli.model_config_from_args(p.parse_args(flags)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.inference_mode():
        _, flows = model.eval()(torch.from_numpy(img1),
                                torch.from_numpy(img2), iters=ITERS,
                                seq_parallel=group)
    return flows[-1].float().numpy()


def test_world2_matches_the_jax_sp_evaluator(tmp_path):
    from craft_tpu.eval.evaluate import Evaluator as JaxEvaluator
    from craft_tpu_torch.utils.weights import state_dict_from_flax
    from test_torch_modes import configs, modes_tree

    rng = np.random.RandomState(0)
    tree = _randomize_windows(modes_tree(NAME), rng)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(tree).items()}
    img1, img2 = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
                  for _ in range(2))
    jcfg, _ = configs(NAME, False)
    _, jflows = JaxEvaluator(jcfg, tree, iters=ITERS,
                             seq_parallel=True)(img1, img2)
    want = np.asarray(jflows[-1])
    out = run_ranks(tmp_path, 2, _sp_flow, _flags(), sd, img1, img2)
    for rank, flow in enumerate(out):
        err = float(np.abs(flow - want).max())
        print(f"rank {rank}: max |flow diff| {err:.3e} px")
        assert err < 1e-3, (rank, err)
    np.testing.assert_array_equal(out[0], out[1])
