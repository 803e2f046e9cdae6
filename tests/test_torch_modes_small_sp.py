"""Sequence parallelism at mode dims below 16 on the CPU: two and three
ranks spawned as processes (tests/test_torch_sp.py's runner: gloo over a
FileStore), each running the port's FlowModel of the modes32 configuration
(md 8 at every site: B9 at 32 modes, B1, B2 and B4 on the rank's rows)
with its SeqParallel group, against the JAX package's
Evaluator(seq_parallel=True) on its 8 virtual devices: fp32 at 64x128
(rows 4/4 and 3/3/2 of the 8 x 16 grid), 3 iterations, the tree of
tests/test_torch_modes.py with its sliding windows made random, within
1e-3 px (test_torch_sp.py's bound), every rank's flow bit for bit equal.
A spawned rank imports this module, so it imports no JAX at module level.
"""

import numpy as np
import pytest

from test_torch_modes_sp import _sp_flow
from test_torch_sp import H, ITERS, W, _randomize_windows, run_ranks

NAME = "modes32"


@pytest.fixture(scope="module")
def jax_sp():
    """(the configuration's flags, the port's state_dict as numpy, the two
    frames, the JAX SP evaluator's flow)."""
    import chip_smoke
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
    return (chip_smoke.mode_flags(NAME), sd, img1, img2,
            np.asarray(jflows[-1]))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_match_the_jax_sp_evaluator_below_md16(tmp_path, jax_sp,
                                                      world):
    flags, sd, img1, img2, want = jax_sp
    out = run_ranks(tmp_path, world, _sp_flow, flags, sd, img1, img2)
    for rank, flow in enumerate(out):
        err = float(np.abs(flow - want).max())
        print(f"world {world} rank {rank}: max |flow diff| {err:.3e} px")
        assert err < 1e-3, (world, rank, err)
    for flow in out[1:]:
        np.testing.assert_array_equal(out[0], flow)
