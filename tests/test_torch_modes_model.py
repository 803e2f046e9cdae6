"""Whole models at mode counts other than 4, port against the JAX package
on the CPU at 64x64, 3 iterations: modes1 (one mode at every site: no mode
aggregation at the inter site, the JAX raw-volume route that the port
serves through B3 at one mode), modes8 (eight at every site: the
aggregating kernels' groups of four) and modes_mixed (--intermodes 2
--f2modes 16 --intramodes 1), with the trees of tests/test_torch_modes.py.
Bounds: fp32 flows within 1e-4 px; mixed precision (bf16 compute, bf16
pyramid levels, int8 intra probs) within 0.05 px, where the two frameworks
round at other places in the same bf16 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_modes import _one_thread, configs, modes_tree  # noqa: F401

HW, ITERS = (64, 64), 3
BOUND_PX = {False: 1e-4, True: 0.05}


def _frames(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (1, *HW, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("mixed_precision", [False, True],
                         ids=["fp32", "mixed"])
@pytest.mark.parametrize("name", ["modes1", "modes8", "modes_mixed"])
def test_flow_matches_jax(name, mixed_precision):
    jcfg, tcfg = configs(name, mixed_precision)
    tree = modes_tree(name)
    img1, img2 = _frames()
    _, jflows = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(img1),
        jnp.asarray(img2), iters=ITERS)
    want = np.asarray(jflows[-1], np.float32)
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                         iters=ITERS)
    got = flows[-1].float().numpy()
    err = float(np.abs(got - want).max())
    print(f"{name} {'mixed' if mixed_precision else 'fp32'}: max |flow "
          f"diff| {err:.3e} px (max |flow| {float(np.abs(want).max()):.3f})")
    assert np.isfinite(got).all() and err < BOUND_PX[mixed_precision]
