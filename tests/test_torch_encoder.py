"""Port BasicEncoder (instance and batch norm) against the flax module with
bridged weights, on seeded 32x32 images at the real widths.  fp32, atol
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.nn.encoder import BasicEncoder as JaxEncoder
from craft_tpu_torch.nn.encoder import BasicEncoder
from craft_tpu_torch.utils.weights import state_dict_from_flax


def _randomize(tree, rng):
    """Seeded noise on every leaf (the BN init is identity-like and would
    hide a bridging fault); BN scales stay near 0.4 and variances in
    [0.5, 1.5] so the activations stay O(1)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize(v, rng)
            continue
        noise = rng.randn(*np.shape(v)).astype(np.float32) * 0.1
        if k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k == "scale":
            out[k] = 0.4 + noise
        else:
            out[k] = np.asarray(v, np.float32) + noise
    return out


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_flax(rng, norm_fn):
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jmod = JaxEncoder(output_dim=256, norm_fn=norm_fn, train=False)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {col: _randomize(dict(tree), rng)
                 for col, tree in variables.items()}
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))

    model = BasicEncoder(256, norm_fn).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-4)
