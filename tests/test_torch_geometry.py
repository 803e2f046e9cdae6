"""Port geometry functions against the JAX package's, on the same seeded
inputs.  fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops import geometry as jg
from craft_tpu_torch.ops import geometry as tg

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_coords_grid():
    np.testing.assert_array_equal(tg.coords_grid(2, 5, 7).numpy(),
                                  np.asarray(jg.coords_grid(2, 5, 7)))


def test_bilinear_sample_in_and_out_of_range(rng):
    img = rng.randn(2, 7, 12, 3).astype(np.float32)
    # Coordinates from well outside to well inside, including exact integers
    # and the last row/column.
    coords = rng.uniform(-3.0, 14.0, (2, 5, 6, 2)).astype(np.float32)
    coords[0, 0, :3] = [[0.0, 0.0], [11.0, 6.0], [11.5, 6.5]]
    got = tg.bilinear_sample(_t(img), _t(coords)).numpy()
    want = np.asarray(jg.bilinear_sample(jnp.asarray(img),
                                         jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_convex_upsample(rng):
    flow = rng.randn(2, 4, 6, 2).astype(np.float32) * 3
    mask = rng.randn(2, 4, 6, 576).astype(np.float32)
    got = tg.convex_upsample(_t(flow), _t(mask)).numpy()
    want = np.asarray(jg.convex_upsample(jnp.asarray(flow),
                                         jnp.asarray(mask)))
    assert got.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(6, 8), (7, 13)])
def test_avg_pool2x2_drops_odd_edges(rng, hw):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    got = tg.avg_pool2x2(_t(x)).numpy()
    want = np.asarray(jg.avg_pool2x2(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(436, 1024), (375, 1242), (21, 30)])
def test_input_padder(rng, mode, hw):
    x = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    tp = tg.InputPadder(x.shape, mode=mode)
    jp = jg.InputPadder(x.shape, mode=mode)
    (got,) = tp.pad(_t(x))
    (want,) = jp.pad(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    if hw == (375, 1242):  # KITTI: 376x1248, the bottom row padded
        assert got.shape[1:3] == (376, 1248)
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)
