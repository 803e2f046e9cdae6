"""Port correlation pyramid and windowed lookup against the JAX package's,
including out-of-range coordinates and odd grids (7x12: pooling drops the
odd last row).  fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops import corr as jc
from craft_tpu_torch.ops import corr as tc

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_global_layer_norm(rng):
    vol = rng.randn(2, 1, 7 * 12 * 7 * 12).astype(np.float32) * 3 + 1
    got = tc.global_layer_norm(_t(vol)).numpy()
    want = np.asarray(jc.global_layer_norm(jnp.asarray(vol)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(6, 8), (7, 12), (9, 13)])
def test_build_pyramid_with_global_norm(rng, hw):
    h, w = hw
    corr = rng.randn(2, h * w, 1, h * w).astype(np.float32)
    got = tc.build_pyramid(_t(corr), 2, h, w, do_global_norm=True)
    want = jc.build_pyramid(jnp.asarray(corr), 2, h, w,
                            do_global_norm=True)
    assert len(got.levels) == len(want.levels) == 4
    for g, wl in zip(got.levels, want.levels):
        assert tuple(g.shape) == wl.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), atol=ATOL)


@pytest.mark.parametrize("hw", [(7, 12), (55, 16)])
def test_pyramid_from_level0_drops_odd_rows(rng, hw):
    h, w = hw
    vol = rng.randn(2, h * w, h * w).astype(np.float32)
    got = tc.pyramid_from_level0(_t(vol), 2, h, w, level_dtype=torch.float32)
    want = jc.pyramid_from_level0(jnp.asarray(vol), 2, h, w,
                                  level_dtype=jnp.float32)
    heights = [h]
    for _ in range(3):
        heights.append(heights[-1] // 2)
    assert [lv.shape[1] for lv in got.levels] == heights
    for g, wl in zip(got.levels, want.levels):
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), atol=ATOL)


@pytest.mark.parametrize("hw", [(7, 12), (8, 8)])
def test_corr_lookup_matches_jax_lookups(rng, hw):
    h, w = hw
    B = 2
    vol = rng.randn(B, h * w, h * w).astype(np.float32)
    # Coordinates inside, on the edge and far outside every level.
    coords = rng.uniform(-6.0, max(h, w) + 6.0, (B, h, w, 2)).astype(
        np.float32)
    coords[0, 0, 0] = [0.0, 0.0]
    coords[0, 0, 1] = [w - 1.0, h - 1.0]
    coords[1, 1, 1] = [-40.0, 70.0]
    tpyr = tc.pyramid_from_level0(_t(vol), B, h, w,
                                  level_dtype=torch.float32)
    jpyr = jc.pyramid_from_level0(jnp.asarray(vol), B, h, w,
                                  level_dtype=jnp.float32)
    got = tc.corr_lookup(tpyr, _t(coords)).numpy()
    assert got.shape == (B, h, w, 4 * 81)
    # The JAX gather lookup cannot index a level pooled to zero rows (7x12
    # reaches 0 rows at level 3); its MXU lookup, the JAX default, can.
    lookups = (jc.corr_lookup_mxu,) if h % 8 else (jc.corr_lookup_mxu,
                                                   jc.corr_lookup_gather)
    for lookup in lookups:
        want = np.asarray(lookup(jpyr, jnp.asarray(coords)))
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_corr_lookup_channel_order():
    """Channel (level, i, j): i offsets x, j offsets y (corr.py:274-277)."""
    h, w = 8, 8
    # Level 0 of query 0 holds x + 100 * y, so a tap reads its own position.
    vol = np.zeros((1, h * w, h, w), np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    vol[0, 0] = xs + 100.0 * ys
    pyr = tc.pyramid_from_level0(_t(vol.reshape(1, h * w, h * w)), 1, h, w,
                                 level_dtype=torch.float32)
    coords = np.zeros((1, h, w, 2), np.float32)
    coords[0, 0, 0] = [4.0, 4.0]
    win = tc.corr_lookup(pyr, _t(coords))[0, 0, 0, :81].reshape(9, 9)
    # Tap (i, j) sits at x = 4 + i - 4, y = 4 + j - 4 (inside for i, j < 8).
    assert float(win[5, 2]) == 5.0 + 100.0 * 2.0
    assert float(win[0, 0]) == 0.0 + 100.0 * 0.0
    assert float(win[2, 7]) == 2.0 + 100.0 * 7.0
    assert float(win[8, 0]) == 0.0  # x = 8 is outside: zero padding
