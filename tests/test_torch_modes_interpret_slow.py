"""The port's plain kernels at mode counts other than 4 against the JAX
Pallas kernels themselves (interpret mode on the CPU), at tiny grids with
the new (M, md) pairs: B1, B2, B3, B4 (int8), B6 forward and backward, B7
and B9 (sums and write), as tests/test_torch_interpret_slow.py holds them
at four modes, with its bounds.  Slow: run with ``-m slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.nn.setrans import sliding_pos_biases as jax_sliding_pos_biases
from craft_tpu.ops.pallas.corr_vjp import _pallas_agg_corr_bwd
from craft_tpu.ops.pallas.mode_attention import (corr_norm_sums_mt,
                                                 flash_mode_attention_mt,
                                                 fused_agg_corr_mt,
                                                 fused_agg_corr_norm_mt,
                                                 mode_softmax_probs_mt,
                                                 scores_global_max)
from craft_tpu.ops.pallas.probs_vjp import _pallas_probs_bwd
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv

pytestmark = pytest.mark.slow

PALLAS_TOL = 2e-3  # tests/test_torch_interpret_slow.py's
# (modes, mode dim) of the 256-wide sites' new counts, and the intra site's.
WIDE = [(1, 256), (2, 128), (8, 32), (16, 16)]
INTRA = [(1, 128), (8, 16)]


def _inputs(rng, M, md, U, B=1):
    q = (rng.randn(B, M, U, md) * 0.8 / np.sqrt(md / 8)).astype(np.float32)
    k = (rng.randn(B, M, U, md) * 0.8).astype(np.float32)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    return q, k, biases


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("M,md", WIDE + INTRA)
def test_plain_b1_b2_b4_match_pallas(rng, M, md):
    H8, W8 = 2, 8
    U = H8 * W8
    q, k, biases = _inputs(rng, M, md, U)
    scale = 1.0 / np.sqrt(md)
    want = scores_global_max(jnp.asarray(q), jnp.asarray(k), scale,
                             interpret=True)
    got = ma.scores_global_max(*_t(q, k), scale)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    v = rng.randn(1, M, U, 128).astype(np.float32)
    want = flash_mode_attention_mt(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(biases),
                                   (H8, W8), 0.5, 1.0, interpret=True)
    got = ma.flash_mode_attention(*_t(q, k, v, biases), (H8, W8),
                                  torch.tensor(0.5), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    want_num, want_scale = mode_softmax_probs_mt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(biases), (H8, W8), 0.5,
        1.0, interpret=True, quantized=True)
    num, sc = ma.mode_softmax_probs(*_t(q, k, biases), (H8, W8),
                                    torch.tensor(0.5), 1.0, quantized=True)
    diff = np.abs(num.numpy().astype(np.int32)
                  - np.asarray(want_num).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_scale),
                               rtol=1e-5)


@pytest.mark.parametrize("M,md", WIDE[1:])
def test_plain_b3_and_b9_match_pallas(rng, M, md):
    # The Pallas kernels tile only W8 % 128 == 0 grids; JAX runs one mode
    # through its XLA path (no fused norm at one mode).
    H8, W8 = 2, 128
    U = H8 * W8
    q, k, biases = _inputs(rng, M, md, U)
    agg = (torch.tensor(1.2), torch.tensor(0.1))
    want, wstats = fused_agg_corr_norm_mt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(biases), (H8, W8), 0.5,
        0.5, 1.2, 0.1, out_dtype=jnp.float32, interpret=True)
    got, stats = ma.fused_agg_corr_norm(*_t(q, k, biases), (H8, W8), 0.5,
                                        0.5, *agg, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(stats.numpy()[..., :3],
                               np.asarray(wstats)[..., :3], rtol=1e-4,
                               atol=1e-5)
    # B9 sums on the second grid row against the shard's Pallas sums.
    gmax = float(wstats[0, 0, 0])
    qs = q[:, :, W8:]
    want = corr_norm_sums_mt(jnp.asarray(qs), jnp.asarray(k),
                             jnp.asarray(biases), (H8, W8), gmax, 0.5, 0.5,
                             1.2, 0.1, q_row0=1, interpret=True)
    got = ma.corr_norm_sums(*_t(qs, k, biases), (H8, W8),
                            torch.tensor(gmax), 0.5, 0.5, *agg, q_row0=1)
    n = float(U) * U
    np.testing.assert_allclose(got.numpy()[:, 0] / n,
                               np.asarray(want)[:, 0, 1], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 1] / n,
                               np.asarray(want)[:, 0, 2], rtol=1e-4)


@pytest.mark.parametrize("M,md", WIDE)
def test_plain_b6_matches_pallas(rng, M, md):
    H8, W8 = 2, 128
    U = H8 * W8
    q, k, biases = _inputs(rng, M, md, U, B=2)
    want = fused_agg_corr_mt(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(biases), (H8, W8), 0.5, 0.5, 1.2,
                             0.1, interpret=True)
    vol = cv.fused_agg_corr(*_t(q, k, biases), (H8, W8), 0.5, 0.5,
                            torch.tensor(1.2), torch.tensor(0.1))
    np.testing.assert_allclose(vol.numpy(), np.asarray(want),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
    H8, W8 = 3, 7
    U = H8 * W8
    q, k, biases = _inputs(rng, M, md, U, B=2)
    t = _t(q, k, biases)
    vol = cv.fused_agg_corr(*t, (H8, W8), 0.5, 0.5, torch.tensor(1.2),
                            torch.tensor(0.1))
    g = rng.randn(2, U, U).astype(np.float32)
    dense = jax_sliding_pos_biases(jnp.asarray(biases), H8, W8)
    want_dc, want_da = _pallas_agg_corr_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(g),
        jnp.asarray(vol.numpy()), dense, 0.5, 0.5, 1.2, True, jnp.float32)
    dc, da = cv.agg_corr_bwd(t[0], t[1], torch.from_numpy(g), vol, t[2],
                             (H8, W8), 0.5, 0.5, torch.tensor(1.2))
    np.testing.assert_allclose(dc.numpy(), np.asarray(want_dc),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
    np.testing.assert_allclose(float(da), float(want_da), rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)


@pytest.mark.parametrize("M,md", WIDE + INTRA)
def test_plain_b7_matches_pallas(rng, M, md):
    H8, W8 = 3, 7
    U = H8 * W8
    q, k, biases = _inputs(rng, M, md, U, B=2)
    t = _t(q, k, biases)
    p = ma.mode_softmax_probs(*t, (H8, W8), torch.tensor(0.5), 1.0,
                              out_dtype=torch.float32)
    g = rng.randn(2, M, U, U).astype(np.float32)
    want_dc, want_dlsum = _pallas_probs_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(p.numpy()),
        jnp.asarray(g), 0.5, jnp.float32, True)
    dc, dlsum = pv.probs_bwd(t[0], t[1], p, torch.from_numpy(g), 0.5)
    np.testing.assert_allclose(dc.numpy(), np.asarray(want_dc),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
    np.testing.assert_allclose(dlsum.numpy(), np.asarray(want_dlsum),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
