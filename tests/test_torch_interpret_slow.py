"""The port's plain B3, B4, B6 (forward and backward) and B7 backward
against the JAX Pallas kernels themselves (interpret mode on the CPU), at
tiny shapes, so the plain versions are tied to the TPU kernels and not only
to the XLA path.  Slow: run with ``-m slow``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.nn.setrans import sliding_pos_biases as jax_sliding_pos_biases
from craft_tpu.ops.pallas.corr_vjp import _pallas_agg_corr_bwd
from craft_tpu.ops.pallas.mode_attention import (fused_agg_corr,
                                                 fused_agg_corr_mt,
                                                 fused_agg_corr_norm_mt,
                                                 mode_softmax_probs_mt)
from craft_tpu.ops.pallas.probs_vjp import _pallas_probs_bwd
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv

pytestmark = pytest.mark.slow


def test_plain_b3_matches_pallas_fused_agg_corr_norm(rng):
    # The Pallas kernel tiles only W8 % 128 == 0 grids.
    H8, W8, md = 2, 128, 8
    U = H8 * W8
    q = (rng.randn(1, 4, U, md) * 0.8).astype(np.float32)
    k = (rng.randn(1, 4, U, md) * 0.8).astype(np.float32)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    for attn_clip in (100.0, 0.5):
        want, wstats = fused_agg_corr_norm_mt(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(biases), (H8, W8),
            attn_clip, 0.5, 1.2, 0.1, out_dtype=jnp.float32, interpret=True)
        got, stats = ma.fused_agg_corr_norm(
            *(torch.from_numpy(a) for a in (q, k, biases)), (H8, W8),
            attn_clip, 0.5, torch.tensor(1.2), torch.tensor(0.1),
            out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(stats.numpy()[..., :3],
                                   np.asarray(wstats)[..., :3], rtol=1e-4,
                                   atol=1e-5)


def test_plain_b4_matches_pallas_quantized_probs(rng):
    H8, W8, md = 2, 8, 8
    U = H8 * W8
    q = (rng.randn(1, 4, U, md) * 0.8).astype(np.float32)
    k = (rng.randn(1, 4, U, md) * 0.8).astype(np.float32)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    want_num, want_scale = mode_softmax_probs_mt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(biases), (H8, W8), 0.5,
        1.0, interpret=True, quantized=True)
    num, scale = ma.mode_softmax_probs(
        *(torch.from_numpy(a) for a in (q, k, biases)), (H8, W8),
        torch.tensor(0.5), 1.0, quantized=True)
    diff = np.abs(num.numpy().astype(np.int32)
                  - np.asarray(want_num).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(scale.numpy(), np.asarray(want_scale),
                               rtol=1e-5)


# ---------------------------------------------- the training kernels (B6, B7)

def _b6_inputs(rng, H8, W8, md=8, B=2):
    U = H8 * W8
    q = (rng.randn(B, 4, U, md) * 0.8).astype(np.float32)
    k = (rng.randn(B, 4, U, md) * 0.8).astype(np.float32)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    return q, k, biases


# The JAX package's own bound for its Pallas backward against XLA
# (tests/test_corr_vjp.py:62-63).
PALLAS_TOL = 2e-3


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_plain_b6_forward_matches_pallas_sliding_window(rng, clip):
    H8, W8 = 2, 128  # the window kernel tiles W8 % 128 == 0 grids
    q, k, biases = _b6_inputs(rng, H8, W8)
    want = fused_agg_corr_mt(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(biases), (H8, W8), clip, 0.5, 1.2,
                             0.1, interpret=True)
    got = cv.fused_agg_corr(*(torch.from_numpy(a) for a in (q, k, biases)),
                            (H8, W8), clip, 0.5, torch.tensor(1.2),
                            torch.tensor(0.1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_plain_b6_forward_matches_pallas_dense_window(rng, clip):
    H8, W8 = 3, 7
    q, k, biases = _b6_inputs(rng, H8, W8)
    dense = jax_sliding_pos_biases(jnp.asarray(biases), H8, W8)
    want = fused_agg_corr(jnp.asarray(q), jnp.asarray(k), dense, clip, 0.5,
                          1.2, 0.1, interpret=True)
    got = cv.fused_agg_corr(*(torch.from_numpy(a) for a in (q, k, biases)),
                            (H8, W8), clip, 0.5, torch.tensor(1.2),
                            torch.tensor(0.1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_plain_b6_backward_matches_pallas(rng, clip):
    H8, W8 = 3, 7
    U = H8 * W8
    q, k, biases = _b6_inputs(rng, H8, W8)
    g = rng.randn(2, U, U).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, biases)]
    vol = cv.fused_agg_corr(*t, (H8, W8), clip, 0.5, torch.tensor(1.2),
                            torch.tensor(0.1))
    dense = jax_sliding_pos_biases(jnp.asarray(biases), H8, W8)
    want_dc, want_da = _pallas_agg_corr_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(g),
        jnp.asarray(vol.numpy()), dense, clip, 0.5, 1.2, True, jnp.float32)
    dc, da = cv.agg_corr_bwd(t[0], t[1], torch.from_numpy(g), vol, t[2],
                             (H8, W8), clip, 0.5, torch.tensor(1.2))
    np.testing.assert_allclose(dc.numpy(), np.asarray(want_dc),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
    np.testing.assert_allclose(float(da), float(want_da), rtol=PALLAS_TOL)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_plain_b7_backward_matches_pallas(rng, clip):
    H8, W8 = 3, 7
    U = H8 * W8
    q, k, biases = _b6_inputs(rng, H8, W8)
    t = [torch.from_numpy(a) for a in (q, k, biases)]
    p = ma.mode_softmax_probs(*t, (H8, W8), torch.tensor(clip), 1.0,
                              out_dtype=torch.float32)
    g = rng.randn(2, 4, U, U).astype(np.float32)
    want_dc, want_dlsum = _pallas_probs_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(p.numpy()),
        jnp.asarray(g), clip, jnp.float32, True)
    dc, dlsum = pv.probs_bwd(t[0], t[1], p, torch.from_numpy(g), clip)
    np.testing.assert_allclose(dc.numpy(), np.asarray(want_dc),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
    np.testing.assert_allclose(dlsum.numpy(), np.asarray(want_dlsum),
                               atol=PALLAS_TOL, rtol=PALLAS_TOL)
