"""The port's plain B3 and B4 against the JAX Pallas kernels themselves
(interpret mode on the CPU), at one tiny shape each, so the plain versions
are tied to the TPU kernels and not only to the XLA path.  Slow: run with
``-m slow``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops.pallas.mode_attention import (fused_agg_corr_norm_mt,
                                                 mode_softmax_probs_mt)
from craft_tpu_torch.ops.kernels import mode_attention as ma

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
