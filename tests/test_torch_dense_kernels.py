"""The plain versions of the dense-table kernels, B8
(flash_mode_attention_dense), B6 dense (fused_agg_corr_dense) and B4 dense
(mode_softmax_probs_dense), against the JAX package's Pallas functions
themselves in interpret mode (flash_mode_attention, fused_agg_corr,
mode_softmax_probs) at tiny ragged shapes: no table and a seeded table,
U1 != U2, the clamp off and on.  Then the wrappers' input checks, and the
-1e9 mask rows of B8 with nearly every key masked.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops.pallas.mode_attention import (flash_mode_attention,
                                                 fused_agg_corr,
                                                 mode_softmax_probs)
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma

# (U1, U2): a ragged square and a rectangle; neither fills a tile.
SHAPES = [(21, 21), (13, 29)]
CLIPS = [1e30, 0.5]
# Pallas interpret and the plain version: fp32 sums of md products in
# another order, and the Pallas kernel's online softmax against a
# materialised one.
TOL = 1e-5


def _inputs(rng, u1, u2, md=8, B=2, with_table=True):
    q = (rng.randn(B, 4, u1, md) * 0.9).astype(np.float32)
    k = (rng.randn(B, 4, u2, md) * 0.9).astype(np.float32)
    table = (rng.randn(u1, u2) * 0.7).astype(np.float32) if with_table \
        else None
    return q, k, table


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_b8_matches_pallas(rng, shape, with_table, clip):
    q, k, table = _inputs(rng, *shape, with_table=with_table)
    v = rng.randn(2, 4, shape[1], 16).astype(np.float32)
    want = flash_mode_attention(_j(q), _j(k), _j(v), _j(table), clip, 0.5,
                                tq=16, tk=16, interpret=True)
    got = ma.flash_mode_attention_dense(_t(q), _t(k), _t(v), _t(table),
                                        torch.tensor(clip), 0.5)
    assert got.shape == (2, 4, shape[0], 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_b6_dense_matches_pallas(rng, shape, with_table, clip):
    q, k, table = _inputs(rng, *shape, with_table=with_table)
    want = fused_agg_corr(_j(q), _j(k), _j(table), clip, 0.5, 1.2, 0.1,
                          tq=16, tk=16, interpret=True)
    got = cv.fused_agg_corr_dense(_t(q), _t(k), _t(table), clip, 0.5,
                                  torch.tensor(1.2), torch.tensor(0.1))
    assert got.shape == (2, *shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_b4_dense_matches_pallas(rng, shape, with_table, clip):
    q, k, table = _inputs(rng, *shape, with_table=with_table)
    want = mode_softmax_probs(_j(q), _j(k), _j(table), clip, 1.0, tq=16,
                              tk=16, out_dtype=jnp.float32, interpret=True)
    got = ma.mode_softmax_probs_dense(_t(q), _t(k), _t(table),
                                      torch.tensor(clip), 1.0,
                                      out_dtype=torch.float32)
    assert got.shape == (2, 4, *shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_plain_versions_are_the_xla_formulas(rng):
    """The three plain versions written out once more as the JAX package's
    XLA path computes them (setrans.py:657-686, 756)."""
    q, k, table = _inputs(rng, 13, 29)
    v = rng.randn(2, 4, 29, 16).astype(np.float32)
    s = np.einsum("bmid,bmjd->bmij", q, k) / math.sqrt(q.shape[-1])
    s = np.clip(s, -0.5, 0.5) + 0.5 * table
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    got = ma.flash_mode_attention_dense(_t(q), _t(k), _t(v), _t(table), 0.5,
                                        0.5).numpy()
    np.testing.assert_allclose(got, p @ v, atol=TOL)
    got = ma.mode_softmax_probs_dense(_t(q), _t(k), _t(table), 0.5, 0.5,
                                      out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, p, atol=TOL)
    lg = 1.2 * s + 0.1
    w = np.exp(lg - lg.max(1, keepdims=True))
    want = (w * s).sum(1) / w.sum(1)
    got = cv.fused_agg_corr_dense(_t(q), _t(k), _t(table), 0.5, 0.5, 1.2,
                                  0.1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_b8_rows_with_nearly_every_key_masked(rng):
    """An f2 mask of radius 0: every row keeps only its own key, so the
    output is v itself; -1e9 gives exp(.) = 0, not NaN."""
    from craft_tpu_torch.nn.setrans import attention_mask
    q, k, _ = _inputs(rng, 21, 21)
    v = rng.randn(2, 4, 21, 16).astype(np.float32)
    table = attention_mask(3, 7, 0)
    got = ma.flash_mode_attention_dense(_t(q), _t(k), _t(v), table,
                                        torch.tensor(1e30), 1.0)
    np.testing.assert_allclose(got.numpy(), v, atol=1e-6)


def test_dense_wrappers_check_the_table(rng):
    q, k, table = _inputs(rng, 13, 29)
    qt, kt = _t(q), _t(k)
    for bad in (torch.zeros(29, 13), torch.zeros(13, 29, dtype=torch.float64)):
        with pytest.raises(ValueError, match="dense bias table"):
            ma.mode_softmax_probs_dense(qt, kt, bad, 1e30, 1.0)
        with pytest.raises(ValueError, match="dense bias table"):
            cv.fused_agg_corr_dense(qt, kt, bad, 1e30, 1.0, 1.0, 0.0)
