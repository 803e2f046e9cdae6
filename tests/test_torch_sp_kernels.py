"""The sequence-parallel kernels' plain versions on the CPU: B9
(corr_norm_sums, corr_norm_write) and B1, B2 and B4 on a row shard of the
queries (U1 < U2, a grid-row offset q_row0 != 0) against the JAX package's
Pallas functions themselves in interpret mode (corr_norm_sums_mt,
corr_norm_write_mt, scores_global_max, flash_mode_attention_mt,
mode_softmax_probs_mt with q_row0); then B9's shards, even and uneven,
assembled against plain B3 on the whole grid; then the wrappers' row
checks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops.pallas.mode_attention import (corr_norm_sums_mt,
                                                 corr_norm_write_mt,
                                                 flash_mode_attention_mt,
                                                 mode_softmax_probs_mt,
                                                 scores_global_max)
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.parallel.sp import row_split

# Pallas interpret and the plain version: fp32 sums of md products in
# another order, an online softmax against a materialised one.
TOL = 1e-5
AGG = (0.7, -0.2)  # the inter site's (agg_w, agg_b)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qk(rng, B, u1, u2, md, std=1.0):
    return ((rng.randn(B, 4, u1, md) * std).astype(np.float32),
            (rng.randn(B, 4, u2, md) * std).astype(np.float32))


# ------------------------------------------------ B9 against Pallas interpret

B9_GRID, B9_ROWS, B9_ROW0 = (8, 128), 4, 4  # a 4-row shard: a 4-step grid


@pytest.mark.parametrize("attn_clip", [100.0, 1.0])
def test_plain_b9_matches_pallas_on_a_shard(rng, attn_clip):
    H8, W8 = B9_GRID
    U, md = H8 * W8, 8
    q, k = _qk(rng, 1, U, U, md)
    biases = rng.randn(5, 5).astype(np.float32)
    gmax = float(np.einsum("bmid,bmjd->bmij", q, k).max() / math.sqrt(md))
    assert gmax > 1.0  # attn_clip 1.0 clamps
    scal = (attn_clip, 0.5, *AGG)
    N = float(U) * U
    jsums, tsums = [], []
    for h0 in range(0, H8, B9_ROWS):  # both shards: their sums make N's
        ql = q[:, :, h0 * W8:(h0 + B9_ROWS) * W8]
        jsums.append(np.asarray(corr_norm_sums_mt(
            jnp.asarray(ql), jnp.asarray(k), jnp.asarray(biases), B9_GRID,
            gmax, *scal, q_row0=h0, interpret=True)))
        tsums.append(ma.corr_norm_sums(_t(ql), _t(k), _t(biases), B9_GRID,
                                       torch.tensor(gmax), *scal, q_row0=h0))
        got, want = tsums[-1].numpy() / N, jsums[-1][:, 0, 1:3]
        assert tsums[-1].dtype == torch.float64 and got.shape == (1, 2)
        assert jsums[-1][0, 0, 0] == np.float32(gmax)
        # mean against the rms, E[x^2] against itself
        scale = np.array([math.sqrt(want[0, 1]), want[0, 1]])
        np.testing.assert_array_less(np.abs(got - want) / scale, 1e-5)
    jstats = np.concatenate(
        [[gmax], sum(s[0, 0, 1:3] for s in jsums), [0.0]]).astype(np.float32)
    # The write with the same moments on both sides: the JAX stats.
    sums = torch.tensor(jstats[1:3], dtype=torch.float64)[None] * N
    ql = q[:, :, B9_ROW0 * W8:(B9_ROW0 + B9_ROWS) * W8]
    want = np.asarray(corr_norm_write_mt(
        jnp.asarray(ql), jnp.asarray(k), jnp.asarray(biases), B9_GRID,
        jnp.asarray(jstats).reshape(1, 1, 4), *scal, q_row0=B9_ROW0,
        out_dtype=jnp.float32, interpret=True))
    got = ma.corr_norm_write(_t(ql), _t(k), _t(biases), B9_GRID,
                             torch.tensor(gmax), sums, *scal, q_row0=B9_ROW0,
                             out_dtype=torch.float32)
    assert got.shape == (1, B9_ROWS * W8, U)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# -------------------------------------- B1, B2 and B4 on a shard, Pallas

GRID, ROW0, ROWS = (8, 16), 3, 4  # query rows 3..6 of 8


def _shard_inputs(rng, md=8, B=2, grid=GRID):
    H8, W8 = grid
    q, k = _qk(rng, B, ROWS * W8, H8 * W8, md, std=1.2)
    return q, k, rng.randn(5, 5).astype(np.float32)


def test_plain_b1_on_a_shard_matches_pallas(rng):
    q, k, _ = _shard_inputs(rng)
    want = float(scores_global_max(jnp.asarray(q), jnp.asarray(k), 0.35,
                                   tq=64, tk=64, interpret=True))
    got = float(ma.scores_global_max(_t(q), _t(k), 0.35))
    assert got > 0 and abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("clip", [1e30, 0.8])
def test_plain_b2_with_a_row_offset_matches_pallas(rng, clip):
    # W8 = 64: the Pallas kernel assembles its bias tiles from fewer W8
    # blocks, which interpret mode runs one by one.
    grid = (GRID[0], 64)
    q, k, biases = _shard_inputs(rng, B=1, grid=grid)
    v = rng.randn(*k.shape[:3], 16).astype(np.float32)
    want = flash_mode_attention_mt(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(biases),
        grid, clip, 0.5, interpret=True, q_row0=ROW0)
    got = ma.flash_mode_attention(_t(q), _t(k), _t(v), _t(biases), grid,
                                  torch.tensor(clip), 0.5, q_row0=ROW0)
    assert got.shape == (1, 4, ROWS * grid[1], 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # Rows 0..3 are not rows 3..6: the offset moves the output.
    at0 = ma.flash_mode_attention(_t(q), _t(k), _t(v), _t(biases), grid,
                                  torch.tensor(clip), 0.5)
    assert float((at0 - got).abs().max()) > 100 * TOL


@pytest.mark.parametrize("clip", [1e30, 0.8])
def test_plain_b4_with_a_row_offset_matches_pallas(rng, clip):
    q, k, biases = _shard_inputs(rng, md=4)
    args = (GRID, clip, 1.0)
    jq, jk, jb = jnp.asarray(q), jnp.asarray(k), jnp.asarray(biases)
    tq, tk, tb = _t(q), _t(k), _t(biases)
    want = mode_softmax_probs_mt(jq, jk, jb, *args, out_dtype=jnp.float32,
                                 interpret=True, q_row0=ROW0)
    got = ma.mode_softmax_probs(tq, tk, tb, GRID, torch.tensor(clip), 1.0,
                                out_dtype=torch.float32, q_row0=ROW0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    wnum, wscale = mode_softmax_probs_mt(jq, jk, jb, *args, interpret=True,
                                         quantized=True, q_row0=ROW0)
    num, scale = ma.mode_softmax_probs(tq, tk, tb, GRID, torch.tensor(clip),
                                       1.0, quantized=True, q_row0=ROW0)
    assert num.shape == (2, 4, ROWS * GRID[1], GRID[0] * GRID[1])
    # int8 numerators: rint of the same exp, one step apart at most where
    # the fp32 exps straddle a half.
    assert int(np.abs(num.numpy().astype(int)
                      - np.asarray(wnum).astype(int)).max()) <= 1
    np.testing.assert_allclose(scale.numpy(), np.asarray(wscale), rtol=TOL)


# ------------------------------------------- B9's shards against plain B3

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attn_clip", [100.0, 1.0])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_b9_shards_assemble_to_b3(rng, world, attn_clip, dtype):
    """H8 = 7 rows over 1, 2 (4/3) and 3 (3/2/2) shards: the local B1
    maxima and the shards' sums combine as the collectives do, and the
    written rows stacked are B3's volume."""
    H8, W8, md = 7, 6, 8
    grid = (H8, W8)
    q, k = (_t(x).to(dtype) for x in _qk(rng, 2, H8 * W8, H8 * W8, md, 1.2))
    biases = _t(rng.randn(5, 5).astype(np.float32))
    want, _ = ma.fused_agg_corr_norm_plain(q, k, biases, grid, attn_clip,
                                           0.5, *AGG, out_dtype=dtype)
    shards = [row_split(H8, world, r) for r in range(world)]
    ql = [q[:, :, h0 * W8:h1 * W8] for h0, h1 in shards]
    gmax = max(ma.scores_global_max(x, k, 1.0 / math.sqrt(md)) for x in ql)
    sums = sum(ma.corr_norm_sums(x, k, biases, grid, gmax, attn_clip, 0.5,
                                 *AGG, q_row0=h0)
               for x, (h0, _) in zip(ql, shards))
    got = torch.cat([ma.corr_norm_write(x, k, biases, grid, gmax, sums,
                                        attn_clip, 0.5, *AGG, q_row0=h0,
                                        out_dtype=dtype)
                     for x, (h0, _) in zip(ql, shards)], dim=1)
    assert got.dtype == dtype and got.shape == want.shape
    # The moments differ from B3's by the order of fp64 sums; a bf16 output
    # may round the other way where a value sits on a rounding boundary.
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    d = (got.float() - want.float()).abs()
    assert float((d / (1.0 + want.float().abs())).max()) <= tol


def test_shard_rows_are_checked(rng):
    q, k = (_t(x) for x in _qk(rng, 1, 30, 42, 8))
    biases = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="whole rows"):  # 30 is not 5 x 6
        ma.corr_norm_sums(q[:, :, :29], k, biases, (7, 6), 1.0, 1.0, 0.5,
                          *AGG)
    with pytest.raises(ValueError, match="whole rows"):  # rows 3..7 of 7
        ma.flash_mode_attention(q, k, k, biases, (7, 6), 1e30, 0.5,
                                q_row0=3)
    with pytest.raises(ValueError, match="whole rows"):  # k is not 7 x 7
        ma.mode_softmax_probs(q, k, biases, (7, 7), 1e30, 1.0)
