"""The plain versions of the four attention kernels (B1-B4) and the three
main-path attention sites against the JAX package's XLA path, at tiny
ragged shapes (M=4, md 8-16, a 5x12 token grid: no tile divides it).

Sites run through the flax modules with bridged weights; kernel functions
are held against the same math written with the JAX package's own pieces
(sliding_pos_biases, global_layer_norm).  Clamp off (attn_clip=100), on
(attn_clip=0.5), and a batch of 2 where only one sample crosses the
threshold (the predicate is batch-global).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import TransCorr as JaxTransCorr
from craft_tpu.nn.setrans import SelfAttVisPosTrans as JaxSelfAtt
from craft_tpu.nn.setrans import sliding_pos_biases as jax_sliding_pos_biases
from craft_tpu.ops.corr import global_layer_norm as jax_global_layer_norm
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import TransCorr
from craft_tpu_torch.nn.setrans import QuantizedProbs, SelfAttVisPosTrans
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.utils.weights import state_dict_from_flax

H8, W8 = 5, 12
U = H8 * W8
GRID = (H8, W8)


def _configs(site: str, dim: int, **kw):
    ctor = {"inter": "inter_corr_config", "f2": "f2_trans_config",
            "intra": "intra_attn_config"}[site]
    fields = dict(in_feat_dim=dim, feat_dim=dim, **kw)
    return (dataclasses.replace(getattr(jconfig, ctor)(), **fields),
            dataclasses.replace(getattr(tconfig, ctor)(), **fields))


def _params(params, rng, qk_scale):
    """Seeded weights: a nonzero sliding-bias window and q/k projections
    wide enough that the scores reach O(1)."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            shape = np.shape(v)
            if k == "biases":
                out[k] = (rng.randn(*shape) * 0.5).astype(np.float32)
            elif k == "kernel" and ("query" in path or "key" in path):
                out[k] = (rng.randn(*shape) * qk_scale).astype(np.float32)
            else:
                out[k] = (np.asarray(v, np.float32)
                          + rng.randn(*shape).astype(np.float32) * 0.05)
        return out
    return {"params": walk(params)}


def _jax_scores(q, k, biases, clip, pos_w):
    """The XLA path's clamped, biased scores [B, M, U, U] (fp32 numpy)."""
    md = q.shape[-1]
    s = jnp.einsum("bmid,bmjd->bmij", jnp.asarray(q), jnp.asarray(k)) \
        / math.sqrt(md)
    s = jnp.clip(s, -clip, clip)
    return np.asarray(s + pos_w * jax_sliding_pos_biases(
        jnp.asarray(biases), H8, W8))


def _qk(rng, B=2, md=16, scale=0.6):
    q = (rng.randn(B, 4, U, md) * scale).astype(np.float32)
    k = (rng.randn(B, 4, U, md) * scale).astype(np.float32)
    return q, k


# --------------------------------------------------------------- kernels


def test_sliding_pos_biases_matches_jax(rng):
    biases = rng.randn(15, 15).astype(np.float32)
    got = ma.sliding_pos_biases(torch.from_numpy(biases), H8, W8).numpy()
    want = np.asarray(jax_sliding_pos_biases(jnp.asarray(biases), H8, W8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("md", [8, 16])
def test_b1_scores_global_max(rng, md):
    q, k = _qk(rng, md=md)
    scale = 1.0 / math.sqrt(md)
    got = float(ma.scores_global_max(torch.from_numpy(q),
                                     torch.from_numpy(k), scale))
    want = float(np.max(np.einsum("bmid,bmjd->bmij", q, k)) * scale)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_b2_flash_attention_plain(rng, clip):
    q, k = _qk(rng)
    v = rng.randn(2, 4, U, 32).astype(np.float32)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    got = ma.flash_mode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, biases)), GRID,
        torch.tensor(clip), 0.5).numpy()
    p = jax.nn.softmax(_jax_scores(q, k, biases, clip, 0.5), axis=-1)
    want = np.einsum("bmij,bmjf->bmif", np.asarray(p), v)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_agg_norm(q, k, biases, attn_clip, pos_w, agg_w, agg_b):
    """JAX scores-only XLA path (batch-global conditional clamp, learned
    soft aggregation over modes) followed by global_layer_norm."""
    md = q.shape[-1]
    raw = np.einsum("bmid,bmjd->bmij", q, k) / math.sqrt(md)
    clip = attn_clip if raw.max() > attn_clip else 1e30
    s = jnp.asarray(_jax_scores(q, k, biases, clip, pos_w))
    w = jax.nn.softmax(agg_w * s + agg_b, axis=1)
    vol = jnp.sum(w * s, axis=1)  # [B, U, U]
    B = q.shape[0]
    normed = jax_global_layer_norm(vol.reshape(B, 1, U * U))
    return np.asarray(normed).reshape(B, U, U), float(raw.max())


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_b3_fused_agg_corr_norm_plain(rng, attn_clip):
    q, k = _qk(rng)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    got, stats = ma.fused_agg_corr_norm(
        *(torch.from_numpy(a) for a in (q, k, biases)), GRID, attn_clip,
        0.5, torch.tensor(1.2), torch.tensor(0.1), out_dtype=torch.float32)
    want, gmax = _jax_agg_norm(q, k, biases, attn_clip, 0.5, 1.2, 0.1)
    assert (gmax > attn_clip) == (attn_clip == 0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), gmax, rtol=1e-6)


def test_b3_clamp_predicate_is_batch_global(rng):
    q, k = _qk(rng, scale=0.1)
    q[0, 0, 0] = 5.0  # only sample 0 crosses the threshold
    k[0, 0, 0] = 5.0
    attn_clip = 10.0
    per_sample = [np.max(np.einsum("mid,mjd->mij", q[b], k[b])) / 4.0
                  for b in range(2)]
    assert per_sample[0] > attn_clip > per_sample[1]
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    got, stats = ma.fused_agg_corr_norm(
        *(torch.from_numpy(a) for a in (q, k, biases)), GRID, attn_clip,
        0.5, torch.tensor(1.2), torch.tensor(0.1), out_dtype=torch.float32)
    want, gmax = _jax_agg_norm(q, k, biases, attn_clip, 0.5, 1.2, 0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(stats[:, 0, 0].numpy(), [gmax, gmax],
                               rtol=1e-6)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_b4_float_probs_plain(rng, clip):
    q, k = _qk(rng, md=8)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    got = ma.mode_softmax_probs(
        *(torch.from_numpy(a) for a in (q, k, biases)), GRID,
        torch.tensor(clip), 1.0, out_dtype=torch.float32).numpy()
    want = np.asarray(jax.nn.softmax(_jax_scores(q, k, biases, clip, 1.0),
                                     axis=-1))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_b4_quantized_probs_plain(rng, clip):
    q, k = _qk(rng, md=8)
    biases = (rng.randn(15, 15) * 0.5).astype(np.float32)
    num, scale = ma.mode_softmax_probs(
        *(torch.from_numpy(a) for a in (q, k, biases)), GRID,
        torch.tensor(clip), 1.0, quantized=True)
    assert num.dtype == torch.int8 and scale.shape == (2, 4, U, 1)
    s = _jax_scores(q, k, biases, clip, 1.0)
    x = np.exp(s - s.max(-1, keepdims=True)) * 127.0
    want = np.round(x)  # half to even, as jnp.round
    diff = np.abs(num.numpy().astype(np.float64) - want)
    near_half = np.abs(x - np.floor(x) - 0.5) < 1e-3
    assert diff.max() <= 1 and not (diff[~near_half] > 0).any()
    assert (num.numpy().max(-1) == 127).all()  # every row's max is 127
    probs = np.asarray(jax.nn.softmax(s, axis=-1))
    deq = num.numpy().astype(np.float32) * scale.numpy()
    assert np.abs(deq - probs).max() <= 1.0 / 254


# ----------------------------------------------------------------- sites


def _site_pair(site, dim, rng, qk_scale, **kw):
    jcfg, tcfg = _configs(site, dim, **kw)
    jmod = JaxSelfAtt(jcfg)
    x = rng.randn(2, H8, W8, dim).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    variables = _params(params, rng, qk_scale)
    model = SelfAttVisPosTrans(tcfg).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return got, np.asarray(want)


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_f2_site_matches_flax(rng, attn_clip):
    got, want = _site_pair("f2", 64, rng, 0.15, attn_clip=attn_clip)
    assert got.shape == want.shape == (2, H8, W8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_intra_site_float_probs_match_flax(rng, attn_clip):
    got, want = _site_pair("intra", 32, rng, 0.2, attn_clip=attn_clip)
    assert got.shape == want.shape == (2, 4, U, U)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_intra_site_quantized_probs_match_flax(rng):
    got, want = _site_pair("intra", 32, rng, 0.2, quantize_probs=True)
    assert isinstance(got, QuantizedProbs)
    deq = got.num.float().numpy() * got.scale.numpy()
    assert np.abs(deq - want).max() <= 1.0 / 254


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_inter_site_matches_flax_scores_then_global_norm(rng, attn_clip):
    jcfg, tcfg = _configs("inter", 64, attn_clip=attn_clip)
    jmod = JaxTransCorr(jconfig.ModelConfig(inter=jcfg))
    f1 = rng.randn(2, H8, W8, 64).astype(np.float32)
    f2 = rng.randn(2, H8, W8, 64).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(f1),
                       jnp.asarray(f2))["params"]
    variables = _params(params, rng, 0.15)
    raw = jmod.apply(variables, jnp.asarray(f1), jnp.asarray(f2))
    assert raw.shape == (2, U, 1, U)
    want = np.asarray(jax_global_layer_norm(raw.reshape(2, 1, U * U)))
    model = TransCorr(tconfig.ModelConfig(inter=tcfg)).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(f1), torch.from_numpy(f2))
        q, k = model.setrans._qk(*(model.vispos_encoder(torch.from_numpy(f))[0]
                                   for f in (f1, f2)))
        gmax = float(ma.scores_global_max(q, k, 1 / math.sqrt(tcfg.mode_dim)))
    assert (gmax > attn_clip) == (attn_clip == 0.5)
    np.testing.assert_allclose(got.numpy(), want.reshape(2, U, U),
                               atol=2e-4, rtol=1e-3)
