"""Port SepConvGRU and GMAUpdateBlock against the flax modules with bridged
weights, on seeded 4x6 grids at the real widths (hidden 128, 324 lookup
channels, 4 modes).  fp32, atol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.config import craft_config as jax_craft_config
from craft_tpu.nn.setrans import QuantizedProbs as JaxQuantizedProbs
from craft_tpu.nn.update import GMAUpdateBlock as JaxUpdateBlock
from craft_tpu.nn.update import SepConvGRU as JaxSepConvGRU
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.nn.setrans import QuantizedProbs
from craft_tpu_torch.nn.update import GMAUpdateBlock, SepConvGRU
from craft_tpu_torch.utils.weights import state_dict_from_flax

ATOL = 1e-4
B, H, W = 2, 4, 6


def _noisy(tree, rng):
    return {k: _noisy(v, rng) if hasattr(v, "items") else
            np.asarray(v, np.float32)
            + rng.randn(*np.shape(v)).astype(np.float32) * 0.02
            for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("static", [False, True])
def test_sep_conv_gru_matches_flax(rng, static):
    h = np.tanh(rng.randn(B, H, W, 128)).astype(np.float32)
    x = rng.randn(B, H, W, 384).astype(np.float32)
    jmod = JaxSepConvGRU(hidden_dim=128)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h),
                       jnp.asarray(x))["params"]
    variables = {"params": _noisy(params, rng)}
    sd = state_dict_from_flax({"params": {"gru": variables["params"]}})
    model = SepConvGRU(128, 384)
    model.load_state_dict({k[len("gru."):]: v for k, v in sd.items()},
                          strict=True)
    th, tx = torch.from_numpy(h), torch.from_numpy(x)
    if static:
        js = jmod.apply(variables, jnp.asarray(x[..., :128]), 256,
                        method=JaxSepConvGRU.static_contrib)
        want = jmod.apply(variables, jnp.asarray(h),
                          jnp.asarray(x[..., 128:]), static=js)
        got = model(th, tx[..., 128:],
                    static=model.static_contrib(tx[..., :128]))
    else:
        want = jmod.apply(variables, jnp.asarray(h), jnp.asarray(x))
        got = model(th, tx)
    _close(got, want)


@pytest.mark.parametrize("attention_kind", ["probs", "quantized"])
@pytest.mark.parametrize("static", [False, True])
def test_gma_update_block_matches_flax(rng, attention_kind, static):
    jcfg = jax_craft_config(mixed_precision=False)
    cfg = craft_config(mixed_precision=False)
    U = H * W
    net = np.tanh(rng.randn(B, H, W, 128)).astype(np.float32)
    inp = np.maximum(rng.randn(B, H, W, 128), 0).astype(np.float32)
    corr = rng.randn(B, H, W, cfg.cor_planes).astype(np.float32)
    flow = (rng.randn(B, H, W, 2) * 2).astype(np.float32)
    logits = rng.randn(B, 4, U, U).astype(np.float32) * 2
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    if attention_kind == "probs":
        j_att, t_att = jnp.asarray(probs), torch.from_numpy(probs)
    else:
        # probs = num * scale with num = round(p / rowmax * 127).
        pmax = probs.max(-1, keepdims=True)
        num = np.round(probs / pmax * 127).astype(np.int8)
        scale = (pmax / 127.0).astype(np.float32)
        j_att = JaxQuantizedProbs(jnp.asarray(num), jnp.asarray(scale))
        t_att = QuantizedProbs(torch.from_numpy(num), torch.from_numpy(scale))

    jmod = JaxUpdateBlock(jcfg)
    jargs = [jnp.asarray(a) for a in (net, inp, corr, flow)]
    params = jmod.init(jax.random.PRNGKey(0), *jargs,
                       jnp.asarray(probs))["params"]
    variables = {"params": _noisy(params, rng)}
    model = GMAUpdateBlock(cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    targs = [torch.from_numpy(a) for a in (net, inp, corr, flow)]

    with torch.no_grad():
        if static:
            js = jmod.apply(variables, jargs[1],
                            method=JaxUpdateBlock.precompute_gru_static)
            want = jmod.apply(variables, *jargs, j_att, gru_static=js)
            got = model(*targs, t_att,
                        gru_static=model.precompute_gru_static(targs[1]))
        else:
            want = jmod.apply(variables, *jargs, j_att)
            got = model(*targs, t_att)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)
        mask = model.upsample_mask(got[0])
    want_mask = jmod.apply(variables, jnp.asarray(got[0].numpy()),
                           method=JaxUpdateBlock.upsample_mask)
    _close(mask, want_mask)


def test_aggregator_config_is_the_intra_site_with_feature_output():
    cfg = craft_config(mixed_precision=True)
    agg = GMAUpdateBlock(cfg).aggregator.cfg
    assert dataclasses.asdict(agg) == dict(
        dataclasses.asdict(cfg.intra), out_attn_probs_only=False,
        out_attn_scores_only=False)
