"""The learned-sinusoid positional codes (pos_code_type='lsinu') and the
masked f2 attention (attn_mask_radius > 0) of the port against the JAX
package on the CPU: the embedder and the lsinu input encoder (fp32, atol
1e-5), the f2 mask and its dense table, the three attention sites in eval
mode (the f2 site also against the Pallas interpret branch,
use_pallas='on'), and the whole FlowModel at 64x64 under lsinu (all three
sites) and under --f2radius 3 with JAX-initialised weights bridged by
``state_dict_from_flax``: fp32 within 1e-3 px, mixed precision within
0.15 px (the JAX package's own bounds, tools/verify_tpu.py:36-37).  Train
mode under these configurations: tests/test_torch_plain_sites.py and
tests/test_torch_train_dense*.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu.models.flow_model import TransCorr as JaxTransCorr
from craft_tpu.nn.setrans import InputFeatEncoder as JaxInputFeatEncoder
from craft_tpu.nn.setrans import LearnedSinuPosEmbedder as JaxEmbedder
from craft_tpu.nn.setrans import SelfAttVisPosTrans as JaxSelfAtt
from craft_tpu.nn.setrans import sliding_pos_biases as jax_sliding_pos_biases
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import FlowModel, TransCorr
from craft_tpu_torch.nn import setrans as ts
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.corr import global_layer_norm
from craft_tpu_torch.utils.weights import state_dict_from_flax

H8, W8 = 5, 12
U = H8 * W8


def _seeded(params, rng, qk_scale=0.15):
    """Seeded weights: q/k projections wide enough that the scores reach
    O(1), a nonzero bias window, O(1) pos_fc weights so that the sinusoids
    vary across the grid, and every other leaf moved off its init."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            shape = np.shape(v)
            if k == "biases":
                out[k] = (rng.randn(*shape) * 0.5).astype(np.float32)
            elif "pos_fc" in path:
                out[k] = (rng.randn(*shape) * 2.0).astype(np.float32)
            elif k == "kernel" and ("query" in path or "key" in path):
                out[k] = (rng.randn(*shape) * qk_scale).astype(np.float32)
            else:
                out[k] = (np.asarray(v, np.float32)
                          + rng.randn(*shape).astype(np.float32) * 0.05)
        return out
    return walk(params)


def _with_codes(params, rng):
    """The JAX init with seeded positional codes: a nonzero bias window
    (its init is zero) and O(1) pos_fc weights.  The rest stays as
    initialised; the perturbed weights of ``_seeded`` drive a whole model to
    flows of ~90 px at 64x64, where bf16 rounding is amplified past any
    bound, for the sliding-bias config as much as for these."""
    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if hasattr(v, "items") else
                (rng.randn(*np.shape(v)) * (0.5 if k == "biases" else 2.0))
                .astype(np.float32) if k == "biases" or "pos_fc" in path
                else v for k, v in tree.items()}
    return walk(params)


# ------------------------------------------------------ codes and tables


def test_lsinu_embedder_matches_flax(rng):
    coords = rng.rand(1, 40, 2).astype(np.float32)
    jmod = JaxEmbedder(64)
    params = _seeded(jmod.init(jax.random.PRNGKey(0),
                               jnp.asarray(coords))["params"], rng)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(coords)))
    mod = ts.LearnedSinuPosEmbedder(64)
    mod.load_state_dict(state_dict_from_flax({"params": params}), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # Interleaved: column 2i is a sine, column 2i + 1 a cosine.
    with torch.no_grad():
        p = mod.pos_fc(torch.from_numpy(coords))
    raw = torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1)
    assert torch.equal(raw.reshape(p.shape)[..., 1], p[..., 1].cos())


@pytest.mark.parametrize("hw", [(5, 12), (9, 4), (1, 1)])
def test_lsinu_input_encoder_matches_flax(rng, hw):
    H, W = hw
    jcfg = dataclasses.replace(jconfig.f2_trans_config(), in_feat_dim=32,
                               feat_dim=32, pos_code_type="lsinu",
                               pos_code_weight=0.7)
    tcfg = dataclasses.replace(tconfig.f2_trans_config(), in_feat_dim=32,
                               feat_dim=32, pos_code_type="lsinu",
                               pos_code_weight=0.7)
    x = rng.randn(2, H, W, 32).astype(np.float32)
    jmod = JaxInputFeatEncoder(jcfg)
    params = _seeded(jmod.init(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"], rng)
    want, wbias = jmod.apply({"params": params}, jnp.asarray(x))
    assert wbias is None
    enc = ts.InputFeatEncoder(tcfg).eval()
    enc.load_state_dict(state_dict_from_flax({"params": params}), strict=True)
    with torch.no_grad():
        got, bias = enc(torch.from_numpy(x))
    assert bias is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("radius", [1, 3])
def test_attention_mask_and_dense_table_match_jax(rng, radius):
    ys, xs = jnp.meshgrid(jnp.arange(H8), jnp.arange(W8), indexing="ij")
    coords = jnp.stack([ys, xs], axis=-1).reshape(U, 2)
    diff = jnp.abs(coords[None] - coords[:, None]).max(axis=-1)
    want_mask = np.asarray(jnp.where(diff > radius, -1e9, 0.0)
                           .astype(jnp.float32))
    got_mask = ts.attention_mask(H8, W8, radius)
    assert got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert (np.diag(want_mask) == 0).all()
    biases = rng.randn(15, 15).astype(np.float32)
    want = 0.5 * np.asarray(jax_sliding_pos_biases(jnp.asarray(biases), H8,
                                                   W8)) + want_mask
    got = got_mask + 0.5 * ma.sliding_pos_biases(torch.from_numpy(biases),
                                                  H8, W8)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- sites


def _site(site, dim, **kw):
    ctor = {"f2": "f2_trans_config", "intra": "intra_attn_config"}[site]
    fields = dict(in_feat_dim=dim, feat_dim=dim, **kw)
    return (dataclasses.replace(getattr(jconfig, ctor)(), **fields),
            dataclasses.replace(getattr(tconfig, ctor)(), **fields))


def _site_pair(rng, site, dim, use_pallas="auto", **kw):
    jcfg, tcfg = _site(site, dim, **kw)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    jmod = JaxSelfAtt(jcfg)
    x = rng.randn(2, H8, W8, dim).astype(np.float32)
    params = _seeded(jmod.init(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"], rng)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    model = ts.SelfAttVisPosTrans(tcfg).eval()
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return got, want


F2_CASES = {
    "lsinu": dict(pos_code_type="lsinu"),
    "lsinu, clamp on": dict(pos_code_type="lsinu", attn_clip=0.5),
    "bias, radius 3": dict(attn_mask_radius=3),
    "bias, radius 1, clamp on": dict(attn_mask_radius=1, attn_clip=0.5),
    "lsinu, radius 2": dict(pos_code_type="lsinu", attn_mask_radius=2),
}


@pytest.mark.parametrize("case", sorted(F2_CASES))
def test_f2_site_matches_flax(rng, case):
    got, want = _site_pair(rng, "f2", 64, **F2_CASES[case])
    assert got.shape == want.shape == (2, H8, W8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_f2_site_lsinu_matches_the_pallas_branch(rng, attn_clip):
    """use_pallas='on': the JAX site runs B1 and flash_mode_attention with
    no table, in interpret mode."""
    got, want = _site_pair(rng, "f2", 64, use_pallas="on",
                           pos_code_type="lsinu", attn_clip=attn_clip)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_intra_site_lsinu_matches_flax(rng, attn_clip):
    got, want = _site_pair(rng, "intra", 32, pos_code_type="lsinu",
                           attn_clip=attn_clip)
    assert got.shape == want.shape == (2, 4, U, U)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_intra_site_lsinu_ignores_quantize_probs_under_mixed(rng):
    """Float probs in the compute dtype, as the JAX XLA softmax gives."""
    jcfg, tcfg = _site("intra", 32, pos_code_type="lsinu",
                       quantize_probs=True)
    jmod = JaxSelfAtt(jcfg, dtype=jnp.bfloat16)
    x = rng.randn(2, H8, W8, 32).astype(np.float32)
    params = _seeded(jmod.init(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"], rng, 0.2)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    model = ts.SelfAttVisPosTrans(tcfg, torch.bfloat16).eval()
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, U, U)
    # bf16 probs of the same rows: a bf16 rounding (2^-8) of each value,
    # from q, k projected in bf16 by both.
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


@pytest.mark.parametrize("attn_clip", [100.0, 0.5])
def test_inter_site_lsinu_matches_flax_raw_volume(rng, attn_clip):
    fields = dict(in_feat_dim=64, feat_dim=64, pos_code_type="lsinu",
                  attn_clip=attn_clip)
    jcfg = dataclasses.replace(jconfig.inter_corr_config(), **fields)
    tcfg = dataclasses.replace(tconfig.inter_corr_config(), **fields)
    jmod = JaxTransCorr(jconfig.ModelConfig(inter=jcfg))
    f1 = rng.randn(2, H8, W8, 64).astype(np.float32)
    f2 = rng.randn(2, H8, W8, 64).astype(np.float32)
    params = _seeded(jmod.init(jax.random.PRNGKey(0), jnp.asarray(f1),
                               jnp.asarray(f2))["params"], rng)
    raw = np.asarray(jmod.apply({"params": params}, jnp.asarray(f1),
                                jnp.asarray(f2)))
    assert raw.shape == (2, U, 1, U)
    model = TransCorr(tconfig.ModelConfig(inter=tcfg)).eval()
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    assert not model.prenormed()
    with torch.no_grad():
        got = model(torch.from_numpy(f1), torch.from_numpy(f2))
    assert got.dtype == torch.float32 and got.shape == (2, U, U)
    np.testing.assert_allclose(got.numpy(), raw.reshape(2, U, U), atol=2e-4,
                               rtol=1e-3)
    # And after the global norm the pyramid applies.
    normed = global_layer_norm(got.reshape(2, 1, U * U)).numpy()
    want = (raw - raw.mean(axis=(1, 2, 3), keepdims=True)) / np.sqrt(
        raw.var(axis=(1, 2, 3), keepdims=True) + 1e-12)
    np.testing.assert_allclose(normed.reshape(2, U, U), want.reshape(2, U, U),
                               atol=1e-3)


# ------------------------------------------------------- the whole model


def _variant(mixed, variant):
    """(JAX config, port config) of full CRAFT under `variant`."""
    cfgs = []
    for m in (jconfig, tconfig):
        cfg = m.craft_config(mixed_precision=mixed)
        if variant == "lsinu":
            cfg = cfg.replace(**{site: dataclasses.replace(
                getattr(cfg, site), pos_code_type="lsinu")
                for site in ("inter", "f2", "intra")})
        else:
            cfg = cfg.replace(f2=dataclasses.replace(cfg.f2,
                                                     attn_mask_radius=3))
        cfgs.append(cfg)
    return cfgs


@functools.lru_cache(maxsize=None)
def _model_variables(variant):
    """JAX-initialised variables of `variant` (at 16x16 and fp32: no
    parameter depends on the frame size or the compute dtype) with seeded
    positional codes."""
    jcfg, _ = _variant(False, variant)
    zeros = jnp.zeros((1, 16, 16, 3))
    init = JaxFlowModel(cfg=jcfg, train=False).init
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: init(key, zeros, zeros, iters=1))(jax.random.PRNGKey(0)))
    return {"params": _with_codes(variables["params"],
                                  np.random.RandomState(2)),
            "batch_stats": variables["batch_stats"]}


@pytest.mark.parametrize("mixed,bound", [(False, 1e-3), (True, 0.15)])
@pytest.mark.parametrize("variant", ["lsinu", "f2radius 3"])
def test_flow_model_matches_jax(variant, mixed, bound):
    jcfg, tcfg = _variant(mixed, variant)
    rng = np.random.RandomState(1)
    img1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    img2 = np.roll(img1, 3, axis=2) + rng.uniform(
        -8, 8, img1.shape).astype(np.float32)
    jmodel = JaxFlowModel(cfg=jcfg, train=False)
    variables = _model_variables(variant)
    _, want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=3))(
        variables, jnp.asarray(img1), jnp.asarray(img2))
    want = np.asarray(want[-1], np.float32)
    model = FlowModel(tcfg).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        _, got = model(torch.from_numpy(img1), torch.from_numpy(img2),
                       iters=3)
    got = got[-1].float().numpy()
    assert np.isfinite(got).all() and got.shape == (1, 64, 64, 2)
    assert np.abs(want).max() > 0.01  # the flow is not trivially zero
    err = float(np.abs(got - want).max())
    print(f"{variant} mixed={mixed}: max |flow diff| {err:.3e} px")
    assert err < bound
