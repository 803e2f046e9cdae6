"""The SETrans ablations of the port (``nn/setrans_ablation.py``) against
the JAX package on the CPU: the fixed 2D sinusoid table (bit for bit), the
f2 and intra sites under the positional codes 'zero', 'rand' and 'sinu'
and the f2 site under ``ablate_multihead`` in eval mode (atol 1e-4 and
1e-5, ``tests/test_torch_posenc.py``'s site bounds), the multi-head site
in train mode (dropout rates 0: the plain path, its output and its input
gradient within 1e-4), and the whole FlowModel at 64x64 under each code
(every site) and under ``ablate_multihead`` (the f2 site): fp32 within
1e-3 px, mixed precision within 0.15 px (the JAX package's bounds,
tools/verify_tpu.py:36-37).  Model weights: the JAX tree as
``jax.eval_shape`` gives it, filled from the oracle tree
(``test_torch_families._fill``); the 'rand' tables then hold one row a
token of the 8 x 8 grid, as the JAX init sizes them.
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
from craft_tpu.nn.setrans import SelfAttVisPosTrans as JaxSelfAtt
from craft_tpu.nn.setrans_ablation import \
    positional_encoding_2d as jax_table
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.nn import setrans as ts
from craft_tpu_torch.nn.setrans_ablation import (MultiHeadFeatTrans,
                                                 RandPosEmbedder,
                                                 positional_encoding_2d)
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax
from test_torch_families import ORACLE, _fill, _flat, _nest
from test_torch_posenc import H8, W8, U, _seeded, _site_pair
from test_torch_two_way import _one_thread  # noqa: F401

CODES = ("zero", "rand", "sinu")
HW, ITERS = (64, 64), 3


@pytest.mark.parametrize("cwh", [(64, 5, 12), (256, 8, 8), (128, 1, 3)])
def test_positional_encoding_2d_matches_jax(cwh):
    np.testing.assert_array_equal(positional_encoding_2d(*cwh),
                                  jax_table(*cwh))


@pytest.mark.parametrize("code", CODES)
def test_f2_site_under_each_code_matches_flax(rng, code):
    got, want = _site_pair(rng, "f2", 64, pos_code_type=code)
    assert got.shape == want.shape == (2, H8, W8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("code", CODES)
def test_intra_site_under_each_code_matches_flax(rng, code):
    got, want = _site_pair(rng, "intra", 32, pos_code_type=code,
                           attn_clip=0.5)
    assert got.shape == want.shape == (2, 4, U, U)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("code", ["bias", "lsinu"])
def test_f2_site_ablate_multihead_matches_flax(rng, code):
    got, want = _site_pair(rng, "f2", 64, pos_code_type=code,
                           ablate_multihead=True)
    assert got.shape == want.shape == (2, H8, W8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_multihead_site_trains_through_the_plain_path(rng):
    """Train mode, dropout rates 0: the output and d(sum(out * g))/dx of
    the port's site against the JAX site's (deterministic=False)."""
    fields = dict(in_feat_dim=64, feat_dim=64, ablate_multihead=True,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg = dataclasses.replace(jconfig.f2_trans_config(), **fields)
    tcfg = dataclasses.replace(tconfig.f2_trans_config(), **fields)
    jmod = JaxSelfAtt(jcfg)
    x = rng.randn(2, H8, W8, 64).astype(np.float32)
    g = rng.randn(2, H8, W8, 64).astype(np.float32)
    params = _seeded(jmod.init(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"], rng)

    want, vjp = jax.vjp(
        lambda xx: jmod.apply({"params": params}, xx, False,
                              rngs={"dropout": jax.random.PRNGKey(0)}),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    site = ts.SelfAttVisPosTrans(tcfg).train()
    site.load_state_dict(state_dict_from_flax({"params": params}),
                         strict=True)
    assert isinstance(site.setrans.out_trans, MultiHeadFeatTrans)
    tx = torch.from_numpy(x).requires_grad_()
    got = site(tx)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-4)


def test_rand_table_takes_the_loaded_size():
    """Built for the default 36 x 36 grid, the table takes a loaded one's
    size, and a grid past its rows raises."""
    emb = RandPosEmbedder(8)
    assert emb.pos_embed.shape == (36 * 36, 8)
    emb.load_state_dict({"pos_embed": torch.ones(12, 8)})
    assert emb.pos_embed.shape == (12, 8)
    assert emb(torch.zeros(1, 12, 2), 3, 4).shape == (1, 12, 8)
    with pytest.raises(ValueError, match="13 rows of a table of 12"):
        emb(torch.zeros(1, 13, 2), 13, 1)


# ------------------------------------------------------- the whole model


def _configs(variant, mixed):
    out = []
    for c in (jconfig, tconfig):
        cfg = c.craft_config(mixed_precision=mixed)
        if variant == "multihead":
            cfg = cfg.replace(f2=dataclasses.replace(
                cfg.f2, ablate_multihead=True))
        else:
            cfg = cfg.replace(**{s: dataclasses.replace(
                getattr(cfg, s), pos_code_type=variant)
                for s in ("inter", "f2", "intra")})
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def variant_tree(variant, seed=0):
    jcfg, _ = _configs(variant, False)
    x = jnp.zeros((1, *HW, 3))
    model = JaxFlowModel(cfg=jcfg)
    shapes = jax.eval_shape(lambda r: model.init(r, x, x, iters=1),
                            jax.random.PRNGKey(0))
    oracle = dict(_flat(load_oracle_npz(ORACLE)[3]))
    rng = np.random.RandomState(seed)
    return _nest({(col,) + path: _fill((col,) + path, tuple(sds.shape),
                                       oracle, rng)
                  for col in ("params", "batch_stats")
                  for path, sds in _flat(shapes.get(col, {}))})


@pytest.mark.parametrize("mixed,bound", [(False, 1e-3), (True, 0.15)],
                         ids=["fp32", "mixed"])
@pytest.mark.parametrize("variant", CODES + ("multihead",))
def test_flow_model_under_each_ablation_matches_jax(variant, mixed, bound):
    jcfg, tcfg = _configs(variant, mixed)
    rng = np.random.RandomState(1)
    img1 = rng.uniform(0, 255, (1, *HW, 3)).astype(np.float32)
    img2 = np.roll(img1, 3, axis=2) + rng.uniform(
        -8, 8, img1.shape).astype(np.float32)
    tree = variant_tree(variant)
    _, want = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(img1),
        jnp.asarray(img2), iters=ITERS)
    want = np.asarray(want[-1], np.float32)
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    with torch.inference_mode():
        _, got = model(torch.from_numpy(img1), torch.from_numpy(img2),
                       iters=ITERS)
    got = got[-1].float().numpy()
    err = float(np.abs(got - want).max())
    print(f"{variant} mixed={mixed}: max |flow diff| {err:.3e} px "
          f"(max |flow| {float(np.abs(want).max()):.3f})")
    assert np.isfinite(got).all() and np.abs(want).max() > 0.01
    assert err < bound
