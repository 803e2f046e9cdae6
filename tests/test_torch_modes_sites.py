"""The three SETrans sites at mode counts other than 4, port against the
JAX package's XLA path on the CPU, fp32, dropout rates 0, seeded weights.

The 256-wide sites (f2, inter) take 1, 2, 8 and 16 modes (md 256, 128, 32,
16), the 128-wide intra site 1, 2 and 8 (md 128, 64, 16).  In eval mode the
port's sites take their kernels' plain versions (B2 at the f2 site, B4 float
at the intra site, B3 at the inter site, whose normed volume is held against
the JAX raw volume normed per sample as B3 norms it); at one mode the inter
site has no attn_softaggr and its volume is the clamped, biased scores
themselves (craft_tpu/nn/setrans.py:682-685).  In train mode each site's
output and ``jax.vjp``'s gradients (every parameter, the inputs) from a
seeded cotangent.  The plain path too (stock autograd over the
materialised scores: training under lsinu or --attn_diag, attvis) at one
and eight modes, with an AttentionDiagnostics collecting, against the JAX
site with its 'diagnostics' collection (tests/test_torch_plain_sites.py's
helpers).  The clamp fires (attn_clip below the seeded sites' largest
score).  Bounds: outputs within atol 5e-5, rtol 1e-4; gradients
within rtol 1e-4 and atol 5e-5 of the site's largest gradient (a scalar's
gradient, input_skip_coeff's, is one sum over every token and feature,
taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import TransCorr as JaxTransCorr
from craft_tpu.nn.setrans import SelfAttVisPosTrans as JaxSelfAtt
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import TransCorr
from craft_tpu_torch.nn import setrans as ts
from craft_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_plain_sites import _jax_site, _port_site
from test_torch_posenc import _seeded
from test_torch_train_dense import _one_thread  # noqa: F401

H8, W8 = 4, 10
ATOL, RTOL = 5e-5, 1e-4
EPS = 1e-12  # B3's layer-norm epsilon
CLAMP_CLIP = 0.5  # below the seeded sites' largest score: the clamp fires
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CTORS = {"f2": "f2_trans_config", "intra": "intra_attn_config",
         "inter": "inter_corr_config"}
MODES = {"f2": (1, 2, 8, 16), "inter": (1, 2, 8, 16), "intra": (1, 2, 8)}
CASES = [(site, m) for site, ms in MODES.items() for m in ms]


def _configs(site, modes, attn_clip):
    kw = dict(num_modes=modes, attn_clip=attn_clip, **NO_DROPOUT)
    return (dataclasses.replace(getattr(jconfig, CTORS[site])(), **kw),
            dataclasses.replace(getattr(tconfig, CTORS[site])(), **kw))


def _inputs(site, jcfg):
    rng = np.random.RandomState(3)
    n_in = 2 if site == "inter" else 1
    return [rng.randn(2, H8, W8, jcfg.in_feat_dim).astype(np.float32)
            for _ in range(n_in)]


def _jax_module(site, jcfg):
    if site == "inter":
        return JaxTransCorr(jconfig.ModelConfig(inter=jcfg))
    return JaxSelfAtt(jcfg)


def _params(jmod, xs):
    init = jmod.init(jax.random.PRNGKey(0), *xs)["params"]
    return _seeded(init, np.random.RandomState(4))


def _port_module(site, tcfg, params, train):
    model = TransCorr(tconfig.ModelConfig(inter=tcfg)) if site == "inter" \
        else ts.SelfAttVisPosTrans(tcfg)
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    return model.train(train)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got).reshape(np.shape(want)), want,
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("site,modes", CASES)
def test_site_eval_matches_jax(site, modes, attn_clip=CLAMP_CLIP):
    jcfg, tcfg = _configs(site, modes, attn_clip)
    inputs = _inputs(site, jcfg)
    xs = [jnp.asarray(x) for x in inputs]
    jmod = _jax_module(site, jcfg)
    params = _params(jmod, xs)
    if site == "inter":
        raw = np.asarray(jmod.apply({"params": params}, *xs, None, None,
                                    True))[:, :, 0]  # [B, U1, U2]
        mean = raw.mean(axis=(1, 2), keepdims=True, dtype=np.float64)
        var = (raw.astype(np.float64) ** 2).mean(
            axis=(1, 2), keepdims=True) - mean ** 2
        want = ((raw - mean) / np.sqrt(var + EPS)).astype(np.float32)
    else:
        want = np.asarray(jmod.apply({"params": params}, *xs,
                                     deterministic=True))
    model = _port_module(site, tcfg, params, train=False)
    assert hasattr(model.setrans, "attn_softaggr") == (
        modes > 1 and tcfg.out_attn_only)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in inputs))
    _close(got.numpy(), want, f"{site} M={modes} eval")


@pytest.mark.parametrize("site,modes", CASES)
def test_site_gradients_match_jax_vjp(site, modes, attn_clip=CLAMP_CLIP):
    jcfg, tcfg = _configs(site, modes, attn_clip)
    inputs = _inputs(site, jcfg)
    xs = [jnp.asarray(x) for x in inputs]
    jmod = _jax_module(site, jcfg)
    params = _params(jmod, xs)
    rngs = {"dropout": jax.random.PRNGKey(1)}

    def fn(p, *a):
        if site == "inter":
            return jmod.apply({"params": p}, *a, None, None, False,
                              rngs=rngs)
        return jmod.apply({"params": p}, *a, deterministic=False, rngs=rngs)

    want, vjp = jax.vjp(fn, params, *xs)
    cot = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(cot))
    model = _port_module(site, tcfg, params, train=True)
    tx = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = model(*tx)
    _close(out.detach().numpy(), np.asarray(want), f"{site} M={modes} out")
    out.backward(torch.from_numpy(cot).reshape(out.shape))
    want_grads = state_dict_from_flax({"params": wgrads[0]})
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for name, p in model.named_parameters():
        w = want_grads[name].numpy()
        # The probs-only site's attn_softaggr is kept for the state_dict
        # and reached by nothing (zero in JAX); feat2score's bias inside
        # the softmax over the modes is zero in exact arithmetic.
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * gmax,
                                   err_msg=f"{site} M={modes} {name}")
    for x, w in zip(tx, wgrads[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max(),
                                   err_msg=f"{site} M={modes} dx")


@pytest.mark.parametrize("site,modes", [("inter", 1), ("inter", 8),
                                        ("f2", 1)])
def test_plain_site_matches_jax_vjp(site, modes, attn_clip=CLAMP_CLIP):
    jcfg, tcfg = _configs(site, modes, attn_clip)
    inputs = _inputs(site, jcfg)
    want, cot, wgrads, wx, sows, params = _jax_site(site, jcfg, inputs, True)
    got, model, gx, diag = _port_site(site, tcfg, params, inputs, cot, True)
    _close(got, want, f"{site} M={modes} plain out")
    want_grads = state_dict_from_flax({"params": wgrads})
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for name, p in model.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * gmax,
                                   err_msg=f"{site} M={modes} {name}")
    for g, w in zip(gx, wx):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())
    (max_attn, _, _), = diag.sites
    np.testing.assert_allclose(float(max_attn), sows["max_attn"][0],
                               rtol=1e-5)
