"""The plain training path of the three attention sites (stock autograd
over the materialised fp32 scores) against ``jax.vjp`` of the flax sites
on the CPU: fp32, dropout rates 0, seeded weights, a seeded cotangent.

The sites take that path in training where they have no sliding bias
(lsinu) or a mask (the f2 site's --f2radius), and every site when an
``AttentionDiagnostics`` collects (the --attn_diag step; here with the
sliding bias, against the JAX site with its 'diagnostics' collection
mutable, whose sows the port's records must match within 1e-5 relative).
Each case runs with the default attn_clip and with one low enough that
the clamp fires.  Bounds are those of tests/test_torch_training.py: each
gradient within 1e-3 of its own largest value; a gradient that is zero
in exact arithmetic (feat2score's bias inside a softmax over the modes)
within 1e-3 of the site's largest gradient.
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
from test_torch_posenc import _seeded
from test_torch_train_dense import _one_thread  # noqa: F401

H8, W8 = 5, 12
U = H8 * W8
GRAD_TOL = 1e-3
DIAG_RTOL = 1e-5
CLAMP_CLIP = 0.5  # below the seeded sites' largest score (~1-3)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DIMS = {"f2": 64, "intra": 32, "inter": 64}
CTORS = {"f2": "f2_trans_config", "intra": "intra_attn_config",
         "inter": "inter_corr_config"}

# (site, config fields, whether an AttentionDiagnostics collects)
CASES = {
    "f2 lsinu": ("f2", dict(pos_code_type="lsinu"), False),
    "f2 bias, radius 2": ("f2", dict(attn_mask_radius=2), False),
    "f2 lsinu, radius 2": ("f2", dict(pos_code_type="lsinu",
                                      attn_mask_radius=2), False),
    "intra lsinu": ("intra", dict(pos_code_type="lsinu"), False),
    "inter lsinu": ("inter", dict(pos_code_type="lsinu"), False),
    "f2 bias, diagnostics": ("f2", {}, True),
    "intra bias, diagnostics": ("intra", {}, True),
    "inter bias, diagnostics": ("inter", {}, True),
}


def _configs(site, fields, attn_clip):
    dim = DIMS[site]
    kw = dict(fields, in_feat_dim=dim, feat_dim=dim, attn_clip=attn_clip,
              **NO_DROPOUT)
    return (dataclasses.replace(getattr(jconfig, CTORS[site])(), **kw),
            dataclasses.replace(getattr(tconfig, CTORS[site])(), **kw))


def _sows(diag_tree):
    """{name: [values]} of the JAX 'diagnostics' collection."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(diag_tree)[0]:
        name = jax.tree_util.keystr(path)
        for key in ("max_attn", "avg_abs_attn", "clamp_frac"):
            if key in name:
                out.setdefault(key, []).append(float(leaf))
    return out


def _jax_site(site, jcfg, inputs, collect):
    """(output, {name: parameter gradient}, [input gradients], sows,
    params) of the flax site under jax.vjp with a seeded cotangent."""
    if site == "inter":
        jmod = JaxTransCorr(jconfig.ModelConfig(inter=jcfg))
    else:
        jmod = JaxSelfAtt(jcfg)
    xs = [jnp.asarray(x) for x in inputs]
    init = jmod.init(jax.random.PRNGKey(0), *xs)["params"]
    params = _seeded(init, np.random.RandomState(4))
    rngs = {"dropout": jax.random.PRNGKey(1)}
    mutable = ["diagnostics"] if collect else False

    def fn(p, *a):
        if site == "inter":
            out = jmod.apply({"params": p}, *a, None, None, False,
                             rngs=rngs, mutable=mutable)
        else:
            out = jmod.apply({"params": p}, *a, deterministic=False,
                             rngs=rngs, mutable=mutable)
        return out if collect else (out, {})

    out, vjp, state = jax.vjp(fn, params, *xs, has_aux=True)
    cot = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    grads = vjp(jnp.asarray(cot))
    return (np.asarray(out), cot, grads[0], [np.asarray(g) for g in
                                             grads[1:]],
            _sows(state.get("diagnostics", {})), params)


def _port_site(site, tcfg, params, inputs, cot, collect):
    if site == "inter":
        model = TransCorr(tconfig.ModelConfig(inter=tcfg))
    else:
        model = ts.SelfAttVisPosTrans(tcfg)
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    model.train()
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    diag = ts.AttentionDiagnostics() if collect else None
    out = model(*xs, diagnostics=diag)
    out.backward(torch.from_numpy(cot).reshape(out.shape))
    return out.detach().numpy(), model, [x.grad.numpy() for x in xs], diag


@pytest.mark.parametrize("attn_clip", [100.0, CLAMP_CLIP])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_site_gradients_match_jax_vjp(case, attn_clip):
    site, fields, collect = CASES[case]
    jcfg, tcfg = _configs(site, fields, attn_clip)
    rng = np.random.RandomState(3)
    n_in = 2 if site == "inter" else 1
    inputs = [rng.randn(2, H8, W8, DIMS[site]).astype(np.float32)
              for _ in range(n_in)]
    want, cot, wgrads, wx, sows, params = _jax_site(site, jcfg, inputs,
                                                    collect)
    got, model, gx, diag = _port_site(site, tcfg, params, inputs, cot,
                                      collect)
    assert got.size == want.size
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    want_grads = state_dict_from_flax({"params": wgrads})
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    checked = []
    for name, p in model.named_parameters():
        want_g = want_grads[name].numpy()
        # The probs-only site's attn_softaggr is kept for the state_dict
        # and reached by nothing (zero in JAX).
        got_g = np.zeros_like(want_g) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got_g - want_g).max())
        if name.endswith("feat2score.bias"):
            assert err <= GRAD_TOL * gmax, name
        else:
            assert err <= GRAD_TOL * np.abs(want_g).max(), (name, err)
        checked.append(name)
    # The codes' gradients reach their parameters: pos_fc's under lsinu,
    # the sliding window's through the dense table.
    code = "pos_fc.weight" if fields.get("pos_code_type") == "lsinu" \
        else "pos_coder.biases"
    assert any(n.endswith(code) and np.abs(model.get_parameter(n).grad
                                           .numpy()).max() > 0
               for n in checked), code
    for g, w in zip(gx, wx):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())
    if collect:
        (max_attn, avg_abs, frac), = diag.sites
        assert (max_attn > attn_clip) == (attn_clip == CLAMP_CLIP)
        for key, val in (("max_attn", max_attn), ("avg_abs_attn", avg_abs),
                         ("clamp_frac", frac)):
            np.testing.assert_allclose(float(val), sows[key][0],
                                       rtol=DIAG_RTOL, err_msg=key)
        assert (float(frac) > 0) == (attn_clip == CLAMP_CLIP)
