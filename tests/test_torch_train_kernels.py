"""The training-side pieces of the port on the CPU, each against the JAX
package: the plain versions of B6 (the aggregated volume and its backward)
and B7 (the probs backward) through their autograd Functions against
``jax.value_and_grad`` of the JAX XLA math, gradchecks of both Functions,
the sliding-bias gradient, the train-mode attention sites and encoders,
the sequence loss, the one-cycle schedule and the optimizer, and dropout.

Inputs come from a numpy seed.  Each gradient must lie within 1e-4 of its
own max |value| in fp32 unless a test says otherwise.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.nn.encoder import BasicEncoder as JaxEncoder
from craft_tpu.nn.setrans import SelfAttVisPosTrans as JaxSelfAtt
from craft_tpu.nn.setrans import sliding_pos_biases as jax_sliding_pos_biases
from craft_tpu.ops.pallas.corr_vjp import \
    _sliding_bias_grad as jax_sliding_bias_grad
from craft_tpu.training.loss import sequence_loss as jax_sequence_loss
from craft_tpu.training.optim import make_optimizer as jax_make_optimizer
from craft_tpu.training.optim import onecycle_linear, onecycle_linear_host
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.nn.encoder import BasicEncoder
from craft_tpu_torch.nn.layers import dropout, dropout2d
from craft_tpu_torch.nn.setrans import SelfAttVisPosTrans
from craft_tpu_torch.ops.kernels.corr_vjp import (fused_agg_corr_diff,
                                                  sliding_bias_grad)
from craft_tpu_torch.ops.kernels.probs_vjp import mode_softmax_probs_diff
from craft_tpu_torch.training.loss import sequence_loss
from craft_tpu_torch.training.optim import clip_by_global_norm, make_optimizer
from craft_tpu_torch.utils.weights import state_dict_from_flax

GRAD_TOL = 1e-4
# (H8, W8, R): a 4x32 grid with R=2 (the JAX package's own corr_vjp test),
# and an odd 3x7 grid whose U is a multiple of no tile, with the full R=7
# window (wider than the grid).
GRIDS = [(4, 32, 2), (3, 7, 7)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(rng, H, W, R, md=16, B=2):
    U = H * W
    q = (rng.randn(B, 4, U, md) * 0.9).astype(np.float32)
    k = (rng.randn(B, 4, U, md) * 0.9).astype(np.float32)
    biases = rng.randn(2 * R + 1, 2 * R + 1).astype(np.float32)
    return q, k, biases


def _jax_scores(q, k, biases, clip, pos_w, H, W):
    c = jnp.einsum("bmid,bmjd->bmij", q, k) / math.sqrt(q.shape[-1])
    return jnp.clip(c, -clip, clip) + pos_w * jax_sliding_pos_biases(
        biases, H, W)


def _torch_args(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _clip_for(q, k, share=0.3):
    """A clip value that the given share of |scale q k^T| exceeds."""
    c = np.abs(np.einsum("bmid,bmjd->bmij", q, k)) / math.sqrt(q.shape[-1])
    return float(np.quantile(c, 1.0 - share))


# ------------------------------------------------------------------- B6


@pytest.mark.parametrize("H,W,R", GRIDS)
@pytest.mark.parametrize("clamp", [False, True])
def test_b6_volume_and_grads_match_jax(rng, H, W, R, clamp):
    q, k, biases = _inputs(rng, H, W, R)
    clip = _clip_for(q, k) if clamp else 1e30
    pos_w, agg_w, agg_b = 0.5, 0.7, -0.2
    gw = rng.randn(2, H * W, H * W).astype(np.float32)

    def jax_loss(q, k, biases, agg_w, agg_b):
        s = _jax_scores(q, k, biases, clip, pos_w, H, W)
        p = jax.nn.softmax(agg_w * s + agg_b, axis=1)
        vol = jnp.sum(p * s, axis=1)
        return jnp.sum(vol * gw), vol

    (_, want_vol), want = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        q, k, biases, jnp.float32(agg_w), jnp.float32(agg_b))
    tq, tk, tb = _torch_args(q, k, biases)
    tw = torch.tensor(agg_w, requires_grad=True)
    tbias = torch.tensor(agg_b, requires_grad=True)
    vol = fused_agg_corr_diff(tq, tk, tb, clip, pos_w, tw, tbias, (H, W))
    (vol * torch.from_numpy(gw)).sum().backward()
    assert _rel(vol.detach(), want_vol) <= 1e-6
    for name, got, w in (("dq", tq.grad, want[0]), ("dk", tk.grad, want[1]),
                         ("dbias", tb.grad, want[2]),
                         ("dagg_w", tw.grad, want[3])):
        assert _rel(got, w) <= GRAD_TOL, name
    # agg_b cancels in the mode softmax: exactly 0 here, rounding in JAX.
    assert float(tbias.grad) == 0.0
    assert abs(float(want[4])) <= 1e-4 * np.abs(np.asarray(want[3]))


# ------------------------------------------------------------------- B7


@pytest.mark.parametrize("H,W,R", GRIDS)
@pytest.mark.parametrize("clamp", [False, True])
def test_b7_probs_and_grads_match_jax(rng, H, W, R, clamp):
    q, k, biases = _inputs(rng, H, W, R)
    clip = _clip_for(q, k) if clamp else 1e30
    pos_w = 1.0
    gw = rng.randn(2, 4, H * W, H * W).astype(np.float32)

    def jax_loss(q, k, biases):
        p = jax.nn.softmax(_jax_scores(q, k, biases, clip, pos_w, H, W), -1)
        return jnp.sum(p * gw), p

    (_, want_p), want = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, biases)
    tq, tk, tb = _torch_args(q, k, biases)
    p = mode_softmax_probs_diff(tq, tk, tb, clip, pos_w, (H, W))
    (p * torch.from_numpy(gw)).sum().backward()
    assert _rel(p.detach(), want_p) <= 1e-6
    for name, got, w in (("dq", tq.grad, want[0]), ("dk", tk.grad, want[1]),
                         ("dbias", tb.grad, want[2])):
        assert _rel(got, w) <= GRAD_TOL, name


@pytest.mark.parametrize("clip", [1e30, 0.6])
def test_gradcheck_both_functions(clip):
    gen = torch.Generator().manual_seed(0)
    H, W = 2, 3
    q, k = (torch.randn(2, 4, H * W, 4, generator=gen, dtype=torch.float64)
            .mul(0.8).requires_grad_() for _ in range(2))
    biases = torch.randn(5, 5, generator=gen,
                         dtype=torch.float64).requires_grad_()
    agg_w = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    agg_b = torch.tensor(-0.2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, b, w, a: fused_agg_corr_diff(q, k, b, clip, 0.5, w, a,
                                                  (H, W)),
        (q, k, biases, agg_w, agg_b))
    assert torch.autograd.gradcheck(
        lambda q, k, b: mode_softmax_probs_diff(q, k, b, clip, 0.5, (H, W)),
        (q, k, biases))


@pytest.mark.parametrize("H,W,R", [(3, 7, 2)])
def test_sliding_bias_grad_matches_jax(rng, H, W, R):
    g = rng.randn(3, H * W, H * W).astype(np.float32)
    want = jax_sliding_bias_grad(jnp.asarray(g), H, W, R, 0.5)
    got = sliding_bias_grad(torch.from_numpy(g), H, W, R, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- sites


@pytest.mark.parametrize("site,dim", [("f2", 32), ("intra", 32)])
def test_train_mode_site_grads_match_flax(rng, site, dim):
    ctor = {"f2": "f2_trans_config", "intra": "intra_attn_config"}[site]
    fields = dict(in_feat_dim=dim, feat_dim=dim, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, attn_clip=0.5)
    jcfg = dataclasses.replace(getattr(jconfig, ctor)(), **fields)
    tcfg = dataclasses.replace(getattr(tconfig, ctor)(), **fields)
    x = rng.randn(2, 5, 12, dim).astype(np.float32)
    jmod = JaxSelfAtt(jcfg)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.2 * np.asarray(rng.randn(*np.shape(a)), np.float32),
        variables)
    shape = jax.eval_shape(lambda: jmod.apply(variables, x)).shape
    w = rng.randn(*shape).astype(np.float32)

    def loss(params, xx):
        out = jmod.apply({"params": params}, xx, False,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    model = SelfAttVisPosTrans(tcfg).train()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    (model(xt) * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad, gx) <= GRAD_TOL
    want = state_dict_from_flax({"params": gp})
    for name, p in model.named_parameters():
        if p.grad is None:  # the probs-only site's unused attn_softaggr
            assert "attn_softaggr" in name
        elif not name.endswith("feat2score.bias"):  # zero: softmax shift
            assert _rel(p.grad, want[name]) <= GRAD_TOL, name


# -------------------------------------------------------------- encoders


def _oracle_encoder_vars(name):
    from pathlib import Path
    from craft_tpu_torch.utils.weights import load_oracle_npz
    tree = load_oracle_npz(Path(__file__).resolve().parent / "data"
                           / "oracle_craft_128.npz")[3]
    out = {"params": tree["params"][name]}
    if name in tree.get("batch_stats", {}):
        out["batch_stats"] = tree["batch_stats"][name]
    return out


def _encoder_grads(variables, norm_fn, x, w, dtype):
    model = BasicEncoder(256, norm_fn, dtype).train()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.to(dtype)
    (model(torch.from_numpy(x).to(dtype)) * torch.from_numpy(w).to(
        dtype)).sum().backward()
    return model


def test_train_mode_cnet_matches_flax_batch_norm(rng):
    """cnet in train mode (BatchNorm on batch statistics, running averages
    updated with momentum 0.9 and the biased variance) against flax,
    unjitted: outputs, gradients and the new batch_stats."""
    variables = _oracle_encoder_vars("cnet")
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    w = rng.randn(2, 8, 8, 256).astype(np.float32)
    jmod = JaxEncoder(output_dim=256, norm_fn="batch", train=True)

    def loss(params):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(y * w), upd["batch_stats"]

    (_, stats), gp = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model = _encoder_grads(variables, "batch", x, w, torch.float32)
    want = state_dict_from_flax({"params": gp})
    for name, p in model.named_parameters():
        if not ZERO_BIAS(name):
            assert _rel(p.grad, want[name]) <= GRAD_TOL, name
    want_stats = state_dict_from_flax({"batch_stats": stats})
    buffers = dict(model.named_buffers())
    for name, v in want_stats.items():
        if "running_" in name:
            np.testing.assert_allclose(buffers[name].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def ZERO_BIAS(name):
    """A conv bias right before a norm: its gradient is 0 up to rounding."""
    return name.endswith(".bias") and "norm" not in name and \
        "downsample.1" not in name and name != "conv2.bias"


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_train_mode_encoder_grads_match_float64(norm_fn):
    """The port's fp32 encoder gradients against the same encoder run in
    float64, on the frames of test_torch_training.py's step, where the JAX
    package's fp32 norm backward loses digits: within 1e-5 of each max
    |value|."""
    variables = _oracle_encoder_vars("fnet" if norm_fn == "instance"
                                     else "cnet")
    rng = np.random.RandomState(0)  # test_torch_training._batch's draws
    rng.uniform(size=(2, 64, 64))
    frames = [rng.uniform(0, 255, (2, 64, 64, 3)) for _ in range(2)]
    if norm_fn == "instance":  # fnet sees both frames, cnet frame 1
        frames = [np.concatenate(frames)]
    x = (2.0 * (frames[0] / 255.0) - 1.0).astype(np.float32)
    w = np.random.RandomState(3).randn(len(x), 8, 8, 256).astype(np.float32)
    m32 = _encoder_grads(variables, norm_fn, x, w, torch.float32)
    m64 = _encoder_grads(variables, norm_fn, x, w, torch.float64)
    g64 = dict(m64.named_parameters())
    for name, p in m32.named_parameters():
        if not ZERO_BIAS(name):
            assert _rel(p.grad, g64[name].grad) <= 1e-5, name


# ------------------------------------------------- loss, schedule, optim


def test_sequence_loss_matches_jax(rng):
    preds = (rng.randn(3, 2, 16, 24, 2) * 4).astype(np.float32)
    gt = (rng.randn(2, 16, 24, 2) * 4).astype(np.float32)
    gt[0, :2] = 500.0  # beyond MAX_FLOW: unsupervised
    valid = (rng.uniform(size=(2, 16, 24)) > 0.3).astype(np.float32)
    want, wm = jax_sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                 jnp.asarray(valid), 0.8)
    got, gm = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                            torch.from_numpy(valid), 0.8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(gm) == set(wm)
    for key in wm:
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("num_steps", [100, 1900])
def test_onecycle_schedule_matches_jax(num_steps):
    """Every step's learning rate against the JAX package's schedule: its
    float64 host twin within 1e-12 relative, the optax schedule within 1e-6
    relative plus its own fp32 rounding (a few ulps of the peak rate)."""
    lr = 2.5e-4
    want = onecycle_linear(lr, num_steps + 100)
    want_host = onecycle_linear_host(lr, num_steps + 100)
    opt, sched = make_optimizer([torch.nn.Parameter(torch.zeros(1))], lr,
                                num_steps)
    for step in range(num_steps + 100):
        got = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(got, want_host(step), rtol=1e-12,
                                   err_msg=str(step))
        np.testing.assert_allclose(got, float(want(step)), rtol=1e-6,
                                   atol=4 * 2.0 ** -24 * lr,
                                   err_msg=str(step))
        assert opt.param_groups[0]["betas"] == (0.9, 0.999)
        opt.step()
        sched.step()


def test_optimizer_matches_optax(rng):
    """Three AdamW updates with clipping active (gradient norms of 4-20)
    from identical gradients.  The parameters after each update agree with
    the same optimizer run in float64 to 1e-6 of the update's size, and
    with optax to 2e-5 of it: optax's fp32 bias correction 1 - 0.999^t is
    1.3e-5 off in relative terms (1 - 0.999 in fp32)."""
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 3, 4)}
    init = {k: (rng.randn(*s) * 1e-4).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.3, 1.0, 1.5)]
    lr, wd = 2.5e-3, 0.1
    tx, _ = jax_make_optimizer(lr, 100, wdecay=wd)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt, sched = make_optimizer(params.values(), lr, 100, wdecay=wd)
    params64 = {k: torch.nn.Parameter(torch.from_numpy(v.astype(np.float64)))
                for k, v in init.items()}
    opt64, sched64 = make_optimizer(params64.values(), lr, 100, wdecay=wd)
    for g in grads:
        before = {k: v.copy() for k, v in jax.tree_util.tree_map(
            np.asarray, jp).items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm(list(params.values()), 1.0)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum(
            (v.astype(np.float64) ** 2).sum() for v in g.values()))),
            rtol=1e-6)
        assert float(norm) > 1.0  # the clip is active
        opt.step()
        sched.step()
        for k, p in params64.items():
            p.grad = torch.from_numpy(g[k].astype(np.float64))
        clip_by_global_norm(list(params64.values()), 1.0)
        opt64.step()
        sched64.step()
        for k, p in params.items():
            exact = params64[k].detach().numpy()
            step = np.abs(exact - before[k]).max()
            np.testing.assert_allclose(p.detach().numpy(), exact, rtol=0,
                                       atol=1e-6 * step, err_msg=k)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=2e-5 * step, err_msg=k)


# ---------------------------------------------------------------- dropout


def test_dropout_keeps_its_share_and_scales():
    x = torch.ones(4, 64, 128)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.2, gen)
    kept = y != 0
    n = kept.numel()
    share = float(kept.float().mean())
    assert abs(share - 0.8) < 4 * math.sqrt(0.8 * 0.2 / n)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    again = dropout(x, 0.2, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, y, rtol=0, atol=0)
    assert not torch.equal(dropout(x, 0.2, gen), y)  # the generator moved
    assert dropout(x, 0.0, gen) is x
    xg = torch.randn(2, 8, 8, requires_grad=True)
    yg = dropout(xg, 0.5, torch.Generator().manual_seed(1))
    yg.sum().backward()
    torch.testing.assert_close(xg.grad, (yg != 0).float() * 2.0)


def test_dropout2d_drops_whole_channels():
    x = torch.ones(8, 5, 6, 64, dtype=torch.bfloat16)
    y = dropout2d(x, 0.25, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    per_channel = y.float().reshape(8, 30, 64)
    assert bool((per_channel == per_channel[:, :1]).all())
    share = float((per_channel[:, 0] != 0).float().mean())
    assert abs(share - 0.75) < 4 * math.sqrt(0.75 * 0.25 / (8 * 64))
    kept = per_channel[:, 0][per_channel[:, 0] != 0]
    scale = torch.tensor(1.0, dtype=torch.bfloat16) / 0.75  # in bf16
    torch.testing.assert_close(kept, torch.full_like(kept, float(scale)))
