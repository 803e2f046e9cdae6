"""The port's training step under learned sinusoid codes (--interpos
--intrapos lsinu) against the JAX train path on the CPU, in fp32 and in
mixed precision, as tests/test_torch_training.py holds the sliding-bias
step: full-width CRAFT at 64x64, batch 2, 2 iterations, dropout rates 0,
the oracle snapshot's weights with each site's window replaced by seeded
pos_fc weights, and the same bounds: in fp32 the loss and every gradient
outside the encoders, pos_fc's among them, to JAX's; in mixed precision
each module group's gradient within 1.25 times JAX's own bf16-against-fp32
spread.  The encoders' fp32 gradients are held as the repository holds
them where JAX's norm backward loses digits (tests/
test_torch_train_kernels.py): each tensor within 1e-5 of the same encoder
run in float64 on the step's own inputs and output cotangent, and each
encoder's gradient within test_torch_training.py's per-tensor bound for
it (fnet 2e-2, cnet 1e-1) of JAX's in the norm of the group, which
holds the cotangent.  On the lsinu step's fnet cotangent JAX's fp32
fnet.layer2.1.conv2 gradient is 2.9e-2 from float64, the port's 1.7e-6.
The step's attention sites run the plain path (stock autograd over the
fp32 scores), recomputed in the backward (remat_att_sites, the default).
``tests/test_torch_train_dense_mask.py`` and ``_dense_both.py`` run
--f2radius 3, alone and with lsinu, through the same functions (one file
each, to spread the JAX compiles over the workers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu.training.loss import sequence_loss as jax_sequence_loss
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax
from test_torch_train_kernels import (ZERO_BIAS, _encoder_grads,
                                      _oracle_encoder_vars, _rel)
from test_torch_training import (BF16_LOSS_RTOL, BF16_SPREAD,
                                 FP32_GRAD_TOL, FP32_LOSS_RTOL, GROUPS,
                                 ITERS, ORACLE, ZERO_GRAD, _batch,
                                 _grad_errors, _group_error, _no_dropout)

SITES = {"inter": "corr_fn", "f2": "f2_trans", "intra": "att"}
TOKEN_DIMS = {"corr_fn": 256, "f2_trans": 256, "att": 128}
POS_FC_STD = 2.0  # O(1) phases across the grid, as chip_smoke.py seeds
# encoder: (norm, bound on the group's gradient against JAX's)
ENCODERS = {"fnet": ("instance", 2e-2), "cnet": ("batch", 1e-1)}
ENCODER_F64_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's steps: under pytest-xdist the
    workers share the cores, and every extra spinning thread slows them
    all.  The other files of these tests import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant_config(m, mixed, variant):
    """craft_config of the package `m` (the JAX or the port's config
    module) under `variant`, dropout rates 0."""
    cfg = m.craft_config(mixed_precision=mixed)
    if "lsinu" in variant:
        cfg = cfg.replace(**{site: dataclasses.replace(
            getattr(cfg, site), pos_code_type="lsinu") for site in SITES})
    if "f2radius" in variant:
        cfg = cfg.replace(f2=dataclasses.replace(cfg.f2, attn_mask_radius=3))
    return _no_dropout(cfg)


def variant_tree(variant):
    """The oracle tree; under lsinu each site's window replaced by seeded
    pos_fc weights ~ N(0, POS_FC_STD^2)."""
    tree = load_oracle_npz(ORACLE)[3]
    if "lsinu" in variant:
        rng = np.random.RandomState(7)
        for site, dim in TOKEN_DIMS.items():
            enc = tree["params"][site]["vispos_encoder"]
            enc["pos_coder"] = {"pos_fc": {"Dense_0": {
                "kernel": (rng.randn(2, dim) * POS_FC_STD).astype(np.float32),
                "bias": (rng.randn(dim) * POS_FC_STD).astype(np.float32)}}}
    return tree


def jax_step(variant, mixed, tree, batch):
    """JAX loss, metrics, clipped gradients (a state_dict), grad norm."""
    model = JaxFlowModel(cfg=variant_config(jconfig, mixed, variant),
                         train=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, batch_stats):
        (_, flows), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, jb["image1"],
            jb["image2"], iters=ITERS, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_sequence_loss(flows.astype(jnp.float32), jb["flow"],
                                 jb["valid"], 0.8)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree["params"], tree["batch_stats"])
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    host = {k: float(v) for k, v in metrics.items()}
    host["loss"] = float(loss)
    host["grad_norm"] = float(optax.global_norm(grads))
    return host, state_dict_from_flax({"params": clipped})


@functools.lru_cache(maxsize=None)
def jax_result(variant, mixed):
    """jax_step on the variant's tree and test_torch_training's batch."""
    return jax_step(variant, mixed, variant_tree(variant), _batch())


def port_step(variant, mixed, tree, batch, seen=None):
    """(model after the step, host metrics); `seen`, a dict, receives each
    encoder's input and the cotangent of its output."""
    cfg = variant_config(tconfig, mixed, variant)
    assert cfg.remat_att_sites
    state = create_train_state(cfg, state_dict_from_flax(tree), device="cpu",
                               num_steps=100)
    if seen is not None:
        for name in ENCODERS:
            def hook(mod, inputs, out, name=name):
                seen[name] = [inputs[0].detach().numpy()]
                out.register_hook(lambda g: seen[name].append(
                    g.detach().numpy()))
            getattr(state.model, name).register_forward_hook(hook)
    state, metrics = make_train_step(cfg, iters=ITERS)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state.model, host_metrics(metrics)


def _code_params(model, variant):
    """The positional codes' parameters: pos_fc's under lsinu, else the
    f2 site's sliding window (reached through the dense table)."""
    key = "pos_fc" if "lsinu" in variant else "f2_trans.vispos_encoder." \
        "pos_coder.biases"
    names = [n for n, _ in model.named_parameters() if key in n]
    assert names
    return names


def check_fp32(variant):
    want, want_grads = jax_result(variant, False)
    seen = {}
    model, got = port_step(variant, False, variant_tree(variant), _batch(),
                           seen)
    print({k: (got[k], want[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=FP32_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    for key in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    errs = _grad_errors(model, want_grads)
    print("worst:", sorted(errs.items(), key=lambda kv: -kv[1])[:8])
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads.items():
        if name.split(".")[0] in ENCODERS:
            continue
        if ZERO_GRAD.search(name):
            want_g = want_grads[name].numpy()
            assert np.abs(g.numpy() - want_g).max() <= 1e-3 * gmax, name
            continue
        assert errs[name] <= FP32_GRAD_TOL, (name, errs[name])
    # The step's gradients are clipped to a global norm of 1.
    scale = min(1.0, 1.0 / got["grad_norm"])
    for enc, (norm_fn, group_tol) in ENCODERS.items():
        err = _group_error(grads, want_grads, enc)
        print(f"{enc}: port vs JAX {err:.3e}")
        assert err <= group_tol, enc
        x, cot = seen[enc]
        m64 = _encoder_grads(_oracle_encoder_vars(enc), norm_fn, x, cot,
                             torch.float64)
        for name, p in m64.named_parameters():
            if not ZERO_BIAS(name):
                rel = _rel(grads[f"{enc}.{name}"], p.grad * scale)
                assert rel <= ENCODER_F64_TOL, (enc, name, rel)
    for name in _code_params(model, variant):
        assert np.abs(want_grads[name].numpy()).max() > 0, name
        assert errs[name] <= FP32_GRAD_TOL, (name, errs[name])
    return want


def check_mixed(variant):
    _, grads32 = jax_result(variant, False)
    want, want_grads = jax_result(variant, True)
    model, got = port_step(variant, True, variant_tree(variant), _batch())
    print({k: (got[k], want[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=5e-2)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for group in GROUPS:
        spread = _group_error(want_grads, grads32, group)
        err = _group_error(grads, want_grads, group)
        print(f"{group}: port vs JAX {err:.3e}, JAX bf16 vs fp32 "
              f"{spread:.3e}")
        assert err <= BF16_SPREAD * spread, group
    assert _code_params(model, variant)


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
def test_lsinu_train_step_matches_jax(mixed):
    (check_mixed if mixed else check_fp32)("lsinu")
