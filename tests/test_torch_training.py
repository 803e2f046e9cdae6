"""The port's training step as a whole against the JAX train path on the
CPU: full-width CRAFT with the oracle snapshot's weights at 64x64, batch 2,
2 iterations, dropout rates 0 (the two frameworks' masks cannot match bit
for bit; dropout is tested on its own in test_torch_train_kernels.py).

JAX side: ``FlowModel(train=True)`` + ``sequence_loss`` under
``jax.value_and_grad`` with the batch_stats collection mutable, from the
oracle tree (not ``create_train_state``, whose init takes half a minute),
its gradients clipped with the JAX package's optimizer.  Port side: one
``make_train_step`` step, whose gradients are read after its clip.  Every
gradient is mapped key by key with ``state_dict_from_flax``.
"""

import dataclasses
import re
from pathlib import Path

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

ORACLE = Path(__file__).resolve().parent / "data" / "oracle_craft_128.npz"
B, HW, ITERS = 2, 64, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _no_dropout(cfg):
    return cfg.replace(**{site: dataclasses.replace(getattr(cfg, site),
                                                    **NO_DROPOUT)
                          for site in ("inter", "f2", "intra")})


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    valid = (rng.uniform(size=(B, HW, HW)) > 0.2).astype(np.float32)
    return dict(
        image1=rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
        flow=(rng.randn(B, HW, HW, 2) * 3).astype(np.float32),
        valid=valid)


def _jax_step(mixed_precision, tree, batch):
    """JAX loss, metrics, clipped gradients (as a state_dict), grad norm
    and new batch_stats (as a state_dict)."""
    cfg = _no_dropout(jconfig.craft_config(mixed_precision=mixed_precision))
    model = JaxFlowModel(cfg=cfg, train=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, batch_stats):
        (_, flows), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, jb["image1"],
            jb["image2"], iters=ITERS, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        loss, metrics = jax_sequence_loss(flows.astype(jnp.float32),
                                          jb["flow"], jb["valid"], 0.8)
        return loss, (metrics, upd["batch_stats"])

    (loss, (metrics, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(tree["params"],
                                                   tree["batch_stats"])
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    host = {k: float(v) for k, v in metrics.items()}
    host["loss"] = float(loss)
    host["grad_norm"] = float(optax.global_norm(grads))
    return (host, state_dict_from_flax({"params": clipped}),
            state_dict_from_flax({"batch_stats": stats}))


def _port_step(mixed_precision, tree, batch, freeze_bn=False):
    cfg = _no_dropout(tconfig.craft_config(mixed_precision=mixed_precision))
    state = create_train_state(cfg, state_dict_from_flax(tree), device="cpu",
                               num_steps=100)
    step = make_train_step(cfg, iters=ITERS, freeze_bn=freeze_bn)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return state.model, host_metrics(metrics)


def _grad_errors(model, want_grads):
    """{name: max |grad - want| / max |want|} over every parameter."""
    errs = {}
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        got = p.grad.numpy()
        assert got.shape == want.shape, name
        errs[name] = float(np.abs(got - want).max()
                           / max(np.abs(want).max(), 1e-30))
    return errs


def _group_error(got, want, group):
    """||got - want|| / ||want|| over the gradients of one module group."""
    names = [n for n in got if n.startswith(group)]
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum())
              for n in names)
    den = sum(float((want[n].double() ** 2).sum()) for n in names)
    return (num / den) ** 0.5


# fp32 tolerances: the loss within 1e-5 relative, each gradient within 1e-3
# of its own max |value|.  Named exceptions, with the reason:
#  * a bias right before a normalization (the encoders' convs before
#    InstanceNorm or train-mode BatchNorm) or inside a softmax over modes
#    (feat2score) has a zero gradient; both sides give rounding noise
#    (|g| ~ 1e-9), held within 1e-3 of the model's largest gradient;
#  * cnet: XLA's jitted flax BatchNorm backward (E[x^2] - E[x]^2, fused)
#    loses digits; the same step run unjitted agrees with the port to 3e-6
#    relative, and test_torch_train_kernels.py holds the port's cnet
#    gradients against float64 and unjitted flax to 1e-5;
#  * fnet weights: flax's InstanceNorm backward (E[x^2] - E[x]^2) loses
#    digits where the port's agrees with a float64 run to 2e-6 (the same
#    test file).
FP32_LOSS_RTOL, FP32_GRAD_TOL = 1e-5, 1e-3
ZERO_GRAD = re.compile(r"^(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|"
                       r"downsample\.0))\.bias$|feat2score\.bias$")
FP32_GRAD_EXCEPTIONS = ((re.compile(r"^cnet\."), 1e-1),
                        (re.compile(r"^fnet\..*weight$"), 2e-2))
# Mixed precision runs the encoders, attention and update block in bf16
# (8 bits of mantissa) in both frameworks, which round at other places (and
# the port's probs backward starts from the saved bf16 probs where XLA
# differentiates its fp32 softmax).  bf16 moves JAX's own gradients, against
# its fp32 run, by 2e-2 (update block) to 3.6e-1 (fnet) in the norm of a
# module group.  The port's mixed gradients must stay within that spread of
# JAX's mixed ones (times 1.25), group by group; the loss within 1e-2.
GROUPS = ("fnet", "cnet", "f2_trans", "att", "corr_fn", "update_block")
BF16_LOSS_RTOL, BF16_SPREAD = 1e-2, 1.25


@pytest.fixture(scope="module")
def oracle_tree():
    return load_oracle_npz(ORACLE)[3]


@pytest.fixture(scope="module")
def jax_fp32(oracle_tree):
    return _jax_step(False, oracle_tree, _batch())


def test_fp32_train_step_matches_jax(oracle_tree, jax_fp32):
    want, want_grads, want_stats = jax_fp32
    model, got = _port_step(False, oracle_tree, _batch())
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
    for name, p in model.named_parameters():
        want_g = want_grads[name].numpy()
        if ZERO_GRAD.search(name):
            assert np.abs(p.grad.numpy() - want_g).max() <= 1e-3 * gmax, name
            continue
        tol = next((t for pat, t in FP32_GRAD_EXCEPTIONS
                    if pat.search(name)), FP32_GRAD_TOL)
        assert errs[name] <= tol, (name, errs[name])
    buffers = dict(model.named_buffers())
    for name, want_v in want_stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[name].numpy(),
                                       want_v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_mixed_precision_train_step_matches_jax(oracle_tree, jax_fp32):
    want32, grads32, _ = jax_fp32
    want, want_grads, want_stats = _jax_step(True, oracle_tree, _batch())
    model, got = _port_step(True, oracle_tree, _batch())
    print({k: (got[k], want[k], want32[k]) for k in want})
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
    buffers = dict(model.named_buffers())
    for name, want_v in want_stats.items():
        if not name.endswith("num_batches_tracked"):
            # bf16 activations: the batch moments agree to a few ulps.
            np.testing.assert_allclose(buffers[name].numpy(),
                                       want_v.numpy(), rtol=2e-2,
                                       atol=2e-3, err_msg=name)


def test_freeze_bn_keeps_batch_stats(oracle_tree):
    model, got = _port_step(False, oracle_tree, _batch(), freeze_bn=True)
    assert np.isfinite(got["loss"])
    sd = state_dict_from_flax(oracle_tree)
    for name, buf in model.named_buffers():
        if "running_" in name:
            torch.testing.assert_close(buf, sd[name], rtol=0, atol=0)
