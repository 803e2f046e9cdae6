"""One training step at mode counts other than 4, port against the JAX
train path on the CPU: the modes_mixed configuration (--intermodes 2
--f2modes 16 --intramodes 1: B6 and its backward at two modes, B4 and B7
at md 16 and at md 128, the inter site's mode softmax, the f2 site's
sixteen first-linear blocks, the intra aggregator at one mode) with the
tree of tests/test_torch_modes.py, at 64x64, batch 2, 2 iterations,
dropout rates 0, fp32 and mixed precision, at tests/test_torch_training.py's
bounds (its helpers and tolerances); the encoders' fp32 gradients, where
JAX's norm backward loses digits, as tests/test_torch_train_dense.py holds
them: each tensor within 1e-5 of the same encoder run in float64 on the
step's own inputs and output cotangent, each encoder's group within its
bound of JAX's.  The tree's encoders are the oracle's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu.training.loss import sequence_loss as jax_sequence_loss
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_modes import _one_thread, configs, modes_tree  # noqa: F401
from test_torch_train_dense import ENCODER_F64_TOL, ENCODERS
from test_torch_train_kernels import (ZERO_BIAS, _encoder_grads,
                                      _oracle_encoder_vars, _rel)
from test_torch_training import (BF16_LOSS_RTOL, BF16_SPREAD, FP32_GRAD_TOL,
                                 FP32_LOSS_RTOL, GROUPS, ITERS, ZERO_GRAD,
                                 _batch, _grad_errors, _group_error,
                                 _no_dropout)

NAME = "modes_mixed"


def _jax_step(mixed_precision, tree, batch):
    jcfg, _ = configs(NAME, mixed_precision)
    model = JaxFlowModel(cfg=_no_dropout(jcfg), train=True)
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


def _port_step(mixed_precision, tree, batch, seen=None):
    """(model after the step, host metrics); `seen`, a dict, receives each
    encoder's input and the cotangent of its output."""
    _, tcfg = configs(NAME, mixed_precision)
    cfg = _no_dropout(tcfg)
    state = create_train_state(cfg, state_dict_from_flax(tree), device="cpu",
                               num_steps=100)
    if seen is not None:
        for name in ENCODERS:
            def hook(mod, inputs, out, name=name):
                seen[name] = [inputs[0].detach().numpy()]
                out.register_hook(lambda g: seen[name].append(
                    g.detach().numpy()))
            getattr(state.model, name).register_forward_hook(hook)
    step = make_train_step(cfg, iters=ITERS)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return state.model, host_metrics(metrics)


@pytest.fixture(scope="module")
def jax_fp32():
    return _jax_step(False, modes_tree(NAME), _batch())


def test_fp32_train_step_matches_jax(jax_fp32):
    want, want_grads, want_stats = jax_fp32
    seen = {}
    model, got = _port_step(False, modes_tree(NAME), _batch(), seen)
    print({k: (got[k], want[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=FP32_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
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
    buffers = dict(model.named_buffers())
    for name, want_v in want_stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[name].numpy(),
                                       want_v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_mixed_precision_train_step_matches_jax(jax_fp32):
    _, grads32, _ = jax_fp32
    want, want_grads, _ = _jax_step(True, modes_tree(NAME), _batch())
    model, got = _port_step(True, modes_tree(NAME), _batch())
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
