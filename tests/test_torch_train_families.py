"""One fp32 training step of RAFT, GMA and craft_nogma, port against the
JAX train path on the CPU (64x64, batch 2, 2 iterations, dropout off),
with the tolerances of tests/test_torch_training.py; and the packed step
(upsample_mode='packed', ``sequence_loss_packed``) against JAX's packed
step (RAFT) and against the port's own 'all' step (full CRAFT).

The weights are each family's tree of tests/test_torch_families.py.  The
JAX side is ``FlowModel(train=True)`` + the sequence loss under
``jax.value_and_grad`` with batch_stats mutable, its gradients clipped
with the JAX package's optimizer; the port side is one ``make_train_step``
step, whose gradients are read after its clip.  The encoders, where
flax's fp32 norm backward loses digits, are held as
tests/test_torch_train_dense.py holds them: each tensor within 1e-5 of
the same encoder run in float64 on the step's own input and output
cotangent, and the group within fnet 2e-2, cnet 1e-1 of JAX's in its norm
(craft_nogma's fnet.layer1.1.conv2 gradient: JAX's 2.2e-2 from the
port's, which is within 1e-5 of float64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu.training import loss as jloss
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import (load_oracle_npz,
                                           state_dict_from_flax)
from test_torch_families import ORACLE, configs, family_tree
from test_torch_train_dense import ENCODER_F64_TOL, ENCODERS
from test_torch_train_kernels import (ZERO_BIAS, _encoder_grads,
                                      _oracle_encoder_vars, _rel)
from test_torch_training import (FP32_GRAD_TOL, FP32_LOSS_RTOL, ZERO_GRAD,
                                 _grad_errors, _group_error)

B, HW, ITERS = 2, 64, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _no_dropout(cfg):
    return cfg.replace(**{site: dataclasses.replace(getattr(cfg, site),
                                                    **NO_DROPOUT)
                          for site in ("inter", "f2", "intra")})


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        image1=rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
        flow=(rng.randn(B, HW, HW, 2) * 3).astype(np.float32),
        valid=(rng.uniform(size=(B, HW, HW)) > 0.2).astype(np.float32))


def _jax_step(name, batch, upsample_mode="all"):
    """JAX metrics, clipped gradients and new batch_stats (state_dicts)."""
    jcfg, _ = configs(name, False)
    model = JaxFlowModel(cfg=_no_dropout(jcfg), train=True)
    tree = jax.tree.map(jnp.asarray, family_tree(name))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_impl = (jloss.sequence_loss_packed if upsample_mode == "packed"
                 else jloss.sequence_loss)

    def loss_fn(params, batch_stats):
        (_, flows), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, jb["image1"],
            jb["image2"], iters=ITERS, upsample_mode=upsample_mode,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        loss, metrics = loss_impl(flows.astype(jnp.float32), jb["flow"],
                                  jb["valid"], 0.8)
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


def _port_step(cfg, sd, batch, upsample_mode=None, seen=None):
    """(model after the step, host metrics); `seen`, a dict, receives the
    input and the output cotangent of each encoder."""
    cfg = _no_dropout(cfg)
    state = create_train_state(cfg, sd, device="cpu", num_steps=100)
    if seen is not None:
        for name in ENCODERS:
            def hook(mod, inputs, out, name=name):
                seen[name] = [inputs[0].detach().numpy()]
                out.register_hook(lambda g: seen[name].append(
                    g.detach().numpy()))
            getattr(state.model, name).register_forward_hook(hook)
    step = make_train_step(cfg, iters=ITERS, upsample_mode=upsample_mode)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return state.model, host_metrics(metrics)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hold(model, got, want, want_grads, want_stats, seen):
    """tests/test_torch_training.py's fp32 bounds; the encoders against
    float64 and JAX's, as the module docstring says."""
    print({k: (got[k], want[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=FP32_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    for key in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    errs = _grad_errors(model, want_grads)
    print("worst:", sorted(errs.items(), key=lambda kv: -kv[1])[:6])
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


# The batch each family's step takes.  On batch 0 GMA's second iteration
# puts one flow-head pre-activation at 7.5e-9 from zero, where 1e-7 of
# rounding flips its ReLU's derivative and moves the update block's
# gradients by up to 1 % in either framework (with that forward's
# attention held constant the two agree to 2e-7, and each GMA module's
# gradient agrees with JAX's to 1e-6 on its own); batch 1 has no
# pre-activation that close to a kink.
STEP_BATCH = {"raft": 0, "gma": 1, "craft_nogma": 0}


@pytest.mark.parametrize("name", ["raft", "gma", "craft_nogma"])
def test_fp32_train_step_matches_jax(name):
    batch = _batch(STEP_BATCH[name])
    want, want_grads, want_stats = _jax_step(name, batch)
    _, tcfg = configs(name, False)
    seen = {}
    model, got = _port_step(tcfg, state_dict_from_flax(family_tree(name)),
                            batch, seen=seen)
    if name == "gma":
        # Content-only attention leaves pos_emb out of the loss in both.
        assert not model.att.pos_emb.rel_height.weight.grad.any()
        assert model.update_block.aggregator.gamma.grad.abs().item() > 0
    _hold(model, got, want, want_grads, want_stats, seen)


def test_packed_train_step_matches_jax():
    batch = _batch(1)
    want, want_grads, want_stats = _jax_step("raft", batch, "packed")
    _, tcfg = configs("raft", False)
    seen = {}
    model, got = _port_step(tcfg, state_dict_from_flax(family_tree("raft")),
                            batch, upsample_mode="packed", seen=seen)
    _hold(model, got, want, want_grads, want_stats, seen)


def test_packed_train_step_equals_all_step():
    """Full CRAFT (the oracle tree, fp32): the packed step's loss, metrics
    and gradients against the 'all' step's, within fp32 rounding (the loss
    sums the same terms in another order)."""
    sd = state_dict_from_flax(load_oracle_npz(ORACLE)[3])
    cfg = tconfig.craft_config(mixed_precision=False)
    batch = _batch(2)
    m_all, got_all = _port_step(cfg, sd, batch, upsample_mode="all")
    m_packed, got = _port_step(cfg.replace(upsample_mode="packed"), sd,
                               batch)
    for key in got_all:
        np.testing.assert_allclose(got[key], got_all[key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for (name, p), q in zip(m_packed.named_parameters(),
                            m_all.parameters()):
        err = float((p.grad - q.grad).abs().max()
                    / q.grad.abs().max().clamp(min=1e-30))
        assert err <= 1e-4 or ZERO_GRAD.search(name), (name, err)
    with pytest.raises(ValueError, match="'all' or 'packed'"):
        make_train_step(cfg, upsample_mode="final")
