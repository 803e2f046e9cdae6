"""The port's two-way training step (--f1, arch 'craft') as a whole
against the JAX train path on the CPU, at ``tests/test_torch_training.py``'s
size (64x64, batch 2, 2 iterations, dropout rates 0) and bounds: fp32
under 'private' (the loss within 1e-5 relative, each gradient within 1e-3
of its own largest value, the named exceptions of that file), mixed
precision under 'shared' (the loss within 1e-2, each module group's
gradients within 1.25 times JAX's own bf16-against-fp32 spread).  The f1
site trains through the same kernels' plain versions as the f2 site (B1,
B4 float, B7), the inter site once a direction (B6 and its backward), and
the lookup through B5's backward at D = 2.  Weights:
``test_torch_two_way.two_way_tree``.
"""

import functools

import numpy as np

import craft_tpu.config as jconfig
import craft_tpu_torch.config as tconfig
from test_torch_training import (BF16_LOSS_RTOL, BF16_SPREAD,
                                 FP32_GRAD_EXCEPTIONS, FP32_GRAD_TOL,
                                 FP32_LOSS_RTOL, ZERO_GRAD, _batch,
                                 _group_error, _jax_step, _port_step)
from test_torch_two_way import _one_thread, two_way_tree  # noqa: F401

GROUPS = ("fnet", "cnet", "f1_trans", "f2_trans", "att", "corr_fn",
          "update_block")


# The presets of both packages, before a test binds f1trans into them.
CRAFT_CONFIGS = (jconfig.craft_config, tconfig.craft_config)


def _steps(f1, mixed_precision, monkeypatch):
    """(JAX (metrics, grads, stats), port (model, metrics)) of one step of
    the test_torch_training step functions, their presets given --f1."""
    for module, make in zip((jconfig, tconfig), CRAFT_CONFIGS):
        monkeypatch.setattr(module, "craft_config",
                            functools.partial(make, f1trans=f1))
    tree = two_way_tree(f1)
    return (_jax_step(mixed_precision, tree, _batch()),
            _port_step(mixed_precision, tree, _batch()))


def test_fp32_two_way_train_step_matches_jax(monkeypatch):
    (want, want_grads, want_stats), (model, got) = _steps("private", False,
                                                          monkeypatch)
    print({k: (got[k], want[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=FP32_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("f1_trans.") for n in names)
    for name, p in model.named_parameters():
        want_g = want_grads[name].numpy()
        got_g = p.grad.numpy()
        assert got_g.shape == want_g.shape, name
        if ZERO_GRAD.search(name):
            assert np.abs(got_g - want_g).max() <= 1e-3 * gmax, name
            continue
        err = float(np.abs(got_g - want_g).max()
                    / max(np.abs(want_g).max(), 1e-30))
        tol = next((t for pat, t in FP32_GRAD_EXCEPTIONS
                    if pat.search(name)), FP32_GRAD_TOL)
        assert err <= tol, (name, err)
    buffers = dict(model.named_buffers())
    for name, want_v in want_stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[name].numpy(),
                                       want_v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_mixed_two_way_train_step_matches_jax(monkeypatch):
    """'shared': the one f2_trans module takes the gradients of both of
    its calls (the JAX tree has f2_trans alone)."""
    (want32, grads32, _), _ = _steps("shared", False, monkeypatch)
    (want, want_grads, _), (model, got) = _steps("shared", True,
                                                 monkeypatch)
    print({k: (got[k], want[k], want32[k]) for k in want})
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=BF16_LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert not any(n.startswith("f1_trans.") for n in grads)
    for group in (g for g in GROUPS if g != "f1_trans"):
        spread = _group_error(want_grads, grads32, group)
        err = _group_error(grads, want_grads, group)
        print(f"{group}: port vs JAX {err:.3e}, JAX bf16 vs fp32 "
              f"{spread:.3e}")
        assert err <= BF16_SPREAD * spread, group
