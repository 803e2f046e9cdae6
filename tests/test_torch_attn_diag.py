"""The --attn_diag step (``make_train_step(attn_diag=True)``) against the
JAX package's on the CPU: full-width CRAFT at 64x64 from the oracle tree
(under lsinu with seeded pos_fc weights), batch 2, 2 iterations, fp32,
dropout rates 0.  attn_max, attn_clamp_frac and attn_avg_abs within 1e-5
relative of the JAX step's, with attn_clip at its default (no site
clamps) and at 1.0 (every site's scores pass it, so each clamps), and the
loss as tests/test_torch_training.py holds it.

``tests/test_torch_attn_diag_lsinu.py`` runs the same check under lsinu.
Then which path each site takes, counted on the port alone: the fast
step keeps the training kernels wherever a site has the sliding bias and
no mask, and the diagnostics step sends every site through the plain
path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.training.optim import make_optimizer as jax_make_optimizer
from craft_tpu.training.train_step import TrainState
from craft_tpu.training.train_step import make_train_step as jax_train_step
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.nn.setrans import CrossAttFeatTrans
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_train_dense import _one_thread  # noqa: F401
from test_torch_train_dense import SITES, variant_config, variant_tree
from test_torch_training import FP32_LOSS_RTOL, ITERS, _batch

DIAG_RTOL = 1e-5
CLAMP_CLIP = 1.0  # below every site's largest score on these frames
DIAG_KEYS = ("attn_max", "attn_clamp_frac", "attn_avg_abs")


def _with_clip(cfg, clip):
    if clip is None:
        return cfg
    return cfg.replace(**{site: dataclasses.replace(getattr(cfg, site),
                                                    attn_clip=clip)
                          for site in SITES})


def _jax_diag(variant, clip, tree, batch):
    cfg = _with_clip(variant_config(jconfig, False, variant), clip)
    tx, _ = jax_make_optimizer(2.5e-4, 100)
    params = tree["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=tree["batch_stats"],
                       opt_state=tx.init(params))
    step = jax.jit(jax_train_step(cfg, tx, iters=ITERS, attn_diag=True))
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    return {k: float(v) for k, v in metrics.items()}


def check_diagnostics(variant, clip):
    tree, batch = variant_tree(variant), _batch()
    want = _jax_diag(variant, clip, tree, batch)
    cfg = _with_clip(variant_config(tconfig, False, variant), clip)
    state = create_train_state(cfg, state_dict_from_flax(tree), device="cpu",
                               num_steps=100)
    _, metrics = make_train_step(cfg, iters=ITERS, attn_diag=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = host_metrics(metrics)
    print({k: (got[k], want[k]) for k in DIAG_KEYS + ("loss",)})
    for key in DIAG_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=DIAG_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=FP32_LOSS_RTOL)
    clamped = clip is not None
    assert (want["attn_max"] > (clip or 100.0)) == clamped
    assert (want["attn_clamp_frac"] > 0) == clamped
    assert want["attn_avg_abs"] > 0


@pytest.mark.parametrize("clip", [None, CLAMP_CLIP], ids=["default", "1.0"])
def test_diagnostics_step_matches_jax(clip):
    check_diagnostics("bias", clip)


@pytest.mark.parametrize("case", ["bias fast", "bias diagnostics",
                                  "lsinu fast", "f2radius 3 fast"])
def test_which_sites_take_the_plain_path(case, monkeypatch):
    """Each site's training branch, counted over one step's forward and
    its recompute: under the sliding bias the fast step runs none of the
    plain path; the diagnostics step runs it at all three sites and the
    training kernels at none; lsinu runs it at all three, --f2radius
    at the f2 site alone."""
    variant, kind = case.rsplit(" ", 1)
    calls = {"plain": [], "kernels": []}
    for branch, method in (("plain", "_plain_train_forward"),
                           ("kernels", "_train_forward")):
        orig = getattr(CrossAttFeatTrans, method)

        def counted(self, *a, _orig=orig, _branch=branch, **kw):
            calls[_branch].append(self.cfg)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(CrossAttFeatTrans, method, counted)
    cfg = variant_config(tconfig, False, variant)
    state = create_train_state(cfg, state_dict_from_flax(
        variant_tree(variant)), device="cpu", num_steps=100)
    step = make_train_step(cfg, iters=ITERS,
                           attn_diag=kind == "diagnostics")
    step(state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    n_plain = len({id(c) for c in calls["plain"]})
    n_kernels = len({id(c) for c in calls["kernels"]})
    want_plain = {"bias fast": 0, "bias diagnostics": 3, "lsinu fast": 3,
                  "f2radius 3 fast": 1}[case]
    assert (n_plain, n_kernels) == (want_plain, 3 - want_plain)
    if case == "f2radius 3 fast":
        assert all(c.attn_mask_radius == 3 for c in calls["plain"])
