"""remat_att_sites and drop_path_prob on the CPU (port only).

remat: the training step with the attention sites recomputed in the
backward (``models/flow_model.py:recomputed``) against the same step
keeping their activations, with dropout on: the loss and every gradient
bit-identical, in fp32 and mixed precision, on the sliding-bias path (the
training kernels' plain versions), under lsinu, under --f2radius 3 and on
the diagnostics step; a step with dropout off differs, so the masks were
live.  ``torch.utils.checkpoint`` alone replays only the default
generators, and gives other masks from an explicit one.

drop_path: the identity at rate 0 and in eval mode; at 0.5 each sample's
pooled output reaches the input skip either as 0 or as twice its value
without the drop, both occurring (the JAX package's ``drop_path``).

chip_smoke.step_launches, the exact launches its training phases assert
on the card, against the calls of the kernels' plain versions on the CPU.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import chip_smoke
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import recomputed
from craft_tpu_torch.nn.layers import dropout, layer_norm
from craft_tpu_torch.nn.setrans import ExpandedFeatTrans
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_train_dense import _one_thread  # noqa: F401
from test_torch_train_dense import variant_config, variant_tree

B, HW, ITERS = 2, 64, 2
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.2)


def _batch():
    rng = np.random.RandomState(2)
    return {"image1": torch.from_numpy(rng.uniform(0, 255, (B, HW, HW, 3))
                                       .astype(np.float32)),
            "image2": torch.from_numpy(rng.uniform(0, 255, (B, HW, HW, 3))
                                       .astype(np.float32)),
            "flow": torch.from_numpy((rng.randn(B, HW, HW, 2) * 3)
                                     .astype(np.float32)),
            "valid": torch.ones(B, HW, HW)}


def _step(cfg, sd, remat, attn_diag=False):
    cfg = cfg.replace(remat_att_sites=remat)
    state = create_train_state(cfg, sd, device="cpu", num_steps=100)
    step = make_train_step(cfg, iters=ITERS, seed=3, attn_diag=attn_diag)
    state, metrics = step(state, _batch())
    return host_metrics(metrics), {n: p.grad for n, p in
                                   state.model.named_parameters()}


@pytest.mark.parametrize("case", ["bias fp32", "bias mixed", "lsinu fp32",
                                  "f2radius 3 fp32", "diagnostics fp32"])
def test_remat_is_bit_identical_with_dropout(case):
    variant = case.rsplit(" ", 1)[0]
    mixed = case.endswith("mixed")
    tree = variant_tree(variant)
    cfg = variant_config(tconfig, mixed, variant)
    cfg = cfg.replace(**{site: dataclasses.replace(getattr(cfg, site),
                                                   **DROPOUT)
                         for site in ("inter", "f2", "intra")})
    sd = state_dict_from_flax(tree)
    diag = variant == "diagnostics"
    on, g_on = _step(cfg, sd, True, diag)
    off, g_off = _step(cfg, sd, False, diag)
    assert on == off
    for name, g in g_on.items():
        assert torch.equal(g, g_off[name]), name
    still = cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
        for site in ("inter", "f2", "intra")})
    plain, g_plain = _step(still, sd, True, diag)
    assert plain["loss"] != on["loss"]
    assert not torch.equal(g_plain["f2_trans.setrans.query.weight"],
                           g_on["f2_trans.setrans.query.weight"])


def test_recomputed_replays_an_explicit_generator():
    """Dropout from an explicit generator inside a recomputed function:
    the gradient equals the unrecomputed one; under a bare checkpoint the
    backward draws another mask."""
    x0 = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))

    def fn(x, gen):
        return dropout(x * x, 0.5, gen) * x

    grads = []
    for wrap in (None, "recomputed", "checkpoint"):
        x = x0.clone().requires_grad_()
        gen = torch.Generator().manual_seed(1)
        if wrap is None:
            y = fn(x, gen)
        elif wrap == "recomputed":
            y = recomputed(fn, gen, x, gen)
        else:
            y = checkpoint(fn, x, gen, use_reentrant=False)
        y.sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    assert not torch.equal(grads[0], grads[2])


def _feat_trans(rate):
    cfg = dataclasses.replace(tconfig.f2_trans_config(), in_feat_dim=32,
                              feat_dim=32, drop_path_prob=rate)
    torch.manual_seed(0)
    mod = ExpandedFeatTrans(cfg)
    with torch.no_grad():
        mod.input_skip_coeff.fill_(0.7)
    return mod


def _run(mod, x, probs, seed=5):
    pooled = []
    hook = mod.feat_softaggr.register_forward_hook(
        lambda m, i, out: pooled.append(out))
    out = mod(x, attention=probs,
              generator=torch.Generator().manual_seed(seed))
    hook.remove()
    return out, pooled[0]


@pytest.mark.parametrize("case", ["rate 0", "eval"])
def test_drop_path_is_the_identity_at_zero_and_in_eval(case):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(6, 10, 32, generator=gen)
    probs = torch.softmax(torch.randn(6, 4, 10, 10, generator=gen), -1)
    mod = _feat_trans(0.0 if case == "rate 0" else 0.5)
    mod.train(case == "rate 0")
    out, pooled = _run(mod, x, probs)
    want = layer_norm(0.7 * x + pooled)
    assert torch.equal(out, want)


def test_drop_path_keeps_or_drops_whole_samples():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(16, 10, 32, generator=gen)
    probs = torch.softmax(torch.randn(16, 4, 10, 10, generator=gen), -1)
    mod = _feat_trans(0.5).train()
    out, pooled = _run(mod, x, probs)
    kept = dropped = 0
    for b in range(16):
        if torch.equal(out[b], layer_norm(0.7 * x[b] + 2.0 * pooled[b])):
            kept += 1
        else:
            assert torch.equal(out[b], layer_norm(0.7 * x[b])), b
            dropped += 1
    assert kept and dropped
    # The aggregator's copy of the config never drops (deterministic in the
    # JAX package's update block).
    cfg = dataclasses.replace(tconfig.intra_attn_config(), drop_path_prob=0.3)
    assert tconfig.intra_aggregator_config(cfg).drop_path_prob == 0.0


# The wrappers of the training path's kernels, by module, each called
# once per launch on the card; on the CPU each calls its plain version.
PLAIN = {"mode_attention": ("scores_global_max", "mode_softmax_probs"),
         "corr_vjp": ("fused_agg_corr", "agg_corr_bwd"),
         "probs_vjp": ("probs_bwd",),
         "corr_lookup": ("corr_lookup", "corr_lookup_bwd")}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no remat"])
@pytest.mark.parametrize("variant", ["main", "lsinu", "f2radius", "diag"])
def test_step_launches_counts_each_kernel_call(variant, remat, monkeypatch):
    """chip_smoke.step_launches, the exact launches its training phases
    assert on the card, against the calls of each kernel's plain version
    in one CPU step of chip_smoke's configs (64x64, 2 iterations)."""
    calls, inside = {}, []
    for mod_name, names in PLAIN.items():
        mod = importlib.import_module(
            f"craft_tpu_torch.ops.kernels.{mod_name}")
        for name in names:
            plain = getattr(mod, f"{name}_plain")

            def counted(*a, _plain=plain, _name=name, **kw):
                # A plain version called by another (the lookup's
                # backward by autograd of its forward) is no launch.
                if not inside:
                    calls[_name] = calls.get(_name, 0) + 1
                inside.append(_name)
                try:
                    return _plain(*a, **kw)
                finally:
                    inside.pop()
            monkeypatch.setattr(mod, f"{name}_plain", counted)
    cfg, sd = chip_smoke.variant_weights(
        "main" if variant == "diag" else variant, False)
    cfg = cfg.replace(remat_att_sites=remat)
    state = create_train_state(cfg, sd, device="cpu", num_steps=100)
    make_train_step(cfg, iters=ITERS, attn_diag=variant == "diag")(
        state, _batch())
    assert calls == chip_smoke.step_launches(variant, remat, iters=ITERS)
