"""The kernel-against-plain checks of chip_smoke.py (its phase 2), run on
the CPU at a small ragged grid.  On CPU tensors each wrapper takes its plain
version, so the checks pass as they are; with a fault planted in a wrapper
(the sliding bias dropped, the clamp ignored, or for the training kernels
the backward's clamp mask, its agg_w term or its softmax row term dropped)
they must fail.  On the card the same checks also plant the faults in the
plain versions and fail unless their bounds catch them.
"""

import functools

import pytest
import torch

import chip_smoke
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv

GRID = (6, 20)  # U = 120: not a multiple of the kernels' 64-row tiles
CPU = torch.device("cpu")


def _run(seed=0):
    report = {fn.__name__: {} for fn in ma.KERNELS}
    gen = torch.Generator().manual_seed(seed)
    chip_smoke.check_kernels(CPU, gen, report, grid=GRID)
    return report


def test_checks_pass_the_plain_versions():
    report = _run()
    # Only bf16 rounding is left where a bf16 output meets an fp32 plain one.
    for name, r in report.items():
        assert 0.0 <= r["max_abs_err"] < 0.1, name


def _no_bias(plain, pos_w_at):
    def faulty(*args, **kwargs):
        args = list(args)
        args[pos_w_at] = 0.0
        return plain(*args, **kwargs)
    return faulty


def _no_clamp(plain, clip_at, off):
    def faulty(*args, **kwargs):
        args = list(args)
        args[clip_at] = off(args[clip_at])
        return plain(*args, **kwargs)
    return faulty


_OFF_T = functools.partial(torch.full_like, fill_value=chip_smoke.CLIP_OFF)
# wrapper name -> (plain version, index of clip, of pos_w, clip off value)
_SITES = {
    "flash_mode_attention": (ma.flash_mode_attention_plain, 5, 6, _OFF_T),
    "fused_agg_corr_norm": (ma.fused_agg_corr_norm_plain, 4, 5,
                            lambda _: chip_smoke.CLIP_OFF),
    "mode_softmax_probs": (ma.mode_softmax_probs_plain, 4, 5, _OFF_T),
}


@pytest.mark.parametrize("fault", ["no bias", "no clamp"])
@pytest.mark.parametrize("wrapper", sorted(_SITES))
def test_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper, fault):
    plain, clip_at, pos_w_at, off = _SITES[wrapper]
    faulty = (_no_bias(plain, pos_w_at) if fault == "no bias"
              else _no_clamp(plain, clip_at, off))
    monkeypatch.setattr(ma, wrapper, faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


def test_hold_fails_a_bound_that_misses_a_fault():
    want = torch.ones(3)
    with pytest.raises(AssertionError, match="misses"):
        chip_smoke.hold("x", want, want, chip_smoke.rel_err, 1e-2,
                        {"no bias": want * 1.001})


# ------------------------------------------------- the training kernels

TRAIN_GRID, TRAIN_BATCH = (5, 12), 2


def _run_train(seed=0):
    report = {name: {} for name in ("fused_agg_corr", "agg_corr_bwd",
                                    "probs_bwd")}
    gen = torch.Generator().manual_seed(seed)
    chip_smoke.check_train_kernels(CPU, gen, report, grid=TRAIN_GRID,
                                   batch=TRAIN_BATCH)
    return report


def test_train_checks_pass_the_plain_versions():
    report = _run_train()
    for name, r in report.items():
        assert r["max_abs_err"] == 0.0, name


def _b6_fwd_fault(fault):
    def faulty(q, k, biases, grid, clip, pos_w, agg_w, agg_b):
        if fault == "no bias":
            pos_w = 0.0
        else:
            clip = chip_smoke.CLIP_OFF
        return cv.fused_agg_corr_plain(q, k, biases, grid, clip, pos_w,
                                       agg_w, agg_b)
    return faulty


def _b6_bwd_fault(fault):
    def faulty(q, k, g, vol, biases, grid, clip, pos_w, agg_w):
        _, da = cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip,
                                      pos_w, agg_w)
        dc = chip_smoke._b6_dc_fault(
            q, k, g, vol, biases, grid, clip, agg_w,
            drop_term=fault == "t = p", mask=fault != "no clamp mask")
        return dc, da
    return faulty


def _b7_bwd_fault(fault):
    def faulty(q, k, p, g, clip):
        return chip_smoke._b7_fault(q, k, p, g, clip,
                                    row_term=fault != "no row term",
                                    mask=fault != "no clamp mask")
    return faulty


_TRAIN_SITES = {
    ("fused_agg_corr", "no bias"): (cv, _b6_fwd_fault),
    ("fused_agg_corr", "no clamp"): (cv, _b6_fwd_fault),
    ("agg_corr_bwd", "no clamp mask"): (cv, _b6_bwd_fault),
    ("agg_corr_bwd", "t = p"): (cv, _b6_bwd_fault),
    ("probs_bwd", "no clamp mask"): (pv, _b7_bwd_fault),
    ("probs_bwd", "no row term"): (pv, _b7_bwd_fault),
}


@pytest.mark.parametrize("wrapper,fault", sorted(_TRAIN_SITES))
def test_train_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                   fault):
    module, make = _TRAIN_SITES[(wrapper, fault)]
    monkeypatch.setattr(module, wrapper, make(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_train()
