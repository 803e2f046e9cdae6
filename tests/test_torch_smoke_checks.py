"""The kernel-against-plain checks of chip_smoke.py (its phase 2), run on
the CPU at a small ragged grid.  On CPU tensors each wrapper takes its plain
version, so the checks pass as they are; with a fault planted in a wrapper
(the sliding bias dropped, or the clamp ignored) they must fail.  On the
card the same checks also plant both faults in the plain versions and fail
unless their bounds catch them.
"""

import functools

import pytest
import torch

import chip_smoke
from craft_tpu_torch.ops.kernels import mode_attention as ma

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
