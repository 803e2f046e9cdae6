"""chip_smoke.py's checks of the kernels at mode counts other than 4
(``check_mode_kernels``: the four-mode checks at each count), run on the
CPU at small grids: on CPU tensors the wrappers take their plain versions,
so the checks pass as they are; with a fault planted in a wrapper they
must fail: the modes past the first group
of four dropped (B3, B6, B6 dense, B9, B6 backward's dc), q's first two
64-wide md chunks swapped (B1, B2, B8, B3, B4, B4 dense, B7), B6
backward's dc written into the next mode's plane.  Also every
configuration of the phase builds from the CLI's flags and loads its
weights (``chip_smoke.mode_weights``) strictly.
"""

import pytest
import torch

import chip_smoke
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv
from test_torch_smoke_checks import _one_thread  # noqa: F401

CPU = torch.device("cpu")
GRID, TRAIN_GRID = (4, 24), (4, 20)
MODULES = {"scores_global_max": ma, "flash_mode_attention": ma,
           "flash_mode_attention_dense": ma, "fused_agg_corr_norm": ma,
           "mode_softmax_probs": ma, "mode_softmax_probs_dense": ma,
           "corr_norm_sums": ma, "corr_norm_write": ma,
           "fused_agg_corr": cv, "fused_agg_corr_dense": cv,
           "agg_corr_bwd": cv, "probs_bwd": pv}
FAULT_IDS = {chip_smoke.GROUP_DROPPED: "group_dropped",
             chip_smoke.CHUNK_SWAPPED: "chunk_swapped",
             chip_smoke.DC_MODE_OFF: "dc_mode_off"}


def _run():
    report = {f"{n}_m{M}": {"max_abs_err": None}
              for n in chip_smoke.MODE_KERNELS for M in (1, 8)}
    chip_smoke.check_mode_kernels(CPU, torch.Generator().manual_seed(0),
                                  report, grid=GRID, train_grid=TRAIN_GRID,
                                  b3_grids=(GRID,))
    return report


def test_mode_checks_pass_the_plain_versions():
    report = _run()
    assert all(r["max_abs_err"] is not None for r in report.values())


def _faulty(wrapper, fault):
    orig = getattr(MODULES[wrapper], wrapper)

    def run(q, k, *args, **kw):
        M, md = q.shape[1], q.shape[-1]
        if fault == chip_smoke.CHUNK_SWAPPED and md > 64:
            q = chip_smoke.swap_md_chunks(q)
        if fault == chip_smoke.GROUP_DROPPED and M > 4 and \
                wrapper != "agg_corr_bwd":
            q, k = q[:, :4], k[:, :4]
        out = orig(q, k, *args, **kw)
        if wrapper == "agg_corr_bwd":
            dc, da = out
            if fault == chip_smoke.DC_MODE_OFF and M > 1:
                dc = dc.roll(1, dims=1)
            if fault == chip_smoke.GROUP_DROPPED and M > 4:
                dc = torch.cat([dc[:, :4], torch.zeros_like(dc[:, 4:])], 1)
            out = dc, da
        return out
    return run


@pytest.mark.parametrize("wrapper,fault", [
    *((w, chip_smoke.GROUP_DROPPED) for w in (
        "fused_agg_corr_norm", "fused_agg_corr", "fused_agg_corr_dense",
        "corr_norm_sums", "corr_norm_write", "agg_corr_bwd")),
    *((w, chip_smoke.CHUNK_SWAPPED) for w in (
        "scores_global_max", "flash_mode_attention",
        "flash_mode_attention_dense", "fused_agg_corr_norm",
        "mode_softmax_probs", "mode_softmax_probs_dense", "probs_bwd")),
    ("agg_corr_bwd", chip_smoke.DC_MODE_OFF)],
    ids=lambda v: FAULT_IDS.get(v, v))
def test_mode_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                  fault):
    monkeypatch.setattr(MODULES[wrapper], wrapper, _faulty(wrapper, fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


@pytest.mark.parametrize("name", list(chip_smoke.MODE_CONFIGS))
def test_mode_configs_load_their_weights(name):
    cfg = chip_smoke.mode_config(name, False)
    inter, f2, intra = chip_smoke.MODE_CONFIGS[name]
    assert (cfg.inter.num_modes, cfg.f2.num_modes) == (inter, f2)
    if cfg.use_setrans:
        assert cfg.intra.num_modes == intra
    model = FlowModel(cfg)
    result = model.load_state_dict(chip_smoke.mode_weights(name),
                                   strict=True)
    assert not result.missing_keys and not result.unexpected_keys
