"""chip_smoke.py's checks of the kernels at mode counts other than 4
(``check_mode_kernels``: the four-mode checks at each count), run on the
CPU at small grids: on CPU tensors the wrappers take their plain versions,
so the checks pass as they are (every count, 1 to 256 modes at the
256-wide sites, the counts past 32 at their cut grid); with a fault
planted in a wrapper they must fail: the modes past the first group
of four dropped (B3, B6, B6 dense, B9, B6 backward's dc), q's first two
64-wide md chunks swapped (B1, B2, B8, B3, B4, B4 dense, B7), B6
backward's dc written into the next mode's plane; and below md 16 a
nonzero pad column (B1, B2, B8, B4, B4 dense, B7), modes 16-19 skipped
(B3, B6, B6 dense, B9, B6 backward's dc) and the running max reset
between groups of four modes (B3, B6, B6 dense, B6 backward's dc); and
at one mode against B2's and B8's pipelined body q.k over md chunk 3
skipped (B2, B8) and keys 64-127 of every 128-key tile dropped (B2 at F
128).  Also
every configuration of the phase builds from the CLI's flags and loads
its weights (``chip_smoke.mode_weights``) strictly.
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
             chip_smoke.DC_MODE_OFF: "dc_mode_off",
             chip_smoke.PAD_NONZERO: "pad_nonzero",
             chip_smoke.GROUP_SKIPPED: "group_skipped",
             chip_smoke.MAX_RESET: "max_reset",
             chip_smoke.CHUNK_SKIPPED: "chunk_skipped",
             chip_smoke.HALF_TILE: "half_tile"}
# The counts past 16 modes (md 8 to 1), where the pad and group-skip
# faults apply.
PAST_16 = tuple(c for c in chip_smoke.MODE_COUNTS if c[0][0] > 16)
# One mode (md 256 at the 256-wide sites, 128 at the intra site), where
# the pipelined body's md-chunk and key-tile faults apply: md chunk 3
# skipped (B2, B8), and at F 128 keys 64-127 of every 128-key tile dropped
# (B2).
ONE_MODE = tuple(c for c in chip_smoke.MODE_COUNTS if c[0][0] == 1)
PER_MODE = ("scores_global_max", "flash_mode_attention",
            "flash_mode_attention_dense", "mode_softmax_probs",
            "mode_softmax_probs_dense", "probs_bwd")


def _run(counts=chip_smoke.MODE_COUNTS):
    report = {f"{n}_m{M}": {"max_abs_err": None}
              for n in chip_smoke.MODE_KERNELS for M in chip_smoke.MODE_ROWS}
    chip_smoke.check_mode_kernels(CPU, torch.Generator().manual_seed(0),
                                  report, grid=GRID, train_grid=TRAIN_GRID,
                                  b3_grids=(GRID,), counts=counts,
                                  cut_grid=GRID, cut_train_grid=TRAIN_GRID,
                                  flash_grids=(("small", GRID),))
    return report


def test_mode_checks_pass_the_plain_versions():
    report = _run()
    assert all(r["max_abs_err"] is not None for r in report.values())


def _max_reset(wrapper, orig, q, k, *args, **kw):
    """The wrapper's output with chip_smoke.MAX_RESET planted (the plain
    version with its mode softmax's max reset at each group of four)."""
    if wrapper == "fused_agg_corr":
        biases, grid, clip, pos_w, agg_w, agg_b = args
        return chip_smoke.max_reset_volume(
            q, k, ma.window_rows(biases, grid, q, k), clip, pos_w, agg_w,
            agg_b)
    if wrapper == "fused_agg_corr_dense":
        return chip_smoke.max_reset_volume(q, k, *args)
    if wrapper == "fused_agg_corr_norm":
        out, stats = orig(q, k, *args, **kw)
        return chip_smoke.b3_max_reset(q, k, *args[:6]).to(out.dtype), stats
    g, vol, biases, grid, clip, pos_w, agg_w = args  # agg_corr_bwd
    dc, da = orig(q, k, *args)
    return chip_smoke._b6_dc_fault(q, k, g, vol, biases, grid, clip, agg_w,
                                   max_reset=True), da


def _faulty(wrapper, fault):
    orig = getattr(MODULES[wrapper], wrapper)

    def run(q, k, *args, **kw):
        M, md = q.shape[1], q.shape[-1]
        if fault == chip_smoke.MAX_RESET and M > 4:
            return _max_reset(wrapper, orig, q, k, *args, **kw)
        if fault == chip_smoke.CHUNK_SWAPPED and md > 64:
            q = chip_smoke.swap_md_chunks(q)
        if fault == chip_smoke.CHUNK_SKIPPED and md > 192:
            q = chip_smoke.skip_md_chunk3(q)
        if fault == chip_smoke.HALF_TILE and args[0].shape[-1] == 128:
            v, biases, grid, clip, pos_w = args[:5]
            return chip_smoke.b2_half_tile(q, k, v, biases, grid, clip,
                                           pos_w, *args[5:], **kw)
        if fault == chip_smoke.PAD_NONZERO and md < ma.MMA_K:
            q, k = chip_smoke.pad_col_fault(q), chip_smoke.pad_col_fault(k)
        if fault == chip_smoke.GROUP_DROPPED and M > 4 and \
                wrapper != "agg_corr_bwd":
            q, k = q[:, :4], k[:, :4]
        if fault == chip_smoke.GROUP_SKIPPED and M > 16 and \
                wrapper != "agg_corr_bwd":
            q, k = chip_smoke.skip_group(q), chip_smoke.skip_group(k)
        out = orig(q, k, *args, **kw)
        if wrapper == "agg_corr_bwd":
            dc, da = out
            if fault == chip_smoke.DC_MODE_OFF and M > 1:
                dc = dc.roll(1, dims=1)
            if fault == chip_smoke.GROUP_DROPPED and M > 4:
                dc = torch.cat([dc[:, :4], torch.zeros_like(dc[:, 4:])], 1)
            if fault == chip_smoke.GROUP_SKIPPED and M > 16:
                dc = torch.cat([dc[:, :16], torch.zeros_like(dc[:, 16:20]),
                                dc[:, 20:]], 1)
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
    ("agg_corr_bwd", chip_smoke.DC_MODE_OFF),
    *((w, chip_smoke.PAD_NONZERO) for w in PER_MODE),
    *((w, chip_smoke.GROUP_SKIPPED) for w in (
        "fused_agg_corr_norm", "fused_agg_corr", "fused_agg_corr_dense",
        "corr_norm_sums", "corr_norm_write", "agg_corr_bwd")),
    *((w, chip_smoke.MAX_RESET) for w in (
        "fused_agg_corr_norm", "fused_agg_corr", "fused_agg_corr_dense",
        "agg_corr_bwd")),
    *((w, chip_smoke.CHUNK_SKIPPED) for w in (
        "flash_mode_attention", "flash_mode_attention_dense")),
    ("flash_mode_attention", chip_smoke.HALF_TILE)],
    ids=lambda v: FAULT_IDS.get(v, v))
def test_mode_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                  fault):
    monkeypatch.setattr(MODULES[wrapper], wrapper, _faulty(wrapper, fault))
    past_16 = fault in (chip_smoke.PAD_NONZERO, chip_smoke.GROUP_SKIPPED)
    one_mode = fault in (chip_smoke.CHUNK_SKIPPED, chip_smoke.HALF_TILE)
    with pytest.raises(AssertionError, match="disagrees"):
        _run(PAST_16 if past_16 else ONE_MODE if one_mode
             else chip_smoke.MODE_COUNTS)


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
