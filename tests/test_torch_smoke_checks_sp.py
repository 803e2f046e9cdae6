"""chip_smoke.py's sequence-parallel checks of dense tables, two-way
correlation and GMA, run on the CPU at small grids: B8, B6 dense and B4
dense on row shards with ``sp_clip``'s clamp (no table, and the shard's
rows of a table as the port builds them against the rows of the whole
table), B6 dense's shards normed by ``build_pyramid(shard=...)``, B9 in
both directions of the two-way volume through
``sp_fused_agg_corr_norm_mt`` and GMA's attention on a shard, every rank
a thread of ``chip_smoke.LocalGroup``.  On CPU tensors the kernels'
wrappers take their plain versions, so the checks pass as they are, and
each planted fault (the table's rows from grid row 0, the clamp predicate
from the shard's own max, the norm's moments from the shard's own rows,
the first direction's moments in the second, GMA's x0 = 0 on rank 1) falls
outside its bound, which ``chip_smoke.hold`` asserts.  With each of these
made wrong in the port's own code (``sliding_pos_biases``,
``attention_mask``, ``sp_clip``, ``RowShard.layer_norm_moments``,
``RowShard.all_sum``, ``Attention.forward``) the checks fail.
"""

import pytest
import torch

import chip_smoke
from craft_tpu_torch.nn.gma import Attention
from craft_tpu_torch.parallel import sequence_parallel as spw
from craft_tpu_torch.parallel.sp import RowShard
from test_torch_smoke_checks import _one_thread  # noqa: F401

CPU = torch.device("cpu")
# Grids of 10 and 9 rows: 5/5 and 4/3/3, 5/4 rows, off the 64-row tiles;
# the --f2radius mask (radius 7) masks along both axes at 10 x 24.
CASES = (((10, 24), 2), ((10, 24), 3), ((9, 21), 2))
SMALL = ((4, 16), (4, 16))  # (modes, mode dim) of the wide and intra sites
GMA_GRID, GMA_MAX_POS = (9, 21), 6
FAULTS = ("table rows from grid row 0", "local clamp predicate",
          "moments of the shard's own rows", "the first direction's moments",
          "x0 = 0 on rank 1")


def _report():
    return {"flash_mode_attention_dense": {}, "fused_agg_corr_dense": {},
            "mode_softmax_probs_dense": {}, "corr_norm_write": {}}


def _run(seed=0):
    report = _report()
    gen = torch.Generator().manual_seed(seed)
    chip_smoke.check_sp_dense_kernels(CPU, gen, report, cases=CASES,
                                      wide=SMALL[0], intra=SMALL[1])
    chip_smoke.check_sp_two_way_b9(CPU, gen, report, grid=GMA_GRID, md=32)
    chip_smoke.check_sp_gma(CPU, gen, grid=GMA_GRID, max_pos=GMA_MAX_POS)
    return report


def test_sp_checks_pass_the_plain_versions(capsys):
    report = _run()
    for name in ("flash_mode_attention_dense", "fused_agg_corr_dense"):
        assert report[name]["max_abs_err"] == 0.0, name
    # bf16 probs against fp32 ones: half an ulp of values <= 1.
    assert 0.0 < report["mode_softmax_probs_dense"]["max_abs_err"] <= 2.0 ** -9
    # bf16 rows against fp32 ones: one rounding of normed values < 16.
    assert 0.0 < report["corr_norm_write"]["max_abs_err"] < 2.0 ** -4
    out = capsys.readouterr().out
    for fault in FAULTS:
        assert f"planted fault '{fault}'" in out, fault


_window, _mask = chip_smoke.ma.sliding_pos_biases, chip_smoke.setrans.attention_mask


def _window_from_row0(biases, H, W, q_row0=0, q_rows=None):
    """sliding_pos_biases giving grid rows 0 .. q_rows - 1 whatever
    q_row0."""
    return _window(biases, H, W, 0, H - q_row0 if q_rows is None else q_rows)


def _mask_from_row0(H, W, radius, device=None, row0=0, rows=None):
    """attention_mask giving grid rows 0 .. rows - 1 whatever row0."""
    return _mask(H, W, radius, device, 0, H - row0 if rows is None else rows)


def _local_clip(shard, q, k, attn_clip):
    """sp_clip without the all_max: the shard's own max."""
    gmax = spw.scores_global_max(q, k, q.shape[-1] ** -0.5)
    return chip_smoke._sp_clip(gmax, attn_clip)


def _local_moments(self, vol):
    """RowShard.layer_norm_moments without the all_sum: the shard's own."""
    mean = vol.mean(dim=-1, keepdim=True)
    return mean, (vol - mean).square().mean(dim=-1, keepdim=True)


def _first_sums(all_sum):
    """RowShard.all_sum that gives each rank the first sums it ever took:
    the second direction of the two-way volume normed by the first's
    moments."""
    seen = {}

    def first(self, x):
        return seen.setdefault(self.group.rank, all_sum(self, x))
    return first


@pytest.mark.parametrize("fault", ["window rows from grid row 0",
                                   "mask rows from grid row 0",
                                   "local clamp predicate",
                                   "moments of the shard's own rows"])
def test_sp_checks_catch_a_fault_in_the_port(monkeypatch, fault):
    if fault == "window rows from grid row 0":
        monkeypatch.setattr(chip_smoke.ma, "sliding_pos_biases",
                            _window_from_row0)
    elif fault == "mask rows from grid row 0":
        monkeypatch.setattr(chip_smoke.setrans, "attention_mask",
                            _mask_from_row0)
    elif fault == "local clamp predicate":
        monkeypatch.setattr(spw, "sp_clip", _local_clip)
    else:
        monkeypatch.setattr(RowShard, "layer_norm_moments", _local_moments)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_sp_dense_kernels(
            CPU, torch.Generator().manual_seed(0), _report(), cases=CASES,
            wide=SMALL[0], intra=SMALL[1])


def test_two_way_check_catches_the_first_directions_moments(monkeypatch):
    monkeypatch.setattr(RowShard, "all_sum", _first_sums(RowShard.all_sum))
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_sp_two_way_b9(CPU, torch.Generator().manual_seed(0),
                                       _report(), grid=GMA_GRID, md=32)


def test_gma_check_catches_a_local_row_offset(monkeypatch):
    """Attention on a shard that reads its relative positions from grid row
    0, as a rank that passed x0 = 0."""
    forward = Attention.forward

    def at_row0(self, fmap, shard=None):
        if shard is None:
            return forward(self, fmap)
        probs = self._probs
        self._probs = lambda q, kt, h, w, x0: probs(q, kt, h, w,
                                                    x0 - shard.h0)
        try:
            return forward(self, fmap, shard=shard)
        finally:
            del self._probs
    monkeypatch.setattr(Attention, "forward", at_row0)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_sp_gma(CPU, torch.Generator().manual_seed(0),
                                grid=GMA_GRID, max_pos=GMA_MAX_POS)
