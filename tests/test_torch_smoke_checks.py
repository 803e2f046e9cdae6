"""The kernel-against-plain checks of chip_smoke.py (its phase 2), run on
the CPU at a small ragged grid.  On CPU tensors each wrapper takes its plain
version, so the checks pass as they are; with a fault planted in a wrapper
(the sliding bias dropped, the clamp ignored, B2's and B3's outer window
ring dropped, B4's int8 row max taken over one key tile (also at the
KITTI and chairs widths), B1's last key tile or mode 3 dropped before a
planted peak,
for the training kernels the backward's clamp mask, its agg_w
term or its softmax row term dropped (and, against the bf16 bodies' tiles,
B6 backward's dc of every mode from mode 0's scores or its da over the
first key group only, B7's row term over the first column tile only or
its dlsum of the last bm only, B6 forward's and B6 dense's vol of every
mode from mode 0's scores, the window over one warpgroup's keys, the
table read with another warpgroup's rows or a normalisation offset left
in, and a forward or backward whose two launches differ),
for
the lookup its channel order swapped, clamped padding, a wrong level scale
or the y blend dropped, and for the dense-table kernels a transposed table,
a table scaled by pos_w twice, no clamp or ragged keys left unmasked
(B6 dense reads each key on its own, so it has no such fault), and for the
sequence-parallel kernels (B9, and B2 and B4 on a row shard) the row offset
dropped, the moments over a shard's own element count or a shard's own max
as the clamp predicate, and for the fused GRU pass B10 the row mask
dropped, q over h, the blend reversed, halo rows counted twice in the
weight gradients or dh without its drh r term, and B5's backward with its
16-byte units that straddle two queries dropped or doubled, also at odd
slab sizes and radii 0, 1, 4 and 7) they must fail.  On the card the same
checks also plant the faults in the plain versions and fail unless their
bounds catch them.
"""

import functools

import pytest
import torch

import chip_smoke
from craft_tpu_torch.ops.kernels import corr_lookup as lk
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg

GRID = (6, 20)  # U = 120: not a multiple of the kernels' 64-row tiles
# B3 also at a ragged KITTI-width grid (W8 = 156, U = 468).
B3_GRIDS = (GRID, (3, 156))
CPU = torch.device("cpu")


def _run(seed=0):
    report = {fn.__name__: {} for fn in ma.KERNELS}
    gen = torch.Generator().manual_seed(seed)
    chip_smoke.check_kernels(CPU, gen, report, grid=GRID, b3_grids=B3_GRIDS)
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


def test_checks_catch_a_dropped_outer_ring(monkeypatch):
    """B2 with its window's outer ring (|dh| = R or |dw| = R) dropped: a
    band test one row too tight."""
    def faulty(q, k, v, biases, *args, **kwargs):
        return ma.flash_mode_attention_plain(
            q, k, v, chip_smoke.drop_outer_ring(biases), *args, **kwargs)
    monkeypatch.setattr(ma, "flash_mode_attention", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


def test_checks_catch_a_b3_outer_ring_dropped(monkeypatch):
    """B3 with its window's outer ring dropped: a band or column test one
    row or column too tight."""
    def faulty(q, k, biases, *args, **kwargs):
        return ma.fused_agg_corr_norm_plain(
            q, k, chip_smoke.drop_outer_ring(biases), *args, **kwargs)
    monkeypatch.setattr(ma, "fused_agg_corr_norm", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


def _tile_max_fault(plain=ma.mode_softmax_probs):
    """B4 whose int8 output takes the row max over one key tile (float
    outputs stay right: the max cancels in e / l)."""
    def faulty(q, k, biases, grid, clip, pos_w, out_dtype=torch.bfloat16,
               quantized=False, q_row0=0):
        if quantized:
            return chip_smoke.b4_tile_max_fault(q, k, biases, grid, clip,
                                                pos_w, q_row0)
        return plain(q, k, biases, grid, clip, pos_w, out_dtype=out_dtype,
                     q_row0=q_row0)
    return faulty


def test_checks_catch_a_row_max_over_one_key_tile(monkeypatch):
    monkeypatch.setattr(ma, "mode_softmax_probs", _tile_max_fault())
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


# B4 at small stand-ins for the KITTI and chairs shapes: W8 = 156 (U = 468)
# and W8 = 62, batch 2 (U = 310), both ragged against the 64-key tiles.
B4_SHAPES = (("KITTI width", 1, (3, 156)), ("chairs width", 2, (5, 62)))


def _run_b4_shapes(seed=0):
    report = {"mode_softmax_probs": {}}
    chip_smoke.check_b4_shapes(CPU, torch.Generator().manual_seed(seed),
                               report, shapes=B4_SHAPES)
    return report


def test_b4_shape_checks_pass_the_plain_version():
    report = _run_b4_shapes()
    # bf16 probs against fp32 ones: one rounding of values <= 1.
    assert 0.0 < report["mode_softmax_probs"]["max_abs_err"] < 2 ** -8


@pytest.mark.parametrize("fault", ["no bias", "no clamp",
                                   "row max taken over one key tile"])
def test_b4_shape_checks_catch_a_planted_kernel_fault(monkeypatch, fault):
    plain, clip_at, pos_w_at, off = _SITES["mode_softmax_probs"]
    faulty = (_tile_max_fault(plain) if fault.startswith("row max")
              else _no_bias(plain, pos_w_at) if fault == "no bias"
              else _no_clamp(plain, clip_at, off))
    monkeypatch.setattr(ma, "mode_softmax_probs", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run_b4_shapes()


# B1's planted peaks at small ragged shapes: U2 = 100 and 91 (the last key
# tile of 64 ragged), md 64 and 32, and the last rows of a shard.
B1_PEAK_CASES = (("ragged", 2, (5, 20), None, 64),
                 ("md 32", 1, (7, 13), None, 32),
                 ("shard", 1, (6, 20), (4, 6), 64))


def _run_peaks():
    chip_smoke.check_b1_peaks(CPU, torch.Generator().manual_seed(0),
                              cases=B1_PEAK_CASES)


def test_b1_peak_checks_pass_the_plain_version():
    _run_peaks()


@pytest.mark.parametrize("fault", chip_smoke.B1_FAULTS)
def test_b1_peak_checks_catch_a_planted_kernel_fault(monkeypatch, fault):
    monkeypatch.setattr(ma, "scores_global_max",
                        lambda q, k, scale: chip_smoke.b1_fault(q, k, scale,
                                                                fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_peaks()


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


# Faults against the bf16 bodies' tiles: at a grid wider than B7's column
# tile (128) and a B6 backward block's key group (576 keys), batch 2.
TILE_GRID = (10, 62)  # U = 620


def _run_train_tiles(seed=0):
    report = {name: {} for name in ("fused_agg_corr", "agg_corr_bwd",
                                    "probs_bwd")}
    chip_smoke.check_train_kernels(CPU, torch.Generator().manual_seed(seed),
                                   report, grid=TILE_GRID, batch=TRAIN_BATCH)
    return report


def test_tile_fault_grid_is_wider_than_the_tiles():
    u = TILE_GRID[0] * TILE_GRID[1]
    assert u > chip_smoke.B6_KEY_GROUP and u > chip_smoke.B7_COL_TILE


def test_train_checks_pass_the_plain_versions_at_the_tile_grid():
    report = _run_train_tiles()
    for name, r in report.items():
        assert r["max_abs_err"] == 0.0, name


def _b6_tile_fault(fault):
    def faulty(q, k, g, vol, biases, grid, clip, pos_w, agg_w):
        dc, da = cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip,
                                       pos_w, agg_w)
        if fault == "dc of every mode from mode 0's scores":
            dc = chip_smoke._b6_dc_fault(q, k, g, vol, biases, grid, clip,
                                         agg_w, mode0=True)
        else:
            da = chip_smoke._b6_da_fault(q, k, g, vol, biases, grid, clip,
                                         agg_w)
        return dc, da
    return faulty


def _b7_tile_fault(fault):
    def faulty(q, k, p, g, clip):
        if fault == "row term over the first column tile only":
            return chip_smoke._b7_fault(q, k, p, g, clip,
                                        row_cols=chip_smoke.B7_COL_TILE)
        return chip_smoke._b7_fault(q, k, p, g, clip, last_bm=True)
    return faulty


_TILE_SITES = {
    ("agg_corr_bwd", "dc of every mode from mode 0's scores"):
        (cv, _b6_tile_fault),
    ("agg_corr_bwd", "da from the first key group only"):
        (cv, _b6_tile_fault),
    ("probs_bwd", "row term over the first column tile only"):
        (pv, _b7_tile_fault),
    ("probs_bwd", "dlsum of the last bm only"): (pv, _b7_tile_fault),
}


@pytest.mark.parametrize("wrapper,fault", sorted(_TILE_SITES))
def test_train_checks_catch_a_fault_against_the_tiles(monkeypatch, wrapper,
                                                      fault):
    module, make = _TILE_SITES[(wrapper, fault)]
    monkeypatch.setattr(module, wrapper, make(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_train_tiles()


def _run_b6_forward(seed=0):
    report = {"fused_agg_corr": {}}
    gen = torch.Generator().manual_seed(seed)
    biases = torch.randn(15, 15, generator=gen) * chip_smoke.BIAS_STD
    chip_smoke.check_b6_forward(CPU, gen, report, biases, grid=TILE_GRID,
                                batch=TRAIN_BATCH)
    return report


def test_tile_fault_grid_spans_the_forward_blocks():
    """B6's forward tiles: more than one 128-row block of two 64-row
    halves, and many 64-key tiles of two 32-key halves."""
    u = TILE_GRID[0] * TILE_GRID[1]
    assert u > 4 * chip_smoke.B6_ROW_HALF and u > 8 * chip_smoke.B6_KEY_HALF


@pytest.mark.parametrize("fault", [chip_smoke.B6_MODE0,
                                   chip_smoke.B6_HALF_WINDOW,
                                   chip_smoke.B6_WB])
def test_b6_forward_checks_catch_a_fault_against_the_tiles(monkeypatch,
                                                           fault):
    def faulty(q, k, biases, grid, clip, pos_w, agg_w, agg_b):
        return chip_smoke.b6_fwd_fault(q, k, ma.window_rows(biases, grid, q,
                                                            k),
                                       clip, pos_w, agg_w, agg_b, fault)
    monkeypatch.setattr(cv, "fused_agg_corr", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run_b6_forward()


@pytest.mark.parametrize("wrapper", ["fused_agg_corr",
                                     "fused_agg_corr_dense"])
def test_checks_catch_a_forward_that_is_not_repeatable(monkeypatch,
                                                       wrapper):
    plain = getattr(cv, wrapper + "_plain")
    calls = []

    def drifting(*a):
        calls.append(1)
        return plain(*a) * (1.0 + len(calls) * 2.0 ** -20)
    monkeypatch.setattr(cv, wrapper, drifting)
    with pytest.raises(AssertionError, match="two launches differ"):
        if wrapper == "fused_agg_corr":
            _run_b6_forward()
        else:
            _run_dense()


@pytest.mark.parametrize("wrapper", ["agg_corr_bwd", "probs_bwd"])
def test_train_checks_catch_a_backward_that_is_not_repeatable(monkeypatch,
                                                              wrapper):
    module = cv if wrapper == "agg_corr_bwd" else pv
    plain = getattr(module, wrapper + "_plain")
    calls = []

    def drifting(*a):
        dc, second = plain(*a)
        calls.append(1)
        return dc, second * (1.0 + len(calls) * 2.0 ** -20)
    monkeypatch.setattr(module, wrapper, drifting)
    with pytest.raises(AssertionError, match="two launches differ"):
        _run_train()


# ------------------------------------------------- the lookup (B5)

# A bf16 grid whose last level pools to zero rows, and an fp32 one.
LOOKUP_SHAPES = (("ragged", 2, 5, 12, torch.bfloat16),
                 ("fp32", 1, 7, 9, torch.float32))


def _run_lookup():
    report = {"corr_lookup": {}, "corr_lookup_bwd": {}}
    chip_smoke.check_lookup(CPU, report, shapes=LOOKUP_SHAPES)
    return report


def test_lookup_checks_pass_the_plain_versions():
    report = _run_lookup()
    assert report["corr_lookup"]["max_abs_err"] == 0.0
    # bf16 level gradients against fp32 ones: one rounding of values < 8.
    assert 0.0 < report["corr_lookup_bwd"]["max_abs_err"] < 2.0 ** -5


def _lookup_fault(wrapper, fault):
    if wrapper == "corr_lookup":
        return lambda levels, coords, r: chip_smoke._b5_fault(
            levels, coords, r, fault)

    def faulty(coords, g, shapes, dtype, r):
        return tuple(d.to(dtype) for d in chip_smoke._b5_bwd_fault(
            coords, g, shapes, r, fault))
    return faulty


@pytest.mark.parametrize("fault", chip_smoke.B5_FAULTS)
@pytest.mark.parametrize("wrapper", ["corr_lookup", "corr_lookup_bwd"])
def test_lookup_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                    fault):
    monkeypatch.setattr(lk, wrapper, _lookup_fault(wrapper, fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_lookup()


def _unit_fault(fault):
    """corr_lookup_bwd whose straddling 16-byte units are dropped or
    doubled (chip_smoke.B5_UNIT_FAULTS)."""
    def faulty(coords, g, shapes, dtype, r):
        out = lk.corr_lookup_bwd_plain(coords, g, shapes, torch.float32, r)
        return tuple(d.to(dtype) for d in
                     chip_smoke._b5_unit_faults(list(out), dtype)[fault])
    return faulty


def test_lookup_radii_checks_pass_the_plain_versions():
    report = {"corr_lookup_bwd": {}}
    chip_smoke.check_lookup_radii(CPU, report)
    assert 0.0 < report["corr_lookup_bwd"]["max_abs_err"] < 2.0 ** -5


@pytest.mark.parametrize("fault", chip_smoke.B5_UNIT_FAULTS)
def test_lookup_radii_checks_catch_a_straddling_unit_fault(monkeypatch,
                                                           fault):
    monkeypatch.setattr(lk, "corr_lookup_bwd", _unit_fault(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_lookup_radii(CPU, {"corr_lookup_bwd": {}},
                                      radii=(1,))


@pytest.mark.parametrize("fault", chip_smoke.B5_UNIT_FAULTS)
def test_lookup_checks_catch_a_straddling_unit_fault(monkeypatch, fault):
    """The ragged grid's slabs (60 and 12 values) straddle units too."""
    monkeypatch.setattr(lk, "corr_lookup_bwd", _unit_fault(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_lookup()


def test_the_odd_slab_grid_has_odd_slabs():
    _, batch, h8, w8 = chip_smoke.LOOKUP_ODD_GRID
    slabs = [(h8 >> lvl) * (w8 >> lvl) for lvl in range(4)]
    assert batch >= 3 and sum(s % 2 for s in slabs) >= 3
    assert set(chip_smoke.LOOKUP_RADII) == {0, 1, 4, 7}


# ------------------------------------------------- the dense-table kernels

DENSE = ("flash_mode_attention_dense", "fused_agg_corr_dense",
         "mode_softmax_probs_dense")
DENSE_FAULTS = ("table transposed", "table scaled by pos_w twice",
                "no clamp", "ragged keys unmasked")


def _run_dense(seed=0):
    report = {name: {} for name in DENSE}
    chip_smoke.check_dense_kernels(CPU, torch.Generator().manual_seed(seed),
                                   report, grid=GRID)
    return report


def test_dense_checks_pass_the_plain_versions():
    report = _run_dense()
    assert report["flash_mode_attention_dense"]["max_abs_err"] == 0.0
    assert report["fused_agg_corr_dense"]["max_abs_err"] == 0.0
    # bf16 probs against fp32 ones: one rounding of values <= 1.
    assert 0.0 < report["mode_softmax_probs_dense"]["max_abs_err"] < 2 ** -8


def _dense_fault(name, fault):
    """The wrapper `name` as its plain version with `fault` planted."""
    plain, _, _, ragged = chip_smoke._dense_plains()[name]

    def apply(q, k, table, clip, pos_w, v):
        if fault == "table transposed" and table is not None \
                and table.shape[0] == table.shape[1]:
            table = table.t()
        if fault == "table scaled by pos_w twice":
            pos_w = pos_w * pos_w
        if fault == "no clamp":
            clip = torch.tensor(chip_smoke.CLIP_OFF)
        fn = ragged if fault == "ragged keys unmasked" else plain
        return fn(q, k, table, clip, pos_w, v)
    if name == "flash_mode_attention_dense":
        return lambda q, k, v, table, clip, pos_w: apply(q, k, table, clip,
                                                         pos_w, v)
    if name == "fused_agg_corr_dense":
        return lambda q, k, table, clip, pos_w, agg_w, agg_b: apply(
            q, k, table, clip, pos_w, None)
    return lambda q, k, table, clip, pos_w, out_dtype: apply(
        q, k, table, clip, pos_w, None).to(out_dtype)


@pytest.mark.parametrize("wrapper,fault", [
    (w, f) for w in DENSE for f in DENSE_FAULTS
    if not (w == "fused_agg_corr_dense" and f == "ragged keys unmasked")])
def test_dense_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                   fault):
    module = cv if wrapper == "fused_agg_corr_dense" else ma
    monkeypatch.setattr(module, wrapper, _dense_fault(wrapper, fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_dense()


@pytest.mark.parametrize("fault", [chip_smoke.B6_MODE0,
                                   chip_smoke.B6_TABLE_ROWS,
                                   chip_smoke.B6_WB])
def test_dense_checks_catch_a_b6_fault_against_the_tiles(monkeypatch, fault):
    """B6 dense against its bf16 body's tiles, at GRID (U = 120: the rows
    of a 128-row block's second half are ragged)."""
    def faulty(q, k, table, clip, pos_w, agg_w, agg_b):
        return chip_smoke.b6_fwd_fault(q, k, table, clip, pos_w, agg_w, agg_b,
                                       fault)
    monkeypatch.setattr(cv, "fused_agg_corr_dense", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run_dense()


# ------------------------------------------------- sequence parallelism

SP_GRID, SP_WORLDS = (6, 20), (1, 2, 3)


def _run_sp(seed=0):
    report = {"corr_norm_sums": {}, "corr_norm_write": {}}
    chip_smoke.check_sp_kernels(CPU, torch.Generator().manual_seed(seed),
                                report, grid=SP_GRID, worlds=SP_WORLDS)
    return report


def test_sp_checks_pass_the_plain_versions():
    report = _run_sp()
    assert report["corr_norm_sums"]["max_abs_err"] == 0.0
    # bf16 rows against fp32 ones: one rounding of normed values < 16.
    assert 0.0 < report["corr_norm_write"]["max_abs_err"] < 2.0 ** -4


def _sp_fault(name, fault):
    """The wrapper `name` as its plain version with `fault` planted: the
    row offset dropped, the moments over the shard's own element count, or
    the shard's own max as the clamp predicate."""
    plain = getattr(ma, name + "_plain")

    def faulty(*args, **kw):
        args = list(args)
        q, k = args[0], args[1]
        if fault == "row offset dropped":
            kw["q_row0"] = 0
        if fault == "local gmax":
            args[4] = ma.scores_global_max_plain(q, k, q.shape[-1] ** -0.5)
        if name != "corr_norm_write":
            return plain(*args, **kw)
        n = float(k.shape[2]) * (q.shape[2] if fault.startswith("moments")
                                 else k.shape[2])
        return plain(*args[:6], n, *args[6:], **kw)
    return faulty


@pytest.mark.parametrize("wrapper,fault", [
    ("corr_norm_sums", "row offset dropped"), ("corr_norm_sums", "local gmax"),
    ("corr_norm_write", "row offset dropped"),
    ("corr_norm_write", "moments over the local count"),
    ("corr_norm_write", "local gmax"),
    ("flash_mode_attention", "row offset dropped"),
    ("mode_softmax_probs", "row offset dropped")])
def test_sp_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper, fault):
    monkeypatch.setattr(ma, wrapper, _sp_fault(wrapper, fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run_sp()


# ------------------------------------------------- B10, the fused GRU pass

GRU_GRIDS = (("tiny", 2, 5, 9),)  # 45 rows an image: no 64-row tile fits


def _run_gru():
    report = {"gru_pass_fwd": {}, "gru_pass_bwd": {}}
    chip_smoke.check_gru(CPU, report, grids=GRU_GRIDS)
    return report


def test_gru_checks_pass_the_plain_versions():
    report = _run_gru()
    assert report["gru_pass_fwd"]["max_abs_err"] == 0.0
    assert report["gru_pass_bwd"]["max_abs_err"] == 0.0


def _gru_fault(fault):
    if fault in chip_smoke.B10_FWD_FAULTS:
        return "gru_pass_fwd", lambda *a: chip_smoke._gru_fwd_fault(
            list(a[:11]), a[11], a[12], fault)
    return "gru_pass_bwd", lambda *a: chip_smoke._gru_bwd_fault(
        a[:12], a[12], a[13], fault)


@pytest.mark.parametrize("fault", chip_smoke.B10_FAULTS)
def test_gru_checks_catch_a_planted_kernel_fault(monkeypatch, fault):
    wrapper, faulty = _gru_fault(fault)
    monkeypatch.setattr(sg, wrapper, faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run_gru()


def test_the_tile_edge_fault_is_at_the_forward_tile():
    """'r h halo dropped' cuts q's taps at the bf16 forward's row tiles
    (csrc/sep_conv_gru.cu GF_ROWS)."""
    import re
    from pathlib import Path
    src = Path(sg.__file__).resolve().parents[2] / "csrc" / "sep_conv_gru.cu"
    rows = re.search(r"^#define\s+GF_ROWS\s+(\d+)\b", src.read_text(),
                     re.MULTILINE)
    assert int(rows.group(1)) == chip_smoke.B10_FWD_TILE
    assert "r h halo dropped" in chip_smoke.B10_FWD_FAULTS


def test_gru_checks_catch_a_backward_that_is_not_repeatable(monkeypatch):
    calls = []

    def drifting(*a):
        out = list(sg.gru_pass_bwd_plain(*a))
        calls.append(1)
        out[2] = out[2] + len(calls) * 1e-7
        return tuple(out)
    monkeypatch.setattr(sg, "gru_pass_bwd", drifting)
    with pytest.raises(AssertionError, match="two backwards differ"):
        _run_gru()


def test_the_ragged_gru_grid_is_ragged():
    """chip_smoke's ragged GRU grid: its rows are a multiple neither of the
    bf16 backward's row tiles nor of its weight-gradient steps, and they
    fall into two or more row splits, the last one short."""
    import re
    from pathlib import Path
    src = Path(sg.__file__).resolve().parents[2] / "csrc" / "sep_conv_gru.cu"
    d = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^#define\s+(\w+)\s+(\d+)\b", src.read_text(), re.MULTILINE)}
    label, batch, h8, w8 = chip_smoke.GRU_CHECK_GRIDS[-1]
    rows = batch * h8 * w8
    assert label == "ragged" and rows % (64 * d["GB_WG"]) and \
        rows % d["GB_DEPTH"]
    n = sg.wgrad_splits(rows, True)
    chunk = -(-(-(-rows // n)) // d["GB_DEPTH"]) * d["GB_DEPTH"]
    assert n >= 2 and 0 < rows - (n - 1) * chunk < chunk
