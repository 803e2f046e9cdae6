"""The kernel-against-plain checks of chip_smoke.py (its phase 2), run on
the CPU at a small ragged grid.  On CPU tensors each wrapper takes its plain
version, so the checks pass as they are; with a fault planted in a wrapper
(the sliding bias dropped, the clamp ignored, for the training kernels the
backward's clamp mask, its agg_w term or its softmax row term dropped, for
the lookup its channel order swapped, clamped padding, a wrong level scale
or the y blend dropped, and for the dense-table kernels a transposed table,
a table scaled by pos_w twice, no clamp or ragged keys left unmasked
(B6 dense reads each key on its own, so it has no such fault), and for the
sequence-parallel kernels (B9, and B2 and B4 on a row shard) the row offset
dropped, the moments over a shard's own element count or a shard's own max
as the clamp predicate) they must fail.  On the card the same checks also
plant the faults in the plain versions and fail unless their bounds catch
them.
"""

import functools

import pytest
import torch

import chip_smoke
from craft_tpu_torch.ops.kernels import corr_lookup as lk
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
