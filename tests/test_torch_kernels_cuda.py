"""The CUDA kernels (B1-B4, the training kernels B6 forward and backward
and B7 backward, the lookup B5 forward and backward, the dense-table
kernels B8, B6 dense and B4 dense, and the sequence-parallel B9 with B1,
B2 and B4 on row shards) against their plain versions at small ragged
shapes, bf16 and fp32 inputs, batch 2, every input drawn from a
seeded generator.  Needs an NVIDIA GPU with nvcc
(sm_90a); skipped elsewhere.  On the card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: the suite's conftest imports JAX, which the port does not
need on the GPU machine.)
"""

import math

import pytest
import torch

from craft_tpu_torch.ops.kernels import corr_lookup as lk
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import launch
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv

pytestmark = pytest.mark.cuda

GRIDS = [(5, 12), (3, 128)]  # ragged (U=60) and a W8 = 128 grid (U=384)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed: int) -> torch.Generator:
    """A seeded CPU generator: each test's inputs are the same in every run
    and in every order."""
    return torch.Generator().manual_seed(seed)


def _inputs(dev, grid, md, dtype, seed=0, qk_std=0.7, bias_std=0.5):
    gen = _gen(seed)
    U = grid[0] * grid[1]
    q, k = (torch.randn(2, 4, U, md, generator=gen) * qk_std
            for _ in range(2))
    biases = torch.randn(15, 15, generator=gen) * bias_std
    return q.to(dev, dtype), k.to(dev, dtype), biases.to(dev)


# B2 and B4 take inputs whose softmax rows are dominated by a few keys and
# whose bias moves them (scores of std 2.25, pos_w * bias of std 1.5 or 3),
# as chip_smoke.py does, so that a near-uniform softmax cannot hide a fault.
_PEAKY = dict(qk_std=1.5, bias_std=3.0)


def _rel(got, want, dim=None):
    """max |got - want| / max |want|, over the tensor or per row (dim -1)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    if dim is None:
        return float(d.max() / w.max())
    return float((d.amax(dim) / w.amax(dim)).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("md", [16, 32, 64])
def test_b1_scores_global_max(dev, dtype, grid, md):
    q, k, _ = _inputs(dev, grid, md, dtype)
    scale = 1.0 / math.sqrt(md)
    got = ma.scores_global_max(q, k, scale)
    want = ma.scores_global_max_plain(q, k, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b2_flash_attention(dev, dtype, grid, clip):
    q, k, biases = _inputs(dev, grid, 64, dtype, **_PEAKY)
    v = torch.randn(2, 4, q.shape[2], 256, generator=_gen(1)).to(dev, dtype)
    clip_t = torch.tensor(clip, device=dev)
    got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
    want = ma.flash_mode_attention_plain(q, k, v, biases, grid, clip_t, 0.5)
    if dtype == torch.bfloat16:  # both bf16: one ulp is <= 2^-7 of a value
        assert _rel(got, want) <= 2e-2
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("attn_clip", [100.0, 0.4])
def test_b3_fused_agg_corr_norm(dev, out_dtype, grid, attn_clip):
    q, k, biases = _inputs(dev, grid, 64, torch.bfloat16)
    q[0, 0, 0] *= 4  # only sample 0 crosses 0.4 by the most
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    got, stats = ma.fused_agg_corr_norm(q, k, biases, grid, attn_clip, 0.5,
                                        *agg, out_dtype=out_dtype)
    want, wstats = ma.fused_agg_corr_norm_plain(
        q, k, biases, grid, attn_clip, 0.5, *agg, out_dtype=torch.float32)
    tol = (3e-2, 1e-2) if out_dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), want, atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(stats, wstats, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("md", [16, 32])
def test_b4_probs(dev, grid, md):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, **_PEAKY)
    clip = torch.tensor(1.0, device=dev)
    num, scale = ma.mode_softmax_probs(q, k, biases, grid, clip, 1.0,
                                       quantized=True)
    wnum, wscale = ma.mode_softmax_probs_plain(q, k, biases, grid, clip, 1.0,
                                               quantized=True)
    assert (num.int() - wnum.int()).abs().max() <= 1
    torch.testing.assert_close(scale, wscale, rtol=1e-4, atol=0)
    for odt in (torch.float32, torch.bfloat16):
        got = ma.mode_softmax_probs(q, k, biases, grid, clip, 1.0,
                                    out_dtype=odt)
        want = ma.mode_softmax_probs_plain(q, k, biases, grid, clip, 1.0,
                                           out_dtype=torch.float32)
        # per row, over the row max; bf16 rounding is <= 2^-8 of a value
        assert _rel(got, want, -1) <= (1e-2 if odt == torch.bfloat16
                                       else 1e-4)


def test_launch_counts_count_kernel_launches_only(dev):
    q, k, biases = _inputs(dev, GRIDS[0], 32, torch.bfloat16)
    one = torch.tensor(1.0, device=dev)
    launch.reset_launch_counts()
    ma.scores_global_max_plain(q, k, 0.2)
    ma.scores_global_max(q, k, 0.2)
    ma.mode_softmax_probs(q, k, biases, GRIDS[0], torch.tensor(1e30,
                                                                device=dev),
                          1.0)
    # B3 launches the B1 kernel as its phase 0: B1's count takes it.
    ma.fused_agg_corr_norm(q, k, biases, GRIDS[0], 100.0, 0.5, one, one)
    cv.fused_agg_corr(q, k, biases, GRIDS[0], one, 0.5, one, one)
    cv.fused_agg_corr_dense(q, k, None, one, 0.5, one, one)
    assert launch.launch_counts() == {"scores_global_max": 2,
                                      "flash_mode_attention": 0,
                                      "flash_mode_attention_dense": 0,
                                      "fused_agg_corr_norm": 1,
                                      "mode_softmax_probs": 1,
                                      "mode_softmax_probs_dense": 0,
                                      "fused_agg_corr": 1,
                                      "fused_agg_corr_dense": 1,
                                      "agg_corr_bwd": 0,
                                      "probs_bwd": 0,
                                      "corr_lookup": 0,
                                      "corr_lookup_bwd": 0,
                                      "corr_norm_sums": 0,
                                      "corr_norm_write": 0}


def test_unsupported_variants_raise(dev):
    q, k, biases = _inputs(dev, GRIDS[0], 64, torch.float32)
    clip = torch.tensor(1e30, device=dev)
    v = torch.randn(2, 4, q.shape[2], 128, generator=_gen(1)).to(dev)
    with pytest.raises(ValueError, match="feature dim"):
        ma.flash_mode_attention(q, k, v, biases, GRIDS[0], clip, 0.5)
    one = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="fp32 -> fp32"):
        ma.fused_agg_corr_norm(q, k, biases, GRIDS[0], 100.0, 0.5, one, one,
                               out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 output only"):
        ma.mode_softmax_probs(q, k, biases, GRIDS[0], clip, 1.0,
                              quantized=True)


# ------------------------------------------------- the training kernels


def _outside_band(q, k, clip, band=1e-4):
    """Elements whose |c| is not within rounding of the clip (a clamp-mask
    element there may flip between two fp32 sums of the same products)."""
    c = ma.scores(q, k, 1.0 / math.sqrt(q.shape[-1])).abs()
    return (c - clip).abs() > band * clip


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b6_forward_and_backward(dev, dtype, grid, clip):
    q, k, biases = _inputs(dev, grid, 64, dtype, **_PEAKY)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    got = cv.fused_agg_corr(q, k, biases, grid, clip, 0.5, agg_w, agg_b)
    vol = cv.fused_agg_corr_plain(q, k, biases, grid, clip, 0.5, agg_w,
                                  agg_b)
    assert got.dtype == torch.float32 and _rel(got, vol) <= 1e-4
    U = q.shape[2]
    g = torch.randn(2, U, U, generator=_gen(1)).to(dev) + 1.0
    dc, da = cv.agg_corr_bwd(q, k, g, vol, biases, grid, clip, 0.5, agg_w)
    wdc, wda = cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip, 0.5,
                                     agg_w)
    keep = _outside_band(q, k, clip)
    assert dc.dtype == torch.float32
    assert _rel(dc * keep, wdc * keep) <= 1e-4
    assert float((da - wda).abs()) <= 1e-4 * float(wda.abs())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("md", [32, 64])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def b7_fp32_row_err(dc, wdc, p, g) -> float:
    """Per row, max_j |dc_j - wdc_j| / A with A = sum_j |p_j g_j|; the worst
    row."""
    a = (p.float() * g.float()).abs().sum(-1)
    return float(((dc.float() - wdc.float()).abs().amax(-1) / a).max())


def b7_fp32_bound(u: int) -> float:
    """The bound of b7_fp32_row_err.  dl_j = p_j (g_j - S) with S = sum_i
    g_i p_i; kernel and plain version take S in different orders, and any
    order errs by at most gamma_U A (gamma_U ~ U u, u = 2^-24 the fp32 unit
    roundoff), so the two S differ by at most 2 gamma_U A, and p_j <= 1
    carries that to dl_j.  g_j - S and the product by p_j round once each on
    either side, at most 2 u p_j (|g_j| + |S|) <= 4 u A a side (p_j |g_j|
    <= A, |S| <= A).  Hence |dc_j - wdc_j| <= (2U + 8) u A; 2U + 16 leaves
    room for the 1 / (1 - U u) of gamma_U.  Against the row max of dc (the
    bound before) a row whose probs sit on one key cancels in dl_j and has
    no such bound."""
    return (2 * u + 16) * 2.0 ** -24


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("md", [32, 64])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b7_backward(dev, dtype, grid, md, clip):
    q, k, biases = _inputs(dev, grid, md, dtype, **_PEAKY)
    clip_t = torch.tensor(clip, device=dev)
    p = ma.mode_softmax_probs_plain(q, k, biases, grid, clip_t, 1.0,
                                    out_dtype=dtype)
    g = torch.randn(p.shape, generator=_gen(1)).to(dev, dtype)
    dc, dlsum = pv.probs_bwd(q, k, p, g, clip)
    wdc, wdlsum = pv.probs_bwd_plain(q, k, p, g, clip)
    keep = _outside_band(q, k, clip)
    assert dc.dtype == dtype and dlsum.dtype == torch.float32
    if dtype == torch.bfloat16:
        # Per row, over the row max: half a bf16 ulp, 2^-8, either side.
        assert _rel(dc.float() * keep, wdc.float() * keep, -1) <= 1e-2
    else:
        assert b7_fp32_row_err(dc * keep, wdc * keep, p, g) <= \
            b7_fp32_bound(q.shape[2])
    assert _rel(dlsum, wdlsum) <= 1e-4


# ------------------------------------------------- the dense-table kernels

# (U1, U2): ragged squares (one with the serving W8) and a rectangle.
DENSE_SHAPES = [(60, 60), (384, 384), (100, 37)]


def _dense_inputs(dev, shape, md, dtype, with_table, seed=3):
    gen = _gen(seed)
    u1, u2 = shape
    q = torch.randn(2, 4, u1, md, generator=gen) * 1.5
    k = torch.randn(2, 4, u2, md, generator=gen) * 1.5
    table = torch.randn(u1, u2, generator=gen) * 3.0 if with_table else None
    v = torch.randn(2, 4, u2, 256, generator=gen)
    return (q.to(dev, dtype), k.to(dev, dtype),
            None if table is None else table.to(dev), v.to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b8_flash_attention_dense(dev, dtype, with_table, shape, clip):
    q, k, table, v = _dense_inputs(dev, shape, 64, dtype, with_table)
    clip_t = torch.tensor(clip, device=dev)
    got = ma.flash_mode_attention_dense(q, k, v, table, clip_t, 0.5)
    want = ma.flash_mode_attention_dense_plain(q, k, v, table, clip_t, 0.5)
    assert got.shape == (2, 4, shape[0], 256) and got.dtype == dtype
    if dtype == torch.bfloat16:  # both bf16: one ulp is <= 2^-7 of a value
        assert _rel(got, want) <= 2e-2
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_b8_masked_rows_keep_their_own_key(dev):
    """The f2 mask at radius 0 leaves each row its own key only: out = v,
    with no NaN from rows whose other keys all sit at -1e9."""
    from craft_tpu_torch.nn.setrans import attention_mask
    q, k, _, v = _dense_inputs(dev, (384, 384), 64, torch.float32, False)
    table = attention_mask(3, 128, 0, dev)
    got = ma.flash_mode_attention_dense(q, k, v, table, 1e30, 1.0)
    torch.testing.assert_close(got, v, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b6_dense_forward(dev, dtype, with_table, shape, clip):
    q, k, table, _ = _dense_inputs(dev, shape, 64, dtype, with_table)
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    got = cv.fused_agg_corr_dense(q, k, table, clip, 0.5, *agg)
    want = cv.fused_agg_corr_dense_plain(q, k, table, clip, 0.5, *agg)
    assert got.dtype == torch.float32 and got.shape == (2, *shape)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("io", [(torch.bfloat16, torch.bfloat16),
                                (torch.bfloat16, torch.float32),
                                (torch.float32, torch.float32)])
@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b4_dense_probs(dev, io, with_table, shape, clip):
    dtype, out_dtype = io
    q, k, table, _ = _dense_inputs(dev, shape, 32, dtype, with_table)
    clip_t = torch.tensor(clip, device=dev)
    got = ma.mode_softmax_probs_dense(q, k, table, clip_t, 1.0,
                                      out_dtype=out_dtype)
    want = ma.mode_softmax_probs_dense_plain(q, k, table, clip_t, 1.0,
                                             out_dtype=torch.float32)
    assert got.dtype == out_dtype and got.shape == (2, 4, *shape)
    # per row, over the row max; bf16 rounding is <= 2^-8 of a value
    assert _rel(got, want, -1) <= (1e-2 if out_dtype == torch.bfloat16
                                   else 1e-4)


def test_dense_variants_that_the_kernels_do_not_take_raise(dev):
    q, k, table, v = _dense_inputs(dev, (60, 60), 64, torch.float32, True)
    with pytest.raises(ValueError, match="feature dim"):
        ma.flash_mode_attention_dense(q, k, v[..., :128], table, 1e30, 0.5)
    with pytest.raises(ValueError, match="fp32 -> fp32"):
        ma.mode_softmax_probs_dense(q, k, table, 1e30, 1.0)
    with pytest.raises(ValueError, match="dense bias table"):
        cv.fused_agg_corr_dense(q, k, table.cpu(), 1e30, 0.5, 1.0, 0.0)


def test_autograd_functions_on_the_card_match_the_cpu(dev):
    """Both Functions through the kernels on the card against their plain
    versions on the CPU: values and gradients, fp32, the clamp off (the
    kernel tests above cover it on)."""
    q, k, biases = _inputs(dev, GRIDS[0], 32, torch.float32, **_PEAKY)
    agg = (torch.tensor(1.3), torch.tensor(0.1))
    w = torch.randn(2, 4, q.shape[2], q.shape[2], generator=_gen(2))
    out = {}
    for d in (dev, torch.device("cpu")):
        args = [t.detach().to(d).requires_grad_() for t in (q, k, biases)]
        aw, ab = (t.to(d).requires_grad_() for t in agg)
        vol = cv.fused_agg_corr_diff(*args, 1e30, 0.5, aw, ab, GRIDS[0])
        p = pv.mode_softmax_probs_diff(*args, 1e30, 1.0, GRIDS[0])
        ((vol * w[:, 0].to(d)).sum() + (p * w.to(d)).sum()).backward()
        out[d.type] = [t.detach().cpu() for t in (vol, p, *(
            a.grad for a in args), aw.grad)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel(got, want) <= 1e-3


# ------------------------------------------------- the lookup (B5)

# (batch, H8, W8): a ragged grid whose last level pools to one row, one
# whose last level pools to zero rows, and the serving width.
LOOKUP_GRIDS = [(2, 5, 12), (1, 7, 9), (1, 9, 128)]


def _lookup_inputs(dev, batch, h8, w8, dtype):
    import chip_smoke
    return chip_smoke.lookup_inputs(dev, batch, h8, w8, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", LOOKUP_GRIDS)
@pytest.mark.parametrize("radius", [4, 2])
def test_b5_lookup_forward_and_backward(dev, dtype, grid, radius):
    levels, coords = _lookup_inputs(dev, *grid, dtype)
    got = lk.corr_lookup(levels, coords, radius)
    want = lk.corr_lookup_plain(levels, coords, radius)
    top = max(float(lv.float().abs().max()) for lv in levels if lv.numel())
    # The same four values blended with the same fp32 operations.
    assert float((got - want).abs().max()) <= 4 * 2.0 ** -23 * top
    g = torch.randn(got.shape, generator=_gen(1)).to(dev)
    shapes = [tuple(lv.shape) for lv in levels]
    dl = lk.corr_lookup_bwd(coords, g, shapes, dtype, radius)
    wdl = lk.corr_lookup_bwd_plain(coords, g, shapes, torch.float32, radius)
    # Each element within one rounding to the level type of the fp32 value.
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 4 * 2.0 ** -23
    for d, w in zip(dl, wdl):
        assert d.dtype == dtype and d.shape == w.shape
        assert bool(((d.float() - w).abs() <= tol * w.abs()).all())


def test_b5_function_on_the_card_matches_the_cpu(dev):
    levels, coords = _lookup_inputs(dev, 2, 5, 12, torch.float32)
    g = torch.randn(2, 5, 12, 4 * 81, generator=_gen(1)).to(dev)
    out = {}
    for d in (dev, torch.device("cpu")):
        lv = [t.detach().to(d).requires_grad_() for t in levels]
        res = lk.corr_lookup_diff(lv, coords.to(d), 4)
        (res * g.to(d)).sum().backward()
        out[d.type] = [t.detach().cpu() for t in (res, *(x.grad for x in lv))]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_b5_rejects_what_the_kernel_does_not_take(dev):
    levels, coords = _lookup_inputs(dev, 1, 5, 12, torch.float32)
    with pytest.raises(ValueError, match="coords"):
        lk.corr_lookup(levels, coords.double(), 4)
    with pytest.raises(ValueError, match="one type"):
        lk.corr_lookup([levels[0], levels[1].bfloat16()], coords, 4)
    with pytest.raises(ValueError, match="radius"):
        lk.corr_lookup(levels, coords, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lk.corr_lookup([lv.cpu() for lv in levels], coords, 4)


# ------------------------------------------------- row shards (B9, offsets)

# (H8, W8) grids split into (h0, h1) row shards: even, uneven and one row.
SHARDS = [((5, 12), [(0, 3), (3, 5)]), ((7, 128), [(0, 3), (3, 5), (5, 7)]),
          ((3, 20), [(2, 3)])]


def _shard_case(dev, grid, dtype, md, seed, **kw):
    q, k, biases = _inputs(dev, grid, md, dtype, seed=seed, **kw)
    return q, k, biases, grid[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid,shards", SHARDS)
def test_b1_on_row_shards(dev, dtype, grid, shards):
    q, k, _, W8 = _shard_case(dev, grid, dtype, 64, 2)
    for h0, h1 in shards:
        ql = q[:, :, h0 * W8:h1 * W8]
        torch.testing.assert_close(ma.scores_global_max(ql, k, 0.125),
                                   ma.scores_global_max_plain(ql, k, 0.125),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid,shards", SHARDS)
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b2_b4_with_row_offsets(dev, dtype, grid, shards, clip):
    q, k, biases, W8 = _shard_case(dev, grid, dtype, 64, 3, **_PEAKY)
    v = torch.randn(2, 4, k.shape[2], 256, generator=_gen(4)).to(dev, dtype)
    clip_t = torch.tensor(clip, device=dev)
    for h0, h1 in shards:
        ql = q[:, :, h0 * W8:h1 * W8]
        got = ma.flash_mode_attention(ql, k, v, biases, grid, clip_t, 0.5,
                                      q_row0=h0)
        want = ma.flash_mode_attention_plain(ql, k, v, biases, grid, clip_t,
                                             0.5, q_row0=h0)
        assert _rel(got, want) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
        odt = dtype  # bf16 -> bf16, fp32 -> fp32
        got = ma.mode_softmax_probs(ql, k, biases, grid, clip_t, 1.0,
                                    out_dtype=odt, q_row0=h0)
        want = ma.mode_softmax_probs_plain(ql, k, biases, grid, clip_t, 1.0,
                                           out_dtype=torch.float32,
                                           q_row0=h0)
        assert _rel(got, want, -1) <= (1e-2 if odt == torch.bfloat16
                                       else 1e-4)
        if dtype == torch.bfloat16:
            num, sc = ma.mode_softmax_probs(ql, k, biases, grid, clip_t, 1.0,
                                            quantized=True, q_row0=h0)
            wnum, wsc = ma.mode_softmax_probs_plain(
                ql, k, biases, grid, clip_t, 1.0, quantized=True, q_row0=h0)
            assert (num.int() - wnum.int()).abs().max() <= 1
            torch.testing.assert_close(sc, wsc, rtol=1e-4, atol=0)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid,shards", SHARDS[:2])
@pytest.mark.parametrize("attn_clip", [100.0, 0.4])
def test_b9_shards_against_plain_and_b3(dev, out_dtype, grid, shards,
                                        attn_clip):
    in_dtype = torch.float32 if out_dtype == torch.float32 else torch.bfloat16
    q, k, biases, W8 = _shard_case(dev, grid, in_dtype, 64, 5)
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    ql = [q[:, :, h0 * W8:h1 * W8] for h0, h1 in shards]
    gmax = max(ma.scores_global_max(x, k, 0.125) for x in ql)
    sums = 0
    for x, (h0, _) in zip(ql, shards):
        got = ma.corr_norm_sums(x, k, biases, grid, gmax, attn_clip, 0.5,
                                *agg, q_row0=h0)
        want = ma.corr_norm_sums_plain(x, k, biases, grid, gmax, attn_clip,
                                       0.5, *agg, q_row0=h0)
        assert got.dtype == torch.float64
        n = x.shape[2] * k.shape[2]
        rms = float((want[:, 1] / n).sqrt().max())
        assert float((got - want)[:, 0].abs().max()) <= 1e-5 * rms * n
        torch.testing.assert_close(got[:, 1], want[:, 1], rtol=1e-5, atol=0)
        sums = sums + got
    tol = (3e-2, 1e-2) if out_dtype == torch.bfloat16 else (1e-4, 1e-4)
    parts = []
    for x, (h0, _) in zip(ql, shards):
        got = ma.corr_norm_write(x, k, biases, grid, gmax, sums, attn_clip,
                                 0.5, *agg, q_row0=h0, out_dtype=out_dtype)
        want = ma.corr_norm_write_plain(
            x, k, biases, grid, gmax, sums, float(k.shape[2]) ** 2, attn_clip,
            0.5, *agg, q_row0=h0, out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), want, atol=tol[0],
                                   rtol=tol[1])
        parts.append(got)
    b3, _ = ma.fused_agg_corr_norm(q, k, biases, grid, attn_clip, 0.5, *agg,
                                   out_dtype=out_dtype)
    torch.testing.assert_close(torch.cat(parts, 1).float(), b3.float(),
                               atol=tol[0], rtol=tol[1])
