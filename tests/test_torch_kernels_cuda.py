"""The CUDA kernels (B1-B4, the training kernels B6 forward and backward
and B7 backward (their bf16 bodies also at misaligned and ragged grids,
BM 1 to 32, twice for bit-identity, B6's forward against the faults
planted against its tiles), the lookup B5 forward and
backward, the dense-table kernels B8, B6 dense and B4 dense, the sequence-parallel B9 with B1,
B2 and B4 on row shards, and the fused SepConvGRU pass B10 forward and
backward) against their plain versions at small ragged
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
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg

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


# B1 also at grids that span several of its bf16 body's 128-row q tiles
# and 16-tile key chunks, ragged in both: the KITTI width (156) and the
# chairs width (62).
BIG_GRIDS = [(9, 156), (20, 62)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", GRIDS + BIG_GRIDS)
@pytest.mark.parametrize("md", [16, 32, 48, 64])
def test_b1_scores_global_max(dev, dtype, grid, md):
    q, k, _ = _inputs(dev, grid, md, dtype)
    scale = 1.0 / math.sqrt(md)
    got = ma.scores_global_max(q, k, scale)
    want = ma.scores_global_max_plain(q, k, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _peaked(q, k, m, row, key, value=3.0):
    """q, k with q[:, m, row] = k[:, m, key] = value (every feature): their
    score value^2 md scale is exact in any summation order and above every
    other score."""
    q, k = q.clone(), k.clone()
    q[:, m, row] = value
    k[:, m, key] = value
    return q, k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid,shard", [((5, 12), None), ((9, 156), None),
                                        ((20, 62), None), ((9, 156), (6, 9))])
@pytest.mark.parametrize("md", [32, 64])
def test_b1_finds_a_planted_peak_exactly(dev, dtype, grid, shard, md):
    """The peak at the last mode, the last query row and the last (ragged)
    key: a body that drops the last key tile, mode 3 or the last rows
    misses it."""
    q, k, _ = _inputs(dev, grid, md, dtype, seed=9)
    if shard is not None:
        q = q[:, :, shard[0] * grid[1]:shard[1] * grid[1]]
    q, k = _peaked(q, k, 3, q.shape[2] - 1, k.shape[2] - 1)
    scale = 1.0 / math.sqrt(md)
    peak = torch.tensor(9.0 * md, dtype=torch.float32) * scale
    assert float(ma.scores_global_max(q, k, scale)) == float(peak)
    assert float(ma.scores_global_max_plain(q, k, scale)) == float(peak)


def test_b1_b3_bf16_tiles_reject_what_they_do_not_take(dev):
    """The bf16 bodies of B1, B3 and B9 take md a multiple of 16 and
    16-byte aligned q and k; fp32 takes md 24."""
    grid = GRIDS[0]
    one = torch.tensor(1.0, device=dev)
    q, k, biases = _inputs(dev, grid, 24, torch.bfloat16)
    for fn in (lambda a, b: ma.scores_global_max(a, b, 0.2),
               lambda a, b: ma.fused_agg_corr_norm(
                   a, b, biases, grid, 100.0, 0.5, one, one,
                   out_dtype=torch.float32),
               lambda a, b: ma.corr_norm_sums(a, b, biases, grid, one, 100.0,
                                              0.5, one, one)):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(q, k)
        fn(q.float(), k.float())
    q, k, _ = _inputs(dev, grid, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_off = flat[1:].view(q.shape)  # contiguous, 2 bytes past alignment
    q_off.copy_(q)
    for fn in (lambda a: ma.scores_global_max(a, k, 0.2),
               lambda a: ma.fused_agg_corr_norm(a, k, biases, grid, 100.0,
                                                0.5, one, one)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q_off)
        fn(q)


# B2's grids add two widths whose 64-row q tiles straddle grid rows: the
# chairs width (62) and the KITTI width (156).
B2_GRIDS = GRIDS + [(3, 62), (2, 156)]


# B2's value widths: the f2 site's 256 and the lazy intra aggregator's 128.
B2_FEATS = [128, 256]


@pytest.mark.parametrize("F", B2_FEATS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", B2_GRIDS)
@pytest.mark.parametrize("clip", [1e30, 0.4])
@pytest.mark.parametrize("md", [16, 32, 64])
def test_b2_flash_attention(dev, dtype, grid, clip, md, F):
    q, k, biases = _inputs(dev, grid, md, dtype, **_PEAKY)
    v = torch.randn(2, 4, q.shape[2], F, generator=_gen(1)).to(dev, dtype)
    clip_t = torch.tensor(clip, device=dev)
    got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
    want = ma.flash_mode_attention_plain(q, k, v, biases, grid, clip_t, 0.5)
    if dtype == torch.bfloat16:  # both bf16: one ulp is <= 2^-7 of a value
        assert _rel(got, want) <= 2e-2
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _ring(biases, value=3.0):
    """The window with its outer ring (|dh| = R or |dw| = R) at +-value, in
    a fixed sign pattern."""
    w = biases.clone()
    n = w.shape[0]
    ring = torch.zeros(n, n, dtype=torch.bool, device=w.device)
    ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
    signs = torch.ones(n, n, device=w.device)
    signs[::2, 1::2] = signs[1::2, ::2] = -1.0
    w[ring] = (value * signs)[ring]
    return w, ring


# Grids tall enough for |dh| = R = 7 at the chairs and KITTI widths, where
# 16-row warps and 64-key tiles straddle grid rows: some (warp, key tile)
# pairs meet only at |dh| = R (W8 = 62: the warp of tokens 0-15, grid row
# 0, and key tile 7, rows 7-8), so a band test one row too tight drops the
# ring's entries there.
RING_GRIDS = [(10, 62), (9, 156)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", RING_GRIDS)
def test_b2_window_outer_ring(dev, dtype, grid):
    q, k, biases = _inputs(dev, grid, 64, dtype, **_PEAKY)
    biases, ring = _ring(biases)
    v = torch.randn(2, 4, q.shape[2], 256, generator=_gen(1)).to(dev, dtype)
    clip_t = torch.tensor(1e30, device=dev)
    got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
    want = ma.flash_mode_attention_plain(q, k, v, biases, grid, clip_t, 0.5)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel(got, want) <= tol
    # The ring matters: the window without it is far outside the bound.
    no_ring = ma.flash_mode_attention_plain(
        q, k, v, biases.masked_fill(ring, 0.0), grid, clip_t, 0.5)
    assert _rel(no_ring, want) > 5 * tol


@pytest.mark.parametrize("grid,shards", [((10, 62), [(0, 3), (3, 10)]),
                                         ((9, 156), [(2, 5)])])
@pytest.mark.parametrize("md", [16, 32, 64])
@pytest.mark.parametrize("F", B2_FEATS)
def test_b2_bf16_tiles_on_row_shards(dev, grid, shards, md, F):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, seed=6, **_PEAKY)
    biases, _ = _ring(biases)
    v = torch.randn(2, 4, k.shape[2], F, generator=_gen(4)).to(
        dev, torch.bfloat16)
    clip_t = torch.tensor(0.4, device=dev)
    W8 = grid[1]
    for h0, h1 in shards:
        ql = q[:, :, h0 * W8:h1 * W8]
        got = ma.flash_mode_attention(ql, k, v, biases, grid, clip_t, 0.5,
                                      q_row0=h0)
        want = ma.flash_mode_attention_plain(ql, k, v, biases, grid, clip_t,
                                             0.5, q_row0=h0)
        assert got.shape == (2, 4, ql.shape[2], F)
        assert _rel(got, want) <= 2e-2


def test_flash_bf16_tiles_reject_what_they_do_not_take(dev):
    """The bf16 body needs md a multiple of 16 and 16-byte aligned
    tensors; fp32 takes md 24.  Both take F 128 and 256 and refuse any
    other width (192)."""
    grid = GRIDS[0]
    q, k, biases = _inputs(dev, grid, 24, torch.bfloat16)
    v = torch.randn(2, 4, q.shape[2], 256, generator=_gen(1)).to(
        dev, torch.bfloat16)
    clip = torch.tensor(1e30, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        ma.flash_mode_attention(q, k, v, biases, grid, clip, 0.5)
    with pytest.raises(ValueError, match="multiple of 16"):
        ma.flash_mode_attention_dense(q, k, v, None, clip, 0.5)
    ma.flash_mode_attention(q.float(), k.float(), v.float(), biases, grid,
                            clip, 0.5)
    q, k, _ = _inputs(dev, grid, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_off = flat[1:].view(q.shape)  # contiguous, 2 bytes past alignment
    q_off.copy_(q)
    for fn in (lambda x: ma.flash_mode_attention(x, k, v, biases, grid, clip,
                                                 0.5),
               lambda x: ma.flash_mode_attention_dense(x, k, v, None, clip,
                                                       0.5)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q_off)
        fn(q)
    for F, takes in ((128, True), (192, False)):
        for dt in (torch.bfloat16, torch.float32):
            vf = torch.randn(2, 4, q.shape[2], F, generator=_gen(2)).to(
                dev, dt)
            for fn in (lambda: ma.flash_mode_attention(
                           q.to(dt), k.to(dt), vf, biases, grid, clip, 0.5),
                       lambda: ma.flash_mode_attention_dense(
                           q.to(dt), k.to(dt), vf, None, clip, 0.5)):
                if takes:
                    assert fn().shape == (2, 4, q.shape[2], F)
                else:
                    with pytest.raises(ValueError, match="feature dims"):
                        fn()
    # The launch itself refuses F = 192 past the wrapper's check.
    out = torch.empty(2, 4, q.shape[2], 192, dtype=q.dtype, device=dev)
    v192 = torch.zeros(2, 4, q.shape[2], 192, dtype=q.dtype, device=dev)
    win = biases.float().contiguous()
    with pytest.raises(RuntimeError, match="flash_attn_launch"):
        ma._call("flash_attn_launch", *(launch.ptr(t) for t in (
            q, k, v192, out, win, clip.reshape(1))), 8, q.shape[2],
            q.shape[2], 0, 64, 192, grid[1], 7, 0.125, 0.5, 1,
            launch.stream(q))


# B3's grids add ragged widths, the KITTI one (156) among them, whose
# 16-row warps and 64-key tiles straddle grid rows, over several q tiles
# and key groups.
B3_GRIDS = GRIDS + [(9, 156), (11, 62)]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", B3_GRIDS)
@pytest.mark.parametrize("attn_clip", [100.0, 0.4])
@pytest.mark.parametrize("md", [32, 64])
def test_b3_fused_agg_corr_norm(dev, out_dtype, grid, attn_clip, md):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16)
    q[0, 0, 0] *= 4  # only sample 0 crosses 0.4 by the most
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    got, stats = ma.fused_agg_corr_norm(q, k, biases, grid, attn_clip, 0.5,
                                        *agg, out_dtype=out_dtype)
    want, wstats = ma.fused_agg_corr_norm_plain(
        q, k, biases, grid, attn_clip, 0.5, *agg, out_dtype=torch.float32)
    tol = (3e-2, 1e-2) if out_dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), want, atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(stats, wstats, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("grid", RING_GRIDS)
def test_b3_window_outer_ring(dev, grid):
    """B3 in bf16 with the window's outer ring at +-3: a band test one grid
    row too tight moves the volume far outside the bound."""
    q, k, biases = _inputs(dev, grid, 64, torch.bfloat16, seed=8)
    biases, ring = _ring(biases)
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    got, _ = ma.fused_agg_corr_norm(q, k, biases, grid, 100.0, 0.5, *agg,
                                    out_dtype=torch.float32)
    want, _ = ma.fused_agg_corr_norm_plain(q, k, biases, grid, 100.0, 0.5,
                                           *agg, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    no_ring, _ = ma.fused_agg_corr_norm_plain(
        q, k, biases.masked_fill(ring, 0.0), grid, 100.0, 0.5, *agg,
        out_dtype=torch.float32)
    assert float((no_ring - want).abs().max()) > 1e-2


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


def _hold_b4(q, k, biases, grid, clip, pos_w, q_row0=0):
    """B4 int8 and bf16 against the plain version under phase 2's bounds:
    numerators within 1, row scales rtol 1e-4, bf16 probs per row 1e-2."""
    num, sc = ma.mode_softmax_probs(q, k, biases, grid, clip, pos_w,
                                    quantized=True, q_row0=q_row0)
    wnum, wsc = ma.mode_softmax_probs_plain(q, k, biases, grid, clip, pos_w,
                                            quantized=True, q_row0=q_row0)
    assert (num.int() - wnum.int()).abs().max() <= 1
    torch.testing.assert_close(sc, wsc, rtol=1e-4, atol=0)
    got = ma.mode_softmax_probs(q, k, biases, grid, clip, pos_w,
                                out_dtype=torch.bfloat16, q_row0=q_row0)
    want = ma.mode_softmax_probs_plain(q, k, biases, grid, clip, pos_w,
                                       out_dtype=torch.float32,
                                       q_row0=q_row0)
    assert _rel(got, want, -1) <= 1e-2
    return num


# B4's bf16 body at grids that span several 128-row q tiles and 16-tile key
# chunks, U % 128 != 0: the KITTI width (W8 = 156: int8 rows 4-byte
# aligned, bf16 rows 8-byte) and the chairs width (W8 = 62: every 64-key
# tile crosses a grid row), the window's outer ring on.
@pytest.mark.parametrize("grid", BIG_GRIDS)
@pytest.mark.parametrize("md", [32, 64])
@pytest.mark.parametrize("clip", [1e30, 1.0])
def test_b4_bf16_body_at_wide_grids(dev, grid, md, clip):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, seed=5, **_PEAKY)
    _hold_b4(q, k, biases, grid, torch.tensor(clip, device=dev), 1.0)


@pytest.mark.parametrize("grid,rows", [((9, 156), (4, 9)),
                                       ((20, 62), (7, 13))])
def test_b4_bf16_body_on_a_row_shard(dev, grid, rows):
    q, k, biases = _inputs(dev, grid, 32, torch.bfloat16, seed=6, **_PEAKY)
    h0, h1 = rows
    ql = q[:, :, h0 * grid[1]:h1 * grid[1]]
    _hold_b4(ql, k, biases, grid, torch.tensor(1.0, device=dev), 1.0,
             q_row0=h0)


@pytest.mark.parametrize("grid", GRIDS + BIG_GRIDS)
def test_b4_every_rows_largest_numerator_is_127(dev, grid):
    """Sweep 2 subtracts the exact max of the scores that sweep 1 saw:
    each row's largest int8 numerator is 127, not 126 (a max taken from
    part of the row, or rounded, would lose it)."""
    q, k, biases = _inputs(dev, grid, 32, torch.bfloat16, seed=7, **_PEAKY)
    num, _ = ma.mode_softmax_probs(q, k, biases, grid,
                                   torch.tensor(1.0, device=dev), 1.0,
                                   quantized=True)
    assert bool((num.amax(-1) == 127).all())


def test_b4_bf16_tiles_reject_what_they_do_not_take(dev):
    q, k, biases = _inputs(dev, GRIDS[0], 40, torch.bfloat16)
    clip = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        ma.mode_softmax_probs(q, k, biases, GRIDS[0], clip, 1.0,
                              quantized=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        ma.mode_softmax_probs_dense(q, k, None, clip, 1.0)
    q, k, biases = _inputs(dev, GRIDS[0], 32, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_odd = buf[1:].view(q.shape)  # 2 bytes past a 16-byte boundary
    q_odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ma.mode_softmax_probs(q_odd, k, biases, GRIDS[0], clip, 1.0)


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
                                      "corr_norm_write": 0,
                                      "gru_pass_fwd": 0,
                                      "gru_pass_bwd": 0}


def test_unsupported_variants_raise(dev):
    q, k, biases = _inputs(dev, GRIDS[0], 64, torch.float32)
    clip = torch.tensor(1e30, device=dev)
    # F = 192: the kernel takes 128 and 256 (FLASH_FEAT).
    v = torch.randn(2, 4, q.shape[2], 192, generator=_gen(1)).to(dev)
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


# The bf16 bodies of B6 backward and B7 (wgmma tiles) at grids whose rows
# start 8 (6 x 62, as chairs), 4 (7 x 62) and 2 (5 x 13, odd U) bytes off a
# 16-byte unit in bf16, ragged against their 64- and 128-wide tiles, wider
# than B7's 128-column tile (6 x 62) and than a B6 backward block's 576
# keys (10 x 62).
TILE_GRIDS = [(6, 62), (7, 62), (5, 13), (10, 62)]


def _b7_case(dev, grid, md, clip, bm, seed=5):
    """B7's inputs at BM = bm: batch 8 x 4 modes (32) or one (b, mode)."""
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, seed=seed,
                           **_PEAKY)
    if bm == 32:
        q, k = q.repeat(4, 1, 1, 1), k.repeat(4, 1, 1, 1)
    elif bm == 1:
        q, k = q[:1, :1].contiguous(), k[:1, :1].contiguous()
    p = ma.mode_softmax_probs_plain(q, k, biases, grid,
                                    torch.tensor(clip, device=dev), 1.0,
                                    out_dtype=torch.bfloat16)
    g = torch.randn(p.shape, generator=_gen(seed + 1)).to(dev,
                                                          torch.bfloat16)
    return q, k, p, g


@pytest.mark.parametrize("grid", TILE_GRIDS)
@pytest.mark.parametrize("md", [32, 64])
@pytest.mark.parametrize("bm", [1, 8, 32])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b7_bf16_body_on_misaligned_rows(dev, grid, md, bm, clip):
    q, k, p, g = _b7_case(dev, grid, md, clip, bm)
    dc, dlsum = pv.probs_bwd(q, k, p, g, clip)
    wdc, wdlsum = pv.probs_bwd_plain(q, k, p, g, clip)
    keep = _outside_band(q, k, clip)
    # Per row, over the row max: half a bf16 ulp, 2^-8, either side.
    assert _rel(dc.float() * keep, wdc.float() * keep, -1) <= 1e-2
    assert _rel(dlsum, wdlsum) <= 1e-4


@pytest.mark.parametrize("grid", [(6, 62), (5, 13)])
def test_b7_bf16_body_is_deterministic(dev, grid):
    q, k, p, g = _b7_case(dev, grid, 64, 0.4, 32)
    dc, dlsum = pv.probs_bwd(q, k, p, g, 0.4)
    dc2, dlsum2 = pv.probs_bwd(q, k, p, g, 0.4)
    assert torch.equal(dc, dc2) and torch.equal(dlsum, dlsum2)


@pytest.mark.parametrize("grid", TILE_GRIDS)
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("md", [32, 64])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b6_backward_bf16_body_on_ragged_grids(dev, grid, batch, md, clip):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, seed=6, **_PEAKY)
    q, k = q[:batch], k[:batch]
    agg_w = torch.tensor(1.3, device=dev)
    vol = cv.fused_agg_corr_plain(q, k, biases, grid, clip, 0.5, agg_w,
                                  torch.tensor(0.1, device=dev))
    U = q.shape[2]
    g = torch.randn(batch, U, U, generator=_gen(7)).to(dev) + 1.0
    dc, da = cv.agg_corr_bwd(q, k, g, vol, biases, grid, clip, 0.5, agg_w)
    wdc, wda = cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip, 0.5,
                                     agg_w)
    keep = _outside_band(q, k, clip)
    assert _rel(dc * keep, wdc * keep) <= 1e-4
    assert float((da - wda).abs()) <= 1e-4 * float(wda.abs())
    dc2, da2 = cv.agg_corr_bwd(q, k, g, vol, biases, grid, clip, 0.5, agg_w)
    assert torch.equal(dc, dc2) and torch.equal(da, da2)


# B6's forward in bf16 runs B3's sweep: 128-row blocks of two 64-row
# warpgroup halves, 64-key tiles of two 32-key halves.
_AGG = (1.3, 0.1)


def _agg(dev):
    return tuple(torch.tensor(x, device=dev) for x in _AGG)


@pytest.mark.parametrize("grid", TILE_GRIDS)
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("md", [16, 32, 64])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b6_forward_bf16_body_on_ragged_grids(dev, grid, batch, md, clip):
    q, k, biases = _inputs(dev, grid, md, torch.bfloat16, seed=8, **_PEAKY)
    q, k = q[:batch], k[:batch]
    got = cv.fused_agg_corr(q, k, biases, grid, clip, 0.5, *_agg(dev))
    want = cv.fused_agg_corr_plain(q, k, biases, grid, clip, 0.5,
                                   *_agg(dev))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-4
    assert torch.equal(got, cv.fused_agg_corr(q, k, biases, grid, clip, 0.5,
                                              *_agg(dev)))


@pytest.mark.parametrize("fault", ["mode 0", "half window", "wb"])
@pytest.mark.parametrize("clip", [1e30, 0.4])
def test_b6_forward_bound_catches_the_tile_faults(dev, fault, clip):
    """The kernel within 1e-4 of the plain volume, and each fault that
    chip_smoke.py plants against the tiles outside it (10 x 62: five
    128-row blocks, ten 64-key tiles)."""
    import chip_smoke as cs
    name = {"mode 0": cs.B6_MODE0, "half window": cs.B6_HALF_WINDOW,
            "wb": cs.B6_WB}[fault]
    grid = (10, 62)
    q, k, biases = _inputs(dev, grid, 64, torch.bfloat16, seed=9, **_PEAKY)
    got = cv.fused_agg_corr(q, k, biases, grid, clip, 0.5, *_agg(dev))
    want = cv.fused_agg_corr_plain(q, k, biases, grid, clip, 0.5,
                                   *_agg(dev))
    bad = cs.b6_fwd_fault(q, k, ma.window_rows(biases, grid, q, k), clip,
                          0.5, *_agg(dev), name)
    assert _rel(got, want) <= 1e-4 < _rel(bad, want)


def test_b6_forward_bf16_body_rejects_what_it_does_not_take(dev):
    """md a multiple of 16 and 16-byte aligned q and k; fp32 takes md 24
    and any offset."""
    grid = (6, 62)
    q, k, biases = _inputs(dev, grid, 24, torch.bfloat16)
    agg = _agg(dev)
    for fn in (lambda a, b: cv.fused_agg_corr(a, b, biases, grid, 0.4, 0.5,
                                              *agg),
               lambda a, b: cv.fused_agg_corr_dense(a, b, None, 0.4, 0.5,
                                                    *agg)):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(q, k)
        fn(q.float(), k.float())
    q, k, _ = _inputs(dev, grid, 64, torch.bfloat16)
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
    k_off = flat[1:].view(k.shape)  # contiguous, 2 bytes past alignment
    k_off.copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cv.fused_agg_corr(q, k_off, biases, grid, 0.4, 0.5, *agg)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cv.fused_agg_corr_dense(k_off, q, None, 0.4, 0.5, *agg)
    cv.fused_agg_corr(q, k, biases, grid, 0.4, 0.5, *agg)


def test_b6_b7_bf16_bodies_reject_what_they_do_not_take(dev):
    """md a multiple of 16 and 16-byte aligned tensors; fp32 takes md 24
    and any offset."""
    grid = (6, 62)
    q, k, biases = _inputs(dev, grid, 24, torch.bfloat16)
    U = q.shape[2]
    p = torch.rand(2, 4, U, U, generator=_gen(3)).to(dev, torch.bfloat16)
    gv = torch.rand(2, U, U, generator=_gen(4)).to(dev)
    one = torch.tensor(1.0, device=dev)
    for fn in (lambda a, b, pp: pv.probs_bwd(a, b, pp, pp, 0.4),
               lambda a, b, pp: cv.agg_corr_bwd(a, b, gv, gv, biases, grid,
                                                0.4, 0.5, one)):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(q, k, p)
        fn(q.float(), k.float(), p.float())
    q, k, _ = _inputs(dev, grid, 64, torch.bfloat16)

    def off(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        y = flat[1:].view(x.shape)  # contiguous, 2 bytes past alignment
        y.copy_(x)
        return y
    with pytest.raises(ValueError, match="16-byte aligned"):
        pv.probs_bwd(off(q), k, p, p, 0.4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pv.probs_bwd(q, k, off(p), p, 0.4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cv.agg_corr_bwd(q, off(k), gv, gv, biases, grid, 0.4, 0.5, one)
    pv.probs_bwd(q, k, p, p, 0.4)
    cv.agg_corr_bwd(q, k, gv, gv, biases, grid, 0.4, 0.5, one)


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
@pytest.mark.parametrize("md", [16, 32, 48, 64])
def test_b8_flash_attention_dense(dev, dtype, with_table, shape, clip, md):
    q, k, table, v = _dense_inputs(dev, shape, md, dtype, with_table)
    clip_t = torch.tensor(clip, device=dev)
    got = ma.flash_mode_attention_dense(q, k, v, table, clip_t, 0.5)
    want = ma.flash_mode_attention_dense_plain(q, k, v, table, clip_t, 0.5)
    assert got.shape == (2, 4, shape[0], 256) and got.dtype == dtype
    if dtype == torch.bfloat16:  # both bf16: one ulp is <= 2^-7 of a value
        assert _rel(got, want) <= 2e-2
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b8_masked_rows_keep_their_own_key(dev, dtype):
    """The f2 mask at radius 0 leaves each row its own key only: out = v,
    with no NaN from rows whose other keys all sit at -1e9."""
    from craft_tpu_torch.nn.setrans import attention_mask
    q, k, _, v = _dense_inputs(dev, (384, 384), 64, dtype, False)
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


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", [(1240, 1240), (500, 1404), (300, 129)])
@pytest.mark.parametrize("md", [16, 32, 64])
def test_b6_dense_bf16_body_at_wide_shapes(dev, with_table, shape, md):
    """B6 dense's bf16 body (B3's sweep with no bias or a table tile in
    each ring stage) over several 128-row blocks and key groups, ragged
    both ways, U2 odd (129), twice for bit-identity, against the faults
    planted against its tiles."""
    import chip_smoke as cs
    q, k, table, _ = _dense_inputs(dev, shape, md, torch.bfloat16,
                                   with_table)
    agg = _agg(dev)
    got = cv.fused_agg_corr_dense(q, k, table, 0.4, 0.5, *agg)
    want = cv.fused_agg_corr_dense_plain(q, k, table, 0.4, 0.5, *agg)
    assert got.dtype == torch.float32 and got.shape == (2, *shape)
    assert _rel(got, want) <= 1e-4
    assert torch.equal(got, cv.fused_agg_corr_dense(q, k, table, 0.4, 0.5,
                                                    *agg))
    faults = [cs.B6_MODE0, cs.B6_WB] + ([cs.B6_TABLE_ROWS] if with_table
                                        else [])
    for fault in faults:
        bad = cs.b6_fwd_fault(q, k, table, 0.4, 0.5, *agg, fault)
        assert _rel(bad, want) > 1e-4, fault


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


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("shape", [(1240, 1240), (500, 1404)])
@pytest.mark.parametrize("md", [32, 64])
def test_b4_dense_bf16_body_at_wide_shapes(dev, with_table, shape, md):
    """B4 dense's bf16 body over several q tiles and key chunks, rows of
    2480 and 2808 bytes (bf16 rows 16- and 8-byte aligned), no table and
    a table."""
    q, k, table, _ = _dense_inputs(dev, shape, md, torch.bfloat16,
                                   with_table)
    clip_t = torch.tensor(0.4, device=dev)
    got = ma.mode_softmax_probs_dense(q, k, table, clip_t, 1.0)
    want = ma.mode_softmax_probs_dense_plain(q, k, table, clip_t, 1.0,
                                             out_dtype=torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, *shape)
    assert _rel(got, want, -1) <= 1e-2


def test_dense_variants_that_the_kernels_do_not_take_raise(dev):
    q, k, table, v = _dense_inputs(dev, (60, 60), 64, torch.float32, True)
    with pytest.raises(ValueError, match="feature dim"):
        ma.flash_mode_attention_dense(q, k, v[..., :192], table, 1e30, 0.5)
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
    # The same four values blended with the same rounded fp32 operations
    # in the same order: bit for bit.
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=_gen(1)).to(dev)
    shapes = [tuple(lv.shape) for lv in levels]
    dl = lk.corr_lookup_bwd(coords, g, shapes, dtype, radius)
    wdl = lk.corr_lookup_bwd_plain(coords, g, shapes, torch.float32, radius)
    # Each element within one rounding to the level type of the fp32 value.
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 4 * 2.0 ** -23
    for d, w in zip(dl, wdl):
        assert d.dtype == dtype and d.shape == w.shape
        assert bool(((d.float() - w).abs() <= tol * w.abs()).all())


# B5's backward writes 16-byte units that straddle queries where slabs are
# odd: 11 x 15 gives 165, 35, 6 and 1 values a query; batch 3, the radii 0,
# 1, 4 and 7 (each a kernel of its own).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("radius", [0, 1, 4, 7])
def test_b5_backward_at_odd_slabs(dev, dtype, radius):
    levels, coords = _lookup_inputs(dev, 3, 11, 15, dtype)
    g = torch.randn(3, 11, 15, 4 * (2 * radius + 1) ** 2,
                    generator=_gen(2)).to(dev)
    shapes = [tuple(lv.shape) for lv in levels]
    dl = lk.corr_lookup_bwd(coords, g, shapes, dtype, radius)
    again = lk.corr_lookup_bwd(coords, g, shapes, dtype, radius)
    wdl = lk.corr_lookup_bwd_plain(coords, g, shapes, torch.float32, radius)
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 4 * 2.0 ** -23
    for d, a, w in zip(dl, again, wdl):
        assert torch.equal(d, a)
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
@pytest.mark.parametrize("grid,shards", SHARDS[:2] + [
    ((9, 156), [(0, 4), (4, 9)])])
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


# ------------------------------------------------- B10, the fused GRU pass

# (B, H, W, Ch, Cx): odd widths with channels that no tile divides, and the
# full width over rows that span several 64-row tiles and image rows.
GRU_SHAPES = [(2, 5, 9, 16, 24), (1, 4, 70, 128, 384)]
# max |kernel - plain| / max |plain| per tensor.  fp32: sums of up to
# 5 (Ch + Cx) products (rows, for the weight gradients) in another order.
# bf16: an io output may round one ulp (2^-7 of the largest value) the
# other way; the fp32 weight and bias gradients sum exact products of the
# same bf16 operands, of which a few may have rounded the other way.
GRU_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}


def _gru_inputs(dev, shape, dtype, seed=11):
    """The 13 arguments of a pass (stride 1) and a cotangent, seeded: h in
    (-1, 1), x ~ N(0, 1), taps ~ N(0, 1 / (5 (Ch + Cx))) so that each gate's
    pre-activation has unit scale, biases ~ N(0, 0.1^2)."""
    B, H, W, Ch, Cx = shape
    gen = _gen(seed)
    h = torch.randn(B, H * W, Ch, generator=gen).tanh()
    x = torch.randn(B, H * W, Cx, generator=gen)
    std = (5 * (Ch + Cx)) ** -0.5
    ws = [torch.randn(5, c, Ch, generator=gen) * std
          for _ in range(3) for c in (Ch, Cx)]
    bs = [torch.randn(Ch, generator=gen) * 0.1 for _ in range(3)]
    g = torch.randn(B, H * W, Ch, generator=gen)
    return ([h.to(dev, dtype), x.to(dev), *[w.to(dev) for w in ws],
             *[b.to(dev) for b in bs]], g.to(dev))


def _gru_close(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = _rel(a, b)
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_b10_forward(dev, dtype, vertical, shape):
    args, _ = _gru_inputs(dev, shape, dtype)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    got = sg.gru_pass_fwd(*args, *geo)
    want = sg.gru_pass_fwd_plain(*args, *geo)
    _gru_close(got, want, GRU_TOL[dtype][0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
@pytest.mark.parametrize("shape", GRU_SHAPES)
def test_b10_backward(dev, dtype, vertical, shape):
    args, g = _gru_inputs(dev, shape, dtype)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    _, z, r, q = sg.gru_pass_fwd_plain(*args, *geo)
    res = (args[0], args[1], z, r, q, g, *args[2:8])
    got = sg.gru_pass_bwd(*res, *geo)
    want = sg.gru_pass_bwd_plain(*res, *geo)
    io_tol, w_tol = GRU_TOL[dtype]
    _gru_close(got[:2], want[:2], io_tol)
    _gru_close(got[2:], want[2:], w_tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b10_backward_is_deterministic(dev, dtype):
    args, g = _gru_inputs(dev, GRU_SHAPES[1], dtype)
    hout, z, r, q = sg.gru_pass_fwd(*args, 1, GRU_SHAPES[1][2])
    res = (args[0], args[1], z, r, q, g, *args[2:8], 1, GRU_SHAPES[1][2])
    for a, b in zip(sg.gru_pass_bwd(*res), sg.gru_pass_bwd(*res)):
        assert torch.equal(a, b)


# (B, H, W, Ch, Cx) over several of the bf16 forward's 64-row tiles: 2 x 9
# x 20 = 360 rows (5.6 tiles), whose vertical taps (20 and 40 rows apart)
# cross every tile edge, at the full width and with channels that no
# 64-channel stage divides.
GRU_TILED = [(2, 9, 20, 128, 384), (3, 7, 13, 24, 40)]


@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
@pytest.mark.parametrize("shape", GRU_TILED)
def test_b10_forward_across_tiles(dev, vertical, shape):
    args, _ = _gru_inputs(dev, shape, torch.bfloat16)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    got = sg.gru_pass_fwd(*args, *geo)
    want = sg.gru_pass_fwd_plain(*args, *geo)
    _gru_close(got, want, GRU_TOL[torch.bfloat16][0])


@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
def test_b10_forward_is_deterministic(dev, vertical):
    shape = GRU_TILED[0]
    args, _ = _gru_inputs(dev, shape, torch.bfloat16)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    for a, b in zip(sg.gru_pass_fwd(*args, *geo),
                    sg.gru_pass_fwd(*args, *geo)):
        assert torch.equal(a, b)


# 2 x 37 x 61 = 4514 rows: a multiple neither of the bf16 backward's
# 128-row tiles nor of its 64-row weight-gradient steps, in two row splits.
GRU_RAGGED = (2, 37, 61, 128, 384)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
def test_b10_backward_at_ragged_rows(dev, dtype, vertical):
    shape = GRU_RAGGED
    args, g = _gru_inputs(dev, shape, dtype)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    _, z, r, q = sg.gru_pass_fwd_plain(*args, *geo)
    res = (args[0], args[1], z, r, q, g, *args[2:8])
    got = sg.gru_pass_bwd(*res, *geo)
    for a, b in zip(got, sg.gru_pass_bwd(*res, *geo)):
        assert torch.equal(a, b)
    want = sg.gru_pass_bwd_plain(*res, *geo)
    io_tol, w_tol = GRU_TOL[dtype]
    _gru_close(got[:2], want[:2], io_tol)
    _gru_close(got[2:], want[2:], w_tol)


@pytest.mark.parametrize("vertical", [False, True], ids=["h", "v"])
def test_b10_fp32_takes_ragged_channels(dev, vertical):
    """fp32 tiles mask channels that no 8 divides; bf16 ones refuse them."""
    shape = (2, 3, 7, 12, 20)
    args, g = _gru_inputs(dev, shape, torch.float32)
    geo = (shape[2], shape[1] * shape[2]) if vertical else (1, shape[2])
    got = sg.gru_pass_fwd(*args, *geo)
    want = sg.gru_pass_fwd_plain(*args, *geo)
    _gru_close(got, want, GRU_TOL[torch.float32][0])
    res = (args[0], args[1], *want[1:], g, *args[2:8])
    _gru_close(sg.gru_pass_bwd(*res, *geo), sg.gru_pass_bwd_plain(*res, *geo),
               GRU_TOL[torch.float32][1])
    args[0] = args[0].bfloat16()
    with pytest.raises(ValueError, match="multiples of 8"):
        sg.gru_pass_fwd(*args, *geo)


def test_b10_module_on_card_launches_its_kernels(dev, monkeypatch):
    """SepConvGRU(fused='on') on the card: two forward and two backward
    launches a call, none under `static` or with fused='off'; its output
    and gradients against the conv form in fp32 (cuDNN's convs with TF32
    off, or they keep three decimal digits)."""
    from craft_tpu_torch.nn.update import SepConvGRU
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = _gen(12)
    on = SepConvGRU(128, 384, fused="on").to(dev)
    off = SepConvGRU(128, 384).to(dev)
    off.load_state_dict(on.state_dict())
    h = torch.randn(2, 6, 13, 128, generator=gen).tanh().to(dev)
    x = torch.randn(2, 6, 13, 384, generator=gen).to(dev)
    outs = []
    for mod in (on, off):
        launch.reset_launch_counts()
        y = mod(h, x)
        y.square().sum().backward()
        counts = launch.launch_counts()
        n = 2 if mod is on else 0
        assert (counts["gru_pass_fwd"], counts["gru_pass_bwd"]) == (n, n)
        outs.append([y.detach()] + [p.grad for p in mod.parameters()])
    for a, b in zip(*outs):
        assert _rel(a, b) <= 1e-4
    launch.reset_launch_counts()
    on(h, x[..., 128:], static=on.static_contrib(x[..., :128]))
    assert launch.launch_counts()["gru_pass_fwd"] == 0
