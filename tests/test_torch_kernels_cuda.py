"""The four CUDA kernels against their plain versions at small ragged
shapes, bf16 and fp32 inputs, batch 2.  Needs an NVIDIA GPU with nvcc
(sm_90a); skipped elsewhere.  On the card:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: the suite's conftest imports JAX, which the port does not
need on the GPU machine.)
"""

import math

import pytest
import torch

from craft_tpu_torch.ops.kernels import mode_attention as ma

pytestmark = pytest.mark.cuda

GRIDS = [(5, 12), (3, 128)]  # ragged (U=60) and a W8 = 128 grid (U=384)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, grid, md, dtype, seed=0, qk_std=0.7, bias_std=0.5):
    gen = torch.Generator().manual_seed(seed)
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
    v = torch.randn(2, 4, q.shape[2], 256, device=dev).to(dtype)
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
    ma.reset_launch_counts()
    ma.scores_global_max_plain(q, k, 0.2)
    ma.scores_global_max(q, k, 0.2)
    ma.mode_softmax_probs(q, k, biases, GRIDS[0], torch.tensor(1e30,
                                                                device=dev),
                          1.0)
    # B3 launches the B1 kernel as its phase 0: B1's count takes it.
    ma.fused_agg_corr_norm(q, k, biases, GRIDS[0], 100.0, 0.5, one, one)
    assert ma.launch_counts() == {"scores_global_max": 2,
                                  "flash_mode_attention": 0,
                                  "fused_agg_corr_norm": 1,
                                  "mode_softmax_probs": 1}


def test_unsupported_variants_raise(dev):
    q, k, biases = _inputs(dev, GRIDS[0], 64, torch.float32)
    clip = torch.tensor(1e30, device=dev)
    v = torch.randn(2, 4, q.shape[2], 128, device=dev)
    with pytest.raises(ValueError, match="feature dim"):
        ma.flash_mode_attention(q, k, v, biases, GRIDS[0], clip, 0.5)
    one = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="fp32 -> fp32"):
        ma.fused_agg_corr_norm(q, k, biases, GRIDS[0], 100.0, 0.5, one, one,
                               out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 output only"):
        ma.mode_softmax_probs(q, k, biases, GRIDS[0], clip, 1.0,
                              quantized=True)
