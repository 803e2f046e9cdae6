"""B5 on the CPU: the port's plain lookup, its plain backward and the
autograd Function around them, against the JAX package's Pallas lookup
(interpret mode), its MXU lookup and the VJP that ``corr_lookup_tpu`` takes.

Levels are made with numpy from a seed at odd sizes, one pooled to zero
rows (the MXU lookup takes it; Pallas in interpret mode cannot index an
empty block, so the Pallas comparisons use the three levels above it);
coords fall inside, on the edge, partly and wholly outside every level.

Tolerances: fp32 sums of the same taps in another order, 1e-5 of values of
std 1.  With bf16 levels the JAX lookups round their intermediates to bf16
(the Pallas kernel its hat weights and its row pass, the MXU lookup and its
VJP their products), so there the port is held to 2^-6 of the largest
value: a few bf16 roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops.corr import CorrPyramid, corr_lookup_mxu
from craft_tpu.ops.pallas.corr_lookup import (corr_lookup_pallas,
                                              corr_lookup_tpu)
from craft_tpu_torch.ops import corr as tc
from craft_tpu_torch.ops.kernels import corr_lookup as lk

B, H1, W1, R = 2, 5, 7, 4
# Level sizes: odd, a single row, and one pooled away to zero rows.
SHAPES = [(7, 12), (3, 6), (1, 3), (0, 1)]
PALLAS_SHAPES = SHAPES[:3]
ATOL = 1e-5
BF16_TOL = 2.0 ** -6


def _levels(rng, shapes=SHAPES, q=B * H1 * W1):
    return [rng.randn(q, h, w).astype(np.float32) for h, w in shapes]


def _coords(rng, b=B, h1=H1, w1=W1, span=14.0):
    c = rng.uniform(-6.0, span, (b, h1, w1, 2)).astype(np.float32)
    c = c.reshape(-1, 2)
    c[0] = [0.0, 0.0]          # integer, on the corner
    c[1] = [11.0, 6.0]         # integer, on the far edge
    c[2] = [3.0, 2.5]          # integer x, fractional y
    c[3] = [-40.0, 70.0]       # wholly outside every level
    c[4] = [-4.5, -3.25]       # partly outside
    return c.reshape(b, h1, w1, 2)


def _bf16(x):
    """x rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _jax_pyr(levels, dtype):
    return CorrPyramid(tuple(jnp.asarray(lv, dtype) for lv in levels), B, H1,
                       W1, R)


def _torch_levels(levels, dtype):
    return [torch.from_numpy(lv).to(getattr(torch, dtype)) for lv in levels]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_and_mxu(rng, dtype):
    levels = _levels(rng)
    if dtype == "bfloat16":
        levels = [_bf16(lv) for lv in levels]
    coords = _coords(rng)
    tcoords, jcoords = torch.from_numpy(coords), jnp.asarray(coords)
    got = lk.corr_lookup_plain(_torch_levels(levels, dtype), tcoords,
                               R).numpy()
    assert got.shape == (B, H1, W1, 4 * 81) and got.dtype == np.float32
    tol = ATOL if dtype == "float32" else BF16_TOL * max(
        float(np.abs(lv).max()) for lv in levels if lv.size)
    want = np.asarray(corr_lookup_mxu(_jax_pyr(levels, getattr(jnp, dtype)),
                                      jcoords))
    np.testing.assert_allclose(got, want, atol=tol)
    # The wholly outside query reads zero on every level, the empty level
    # zero everywhere.
    assert not got.reshape(-1, 4 * 81)[3].any() and not got[..., 243:].any()

    n3 = len(PALLAS_SHAPES)
    pallas = np.asarray(corr_lookup_pallas(
        _jax_pyr(levels[:n3], getattr(jnp, dtype)), jcoords, interpret=True))
    np.testing.assert_allclose(got[..., :n3 * 81], pallas, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(rng, dtype):
    levels = [_bf16(lv) for lv in _levels(rng, PALLAS_SHAPES)]
    coords = _coords(rng)
    g = rng.randn(B, H1, W1, len(levels) * 81).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jlevels = tuple(jnp.asarray(lv, jdt) for lv in levels)

    def fwd(lvls):
        return corr_lookup_tpu(CorrPyramid(lvls, B, H1, W1, R),
                               jnp.asarray(coords), interpret=True)

    _, vjp = jax.vjp(fwd, jlevels)
    (want,) = vjp(jnp.asarray(g))
    got = lk.corr_lookup_bwd_plain(torch.from_numpy(coords),
                                   torch.from_numpy(g),
                                   [lv.shape for lv in levels],
                                   getattr(torch, dtype), R)
    for d, w, lv in zip(got, want, levels):
        assert d.shape == lv.shape and d.dtype == getattr(torch, dtype)
        w = np.asarray(w, np.float32)
        tol = ATOL if dtype == "float32" else BF16_TOL * np.abs(w).max()
        np.testing.assert_allclose(d.float().numpy(), w, atol=tol)


def test_function_gradcheck_float64(rng):
    shapes = [(3, 4), (1, 2)]
    levels = [torch.from_numpy(lv).double().requires_grad_()
              for lv in _levels(rng, shapes, q=6)]
    coords = torch.from_numpy(_coords(rng, b=1, h1=2, w1=3, span=5.0))
    assert torch.autograd.gradcheck(
        lambda *lv: lk.corr_lookup_diff(lv, coords, 1), levels)


def test_function_matches_plain_and_coords_get_no_gradient(rng):
    levels = [torch.from_numpy(lv).requires_grad_()
              for lv in _levels(rng)]
    coords = torch.from_numpy(_coords(rng)).requires_grad_()
    g = torch.from_numpy(rng.randn(B, H1, W1, 4 * 81).astype(np.float32))
    out = lk.corr_lookup_diff(levels, coords, R)
    (out * g).sum().backward()
    assert coords.grad is None
    want = lk.corr_lookup_plain([lv.detach() for lv in levels],
                                coords.detach(), R)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    wgrads = lk.corr_lookup_bwd_plain(coords, g, [lv.shape for lv in levels],
                                      torch.float32, R)
    for lv, w in zip(levels, wgrads):
        torch.testing.assert_close(lv.grad, w, rtol=0, atol=0)
    assert not levels[3].grad.numel()


def test_cpu_tensors_take_the_plain_versions(rng):
    levels = [torch.from_numpy(lv) for lv in _levels(rng)]
    coords = torch.from_numpy(_coords(rng))
    pyr = tc.CorrPyramid(tuple(levels), B, H1, W1, R)
    lk.corr_lookup.launches = lk.corr_lookup_bwd.launches = 0
    want = lk.corr_lookup_plain(levels, coords, R)
    got = tc.corr_lookup(pyr, coords)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.inference_mode():  # serving: the Function records nothing
        torch.testing.assert_close(tc.corr_lookup(pyr, coords), want,
                                   rtol=0, atol=0)
    lk.corr_lookup_bwd(coords, torch.ones_like(got),
                       [lv.shape for lv in levels], torch.float32, R)
    assert lk.corr_lookup.launches == lk.corr_lookup_bwd.launches == 0
