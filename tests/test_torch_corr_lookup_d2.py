"""B5 at D = 2 (two-way correlation, --f1) on the CPU: the port's plain
lookup and backward over L levels of two planes each, and the D = 2
pyramid, against the JAX package, which interleaves D into the lane axis
of one [Q, h, w * D] array a level (``craft_tpu/ops/corr.py:24-30``):
the forward against ``corr_lookup_gather``, ``corr_lookup_mxu`` and the
Pallas ``_lookup_all_levels`` in interpret mode (through
``corr_lookup_pallas``), the backward against ``jax.vjp`` of
``corr_lookup_tpu``, at 1 and 4 levels and radii 0, 3 and 4; a float64
gradcheck of the Function at D = 2; ``build_pyramid`` of a [B, U1, 2, U2]
volume with the per-(batch, d) norm against JAX's.

Tolerances as ``tests/test_torch_corr_lookup.py``: 1e-5 (fp32 sums in
another order, values of std 1); the pyramid 1e-5 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.ops import corr as jc
from craft_tpu.ops.pallas.corr_lookup import (corr_lookup_pallas,
                                              corr_lookup_tpu)
from craft_tpu_torch.ops import corr as tc
from craft_tpu_torch.ops.kernels import corr_lookup as lk
from test_torch_corr_lookup import _coords

B, H1, W1, D = 2, 5, 7, 2
ATOL = 1e-5
# Levels of odd sizes, the last a single value (Pallas in interpret mode
# cannot index a level pooled to zero rows).
SHAPES = [(7, 12), (3, 6), (1, 3), (1, 1)]


def _planes(rng, shapes, q=B * H1 * W1):
    """Seeded planes [Q, h, w] in (level, d) order."""
    return [rng.randn(q, h, w).astype(np.float32)
            for h, w in shapes for _ in range(D)]


def _jax_pyr(planes, radius, dtype=jnp.float32):
    """The JAX pyramid of the same planes: d interleaved into the lanes."""
    levels = tuple(jnp.asarray(np.stack(planes[l:l + D], -1).reshape(
        planes[l].shape[0], planes[l].shape[1], -1), dtype)
        for l in range(0, len(planes), D))
    return jc.CorrPyramid(levels, B, H1, W1, radius, dim=D)


def _deinterleave(levels):
    return [np.asarray(lv, np.float32).reshape(
        lv.shape[0], lv.shape[1], lv.shape[2] // D, D)[..., d]
        for lv in levels for d in range(D)]


@pytest.mark.parametrize("radius", [0, 3, 4])
@pytest.mark.parametrize("n_levels", [1, 4])
def test_plain_forward_matches_jax_lookups(rng, n_levels, radius):
    planes = _planes(rng, SHAPES[:n_levels])
    coords = _coords(rng)
    got = lk.corr_lookup_plain([torch.from_numpy(p) for p in planes],
                               torch.from_numpy(coords), radius, D).numpy()
    n2 = (2 * radius + 1) ** 2
    assert got.shape == (B, H1, W1, n_levels * D * n2)
    pyr, jcoords = _jax_pyr(planes, radius), jnp.asarray(coords)
    for name, fn in (("gather", jc.corr_lookup_gather),
                     ("mxu", jc.corr_lookup_mxu),
                     ("pallas", lambda p, c: corr_lookup_pallas(
                         p, c, interpret=True))):
        want = np.asarray(fn(pyr, jcoords))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
    # Channel block p is plane p alone: (level, d, i, j).
    one = lk.corr_lookup_plain([torch.from_numpy(planes[-1])],
                               torch.from_numpy(coords / 2.0 ** (n_levels
                                                                 - 1)),
                               radius).numpy()
    np.testing.assert_allclose(got[..., -n2:], one, atol=ATOL)


@pytest.mark.parametrize("radius", [0, 3, 4])
@pytest.mark.parametrize("n_levels", [1, 4])
def test_plain_backward_matches_jax_vjp(rng, n_levels, radius):
    planes = _planes(rng, SHAPES[:n_levels])
    coords = _coords(rng)
    n2 = (2 * radius + 1) ** 2
    g = rng.randn(B, H1, W1, n_levels * D * n2).astype(np.float32)
    pyr = _jax_pyr(planes, radius)

    def fwd(levels):
        return corr_lookup_tpu(pyr._replace(levels=levels),
                               jnp.asarray(coords), interpret=True)

    _, vjp = jax.vjp(fwd, pyr.levels)
    (want,) = vjp(jnp.asarray(g))
    got = lk.corr_lookup_bwd_plain(torch.from_numpy(coords),
                                   torch.from_numpy(g),
                                   [p.shape for p in planes], torch.float32,
                                   radius, D)
    for d, w in zip(got, _deinterleave(want)):
        np.testing.assert_allclose(d.numpy(), w, atol=ATOL)


def test_function_gradcheck_float64_two_planes(rng):
    planes = [torch.from_numpy(p).double().requires_grad_()
              for p in _planes(rng, [(3, 4), (1, 2)], q=6)]
    coords = torch.from_numpy(_coords(rng, b=1, h1=2, w1=3, span=5.0))
    assert torch.autograd.gradcheck(
        lambda *p: lk.corr_lookup_diff(p, coords, 1, D), planes)


@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_build_pyramid_two_way_matches_jax(rng, hw):
    """[B, U1, 2, U2] -> 4 levels of two planes, each normed per
    (batch, d) and pooled on its own, against JAX's interleaved levels;
    the lookup over them against JAX's."""
    h, w = hw
    corr = rng.randn(B, h * w, D, h * w).astype(np.float32) * 3 + 1
    got = tc.build_pyramid(torch.from_numpy(corr), B, h, w,
                           do_global_norm=True)
    want = jc.build_pyramid(jnp.asarray(corr), B, h, w, do_global_norm=True)
    assert got.dim == D and len(got.levels) == 4 * D
    for a, b in zip(got.levels, _deinterleave(want.levels)):
        assert a.is_contiguous()
        assert a.shape == b.shape
        if b.size:
            np.testing.assert_allclose(a.numpy(), b,
                                       atol=ATOL * np.abs(b).max())
    coords = _coords(rng, b=B, h1=h, w1=w, span=8.0)
    np.testing.assert_allclose(
        tc.corr_lookup(got, torch.from_numpy(coords)).numpy(),
        np.asarray(jc.corr_lookup_mxu(want, jnp.asarray(coords))), atol=1e-4)


def test_pyramid_from_level0_takes_a_plane_a_direction(rng):
    """The eval route's pyramid of two normed [B, U1, U2] volumes equals
    build_pyramid's of the same volumes stacked (no norm: they are
    normed), plane for plane, and is (level, d) ordered."""
    h, w = 4, 6
    vols = [rng.randn(B, h * w, h * w).astype(np.float32) for _ in range(D)]
    got = tc.pyramid_from_level0(tuple(torch.from_numpy(v) for v in vols),
                                 B, h, w, level_dtype=torch.float32)
    want = tc.build_pyramid(torch.from_numpy(np.stack(vols, 2)), B, h, w)
    assert got.dim == want.dim == D
    for a, b in zip(got.levels, want.levels):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(got.levels[1].numpy(),
                                  vols[1].reshape(B * h * w, h, w))


@pytest.mark.parametrize("radius", range(8))
@pytest.mark.parametrize("planes", [4, 8])
def test_every_lookup_forward_fits_its_static_smem(planes, radius):
    """lookup_fwd_kernel<T, radius, NP>'s corner buffer, buf[NW][NP MM]
    floats with NW = fwd_warps(NP, radius), within a block's 48 KB of
    static shared memory; NP = 4 keeps the one-way kernel's 8 warps."""
    from test_torch_kernel_grids import _defines

    d = _defines("corr_lookup.cu")
    mm = (2 * radius + 2) ** 2
    nw = min(d["WARPS"], d["FWD_SMEM"] // (planes * mm * 4))
    assert d["MAXP"] == 8 and nw >= 1
    assert nw * planes * mm * 4 <= d["FWD_SMEM"] == 49152
    if planes == 4:
        assert nw == d["WARPS"] == 8
