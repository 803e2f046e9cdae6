"""GMA attention and aggregation, the plain volume and packed upsampling of
the port against the JAX package on the CPU.

* ``rel_pos_index`` and ``RelPosEmb`` at grid sides up to 320 (HD1K's W8),
  beyond the 319-row tables: JAX's gather wraps a negative index once and
  clamps the rest, and the port reads the same rows, bit for bit.
* ``Attention`` in its three position modes, one and two heads, fp32 and
  bf16, one case on a grid 170 wide; ``Aggregate`` with gamma seeded
  nonzero, one head (no ``project``) and two.  fp32 within 1e-6 (probs) and
  1e-5 (features) of the largest value; bf16 within 2^-7 of it, one bf16
  rounding of the output (both frameworks take the same bf16 inputs and
  round each fp32 sum once, in another order).
* The plain volume and its pyramid (fp32 within 1e-6 relative; bf16
  levels within one bf16 rounding).
* ``convex_upsample_packed`` (1e-6 of the largest value: the two
  frameworks' exp differ in the last bit), ``unpack_upsampled`` and
  ``pack_fullres`` (exact), and ``sequence_loss_packed`` against JAX's and
  the port's unpacked loss (1e-6 relative: the same terms summed in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craft_tpu.nn import gma as jgma
from craft_tpu.ops import corr as jcorr
from craft_tpu.ops import geometry as jgeo
from craft_tpu.training import loss as jloss
from craft_tpu_torch.nn import gma as tgma
from craft_tpu_torch.ops import corr as tcorr
from craft_tpu_torch.ops import geometry as tgeo
from craft_tpu_torch.training import loss as tloss
from craft_tpu_torch.utils.weights import state_dict_from_flax

BF16_TOL = 2.0 ** -7


def _init(module, *args):
    """The module's params from jax.eval_shape, seeded as PyTorch
    initialises them (uniform within 1/sqrt(fan in); tables N(0, 1)),
    gamma 0.7."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(3)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v)
            elif k == "gamma":
                out[k] = np.full(v.shape, 0.7, np.float32)
            elif k in ("rel_height", "rel_width"):
                out[k] = rng.randn(*v.shape).astype(np.float32)
            else:
                b = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
                out[k] = rng.uniform(-b, b, v.shape).astype(np.float32)
        return out
    return fill(shapes)


def _dtypes(bf16):
    return (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                        torch.float32)


def _close(got, want, bf16, rel=1e-5):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    tol = BF16_TOL * scale if bf16 else rel * max(scale, 1e-1)
    print(f"max |diff| {err:.3e}, max |want| {scale:.3e}, bound {tol:.3e}")
    assert err <= tol


@pytest.mark.parametrize("n", [5, 159, 160, 161, 240, 320])
def test_rel_pos_index_reads_jax_rows(n):
    """The rows JAX's gather reads for every (i, j), at sides on both sides
    of max_pos_size = 160."""
    rows = 2 * 160 - 1
    ar = jnp.arange(n)
    raw = ar[None, :] - ar[:, None] + 160 - 1
    want = np.asarray(jnp.arange(rows)[raw])
    got = tgma.rel_pos_index(n, 160).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(4, 170), (200, 3)])
def test_rel_pos_emb_beyond_the_table_is_exact(h, w):
    """RelPosEmb on a grid side past 160, each query one-hot on one feature:
    every score is emb_h[u - x] + emb_w[v - y] of that feature, one fp32
    add, so the two frameworks agree bit for bit only if they read the same
    table rows."""
    d = 8
    mod = jgma.RelPosEmb(max_pos_size=160, dim_head=d)
    rng = np.random.RandomState(0)
    params = {"rel_height": rng.randn(319, d).astype(np.float32),
              "rel_width": rng.randn(319, d).astype(np.float32)}
    q = np.zeros((1, 1, h, w, d), np.float32)
    q[..., 5] = 1.0
    want = np.asarray(mod.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(q)))
    port = tgma.RelPosEmb(160, d)
    port.load_state_dict(state_dict_from_flax({"params": params}),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(q), h, w).numpy()
    np.testing.assert_array_equal(got, want)


ATTENTION_CASES = [
    ("content", 1, (6, 8), False), ("content", 2, (6, 8), True),
    ("position_only", 1, (6, 8), False), ("position_only", 2, (6, 8), True),
    ("position_and_content", 1, (6, 8), True),
    ("position_and_content", 2, (6, 8), False),
    ("position_and_content", 1, (2, 170), False),
    ("position_only", 1, (2, 170), True)]


@pytest.mark.parametrize("mode,heads,grid,bf16", ATTENTION_CASES)
def test_attention_matches_jax(mode, heads, grid, bf16):
    jdt, tdt = _dtypes(bf16)
    h, w = grid
    flags = dict(position_only=mode == "position_only",
                 position_and_content=mode == "position_and_content")
    jmod = jgma.Attention(dim=128, heads=heads, dim_head=128, dtype=jdt,
                          **flags)
    fmap = np.random.RandomState(1).uniform(0, 1.5, (2, h, w, 128)).astype(
        np.float32)
    params = _init(jmod, jnp.asarray(fmap))
    want = np.asarray(jmod.apply(
        {"params": jax.tree.map(jnp.asarray, params)},
        jnp.asarray(fmap)).astype(jnp.float32))
    port = tgma.Attention(128, 160, heads, 128, dtype=tdt, **flags)
    port.load_state_dict(state_dict_from_flax({"params": params}),
                         strict=True)
    x = torch.from_numpy(fmap)
    with torch.no_grad():
        chunked = port(x)
    got = port(x)  # gradients on: one piece
    assert got.dtype == tdt and got.shape == (2, heads, h * w, h * w)
    torch.testing.assert_close(chunked, got.detach(), rtol=0, atol=0)
    _close(got.detach(), want, bf16, rel=1e-6)


def test_attention_rows_in_chunks(monkeypatch):
    """Outside autograd the attention is built a grid row at a time (the
    chunk forced down to one row) with the same values."""
    port = tgma.Attention(128, 160, 1, 128, position_and_content=True)
    x = torch.rand(1, 5, 7, 128)
    with torch.no_grad():
        whole = port(x)
        monkeypatch.setattr(tgma, "ROW_CHUNK_ELEMS", 1)
        rows = port(x)
    torch.testing.assert_close(rows, whole, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("heads,bf16", [(1, False), (2, False), (1, True),
                                        (2, True)])
def test_aggregate_matches_jax(heads, bf16):
    jdt, tdt = _dtypes(bf16)
    h, w = 5, 7
    rng = np.random.RandomState(2)
    attn = rng.uniform(0, 1, (2, heads, h * w, h * w)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    fmap = rng.randn(2, h, w, 128).astype(np.float32)
    jmod = jgma.Aggregate(dim=128, heads=heads, dim_head=128, dtype=jdt)
    params = _init(jmod, jnp.asarray(attn), jnp.asarray(fmap))
    assert ("project" in params) == (heads != 1)
    a_j, f_j = (jnp.asarray(v).astype(jdt) for v in (attn, fmap))
    want = np.asarray(jmod.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, a_j,
        f_j).astype(jnp.float32))
    port = tgma.Aggregate(128, heads, 128, dtype=tdt)
    port.load_state_dict(state_dict_from_flax({"params": params}),
                         strict=True)
    got = port(torch.from_numpy(attn).to(tdt), torch.from_numpy(fmap).to(tdt))
    assert got.dtype == tdt
    # The gated term is well above the bound, so a gamma, a head or a
    # projection that took no effect would show.
    gated = float(np.abs(want - np.asarray(f_j.astype(jnp.float32))).max())
    assert gated > 4 * BF16_TOL * float(np.abs(want).max())
    _close(got.detach(), want, bf16)


@pytest.mark.parametrize("level_dtype", ["float32", "bfloat16"])
def test_plain_pyramid_matches_jax(level_dtype):
    rng = np.random.RandomState(4)
    f1, f2 = (rng.randn(2, 8, 16, 256).astype(np.float32) for _ in range(2))
    want_vol = np.asarray(jcorr.all_pairs_correlation(jnp.asarray(f1),
                                                      jnp.asarray(f2)))
    got_vol = tcorr.all_pairs_correlation(torch.from_numpy(f1),
                                          torch.from_numpy(f2))
    _close(got_vol, want_vol, False, rel=1e-6)
    want = jcorr.plain_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, 4,
                                    level_dtype=getattr(jnp, level_dtype))
    got = tcorr.plain_corr_pyramid(torch.from_numpy(f1),
                                   torch.from_numpy(f2), 4, 4,
                                   level_dtype=getattr(torch, level_dtype))
    assert (got.batch, got.h1, got.w1, got.radius) == (2, 8, 16, 4)
    for g, w_ in zip(got.levels, want.levels):
        assert tuple(g.shape) == w_.shape and str(g.dtype)[6:] == \
            str(w_.dtype)
        _close(g, np.asarray(w_.astype(jnp.float32)),
               level_dtype == "bfloat16", rel=1e-6)


def test_packed_layouts_match_jax():
    rng = np.random.RandomState(5)
    flow = rng.randn(2, 3, 4, 2).astype(np.float32) * 3
    mask = rng.randn(2, 3, 4, 576).astype(np.float32)
    want = np.asarray(jgeo.convex_upsample_packed(jnp.asarray(flow),
                                                  jnp.asarray(mask)))
    got = tgeo.convex_upsample_packed(torch.from_numpy(flow),
                                      torch.from_numpy(mask))
    assert got.shape == (2, 3, 4, 128)
    _close(got, want, False, rel=1e-6)
    # The layout functions move values only: exact.
    np.testing.assert_array_equal(
        tgeo.unpack_upsampled(torch.from_numpy(want)).numpy(),
        np.asarray(jgeo.unpack_upsampled(jnp.asarray(want))))
    full = rng.randn(2, 24, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.pack_fullres(torch.from_numpy(full)).numpy(),
        np.asarray(jgeo.pack_fullres(jnp.asarray(full))))
    # The port's packed and unpacked upsampling share their values.
    torch.testing.assert_close(
        tgeo.unpack_upsampled(got),
        tgeo.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask)),
        rtol=0, atol=0)


def test_sequence_loss_packed_matches_jax():
    rng = np.random.RandomState(6)
    n, B, H, W = 3, 2, 16, 24
    packed = (rng.randn(n, B, H // 8, W // 8, 128) * 3).astype(np.float32)
    gt = (rng.randn(B, H, W, 2) * 3).astype(np.float32)
    gt[0, 0, 0] = 500.0  # past MAX_FLOW: left out
    valid = (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)
    want_loss, want_m = jloss.sequence_loss_packed(
        jnp.asarray(packed), jnp.asarray(gt), jnp.asarray(valid))
    got_loss, got_m = tloss.sequence_loss_packed(
        torch.from_numpy(packed), torch.from_numpy(gt),
        torch.from_numpy(valid))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-6, err_msg=k)
    unpacked = torch.stack([tgeo.unpack_upsampled(torch.from_numpy(p))
                            for p in packed])
    loss, m = tloss.sequence_loss(unpacked, torch.from_numpy(gt),
                                  torch.from_numpy(valid))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    for k in m:
        np.testing.assert_allclose(float(got_m[k]), float(m[k]), rtol=1e-6,
                                   err_msg=k)
