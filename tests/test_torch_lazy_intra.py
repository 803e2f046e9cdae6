"""The lazy intra attention (``LazyModeAttention``) against the JAX
package, on the CPU.

* The switch: the intra site hands the aggregator (q, k, the window, the
  clamp) in place of probs exactly where the JAX package's formula says
  (``craft_tpu/nn/setrans.py:725-738``: B * M * U1 * U2 * itemsize of the
  compute dtype > 4e9), and never under a row shard, lsinu, a dense table
  or training.
* The module: the port's aggregator fed its LazyModeAttention against the
  JAX ExpandedFeatTrans fed the JAX one (Pallas in interpret mode), at the
  JAX lazy test's bound (``tests/test_pallas_batched.py:174-216``).
* The whole model: the oracle at 128x128 with the threshold at 0, so that
  its intra site goes lazy, within the oracle's two bounds.
"""

import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.nn.setrans import ExpandedFeatTrans as JaxExpandedFeatTrans
from craft_tpu.nn.setrans import LazyModeAttention as JaxLazy
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.nn import setrans
from craft_tpu_torch.nn.setrans import (ExpandedFeatTrans, LazyModeAttention,
                                        QuantizedProbs, SelfAttVisPosTrans)
from craft_tpu_torch.parallel.sp import RowShard
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

ORACLE = Path(__file__).resolve().parent / "data" / "oracle_craft_128.npz"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (case, B, token grid, compute dtype, whether the probs go lazy):
# HD1K's 1080x2560 and 1088x1920 frames padded to a multiple of 8, and
# Sintel's 440x1024 at the batches either side of the threshold.
SWITCH_CASES = [
    ("hd1k bf16", 1, (136, 320), "bfloat16", True),
    ("hd1k fp32", 1, (136, 320), "float32", True),
    ("1088x1920 bf16", 1, (136, 240), "bfloat16", True),
    ("sintel batch 10 bf16", 10, (55, 128), "bfloat16", False),
    ("sintel batch 11 bf16", 11, (55, 128), "bfloat16", True),
    ("sintel batch 5 fp32", 5, (55, 128), "float32", False),
    ("sintel batch 6 fp32", 6, (55, 128), "float32", True),
    ("sintel batch 1 bf16", 1, (55, 128), "bfloat16", False),
]


@pytest.mark.parametrize("case,B,grid,dtype,lazy", SWITCH_CASES,
                         ids=[c[0] for c in SWITCH_CASES])
def test_switch_follows_the_jax_formula(case, B, grid, dtype, lazy):
    M = 4
    U = grid[0] * grid[1]
    jax_lazy = B * M * U * U * jnp.dtype(dtype).itemsize > 4e9
    assert jax_lazy == lazy, case
    assert setrans.probs_go_lazy(B, M, U, U, getattr(torch, dtype)) == lazy


GRID = (5, 12)


def _intra_site(pos_code_type="bias", quantize=True, seed=0):
    cfg = dataclasses.replace(
        tconfig.intra_attn_config(pos_code_type=pos_code_type),
        quantize_probs=quantize)
    torch.manual_seed(seed)
    site = SelfAttVisPosTrans(cfg, torch.bfloat16 if quantize
                              else torch.float32).eval()
    with torch.no_grad():
        if pos_code_type == "bias":
            site.vispos_encoder.pos_coder.biases.normal_()
    x = torch.randn(2, *GRID, cfg.in_feat_dim)
    return site, x


class _OneRank(RowShard):
    """A row shard of one rank: every row, no collective."""

    def __init__(self, H8, W8):
        super().__init__(types.SimpleNamespace(world=1, rank=0), H8, W8)

    def all_max(self, x):
        return x


def test_site_goes_lazy_past_the_threshold_only(monkeypatch):
    site, x = _intra_site()
    with torch.no_grad():
        assert isinstance(site(x), QuantizedProbs)
        B, (H8, W8) = 2, GRID
        U = H8 * W8
        # 2 bytes a prob: bf16, though the stored probs are int8.
        monkeypatch.setattr(setrans, "LAZY_PROBS_BYTES", B * 4 * U * U * 2)
        assert isinstance(site(x), QuantizedProbs)
        monkeypatch.setattr(setrans, "LAZY_PROBS_BYTES",
                            B * 4 * U * U * 2 - 1)
        lazy = site(x)
    assert isinstance(lazy, LazyModeAttention)
    assert lazy.q.shape == lazy.k.shape == (B, 4, U, 32)
    assert (lazy.H, lazy.W) == GRID and lazy.pos_w == 1.0
    assert lazy.biases is site.vispos_encoder.pos_coder.biases


@pytest.mark.parametrize("where", ["shard", "lsinu", "dense table",
                                   "training"])
def test_site_never_goes_lazy(monkeypatch, where):
    monkeypatch.setattr(setrans, "LAZY_PROBS_BYTES", 0)
    site, x = _intra_site("lsinu" if where == "lsinu" else "bias")
    kw = {}
    if where == "shard":
        kw["shard"] = _OneRank(*GRID)
    if where == "training":
        site.train()
        kw["generator"] = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if where == "dense table":
            tokens, pos_biases = site.vispos_encoder(x)
            U = GRID[0] * GRID[1]
            out = site.setrans(tokens, pos_biases=pos_biases,
                               attention_mask=torch.zeros(U, U))
        else:
            out = site(x, **kw)
    assert not isinstance(out, LazyModeAttention)
    assert isinstance(out, (torch.Tensor, QuantizedProbs))


@pytest.mark.parametrize("clip", [1e30, 0.5])
def test_lazy_aggregator_matches_jax(clip):
    """The port's ExpandedFeatTrans fed a LazyModeAttention against the JAX
    one fed the JAX LazyModeAttention (flash_mode_attention_mt in interpret
    mode), same seeded inputs and weights: atol 5e-5, rtol 1e-4."""
    rng = np.random.RandomState(0)
    H8, W8, B = 4, 32, 2
    U = H8 * W8
    jsite = jconfig.intra_attn_config()
    jagg = jconfig.intra_aggregator_config(jsite)
    M, md, F = jsite.num_modes, jsite.mode_dim, jsite.feat_dim
    q = rng.randn(B, M, U, md).astype(np.float32)
    k = rng.randn(B, M, U, md).astype(np.float32)
    R = jsite.pos_bias_radius
    biases = rng.randn(2 * R + 1, 2 * R + 1).astype(np.float32)
    motion = rng.randn(B, U, F).astype(np.float32)
    jlazy = JaxLazy(q=jnp.asarray(q), k=jnp.asarray(k),
                    biases=jnp.asarray(biases), H=H8, W=W8,
                    clip_val=jnp.float32(clip), pos_w=jsite.pos_code_weight)
    jmod = JaxExpandedFeatTrans(jagg)
    p0 = np.zeros((B, M, U, U), np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(motion),
                       jnp.asarray(p0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + rng.randn(
        *np.shape(a)).astype(np.float32) * 0.05, params)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(motion),
                                 jlazy))

    agg = ExpandedFeatTrans(tconfig.intra_aggregator_config(
        tconfig.intra_attn_config())).eval()
    agg.load_state_dict(state_dict_from_flax({"params": params}),
                        strict=True)
    lazy = LazyModeAttention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(biases), H8, W8,
                             torch.tensor(clip), jsite.pos_code_weight)
    with torch.no_grad():
        got = agg(torch.from_numpy(motion), lazy).numpy()
    assert got.shape == want.shape == (B, U, F)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("mixed_precision,bound", [(False, 1e-3),
                                                   (True, 0.15)])
def test_lazy_oracle_flow(monkeypatch, mixed_precision, bound):
    """The oracle through the port with the threshold at 0: the intra site
    gives a LazyModeAttention, the aggregator applies it each iteration,
    and the flow stays within the oracle's bound."""
    monkeypatch.setattr(setrans, "LAZY_PROBS_BYTES", 0)
    img1, img2, want, tree = load_oracle_npz(ORACLE)
    model = create_model(craft_config(mixed_precision=mixed_precision),
                         device="cpu")
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    seen = []
    model.att.register_forward_hook(lambda m, i, o: seen.append(type(o)))
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                         iters=12)
    assert seen == [LazyModeAttention]
    got = flows[-1].numpy()
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"mixed_precision={mixed_precision}: lazy max |flow diff| "
          f"{err:.3e} px")
    assert err < bound


# chip_smoke.py's phase-2 check of B2 at F 128 (md 32), run on the CPU at
# small grids: on CPU tensors the wrapper takes its plain version, so the
# check passes; a fault planted in the wrapper must fail it.
SMOKE_GRIDS = (("small", (6, 20)), ("ragged", (5, 13)))


def _b2_lazy_check():
    import chip_smoke
    report = {"flash_mode_attention_f128": {}}
    chip_smoke.check_b2_lazy(torch.device("cpu"),
                             torch.Generator().manual_seed(0), report,
                             grids=SMOKE_GRIDS, hd1k=(6, 20), last=2)
    return report["flash_mode_attention_f128"]["max_abs_err"]


def test_b2_lazy_checks_pass_the_plain_version():
    assert 0.0 <= _b2_lazy_check() < 0.1


@pytest.mark.parametrize("fault", ["no bias", "no clamp"])
def test_b2_lazy_checks_catch_a_planted_kernel_fault(monkeypatch, fault):
    from craft_tpu_torch.ops.kernels import mode_attention as ma
    plain = ma.flash_mode_attention_plain

    def faulty(q, k, v, biases, grid, clip, pos_w, q_row0=0):
        if fault == "no bias":
            pos_w = 0.0
        else:
            clip = torch.full_like(clip, 1e30)
        return plain(q, k, v, biases, grid, clip, pos_w, q_row0)
    monkeypatch.setattr(ma, "flash_mode_attention", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _b2_lazy_check()
