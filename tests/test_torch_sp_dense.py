"""Sequence parallelism of the port under the dense tables and with two-way
correlation, on the CPU: lsinu at every site (B6 dense's raw volume normed
with every rank's moments, B8 at the f2 site, B4 dense's float probs),
--f2radius 3 (B8 with the shard's rows of the mask and window), lsinu with
--f1 private (the two-way raw volume, a plane's moments each), and --f1
shared and private with the sliding bias (B9 a direction, the f1 site on
the shard's rows).  The families' file (``test_torch_sp_families.py``)
shares this file's machinery.

Each configuration runs at 64x64 (H8 = 8 grid rows), 2 iterations, on 2
and on 3 ranks (rows 4/4 and 3/3/2) spawned as processes by
``test_torch_sp.run_ranks`` (gloo over a FileStore): the ranks of a world
size are spawned once, run every configuration of the file, fp32 and
mixed, and each configuration is then checked in its own case:

  * fp32 against the JAX package's ``Evaluator(seq_parallel=True)`` on
    its 8 virtual devices, within 1e-3 px (``test_torch_sp.py``'s bound);
  * fp32 against the port's unsharded forward, within 1e-4 px;
  * mixed precision against the port's unsharded mixed forward, within
    0.05 px;
  * every rank's flow the same bits.

The same spawns hold ``RowShard.layer_norm_moments`` and
``build_pyramid``'s norm on a shard against the unsharded two passes, on
a 7 x 5 grid (rows 4/3 and 3/2/2), and the row-range mask builder is held
against the whole mask.

Weights: each configuration's JAX tree as ``jax.eval_shape`` of its init
gives it, filled from the oracle tree (``test_torch_families._fill``),
every sliding window drawn from N(0, 1) (at zero a window on the wrong
rows would not show) and every lsinu ``pos_fc`` kernel from N(0, 2^2)
(O(1) phases across the grid); under --f1 private the f1 site is the f2
site moved by seeded noise, and the motion encoder's first conv takes a
seeded second half for the second direction (``test_torch_two_way``'s
scheme).  A spawned rank imports this module, so it imports no JAX at
module level.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.nn.setrans import attention_mask
from craft_tpu_torch.ops.corr import build_pyramid
from test_torch_sp import run_ranks

ITERS = 2
JAX_BOUND_PX, FP32_BOUND_PX, MIXED_BOUND_PX = 1e-3, 1e-4, 0.05
WINDOW_STD, POS_FC_STD, F1_NOISE = 1.0, 2.0, 0.02
WORLDS = (2, 3)
NORM_GRID = (7, 5)  # H8 = 7 rows: 4/3 over 2 ranks, 3/2/2 over 3


def _lsinu(cfg):
    return cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), pos_code_type="lsinu")
        for site in ("inter", "f2", "intra")})


def _f2radius(cfg, radius):
    return cfg.replace(f2=dataclasses.replace(cfg.f2,
                                              attn_mask_radius=radius))


# name -> builder(config module, mixed_precision) of the same config in
# both packages.
CONFIGS = {
    "lsinu": lambda c, mp: _lsinu(c.craft_config(mixed_precision=mp)),
    "f2radius3": lambda c, mp: _f2radius(
        c.craft_config(mixed_precision=mp), 3),
    "lsinu_f1_private": lambda c, mp: _lsinu(
        c.craft_config(mixed_precision=mp, f1trans="private")),
    "f1_shared": lambda c, mp: c.craft_config(mixed_precision=mp,
                                              f1trans="shared"),
    "f1_private": lambda c, mp: c.craft_config(mixed_precision=mp,
                                               f1trans="private"),
}
HW = (64, 64)


@functools.lru_cache(maxsize=None)
def sp_tree(configs_key: str, name: str, hw: tuple, seed: int = 0):
    """The JAX variables of `name` (a config of the CONFIGS of module
    `configs_key`) as numpy arrays, filled as the module docstring says."""
    import importlib

    import jax
    import jax.numpy as jnp

    import craft_tpu.config as jconfig
    from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
    from craft_tpu_torch.utils.weights import load_oracle_npz
    from test_torch_families import ORACLE, _fill, _flat, _nest

    configs = importlib.import_module(configs_key).CONFIGS
    model = JaxFlowModel(cfg=configs[name](jconfig, False))
    x = jnp.zeros((1, *hw, 3))
    shapes = jax.eval_shape(lambda r: model.init(r, x, x, iters=1),
                            jax.random.PRNGKey(0))
    oracle = dict(_flat(load_oracle_npz(ORACLE)[3]))
    rng = np.random.RandomState(seed)
    flat = {}
    for col in ("params", "batch_stats"):
        for path, sds in _flat(shapes.get(col, {})):
            shape, full = tuple(sds.shape), (col,) + path
            f2_path = (col, "f2_trans") + path[1:]
            if path[0] == "f1_trans" and f2_path in oracle:
                value = oracle[f2_path] + rng.randn(*shape) * F1_NOISE
            elif path[-2:] == ("convc1", "kernel") and full in oracle and \
                    oracle[full].shape[2] < shape[2]:
                half = oracle[full]
                value = np.concatenate(
                    [half, half[:, :, rng.permutation(half.shape[2])] * 0.5],
                    axis=2)
            elif path[-1] == "biases":
                value = rng.randn(*shape) * WINDOW_STD
            elif "pos_fc" in path and path[-1] == "kernel":
                value = rng.randn(*shape) * POS_FC_STD
            else:
                value = _fill(full, shape, oracle, rng)
            flat[full] = np.asarray(value, np.float32)
    return _nest(flat)


def frames(hw, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
            for _ in range(2)]


def port_flow(cfg, sd, img1, img2, seq_parallel=None):
    model = FlowModel(cfg).eval()
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                         iters=ITERS, seq_parallel=seq_parallel)
    return flows[-1].float().numpy()


# ------------------------------------------------------------ rank target

def norm_volume():
    """A seeded raw two-plane volume [2, U, 2, U] over NORM_GRID, its
    planes at different offsets and scales."""
    g = torch.Generator().manual_seed(5)
    u = NORM_GRID[0] * NORM_GRID[1]
    vol = torch.randn(2, u, 2, u, generator=g)
    scale, offset = torch.tensor([1.0, 3.0]), torch.tensor([0.5, -2.0])
    return vol * scale[:, None] + offset[:, None]


def _sp_runs(group, configs_key, names, weights_path, img1, img2):
    """One rank's flows of each config of `names` (fp32 and mixed), and its
    shard of NORM_GRID's moments and normed pyramid."""
    import importlib
    configs = importlib.import_module(configs_key).CONFIGS
    sds = torch.load(weights_path)
    flows = {}
    for name in names:
        for mp in (False, True):
            flows[name, mp] = port_flow(configs[name](tconfig, mp), sds[name],
                                        img1, img2, group)
    shard = group.shard(*NORM_GRID)
    vol = norm_volume()[:, shard.u0:shard.u1]
    B, U1, D, U2 = vol.shape
    moments = [shard.layer_norm_moments(vol[:, :, d].reshape(B, 1, -1))
               for d in range(D)]
    pyr = build_pyramid(vol, B, *NORM_GRID, num_levels=2,
                        do_global_norm=True, shard=shard)
    return {"flows": flows,
            "moments": [(m.numpy(), v.numpy()) for m, v in moments],
            "levels": [lvl.numpy() for lvl in pyr.levels],
            "rows": (shard.h0, shard.h1)}


# ------------------------------------------------------------ fixtures

class SpRuns:
    """The references (JAX's SP evaluator, the port's unsharded forward)
    and each world size's spawned runs of a module's CONFIGS, each made
    once on first use."""

    def __init__(self, configs_key, configs, hw, tmp_path):
        self.key, self.configs, self.hw = configs_key, configs, hw
        self.tmp_path = tmp_path
        self.img1, self.img2 = frames(hw)
        self.trees = {n: sp_tree(configs_key, n, hw) for n in configs}
        from craft_tpu_torch.utils.weights import state_dict_from_flax
        self.sds = {n: state_dict_from_flax(t) for n, t in self.trees.items()}
        self.weights = str(tmp_path / "weights.pt")
        torch.save(self.sds, self.weights)
        self._worlds, self._refs = {}, {}

    def reference(self, name):
        """(JAX SP fp32, port unsharded fp32, port unsharded mixed)."""
        if name not in self._refs:
            import craft_tpu.config as jconfig
            from craft_tpu.eval.evaluate import Evaluator as JaxEvaluator
            _, jflows = JaxEvaluator(self.configs[name](jconfig, False),
                                     self.trees[name], iters=ITERS,
                                     seq_parallel=True)(self.img1, self.img2)
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                self._refs[name] = (np.asarray(jflows[-1], np.float32), *(
                    port_flow(self.configs[name](tconfig, mp), self.sds[name],
                              self.img1, self.img2) for mp in (False, True)))
            finally:
                torch.set_num_threads(n)
        return self._refs[name]

    def ranks(self, world):
        if world not in self._worlds:
            self._worlds[world] = run_ranks(
                self.tmp_path, world, _sp_runs, self.key, list(self.configs),
                self.weights, self.img1, self.img2)
        return self._worlds[world]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SpRuns("test_torch_sp_dense", CONFIGS, HW,
                  tmp_path_factory.mktemp("sp_dense"))


def check_flows(runs, name, world):
    """The case of `name` at `world` ranks, as the module docstring says."""
    want_jax, want, want_mixed = runs.reference(name)
    out = runs.ranks(world)
    for rank, res in enumerate(out):
        got, mixed = res["flows"][name, False], res["flows"][name, True]
        errs = (float(np.abs(got - want_jax).max()),
                float(np.abs(got - want).max()),
                float(np.abs(mixed - want_mixed).max()))
        print(f"{name} world {world} rank {rank}: fp32 against JAX SP "
              f"{errs[0]:.3e} px, against unsharded {errs[1]:.3e} px; mixed "
              f"against unsharded {errs[2]:.3e} px (max |flow| "
              f"{float(np.abs(want).max()):.3f})")
        assert np.isfinite(got).all() and np.isfinite(mixed).all()
        assert errs[0] < JAX_BOUND_PX, (rank, errs)
        assert errs[1] < FP32_BOUND_PX, (rank, errs)
        assert errs[2] < MIXED_BOUND_PX, (rank, errs)
        for key in ((name, False), (name, True)):
            np.testing.assert_array_equal(res["flows"][key],
                                          out[0]["flows"][key])


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_flow_matches_jax_and_unsharded(runs, name, world):
    check_flows(runs, name, world)


@pytest.mark.parametrize("world", WORLDS)
def test_layer_norm_moments_match_the_two_passes(runs, world):
    """Each rank's (mean, var) of a plane over every rank's rows, at H8 = 7
    over 2 and 3 ranks, against global_layer_norm's fp32 two passes over
    the whole plane."""
    vol = norm_volume()
    B, U, D, _ = vol.shape
    for d in range(D):
        plane = vol[:, :, d].reshape(B, 1, -1)
        mean = plane.mean(dim=-1, keepdim=True)
        var = (plane - mean).square().mean(dim=-1, keepdim=True)
        out = runs.ranks(world)
        for res in out:
            got_mean, got_var = res["moments"][d]
            np.testing.assert_allclose(got_mean, mean.numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got_var, var.numpy(), rtol=1e-6)
            np.testing.assert_array_equal(got_mean, out[0]["moments"][d][0])


@pytest.mark.parametrize("world", WORLDS)
def test_build_pyramid_on_a_shard_matches_unsharded(runs, world):
    """The ranks' levels of a normed two-plane pyramid (its global norm over
    every rank's rows, pooling over the keys) stacked in rank order: the
    unsharded pyramid's, within fp32 rounding."""
    vol = norm_volume()
    B = vol.shape[0]
    want = build_pyramid(vol, B, *NORM_GRID, num_levels=2,
                         do_global_norm=True)
    out = runs.ranks(world)
    assert [r["rows"][0] for r in out[1:]] == [r["rows"][1] for r in out[:-1]]
    for i, lvl in enumerate(want.levels):
        parts = [r["levels"][i].reshape(B, -1, *lvl.shape[1:]) for r in out]
        got = np.concatenate(parts, axis=1).reshape(lvl.shape)
        np.testing.assert_allclose(got, lvl.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_attention_mask_rows_match_the_whole_mask(radius):
    """The row-range builder: every range of rows of a 7 x 9 grid (H8 not
    divisible by 2 or 3) is those rows of the whole mask, and the whole
    mask is -1e9 exactly where the Chebyshev distance passes the radius."""
    H, W = 7, 9
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    yx = np.stack([ys.ravel(), xs.ravel()], -1)
    far = np.abs(yx[:, None] - yx[None]).max(-1) > radius
    full = attention_mask(H, W, radius)
    assert full.dtype == torch.float32 and full.shape == (H * W, H * W)
    np.testing.assert_array_equal(full.numpy(),
                                  np.where(far, -1e9, 0.0).astype(np.float32))
    for row0, rows in ((0, 4), (4, 3), (0, 3), (3, 2), (5, 2), (6, 1)):
        np.testing.assert_array_equal(
            attention_mask(H, W, radius, row0=row0, rows=rows).numpy(),
            full[row0 * W:(row0 + rows) * W].numpy())
