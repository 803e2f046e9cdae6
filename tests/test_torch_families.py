"""The model families other than full CRAFT, port against the JAX package
on the CPU: RAFT, GMA, CRAFT with GMA attention (content, --position_only,
--position_and_content, two heads), craft_nogma and CRAFT without the f2
transformer (--f2 none).

Weights: each family's JAX tree as ``jax.eval_shape`` of its init gives it
(no init is compiled), its leaves filled from the oracle tree where the
path exists (sliced where a GRU takes fewer input channels) and the rest
seeded as PyTorch initialises them (uniform within 1/sqrt(fan in);
RelPosEmb's tables N(0, 1)), ``Aggregate``'s gamma seeded nonzero (it
starts at zero, where the aggregation shows nothing).  The tree goes
across with ``state_dict_from_flax``.

Bounds: fp32 flows within 1e-4 px; mixed precision (bf16 compute, bf16
pyramid levels, int8 intra probs) within MIXED_BOUND_PX, where both
frameworks round at different places in the same bf16 arithmetic
(measured up to 1.5e-2 px at this size, 3 iterations).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import FlowModel, create_model
from craft_tpu_torch.ops.geometry import unpack_upsampled
from craft_tpu_torch.utils.weights import (load_oracle_npz,
                                           load_reference_checkpoint,
                                           state_dict_from_flax)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle_craft_128.npz"
HW, ITERS = (64, 96), 3
FP32_BOUND_PX, MIXED_BOUND_PX = 1e-4, 0.05


# name -> builder(config module, mixed_precision) of the same config in
# both packages.
FAMILIES = {
    "raft": lambda c, mp: c.raft_config(mixed_precision=mp),
    "gma": lambda c, mp: c.gma_config(mixed_precision=mp),
    "craft_gma": lambda c, mp: c.craft_config(mixed_precision=mp,
                                              use_setrans=False),
    "craft_gma_position_only": lambda c, mp: c.craft_config(
        mixed_precision=mp, use_setrans=False).replace(position_only=True),
    "craft_gma_position_and_content_heads2": lambda c, mp: c.craft_config(
        mixed_precision=mp, use_setrans=False).replace(
            position_and_content=True, num_heads=2),
    "craft_nogma": lambda c, mp: c.craft_nogma_config(mixed_precision=mp),
    "craft_nogma_f2_none": lambda c, mp: c.craft_nogma_config(
        mixed_precision=mp, f2trans="none"),
    "craft_f2_none": lambda c, mp: c.craft_config(mixed_precision=mp,
                                                  f2trans="none"),
}
# The families a configuration of the JAX package's presets gives, whose
# parameter counts the JAX package pins to the reference (RAFT and GMA,
# tests/test_param_counts.py).
REFERENCE_COUNTS = {"raft": 5257536, "gma": 5879873}


def configs(name, mixed_precision):
    build = FAMILIES[name]
    return build(jconfig, mixed_precision), build(tconfig, mixed_precision)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _fill(path, shape, oracle, rng):
    """A leaf's value: the oracle's where it exists (its leading part where
    the oracle's is larger: the GRU of BasicUpdateBlock reads 384 input
    channels where GMAUpdateBlock's reads 512), else seeded."""
    if path in oracle:
        want = oracle[path]
        if want.shape == shape:
            return want
        if want.ndim == len(shape) and all(
                a >= b for a, b in zip(want.shape, shape)):
            return np.ascontiguousarray(want[tuple(slice(0, n)
                                                   for n in shape)])
    leaf = path[-1]
    if leaf in ("rel_height", "rel_width"):
        return rng.randn(*shape).astype(np.float32)
    if leaf == "gamma":
        return np.full(shape, 0.5, np.float32)
    if leaf == "mean":
        return (rng.randn(*shape) * 0.1).astype(np.float32)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf == "scale":
        return np.ones(shape, np.float32)
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 128
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def family_tree(name: str, seed: int = 0):
    """The family's JAX variables (params, batch_stats) as numpy arrays."""
    jcfg, _ = configs(name, False)
    model = JaxFlowModel(cfg=jcfg)
    x = jnp.zeros((1, *HW, 3))
    shapes = jax.eval_shape(lambda r: model.init(r, x, x, iters=1),
                            jax.random.PRNGKey(0))
    oracle = dict(_flat(load_oracle_npz(ORACLE)[3]))
    rng = np.random.RandomState(seed)
    flat = {}
    for col in ("params", "batch_stats"):
        for path, sds in _flat(shapes.get(col, {})):
            flat[(col,) + path] = _fill((col,) + path, tuple(sds.shape),
                                        oracle, rng)
    return _nest(flat)


def frames(batch=1, seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (batch, *hw, 3)).astype(np.float32)
            for _ in range(2)]


def jax_flows(name, mixed_precision, img1, img2, iters=ITERS):
    jcfg, _ = configs(name, mixed_precision)
    _, flows = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, family_tree(name)), jnp.asarray(img1),
        jnp.asarray(img2), iters=iters)
    return np.asarray(flows[-1], np.float32)


def port_model(name, mixed_precision):
    _, tcfg = configs(name, mixed_precision)
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(family_tree(name)),
                          strict=True)
    return model


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_flow_matches_jax_fp32(name):
    img1, img2 = frames()
    want = jax_flows(name, False, img1, img2)
    with torch.inference_mode():
        _, flows = port_model(name, False)(torch.from_numpy(img1),
                                           torch.from_numpy(img2),
                                           iters=ITERS)
    got = flows[-1].numpy()
    err = float(np.abs(got - want).max())
    print(f"{name} fp32: max |flow diff| {err:.3e} px (max |flow| "
          f"{float(np.abs(want).max()):.3f})")
    assert np.isfinite(got).all() and err < FP32_BOUND_PX


@pytest.mark.parametrize("name", ["raft", "gma", "craft_gma",
                                  "craft_nogma", "craft_f2_none"])
def test_flow_matches_jax_mixed_precision(name):
    img1, img2 = frames(seed=1)
    want = jax_flows(name, True, img1, img2)
    with torch.inference_mode():
        _, flows = port_model(name, True)(torch.from_numpy(img1),
                                          torch.from_numpy(img2),
                                          iters=ITERS)
    got = flows[-1].float().numpy()
    err = float(np.abs(got - want).max())
    print(f"{name} mixed: max |flow diff| {err:.3e} px (max |flow| "
          f"{float(np.abs(want).max()):.3f})")
    assert np.isfinite(got).all() and err < MIXED_BOUND_PX


@pytest.mark.parametrize("name", list(FAMILIES))
def test_weights_round_trip_and_parameter_count(name):
    """state_dict_from_flax of the JAX tree loads strictly (every key, every
    shape), the port counts as many parameters as the tree, and the
    reference counts hold for RAFT and GMA."""
    tree = family_tree(name)
    _, tcfg = configs(name, False)
    model = FlowModel(tcfg)
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    want = sum(int(np.prod(np.shape(v))) for _, v in _flat(tree["params"]))
    got = sum(p.numel() for p in model.parameters())
    assert got == want, (got, want)
    if name in REFERENCE_COUNTS:
        assert got == REFERENCE_COUNTS[name]
    for key, value in state_dict_from_flax(tree).items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("name", ["raft", "gma", "craft_nogma",
                                  "craft_gma_position_only"])
def test_reference_checkpoint_loads_each_family(tmp_path, name):
    """A reference-format .pth ({'model': ...} with 'module.' keys) loads
    with nothing missing or left over."""
    sd = state_dict_from_flax(family_tree(name))
    path = tmp_path / f"{name}.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    _, tcfg = configs(name, False)
    model = FlowModel(tcfg)
    assert load_reference_checkpoint(str(path), model) == ([], [])


@pytest.mark.parametrize("name", ["raft", "craft_gma", "craft_f2_none"])
def test_packed_forward_equals_all(name):
    """upsample_mode='packed' gives every iteration's flow in the
    [B, H/8, W/8, 128] layout with the 'all' forward's bits."""
    img1, img2 = (torch.from_numpy(a) for a in frames(batch=2, seed=2))
    model = port_model(name, False)
    with torch.inference_mode():
        low_a, flows = model(img1, img2, iters=2)
        low_p, packed = model(img1, img2, iters=2, upsample_mode="packed")
    assert packed.shape == (2, 2, HW[0] // 8, HW[1] // 8, 128)
    torch.testing.assert_close(low_p, low_a, rtol=0, atol=0)
    for i in range(2):
        torch.testing.assert_close(unpack_upsampled(packed[i]), flows[i],
                                   rtol=0, atol=0)


def test_families_refuse_what_is_not_ported():
    """Two-way correlation (arch 'craft') builds its f1 site, and refuses a
    config without the f2 transformer it correlates against; sequence
    parallelism, which every family serves (tests/test_torch_sp_families.
    py), is refused in training, as the JAX package has none there."""
    model = FlowModel(tconfig.craft_config(f1trans="shared"))
    assert model.f1_trans is model.f2_trans
    with pytest.raises(ValueError, match="f2 transformer"):
        FlowModel(tconfig.craft_config(f1trans="private", f2trans="none"))
    model = port_model("raft", False).train()
    img = torch.zeros(1, *HW, 3)
    with pytest.raises(NotImplementedError, match="evaluation only"):
        model(img, img, iters=1, seq_parallel=object())
