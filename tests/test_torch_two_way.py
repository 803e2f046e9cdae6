"""Two-way correlation (--f1 shared|private, arch 'craft') of the port
against the JAX package on the CPU: the whole FlowModel at 64x64, fp32
(< 1e-4 px) and mixed precision (< 0.05 px), through both of the port's
eval routes to the D = 2 pyramid (the sliding bias at the inter site: B3's
normed plane a direction, ``pyramid_from_level0``; learned sinusoids
there: the raw volumes of B6 dense and ``build_pyramid``), on the lazy
intra path, the weights' round trip and a reference-format .pth under
both, and what the port refuses.  The D = 2 pyramid and lookup alone:
``tests/test_torch_corr_lookup_d2.py``.

Weights: the JAX tree as ``jax.eval_shape`` of its init gives it, filled
from the oracle tree (``test_torch_families._fill``); under 'private'
``f1_trans`` is the oracle's f2 site moved by seeded noise (its window by
N(0, 0.5)), so that the two transformers differ; the motion encoder's
first conv, which reads 648 channels here against the oracle's 324, takes
the oracle's kernel for the first 324 and a seeded copy of it, scaled by
0.5, for the second direction's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.config as jconfig
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.models.flow_model import FlowModel, create_model
from craft_tpu_torch.utils.weights import (load_oracle_npz,
                                           load_reference_checkpoint,
                                           state_dict_from_flax)
from test_torch_families import ORACLE, _fill, _flat, _nest

HW, ITERS = (64, 64), 3
FP32_BOUND_PX, MIXED_BOUND_PX = 1e-4, 0.05


def configs(f1, mixed_precision, inter_pos="bias"):
    """(JAX config, port config) of full CRAFT with --f1 `f1`, the inter
    site's positional code `inter_pos`."""
    out = []
    for c in (jconfig, tconfig):
        cfg = c.craft_config(mixed_precision=mixed_precision, f1trans=f1)
        out.append(cfg.replace(inter=dataclasses.replace(
            cfg.inter, pos_code_type=inter_pos)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def two_way_tree(f1: str, inter_pos: str = "bias", seed: int = 0):
    """The JAX variables of the --f1 `f1` model (its inter site's code
    `inter_pos`) as numpy arrays."""
    jcfg, _ = configs(f1, False, inter_pos)
    model = JaxFlowModel(cfg=jcfg)
    x = jnp.zeros((1, *HW, 3))
    shapes = jax.eval_shape(lambda r: model.init(r, x, x, iters=1),
                            jax.random.PRNGKey(0))
    oracle = dict(_flat(load_oracle_npz(ORACLE)[3]))
    rng = np.random.RandomState(seed)
    flat = {}
    for col in ("params", "batch_stats"):
        for path, sds in _flat(shapes.get(col, {})):
            shape = tuple(sds.shape)
            full = (col,) + path
            if path[0] == "f1_trans":
                src = oracle[(col, "f2_trans") + path[1:]]
                noise = 0.5 if path[-1] == "biases" else 0.02
                flat[full] = (src + rng.randn(*shape) * noise).astype(
                    np.float32)
            elif path[-2:] == ("convc1", "kernel") and \
                    oracle[full].shape != shape:
                half = oracle[full]
                flat[full] = np.concatenate(
                    [half, half[:, :, rng.permutation(half.shape[2])] * 0.5],
                    axis=2).astype(np.float32)
            else:
                flat[full] = _fill(full, shape, oracle, rng)
    return _nest(flat)


def frames(batch=1, seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 255, (batch, *hw, 3)).astype(np.float32)
            for _ in range(2)]


def jax_flows(f1, mixed_precision, img1, img2, iters=ITERS,
              inter_pos="bias"):
    jcfg, _ = configs(f1, mixed_precision, inter_pos)
    _, flows = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, two_way_tree(f1, inter_pos)),
        jnp.asarray(img1), jnp.asarray(img2), iters=iters)
    return np.asarray(flows[-1], np.float32)


def port_model(f1, mixed_precision, inter_pos="bias"):
    _, tcfg = configs(f1, mixed_precision, inter_pos)
    model = create_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(two_way_tree(f1, inter_pos)),
                          strict=True)
    return model


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow(model, img1, img2, iters=ITERS):
    with torch.inference_mode():
        _, flows = model(torch.from_numpy(img1), torch.from_numpy(img2),
                         iters=iters)
    return flows[-1].float().numpy()


@pytest.mark.parametrize("route", ["prenormed", "raw"])
@pytest.mark.parametrize("f1", ["shared", "private"])
@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
def test_two_way_flow_matches_jax(f1, mixed, route):
    """Both routes to the D = 2 pyramid in eval: 'prenormed', the sliding
    bias at the inter site (B3 a direction, pyramid_from_level0); 'raw',
    learned sinusoid codes there (the raw volume of B6 dense a direction,
    normed per (batch, d) by build_pyramid).  Training's raw route:
    tests/test_torch_train_two_way.py."""
    inter_pos = "bias" if route == "prenormed" else "lsinu"
    img1, img2 = frames(seed=int(mixed))
    want = jax_flows(f1, mixed, img1, img2, inter_pos=inter_pos)
    model = port_model(f1, mixed, inter_pos)
    assert model.corr_fn.prenormed() == (route == "prenormed")
    got = _flow(model, img1, img2)
    err = float(np.abs(got - want).max())
    print(f"{f1} {'mixed' if mixed else 'fp32'} {route}: max |flow diff| "
          f"{err:.3e} px (max |flow| {float(np.abs(want).max()):.3f})")
    assert np.isfinite(got).all()
    assert err < (MIXED_BOUND_PX if mixed else FP32_BOUND_PX)


def test_two_way_on_the_lazy_intra_path(monkeypatch):
    """--f1 leaves the lazy intra path as it is: with the threshold at 0
    the intra site gives a LazyModeAttention, and the two-way flow stays
    within FP32_BOUND_PX of JAX's (which materialises the probs here)."""
    from craft_tpu_torch.nn import setrans
    from craft_tpu_torch.nn.setrans import LazyModeAttention

    monkeypatch.setattr(setrans, "LAZY_PROBS_BYTES", 0)
    img1, img2 = frames(seed=2)
    want = jax_flows("private", False, img1, img2)
    model = port_model("private", False)
    seen = []
    model.att.register_forward_hook(lambda m, i, o: seen.append(type(o)))
    err = float(np.abs(_flow(model, img1, img2) - want).max())
    print(f"lazy two-way: max |flow diff| {err:.3e} px")
    assert seen == [LazyModeAttention] and err < FP32_BOUND_PX


# ------------------------------------------------------------- weights


def _count(tree):
    return sum(int(np.prod(np.shape(v))) for _, v in _flat(tree["params"]))


@pytest.mark.parametrize("f1", ["shared", "private"])
def test_weights_round_trip(f1):
    """The JAX tree loads strictly; under 'shared' the port's state dict
    lists the one module under f1_trans.* and f2_trans.*, as the
    reference's does, and counts its parameters once; the JAX converter
    reads the port's state dict back into the same tree."""
    from craft_tpu.utils.torch_convert import convert_torch_state

    tree = two_way_tree(f1)
    _, tcfg = configs(f1, False)
    model = FlowModel(tcfg)
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    assert sum(p.numel() for p in model.parameters()) == _count(tree)
    sd = model.state_dict()
    f1_keys = [k for k in sd if k.startswith("f1_trans.")]
    assert len(f1_keys) == len([k for k in sd if k.startswith("f2_trans.")])
    for key in f1_keys:
        twin = "f2_trans." + key[len("f1_trans."):]
        assert (sd[key].data_ptr() == sd[twin].data_ptr()) == (f1 ==
                                                               "shared")
    back, report = convert_torch_state(
        {k: v.numpy() for k, v in sd.items()},
        jax.tree.map(np.zeros_like, tree))
    for path, v in _flat(tree):
        node = back
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, v, err_msg=str(path))
    # Under 'shared' the JAX tree has no f1_trans: those keys go unused
    # (the converter lists all but the tied key.* duplicates).
    unused = report["unused_torch_keys"]
    assert set(unused) <= set(f1_keys) and bool(unused) == (f1 == "shared")


@pytest.mark.parametrize("f1", ["shared", "private"])
@pytest.mark.parametrize("source", ["reference", "jax"])
def test_reference_checkpoint_loads(tmp_path, f1, source):
    """A reference-format .pth ({'model': ...}, 'module.' keys) of the
    port's state dict (under 'shared' both names) or of the JAX tree's
    (f2_trans.* alone) loads with nothing missing or left over."""
    tree = two_way_tree(f1)
    _, tcfg = configs(f1, False)
    sd = state_dict_from_flax(tree)
    if source == "reference":
        model = FlowModel(tcfg)
        model.load_state_dict(sd, strict=True)
        sd = model.state_dict()
    path = tmp_path / "two_way.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    model = FlowModel(tcfg)
    assert load_reference_checkpoint(str(path), model) == ([], [])
    for key, value in state_dict_from_flax(tree).items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0,
                                   atol=0)


def test_two_way_refuses_what_is_not_ported():
    """Sequence parallelism with --f1 serves (tests/test_torch_sp_dense.py)
    but is refused in training, as the JAX package has none there; --f1
    without the f2 transformer it correlates against is refused."""
    model = port_model("shared", False).train()
    img = torch.zeros(1, *HW, 3)
    with pytest.raises(NotImplementedError, match="evaluation only"):
        model(img, img, iters=1, seq_parallel=object())
    _, tcfg = configs("private", False)
    with pytest.raises(ValueError, match="f2 transformer"):
        FlowModel(tcfg.replace(f2trans="none"))
