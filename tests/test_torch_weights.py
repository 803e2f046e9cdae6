"""The port's weight bridge and its import boundary.

state_dict_from_flax inverts craft_tpu.utils.torch_convert: carried through
convert_torch_state it must give back the oracle's flax tree exactly, and
the port's FlowModel must load it with strict=True.  The port imports no
JAX, flax or craft_tpu module, and nothing the card's machine lacks (PIL,
OpenCV, orbax).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from craft_tpu.utils.torch_convert import convert_torch_state
from craft_tpu_torch.config import craft_config
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "tests" / "data" / "oracle_craft_128.npz"
# JAX and the JAX package; and what the card's machine lacks: PIL and
# OpenCV (the port decodes and augments in numpy) and orbax.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "craft_tpu", "PIL", "cv2",
             "orbax")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_state_dict_round_trips_the_oracle_tree_exactly():
    _, _, _, tree = load_oracle_npz(ORACLE)
    sd = state_dict_from_flax(tree)
    state = {k: v.numpy() for k, v in sd.items()}
    new_vars, report = convert_torch_state(state, tree, strict=True)
    assert report["missing"] == [] and report["unused_torch_keys"] == []
    n = 0
    for col in ("params", "batch_stats"):
        for path, want in _flat(tree[col]):
            got = new_vars[col]
            for p in path:
                got = got[p]
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg="/".join((col,) + path))
            n += 1
    assert n == 175  # every params and batch_stats array of the oracle
    # The tied inter-site projection appears under both reference names.
    assert sd["corr_fn.setrans.key.weight"] is sd["corr_fn.setrans.query.weight"]


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_flow_model_loads_the_bridged_state_strictly(mixed_precision):
    _, _, _, tree = load_oracle_npz(ORACLE)
    model = FlowModel(craft_config(mixed_precision=mixed_precision))
    result = model.load_state_dict(state_dict_from_flax(tree), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert model.corr_fn.setrans.key is model.corr_fn.setrans.query


def test_lsinu_tree_round_trips_and_loads(tmp_path):
    """Under --interpos/--intrapos lsinu every site's pos_coder is a Dense
    (pos_fc) and there is no bias window: the generic Dense mapping carries
    it both ways, and a reference .pth of it loads with nothing missing."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import craft_tpu.config as jconfig
    from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
    from craft_tpu_torch.utils.weights import load_reference_checkpoint

    def lsinu(cfg):
        return cfg.replace(**{site: dataclasses.replace(
            getattr(cfg, site), pos_code_type="lsinu")
            for site in ("inter", "f2", "intra")})
    zeros = jnp.zeros((1, 16, 16, 3))
    init = JaxFlowModel(cfg=lsinu(jconfig.craft_config(False)),
                        train=False).init
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: init(key, zeros, zeros, iters=1))(jax.random.PRNGKey(0)))
    sd = state_dict_from_flax(tree)
    for site, dim in (("f2_trans", 256), ("att", 128), ("corr_fn", 256)):
        key = f"{site}.vispos_encoder.pos_coder.pos_fc"
        assert sd[f"{key}.weight"].shape == (dim, 2)
        assert sd[f"{key}.bias"].shape == (dim,)
    assert not [k for k in sd if k.endswith("pos_coder.biases")]
    new_vars, report = convert_torch_state(
        {k: v.numpy() for k, v in sd.items()}, tree, strict=True)
    assert report["missing"] == [] and report["unused_torch_keys"] == []
    for col in ("params", "batch_stats"):
        for path, want in _flat(tree[col]):
            got = new_vars[col]
            for p in path:
                got = got[p]
            np.testing.assert_array_equal(np.asarray(got), want)
    model = FlowModel(lsinu(craft_config(mixed_precision=False)))
    model.load_state_dict(sd, strict=True)
    pth = tmp_path / "lsinu.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, pth)
    fresh = FlowModel(lsinu(craft_config(mixed_precision=False)))
    assert load_reference_checkpoint(pth, fresh) == ([], [])
    torch.testing.assert_close(
        fresh.state_dict()["att.vispos_encoder.pos_coder.pos_fc.weight"],
        sd["att.vispos_encoder.pos_coder.pos_fc.weight"], rtol=0, atol=0)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO) for p in (REPO / "craft_tpu_torch").rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_port_file_imports_no_jax(path):
    for mod in _imported_modules(REPO / path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_importing_the_port_leaves_jax_and_flax_out():
    code = ("import sys; import craft_tpu_torch.models.flow_model, "
            "craft_tpu_torch.ops.kernels.mode_attention, "
            "craft_tpu_torch.parallel.sequence_parallel, "
            "craft_tpu_torch.ops.kernels.sep_conv_gru, "
            "craft_tpu_torch.train, craft_tpu_torch.evaluate, "
            "craft_tpu_torch.eval.flops, craft_tpu_torch.utils.bundle; "
            "bad = [m for m in ('jax', 'flax', 'craft_tpu', 'PIL', 'cv2', "
            "'orbax') if m in sys.modules]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_tied_query_also_fills_key_for_a_bare_site():
    tree = {"params": {"query": {"Dense_0": {
        "kernel": np.ones((8, 4), np.float32),
        "bias": np.zeros((4,), np.float32)}}}}
    sd = state_dict_from_flax(tree)
    assert sd["query.weight"].shape == (4, 8)
    assert sd["key.weight"] is sd["query.weight"]
    assert sd["key.bias"] is sd["query.bias"]
    assert torch.equal(sd["query.weight"], torch.ones(4, 8))
