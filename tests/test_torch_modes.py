"""Mode counts other than 4 (``--intermodes``, ``--f2modes``,
``--intramodes``; ROADMAP item 6) in the port's CLIs, weights and FLOP
count, on the CPU.

* Each count at each site resolves to the JAX CLI's ``ModelConfig`` field
  by field: 1, 2, 4, 8 and 16 modes at the 256-wide inter, f2 and f1 sites
  (craft_nogma's f2 site takes --intramodes), 1, 2, 4 and 8 at the 128-wide
  intra site.  32 modes at a 256-wide site and 16 at the intra site (a mode
  dim of 8), and counts that do not divide the width, exit naming item 6.
* ``--flop``'s analytic table at 8 modes (and the mixed counts) against
  the JAX package's (craft_tpu/eval/flops.py).
* Trees at 1 and 8 modes (first linears of M x F outputs, no attn_softaggr
  at one mode) round-trip through ``state_dict_from_flax`` and the JAX
  package's ``convert_torch_state`` bit for bit and load strictly into the
  port's FlowModel; ``tools/jax_checkpoint_to_pth.py`` carries a JAX
  checkpoint of them into the port, weights and Adam moments bit for bit.

The trees (``modes_tree``) are ``jax.eval_shape`` of each configuration's
init (no init is compiled), filled from the oracle tree where it has the
leaf (its leading part where the oracle's is larger) and seeded as PyTorch
initialises the rest (tests/test_torch_families.py's ``_fill``).
"""

import argparse
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.cli as jcli
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu.utils.torch_convert import convert_torch_state
from craft_tpu_torch import cli as tcli
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

import chip_smoke
from test_torch_families import _fill, _flat, _nest

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "tests" / "data" / "oracle_craft_128.npz"
TOOL = REPO / "tools" / "jax_checkpoint_to_pth.py"
TREE_HW = (64, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parse(module, flags):
    p = argparse.ArgumentParser()
    module.add_model_args(p)
    return p.parse_args(flags)


def configs(name, mixed_precision):
    """(JAX, port) ModelConfig of chip_smoke's configuration `name`, each
    from its own CLI with ``chip_smoke.mode_flags(name)``."""
    flags = chip_smoke.mode_flags(name) + (
        ["--mixed_precision"] if mixed_precision else [])
    return (jcli.model_config_from_args(parse(jcli, flags)),
            tcli.model_config_from_args(parse(tcli, flags)))


@functools.lru_cache(maxsize=None)
def modes_tree(name: str, seed: int = 0):
    """Configuration `name`'s JAX variables as numpy arrays."""
    jcfg, _ = configs(name, False)
    model = JaxFlowModel(cfg=jcfg)
    x = jnp.zeros((1, *TREE_HW, 3))
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


def same_config(got, want):
    """The port's config `got` holds the JAX package's `want`, field by
    field (the port's fields; a site config's sub-fields)."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            for sf in dataclasses.fields(g):
                assert getattr(g, sf.name) == getattr(w, sf.name), \
                    (f.name, sf.name)
        else:
            assert g == w, f.name


ACCEPTED = (
    [["--craft", "--setrans", "--intermodes", str(m)] for m in (1, 2, 8, 16)]
    + [["--craft", "--setrans", "--f2modes", str(m)] for m in (1, 2, 8, 16)]
    + [["--craft", "--setrans", "--intramodes", str(m)] for m in (1, 2, 8)]
    + [["--craft", "--setrans", "--f1", "private", "--f2modes", "16"],
       ["--craft", "--setrans", "--f1", "shared", "--intermodes", "1"],
       ["--nogma", "--intramodes", "16"], ["--nogma", "--intermodes", "1"],
       ["--craft", "--intermodes", "2", "--f2modes", "1"],
       ["--craft", "--setrans", "--intermodes", "2", "--f2modes", "16",
        "--intramodes", "1", "--mixed_precision"]])


@pytest.mark.parametrize("flags", ACCEPTED,
                         ids=lambda v: "_".join(v).replace("--", ""))
def test_counts_resolve_to_the_jax_config(flags):
    same_config(tcli.model_config_from_args(parse(tcli, flags)),
                 jcli.model_config_from_args(parse(jcli, flags)))


@pytest.mark.parametrize("flags", [
    ["--craft", "--setrans", "--intermodes", "32"],
    ["--craft", "--setrans", "--f2modes", "64"],
    ["--craft", "--setrans", "--intramodes", "16"],
    ["--craft", "--setrans", "--intermodes", "3"],
    ["--craft", "--setrans", "--intramodes", "5"],
    ["--craft", "--f1", "shared", "--f2modes", "32"],
    ["--nogma", "--intramodes", "32"]],
    ids=lambda v: "_".join(v).replace("--", ""))
def test_other_counts_exit_naming_item_6(flags):
    with pytest.raises(SystemExit, match="ROADMAP.md section 2, item 6"):
        tcli.model_config_from_args(parse(tcli, flags))


@pytest.mark.parametrize("name", ["modes8", "modes1", "modes_mixed",
                                  "nogma2"])
def test_flop_breakdown_matches_jax(name):
    from craft_tpu.eval import flops as jflops
    from craft_tpu_torch.eval import flops as tflops
    jcfg, tcfg = configs(name, True)
    assert tflops.model_flops_breakdown(tcfg, 440, 1024) == \
        jflops.model_flops_breakdown(jcfg, 440, 1024)


@pytest.mark.parametrize("name", ["modes1", "modes8"])
def test_trees_round_trip_and_load(name):
    tree = modes_tree(name)
    sd = state_dict_from_flax(tree)
    _, tcfg = configs(name, False)
    M = tcfg.inter.num_modes
    assert ("corr_fn.setrans.attn_softaggr.feat2score.weight" in sd) == \
        (M > 1)
    assert sd["f2_trans.setrans.out_trans.first_linear.weight"].shape == \
        (M * 256, 256)
    assert sd["update_block.aggregator.first_linear.weight"].shape == \
        (tcfg.intra.num_modes * 128, 128)
    assert ("att.setrans.attn_softaggr.feat2score.weight" in sd) == \
        (tcfg.intra.num_modes > 1)
    model = FlowModel(tcfg)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    state = {k: v.numpy() for k, v in sd.items()}
    back, report = convert_torch_state(state, tree, strict=True)
    assert report["missing"] == [] and report["unused_torch_keys"] == []
    for col in ("params", "batch_stats"):
        for path, want in _flat(tree[col]):
            got = back[col]
            for p in path:
                got = got[p]
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg="/".join((col,) + path))


@pytest.mark.parametrize("name", ["modes1", "modes8"])
def test_jax_checkpoint_tool_carries_the_tree(name, tmp_path):
    """A JAX checkpoint of the tree (seeded Adam moments, step 5) through
    tools/jax_checkpoint_to_pth.py with the configuration's flags: the
    port's weights and AdamW moments bit for bit."""
    from craft_tpu.training.checkpoint import save_checkpoint as jax_save
    from craft_tpu.training.optim import make_optimizer as jax_optimizer
    from craft_tpu.training.train_step import TrainState as JaxTrainState
    from craft_tpu_torch.training.checkpoint import load_checkpoint
    from craft_tpu_torch.training.train_step import create_train_state
    from test_torch_jax_checkpoint import _seeded, _with_adam

    tree = modes_tree(name)
    params = tree["params"]
    tx, _ = jax_optimizer(2.5e-4, 100)
    rng = np.random.RandomState(5)
    mu, nu = _seeded(params, rng), _seeded(params, rng, positive=True)
    state = JaxTrainState(step=np.asarray(5, np.int32), params=params,
                          batch_stats=tree["batch_stats"],
                          opt_state=_with_adam(tx.init(params), mu, nu, 5))
    path = str(tmp_path / f"5_{name}")
    jax_save(path, state, {"total_steps": 5})
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_pth",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / f"{name}.pth")
    flags = chip_smoke.mode_flags(name)
    tool.main([path, out, *flags, "--lr", "2.5e-4", "--num_steps", "100"])
    _, tcfg = configs(name, False)
    port = create_train_state(tcfg, 0, device="cpu", lr=2.5e-4,
                              num_steps=100)
    load_checkpoint(out, port, load_optimizer_state=True,
                    load_scheduler_state=True)
    want = state_dict_from_flax(tree)
    got = port.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    moments = {n: port.optimizer.state[p] for n, p in
               port.model.named_parameters()}
    for n, v in state_dict_from_flax({"params": mu}).items():
        if n in moments:
            torch.testing.assert_close(moments[n]["exp_avg"], v, rtol=0,
                                       atol=0, msg=n)
