"""The two CLIs of the port for every family, on the CPU.

* Each family's flags resolve to the JAX CLI's ``ModelConfig``, field by
  field (``craft_tpu/cli.py:58-110``, its unread --craft included), and
  what is still refused exits naming its ROADMAP.md item.
* ``python -m craft_tpu_torch.evaluate`` over a reference-format .pth of
  each family (the trees of tests/test_torch_families.py) on a one-pair
  Sintel tree at 64x96: its EPE against the EPE of the JAX model's flow on
  the same pair (fp32, within 1e-4 px: the flows agree to 1e-5 px), and
  --upsample_mode packed giving the 'all' run's metrics bit for bit.
* ``python -m craft_tpu_torch.train`` with --raft, --nogma --attn_diag (the
  f2 and inter sites' telemetry on the status line; none for RAFT), and
  --upsample_mode final, which trains as packed: the same weights as a
  --upsample_mode packed run, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import craft_tpu.cli as jcli
from craft_tpu.models.flow_model import FlowModel as JaxFlowModel
from craft_tpu_torch import cli as tcli
from craft_tpu_torch import evaluate as teval
from craft_tpu_torch import train as ttrain
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.utils.weights import state_dict_from_flax

import chip_smoke
from test_torch_families import HW, family_tree
from test_torch_train_cli import _cli_args

ITERS = 3
FAMILY_FLAGS = {
    "raft": ["--raft"],
    "gma_attention": ["--craft"],
    "position_only": ["--craft", "--position_only"],
    "position_and_content_heads2": ["--craft", "--position_and_content",
                                    "--num_heads", "2"],
    "nogma": ["--nogma"],
    "nogma_f2_none_intramodes": ["--nogma", "--f2", "none",
                                 "--f2modes", "8"],
    "f2_none": ["--craft", "--setrans", "--f2", "none"],
    "raft_f1_mixed": ["--raft", "--f1", "shared", "--mixed_precision"],
    "f1_shared": ["--craft", "--setrans", "--f1", "shared"],
    "f1_private_mixed": ["--craft", "--setrans", "--f1", "private",
                         "--mixed_precision"],
    "packed": ["--craft", "--setrans", "--upsample_mode", "packed"],
}
# The trees of tests/test_torch_families.py each CLI family loads.
TREES = {"raft": "raft", "gma_attention": "craft_gma",
         "nogma": "craft_nogma"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(module, flags):
    import argparse

    p = argparse.ArgumentParser()
    module.add_model_args(p)
    return p.parse_args(flags)


@pytest.mark.parametrize("family", list(FAMILY_FLAGS))
def test_flags_resolve_to_the_jax_config(family):
    flags = FAMILY_FLAGS[family]
    want = jcli.model_config_from_args(_parse(jcli, flags))
    got = tcli.model_config_from_args(_parse(tcli, flags))
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            for sf in dataclasses.fields(g):
                assert getattr(g, sf.name) == getattr(w, sf.name), \
                    (f.name, sf.name)
        else:
            assert g == w, f.name


# A mode count that does not divide its site's width exits, as the JAX
# package's model cannot build it.
@pytest.mark.parametrize("flags,item", [
    (["--craft", "--f1", "private", "--f2modes", "3"], "must divide")])
def test_still_refused_flags_exit_naming_their_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        tcli.model_config_from_args(_parse(tcli, flags))


# What exited naming ROADMAP item 6 (mode counts other than 4, then mode
# dims below 16: 32 to 256 modes at a 256-wide site, 16 to 128 at the
# 128-wide intra site) runs.
MODE_FLAGS = [["--craft", "--setrans", "--f1", "shared", "--intermodes", "2"],
              ["--craft", "--f1", "private", "--f2modes", "8"],
              ["--nogma", "--intermodes", "8"], ["--nogma", "--intramodes",
                                                 "2"],
              ["--craft", "--f2modes", "2"],
              ["--craft", "--setrans", "--f1", "shared", "--intermodes",
               "32"],
              ["--nogma", "--intermodes", "64"],
              ["--nogma", "--intramodes", "32"],
              ["--craft", "--setrans", "--intramodes", "16"]]


@pytest.mark.parametrize("flags", MODE_FLAGS,
                         ids=lambda v: "_".join(v).replace("--", ""))
def test_mode_count_flags_resolve_and_run(sintel, tmp_path, flags):
    """The flags give the JAX CLI's config, field by field, and the
    evaluator runs the one-pair Sintel tree over a .pth of that config
    (``chip_smoke.config_weights``) on the CPU, its metrics finite."""
    from test_torch_modes import same_config
    got = tcli.model_config_from_args(_parse(tcli, flags))
    same_config(got, jcli.model_config_from_args(_parse(jcli, flags)))
    root, _, _ = sintel
    pth = tmp_path / "modes.pth"
    torch.save({"model": {"module." + k: v for k, v in
                          chip_smoke.config_weights(got).items()}}, pth)
    out = teval.main(["--model", str(pth), *flags, "--dataset", "sintel",
                      "--fullprec", "--iters", "2", "--data_root", str(root),
                      "--device", "cpu"])
    assert all(np.isfinite(v) for v in out.values()), out


@pytest.mark.parametrize("flags", [["--raft"], ["--nogma"], ["--craft"],
                                   ["--craft", "--setrans", "--f2", "none"],
                                   ["--craft", "--setrans", "--f1",
                                    "shared"]])
def test_seq_parallel_exits_for_other_families(flags):
    """The name is kept from when --seq_parallel exited for these families
    and flags; it no longer does (they run sharded:
    tests/test_torch_sp_families.py, test_torch_sp_dense.py): the CLI
    passes its checks and reaches the checkpoint, which is absent."""
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        teval.main(["--model", "absent.pth", "--seq_parallel", "--device",
                    "cpu"] + flags)


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    """A one-pair Sintel tree at 64x96 with a seeded ground truth."""
    root = tmp_path_factory.mktemp("families")
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (*HW, 3)).astype(np.uint8)
              for _ in range(2)]
    gt = (rng.randn(*HW, 2) * 2).astype(np.float32)
    chip_smoke.write_sintel_tree(root, frames, [gt])
    return root, frames, gt


@pytest.mark.parametrize("family", list(TREES))
def test_evaluator_cli_runs_each_family(sintel, tmp_path, family):
    root, frames, gt = sintel
    tree = family_tree(TREES[family])
    pth = tmp_path / f"{family}.pth"
    torch.save({"model": {"module." + k: v for k, v in
                          state_dict_from_flax(tree).items()}}, pth)
    argv = ["--model", str(pth), *FAMILY_FLAGS[family], "--dataset",
            "sintel", "--fullprec", "--iters", str(ITERS), "--data_root",
            str(root), "--device", "cpu"]
    got = teval.main(argv)
    jcfg = jcli.model_config_from_args(_parse(jcli, FAMILY_FLAGS[family]))
    jcfg = jcfg.replace(mixed_precision=False)
    img1, img2 = (jnp.asarray(f[None].astype(np.float32)) for f in frames)
    _, flows = JaxFlowModel(cfg=jcfg).apply(
        jax.tree.map(jnp.asarray, tree), img1, img2, iters=ITERS)
    epe = float(np.sqrt(((np.asarray(flows[-1][0]) - gt) ** 2).sum(-1))
                .mean())
    print(family, got, epe)
    assert abs(got["sintel_clean_epe"] - epe) <= 1e-4
    packed = teval.main(argv + ["--upsample_mode", "packed"])
    assert packed == got


@pytest.fixture(scope="module")
def chairs_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("chairs")
    chip_smoke.write_chairs(root, 6, 2, (80, 96))
    return root


def _train(chairs_tree, out, *flags):
    argv = _cli_args(chairs_tree, out, "--num_steps", "2", *flags)
    # _cli_args names full CRAFT; a family flag that follows overrides it
    # (--raft and --nogma take precedence over --craft --setrans).
    return ttrain.main(argv)


def test_train_cli_raft_and_nogma(chairs_tree, tmp_path, capsys):
    state = _train(chairs_tree, tmp_path / "raft", "--raft", "--attn_diag")
    log = capsys.readouterr().out
    assert "Parameter Count: 5257536" in log
    assert "attn_max" not in log
    assert state.step == 2 and state.model.cfg.arch == "raft"
    state = _train(chairs_tree, tmp_path / "nogma", "--nogma",
                   "--attn_diag")
    log = capsys.readouterr().out
    assert "attn_max" in log and "attn_clamp_frac" in log
    assert state.model.att is None and state.model.f2_trans is not None
    for p in state.model.parameters():
        assert torch.isfinite(p).all()


def test_train_cli_final_trains_as_packed(chairs_tree, tmp_path):
    final = _train(chairs_tree, tmp_path / "final", "--raft",
                   "--upsample_mode", "final")
    packed = _train(chairs_tree, tmp_path / "packed", "--raft",
                    "--upsample_mode", "packed")
    for (name, a), b in zip(final.model.named_parameters(),
                            packed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("family", ["raft", "gma_attention", "nogma",
                                    "f2_none", "f1_shared"])
def test_flop_breakdown_of_each_family_matches_jax(family):
    """--flop's analytic table for each family, against the JAX package's
    (craft_tpu/eval/flops.py:85-114), and the counted forward at 64x96."""
    from craft_tpu.eval import flops as jflops
    from craft_tpu_torch.eval import flops as tflops

    flags = FAMILY_FLAGS[family]
    jcfg = jcli.model_config_from_args(_parse(jcli, flags))
    tcfg = tcli.model_config_from_args(_parse(tcli, flags))
    assert tflops.model_flops_breakdown(tcfg, 440, 1024) == \
        jflops.model_flops_breakdown(jcfg, 440, 1024)
    counted, kernels = tflops.count_model_flops(
        tcfg.replace(mixed_precision=False),
        FlowModel(tcfg).state_dict(), image_shape=HW, iters=2,
        device="cpu")
    assert counted > 0 and kernels == 0.0
