"""The port's evaluator on the CPU against the JAX package's: Sintel (batch
1, and batch 2 with test_mode 2), KITTI and FlyingChairs validation on
synthetic trees at 64x128 (KITTI at 60x124, so that its bottom padding
runs), full-width CRAFT in fp32 with the oracle's weights
(tests/data/oracle_craft_128.npz: no JAX init to compile) bridged by
``state_dict_from_flax``.  Every metric agrees within 1e-3 px,
or 1e-3 of a share (KITTI's F1 is a percentage).  Then the port's CLI over
a saved reference-format .pth, its checkpoint loader, the flags that once
exited (submissions, the shift sweep, --convert, --flop, --vis, --dataset
things), and those it does not run yet (``tests/test_torch_eval_dense.py``
runs the CLI under --interpos/--intrapos lsinu and --f2radius).

Each JAX validator builds its own Evaluator, whose jitted forward compiles
anew; the module fixture hands them one Evaluator per (iters, test_mode),
so the four validators compile twice (the JAX package is not changed).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import craft_tpu.config as jconfig
from craft_tpu.eval import demo as jdemo
from craft_tpu.eval import evaluate as jev
from craft_tpu.utils.torch_convert import strip_prefixes as jax_strip
import craft_tpu_torch.config as tconfig
from craft_tpu_torch import cli
from craft_tpu_torch import evaluate as tcli
from craft_tpu_torch.data import frame_utils as tfu
from craft_tpu_torch.data import imgio
from craft_tpu_torch.data.flow_viz import flow_to_image
from craft_tpu_torch.eval import evaluate as tev
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.utils.weights import (load_oracle_npz,
                                           load_reference_checkpoint,
                                           state_dict_from_flax,
                                           strip_prefixes)

import chip_smoke
import test_torch_data as td

H, W, ITERS = 64, 128, 4
CPU = "cpu"
ORACLE = Path(__file__).resolve().parent / "data" / "oracle_craft_128.npz"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's forwards: under pytest-xdist the
    workers share the cores, and every extra spinning thread slows them
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX variables, the port's state_dict, a data root holding Sintel
    (one scene, 2 pairs), KITTI and FlyingChairs trees)."""
    # The oracle's full-width tree (no JAX init to compile).
    variables = load_oracle_npz(ORACLE)[3]
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.RandomState(0)
    td.write_sintel(os.path.join(root, "Sintel"), rng, scenes=("alley_1",),
                    H=H, W=W)
    td.write_kitti(os.path.join(root, "KITTI"), rng, H=H - 4, W=W - 4)
    td.write_chairs(os.path.join(root, "FlyingChairs_release"), rng, H=H,
                    W=W)
    evaluators, make = {}, jev.Evaluator

    def shared(cfg, variables, iters=12, test_mode=1, seq_parallel=None):
        key = (iters, test_mode)
        if key not in evaluators:
            evaluators[key] = make(cfg, variables, iters, test_mode,
                                   seq_parallel)
        return evaluators[key]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "Evaluator", shared)
        mp.setattr(jdemo, "Evaluator", shared)
        yield variables, state_dict_from_flax(variables), root


def _agree(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = 100.0 if key.endswith("_f1") else 1.0  # F1 in percent
        assert abs(got[key] - w) / scale <= 1e-3, (key, got[key], w)


@pytest.mark.parametrize("batch_size,test_mode", [(1, 1), (2, 2)])
def test_validate_sintel_matches_jax(setup, batch_size, test_mode):
    variables, sd, root = setup
    kw = dict(iters=ITERS, data_root=root, dstype="clean",
              batch_size=batch_size, test_mode=test_mode)
    want = jev.validate_sintel(jconfig.craft_config(mixed_precision=False),
                               variables, **kw)
    got = tev.validate_sintel(tconfig.craft_config(mixed_precision=False), sd,
                              device=CPU, **kw)
    if test_mode == 2:
        assert f"sintel_clean_iter{ITERS - 1}_epe" in got
    _agree(got, want)


def test_validate_kitti_matches_jax(setup):
    variables, sd, root = setup
    want = jev.validate_kitti(jconfig.craft_config(mixed_precision=False),
                              variables, iters=ITERS, data_root=root)
    got = tev.validate_kitti(tconfig.craft_config(mixed_precision=False), sd,
                             iters=ITERS, data_root=root, device=CPU)
    _agree(got, want)


def test_validate_chairs_matches_jax(setup):
    variables, sd, root = setup
    want = jev.validate_chairs(jconfig.craft_config(mixed_precision=False),
                               variables, iters=ITERS, data_root=root)
    got = tev.validate_chairs(tconfig.craft_config(mixed_precision=False), sd,
                              iters=ITERS, data_root=root, device=CPU)
    _agree(got, want)


def _save_pth(sd, path):
    """The reference's checkpoint layout: DataParallel keys in {'model'}."""
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "step": 100}, path)


def test_cli_over_a_saved_pth(setup, tmp_path):
    variables, sd, root = setup
    pth = str(tmp_path / "craft.pth")
    _save_pth(sd, pth)
    args = ["--model", pth, "--craft", "--setrans", "--iters", str(ITERS),
            "--device", CPU, "--max_val_count", "1"]
    got = tcli.main(args + ["--fullprec", "--dataset", "sintel",
                            "--data_root", root])
    want = tev.validate_sintel(tconfig.craft_config(mixed_precision=False), sd,
                               iters=ITERS, data_root=root, max_val_count=1,
                               device=CPU)
    assert got == want and "sintel_final_epe" in got
    mixed = tcli.main(args + ["--dataset", "kitti", "--data_root", root])
    assert np.isfinite(list(mixed.values())).all()
    # The single pair writes its flow_viz PNG, as the JAX gen_flow: the
    # flow within 1e-3 px of the JAX one, the PNG within one colour level
    # (tests/test_torch_eval_submit.py adds --scale and a shift).
    scene = os.path.join(root, "Sintel", "training", "clean", "alley_1")
    pair = [os.path.join(scene, f"frame_000{i}.png") for i in (1, 2)]
    out = str(tmp_path / "out")
    flow = tcli.main(args + ["--fullprec", "--img1", pair[0], "--img2",
                             pair[1], "--output_path", out])
    want = jdemo.gen_flow(jconfig.craft_config(mixed_precision=False),
                          variables, *pair, output_path=str(tmp_path / "j"),
                          iters=ITERS)
    assert flow.shape == (H, W, 2)
    np.testing.assert_allclose(flow, want, atol=1e-3, rtol=0)
    png = imgio.load(os.path.join(out, "frame_0001-craft-4.png"))
    np.testing.assert_array_equal(png, flow_to_image(flow))
    jpng = np.array(Image.open(tmp_path / "j" / "frame_0001-craft-4.png"))
    assert np.abs(png.astype(int) - jpng).max() <= 1


@pytest.mark.parametrize("mixed", [False, True])
def test_cli_config_is_craft_config(mixed):
    args = tcli.parse_args(["--model", "x.pth", "--craft", "--setrans"]
                           + ([] if mixed else ["--fullprec"]))
    assert cli.model_config_from_args(args) == tconfig.craft_config(
        mixed_precision=mixed)


def test_loader_unwraps_like_the_jax_converter(setup, tmp_path):
    _, sd, _ = setup
    state = {"model": {f"module.{k}": v for k, v in sd.items()}}
    assert sorted(strip_prefixes(state)) == sorted(jax_strip(state))
    assert sorted(strip_prefixes(sd)) == sorted(jax_strip(sd)) == sorted(sd)
    # A bare state_dict with one entry missing and one foreign entry.
    bare = {k: v for k, v in sd.items() if k != "fnet.conv1.weight"}
    bare["extra.weight"] = torch.zeros(1)
    bare["epoch"] = 3
    pth = str(tmp_path / "bare.pth")
    torch.save(bare, pth)
    model = FlowModel(tconfig.craft_config(mixed_precision=False))
    missing, unexpected = load_reference_checkpoint(pth, model)
    assert missing == ["fnet.conv1.weight"] and unexpected == ["extra.weight"]
    torch.testing.assert_close(model.state_dict()["cnet.conv1.weight"],
                               sd["cnet.conv1.weight"], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(pth, model, strict=True)


# Mode counts that leave a mode dim below 16 or do not divide the width,
# with and without --seq_parallel (which runs every family and flag since
# item 8's first parts, tests/test_torch_sp_dense.py and
# test_torch_sp_families.py, and exits only where the config does).
@pytest.mark.parametrize("flags,item", [
    (["--nogma", "--intramodes", "32"], "item 6"), (["--f2modes", "64"],
                                                    "item 6"),
    (["--f1", "shared", "--intermodes", "3"], "item 6"),
    (["--intramodes", "16"], "item 6"),
    (["--seq_parallel", "--f1", "shared", "--f2modes", "32"], "item 6"),
    (["--seq_parallel", "--intrapos", "lsinu", "--intramodes", "16"],
     "item 6"),
    (["--seq_parallel", "--f2radius", "3", "--f2modes", "64"], "item 6"),
    (["--seq_parallel", "--nogma", "--intermodes", "3"], "item 6"),
    (["--seq_parallel", "--nogma", "--intramodes", "32"], "item 6"),
    (["--seq_parallel", "--f2", "none", "--intermodes", "64"], "item 6")])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md section 2, {item}"):
        tcli.main(["--model", "absent.pth", "--craft", "--setrans",
                   "--device", CPU] + flags)


# What exited naming ROADMAP item 6 (mode counts other than 4) runs.
@pytest.mark.parametrize("flags", [
    ["--nogma", "--intramodes", "2"], ["--f2modes", "8"],
    ["--f1", "shared", "--intermodes", "2"], ["--intermodes", "2"]])
def test_cli_runs_other_mode_counts(tmp_path, flags):
    """The flags build the JAX CLI's config, field by field, and the
    evaluator runs one pair over a .pth of that config (``chip_smoke.
    config_weights``: the oracle's tensors where their shapes hold) on the
    CPU, its metrics finite."""
    import craft_tpu.cli as jcli
    from test_torch_modes import parse, same_config
    argv = ["--craft", "--setrans"] + flags
    got = cli.model_config_from_args(parse(cli, argv))
    same_config(got, jcli.model_config_from_args(parse(jcli, argv)))
    pth = str(tmp_path / "modes.pth")
    _save_pth(chip_smoke.config_weights(got), pth)
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (32, 64, 3)).astype(np.uint8)
              for _ in range(2)]
    chip_smoke.write_sintel_tree(tmp_path / "data", frames,
                                 [np.zeros((32, 64, 2), np.float32)])
    out = tcli.main(["--model", pth, *argv, "--fullprec", "--iters", "2",
                     "--dataset", "sintel", "--data_root",
                     str(tmp_path / "data"), "--device", CPU])
    assert all(np.isfinite(v) for v in out.values()), out


@pytest.mark.parametrize("flag", ["submission", "xshifts", "convert", "flop",
                                  "vis", "things"])
def test_cli_runs_the_evaluator_flags(setup, tmp_path, monkeypatch, flag):
    """What exited naming ROADMAP item 4 runs (fp32, on the CPU): the
    Sintel submission with --warm_start (32 iterations, one test pair a
    pass), the shift sweep, --convert, --flop on one pair, the KITTI
    submission with --vis, and --dataset things.
    ``tests/test_torch_eval_sets.py`` and ``tests/test_torch_eval_submit.py``
    hold what each computes against the JAX package."""
    _, sd, root = setup
    monkeypatch.chdir(tmp_path)
    pth = str(tmp_path / "craft.pth")
    _save_pth(sd, pth)
    args = ["--model", pth, "--craft", "--setrans", "--fullprec",
            "--iters", str(ITERS), "--device", CPU]
    rng = np.random.RandomState(1)
    small = (H // 2, W // 2)  # the port alone: no JAX shape to share
    frames = [rng.randint(0, 256, (*small, 3)).astype(np.uint8)
              for _ in range(2)]
    scene = os.path.join(root, "Sintel", "training", "clean", "alley_1")
    pair = [os.path.join(scene, f"frame_000{i}.png") for i in (1, 2)]
    if flag == "submission":
        chip_smoke.write_sintel_tree(tmp_path, frames, split="test")
        out = tcli.main(args + ["--submission", "sintel", "--warm_start",
                                "--data_root", str(tmp_path)])
        flo = tfu.read_flo(os.path.join(out, "final", "alley_1",
                                        "frame0001.flo"))
        assert flo.shape == (*small, 2) and np.isfinite(flo).all()
    elif flag == "xshifts":
        got = tcli.main(args + ["--dataset", "sintel", "--data_root", root,
                                "--xshifts", "8,0", "--yshifts", "4,0",
                                "--max_val_count", "1"])
        plain = tcli.main(args + ["--dataset", "sintel", "--data_root",
                                  root, "--max_val_count", "1"])
        assert len(got) == 2 and got[1] == plain and got[0] != plain
    elif flag == "convert":
        out = tcli.main(args + ["--convert", str(tmp_path / "conv")])
        model = FlowModel(tconfig.craft_config(mixed_precision=False))
        assert load_reference_checkpoint(out, model) == ([], [])
        for k, v in sd.items():
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0,
                                       atol=0)
    elif flag == "flop":
        got = tcli.main(args + ["--flop", "--img1", pair[0], "--img2",
                                pair[1]])
        assert got["kernel_flops"] == 0 and got["torch_flops"] > 1e9
        assert got["analytic_gflops"]["total"] > 1
    elif flag == "vis":
        chip_smoke.write_kitti_tree(tmp_path, [frames], split="testing")
        out = tcli.main(args + ["--submission", "kitti", "--vis",
                                "--data_root", str(tmp_path)])
        flow, valid = tfu.read_flow_kitti(os.path.join(out,
                                                       "000000_10.png"))
        assert flow.shape == (*small, 2) and valid.all()
        vis = tmp_path / "vis_kitti" / "craft" / "000000_10.png"
        assert imgio.load(str(vis)).shape == (*small, 3)
    else:
        chip_smoke.write_things_tree(tmp_path, frames, [
            rng.uniform(-3, 3, (*small, 2)).astype(np.float32)
            for _ in range(2)])
        got = tcli.main(args + ["--dataset", "things", "--data_root",
                                str(tmp_path)])
        assert np.isfinite(list(got.values())).all()
        assert {"things_clean_epe", "things_final_5px"} <= set(got)


def test_gma_attention_exits():
    """GMA attention (no --setrans) serves (tests/test_torch_family_cli.py),
    under --seq_parallel too; it exits only where a SETrans site it has
    takes a mode count that is not ported, naming ROADMAP item 6."""
    with pytest.raises(SystemExit, match="--intermodes.*item 6"):
        tcli.main(["--model", "absent.pth", "--craft", "--seq_parallel",
                   "--intermodes", "3", "--device", CPU])


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--model", "absent.pth", "--craft", "--setrans",
                   "--dataset", "sintel"])
