"""The port's six further validators on the CPU against the JAX package's:
FlyingThings3D (test_mode 1 and 2), Sintel's occlusion split, the KITTI
re-split (kittitrain), HD1K, VIPER (JPEG frames at half resolution, the
flow resized back) and SlowFlow (test_mode 1 and 2), and the shift
protocol (``xy_shift``) through the dense, sparse and chairs loops.  Every
tree is synthetic, written by ``chip_smoke``'s writers at 64x128 (the
sparse sets at 60x124, VIPER's frames at 128x256), so that every forward
runs at the one padded shape 64x128; full-width CRAFT in fp32 with the
oracle's weights (tests/data/oracle_craft_128.npz) bridged by
``state_dict_from_flax``.  Every
metric agrees within 1e-3 px, or 1e-3 of a share (F1 is a percentage).

The JAX validators build an Evaluator each; the module fixture hands them
one per (iters, test_mode), so the JAX forward compiles twice in all.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import craft_tpu.config as jconfig
from craft_tpu.eval import evaluate as jev
import craft_tpu_torch.config as tconfig
from craft_tpu_torch.eval import evaluate as tev
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

import chip_smoke as cs

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


def _frame(rng, hw):
    return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)


def _flow(rng, hw, top=6.0):
    return rng.uniform(-top, top, (*hw, 2)).astype(np.float32)


def _jpeg(img, quality=90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def write_trees(root: Path, rng) -> None:
    """Things (2 frames: one pair a pass), Sintel with occlusion masks (3
    frames), KITTI (4 pairs: kittitrain holds out 2), HD1K (3 frames),
    VIPER's val split (one JPEG pair) and SlowFlow (2 pairs)."""
    hw, sparse = (H, W), (H - 4, W - 4)
    cs.write_things_tree(root, [_frame(rng, hw) for _ in range(2)],
                         [_flow(rng, hw) for _ in range(2)])
    occ = [np.where(rng.uniform(size=hw) < 0.3, 255, 0).astype(np.uint8)
           for _ in range(2)]
    cs.write_sintel_tree(root, [_frame(rng, hw) for _ in range(3)],
                         [_flow(rng, hw) for _ in range(2)], occ)
    cs.write_kitti_tree(root, [(_frame(rng, sparse), _frame(rng, sparse))
                               for _ in range(4)],
                        [_flow(rng, sparse, 10) for _ in range(4)])
    cs.write_hd1k_tree(root, [_frame(rng, sparse) for _ in range(3)],
                       [_flow(rng, sparse, 10) for _ in range(3)])
    big = (2 * H, 2 * W)
    cs.write_viper_tree(root, [(_jpeg(_frame(rng, big)),
                                _jpeg(_frame(rng, big)))],
                        [_flow(rng, big, 10)])
    cs.write_slowflow_tree(root, [(_frame(rng, hw), _frame(rng, hw))
                                  for _ in range(2)],
                           [_flow(rng, hw) for _ in range(2)])
    cs.write_chairs(root, 0, 2, hw, seed=3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX variables, the port's state_dict, the data root)."""
    # The oracle's full-width tree (no JAX init to compile).
    variables = load_oracle_npz(ORACLE)[3]
    root = tmp_path_factory.mktemp("data")
    write_trees(root, np.random.RandomState(0))
    evaluators, make = {}, jev.Evaluator

    def shared(cfg, variables, iters=12, test_mode=1, seq_parallel=None):
        key = (iters, test_mode)
        if key not in evaluators:
            evaluators[key] = make(cfg, variables, iters, test_mode,
                                   seq_parallel)
        return evaluators[key]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "Evaluator", shared)
        yield variables, state_dict_from_flax(variables), str(root)


def _agree(got: dict, want: dict):
    assert sorted(got) == sorted(want) and got
    for key, w in want.items():
        scale = 100.0 if key.endswith("_f1") else 1.0  # F1 in percent
        assert abs(got[key] - w) / scale <= 1e-3, (key, got[key], w)


def _both(setup, name, **kw):
    variables, sd, root = setup
    kw = dict(iters=ITERS, data_root=root, **kw)
    want = jev.VALIDATORS[name](jconfig.craft_config(mixed_precision=False),
                                variables, **kw)
    got = tev.VALIDATORS[name](tconfig.craft_config(mixed_precision=False),
                               sd, device=CPU, **kw)
    _agree(got, want)
    return got


def test_validators_have_the_jax_names():
    assert sorted(tev.VALIDATORS) == sorted(jev.VALIDATORS)


@pytest.mark.parametrize("name", ["things", "slowflow"])
@pytest.mark.parametrize("test_mode", [1, 2])
def test_dense_validators_match_jax(setup, name, test_mode):
    got = _both(setup, name, test_mode=test_mode)
    if test_mode == 2:
        assert any(k.endswith(f"_iter{ITERS - 1}_epe") for k in got)


def test_validate_sintel_occ_matches_jax(setup):
    got = _both(setup, "sintel_occ")
    assert {"sintel_occ_clean_occ_epe", "sintel_occ_final_noc_epe"} <= \
        set(got)


@pytest.mark.parametrize("name", ["kittitrain", "hd1k"])
def test_sparse_validators_match_jax(setup, name):
    got = _both(setup, name)
    assert f"{name}_f1" in got


def test_validate_viper_matches_jax(setup):
    """VIPER's JPEG frames decoded by the port's decoder (PIL's pixels on
    the JAX side), resized to half, the flow resized back to 128x256."""
    _both(setup, "viper")


@pytest.mark.parametrize("name,kw", [
    ("sintel", dict(dstype="clean")), ("things", dict(dstype="clean")),
    ("kitti", {}), ("hd1k", {}), ("chairs", {})])
def test_shift_protocol_matches_jax(setup, name, kw):
    """xy_shift (12, 6): image1 and the ground truth moved, the vacated
    border left out, the magnitudes taken with the offset added back."""
    _both(setup, name, xy_shift=(12, 6), **kw)
