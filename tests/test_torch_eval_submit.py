"""The port's submission writers, single-pair demo, FLOP counts and
checkpoint conversion on the CPU against the JAX package's.

Synthetic trees (``chip_smoke``'s writers) at 64x128: a Sintel test scene
of three frames, a KITTI testing pair at 60x124 and VIPER test frames at
128x256 (JPEG, run at half resolution), so that every forward runs at the
padded shape 64x128; full-width CRAFT in fp32 with the oracle's weights
(tests/data/oracle_craft_128.npz) bridged by ``state_dict_from_flax``, and
4 iterations in place of the CLIs' 32 and 24.

  * Sintel .flo files within 1e-3 px with the warm start (frames 2 and 3
    start from the forward-splatted low-res flow of the pair before; the
    first frame of a scene as without it); KITTI's 16-bit PNGs within one count (1/64 px); VIPER's
    .flo within 1e-3 px after the resize back; --vis PNGs within one
    colour level (a flow 1e-5 px away can cross a floor).
  * gen_flow's returned flow within 1e-3 px of the JAX gen_flow's, plain,
    at scale 0.5 and with xy_shift, each with a ground truth; its PNG
    within one colour level of the JAX PNG.
  * The analytic FLOPs equal the JAX breakdown; the counted FLOPs beside
    the JAX package's XLA cost analysis (see the test for the bound).
  * --convert: the JAX CLI's converter loads the written .pth into the
    same variables, which give the JAX flow bit for bit.

The JAX writers and demo build their evaluators anew; the module fixture
hands them one per (iters, test_mode) and one warm-start evaluator.
"""

import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import craft_tpu.config as jconfig
from craft_tpu.eval import demo as jdemo
from craft_tpu.eval import evaluate as jev
from craft_tpu.eval import flops as jflops
from craft_tpu.eval import submission as jsub
from craft_tpu.utils.torch_convert import convert_checkpoint
import craft_tpu_torch.config as tconfig
from craft_tpu_torch import evaluate as tcli
from craft_tpu_torch.data import frame_utils as tfu
from craft_tpu_torch.data import imgio
from craft_tpu_torch.eval import demo as tdemo
from craft_tpu_torch.eval import flops as tflops
from craft_tpu_torch.eval import submission as tsub
from craft_tpu_torch.ops.kernels import launch
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


def _jpeg(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _cfg(m):
    return m.craft_config(mixed_precision=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX variables, the port's state_dict, the data root)."""
    # The oracle's full-width tree (no JAX init to compile).
    variables = load_oracle_npz(ORACLE)[3]
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    # Smooth frames, so that consecutive frames' flows are not noise.
    base = _frame(rng, (H + 8, W + 8)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = [base[i:i + H, 2 * i:2 * i + W].astype(np.uint8)
              for i in range(3)]
    cs.write_sintel_tree(root, frames, split="test")
    cs.write_sintel_tree(root, frames[:2], [rng.uniform(
        -3, 3, (H, W, 2)).astype(np.float32)])
    cs.write_kitti_tree(root, [(_frame(rng, (H - 4, W - 4)),
                                _frame(rng, (H - 4, W - 4)))],
                        split="testing")
    big = [_frame(rng, (2 * H, 2 * W)) for _ in range(2)]
    cs.write_viper_tree(root, [tuple(_jpeg(x) for x in big)], split="test")
    tfu.write_flo(str(root / "viper_gt.flo"), rng.uniform(
        -6, 6, (2 * H, 2 * W, 2)).astype(np.float32))
    evaluators, make = {}, jev.Evaluator

    def shared(cfg, variables, iters=12, test_mode=1, seq_parallel=None):
        key = (iters, test_mode)
        if key not in evaluators:
            evaluators[key] = make(cfg, variables, iters, test_mode,
                                   seq_parallel)
        return evaluators[key]
    inits, make_init = {}, jsub._InitEvaluator

    def shared_init(cfg, variables, iters):
        if iters not in inits:
            inits[iters] = make_init(cfg, variables, iters)
        return inits[iters]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "Evaluator", shared)
        mp.setattr(jdemo, "Evaluator", shared)
        mp.setattr(jsub, "_InitEvaluator", shared_init)
        yield variables, state_dict_from_flax(variables), root


def _files(root: Path, pattern: str):
    return sorted(p.relative_to(root) for p in root.glob(pattern))


def _close_png(a: Path, b: Path):
    """Two flow_viz PNGs of flows within 1e-3 px: within one level."""
    x = imgio.load(str(a)).astype(int)
    y = np.array(Image.open(b)).astype(int)
    assert x.shape == y.shape
    assert np.abs(x - y).max() <= 1


def test_sintel_submission_matches_jax(setup, tmp_path, monkeypatch):
    """With the warm start and --vis: frames 2 and 3 of each pass start
    from the forward-splatted low-res flow of the pair before."""
    variables, sd, root = setup
    monkeypatch.chdir(tmp_path)
    kw = dict(data_root=str(root), warm_start=True, iters=ITERS,
              do_vis=True)
    jsub.create_sintel_submission(_cfg(jconfig), variables,
                                  output_path=str(tmp_path / "jax"),
                                  model_name="jax", **kw)
    tsub.create_sintel_submission(_cfg(tconfig), sd, device=CPU,
                                  output_path=str(tmp_path / "port"),
                                  model_name="port", **kw)
    flos = _files(tmp_path / "jax", "*/*/*.flo")
    assert len(flos) == 4 and flos == _files(tmp_path / "port", "*/*/*.flo")
    for f in flos:
        got = tfu.read_flo(str(tmp_path / "port" / f))
        want = tfu.read_flo(str(tmp_path / "jax" / f))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    vis = tmp_path / "vis_sintel" / "test"
    pngs = _files(vis / "jax", "*/*/*.png")
    assert len(pngs) == 4 and pngs == _files(vis / "port", "*/*/*.png")
    for f in pngs:
        _close_png(vis / "port" / f, vis / "jax" / f)
    # The chain moved frame 2's flow: a run without it differs there.
    cold = tmp_path / "cold"
    tsub.create_sintel_submission(_cfg(tconfig), sd, device=CPU,
                                  data_root=str(root), iters=ITERS,
                                  output_path=str(cold))
    f = Path("clean", "alley_1", "frame0002.flo")
    assert np.abs(tfu.read_flo(str(cold / f))
                  - tfu.read_flo(str(tmp_path / "port" / f))).max() > 1e-2
    np.testing.assert_array_equal(
        tfu.read_flo(str(cold / "clean" / "alley_1" / "frame0001.flo")),
        tfu.read_flo(str(tmp_path / "port" / "clean" / "alley_1"
                         / "frame0001.flo")))


def test_kitti_submission_matches_jax(setup, tmp_path):
    variables, sd, root = setup
    kw = dict(data_root=str(root), iters=ITERS)
    jsub.create_kitti_submission(_cfg(jconfig), variables,
                                 output_path=str(tmp_path / "jax"), **kw)
    tsub.create_kitti_submission(_cfg(tconfig), sd, device=CPU,
                                 output_path=str(tmp_path / "port"), **kw)
    assert _files(tmp_path / "jax", "*.png") == \
        _files(tmp_path / "port", "*.png") == [Path("000000_10.png")]
    got = imgio.load(str(tmp_path / "port" / "000000_10.png")).astype(int)
    # The JAX package writes it with OpenCV (BGR); PIL reads no 16-bit RGB.
    want = cv2.imread(str(tmp_path / "jax" / "000000_10.png"),
                      cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)[..., ::-1]
    assert got.shape == (H - 4, W - 4, 3) and want.dtype == np.uint16
    assert np.abs(got - want.astype(int)).max() <= 1  # one count: 1/64 px


def test_viper_submission_matches_jax(setup, tmp_path):
    variables, sd, root = setup
    kw = dict(data_root=str(root), iters=ITERS)
    jsub.create_viper_submission(_cfg(jconfig), variables,
                                 output_path=str(tmp_path / "jax"), **kw)
    tsub.create_viper_submission(_cfg(tconfig), sd, device=CPU,
                                 output_path=str(tmp_path / "port"), **kw)
    name = "001_00010.flo"
    got = tfu.read_flo(str(tmp_path / "port" / name))
    assert got.shape == (2 * H, 2 * W, 2)
    np.testing.assert_allclose(
        got, tfu.read_flo(str(tmp_path / "jax" / name)), atol=1e-3, rtol=0)


@pytest.mark.parametrize("case", ["plain", "scale", "shift"])
def test_gen_flow_matches_jax(setup, tmp_path, case):
    """The returned flow and the PNG, each with a ground truth: the Sintel
    pair (plain; xy_shift (8, 4)) and the VIPER JPEG pair at scale 0.5."""
    variables, sd, root = setup
    if case == "scale":
        scene = root / "viper" / "jpg" / "test" / "img" / "001"
        pair = [str(scene / f"001_000{i}.jpg") for i in (10, 11)]
        gt, kw = str(root / "viper_gt.flo"), dict(scale=0.5)
    else:
        scene = root / "Sintel" / "training" / "clean" / "alley_1"
        pair = [str(scene / f"frame_000{i}.png") for i in (1, 2)]
        gt = str(root / "Sintel" / "training" / "flow" / "alley_1"
                 / "frame_0001.flo")
        kw = dict(xy_shift=(8, 4)) if case == "shift" else {}
    want = jdemo.gen_flow(_cfg(jconfig), variables, *pair, gt,
                          output_path=str(tmp_path / "jax"), iters=ITERS,
                          **kw)
    got = tdemo.gen_flow(_cfg(tconfig), sd, *pair, gt,
                         output_path=str(tmp_path / "port"), iters=ITERS,
                         device=CPU, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    png = Path(pair[0]).stem + f"-craft-{ITERS}.png"
    _close_png(tmp_path / "port" / png, tmp_path / "jax" / png)


@pytest.mark.parametrize("hw", [(128, 128), (436, 1024), (1080, 2560)])
def test_analytic_flops_equal_the_jax_breakdown(hw):
    assert tflops.model_flops_breakdown(_cfg(tconfig), *hw) == \
        jflops.model_flops_breakdown(_cfg(jconfig), *hw)


def test_counted_flops_beside_the_jax_cost_analysis(setup):
    """At 128x128 with 2 iterations, on the CPU, where the wrappers run
    their plain versions and FlopCounterMode counts them.  The count is
    within 3 % of the analytic total (FlopCounterMode counts products and
    convolutions, no elementwise work, as the analytic model).  XLA's cost
    analysis counts the body of the refinement loop, a lax.scan, once
    whatever its trip count: it is the port's count less one iteration's
    update block and lookup (analytic), within 3 %.  The launch counters
    are left as they were."""
    variables, sd, _ = setup
    iters = 2
    xla = jdemo.count_model_flops(_cfg(jconfig), variables, (128, 128),
                                  iters)
    wrapper = launch._COUNTED[0]
    wrapper.launches, wrapper.flops = 3, 5.0
    try:
        torch_flops, kernel_flops = tflops.count_model_flops(
            _cfg(tconfig), sd, (128, 128), iters, device=CPU)
        assert (wrapper.launches, wrapper.flops) == (3, 5.0)
    finally:
        launch.reset_launch_counts()
    assert kernel_flops == 0  # no kernel launches on the CPU
    bd = tflops.model_flops_breakdown(_cfg(tconfig), 128, 128, iters)
    loop = (bd[f"update_block (x{iters})"]
            + bd[f"corr_lookup (x{iters})"]) * 1e9
    assert abs(torch_flops / (bd["total"] * 1e9) - 1) < 0.03
    assert abs((torch_flops - loop * (iters - 1) / iters) / xla - 1) < 0.03


def test_convert_writes_what_the_jax_cli_loads(setup, tmp_path):
    variables, sd, root = setup
    pth = str(tmp_path / "in.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    out = tcli.main(["--model", pth, "--craft", "--setrans", "--fullprec",
                     "--device", CPU, "--convert", str(tmp_path / "conv")])
    assert out == str(tmp_path / "conv" / "craft.pth")
    loaded, report = convert_checkpoint(out, _cfg(jconfig), variables,
                                        strict=False)
    assert not report["missing"]
    img = np.random.RandomState(1).uniform(0, 255, (1, H, W, 3)).astype(
        np.float32)
    ev = jev.Evaluator(_cfg(jconfig), variables, ITERS)
    want = ev._forward(variables, img, img[:, ::-1].copy(), iters=ITERS,
                       test_mode=1)[1]
    got = ev._forward(loaded, img, img[:, ::-1].copy(), iters=ITERS,
                      test_mode=1)[1]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
