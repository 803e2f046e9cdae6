"""The evaluator's host pieces in the port against the JAX package, PIL and
OpenCV, on the CPU:

  * flow_viz: the colour wheel and flow_to_image bit-identical to the JAX
    package's on identical flows; warp_flow (grid_sample) within OpenCV's
    remap, which rounds coordinates to 1/32 px.
  * shift_pixels and forward_interpolate bit-identical.
  * the Sintel bundle reader: generate_selector and read_bundle give the
    JAX package's arrays on a bundle that native/bundler writes.
  * the baseline JPEG decoder bit-identical to PIL (4:2:0, 4:2:2, 4:4:4
    and gray; quality 75 and 95; restart intervals; odd sizes), and the
    committed VIPER fixtures decoding to their recorded hashes (the other
    JPEG and PNG forms: tests/test_torch_imgio_formats.py).
  * resize_linear with a destination size against cv2.resize.
  * read_disp_kitti, and the Sintel occlusion, VIPER and SlowFlow datasets
    against the JAX package's.
"""

import hashlib
import io
import json
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from craft_tpu.data import datasets as jds
from craft_tpu.data import flow_viz as jviz
from craft_tpu.data import frame_utils as jfu
from craft_tpu.ops import geometry as jgeo
from craft_tpu.utils import bundle as jbundle
from craft_tpu_torch.data import datasets as tds
from craft_tpu_torch.data import flow_viz as tviz
from craft_tpu_torch.data import frame_utils as tfu
from craft_tpu_torch.data import imgio
from craft_tpu_torch.data.augmentor import resize_linear
from craft_tpu_torch.ops import geometry as tgeo
from craft_tpu_torch.utils import bundle as tbundle

import chip_smoke as cs

DATA = Path(__file__).resolve().parent / "data"
BUNDLER_DIR = Path(__file__).resolve().parents[1] / "native" / "bundler"


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ------------------------------------------------------------ flow_viz

def test_colorwheel_matches_jax():
    np.testing.assert_array_equal(tviz.make_colorwheel(),
                                  jviz.make_colorwheel())


@pytest.mark.parametrize("kw", [{}, {"convert_to_bgr": True},
                                {"clip_flow": 3.0}])
def test_flow_to_image_is_bit_identical(rng, kw):
    flow = (rng.randn(37, 61, 2) * 5).astype(np.float32)
    flow[0, 0] = 0  # a zero vector: the wheel's centre
    got = tviz.flow_to_image(flow, **kw)
    assert got.dtype == np.uint8 and got.shape == (37, 61, 3)
    np.testing.assert_array_equal(got, jviz.flow_to_image(flow, **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_flow_within_remaps_rounding(rng, dtype):
    """OpenCV's remap takes each coordinate to 1/32 px: its result is
    within (1/32) x the largest step between neighbouring pixels of the
    exact bilinear one (plus 0.5 where it rounds uint8)."""
    img = rng.randint(0, 256, (29, 43, 3)).astype(dtype)
    flow = (rng.randn(29, 43, 2) * 4).astype(np.float32)
    got = tviz.warp_flow(img, flow)
    want = jviz.warp_flow(img, flow)
    assert got.dtype == want.dtype and got.shape == want.shape
    f = img.astype(np.float64)
    step = max(np.abs(np.diff(f, axis=0)).max(),
               np.abs(np.diff(f, axis=1)).max())
    bound = step * 2 / 32 + (1.0 if dtype == np.uint8 else 1e-3)
    assert np.abs(got.astype(np.float64) - want).max() <= bound


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dx,dy", [(8, 4), (-5, 3), (0, -7), (13, 0)])
def test_shift_pixels_is_bit_identical(rng, dx, dy):
    img = rng.uniform(0, 255, (20, 30, 3)).astype(np.float32)
    flow = rng.randn(20, 30, 2).astype(np.float32)
    valid = (rng.uniform(size=(20, 30)) > 0.3).astype(np.float32)
    for v in (None, valid):
        got = tgeo.shift_pixels(img, flow, v, dx, dy)
        want = jgeo.shift_pixels(img, flow, v, dx, dy)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_forward_interpolate_is_bit_identical(rng):
    flow = (rng.randn(23, 41, 2) * 3).astype(np.float32)
    got = tgeo.forward_interpolate(flow)
    assert got.dtype == np.float32 and got.shape == flow.shape
    np.testing.assert_array_equal(got, jgeo.forward_interpolate(flow))


# ------------------------------------------------------------ bundle

def test_selector_matches_jax():
    np.testing.assert_array_equal(tbundle.generate_selector(48, 20),
                                  jbundle.generate_selector(48, 20))
    assert tbundle.SINTEL_TEST_SEQS == jbundle.SINTEL_TEST_SEQS


def test_read_bundle_matches_jax(tmp_path):
    """A bundle of the whole Sintel test layout (both passes, every
    sequence's frame count) at 32x16, written by native/bundler (built
    from a copy of its sources, so that no other test's build races it)."""
    src = tmp_path / "bundler_src"
    src.mkdir()
    for name in ("Makefile", "bundler.cpp"):
        shutil.copy(BUNDLER_DIR / name, src / name)
    r = subprocess.run(["make"], cwd=src, capture_output=True)
    binp = src / "bundler"
    assert r.returncode == 0 and binp.is_file(), r.stderr.decode()[-300:]
    rng = np.random.RandomState(7)
    for pas in ("clean", "final"):
        for name, nframes, _ in tbundle.SINTEL_TEST_SEQS:
            d = tmp_path / pas / name
            d.mkdir(parents=True)
            for i in range(1, nframes + 1):
                tfu.write_flo(str(d / f"frame{i:04d}.flo"),
                              rng.randn(16, 32, 2).astype(np.float32))
    out = str(tmp_path / "out.lzma")
    subprocess.run([str(binp), str(tmp_path / "clean"),
                    str(tmp_path / "final"), out], check=True,
                   capture_output=True)
    got, want = tbundle.read_bundle(out), jbundle.read_bundle(out)
    for key in ("w", "h", "total_samples", "seq_counts"):
        assert got[key] == want[key]
    for gp, wp in zip(got["passes"], want["passes"]):
        for gs, ws in zip(gp, wp):
            assert gs["name"] == ws["name"]
            np.testing.assert_array_equal(gs["canonical"], ws["canonical"])
            assert len(gs["frames"]) == len(ws["frames"])
            for gf, wf in zip(gs["frames"], ws["frames"]):
                np.testing.assert_array_equal(gf["indices"], wf["indices"])
                np.testing.assert_array_equal(gf["uv"], wf["uv"])


# ------------------------------------------------------------ JPEG

def _scene(rng, h, w, c=3):
    """Smooth content with edges and some noise: what a camera gives."""
    x = rng.rand(h // 4 + 2, w // 4 + 2, c) * 255
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(x + rng.randn(h, w, c) * 8, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(37, 61), (64, 128), (17, 9), (1, 1)],
                         ids=str)
@pytest.mark.parametrize("sampling", ["4:2:0", "4:2:2", "4:4:4", "gray"])
@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_is_bit_identical_to_pil(rng, hw, sampling, quality):
    img = _scene(rng, *hw)
    if sampling == "gray":
        img, kw = img[..., 0], {}
    else:
        kw = {"subsampling": sampling}
    data = _pil_jpeg(img, quality=quality, **kw)
    want = np.array(Image.open(io.BytesIO(data)))
    got = imgio.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}], ids=str)
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "gray"])
def test_jpeg_restart_intervals(rng, restart, sampling):
    img = _scene(rng, 45, 70)
    kw = {"subsampling": sampling} if sampling != "gray" else {}
    data = _pil_jpeg(img[..., 0] if sampling == "gray" else img,
                     quality=85, **restart, **kw)
    assert b"\xff\xdd" in data  # a DRI marker
    np.testing.assert_array_equal(imgio.decode_jpeg(data),
                                  np.array(Image.open(io.BytesIO(data))))


def test_jpeg_fixtures_decode_to_their_hashes():
    """tests/data/viper_*.jpg (tools/make_jpeg_fixtures.py): PIL's
    pixels, whose hashes chip_smoke.py also checks on the card."""
    meta = json.loads((DATA / "viper_jpeg.json").read_text())
    assert len(meta) == 4
    for name, m in meta.items():
        got = imgio.load(str(DATA / name))
        assert list(got.shape) == m["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            m["pixels_sha256"]
        np.testing.assert_array_equal(got, np.array(Image.open(DATA / name)))


# ------------------------------------------------------------ resize

@pytest.mark.parametrize("src,dst", [((27, 31), (55, 61)),
                                     ((272, 480), (544, 960)),
                                     ((40, 9), (17, 13))], ids=str)
def test_resize_to_a_size_matches_cv2(rng, src, dst):
    """OpenCV takes the scales as dsize / size when given a dsize (the
    VIPER flow brought back to full size): bit-identical on flows."""
    x = (rng.randn(*src, 2) * 10).astype(np.float32)
    want = cv2.resize(x, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear(x, dsize=(dst[1], dst[0]))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # fx = 1 / 0.5, as the VIPER submission.
    np.testing.assert_array_equal(
        resize_linear(x, 2.0, 2.0),
        cv2.resize(x, None, fx=2.0, fy=2.0, interpolation=cv2.INTER_LINEAR))
    # Three channels: OpenCV's vector path for them sums in another order,
    # a few float32 ulps away; exact on VIPER's frames (whole values
    # halved: every weight 1/2).
    x3 = (rng.randn(*src, 3) * 10).astype(np.float32)
    np.testing.assert_allclose(
        resize_linear(x3, dsize=(dst[1], dst[0])),
        cv2.resize(x3, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR),
        rtol=0, atol=1e-5 * np.abs(x3).max())
    frame = rng.randint(0, 256, (2 * src[0], 2 * src[1], 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        resize_linear(frame, 0.5, 0.5),
        cv2.resize(frame, None, fx=0.5, fy=0.5,
                   interpolation=cv2.INTER_LINEAR))


# ------------------------------------------------------------ datasets

def test_read_disp_kitti_matches_jax(rng, tmp_path):
    disp = rng.randint(0, 60000, (15, 29)).astype(np.uint16)
    disp[rng.uniform(size=disp.shape) < 0.3] = 0
    path = str(tmp_path / "disp.png")
    imgio.write_png(path, disp)
    (tf, tv), (jf, jv) = tfu.read_disp_kitti(path), jfu.read_disp_kitti(path)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)


def _same_items(tset, jset, keys):
    assert tset.image_list == jset.image_list
    assert tset.flow_list == jset.flow_list
    assert tset.extra_info == jset.extra_info
    assert len(tset) == len(jset) > 0
    for i in range(len(jset)):
        t, j = tset[i], jset[i]
        assert sorted(t) == sorted(j) and set(keys) <= set(t)
        for k in keys:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{k} {i}")


def test_sintel_occlusion_matches_jax(rng, tmp_path):
    hw = (12, 20)
    frames = [rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
              for _ in range(3)]
    occ = [np.where(rng.uniform(size=hw) < 0.4, 255, 0).astype(np.uint8)
           for _ in range(2)]
    flows = [rng.randn(*hw, 2).astype(np.float32) for _ in range(2)]
    cs.write_sintel_tree(tmp_path, frames, flows, occ)
    kw = dict(split="training", dstype="final", root=str(tmp_path / "Sintel"),
              occlusion=True)
    _same_items(tds.MpiSintel(**kw), jds.MpiSintel(**kw),
                ("image1", "image2", "flow", "valid", "occ"))


@pytest.mark.parametrize("split", ["validation", "test"])
def test_viper_matches_jax(rng, tmp_path, split):
    hw = (24, 40)
    pairs = [tuple(_pil_jpeg(_scene(rng, *hw), quality=80) for _ in (0, 1))
             for _ in range(2)]
    flows = [rng.uniform(-9, 9, (*hw, 2)).astype(np.float32)
             for _ in range(2)]
    cs.write_viper_tree(tmp_path, pairs,
                        flows if split == "validation" else None,
                        split="val" if split == "validation" else "test")
    kw = dict(split=split, root=str(tmp_path / "viper"))
    keys = ("image1", "image2") + (("flow", "valid") if split ==
                                   "validation" else ())
    _same_items(tds.VIPER(**kw), jds.VIPER(**kw), keys)


def test_slowflow_matches_jax(rng, tmp_path):
    hw = (12, 20)
    pairs = [tuple(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
                   for _ in (0, 1)) for _ in range(2)]
    flows = [rng.randn(*hw, 2).astype(np.float32) for _ in range(2)]
    cs.write_slowflow_tree(tmp_path, pairs, flows)
    kw = dict(root=str(tmp_path / "slowflow"))
    _same_items(tds.SlowFlow(**kw), jds.SlowFlow(**kw),
                ("image1", "image2", "flow", "valid"))
