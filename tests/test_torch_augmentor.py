"""The port's augmentation (``craft_tpu_torch.data.augmentor``, numpy only)
against the JAX package's (PIL's ImageEnhance and cv2.resize) on the CPU.

Every case runs both sides from the same inputs and the same seeds of the
global ``np.random`` and ``random`` streams, at chairs frames (384x512)
and KITTI-like frames (375x1242), 20 seeds each.  uint8 images must be
bit-identical, flows within 1e-4 px, sparse valid masks equal, and the
two streams' states after the call equal (the same draws in the same
order).  The photometric pieces are also held against PIL one by one at
fixed factors below and above 1, and PIL's HSV conversions over every
colour.
"""

import random

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from craft_tpu.data import augmentor as jaug
from craft_tpu_torch.data import augmentor as taug

SEEDS = range(20)
SIZES = {"chairs": (384, 512), "kitti": (375, 1242)}
FLOW_TOL = 1e-4  # px


def _frames(seed, hw):
    """Two uint8 frames (a ramp plus noise, so that luma means and hues
    vary over the frame) and a dense flow."""
    rng = np.random.RandomState(1000 + seed)
    H, W = hw
    ramp = np.linspace(0, 180, W)[None, :, None] * rng.uniform(0.2, 1, 3)
    imgs = [np.clip(ramp + rng.uniform(0, 75, (H, W, 3)), 0, 255)
            .astype(np.uint8) for _ in range(2)]
    flow = (rng.randn(H, W, 2) * 8).astype(np.float32)
    return imgs[0], imgs[1], flow


def _run(fn, seed, *args):
    """fn(*args) after seeding both streams: (result, the streams'
    states after the call)."""
    np.random.seed(seed)
    random.seed(seed)
    out = fn(*args)
    return out, (np.random.get_state(), random.getstate())


def _same_states(a, b):
    (np_a, py_a), (np_b, py_b) = a, b
    assert py_a == py_b
    assert np_a[0] == np_b[0] and np_a[2:] == np_b[2:]
    np.testing.assert_array_equal(np_a[1], np_b[1])


# ------------------------------------------------------------ photometric

FACTORS = [0.0, 0.3, 0.6, 0.999, 1.0, 1.001, 1.4, 2.5]


@pytest.mark.parametrize("op", ["Brightness", "Contrast", "Color"])
def test_enhance_ops_match_pil(op):
    img, _, _ = _frames(0, (96, 128))
    port = {"Brightness": taug.adjust_brightness,
            "Contrast": taug.adjust_contrast,
            "Color": taug.adjust_saturation}[op]
    for f in FACTORS:
        want = np.array(getattr(ImageEnhance, op)(Image.fromarray(img))
                        .enhance(f))
        np.testing.assert_array_equal(port(img, f), want, err_msg=str(f))


def test_luma_and_hue_shift_match_pil():
    img, _, _ = _frames(1, (96, 128))
    np.testing.assert_array_equal(taug._luma(img),
                                  np.array(Image.fromarray(img).convert("L")))
    pil = Image.fromarray(img)
    for f in (-0.159, -0.05, 1e-9, 0.02, 0.159):
        np.testing.assert_array_equal(
            taug.adjust_hue(img, f),
            np.array(jaug.ColorJitter._adjust_hue(pil, f)), err_msg=str(f))


@pytest.mark.parametrize("chunk", range(4))
def test_hsv_conversions_match_pil_for_every_colour(chunk):
    """RGB -> HSV over every RGB triple and HSV -> RGB over every HSV
    triple, a quarter of the 2^24 per case."""
    codes = np.arange(chunk << 22, (chunk + 1) << 22, dtype=np.uint32)
    img = np.stack([(codes >> 16) & 255, (codes >> 8) & 255, codes & 255],
                   -1).astype(np.uint8).reshape(2048, 2048, 3)
    np.testing.assert_array_equal(
        taug.rgb_to_hsv(img), np.array(Image.fromarray(img).convert("HSV")))
    np.testing.assert_array_equal(
        taug.hsv_to_rgb(img),
        np.array(Image.fromarray(img, "HSV").convert("RGB")))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("params", [(0.4, 0.4, 0.4, 0.5 / 3.14),
                                    (0.3, 0.3, 0.3, 0.3 / 3.14)],
                         ids=["dense", "sparse"])
def test_color_jitter_matches_jax(size, params):
    img, _, _ = _frames(2, SIZES[size])
    jj, tj = jaug.ColorJitter(*params), taug.ColorJitter(*params)
    for seed in SEEDS:
        want, ws = _run(lambda: np.array(jj(Image.fromarray(img))), seed)
        got, gs = _run(lambda: tj(img), seed)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        _same_states(gs, ws)


# ------------------------------------------------------------ resize

@pytest.mark.parametrize("size", SIZES)
def test_resize_matches_cv2(size):
    """Scales 2^U(-0.5, 1.2) per axis, below and above 1, as the
    augmentors draw them (chairs reaches 2x and a stretch); the whole
    output and a window of it."""
    img, _, flow = _frames(3, SIZES[size])
    rng = np.random.RandomState(7)
    # The last case rounds to the frame's own size, which OpenCV copies.
    scales = [2.0 ** rng.uniform(-0.5, 1.2, 2) for _ in SEEDS[1:]]
    for seed, (fx, fy) in enumerate(scales + [(1.0004, 1.0012)]):
        want = jaug._resize(img, fx, fy)
        got = taug.resize_linear(img, fx, fy)
        assert got.shape == want.shape, (seed, fx, fy)
        np.testing.assert_array_equal(got, want, err_msg=f"{fx} {fy}")
        # A window of the output, computed alone (the augmentors' crop).
        r0, c0 = rng.randint(0, want.shape[0] // 2), rng.randint(
            0, want.shape[1] // 2)
        win = (slice(r0, r0 + want.shape[0] // 2),
               slice(c0, c0 + want.shape[1] // 2))
        np.testing.assert_array_equal(
            taug.resize_linear(img, fx, fy, *win), want[win])
        wflow = jaug._resize(flow, fx, fy)
        gflow = taug.resize_linear(flow, fx, fy)
        assert gflow.dtype == wflow.dtype == np.float32
        np.testing.assert_allclose(gflow, wflow, rtol=0, atol=FLOW_TOL)


# ------------------------------------------------------------ augmentors

@pytest.mark.parametrize("seed", SEEDS)
def test_random_shift_matches_jax(seed):
    img1, img2, flow = _frames(seed, (96, 128))
    want, ws = _run(jaug.random_shift, seed, img1, img2, flow, (16, 10))
    got, gs = _run(taug.random_shift, seed, img1, img2, flow, (16, 10))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _same_states(gs, ws)


def _check_outputs(got, want, seed):
    img1, img2, flow, valid = got
    w1, w2, wflow, wvalid = want
    np.testing.assert_array_equal(img1, w1, err_msg=f"seed {seed}")
    np.testing.assert_array_equal(img2, w2, err_msg=f"seed {seed}")
    np.testing.assert_allclose(flow, wflow, rtol=0, atol=FLOW_TOL)
    if wvalid is None:
        assert valid is None
    else:
        np.testing.assert_array_equal(valid, wvalid)


# Crops: the chairs stage's at chairs frames; things/sintel's (368x768)
# dense and KITTI's (288x960) sparse at KITTI frames.
DENSE_CROPS = {"chairs": (368, 496), "kitti": (368, 768)}
SPARSE_CROPS = {"chairs": (368, 496), "kitti": (288, 960)}


# shift_prob 0.5: over 20 seeds the shift augmentation runs on some and
# not on others.
@pytest.mark.parametrize("size", SIZES)
def test_flow_augmentor_matches_jax(size):
    kw = dict(crop_size=DENSE_CROPS[size], min_scale=-0.1, max_scale=1.0,
              do_flip=True, shift_prob=0.5)
    jx, tx = jaug.FlowAugmentor("t", **kw), taug.FlowAugmentor("t", **kw)
    for seed in SEEDS:
        img1, img2, flow = _frames(seed, SIZES[size])
        want, ws = _run(jx, seed, img1, img2, flow)
        got, gs = _run(tx, seed, img1, img2, flow)
        _check_outputs(got, want, seed)
        _same_states(gs, ws)


@pytest.mark.parametrize("size", SIZES)
def test_sparse_flow_augmentor_matches_jax(size):
    kw = dict(crop_size=SPARSE_CROPS[size], min_scale=-0.2, max_scale=0.4,
              do_flip=True, shift_prob=0.5)
    jx = jaug.SparseFlowAugmentor("t", **kw)
    tx = taug.SparseFlowAugmentor("t", **kw)
    for seed in SEEDS:
        img1, img2, flow = _frames(seed, SIZES[size])
        valid = (np.random.RandomState(seed).uniform(size=flow.shape[:2])
                 > 0.6).astype(np.float32)
        want, ws = _run(jx, seed, img1, img2, flow, valid)
        got, gs = _run(tx, seed, img1, img2, flow, valid)
        _check_outputs(got, want, seed)
        _same_states(gs, ws)
