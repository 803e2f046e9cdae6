"""The port's Gaussian blur (``craft_tpu_torch.data.augmentor.gaussian_blur``,
numpy only) against ``cv2.GaussianBlur`` on uint8 frames, bit for bit:
hypothesis draws frame sizes from 1x1 up (many narrower or shorter than
the kernel), one or three channels, K in {3, 5, 7} and sigma in (0, 5].
Then the whole ``FlowAugmentor(blur_sigma > 0)`` against the JAX package's
(which blurs through cv2) from the same seeds: uint8 frames bit-identical,
flows within 1e-4 px, the random streams in the same state after the call.
"""

import random

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from craft_tpu.data import augmentor as jaug
from craft_tpu_torch.data import augmentor as taug

FLOW_TOL = 1e-4  # px


@pytest.mark.parametrize("ksize", [3, 5, 7])
@settings(max_examples=200, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       channels=st.sampled_from([0, 3]),
       sigma=st.floats(0.0, 5.0, exclude_min=True),
       seed=st.integers(0, 2 ** 31 - 1))
def test_gaussian_blur_matches_cv2(ksize, h, w, channels, sigma, seed):
    shape = (h, w, channels) if channels else (h, w)
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    want = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    got = taug.gaussian_blur(img, ksize, sigma)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.7, 3.0])
def test_gaussian_blur_matches_cv2_on_a_chairs_crop(sigma):
    """A whole 368x496 crop (wide enough for OpenCV's vector paths) of a
    ramp plus noise, with K 5, the augmentor's default."""
    rng = np.random.RandomState(3)
    ramp = np.linspace(0, 200, 496)[None, :, None] * rng.uniform(0.3, 1, 3)
    img = np.clip(ramp + rng.uniform(0, 55, (368, 496, 3)), 0,
                  255).astype(np.uint8)
    np.testing.assert_array_equal(taug.gaussian_blur(img, 5, sigma),
                                  cv2.GaussianBlur(img, (5, 5), sigma))


def _run(fn, seed, *args):
    np.random.seed(seed)
    random.seed(seed)
    out = fn(*args)
    return out, (np.random.get_state(), random.getstate())


@pytest.mark.parametrize("blur", [(5, 1.0), (3, 2.5)])
def test_flow_augmentor_with_blur_matches_jax(blur):
    ksize, sigma = blur
    kw = dict(crop_size=(160, 224), min_scale=-0.1, max_scale=0.6,
              do_flip=True, shift_prob=0.5, blur_kernel=ksize,
              blur_sigma=sigma)
    jx, tx = jaug.FlowAugmentor("t", **kw), taug.FlowAugmentor("t", **kw)
    for seed in range(8):
        rng = np.random.RandomState(1000 + seed)
        ramp = np.linspace(0, 180, 320)[None, :, None] * rng.uniform(
            0.2, 1, 3)
        img1, img2 = (np.clip(ramp + rng.uniform(0, 75, (240, 320, 3)), 0,
                              255).astype(np.uint8) for _ in range(2))
        flow = (rng.randn(240, 320, 2) * 8).astype(np.float32)
        want, ws = _run(jx, seed, img1, img2, flow)
        got, gs = _run(tx, seed, img1, img2, flow)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w, err_msg=f"seed {seed}")
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
        if want[3] is None:
            assert got[3] is None
        else:
            np.testing.assert_array_equal(got[3], want[3])
        assert gs[1] == ws[1]
        np.testing.assert_array_equal(gs[0][1], ws[0][1])
        # The blur changed the frames: the augmentor without it differs.
        plain, _ = _run(taug.FlowAugmentor(
            "t", **dict(kw, blur_sigma=-1)), seed, img1, img2, flow)
        assert not np.array_equal(plain[0], got[0])
