"""Training-time augmentation (port of ``craft_tpu.data.augmentor``;
reference core/utils/augmentor.py:16-350), numpy only, on the host.

The JAX package runs its photometric jitter through PIL's ``ImageEnhance``
and its resizes through ``cv2.resize``.  The card's machine has neither, so
this module does their arithmetic itself, bit for bit on uint8 images:

  * ``Image.blend(a, b, f)``: a + f * (b - a) in float32 (f rounded to
    float32), truncated toward zero and clipped to [0, 255];
  * ``convert("L")``: (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16;
  * ``convert("HSV")`` and back: PIL's integer HSV with its own mix of
    float32 and float64 steps and C ``round`` (half away from zero);
  * ``cv2.resize(INTER_LINEAR)``: output size cvRound(n * f) (half to
    even), a copy where that is the input's size; source coordinate (d + 0.5) / f - 0.5 in float32, clamped at the
    left and right edges (the vertical weights keep the unclamped fraction
    over the edge row taken twice); uint8 weights in 11-bit fixed point and
    the vertical pass of OpenCV's vector path, ((h0 >> 4) * b0 >> 16) +
    ((h1 >> 4) * b1 >> 16) rounded by 2 bits; float32 images with float32
    weights, products and sums in OpenCV's order.

The random draws are the JAX package's, in the same order, from the same
global ``np.random`` and ``random`` streams.  For speed (a batch of 8 has
to keep pace with a training step), the blends run as tables over the
pixel values, the HSV round trip as gathers from tables of every colour,
and the spatial transform resizes only the window its crop keeps; each of
these gives the same bits as the arithmetic it replaces.
"""

from __future__ import annotations

import functools
import math
import random

import numpy as np

_F32 = np.float32


# ---------------------------------------------------------------------------
# PIL's ImageEnhance on uint8 RGB arrays
# ---------------------------------------------------------------------------

_LEVELS = np.arange(256)


def _blend(degenerate, img, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)``: degenerate (an array or a
    scalar) + factor * (img - degenerate) in float32, clipped and truncated
    to uint8."""
    base = np.asarray(degenerate, np.int16)
    diff = (np.asarray(img).astype(np.int16) - base).astype(_F32)
    out = base.astype(_F32) + _F32(factor) * diff
    return np.clip(out, 0, 255).astype(np.uint8)


def _luma(img: np.ndarray) -> np.ndarray:
    """``convert("L")`` of an RGB image: uint8 [H, W]."""
    flat = img.reshape(-1, 3)
    acc = flat[:, 0] * np.uint32(19595)
    acc += flat[:, 1] * np.uint32(38470)
    acc += flat[:, 2] * np.uint32(7471)
    acc += 0x8000
    acc >>= 16
    return acc.astype(np.uint8).reshape(img.shape[:2])


# Each blend below is a function of one pixel value (and, for the colour
# blend, its luma), so it runs as a table of _blend over every value.

def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(0, _LEVELS, factor)[img]


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend with the grey of the rounded mean luma (``ImageStat``'s mean:
    the integer sum over the pixel count, in double)."""
    luma = _luma(img)
    mean = int(int(luma.sum(dtype=np.int64)) / luma.size + 0.5)
    return _blend(mean, _LEVELS, factor)[img]


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend with the image's luma (``Color``'s degenerate image)."""
    table = _blend(_LEVELS[:, None], _LEVELS[None, :], factor).ravel()
    luma = _luma(img).astype(np.int32)
    return table[(luma[..., None] << 8) | img]


def _rgb_to_hsv_arith(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` (Convert.c ``rgb2hsv_row``) of [..., 3]
    uint8 pixels, step by step."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(_F32)
    s = cr / np.maximum(maxc, 1).astype(_F32)
    rc, gc, bc = ((maxc - c).astype(_F32) / cr for c in (r, g, b))
    # The green and blue branches add a double constant, so they run in
    # double; the red one stays in float32.
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, (2.0 + rc.astype(np.float64)) - bc,
                          (4.0 + gc.astype(np.float64)) - rc)).astype(_F32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(_F32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    uh[grey] = 0
    us[grey] = 0
    return np.stack([uh, us, maxc], -1).astype(np.uint8)


def _hsv_to_rgb_arith(img: np.ndarray) -> np.ndarray:
    """PIL's HSV -> RGB (Convert.c ``hsv2rgb``) of [..., 3] uint8 pixels,
    step by step: sector i = floor(h * 6 / 255), f its remainder and fs =
    s / 255 in float32, the products in double, C ``round`` (halves away
    from zero)."""
    h, s, v = (img[..., i] for i in range(3))
    h6 = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(h6)
    f = (h6 - i).astype(_F32)
    fs = (s.astype(np.float64) / 255.0).astype(_F32)
    v64 = v.astype(np.float64)

    def c_round(x):  # x >= 0
        fl = np.floor(x)
        return np.where(x - fl >= 0.5, fl + 1.0, fl)

    p = c_round(v64 * (1.0 - fs.astype(np.float64)))
    q = c_round(v64 * (1.0 - (fs * f).astype(np.float64)))
    t = c_round(v64 * (1.0 - fs.astype(np.float64)
                       * (1.0 - f.astype(np.float64))))
    p, q, t = (np.clip(x, 0, 255).astype(np.uint8) for x in (p, q, t))
    sector = i.astype(np.int64) % 6
    out = np.stack([np.choose(sector, [v, q, p, p, t, v]),
                    np.choose(sector, [t, v, v, q, p, p]),
                    np.choose(sector, [p, p, t, v, v, q])], -1)
    grey = s == 0
    out[grey] = v[grey][:, None]
    return out


def _codes(img: np.ndarray) -> np.ndarray:
    """Each pixel's 24-bit code c0 + 256 c1 + 65536 c2, uint32."""
    flat = img.reshape(-1, 3)
    quad = np.zeros((flat.shape[0], 4), np.uint8)
    quad[:, :3] = flat
    return quad.view("<u4").ravel()


def _pixels(codes: np.ndarray, shape) -> np.ndarray:
    """The [..., 3] uint8 pixels of 24-bit codes."""
    return codes.view(np.uint8).reshape(-1, 4)[:, :3].reshape(shape)


@functools.lru_cache(maxsize=None)
def _hsv_luts():
    """Both conversions of every colour as 24-bit codes, 2^24 uint32 each
    (64 MB), indexed by ``_codes``: a gather is several times faster than
    the arithmetic.  Built once a process (a few seconds); a ColorJitter
    with a hue shift builds them, so a loader's worker processes forked
    after it share them."""
    to_hsv = np.empty(1 << 24, np.uint32)
    to_rgb = np.empty(1 << 24, np.uint32)
    step = 1 << 20
    for c0 in range(0, 1 << 24, step):
        codes = np.arange(c0, c0 + step, dtype=np.uint32)
        px = _pixels(codes, (step, 3))
        to_hsv[c0:c0 + step] = _codes(_rgb_to_hsv_arith(px))
        to_rgb[c0:c0 + step] = _codes(_hsv_to_rgb_arith(px))
    return to_hsv, to_rgb


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` of a uint8 RGB image."""
    return _pixels(np.take(_hsv_luts()[0], _codes(img)), img.shape)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's HSV -> RGB of a uint8 HSV image."""
    return _pixels(np.take(_hsv_luts()[1], _codes(img)), img.shape)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """The hue moved by int(factor * 255) modulo 256, in HSV."""
    if abs(factor) < 1e-8:
        return img
    to_hsv, to_rgb = _hsv_luts()
    hsv = np.take(to_hsv, _codes(img))
    hsv.view(np.uint8)[0::4] += np.uint8(int(factor * 255) % 256)
    return _pixels(np.take(to_rgb, hsv), img.shape)


class ColorJitter:
    """brightness/contrast/saturation factors U(max(0, 1 - v), 1 + v), a hue
    shift U(-h, h), applied in a random order (torchvision's semantics, as
    the JAX package's ColorJitter), on uint8 [H, W, 3] arrays."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        if hue > 0:
            _hsv_luts()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        ops = []
        for amount, fn in ((self.brightness, adjust_brightness),
                           (self.contrast, adjust_contrast),
                           (self.saturation, adjust_saturation)):
            if amount > 0:
                f = random.uniform(max(0, 1 - amount), 1 + amount)
                ops.append(lambda im, f=f, fn=fn: fn(im, f))
        if self.hue > 0:
            f = random.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


# ---------------------------------------------------------------------------
# cv2.resize(INTER_LINEAR)
# ---------------------------------------------------------------------------

def _axis(n_in: int, out: slice, scale: float, clamp: bool):
    """Source indices (i0, i1) and weights (w0, w1), float32, of the output
    coordinates `out` of one axis.  clamp: OpenCV's horizontal rule (a
    source coordinate off either edge takes the edge pixel with weight 1);
    else the vertical one (the fraction is kept and the row index is
    clipped)."""
    d = np.arange(out.start, out.stop, dtype=np.float64)
    f = ((d + 0.5) * (1.0 / scale) - 0.5).astype(_F32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(_F32)).astype(_F32)
    if clamp:
        off = (i0 < 0) | (i0 >= n_in - 1)
        f[off] = 0
        i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return np.clip(i0, 0, n_in - 1), i1, (_F32(1) - f).astype(_F32), f


def resize_size(shape, fx: float, fy: float):
    """(rows, cols) of ``cv2.resize`` by (fx, fy): cvRound, half to even."""
    return int(np.rint(shape[0] * fy)), int(np.rint(shape[1] * fx))


def resize_linear(img: np.ndarray, fx: float = 0.0, fy: float = 0.0,
                  rows=None, cols=None, dsize=None) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    of a uint8 or float32 [H, W, C] image, or only its window [rows,
    cols] (slices of the output; each output pixel depends only on its
    own coordinates, so the window is computed alone).  With dsize = (W',
    H'), ``cv2.resize(img, dsize, ...)``: OpenCV then takes the scales as
    W' / W and H' / H."""
    H, W = img.shape[:2]
    if dsize is not None:
        ow, oh = dsize
        fx, fy = ow / W, oh / H
    else:
        oh, ow = resize_size(img.shape, fx, fy)
    rows = rows or slice(0, oh)
    cols = cols or slice(0, ow)
    if (oh, ow) == (H, W):  # OpenCV copies the image at its own size
        return img[rows, cols].copy()
    x0, x1, a0, a1 = _axis(W, cols, fx, clamp=True)
    y0, y1, b0, b1 = _axis(H, rows, fy, clamp=False)
    # Only the source rows the window reads.
    top = int(y0.min())
    img, y0, y1 = img[top:int(y1.max()) + 1], y0 - top, y1 - top
    if img.dtype == np.uint8:
        fix = lambda w: np.rint(w * _F32(2048)).astype(np.int32)  # noqa: E731
        a0, a1, b0, b1 = fix(a0), fix(a1), fix(b0), fix(b1)
        src = img.astype(np.int32)
        part = np.take(src, x1, axis=1)
        part *= a1[:, None]
        src = np.take(src, x0, axis=1)
        src *= a0[:, None]
        src += part
        src >>= 4
        out = np.take(src, y0, axis=0)
        out *= b0[:, None, None]
        out >>= 16
        part = np.take(src, y1, axis=0)
        part *= b1[:, None, None]
        part >>= 16
        out += part
        out += 2
        out >>= 2  # at most 255: the weights of a pass sum to 2048
        return out.astype(np.uint8)
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear takes uint8 or float32, not "
                        f"{img.dtype}")
    src = np.take(img, x0, axis=1) * a0[:, None]
    src += np.take(img, x1, axis=1) * a1[:, None]
    out = np.take(src, y0, axis=0) * b0[:, None, None]
    out += np.take(src, y1, axis=0) * b1[:, None, None]
    return out


# ---------------------------------------------------------------------------
# cv2.GaussianBlur on uint8 images
# ---------------------------------------------------------------------------

def gaussian_kernel_q8(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's fixed-point Gaussian kernel for uint8 images (odd `ksize`,
    sigma > 0): the taps of getGaussianKernelBitExact in double precision,
    rounded to 8 fractional bits half to even with each tap's rounding
    error carried into the next, symmetric, the centre 256 minus the
    rest (getGaussianKernelFixedPoint_ED).  int64 [ksize], summing to
    256."""
    half = ksize // 2
    var = sigma * sigma
    # A sigma whose square underflows divides by zero in C: -inf.
    scale = -0.125 / var if var > 0.0 else -math.inf
    taps = [math.exp(float(x * x) * scale)
            for x in range(1 - ksize, 0, 2)]  # x = 2 * (i - half)
    total = 0.0
    for t in taps:  # in order, as OpenCV (sum() compensates since 3.12)
        total += t
    total = total * 2.0 + 1.0
    inv = 1.0 / total
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i, t in enumerate(taps):
        adj = t * inv * 256.0 + err
        v = round(adj)  # half to even, as cvRound
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
    out[half] = 256 - 2 * int(out[:half].sum())
    return out


def _reflect_101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT_101 (borderInterpolate), reflected again
    until inside, for extents shorter than the kernel."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx < n, idx, period - idx)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a uint8 [H, W]
    or [H, W, C] image, bit for bit: rows, then columns, each a sum of
    taps of ``gaussian_kernel_q8`` (8 fractional bits, then 16), rounded
    once at the end."""
    k = gaussian_kernel_q8(ksize, sigma)
    offsets = np.arange(ksize) - ksize // 2
    H, W = img.shape[:2]
    x = img.astype(np.int32)
    cols = _reflect_101(np.arange(W)[:, None] + offsets, W)
    rows = _reflect_101(np.arange(H)[:, None] + offsets, H)
    h = sum(x[:, cols[:, j]] * int(k[j]) for j in range(ksize))
    v = sum(h[rows[:, j]] * int(k[j]) for j in range(ksize))
    return ((v + (1 << 15)) >> 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# Augmentors
# ---------------------------------------------------------------------------

def _complementary_spans(extent, delta):
    """Index spans that crop `delta` pixels complementarily from a pair of
    images along one axis, so that frame 2's content sits shifted by
    exactly `delta` relative to frame 1's."""
    lead, trail = max(0, -delta), max(0, delta)
    return slice(lead, extent - trail), slice(trail, extent - lead)


def random_shift(img1, img2, flow, shift_sigmas=(16, 10)):
    """CRAFT's shift-consistency augmentation (reference augmentor.py:16-78):
    Laplace-sampled even (dx, dy) with one axis damped x1/4; img1 and img2
    cropped complementarily; flow -= (dx, dy); padded back with a validity
    mask."""
    u_sigma, v_sigma = shift_sigmas
    if random.random() > 0.5:
        dx = np.random.laplace(0, u_sigma / 4)
        dy = np.random.laplace(0, v_sigma)
    else:
        dx = np.random.laplace(0, u_sigma)
        dy = np.random.laplace(0, v_sigma / 4)
    dx = (int(dx) // 2) * 2
    dy = (int(dy) // 2) * 2

    H, W = img1.shape[:2]
    rows1, rows2 = _complementary_spans(H, dy)
    cols1, cols2 = _complementary_spans(W, dx)
    img1a = img1[rows1, cols1]
    flowa = flow[rows1, cols1] - np.array([dx, dy], flow.dtype)
    img2a = img2[rows2, cols2]

    pad_x, pad_y = abs(dx) // 2, abs(dy) // 2
    pad = ((pad_y, pad_y), (pad_x, pad_x), (0, 0))
    valid = np.pad(np.ones(img1a.shape[:2], dtype=bool), pad[:2],
                   "constant", constant_values=False)
    img1a, img2a, flowa = (np.pad(x, pad, "constant")
                           for x in (img1a, img2a, flowa))
    return img1a, img2a, flowa, valid


def _eraser(img2, prob, bounds=(50, 100)):
    """Occlusion by 1-2 rectangles of img2's mean colour (reference
    augmentor.py:120-134)."""
    ht, wd = img2.shape[:2]
    if np.random.rand() < prob:
        mean_color = np.mean(img2.reshape(-1, 3), axis=0)
        img2 = img2.copy()
        for _ in range(np.random.randint(1, 3)):
            x0 = np.random.randint(0, wd)
            y0 = np.random.randint(0, ht)
            dx = np.random.randint(bounds[0], bounds[1])
            dy = np.random.randint(bounds[0], bounds[1])
            img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
    return img2


def _window(oh, ow, y0, x0, ch, cw, vflip, hflip):
    """The crop [y0, y0 + ch) x [x0, x0 + cw) of an oh x ow image flipped
    as asked, as rows and columns of the unflipped image."""
    r0 = oh - y0 - ch if vflip else y0
    c0 = ow - x0 - cw if hflip else x0
    return slice(r0, r0 + ch), slice(c0, c0 + cw)


class FlowAugmentor:
    """Dense-GT pipeline (reference augmentor.py:80-204)."""

    def __init__(self, ds_name, crop_size, min_scale=-0.2, max_scale=0.5,
                 spatial_aug_prob=0.8, blur_kernel=5, blur_sigma=-1,
                 do_flip=True, shift_prob=0.0, shift_sigmas=(16, 10)):
        self.ds_name = ds_name
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.shift_prob = shift_prob
        self.shift_sigmas = shift_sigmas
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.blur_kernel = blur_kernel
        self.blur_sigma = blur_sigma

    def color_transform(self, img1, img2):
        if np.random.rand() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1), self.photo_aug(img2)
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0))
        return tuple(np.split(stack, 2, axis=0))

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        return img1, _eraser(img2, self.eraser_aug_prob, bounds)

    def spatial_transform(self, img1, img2, flow):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 8) / float(ht),
                               (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** np.random.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if np.random.rand() < self.stretch_prob:
            scale_x *= 2 ** np.random.uniform(-self.max_stretch,
                                              self.max_stretch)
            scale_y *= 2 ** np.random.uniform(-self.max_stretch,
                                              self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        # The draws of the JAX package's order (resize?, flips, crop); the
        # resize computes only the window the crop keeps.
        resize = np.random.rand() < self.spatial_aug_prob
        oh, ow = resize_size(img1.shape, scale_x, scale_y) if resize \
            else img1.shape[:2]
        hflip = self.do_flip and np.random.rand() < self.h_flip_prob
        vflip = self.do_flip and np.random.rand() < self.v_flip_prob
        ch, cw = self.crop_size
        y0 = np.random.randint(0, oh - ch)
        x0 = np.random.randint(0, ow - cw)
        rows, cols = _window(oh, ow, y0, x0, ch, cw, vflip, hflip)
        if resize:
            img1, img2, flow = (resize_linear(x, scale_x, scale_y, rows, cols)
                                for x in (img1, img2, flow))
            flow = flow * [scale_x, scale_y]
        else:
            img1, img2, flow = img1[rows, cols], img2[rows, cols], \
                flow[rows, cols]
        if hflip:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if vflip:
            img1, img2 = img1[::-1, :], img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]
        return img1, img2, flow

    def __call__(self, img1, img2, flow):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        valid = None
        if self.shift_prob > 0 and random.random() < self.shift_prob:
            img1, img2, flow, valid = random_shift(img1, img2, flow,
                                                   self.shift_sigmas)
        if self.blur_sigma > 0:
            img1, img2 = (gaussian_blur(x, self.blur_kernel, self.blur_sigma)
                          for x in (img1, img2))
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), valid)


class SparseFlowAugmentor:
    """Sparse-GT (KITTI, HD1K) pipeline (reference augmentor.py:207-350):
    flow maps are scattered to the nearest integer cells, not
    interpolated."""

    def __init__(self, ds_name, crop_size, min_scale=-0.2, max_scale=0.5,
                 spatial_aug_prob=0.8, do_flip=False, shift_prob=0.0,
                 shift_sigmas=(16, 10)):
        self.ds_name = ds_name
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.do_flip = do_flip
        self.shift_prob = shift_prob
        self.shift_sigmas = shift_sigmas
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2):
        stack = self.photo_aug(np.concatenate([img1, img2], axis=0))
        return tuple(np.split(stack, 2, axis=0))

    def eraser_transform(self, img1, img2):
        return img1, _eraser(img2, self.eraser_aug_prob)

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        xs, ys = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
        flow_f = flow.reshape(-1, 2).astype(np.float32)
        valid_f = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid_f >= 1]
        flow0 = flow_f[valid_f >= 1]
        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy[v], xx[v]] = flow1[v]
        valid_img[yy[v], xx[v]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 1) / float(ht),
                               (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** np.random.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        resize = np.random.rand() < self.spatial_aug_prob
        oh, ow = resize_size(img1.shape, scale_x, scale_y) if resize \
            else img1.shape[:2]
        if resize:
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      fx=scale_x, fy=scale_y)
        hflip = self.do_flip and np.random.rand() < 0.5

        margin_y, margin_x = 20, 50
        ch, cw = self.crop_size
        y0 = np.random.randint(0, oh - ch + margin_y)
        x0 = np.random.randint(-margin_x, ow - cw + margin_x)
        y0 = int(np.clip(y0, 0, oh - ch))
        x0 = int(np.clip(x0, 0, ow - cw))
        rows, cols = _window(oh, ow, y0, x0, ch, cw, False, hflip)
        if resize:
            img1, img2 = (resize_linear(x, scale_x, scale_y, rows, cols)
                          for x in (img1, img2))
        else:
            img1, img2 = img1[rows, cols], img2[rows, cols]
        flow, valid = flow[rows, cols], valid[rows, cols]
        if hflip:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid)
        if self.shift_prob > 0 and random.random() < self.shift_prob:
            img1, img2, flow, valid2 = random_shift(img1, img2, flow,
                                                    self.shift_sigmas)
            valid = valid * valid2
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
