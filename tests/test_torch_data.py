"""The port's data side on the CPU: its PNG/PPM codec against PIL (and
OpenCV for 16-bit RGB, which PIL reads as 8-bit), its flow files against
``craft_tpu.data.frame_utils``, and its datasets' items and file lists
against the JAX classes on synthetic trees."""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from craft_tpu.data import datasets as jds
from craft_tpu.data import frame_utils as jfu
from craft_tpu_torch.data import datasets as tds
from craft_tpu_torch.data import frame_utils as tfu
from craft_tpu_torch.data import imgio


def _smooth(rng, shape, dtype=np.uint8, top=255):
    """A ramp plus noise, so that PNG writers pick varied row filters."""
    ramp = np.linspace(0, 0.8 * top, shape[1])[None, :]
    if len(shape) == 3:
        ramp = ramp[..., None]
    return (ramp + rng.rand(*shape) * 0.2 * top).astype(dtype)


def _pil_png(img) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="PNG")
    return b.getvalue()


@pytest.mark.parametrize("shape", [(37, 53, 3), (21, 33), (15, 27, 4)],
                         ids=["rgb", "gray", "rgba"])
def test_png_8bit_against_pil(rng, shape):
    img = _smooth(rng, shape)
    np.testing.assert_array_equal(imgio.decode_png(_pil_png(img)), img)
    back = np.array(Image.open(io.BytesIO(imgio.encode_png(img))))
    np.testing.assert_array_equal(back, img)


def _png_every_filter(img: np.ndarray) -> bytes:
    """img as PNG with row y filtered by type y % 5 (None, Sub, Up,
    Average, Paeth), the filters computed here from the PNG standard."""
    h, w, ch = img.shape
    px = img.astype(np.int32)
    rows = []
    for y in range(h):
        a = np.zeros_like(px[y])
        a[1:] = px[y, :-1]
        b = px[y - 1] if y else np.zeros_like(px[y])
        c = np.zeros_like(px[y])
        if y:
            c[1:] = px[y - 1, :-1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][y % 5]
        rows.append(bytes([y % 5]) + ((px[y] - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_every_row_filter(rng):
    img = _smooth(rng, (23, 19, 3))
    data = _png_every_filter(img)
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(imgio.decode_png(data), img)


def test_png_16bit(rng, tmp_path):
    gray = _smooth(rng, (20, 31), np.uint16, 65535)
    np.testing.assert_array_equal(imgio.decode_png(_pil_png(gray)), gray)
    rgb = _smooth(rng, (19, 29, 3), np.uint16, 65535)
    p = str(tmp_path / "rgb16.png")
    assert cv2.imwrite(p, rgb[..., ::-1])
    got = imgio.load(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, rgb)
    imgio.write_png(p, rgb)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(back, rgb)


@pytest.mark.parametrize("shape", [(14, 23, 3), (9, 17)], ids=["ppm", "pgm"])
def test_pnm_against_pil(rng, tmp_path, shape):
    img = rng.randint(0, 255, shape).astype(np.uint8)
    p = str(tmp_path / ("x.ppm" if len(shape) == 3 else "x.pgm"))
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(imgio.load(p), img)
    imgio.write_ppm(p, img)
    np.testing.assert_array_equal(np.array(Image.open(p)), img)


def test_flo_round_trips(rng, tmp_path):
    flow = rng.randn(11, 13, 2).astype(np.float32) * 5
    a, b = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    tfu.write_flo(a, flow)
    jfu.write_flo(b, flow)
    for p in (a, b):
        np.testing.assert_array_equal(jfu.read_flo(p), flow)
        np.testing.assert_array_equal(tfu.read_flo(p), flow)
        np.testing.assert_array_equal(tfu.read_gen(p), jfu.read_gen(p))


@pytest.mark.parametrize("color,scale", [(True, -1.0), (False, 1.0)])
def test_pfm_against_jax(rng, tmp_path, color, scale):
    shape = (7, 9, 3) if color else (7, 9)
    data = rng.randn(*shape).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    with open(p, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"9 7\n%g\n" % scale)
        np.flipud(data).astype("<f" if scale < 0 else ">f").tofile(f)
    np.testing.assert_array_equal(tfu.read_pfm(p), data)
    np.testing.assert_array_equal(tfu.read_gen(p), jfu.read_gen(p))


def test_kitti_flow_round_trips(rng, tmp_path):
    flow = rng.uniform(-100, 100, (12, 17, 2)).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tfu.write_flow_kitti(a, flow)
    jfu.write_flow_kitti(b, flow)
    for p in (a, b):
        tf, tv = tfu.read_flow_kitti(p)
        jf, jv = jfu.read_flow_kitti(p)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
        # The 16-bit codec keeps 1/64 px.
        np.testing.assert_allclose(tf, flow, atol=1 / 64)


# ------------------------------------------------------------ datasets


def write_sintel(root, rng, scenes=("alley_1", "ambush_2"), frames=3, H=16,
                 W=24):
    for scene in scenes:
        for sub in ("clean", "final", "flow"):
            os.makedirs(os.path.join(root, "training", sub, scene))
        for i in range(frames):
            for sub in ("clean", "final"):
                imgio.write_png(os.path.join(
                    root, "training", sub, scene, f"frame_{i + 1:04d}.png"),
                    rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
            if i < frames - 1:
                tfu.write_flo(os.path.join(
                    root, "training", "flow", scene,
                    f"frame_{i + 1:04d}.flo"),
                    rng.uniform(-4, 4, (H, W, 2)).astype(np.float32))


def write_kitti(root, rng, n=2, H=15, W=29):
    for sub in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(root, "training", sub))
    for i in range(n):
        for suf in ("10", "11"):
            imgio.write_png(os.path.join(root, "training", "image_2",
                                         f"{i:06d}_{suf}.png"),
                            rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
        flow = rng.uniform(-10, 10, (H, W, 2)).astype(np.float32)
        tfu.write_flow_kitti(os.path.join(root, "training", "flow_occ",
                                          f"{i:06d}_10.png"), flow)


def write_chairs(root, rng, n=4, H=16, W=24):
    data = os.path.join(root, "data")
    os.makedirs(data)
    for i in range(n):
        for k in (1, 2):
            imgio.write_ppm(os.path.join(data, f"{i + 1:05d}_img{k}.ppm"),
                            rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
        tfu.write_flo(os.path.join(data, f"{i + 1:05d}_flow.flo"),
                      rng.uniform(-4, 4, (H, W, 2)).astype(np.float32))
    # Pairs 1 and 3 train, 2 and 4 validate.
    np.savetxt(os.path.join(root, "FlyingChairs_train_val.txt"),
               np.array([1, 2] * (n // 2)), fmt="%d")


def _same_items(tset, jset):
    assert tset.image_list == jset.image_list
    assert tset.flow_list == jset.flow_list
    assert tset.extra_info == jset.extra_info
    assert len(tset) == len(jset) > 0
    for i in range(len(jset)):
        t, j = tset[i], jset[i]
        assert sorted(t) == sorted(j)
        for key in t:
            if isinstance(j[key], np.ndarray):
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
            else:
                assert t[key] == j[key], key


@pytest.mark.parametrize("dstype", ["clean", "final"])
def test_sintel_matches_jax(rng, tmp_path, dstype):
    root = str(tmp_path / "Sintel")
    write_sintel(root, rng)
    _same_items(tds.MpiSintel(split="training", root=root, dstype=dstype),
                jds.MpiSintel(split="training", root=root, dstype=dstype))


def test_kitti_matches_jax(rng, tmp_path):
    root = str(tmp_path / "KITTI")
    write_kitti(root, rng)
    _same_items(tds.KITTI(split="training", root=root),
                jds.KITTI(split="training", root=root))


@pytest.mark.parametrize("split", ["training", "validation"])
def test_chairs_matches_jax(rng, tmp_path, split):
    root = str(tmp_path / "FlyingChairs_release")
    write_chairs(root, rng)
    kw = dict(split=split, root=os.path.join(root, "data"),
              split_file=os.path.join(root, "FlyingChairs_train_val.txt"))
    tset = tds.FlyingChairs(**kw)
    assert len(tset) == 2
    _same_items(tset, jds.FlyingChairs(**kw))
