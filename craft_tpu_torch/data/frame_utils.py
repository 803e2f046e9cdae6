"""Flow and image file IO (port of ``craft_tpu.data.frame_utils``; reference
core/utils/frame_utils.py:12-137): Middlebury .flo, PFM, the KITTI 16-bit
PNG flow codec and the extension-dispatched reader.  Images go through the
port's own codec (``data/imgio.py``), so nothing here needs PIL or OpenCV.
"""

from __future__ import annotations

import re
from os.path import splitext

import numpy as np

from craft_tpu_torch.data import imgio

FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo: magic f32, w i32, h i32, then h*w*2 f32 (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array(w, np.int32).tofile(f)
        np.array(h, np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """PFM (bottom-up rows; the sign of the scale gives the endianness)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dim = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim:
            raise ValueError("malformed PFM header")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape))


def read_flow_kitti(path: str):
    """KITTI 16-bit RGB PNG: (u, v) stored as uv * 64 + 2^15, valid in the
    third channel.  Returns (flow [H, W, 2], valid [H, W]) fp32."""
    raw = imgio.load(path).astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2 ** 15) / 64.0, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    uv = 64.0 * flow + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    imgio.write_png(path, np.concatenate([uv, valid], -1).astype(np.uint16))


def read_disp_kitti(path: str):
    """A KITTI 16-bit disparity PNG as a horizontal flow: (flow [H, W, 2]
    = (-disp, 0), valid [H, W] = disp > 0), disp = value / 256."""
    disp = imgio.load(path) / 256.0
    valid = disp > 0.0
    return np.stack([-disp, np.zeros_like(disp)], -1), valid


def read_gen(file_name: str):
    """Read by extension: images (.png, .ppm, .pgm, .jpg, .jpeg) as numpy
    arrays, .flo and .pfm flow as fp32 [H, W, 2], .bin/.raw with np.load;
    [] for any other extension, as the reference."""
    ext = splitext(file_name)[-1]
    if ext in (".png", ".ppm", ".pgm", ".jpg", ".jpeg"):
        return imgio.load(file_name)
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return read_flo(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
