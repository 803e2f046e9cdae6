"""Write the JPEG fixtures of the port's VIPER paths and the hashes of their
pixels as PIL decodes them.

    python tools/make_jpeg_fixtures.py [--out tests/data]

Two 1920x1080 frames (VIPER's size) of a seeded synthetic scene, the second
the first moved by (7, -3) px with a little fresh noise, encoded by PIL at
quality 85 with 4:2:0 chroma (its default): tests/data/viper_000{10,11}.jpg;
and their top-left 256x256 corners, encoded alike, as
tests/data/viper_small_000{10,11}.jpg (a tree small enough to run on the
CPU too).  tests/data/viper_jpeg.json holds, per file, the SHA-256 of the uint8 RGB
array that ``np.array(PIL.Image.open(path))`` gives; the CPU tests and
chip_smoke.py hold the port's decoder to those hashes.  Needs PIL, so it
runs where PIL is installed, not on the card's machine.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

H, W = 1080, 1920
SHIFT = (7, -3)  # (dx, dy) of frame 2's content
NAMES = ("viper_00010.jpg", "viper_00011.jpg")
SMALL = (256, 256)


def scene(rng, h: int, w: int) -> np.ndarray:
    """Smooth colour fields, a few hard-edged boxes and mild noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy, ph = rng.uniform(0.002, 0.02, 2).tolist() + \
                [rng.uniform(0, 6.3)]
            img[..., c] += 30 * np.sin(fx * x + fy * y + ph)
    img += 128
    for _ in range(24):
        y0, x0 = rng.randint(0, h - 60), rng.randint(0, w - 60)
        img[y0:y0 + rng.randint(20, 200), x0:x0 + rng.randint(20, 300)] = \
            rng.uniform(0, 255, 3)
    return img


def pixels_sha256(data: bytes) -> str:
    arr = np.ascontiguousarray(np.array(Image.open(io.BytesIO(data))))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(Path(__file__).resolve().parent.parent
                                        / "tests" / "data"))
    out = Path(p.parse_args().out)
    rng = np.random.RandomState(2015)
    pad = 16
    big = scene(rng, H + 2 * pad, W + 2 * pad)
    dx, dy = SHIFT
    frames = [big[pad:pad + H, pad:pad + W],
              big[pad - dy:pad - dy + H, pad - dx:pad - dx + W]]
    meta = {}
    for name, frame in zip(NAMES, frames):
        frame = frame + rng.normal(0, 2, frame.shape)
        img = np.clip(np.rint(frame), 0, 255).astype(np.uint8)
        for prefix, part in (("viper_", img),
                             ("viper_small_", img[:SMALL[0], :SMALL[1]])):
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(part)).save(buf, "JPEG",
                                                             quality=85)
            data = buf.getvalue()
            fname = name.replace("viper_", prefix)
            (out / fname).write_bytes(data)
            meta[fname] = {"shape": list(part.shape), "pixels_sha256":
                           pixels_sha256(data), "bytes": len(data)}
    (out / "viper_jpeg.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
