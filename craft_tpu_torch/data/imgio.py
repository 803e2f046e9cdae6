"""Image codec on numpy and ``zlib``: PNG and binary PNM (PPM/PGM).

The port's own reader and writer for the datasets' files, so that loading
needs neither PIL nor OpenCV.  ``load(path)`` returns the array that
``np.array(PIL.Image.open(path))`` gives for the formats the datasets use:
uint8 [H, W] gray, [H, W, 3] RGB, [H, W, 4] RGBA (PNG, 8-bit), uint16 where
the file is 16-bit (KITTI flow PNGs, [H, W, 3]), and the raw indices of a
palette PNG.  Non-interlaced PNG only, with any of the five row filters.
``write_png`` and ``write_ppm`` write the same formats (PNG rows unfiltered).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels: gray, RGB, palette, gray + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).

    A pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal y + x = d are independent: the loop walks
    the h + w - 1 diagonals, each step vectorized over its rows.  Returns
    [h, w * bpp] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError("PNG: image data has the wrong size")
    rows = rows.reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: unknown row filter")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not ftype.any():
        return rows[:, 1:].copy()
    # recon[y + 1, x + 1] holds pixel (y, x); row 0 and column 0 are zero.
    recon = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = recon[ys + 1, xs]      # left
        b = recon[ys, xs + 1]      # up
        c = recon[ys, xs]          # up-left
        t = ftype[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        recon[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return recon[1:, 1:].reshape(h, w * bpp).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos, idat, hdr = len(_PNG_SIG), [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if interlace or color not in _CHANNELS or depth not in (8, 16) or \
            (color == 3 and depth != 8):
        raise ValueError(f"PNG: unsupported (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    return pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, ch)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 or uint16 [H, W] gray, [H, W, 2] gray + alpha, [H, W, 3] RGB
    or [H, W, 4] RGBA -> PNG bytes (rows unfiltered)."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG: uint8 or uint16 pixels, got {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in _COLOR_TYPE:
        raise ValueError(f"PNG: 1 to 4 channels, got {ch}")
    depth = 8 * img.dtype.itemsize
    px = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(px).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                          _COLOR_TYPE[ch], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PPM (P6, RGB) or PGM (P5, gray), maxval up to 65535."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the line's end
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError("PNM: truncated header")
        tokens.append(data[pos:end])
        pos = end
    magic, w, h, maxval = tokens[0], *map(int, tokens[1:])
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"PNM: binary P5/P6 only, got {magic!r}")
    ch = 3 if magic == b"P6" else 1
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    count = h * w * ch
    pix = np.frombuffer(data, dt, count=count, offset=pos + 1)
    pix = pix.astype(np.uint8 if maxval < 256 else np.uint16)
    return pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, 3)


def encode_ppm(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> binary PPM, or [H, W] -> binary PGM."""
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] == 3):
        raise ValueError("PNM: uint8 [H, W] or [H, W, 3] pixels")
    magic = b"P5" if img.ndim == 2 else b"P6"
    head = b"%s\n%d %d\n255\n" % (magic, img.shape[1], img.shape[0])
    return head + np.ascontiguousarray(img).tobytes()


def load(path: str) -> np.ndarray:
    """Decode a PNG or binary PNM file by its signature."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data)
    raise ValueError(f"{path}: neither PNG nor binary PPM/PGM")


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_ppm(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_ppm(img))
