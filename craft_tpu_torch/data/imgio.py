"""Image codec on numpy and ``zlib``: PNG, binary PNM (PPM/PGM) and
baseline JPEG.

The port's own reader and writer for the datasets' files, so that loading
needs neither PIL nor OpenCV.  ``load(path)`` returns the array that
``np.array(PIL.Image.open(path))`` gives for the formats the datasets use:
uint8 [H, W] gray, [H, W, 3] RGB, [H, W, 4] RGBA (PNG, 8-bit), uint16 where
the file is 16-bit (KITTI flow PNGs, [H, W, 3]), and the raw indices of a
palette PNG.  Non-interlaced PNG only, with any of the five row filters.
``write_png`` and ``write_ppm`` write the same formats (PNG rows unfiltered).

JPEG (VIPER's frames): sequential Huffman-coded 8-bit files, baseline or
extended, one or more scans, restart intervals, gray or three components
at any integer sampling.  The pixels are libjpeg's (and so PIL's) with its
default settings, bit for bit: the ISLOW integer IDCT (``jidctint.c``),
libjpeg-turbo's "fancy" triangular chroma upsampling (h2v1, h1v2, h2v2;
``jdsample.c``) and the fixed-point YCbCr -> RGB tables (``jdcolor.c``).
The entropy decoding runs in Python over a table of every 16-bit window of
the bit stream; the rest is vectorised over all blocks.  Progressive,
lossless, arithmetic-coded and 12-bit files are refused.
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


# ---------------------------------------------------------------- JPEG

# Natural (row-major) index of the k-th coefficient in zigzag order.
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "progressive",
                0xC6: "progressive", 0xC7: "lossless", 0xC9: "arithmetic",
                0xCA: "progressive", 0xCB: "lossless", 0xCD: "arithmetic",
                0xCE: "progressive", 0xCF: "lossless"}


def _huffman_lut(counts, symbols) -> list:
    """A DHT table as a list over every 16-bit window: (code length << 8)
    | symbol for the code the window starts with, 0 where none does."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(seg: np.ndarray) -> memoryview:
    """Every 16-bit window of a segment's bit stream (0xFF00 unstuffed),
    one per bit position, zero bits past its end; as a memoryview whose
    items are Python ints."""
    b = np.concatenate([seg, np.zeros(4, np.uint8)]).astype(np.int32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.int32)
    win = (w24[:, None] >> shifts[None, :]) & 0xFFFF
    return memoryview(np.ascontiguousarray(win.reshape(-1)))


def _decode_blocks(win, blocks, dc_luts, ac_luts, cf) -> None:
    """Huffman-decode one restart segment: `blocks` lists (component,
    coefficient offset) in decode order; coefficients go to cf (natural
    order), DC undifferenced.  The hot loop of the decoder."""
    zz = _ZIGZAG
    pred = [0] * len(dc_luts)
    p = 0
    try:
        for ci, base in blocks:
            e = dc_luts[ci][win[p]]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            p += e >> 8
            s = e & 15
            if s:
                v = win[p] >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            cf[base] = pred[ci]
            ac = ac_luts[ci]
            k = 1
            while k < 64:
                e = ac[win[p]]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = win[p] >> (16 - s)
                    p += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    cf[base + zz[k]] = v
                    k += 1
                elif (e & 255) == 0xF0:
                    k += 16
                else:
                    break
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None


# jidctint.c's constants: FIX(x) = round(x * 2^13).
_C = {n: int(v * (1 << 13) + 0.5) for n, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _idct_1d(x, shift: int):
    """One pass of jpeg_idct_islow over axis 1 of x [N, 8, ...] (int64):
    its even and odd parts, then DESCALE by `shift`."""
    c = _C
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * c["0_541196100"]
    tmp2 = z1 - z3 * c["1_847759065"]
    tmp3 = z1 + z2 * c["0_765366865"]
    tmp0 = (x[:, 0] + x[:, 4]) << 13
    tmp1 = (x[:, 0] - x[:, 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["1_175875602"]
    t0 = t0 * c["0_298631336"]
    t1 = t1 * c["2_053119869"]
    t2 = t2 * c["3_072711026"]
    t3 = t3 * c["1_501321110"]
    z1 = z1 * -c["0_899976223"]
    z2 = z2 * -c["2_562915447"]
    z3 = z3 * -c["1_961570560"] + z5
    z4 = z4 * -c["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + half) >> shift for o in out], axis=1)


# The post-IDCT range limit of jdmaster.c over (value & 1023): values in
# [-128, 127] + 128, up to 511 -> 255, down to -512 -> 0, beyond that
# wrapped as libjpeg wraps them.
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255),
                              np.zeros(384), np.arange(0, 128)]
                             ).astype(np.uint8)


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks [N, 64] (natural order) with
    libjpeg's ISLOW integer IDCT: samples uint8 [N, 8, 8]."""
    x = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d(x, 13 - 2)                    # columns, PASS1_BITS = 2
    out = _idct_1d(ws.transpose(0, 2, 1), 13 + 2 + 3)   # rows
    return _IDCT_LIMIT[out.transpose(0, 2, 1) & 1023]


def _fancy_h(c: np.ndarray, b0: int, b1: int, sh: int) -> np.ndarray:
    """Double the width: (3 c + left + b0) >> sh, (3 c + right + b1) >> sh,
    edges replicated (jdsample.c's first and last columns come out the
    same)."""
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int32)
    out[:, 0::2] = (3 * c + left + b0) >> sh
    out[:, 1::2] = (3 * c + right + b1) >> sh
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int, h: int, w: int):
    """A component's samples [dh, dw] brought to the image's [h, w] as
    libjpeg-turbo does with fancy upsampling on (its default)."""
    p = plane.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    if (fh, fv) == (1, 1):
        out = p
    elif (fh, fv) == (2, 1) and p.shape[1] > 2:
        out = _fancy_h(p, 1, 2, 2)
    elif (fh, fv) == (1, 2):
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        out[0::2] = (3 * p + above + 1) >> 2
        out[1::2] = (3 * p + below + 2) >> 2
    elif (fh, fv) == (2, 2) and p.shape[1] > 2:
        out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
        out[0::2] = _fancy_h(3 * p + above, 8, 7, 4)
        out[1::2] = _fancy_h(3 * p + below, 8, 7, 4)
    else:  # any other integer factor: replication
        out = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    return out[:h, :w]


def _fix16(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: fixed point with 16 fraction bits."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix16(1.40200) * x + half) >> 16
    cb_b = (_fix16(1.77200) * x + half) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A sequential Huffman JPEG -> uint8 [H, W] (one component) or [H, W,
    3] RGB, the pixels of libjpeg's default decode (see the module)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    qts, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame, planes, restart = [], None, None, 0
    adobe, jfif = None, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos >= len(data):
            raise ValueError("JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"JPEG: {_SOF_REFUSED[marker]} JPEG is not "
                             "decoded by the port (sequential Huffman "
                             "only)")
        if marker in (0xC0, 0xC1):
            prec, h, w, n = struct.unpack(">BHHB", body[:6])
            if prec != 8 or h == 0:
                raise ValueError(f"JPEG: {prec}-bit samples or height {h} "
                                 "not decoded by the port")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i])
                     for i in range(n)]
            frame = (h, w)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                syms = body[i + 17:i + 17 + sum(counts)]
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, syms)
                i += 17 + sum(counts)
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(body[i + 1:i + 1 + n],
                                  ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = q
                qts[tq] = nat
                i += 1 + n
        elif marker == 0xDD:  # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            if planes is None:
                planes = _alloc_planes(comps, *frame)
            pos = _decode_scan(buf, pos, body, comps, frame, planes,
                               dc_tabs, ac_tabs, restart)
    if planes is None:
        raise ValueError("JPEG: no frame or no scan")
    return _to_pixels(comps, frame, planes, qts, adobe, jfif)


def _alloc_planes(comps, h, w) -> dict:
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    offset = 0
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["dw"] = -(-w * c["h"] // hmax)
        c["dh"] = -(-h * c["v"] // vmax)
        c["off"] = offset
        offset += c["bw"] * c["bh"] * 64
    return {"coef": np.zeros(offset, np.int32), "mcu": (mcux, mcuy),
            "max": (hmax, vmax)}


def _decode_scan(buf, pos, body, comps, frame, planes, dc_tabs, ac_tabs,
                 restart) -> int:
    """Decode the scan whose SOS body is `body` and whose entropy-coded
    data starts at `pos`; returns the position of the marker after it."""
    ns = body[0]
    ids = [body[1 + 2 * i] for i in range(ns)]
    sel = [body[2 + 2 * i] for i in range(ns)]
    ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        raise ValueError("JPEG: a spectral-selection scan (progressive) is "
                         "not decoded by the port")
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    scomps = [comps[by_id[i]] for i in ids]
    if ns == 1:  # non-interleaved: the component's own blocks, raster
        c = scomps[0]
        bx, by = -(-c["dw"] // 8), -(-c["dh"] // 8)
        yy, xx = np.meshgrid(np.arange(by), np.arange(bx), indexing="ij")
        bases = (c["off"] + (yy * c["bw"] + xx) * 64).reshape(-1)
        cidx = np.zeros(bases.size, np.int64)
        per_mcu = 1
    else:  # interleaved MCUs: each component's h x v blocks in turn
        mcux, mcuy = planes["mcu"]
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                             indexing="ij")
        parts, cparts = [], []
        for j, c in enumerate(scomps):
            for v in range(c["v"]):
                for h in range(c["h"]):
                    parts.append(c["off"] + ((my * c["v"] + v) * c["bw"]
                                             + mx * c["h"] + h) * 64)
                    cparts.append(np.full(my.shape, j))
        bases = np.stack(parts, -1).reshape(-1)
        cidx = np.stack(cparts, -1).reshape(-1)
        per_mcu = len(parts)
    try:
        dcl = [dc_tabs[t >> 4] for t in sel]
        acl = [ac_tabs[t & 15] for t in sel]
    except KeyError:
        raise ValueError("JPEG: a scan names a Huffman table not defined "
                         "before it") from None
    # The scan's bytes run to the first marker other than RSTn.
    rest = buf[pos:]
    ff = np.flatnonzero(rest[:-1] == 0xFF)
    nxt = rest[ff + 1]
    ends = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if ends.size else len(rest)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    stuffed = ff[(ff < end) & (nxt == 0)] + 1
    bounds = [0] + [int(r) for r in rst] + [end]
    starts = [0] + [int(r) + 2 for r in rst]
    blocks = list(zip(cidx.tolist(), bases.tolist()))
    seg_blocks = restart * per_mcu if restart else len(blocks)
    cf = memoryview(planes["coef"])
    for s, (a, b) in enumerate(zip(starts, bounds[1:])):
        keep = np.ones(b - a, bool)
        st = stuffed[(stuffed >= a) & (stuffed < b)] - a
        keep[st] = False
        seg = rest[a:b][keep]
        part = blocks[s * seg_blocks:(s + 1) * seg_blocks]
        if not part:
            break
        _decode_blocks(_windows(seg), part, dcl, acl, cf)
    return pos + end


def _to_pixels(comps, frame, planes, qts, adobe, jfif) -> np.ndarray:
    h, w = frame
    hmax, vmax = planes["max"]
    out = []
    for c in comps:
        coef = planes["coef"][c["off"]:c["off"] + c["bw"] * c["bh"] * 64]
        samples = _idct_islow(coef.reshape(-1, 64), qts[c["tq"]])
        plane = samples.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["dh"], :c["dw"]]
        out.append(_upsample(plane, hmax // c["h"], vmax // c["v"], h, w))
    if len(out) == 1:
        return out[0].astype(np.uint8)
    if len(out) != 3:
        raise ValueError(f"JPEG: {len(out)} components not decoded by the "
                         "port (gray or three)")
    # libjpeg's guess of the colour space (jdapimin.c): JFIF or Adobe
    # transform 1 mean YCbCr; Adobe transform 0 or ids 'R', 'G', 'B' RGB.
    ids = [c["id"] for c in comps]
    rgb = (not jfif) and (adobe == 0 if adobe is not None
                          else ids == [82, 71, 66])
    if rgb:
        return np.stack(out, -1).astype(np.uint8)
    return _ycc_to_rgb(*out)


def load(path: str) -> np.ndarray:
    """Decode a PNG, binary PNM or JPEG file by its signature."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    raise ValueError(f"{path}: neither PNG, binary PPM/PGM nor JPEG")


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_ppm(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_ppm(img))
