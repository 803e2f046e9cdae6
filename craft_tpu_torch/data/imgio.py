"""Image codec on numpy and ``zlib``: PNG, binary PNM (PPM/PGM) and JPEG.

The port's own reader and writer for the datasets' files, so that loading
needs neither PIL nor OpenCV.  ``load(path)`` returns the array of the JAX
package's ``craft_tpu.data.imgio.load`` with its native core (libpng and
libjpeg) built, bit for bit, for every file that decodes: uint8 [H, W]
gray, [H, W, 2] gray + alpha, [H, W, 3] RGB, [H, W, 4] RGBA or CMYK,
uint16 where a PNG is 16-bit (KITTI flow PNGs, [H, W, 3]), and the raw
indices of a palette PNG.  What it refuses, the port refuses with a
ValueError naming the form.  ``write_png`` and ``write_ppm`` write PNG
(rows unfiltered) and PPM/PGM.

PNG: any bit depth libpng takes (1, 2 and 4-bit gray scaled to 8 bits,
palette indices unpacked to bytes), the five row filters, Adam7
interlacing, and a ``tRNS`` chunk on a gray or RGB image made an alpha
channel, as the native core's libpng transforms give them.

JPEG: 8-bit files, Huffman or arithmetic-coded (``jpeg_arith``),
sequential, progressive (``jpeg_progressive``, with libjpeg-turbo 2.1's
block smoothing of coefficients the scans leave inexact) or lossless
(``jpeg_lossless``, as PIL decodes it, the native core's libjpeg having
no lossless decoder), restart intervals, any sampling, one to four
components (or more of no colour).  The pixels are libjpeg's with its
default settings: the ISLOW integer IDCT (``jidctint.c``), libjpeg-turbo's
"fancy" triangular chroma upsampling (h2v1, h1v2, h2v2; ``jdsample.c``),
the fixed-point YCbCr -> RGB tables and YCCK -> CMYK (``jdcolor.c``; CMYK
as stored).  The entropy decoding runs in Python over a table of every
16-bit window of the bit stream; the rest is vectorised over all blocks.
Hierarchical and 12-bit files are refused, as libjpeg and PIL refuse them.
Truncated or damaged files raise, where libjpeg would decode them with a
warning.
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


# Adam7's passes: (x0, y0, dx, dy), each pass the pixels (y0 + i dy,
# x0 + j dx).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Bit depths libpng takes for each colour type.
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _png_rows(raw, h: int, w: int, depth: int, ch: int) -> np.ndarray:
    """One (sub)image's filtered rows -> samples [h, w * ch]: uint8, uint16
    at 16 bits, and at 1, 2 or 4 bits each sample unpacked (MSB first) into
    a byte.  The filters work on whole bytes, one byte a pixel below 8
    bits."""
    if depth < 8:
        rowbytes = -(-w * depth // 8)
        packed = _unfilter(raw, h, rowbytes, 1)
        bits = np.unpackbits(packed, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits.reshape(h, w, depth) * weights).sum(
            -1, dtype=np.uint8)
    pix = _unfilter(raw, h, w, ch * depth // 8)
    return pix.view(">u2").astype(np.uint16) if depth == 16 else pix


def _deinterlace(raw: bytes, h: int, w: int, depth: int,
                 ch: int) -> np.ndarray:
    """Adam7: seven reduced images one after the other, each with its own
    rows and filter bytes; a pass empty at this size has no bytes."""
    out = np.empty((h, w * ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if not pw or not ph:
            continue
        n = ph * (-(-pw * ch * depth // 8) + 1)
        sub = _png_rows(raw[pos:pos + n], ph, pw, depth, ch)
        out.reshape(h, w, ch)[y0::dy, x0::dx] = sub.reshape(ph, pw, ch)
        pos += n
    if pos != len(raw):
        raise ValueError("PNG: image data has the wrong size")
    return out


def _trns_alpha(pix: np.ndarray, color: int, depth: int,
                trns: bytes) -> np.ndarray:
    """png_set_tRNS_to_alpha on a gray or RGB image (samples [H, W * ch]):
    the pixels equal to the chunk's gray value or RGB triple get alpha 0,
    every other one full scale; gray + alpha [H, W, 2] or RGBA [H, W, 4].
    libpng compares the value's low byte at 8 bits and its low `depth`
    bits below 8."""
    ch = 1 if color == 0 else 3
    key = np.array(struct.unpack(f">{ch}H", trns), np.int64)
    key &= (1 << depth) - 1
    if depth < 8:
        key *= 255 // ((1 << depth) - 1)
    px = pix.reshape(pix.shape[0], -1, ch)
    top = 65535 if depth == 16 else 255
    alpha = np.where((px == key.astype(px.dtype)).all(-1), 0, top)
    return np.concatenate([px, alpha[..., None].astype(px.dtype)], -1)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG as libpng gives it with the JAX package's transforms
    (``native/imgio/imgio.cpp``): 1, 2 or 4-bit gray scaled to 8 bits
    (x 255, 85, 17), palette indices unpacked to bytes, and a ``tRNS``
    chunk on a gray or RGB image made an alpha channel."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos, idat, hdr, trns = len(_PNG_SIG), [], None, None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS" and not idat and trns is None:
            trns = body  # libpng reads the first, before the image data
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(f"PNG: unsupported (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        pix = _deinterlace(raw, h, w, depth, ch)
    else:
        pix = _png_rows(raw, h, w, depth, ch)
    if color == 0 and depth < 8:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    if color in (0, 2) and trns is not None and len(trns) == 2 * ch:
        return _trns_alpha(pix, color, depth, trns)
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
# SOF marker -> (entropy coding, process).  Hierarchical frames (SOF5-7,
# SOF13-15) libjpeg refuses, and so does the port.
_SOF = {0xC0: ("Huffman", "sequential"), 0xC1: ("Huffman", "sequential"),
        0xC2: ("Huffman", "progressive"), 0xC3: ("Huffman", "lossless"),
        0xC9: ("arithmetic", "sequential"),
        0xCA: ("arithmetic", "progressive"),
        0xCB: ("arithmetic", "lossless")}
_SOF_HIERARCHICAL = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)


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
    """A JPEG -> uint8 [H, W] (one component), [H, W, 3] RGB, [H, W, 4]
    CMYK, or [H, W, N] of N components of no known colour: the pixels of
    libjpeg's default decode (see the module)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    tabs = {"q": {}, "dc": {}, "ac": {}, "dac_dc": {}, "dac_ac": {}}
    frame, restart, adobe, jfif = None, 0, None, False
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
        if marker in _SOF_HIERARCHICAL:
            raise ValueError(f"JPEG: hierarchical JPEG (SOF{marker - 0xC0}) "
                             "is not decoded (libjpeg refuses it)")
        if marker in _SOF:
            frame = _frame(body, *_SOF[marker])
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                syms = body[i + 17:i + 17 + sum(counts)]
                tabs["ac" if tc else "dc"][th] = _huffman_lut(counts, syms)
                i += 17 + sum(counts)
        elif marker == 0xCC:  # DAC: arithmetic conditioning
            for i in range(0, len(body) - 1, 2):
                tc, tb, cs = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc:
                    tabs["dac_ac"][tb] = cs
                else:
                    tabs["dac_dc"][tb] = (cs & 15, cs >> 4)
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(body[i + 1:i + 1 + n],
                                  ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = q
                tabs["q"][tq] = nat
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
            pos = _scan(frame, buf, pos, body, tabs, restart)
    if frame is None or not frame["scans"]:
        raise ValueError("JPEG: no frame or no scan")
    if frame["process"] == "lossless":
        from craft_tpu_torch.data import jpeg_lossless
        planes = jpeg_lossless.samples(frame)
    else:
        planes = _dct_samples(frame)
    return _to_pixels(frame, planes, adobe, jfif)


def _frame(body: bytes, coding: str, process: str) -> dict:
    """A frame header: its components and an empty store for their
    coefficients (or, lossless, their samples)."""
    prec, h, w, n = struct.unpack(">BHHB", body[:6])
    if coding == "arithmetic" and process == "lossless":
        raise ValueError("JPEG: arithmetic-coded lossless JPEG (SOF11) is "
                         "not decoded (libjpeg has no decoder for it)")
    if prec != 8:
        raise ValueError(f"JPEG: {prec}-bit samples are not decoded (the "
                         "JAX package's libjpeg and PIL take 8 bits)")
    if h == 0 or w == 0 or n == 0:
        raise ValueError(f"JPEG: a frame of {w}x{h} and {n} components "
                         "is not decoded")
    comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                  v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i],
                  coef_bits=np.full(64, -1))
             for i in range(n)]
    if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4 for c in comps):
        raise ValueError("JPEG: a sampling factor outside 1..4")
    frame = {"coding": coding, "process": process, "size": (h, w),
             "comps": comps, "scans": 0}
    frame.update(_alloc_planes(comps, h, w,
                               1 if process == "lossless" else 8))
    return frame


def _alloc_planes(comps, h, w, unit: int = 8) -> dict:
    """Each component's padded store of whole MCUs: bw x bh blocks of 8 x
    8 coefficients (unit 8) or samples (lossless, unit 1); dw x dh its
    samples and cols x rows the blocks that hold them."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (unit * hmax)), -(-h // (unit * vmax))
    offset = 0
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["dw"] = -(-w * c["h"] // hmax)
        c["dh"] = -(-h * c["v"] // vmax)
        c["cols"], c["rows"] = -(-c["dw"] // unit), -(-c["dh"] // unit)
        c["off"] = offset
        offset += c["bw"] * c["bh"] * unit * unit
    return {"coef": np.zeros(offset, np.int32), "mcu": (mcux, mcuy),
            "max": (hmax, vmax)}


def _scan_data(buf, pos):
    """The scan's entropy-coded bytes from `pos` to the first marker other
    than RSTn: its restart segments (0xFF00 unstuffed) and the position of
    that marker."""
    rest = buf[pos:]
    ff = np.flatnonzero(rest[:-1] == 0xFF)
    nxt = rest[ff + 1]
    ends = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if ends.size else len(rest)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    stuffed = ff[(ff < end) & (nxt == 0)] + 1
    bounds = [0] + [int(r) for r in rst] + [end]
    starts = [0] + [int(r) + 2 for r in rst]
    segs = []
    for a, b in zip(starts, bounds[1:]):
        keep = np.ones(b - a, bool)
        keep[stuffed[(stuffed >= a) & (stuffed < b)] - a] = False
        segs.append(rest[a:b][keep])
    return segs, pos + end


def _scan_order(frame, scomps, unit: int = 8):
    """The scan's blocks (lossless: samples) in decode order: offsets into
    the store, each one's component index in the scan, and blocks an
    MCU."""
    if len(scomps) == 1:  # non-interleaved: the component's own, raster
        c = scomps[0]
        yy, xx = np.meshgrid(np.arange(c["rows"]), np.arange(c["cols"]),
                             indexing="ij")
        bases = (c["off"] + (yy * c["bw"] + xx) * unit * unit).reshape(-1)
        return bases, np.zeros(bases.size, np.int64), 1
    # interleaved MCUs: each component's h x v blocks in turn
    mcux, mcuy = frame["mcu"]
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    parts, cparts = [], []
    for j, c in enumerate(scomps):
        for v in range(c["v"]):
            for h in range(c["h"]):
                parts.append(c["off"] + ((my * c["v"] + v) * c["bw"]
                                         + mx * c["h"] + h) * unit * unit)
                cparts.append(np.full(my.shape, j))
    return (np.stack(parts, -1).reshape(-1),
            np.stack(cparts, -1).reshape(-1), len(parts))


def _progression(scomps, ss, se, ah, al) -> None:
    """libjpeg's check of a progressive scan's parameters, and each
    component's coefficient bits (the Al each coefficient was last sent
    at, -1 before it is), which block smoothing reads."""
    bad = (se != 0) if ss == 0 else (se < ss or se > 63 or len(scomps) != 1)
    if bad or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG: a progressive scan of Ss {ss}, Se {se}, "
                         f"Ah {ah}, Al {al} is not valid")
    for c in scomps:
        c["coef_bits"][ss:se + 1] = al


def _scan(frame, buf, pos, body, tabs, restart) -> int:
    """Decode the scan whose SOS body is `body` and whose entropy-coded
    data starts at `pos`; returns the position of the marker after it."""
    ns = body[0]
    ids = [body[1 + 2 * i] for i in range(ns)]
    sel = [body[2 + 2 * i] for i in range(ns)]
    ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    by_id = {c["id"]: c for c in frame["comps"]}
    if ns == 0 or any(i not in by_id for i in ids):
        raise ValueError("JPEG: a scan names a component not in the frame")
    scomps = [by_id[i] for i in ids]
    process, coding = frame["process"], frame["coding"]
    if process != "lossless":
        for c in scomps:  # libjpeg latches a table at a component's first
            if "qt" not in c:  # scan
                if c["tq"] not in tabs["q"]:
                    raise ValueError("JPEG: a component's quantisation "
                                     "table is not defined before its scan")
                c["qt"] = tabs["q"][c["tq"]]
    if process == "progressive":
        _progression(scomps, ss, se, ah, al)
    segs, end = _scan_data(buf, pos)
    unit = 1 if process == "lossless" else 8
    order = _scan_order(frame, scomps, unit)
    if coding == "arithmetic":
        from craft_tpu_torch.data import jpeg_arith
        dac_dc = [tabs["dac_dc"].get(t >> 4, (0, 1)) for t in sel]
        dac_ac = [tabs["dac_ac"].get(t & 15, 5) for t in sel]
        jpeg_arith.decode_scan(segs, order, frame["coef"], sel, dac_dc,
                               dac_ac, process == "progressive", ss, se,
                               ah, al, restart)
    else:
        try:
            dcl = [tabs["dc"][t >> 4] for t in sel] \
                if process != "progressive" or ss == ah == 0 else []
            acl = [tabs["ac"][t & 15] for t in sel] \
                if process == "sequential" or (process == "progressive"
                                               and ss) else []
        except KeyError:
            raise ValueError("JPEG: a scan names a Huffman table not "
                             "defined before it") from None
        if process == "lossless":
            from craft_tpu_torch.data import jpeg_lossless
            jpeg_lossless.decode_scan(segs, frame, scomps, order, dcl,
                                      restart, ss, se, ah, al)
        elif process == "progressive":
            from craft_tpu_torch.data import jpeg_progressive
            jpeg_progressive.decode_scan(segs, scomps, order, frame["coef"],
                                         dcl, acl, ss, se, ah, al, restart)
        else:
            _decode_sequential(segs, order, frame["coef"], dcl, acl,
                               restart)
    frame["scans"] += 1
    return end


def _decode_sequential(segs, order, coef, dcl, acl, restart) -> None:
    """A sequential Huffman scan (libjpeg takes any Ss, Se, Ah, Al here as
    0, 63, 0, 0)."""
    bases, cidx, per_mcu = order
    blocks = list(zip(cidx.tolist(), bases.tolist()))
    seg_blocks = restart * per_mcu if restart else len(blocks)
    cf = memoryview(coef)
    for s, seg in enumerate(segs):
        part = blocks[s * seg_blocks:(s + 1) * seg_blocks]
        if not part:
            break
        _decode_blocks(_windows(seg), part, dcl, acl, cf)


def _dct_samples(frame) -> list:
    """Each component's samples [dh, dw]: its blocks (smoothed where
    libjpeg smooths a progressive file's) through the ISLOW IDCT."""
    comps = frame["comps"]
    smooth = frame["process"] == "progressive"
    if smooth:
        from craft_tpu_torch.data import jpeg_progressive
        smooth = jpeg_progressive.smoothing_applies(comps)
    out = []
    for c in comps:
        coef = frame["coef"][c["off"]:c["off"] + c["bw"] * c["bh"] * 64]
        blocks = coef.reshape(c["bh"], c["bw"], 64)[:c["rows"], :c["cols"]]
        qt = c.get("qt", np.zeros(64, np.int64))  # no scan: all zero
        if smooth:
            blocks = jpeg_progressive.smooth(blocks, qt, c, frame["mcu"][1])
        samples = _idct_islow(blocks.reshape(-1, 64), qt)
        plane = samples.reshape(c["rows"], c["cols"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["rows"] * 8, c["cols"] * 8)
        out.append(plane[:c["dh"], :c["dw"]])
    return out


def _ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - R, G, B of the
    YCbCr conversion; K as stored."""
    return np.concatenate([255 - _ycc_to_rgb(y, cb, cr),
                           k.astype(np.uint8)[..., None]], -1)


def _to_pixels(frame, planes, adobe, jfif) -> np.ndarray:
    """The components' samples brought to the image's size (libjpeg's
    fancy upsampling; replication in a lossless file, where libjpeg has
    no fancy form) and converted to the output colour space."""
    h, w = frame["size"]
    hmax, vmax = frame["max"]
    fancy = frame["process"] != "lossless"
    out = [_upsample(p, hmax // c["h"], vmax // c["v"], h, w) if fancy
           else np.repeat(np.repeat(p, vmax // c["v"], 0), hmax // c["h"],
                          1)[:h, :w]
           for p, c in zip(planes, frame["comps"])]
    ids = [c["id"] for c in frame["comps"]]
    if len(out) == 1:
        return out[0].astype(np.uint8)
    if not fancy:
        return _lossless_colour(out, adobe, jfif)
    if len(out) == 3:
        # libjpeg's guess of the colour space (jdapimin.c): JFIF or Adobe
        # transform 1 mean YCbCr; Adobe transform 0 or ids 'R', 'G', 'B'
        # RGB.
        rgb = (not jfif) and (adobe == 0 if adobe is not None
                              else ids == [82, 71, 66])
        if not rgb:
            return _ycc_to_rgb(*out)
    elif len(out) == 4 and adobe not in (None, 0):
        return _ycck_to_cmyk(*out)  # Adobe transform 2 (or unknown): YCCK
    return np.stack(out, -1).astype(np.uint8)


def _lossless_colour(out, adobe, jfif) -> np.ndarray:
    """A lossless file's components as PIL gives them (the JAX package
    reads lossless JPEG through PIL): libjpeg-turbo converts no colour in
    lossless mode, so a file it takes for YCbCr (JFIF, Adobe transform
    other than 0) or YCCK is refused; RGB as stored; four components as
    PIL's inverted CMYK ("CMYK;I"); PIL has no mode for other counts."""
    if len(out) == 3 and not jfif and adobe in (None, 0):
        return np.stack(out, -1).astype(np.uint8)
    if len(out) == 4 and adobe in (None, 0):
        return 255 - np.stack(out, -1).astype(np.uint8)
    raise ValueError(f"JPEG: lossless JPEG of {len(out)} components "
                     f"({'JFIF' if jfif else f'Adobe transform {adobe}'}) "
                     "is not decoded (PIL's libjpeg-turbo converts no "
                     "colour in lossless mode)")


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
