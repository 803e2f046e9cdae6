"""Write the image-format fixtures of the port's decoder and what the JAX
package's two decoders make of each.

    python tools/make_image_fixtures.py [--out tests/data]

Every JPEG and PNG form the JAX package reads (``craft_tpu.data.imgio.load``:
its native core over libjpeg and libpng, and PIL where the core refuses a
file) gets small files from seeded synthetic pixels, at most 64x96 and
some at odd sizes: progressive Huffman JPEG (libjpeg's and PIL's scripts,
scripts that leave coefficients inexact, so that libjpeg smooths them, DC
only, restarts, and an EOB run that runs past a restart marker),
arithmetic-coded JPEG (sequential and progressive, with and without
restarts, a DAC marker with other conditioning and none at all),
lossless JPEG (predictors 1-7, a point transform, restarts, RGB and
JFIF YCbCr, separate scans, subsampling), CMYK and YCCK JPEG, two
components of no colour, interlaced PNG at every depth and at sizes
from 1x1 (passes with no pixels), 1, 2 and 4-bit gray and palette PNG,
and gray and RGB PNG with a tRNS chunk; and the forms the JAX package
refuses (hierarchical and 12-bit JPEG, arithmetic-coded lossless and
12-bit lossless JPEG).  Also the 1920x1080 VIPER scene
(``tools/make_jpeg_fixtures.py``): its pair as PIL's progressive JPEG and
its first frame as arithmetic-coded JPEG, sequential and progressive,
lossless JPEG, YCCK JPEG and Adam7 PNG, to time each form at a frame's
size.

The files go to tests/data/formats/ and tests/data/image_formats.json
holds, per file, its form and, for the native core and for PIL, the
shape, dtype and SHA-256 of the array each gives (or its error), whether
the two agree and which of them ``load`` returns.  The expected pixels
come from those decoders, never from the encoders here: PIL, libjpeg
through tools/jpeg_fixture_writer.c (built here with the system's
compiler and libjpeg) for arithmetic coding, scan scripts and YCCK, and
numpy for lossless JPEG and PNG.  The tool fails if a file meant to be
valid is refused by both.  It needs PIL, a C compiler, libjpeg's headers
and the JAX package's native core (``craft_tpu.data.imgio.build``), so
it runs where those are, not on the card's machine.
"""

from __future__ import annotations

import argparse
import hashlib
import heapq
import io
import json
import re
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from craft_tpu.data import imgio as jax_imgio  # noqa: E402
import make_jpeg_fixtures  # noqa: E402

WRITER_SRC = ROOT / "tools" / "jpeg_fixture_writer.c"


# ------------------------------------------------------------ pixels

def scene(rng, h: int, w: int, c: int = 3) -> np.ndarray:
    """Smooth ramps, a few boxes and mild noise, uint8 [h, w, c]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, c))
    for k in range(c):
        fx, fy, ph = rng.uniform(0.05, 0.3), rng.uniform(0.05, 0.3), \
            rng.uniform(0, 6.3)
        img[..., k] = 128 + 80 * np.sin(fx * x + fy * y + ph)
    for _ in range(3):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        img[y0:y0 + rng.randint(1, h + 1), x0:x0 + rng.randint(1, w + 1)] = \
            rng.uniform(0, 255, c)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# ------------------------------------------------------------ PNG

def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter_row(x, prev, bpp: int, t: int) -> np.ndarray:
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    b = prev
    if t == 0:
        pred = 0
    elif t == 1:
        pred = a
    elif t == 2:
        pred = b
    elif t == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, adaptive: bool = False
                 ) -> bytes:
    """Each row with a filter byte: the five filters in turn, or (adaptive)
    the one of least sum of absolute signed bytes, libpng's choice."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    prev = np.zeros(n, np.int32)
    out = []
    for r in range(h):
        if adaptive:
            cands = [_filter_row(x[r], prev, bpp, t) for t in range(5)]
            t = int(np.argmin([np.abs(f.view(np.int8).astype(np.int32)).sum()
                               for f in cands]))
            row = cands[t]
        else:
            t = r % 5
            row = _filter_row(x[r], prev, bpp, t)
        out.append(bytes([t]) + row.tobytes())
        prev = x[r]
    return b"".join(out)


def _png_bytes(sub: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] -> packed rows [h, rowbytes] (MSB first)."""
    h = sub.shape[0]
    if depth == 16:
        return sub.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return sub.astype(np.uint8).reshape(h, -1)
    vals = sub.reshape(h, -1).astype(np.uint8)
    bits = np.unpackbits(vals[..., None], axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def png(samples: np.ndarray, depth: int, color: int, interlace=False,
        trns=None, palette=None, adaptive=False) -> bytes:
    """samples [h, w] or [h, w, ch] -> a PNG; trns: the gray value, the RGB
    triple or the palette alphas; adaptive: libpng's filter choice."""
    sub = samples if samples.ndim == 3 else samples[..., None]
    h, w, ch = sub.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                               (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                               (0, 1, 1, 2)):
            part = sub[y0::dy, x0::dx]
            if part.size:
                raw += _filter_rows(_png_bytes(part, depth), bpp, adaptive)
    else:
        raw = _filter_rows(_png_bytes(sub, depth), bpp, adaptive)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body = bytes(np.asarray(trns, np.uint8)) if color == 3 else \
            struct.pack(f">{len(trns)}H", *trns)
        out += _chunk(b"tRNS", body)
    return (out + _chunk(b"IDAT", zlib.compress(raw, 9))
            + _chunk(b"IEND", b""))


def png_fixtures(rng) -> dict:
    out = {}
    rgb = scene(rng, 64, 96)
    gray = rgb[..., 1]
    for d in (1, 2, 4):
        g = gray[:37, :53] >> (8 - d)
        out[f"png_gray{d}.png"] = (f"PNG {d}-bit gray", png(g, d, 0))
        out[f"png_gray{d}_trns.png"] = (
            f"PNG {d}-bit gray with tRNS", png(g, d, 0, trns=[int(g[5, 7])]))
        idx = rng.randint(0, 1 << d, (29, 43))
        pal = rng.randint(0, 256, (1 << d, 3))
        out[f"png_palette{d}.png"] = (
            f"PNG {d}-bit palette", png(idx, d, 3, palette=pal))
    out["png_palette8_trns.png"] = (
        "PNG 8-bit palette with tRNS (indices unchanged)",
        png(rng.randint(0, 200, (21, 13)), 8, 3,
            palette=rng.randint(0, 256, (200, 3)),
            trns=rng.randint(0, 256, 50)))
    out["png_palette2_trns.png"] = (
        "PNG 2-bit palette with tRNS (indices unchanged)",
        png(rng.randint(0, 4, (13, 21)), 2, 3,
            palette=rng.randint(0, 256, (4, 3)), trns=[0, 255, 128]))
    g16 = (gray[:40, :50].astype(np.uint16) * 257
           + rng.randint(0, 256, (40, 50))).astype(np.uint16)
    rgb16 = (rgb[:21, :13].astype(np.uint16) * 257).astype(np.uint16)
    g8, rgb8 = gray[:45, :70].copy(), rgb[:33, :50].copy()
    rgb8[:5, :5] = (10, 20, 30)
    rgb16[:3, :4] = (1000, 2000, 3000)
    g16[7:9, :] = 4242
    out["png_gray8_trns.png"] = ("PNG 8-bit gray with tRNS",
                                 png(g8, 8, 0, trns=[int(g8[3, 3])]))
    out["png_gray16_trns.png"] = ("PNG 16-bit gray with tRNS",
                                  png(g16, 16, 0, trns=[4242]))
    out["png_rgb8_trns.png"] = ("PNG 8-bit RGB with tRNS",
                                png(rgb8, 8, 2, trns=[10, 20, 30]))
    out["png_rgb16_trns.png"] = ("PNG 16-bit RGB with tRNS",
                                 png(rgb16, 16, 2, trns=[1000, 2000, 3000]))
    # Adam7 at every depth and colour type, and at small sizes whose
    # later passes have no pixels.
    a = rgb[:37, :61]
    alpha = rng.randint(0, 256, a.shape[:2] + (1,))
    for name, form, data in (
            ("gray8", "gray", png(a[..., 0], 8, 0, True)),
            ("gray16", "16-bit gray",
             png(a[..., 0].astype(np.uint16) * 300, 16, 0, True)),
            ("rgb8", "RGB", png(a, 8, 2, True)),
            ("rgb16", "16-bit RGB",
             png(a.astype(np.uint16) * 257, 16, 2, True)),
            ("gray_alpha8", "gray + alpha",
             png(np.concatenate([a[..., :1], alpha], -1), 8, 4, True)),
            ("rgba8", "RGBA", png(np.concatenate([a, alpha], -1), 8, 6,
                                  True)),
            ("rgba16", "16-bit RGBA",
             png(np.concatenate([a, alpha], -1).astype(np.uint16) * 257,
                 16, 6, True)),
            ("gray1", "1-bit gray", png(a[..., 0] >> 7, 1, 0, True)),
            ("gray2_trns", "2-bit gray with tRNS",
             png(a[..., 0] >> 6, 2, 0, True, trns=[1])),
            ("gray4", "4-bit gray", png(a[..., 0] >> 4, 4, 0, True)),
            ("palette4", "4-bit palette",
             png(rng.randint(0, 16, (37, 61)), 4, 3, True,
                 palette=rng.randint(0, 256, (16, 3)))),
            ("rgb8_trns", "RGB with tRNS",
             png(a, 8, 2, True, trns=[int(v) for v in a[2, 2]]))):
        out[f"png_adam7_{name}.png"] = (f"PNG Adam7 {form}", data)
    for h, w in ((1, 1), (1, 9), (9, 1), (2, 2), (3, 5), (5, 3), (4, 4),
                 (6, 7), (7, 6), (8, 8), (9, 9)):
        tile = scene(rng, h, w)
        out[f"png_adam7_{h}x{w}.png"] = (
            f"PNG Adam7 RGB {h}x{w}", png(tile, 8, 2, True))
        out[f"png_adam7_gray1_{h}x{w}.png"] = (
            f"PNG Adam7 1-bit gray {h}x{w}", png(tile[..., 0] >> 7, 1, 0,
                                                 True))
    return out


# ------------------------------------------------------------ JPEG

def build_writer(tmp: Path) -> Path:
    exe = tmp / "jpeg_fixture_writer"
    subprocess.run(["cc", "-O2", "-o", str(exe), str(WRITER_SRC), "-ljpeg"],
                   check=True)
    return exe


def libjpeg(exe: Path, img: np.ndarray, **kw) -> bytes:
    """img uint8 [h, w, c] (or [h, w]) through libjpeg's encoder."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d) / "in.raw", Path(d) / "out.jpg"
        src.write_bytes(img.tobytes())
        subprocess.run([str(exe), str(src), str(dst), str(w), str(h), str(c)]
                       + [f"{k}={v}" for k, v in kw.items()], check=True)
        return dst.read_bytes()


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _markers(data: bytes):
    """(offset, marker, segment end) of each marker segment up to SOS's
    header, and the SOS's entropy-coded data start."""
    pos, out = 2, []
    while pos < len(data):
        assert data[pos] == 0xFF
        m = data[pos + 1]
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((pos, m, pos + 2 + n))
        pos += 2 + n
        if m == 0xDA:  # skip the entropy-coded data
            while not (data[pos] == 0xFF and data[pos + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                pos += 1
    return out


def drop_marker(data: bytes, marker: int) -> bytes:
    """The file without its segments of one marker type (DAC, APP14)."""
    for pos, m, end in reversed(_markers(data)):
        if m == marker:
            data = data[:pos] + data[end:]
    return data


def set_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    """The frame header's SOF marker or sample precision changed."""
    for pos, m, _ in _markers(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            b = bytearray(data)
            if marker is not None:
                b[pos + 1] = marker
            if precision is not None:
                b[pos + 4] = precision
            return bytes(b)
    raise AssertionError("no SOF")


def _huffman_codes(counts, symbols) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = format(code, f"0{length}b")
            code += 1
            k += 1
        code <<= 1
    return codes


def longer_eob_runs(data: bytes, run_bits: str, longer: str) -> bytes:
    """Each restart segment but the last of the file's AC scan of the
    band 1..1 ends with the EOB run whose r bits are `run_bits` (symbol
    r << 4); those bits become `longer`, a run past the segment's end,
    which a decoder drops at the restart marker."""
    r = len(run_bits)
    tables, out, last = {}, bytearray(), 0
    for pos, m, end in _markers(data):
        body = data[pos + 4:end]
        if m == 0xC4:
            i = 0
            while i < len(body):
                counts = body[i + 1:i + 17]
                tables[body[i]] = (counts, body[i + 17:i + 17 + sum(counts)])
                i += 17 + sum(counts)
        if m != 0xDA or body[1 + 2 * body[0]:3 + 2 * body[0]] != b"\x01\x01":
            continue
        code = _huffman_codes(*tables[0x10 | (body[2] & 15)])[r << 4]
        scan_end = next((p for p, _, _ in _markers(data) if p > end),
                        data.rindex(b"\xff\xd9"))
        rest = data[end:scan_end]
        segs = []
        i = 0
        while True:
            j = i
            while j < len(rest) and not (rest[j] == 0xFF and j + 1 < len(rest)
                                         and 0xD0 <= rest[j + 1] <= 0xD7):
                j += 1
            segs.append(rest[i:j])
            if j >= len(rest):
                break
            segs.append(rest[j:j + 2])
            i = j + 2
        new = []
        for k, seg in enumerate(segs):
            if k % 2 or k == len(segs) - 1:
                new.append(seg)
                continue
            raw = seg.replace(b"\xff\x00", b"\xff")
            bits = "".join(format(b, "08b") for b in raw).rstrip("1")
            assert bits.endswith(code + run_bits), "no EOB run at the end"
            bits = bits[:-r] + longer
            bits += "1" * (-len(bits) % 8)
            raw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
            new.append(raw.replace(b"\xff", b"\xff\x00"))
        out += data[last:end] + b"".join(new)
        last = scan_end
    assert last, "no AC scan of the band 1..1"
    return bytes(out + data[last:])


def eob_run_image(rng) -> np.ndarray:
    """Gray, 48 x 80: each block row has 4 blocks with a strong left-right
    ramp (AC01 nonzero) and then 6 flat blocks, so that its band 1..1
    ends with an EOB run of 6 (EOB2, bits 10)."""
    img = np.full((48, 80), 120, np.uint8)
    ramp = np.linspace(20, 230, 8)[None, :] + rng.normal(0, 2, (48, 8))
    for b in range(4):
        img[:, 8 * b:8 * b + 8] = np.clip(ramp, 0, 255)
    return img


# Lossless JPEG (SOF3), written here with one Huffman table: the
# difference categories 0..16, each a 5-bit code.
_DC_COUNTS = (0, 0, 0, 0, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
_DC_SYMS = tuple(range(17))


def _predict(psv, a, b, c):
    return {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
            6: b + ((a - c) >> 1), 7: (a + b) >> 1}[psv]


def _diffs(x: np.ndarray, psv: int, pt: int, interval: int,
           precision: int) -> np.ndarray:
    """The differences of samples x [h, w] (already >> pt)."""
    h, w = x.shape
    x = x.astype(np.int64)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pred = _predict(psv, a, b, c)
    pred[:, 0] = b[:, 0]
    first = np.arange(h) % interval == 0 if interval else np.arange(h) == 0
    pred[first] = a[first]
    pred[first, 0] = 1 << (precision - pt - 1)
    return x - pred


def _categories(d: np.ndarray) -> np.ndarray:
    """Each difference's category: the bit length of its magnitude."""
    return np.frexp(np.abs(d).astype(np.float64))[1].astype(np.int64)


def _optimal_table(cats: np.ndarray):
    """A Huffman table (counts by length, symbols) for these categories,
    with one code point kept out so that no code is all 1 bits."""
    freq = np.bincount(cats.ravel(), minlength=17)
    heap = [(int(f), k, (k,)) for k, f in enumerate(freq) if f] + \
        [(1, 17, (17,))]
    heapq.heapify(heap)
    length = dict.fromkeys(range(18), 0)
    while len(heap) > 1:
        fa, ka, sa = heapq.heappop(heap)
        fb, kb, sb = heapq.heappop(heap)
        for k in sa + sb:
            length[k] += 1
        heapq.heappush(heap, (fa + fb, min(ka, kb), sa + sb))
    syms = sorted((n, k) for k, n in length.items() if n and k < 17)
    assert max(n for n, _ in syms) <= 16, "a code longer than 16 bits"
    counts = [sum(1 for n, _ in syms if n == m) for m in range(1, 17)]
    return counts, [k for _, k in syms]


def _pack_fields(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Fields of lens[i] bits each (MSB first), padded with 1 bits to a
    byte and 0xFF stuffed."""
    bits, step = [], 1 << 20
    for lo in range(0, vals.size, step):
        v, n = vals[lo:lo + step], lens[lo:lo + step]
        idx = np.repeat(np.arange(v.size), n)
        pos = np.arange(idx.size) - np.repeat(np.cumsum(n) - n, n)
        bits.append(((v[idx] >> (n[idx] - 1 - pos)) & 1).astype(np.uint8))
    size = sum(b.size for b in bits)
    bits.append(np.ones(-size % 8, np.uint8))
    raw = np.packbits(np.concatenate(bits)).tobytes()
    return raw.replace(b"\xff", b"\xff\x00")


def lossless_jpeg(img: np.ndarray, psv, pt: int = 0, restart_rows: int = 0,
                  ids=(1, 2, 3, 4), jfif: bool = False, adobe=None,
                  separate: bool = False, sampling=None,
                  precision: int = 8, optimize: bool = False) -> bytes:
    """img uint8 [h, w] or [h, w, c] -> SOF3 with one interleaved scan (or
    one scan a component); psv one predictor or one a component; adobe an
    APP14 transform; optimize a Huffman table fitted to the file, else
    one 5-bit code a category."""
    sub = img if img.ndim == 3 else img[..., None]
    h, w, nc = sub.shape
    ids = ids[:nc]
    psvs = psv if isinstance(psv, tuple) else (psv,) * nc
    samp = sampling or [(1, 1)] * nc
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for k, (ch, cv) in enumerate(samp):
        p = sub[::vmax // cv, ::hmax // ch, k] >> pt
        planes.append(p)

    def units(comps, interval_mcus, mcus_row, rows_of):
        """The scan's differences in decode order, [MCUs, units an MCU]."""
        out = []
        for k in comps:
            ch, cv = samp[k] if len(comps) > 1 else (1, 1)
            p = planes[k]
            rows = interval_mcus // mcus_row * cv if interval_mcus else 0
            dd = _diffs(p, psvs[k], pt, rows, precision)
            ph, pw = (mcuy * cv, mcux * ch) if len(comps) > 1 else p.shape
            full = np.zeros((ph, pw), np.int64)
            full[:dd.shape[0], :dd.shape[1]] = dd
            out.append(full.reshape(rows_of, cv, mcus_row, ch).transpose(
                0, 2, 1, 3).reshape(rows_of * mcus_row, cv * ch))
        return np.concatenate(out, 1)

    def entropy(d, interval_mcus, codes):
        s = _categories(d)
        mag = np.where(d > 0, d, d + (1 << s) - 1)
        code = np.array([int(codes.get(k, "0"), 2) for k in range(17)])
        clen = np.array([len(codes.get(k, "")) for k in range(17)])
        vals = ((code[s] << s) | mag).reshape(d.shape[0], -1)
        lens = (clen[s] + s).reshape(d.shape[0], -1)
        step = interval_mcus or d.shape[0]
        out = b""
        for rst, lo in enumerate(range(0, d.shape[0], step)):
            if lo:
                out += bytes([0xFF, 0xD0 + (rst - 1) % 8])
            out += _pack_fields(vals[lo:lo + step].ravel(),
                                lens[lo:lo + step].ravel())
        return out

    scans = []
    for comps in [[k] for k in range(nc)] if separate else [list(range(nc))]:
        if len(comps) > 1:
            mcus_row, rows_of = mcux, mcuy
        else:
            mcus_row, rows_of = planes[comps[0]].shape[::-1]
        interval = restart_rows * mcus_row
        scans.append((comps, interval,
                      units(comps, interval, mcus_row, rows_of)))
    counts, syms = _optimal_table(np.concatenate(
        [_categories(d).ravel() for *_, d in scans])) if optimize else \
        (_DC_COUNTS, _DC_SYMS)
    codes = _huffman_codes(counts, syms)

    head = b"\xff\xd8"
    if jfif:
        head += b"\xff\xe0" + struct.pack(">H", 16) + \
            b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    if adobe is not None:
        head += b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + \
            bytes([0, 100, 0, 0, 0, 0, adobe])
    dht = bytes([0x00]) + bytes(counts) + bytes(syms)
    head += b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht
    sof = struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([ids[k], samp[k][0] << 4 | samp[k][1], 0]) for k in range(nc))
    head += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    for comps, interval, d in scans:
        if interval:
            head += b"\xff\xdd\x00\x04" + struct.pack(">H", interval)
        sos = bytes([len(comps)]) + b"".join(bytes([ids[k], 0x00])
                                             for k in comps) + bytes(
            [psvs[comps[0]], 0, pt])
        head += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
        head += entropy(d, interval, codes)
    return head + b"\xff\xd9"


def jpeg_fixtures(rng, exe: Path) -> dict:
    out = {}
    img = scene(rng, 64, 96)
    odd = scene(rng, 13, 21)
    two = scene(rng, 24, 30)  # 4:2:0 chroma two blocks wide and high
    gray = scene(rng, 37, 45, 1)[..., 0]

    def put(name, form, data):
        out[name] = (form, data)

    # Progressive Huffman.
    put("jpeg_prog_420.jpg", "progressive JPEG 4:2:0 (PIL)",
        pil_jpeg(img, quality=85, progressive=True))
    put("jpeg_prog_444_odd.jpg", "progressive JPEG 4:4:4 13x21 (PIL)",
        pil_jpeg(odd, quality=90, progressive=True, subsampling=0))
    put("jpeg_prog_gray.jpg", "progressive JPEG gray (PIL)",
        pil_jpeg(gray, quality=75, progressive=True))
    put("jpeg_prog_restart.jpg", "progressive JPEG with restarts",
        libjpeg(exe, img, progressive=1, restart=2))
    put("jpeg_prog_stop_al1.jpg",
        "progressive JPEG whose AC stops at Al 1 (smoothed)",
        libjpeg(exe, img, scans="0,1,2:0:0:0:0;0:1:63:0:1;1:1:63:0:1;"
                "2:1:63:0:1"))
    put("jpeg_prog_stop_al1_two_blocks.jpg",
        "progressive JPEG stopping at Al 1 with chroma two blocks wide",
        libjpeg(exe, two, scans="0,1,2:0:0:0:0;0:1:63:0:1;1:1:63:0:1;"
                "2:1:63:0:2"))
    put("jpeg_prog_dc_only_chroma.jpg",
        "progressive JPEG, chroma DC only (DC smoothed)",
        libjpeg(exe, img, scans="0,1,2:0:0:0:1;0:1:5:0:2;0:6:63:0:0;"
                "0,1,2:0:0:1:0"))
    put("jpeg_prog_odd_script.jpg",
        "progressive JPEG, separate DC scans, refinements, 4:2:2, restarts",
        libjpeg(exe, odd, sampling="2x1,1x1,1x1", restart=1,
                scans="0:0:0:0:2;1:0:0:0:1;2:0:0:0:0;0:1:9:0:3;"
                "0:10:63:0:1;1:1:63:0:0;2:1:2:0:1;2:3:63:0:0;0:1:9:3:2;"
                "0:10:63:1:0;0:0:0:2:1;2:1:2:1:0;1:0:0:1:0;0:0:0:1:0"))
    eob = libjpeg(exe, eob_run_image(rng), restart_rows=1,
                  scans="0:0:0:0:0;0:1:1:0:0;0:2:63:0:1;0:2:63:1:0")
    put("jpeg_prog_eob_past_restart.jpg",
        "progressive JPEG with EOB runs past restart markers",
        longer_eob_runs(eob, "10", "11"))
    # Arithmetic coding.
    put("jpeg_arith_420.jpg", "arithmetic-coded JPEG 4:2:0",
        libjpeg(exe, img, arith=1))
    put("jpeg_arith_gray_restart.jpg",
        "arithmetic-coded JPEG gray with restarts",
        libjpeg(exe, gray, arith=1, restart=3))
    put("jpeg_arith_dac.jpg", "arithmetic-coded JPEG with DAC (2, 5, 3)",
        libjpeg(exe, odd, arith=1, dac="2,5,3", sampling="1x1,1x1,1x1"))
    put("jpeg_arith_no_dac.jpg", "arithmetic-coded JPEG without DAC",
        drop_marker(libjpeg(exe, odd, arith=1), 0xCC))
    put("jpeg_arith_prog.jpg", "arithmetic-coded progressive JPEG",
        libjpeg(exe, img, arith=1, progressive=1))
    put("jpeg_arith_prog_restart.jpg",
        "arithmetic-coded progressive JPEG with restarts",
        libjpeg(exe, odd, arith=1, progressive=1, restart=1))
    put("jpeg_arith_prog_stop_al1.jpg",
        "arithmetic-coded progressive JPEG stopping at Al 1 (smoothed)",
        libjpeg(exe, img, arith=1, restart=4,
                scans="0,1,2:0:0:0:1;0:1:63:0:2;1:1:63:0:1;2:1:63:0:0;"
                "0,1,2:0:0:1:0;0:1:63:2:1"))
    # Lossless.
    lgray = scene(rng, 29, 37, 1)[..., 0]
    lrgb = scene(rng, 21, 27)
    for psv in range(1, 8):
        put(f"jpeg_lossless_p{psv}.jpg", f"lossless JPEG predictor {psv}",
            lossless_jpeg(lgray, psv))
    put("jpeg_lossless_rgb.jpg", "lossless JPEG RGB, ids 1 2 3",
        lossless_jpeg(lrgb, 4))
    put("jpeg_lossless_pt_restart.jpg",
        "lossless JPEG, point transform 2, restarts every 3 rows",
        lossless_jpeg(lgray, 7, pt=2, restart_rows=3))
    put("jpeg_lossless_separate.jpg",
        "lossless JPEG, one scan a component, predictors 2, 6, 5",
        lossless_jpeg(lrgb, (2, 6, 5), separate=True, restart_rows=2))
    put("jpeg_lossless_subsampled.jpg", "lossless JPEG with 2x2 chroma",
        lossless_jpeg(lrgb, 1, sampling=[(2, 2), (1, 1), (1, 1)],
                      restart_rows=4))
    lcmyk = scene(rng, 17, 19, 4)
    put("jpeg_lossless_cmyk.jpg", "lossless JPEG CMYK (Adobe transform 0)",
        lossless_jpeg(lcmyk, 3, adobe=0))
    put("jpeg_lossless_cmyk_no_adobe.jpg",
        "lossless JPEG of four components without an Adobe marker",
        lossless_jpeg(lcmyk, 5))
    # Four components, and two of no colour.
    cmyk = scene(rng, 27, 35, 4)
    put("jpeg_cmyk.jpg", "CMYK JPEG (Adobe transform 0)",
        libjpeg(exe, cmyk, space="cmyk"))
    put("jpeg_cmyk_no_adobe.jpg", "CMYK JPEG without an Adobe marker",
        drop_marker(libjpeg(exe, cmyk, space="cmyk"), 0xEE))
    put("jpeg_ycck.jpg", "YCCK JPEG (Adobe transform 2)",
        libjpeg(exe, cmyk, space="ycck"))
    put("jpeg_ycck_420_prog.jpg", "YCCK JPEG, 2x2 luma, progressive",
        libjpeg(exe, cmyk, space="ycck", progressive=1,
                sampling="2x2,1x1,1x1,2x2"))
    put("jpeg_two_components.jpg", "JPEG of two components of no colour",
        libjpeg(exe, scene(rng, 19, 23, 2), space="unknown"))
    # What the JAX package refuses.
    base = pil_jpeg(odd, quality=80)
    put("jpeg_hierarchical.jpg", "hierarchical JPEG (SOF5)",
        set_sof(base, marker=0xC5))
    put("jpeg_12bit.jpg", "12-bit JPEG", set_sof(base, precision=12))
    put("jpeg_lossless_arith.jpg", "arithmetic-coded lossless JPEG (SOF11)",
        set_sof(lossless_jpeg(lgray, 1), marker=0xCB))
    put("jpeg_lossless_12bit.jpg", "12-bit lossless JPEG",
        lossless_jpeg(lgray.astype(np.uint16) * 16, 1, precision=12))
    put("jpeg_lossless_jfif.jpg",
        "lossless JPEG with JFIF (YCbCr, no conversion in lossless mode)",
        lossless_jpeg(lrgb, 1, jfif=True))
    put("jpeg_lossless_ycck.jpg", "lossless JPEG YCCK (Adobe transform 2)",
        lossless_jpeg(lcmyk, 1, adobe=2))
    put("jpeg_lossless_two_components.jpg",
        "lossless JPEG of two components", lossless_jpeg(lrgb[..., :2], 1))
    return out


def full_size_fixtures(frame: np.ndarray, exe: Path) -> dict:
    """One 1920x1080 file of each form a user's frame may come in, from
    the VIPER scene's first frame (uint8 RGB [1080, 1920, 3])."""
    cmyk = np.concatenate([255 - frame, frame.min(-1, keepdims=True)], -1)
    return {
        "viper_arith_00010.jpg": (
            "arithmetic-coded JPEG 1920x1080 4:2:0",
            libjpeg(exe, frame, quality=85, arith=1)),
        "viper_arith_prog_00010.jpg": (
            "arithmetic-coded progressive JPEG 1920x1080 4:2:0",
            libjpeg(exe, frame, quality=85, arith=1, progressive=1)),
        "viper_lossless_00010.jpg": (
            "lossless JPEG RGB 1920x1080, predictor 1",
            lossless_jpeg(frame, 1, optimize=True)),
        "viper_ycck_00010.jpg": (
            "YCCK JPEG 1920x1080 (Adobe transform 2)",
            libjpeg(exe, cmyk, quality=85, space="ycck")),
        "viper_adam7_00010.png": (
            "PNG Adam7 RGB 1920x1080", png(frame, 8, 2, True, adaptive=True))}


# ------------------------------------------------------------ oracle

def _describe(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def witnesses(data: bytes) -> dict:
    """What the JAX package's native core and PIL make of the bytes, and
    which of them its load returns (the core's unless it refuses)."""
    core = jax_imgio._get()
    out = {}
    try:
        pix, h, w, c, bps = core.decode(data)
        arr = np.frombuffer(pix, np.uint16 if bps == 2 else np.uint8)
        out["native"] = _describe(arr.reshape(h, w) if c == 1
                                  else arr.reshape(h, w, c))
    except ValueError as e:
        out["native"] = {"error": str(e)}
    try:
        out["pil"] = _describe(np.array(Image.open(io.BytesIO(data))))
    except Exception as e:  # noqa: BLE001 - PIL raises several kinds
        msg = re.sub(r" at 0x[0-9a-f]+", "", str(e))  # an object's address
        out["pil"] = {"error": f"{type(e).__name__}: {msg}"}
    out["agree"] = "error" not in out["native"] and \
        out["native"] == out["pil"]
    out["load"] = "native" if "error" not in out["native"] else \
        "pil" if "error" not in out["pil"] else None
    return out


# The files meant to be refused: both of the JAX package's decoders.
REFUSED = ("jpeg_hierarchical.jpg", "jpeg_12bit.jpg",
           "jpeg_lossless_arith.jpg", "jpeg_lossless_12bit.jpg",
           "jpeg_lossless_jfif.jpg", "jpeg_lossless_ycck.jpg",
           "jpeg_lossless_two_components.jpg")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(ROOT / "tests" / "data"))
    out = Path(p.parse_args().out)
    if not jax_imgio.available() and not jax_imgio.build():
        raise SystemExit("the JAX package's native image core does not build")
    rng = np.random.RandomState(2022)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_writer(Path(tmp))
        files = png_fixtures(rng)
        files.update(jpeg_fixtures(rng, exe))
        frames = make_jpeg_fixtures.frames()
        files.update(full_size_fixtures(frames[0], exe))
    for i, img in enumerate(frames):
        files[f"viper_prog_000{10 + i}.jpg"] = (
            "progressive JPEG 1920x1080 4:2:0 (PIL)",
            pil_jpeg(img, quality=85, progressive=True))
    folder = out / "formats"
    folder.mkdir(parents=True, exist_ok=True)
    meta = {}
    for name, (form, data) in files.items():
        (folder / name).write_bytes(data)
        meta[name] = {"form": form, "bytes": len(data), **witnesses(data)}
        if (meta[name]["load"] is None) != (name in REFUSED):
            raise SystemExit(f"{name}: the JAX package gives "
                             f"{meta[name]['load']}, not what was meant")
    (out / "image_formats.json").write_text(json.dumps(meta, indent=1)
                                            + "\n")
    for name, m in meta.items():
        print(f"{name:40s} load={m['load']!s:6s} agree={m['agree']!s:5s} "
              f"{m['form']}")


if __name__ == "__main__":
    main()
