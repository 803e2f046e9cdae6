"""Lossless JPEG (SOF3, Huffman-coded; T.81 Annex H), as the JAX package
decodes it: its libjpeg has no lossless decoder, so its ``load`` falls
back to PIL, whose libjpeg-turbo (3.x) has one (``jdlhuff.c``,
``jdlossls.c``, ``jddiffct.c``).  8-bit samples, predictors 1-7 and a
point transform Pt.

A scan codes each sample's difference from a prediction as a DC
difference is coded (a category, then its bits; category 16 is 32768
with no bits).  The store holds the differences; ``samples`` undoes the
prediction, modulo 2^16 as libjpeg does:

  * the first row of the image, and of each restart interval: the left
    sample, and 2^(P - Pt - 1) for the first;
  * the first column of every other row: the sample above;
  * elsewhere the scan's predictor of the left (a), upper (b) and
    upper-left (c) samples: a, b, c, a + b - c, a + ((b - c) >> 1),
    b + ((a - c) >> 1), (a + b) >> 1.

Then each sample is shifted left by Pt.
"""

from __future__ import annotations

import numpy as np

from craft_tpu_torch.data.imgio import _windows

PRECISION = 8


def _predict(psv: int, a, b, c):
    if psv == 1:
        return a
    if psv == 2:
        return b
    if psv == 3:
        return c
    if psv == 4:
        return a + b - c
    if psv == 5:
        return a + ((b - c) >> 1)
    if psv == 6:
        return b + ((a - c) >> 1)
    return (a + b) >> 1


def _undifference(d: np.ndarray, psv: int, pt: int) -> np.ndarray:
    """One restart interval's differences [rows, cols] -> samples.  Rows
    after the first go by anti-diagonals: a sample needs its left, upper
    and upper-left neighbours, so the samples of one diagonal are
    independent."""
    rows, cols = d.shape
    x = np.zeros((rows, cols), np.int64)
    first = d[0].copy()
    first[0] += 1 << (PRECISION - pt - 1)
    x[0] = np.cumsum(first) & 0xFFFF
    for t in range(1, rows + cols - 1):
        i = np.arange(max(1, t - cols + 1), min(rows - 1, t) + 1)
        if not i.size:
            continue
        j = t - i
        b = x[i - 1, j]
        jl = np.maximum(j - 1, 0)
        pred = np.where(j == 0, b, _predict(psv, x[i, jl], b, x[i - 1, jl]))
        x[i, j] = (d[i, j] + pred) & 0xFFFF
    return x


def decode_scan(segs, frame, scomps, order, dc_luts, restart: int,
                psv: int, se: int, ah: int, pt: int) -> None:
    """One lossless scan (Ss the predictor, Al the point transform): its
    differences into the frame's store, and for each of its components
    the predictor, Pt and rows a restart interval that ``samples``
    needs."""
    if not 1 <= psv <= 7 or se or ah or pt >= PRECISION:
        raise ValueError(f"JPEG: a lossless scan of predictor {psv}, Se "
                         f"{se}, Ah {ah}, Pt {pt} is not valid")
    bases, cidx, per_mcu = order
    mcus_row = frame["mcu"][0] if len(scomps) > 1 else scomps[0]["cols"]
    if restart % mcus_row:
        raise ValueError("JPEG: a lossless restart interval that is not "
                         "whole MCU rows")
    for c in scomps:
        v = c["v"] if len(scomps) > 1 else 1
        c["lossless"] = (psv, pt, restart // mcus_row * v)
    seg_units = restart * per_mcu if restart else bases.size
    cf = memoryview(frame["coef"])
    for s, seg in enumerate(segs):
        lo = s * seg_units
        part = bases[lo:lo + seg_units].tolist()
        if not part:
            break
        win, p = _windows(seg), 0
        try:
            for ci, base in zip(cidx[lo:lo + seg_units].tolist(), part):
                e = dc_luts[ci][win[p]]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 8
                n = e & 255
                if n == 16:
                    v = 32768
                elif n:
                    v = win[p] >> (16 - n)
                    p += n
                    if v < (1 << (n - 1)):
                        v -= (1 << n) - 1
                else:
                    v = 0
                cf[base] = v
        except IndexError:
            raise ValueError("JPEG: entropy-coded data ends early") from None


def samples(frame) -> list:
    """Each component's 8-bit samples [dh, dw] from its differences."""
    out = []
    for c in frame["comps"]:
        if "lossless" not in c:
            raise ValueError("JPEG: a component with no scan")
        psv, pt, interval = c["lossless"]
        d = frame["coef"][c["off"]:c["off"] + c["bw"] * c["bh"]].reshape(
            c["bh"], c["bw"])[:c["dh"], :c["dw"]].astype(np.int64)
        step = interval or c["dh"]
        x = np.concatenate([_undifference(d[r:r + step], psv, pt)
                            for r in range(0, c["dh"], step)])
        out.append(((x << pt) & 0xFF).astype(np.uint8))
    return out
