"""Progressive JPEG: the four kinds of Huffman-coded scan (T.81 G.1.2,
libjpeg's ``jdphuff.c``) and the block smoothing libjpeg applies to the
coefficients that the scans leave inexact (``jdcoefct.c``,
``decompress_smooth_data``, libjpeg-turbo 2.1's 5x5 form).

A scan fills the frame's coefficient store (``imgio._alloc_planes``)
that lives across scans:

  * DC first (Ss = 0, Ah = 0): the differences as in a sequential scan,
    shifted left by Al; interleaved or one component.
  * DC refine (Ss = 0, Ah > 0): one bit a block, or-ed in at Al.
  * AC first (Ss > 0, Ah = 0): one component, its band Ss..Se with EOB
    runs (EOBn: 2^n + n more bits of blocks with nothing in the band).
  * AC refine (Ss > 0, Ah > 0): each new coefficient is +-2^Al; every
    coefficient already nonzero that the decoder passes takes a correction
    bit, also in the blocks of an EOB run.

A restart marker resets the DC predictions and the EOB run.  Every
function takes one restart segment: ``win`` is ``imgio._windows`` of its
bytes, ``bits`` its bits one a byte, and ``blocks`` its blocks' offsets
into the store in decode order.
"""

from __future__ import annotations

import numpy as np

from craft_tpu_torch.data.imgio import _ZIGZAG, _windows


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def dc_first(win, blocks, cidx, luts, cf, al: int) -> None:
    pred = [0] * len(luts)
    p = 0
    try:
        for ci, base in zip(cidx, blocks):
            e = luts[ci][win[p]]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            p += e >> 8
            s = e & 15
            if s:
                pred[ci] += _extend(win[p] >> (16 - s), s)
                p += s
            cf[base] = pred[ci] << al
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None


def dc_refine(bits: np.ndarray, blocks: np.ndarray, coef: np.ndarray,
              al: int) -> None:
    if bits.size < blocks.size:
        raise ValueError("JPEG: entropy-coded data ends early")
    coef[blocks[bits[:blocks.size] == 1]] |= 1 << al


def ac_first(win, blocks, lut, cf, ss: int, se: int, al: int) -> None:
    """An EOB run past the segment's end is dropped: a restart ends it."""
    zz = _ZIGZAG
    p, i, n = 0, 0, len(blocks)
    try:
        while i < n:
            base = blocks[i]
            k = ss
            while k <= se:
                e = lut[win[p]]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    cf[base + zz[k]] = _extend(win[p] >> (16 - s), s) << al
                    p += s
                    k += 1
                elif r == 15:
                    k += 16
                else:  # EOBr: this block and 2^r - 1 + (r bits) more
                    run = 1 << r
                    if r:
                        run += win[p] >> (16 - r)
                        p += r
                    i += run - 1
                    break
            i += 1
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None


def ac_refine(win, bits, blocks, lut, coef, ss: int, se: int,
              al: int) -> None:
    """The symbols walk the band in Python; each block's tail after its
    last symbol (all of a block in an EOB run) holds one correction bit per
    coefficient nonzero before the scan, at consecutive bit positions, and
    is applied at the end with numpy."""
    zz = _ZIGZAG
    band = np.asarray(zz[ss:se + 1])
    blocks = np.asarray(blocks, np.int64)
    nz = coef[blocks[:, None] + band[None, :]] != 0   # [blocks, band]
    # Nonzeros of each block from band index k on (flat, k = band.size: 0),
    # and before block b (prefix over the blocks).
    suffix = np.zeros((blocks.size, band.size + 1), np.int64)
    suffix[:, :-1] = np.cumsum(nz[:, ::-1], 1)[:, ::-1]
    suffix = suffix.reshape(-1)
    before = np.concatenate([[0], np.cumsum(suffix[::band.size + 1])])
    # After the symbols of block b, bits tail_p[b]... go to its nonzero
    # coefficients at band index tail_k[b] and on.
    tail_k = np.full(blocks.size, band.size, np.int64)
    tail_p = np.zeros(blocks.size, np.int64)
    cf = memoryview(coef)
    p1, m1 = 1 << al, -1 << al
    p, i, n = 0, 0, blocks.size
    base_of = blocks.tolist()
    try:
        while i < n:
            base = base_of[i]
            k = ss
            eobrun = 0
            while k <= se:
                e = lut[win[p]]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    new = p1 if win[p] >> 15 else m1
                    p += 1
                else:
                    new = 0
                    if r != 15:  # EOBr
                        eobrun = 1 << r
                        if r:
                            eobrun += win[p] >> (16 - r)
                            p += r
                        break
                # Pass r zero coefficients (ZRL: 16), correcting nonzeros.
                while k <= se:
                    pos = base + zz[k]
                    c = cf[pos]
                    if c:
                        if win[p] >> 15 and not c & p1:
                            cf[pos] = c + (p1 if c >= 0 else m1)
                        p += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if new:
                    cf[base + zz[k]] = new
                k += 1
            if not eobrun:
                i += 1
                continue
            # This block's tail, then eobrun - 1 whole blocks.
            tail_k[i], tail_p[i] = k - ss, p
            p += int(suffix[i * (band.size + 1) + k - ss])
            j = min(n, i + eobrun)
            if j > i + 1:
                tail_k[i + 1:j] = 0
                tail_p[i + 1:j] = p + before[i + 1:j] - before[i + 1]
                p += int(before[j] - before[i + 1])
            i = j
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends early") from None
    if p > bits.size:
        raise ValueError("JPEG: entropy-coded data ends early")
    _apply_corrections(coef, blocks, band, nz, tail_k, tail_p, bits, al)


def _apply_corrections(coef, blocks, band, nz, tail_k, tail_p, bits,
                       al: int) -> None:
    """Each block's correction bits from tail_p on, one per coefficient
    nonzero before the scan at band index tail_k and on: a 1 adds 2^Al to
    its magnitude."""
    sel = nz & (np.arange(band.size)[None, :] >= tail_k[:, None])
    at = tail_p[:, None] + np.cumsum(sel, 1) - 1
    b, j = np.nonzero(sel)
    up = bits[at[b, j]] == 1
    pos = blocks[b[up]] + band[j[up]]
    c = coef[pos]
    p1 = 1 << al
    keep = (c & p1) == 0
    coef[pos[keep]] = c[keep] + np.where(c[keep] >= 0, p1, -p1)


def decode_scan(segs, scomps, order, coef, dc_luts, ac_luts, ss: int,
                se: int, ah: int, al: int, restart: int) -> None:
    """One progressive Huffman scan over its restart segments."""
    bases, cidx, per_mcu = order
    seg_blocks = restart * per_mcu if restart else bases.size
    cf = memoryview(coef)
    for s, seg in enumerate(segs):
        lo = s * seg_blocks
        part = bases[lo:lo + seg_blocks]
        if not part.size:
            break
        if ss == 0 and ah:
            dc_refine(np.unpackbits(seg), part, coef, al)
        elif ss == 0:
            dc_first(_windows(seg), part.tolist(),
                     cidx[lo:lo + seg_blocks].tolist(), dc_luts, cf, al)
        elif ah:
            ac_refine(_windows(seg), np.unpackbits(seg), part, ac_luts[0],
                      coef, ss, se, al)
        else:
            ac_first(_windows(seg), part.tolist(), ac_luts[0], cf, ss, se,
                     al)


# ------------------------------------------------------- block smoothing

# (zigzag index, natural index) of the coefficients smoothing estimates:
# AC01 AC10 AC20 AC11 AC02, and with the DC interpolated, AC03 AC12 AC21
# AC30.
_SMOOTHED = ((1, 1), (2, 8), (3, 16), (4, 9), (5, 2), (6, 3), (7, 10),
             (8, 17), (9, 24))


def _w(rows) -> np.ndarray:
    return np.array(rows, np.int64).reshape(5, 5)


# Weights over the 5 x 5 DC neighbourhood (rows above to below, columns
# left to right), as libjpeg-turbo 2.1 writes them out term by term.
_AC_WEIGHTS = {
    1: _w([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
           0, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
    2: _w([0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
           0, 0, -50, 0, 0, 0, 0, 7, 0, 0]),
    3: _w([0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
           0, 0, 13, 0, 0, 0, 0, -1, 0, 0]),
    4: _w([0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
           1, -10, 0, 10, -1, 0, 1, 0, -1, 0]),
    5: _w([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1,
           0, 0, 0, 0, 0, 0, 0, 0, 0, 0]),
}
_DC_INTERP_WEIGHTS = {
    1: _w([-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
           -3, 13, 0, -13, 3, -1, -1, 0, 1, 1]),
    2: _w([-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
           1, -13, -38, -13, 1, 1, 3, 3, 3, 1]),
    3: _w([0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
           0, 2, 7, 2, 0, 0, 0, 1, 0, 0]),
    4: _w([-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
           0, -9, 0, 9, 0, 1, 0, 0, 0, -1]),
    5: _w([0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
           0, 2, -5, 2, 0, 0, 0, 0, 0, 0]),
    6: _w([0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
           0, 1, 0, -1, 0, 0, 0, 0, 0, 0]),
    7: _w([0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
           0, -1, 3, -1, 0, 0, 0, 0, 0, 0]),
    8: _w([0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
           0, 1, 0, -1, 0, 0, 0, 0, 0, 0]),
    9: _w([0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
           0, -1, -2, -1, 0, 0, 0, 0, 0, 0]),
    0: _w([-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
           -6, 6, 42, 6, -6, -2, -6, -8, -6, -2]),
}


def smoothing_applies(comps) -> bool:
    """libjpeg's smoothing_ok: every component has its DC at least in part
    and some component has one of its first nine AC coefficients inexact
    (not yet sent, or sent down to Al > 0)."""
    if any(c["coef_bits"][0] < 0 for c in comps):
        return False
    return any((c["coef_bits"][1:10] != 0).any() for c in comps)


def _block_rows(c, vmax_rows: int) -> np.ndarray:
    """The block rows libjpeg reads two above to two below each block row
    of component c, [5, rows]: the edge rows repeated, and, within the
    first and last two iMCU rows of a component of v > 1 block rows an
    iMCU row, libjpeg's nearer row in place of one two away."""
    v, rows = c["v"], c["rows"]
    last = vmax_rows - 1
    r = np.arange(rows)
    imcu, br = r // v, r % v
    nrows = np.where(imcu == last, rows - last * v, v)
    prev = np.where((br > 0) | (imcu > 0), r - 1, r)
    prev2 = np.where((br > 1) | (imcu > 1), r - 2, prev)
    nxt = np.where((br < nrows - 1) | (imcu < last), r + 1, r)
    nxt2 = np.where((br < nrows - 2) | (imcu + 1 < last), r + 2, nxt)
    return np.stack([prev2, prev, r, nxt, nxt2])


def _block_cols(cols: int) -> np.ndarray:
    """The block columns libjpeg reads two left to two right of each block
    column, [5, cols]: its sliding registers, filled with column 0 and at
    the first block with the next column's value in the fourth alone, so
    that a component two blocks wide sees column 0 again past column 1."""
    reg, out, last = [0] * 5, [], cols - 1
    for j in range(cols):
        if j == 0 and j < last:
            reg[3] = 1
        if j + 1 < last:
            reg[4] = j + 2
        out.append(reg)
        reg = reg[1:] + reg[4:]
    return np.array(out).T


def smooth(blocks: np.ndarray, qt: np.ndarray, c, imcu_rows: int
           ) -> np.ndarray:
    """Component c's quantised blocks [rows, cols, 64] (natural order)
    with the estimates of ``decompress_smooth_data``: each of the first
    nine AC coefficients that is zero and not exact takes a prediction
    from the DC values around it, capped below 2^Al; when no AC
    coefficient of the component has come at all, the DC too."""
    bits = c["coef_bits"]
    out = blocks.copy()
    rows, cols = blocks.shape[:2]
    dc = blocks[..., 0].astype(np.int64)
    ri = _block_rows(c, imcu_rows)
    ci = _block_cols(cols)
    nb = dc[ri[:, None, :, None], ci[None, :, None, :]]  # [5, 5, rows, cols]
    change_dc = bool((bits[1:10] == -1).all())
    weights = _DC_INTERP_WEIGHTS if change_dc else _AC_WEIGHTS
    q00 = int(qt[0])
    for zk, nat in _SMOOTHED:
        al = int(bits[zk])
        if zk not in weights or al == 0:
            continue
        num = q00 * np.einsum("ij,ijrc->rc", weights[zk], nb)
        q = int(qt[nat])
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        zero = out[..., nat] == 0
        out[..., nat] = np.where(zero, pred, out[..., nat])
    if change_dc:
        num = q00 * np.einsum("ij,ijrc->rc", weights[0], nb)
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[..., 0] = np.where(num >= 0, pred, -pred)
    return out
