"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive): the QM
decoder of T.81 Annex D with the DC and AC statistics of Annex F and the
progressive procedures of Annex G, as libjpeg's ``jdarith.c`` runs them.

The coefficients go to the same store, and from there through the same
dequantisation, IDCT, upsampling and colour conversion, as a Huffman
file's (``imgio``); only the entropy decoding differs.  Each restart
segment starts a fresh decoder (C = 0, A = 0, two bytes read) and zeroes
the statistics of the scan's tables and the DC predictions; past the
segment's end (a marker) the decoder reads zeros.  ``DAC`` sets the
conditioning of a table: (L, U) for DC (default (0, 1)), Kx for AC
(default 5).
"""

from __future__ import annotations

from craft_tpu_torch.data.imgio import _ZIGZAG

# T.81 Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS, Next_Index_MPS
# and Switch_MPS of each state; state 113 is libjpeg's fixed probability
# 0.5, which never changes.
_QE = (0x5A1D, 0x2586, 0x1114, 0x080B, 0x03D8, 0x01DA, 0x00E5, 0x006F,
       0x0036, 0x001A, 0x000D, 0x0006, 0x0003, 0x0001, 0x5A7F, 0x3F25,
       0x2CF2, 0x207C, 0x17B9, 0x1182, 0x0CEF, 0x09A1, 0x072F, 0x055C,
       0x0406, 0x0303, 0x0240, 0x01B1, 0x0144, 0x00F5, 0x00B7, 0x008A,
       0x0068, 0x004E, 0x003B, 0x002C, 0x5AE1, 0x484C, 0x3A0D, 0x2EF1,
       0x261F, 0x1F33, 0x19A8, 0x1518, 0x1177, 0x0E74, 0x0BFB, 0x09F8,
       0x0861, 0x0706, 0x05CD, 0x04DE, 0x040F, 0x0363, 0x02D4, 0x025C,
       0x01F8, 0x01A4, 0x0160, 0x0125, 0x00F6, 0x00CB, 0x00AB, 0x008F,
       0x5B12, 0x4D04, 0x412C, 0x37D8, 0x2FE8, 0x293C, 0x2379, 0x1EDF,
       0x1AA9, 0x174E, 0x1424, 0x119C, 0x0F6B, 0x0D51, 0x0BB6, 0x0A40,
       0x5832, 0x4D1C, 0x438E, 0x3BDD, 0x34EE, 0x2EAE, 0x299A, 0x2516,
       0x5570, 0x4CA9, 0x44D9, 0x3E22, 0x3824, 0x32B4, 0x2E17, 0x56A8,
       0x4F46, 0x47E5, 0x41CF, 0x3C3D, 0x375E, 0x5231, 0x4C0F, 0x4639,
       0x415E, 0x5627, 0x50E7, 0x4B85, 0x5597, 0x504F, 0x5A10, 0x5522,
       0x59EB, 0x5A1D)
_NLPS = (1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38,
         39, 40, 42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63,
         32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48,
         50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82,
         83, 84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91,
         92, 93, 86, 88, 95, 96, 97, 99, 99, 93, 95, 101, 102, 103, 104, 99,
         105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113)
_NMPS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16, 17, 18, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
         54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70,
         71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87,
         71, 89, 90, 91, 92, 93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103,
         104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113)
_SWITCH = frozenset((0, 14, 36, 64, 80, 88, 95, 105, 110, 112))
# After an LPS: the next state with the MPS sense (bit 7) flipped where
# Switch_MPS is set; after an MPS, the next state.
_AFTER_LPS = tuple(n | (0x80 if i in _SWITCH else 0)
                   for i, n in enumerate(_NLPS))
FIXED = 113


class QM:
    """The decoder over one restart segment's bytes (0xFF00 unstuffed):
    ``decide(st, i)`` decodes one binary decision with the adaptive state
    st[i] and updates it."""

    def __init__(self, seg):
        self.data = bytes(seg)
        self.pos = 0
        self.c = 0
        self.a = 0
        self.ct = -16  # two bytes to read before the first decision

    def decide(self, st, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalise, reading a byte every 8 shifts
            ct -= 1
            if ct < 0:
                byte = self.data[self.pos] if self.pos < len(self.data) \
                    else 0
                self.pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:  # the lower subinterval: LPS unless exchanged
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ _NMPS[sv & 0x7F]
            else:
                st[i] = (sv & 0x80) ^ _AFTER_LPS[sv & 0x7F]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ _AFTER_LPS[sv & 0x7F]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ _NMPS[sv & 0x7F]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _int16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _low_bits(qm, st, s, m) -> int:
    v = m
    m >>= 1
    while m:
        if qm.decide(st, s):
            v |= m
        m >>= 1
    return v


def _dc_diff(qm, dc_st, ctx: list, ci: int, cond) -> int:
    """Figure F.19: one DC difference with the component's conditioning
    context, which it then updates (F.1.4.4.1.2)."""
    s = ctx[ci]
    if not qm.decide(dc_st, s):
        ctx[ci] = 0
        return 0
    sign = qm.decide(dc_st, s + 1)
    s += 2 + sign
    m = qm.decide(dc_st, s)
    if m:
        s = 20
        while qm.decide(dc_st, s):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: arithmetic-coded DC overflows")
            s += 1
    low, up = cond
    if m < (1 << low) >> 1:
        ctx[ci] = 0
    elif m > (1 << up) >> 1:
        ctx[ci] = 12 + 4 * sign
    else:
        ctx[ci] = 4 + 4 * sign
    v = _low_bits(qm, dc_st, s + 14, m) if m else 0
    v += 1
    return -v if sign else v


def _ac_value(qm, ac_st, k: int, kx: int, fixed) -> tuple:
    """The sign and magnitude of a nonzero AC coefficient whose zero-run
    decisions ended at the bins of coefficient k (Figures F.21-F.24)."""
    sign = qm.decide(fixed, 0)
    s = 3 * (k - 1) + 2
    m = qm.decide(ac_st, s)
    if m:
        if qm.decide(ac_st, s):
            m <<= 1
            s = 189 if k <= kx else 217
            while qm.decide(ac_st, s):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG: arithmetic-coded AC overflows")
                s += 1
        m = _low_bits(qm, ac_st, s + 14, m)
    v = m + 1
    return -v if sign else v


def _ac_band(qm, ac_st, cf, base: int, ss: int, se: int, kx: int, fixed,
             al: int) -> None:
    """Figure F.20 over the band ss..se: EOB decisions and zero runs."""
    zz = _ZIGZAG
    k = ss
    while k <= se:
        if qm.decide(ac_st, 3 * (k - 1)):  # EOB
            return
        while not qm.decide(ac_st, 3 * (k - 1) + 1):
            k += 1
            if k > se:
                raise ValueError("JPEG: arithmetic-coded AC run overflows")
        cf[base + zz[k]] = _int16(_ac_value(qm, ac_st, k, kx, fixed) << al)
        k += 1


def _ac_refine(qm, ac_st, cf, base: int, ss: int, se: int, fixed,
               al: int) -> None:
    """G.1.3.3: the correction bits of the coefficients already nonzero
    and the new +-2^Al ones, EOB decisions only past the last coefficient
    nonzero before the scan."""
    zz = _ZIGZAG
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not cf[base + zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and qm.decide(ac_st, st):
            return
        while True:
            pos = base + zz[k]
            c = cf[pos]
            if c:
                if qm.decide(ac_st, st + 2):
                    cf[pos] = c + (m1 if c < 0 else p1)
                break
            if qm.decide(ac_st, st + 1):
                cf[pos] = m1 if qm.decide(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                raise ValueError("JPEG: arithmetic-coded AC run overflows")
        k += 1


def decode_scan(segs, order, coef, sel, dac_dc, dac_ac, progressive: bool,
                ss: int, se: int, ah: int, al: int, restart: int) -> None:
    """One arithmetic-coded scan over its restart segments.  sel holds
    each scan component's (DC table << 4 | AC table); dac_dc and dac_ac
    their conditioning."""
    bases, cidx, per_mcu = order
    seg_blocks = restart * per_mcu if restart else bases.size
    cf = memoryview(coef)
    dc_tab = [t >> 4 for t in sel]
    ac_tab = [t & 15 for t in sel]
    ns = len(sel)
    for s, seg in enumerate(segs):
        lo = s * seg_blocks
        part = bases[lo:lo + seg_blocks].tolist()
        if not part:
            break
        qm = QM(seg)
        fixed = bytearray([FIXED])
        dc_st = {t: bytearray(64) for t in dc_tab}
        ac_st = {t: bytearray(256) for t in ac_tab}
        ctx, last = [0] * ns, [0] * ns
        comp = cidx[lo:lo + seg_blocks].tolist()
        if not progressive:
            for ci, base in zip(comp, part):
                last[ci] = _int16(last[ci] + _dc_diff(
                    qm, dc_st[dc_tab[ci]], ctx, ci, dac_dc[ci]))
                cf[base] = last[ci]
                _ac_band(qm, ac_st[ac_tab[ci]], cf, base, 1, 63, dac_ac[ci],
                         fixed, 0)
        elif ss == 0 and ah == 0:
            for ci, base in zip(comp, part):
                last[ci] += _dc_diff(qm, dc_st[dc_tab[ci]], ctx, ci,
                                     dac_dc[ci])
                cf[base] = _int16(last[ci] << al)
        elif ss == 0:
            for base in part:
                if qm.decide(fixed, 0):
                    cf[base] |= 1 << al
        elif ah == 0:
            for base in part:
                _ac_band(qm, ac_st[ac_tab[0]], cf, base, ss, se, dac_ac[0],
                         fixed, al)
        else:
            for base in part:
                _ac_refine(qm, ac_st[ac_tab[0]], cf, base, ss, se, fixed,
                           al)
