"""Reader for the official MPI-Sintel submission bundle format (a copy of
``craft_tpu.utils.bundle``, which the port does not import).

native/bundler/bundler.cpp, a tool beside both packages, packs a Sintel
submission (``eval/submission.py``'s .flo files) into this format, byte for
byte as the official packer does (the container layout is documented at
the top of bundler.cpp).  This module decodes such a bundle back into
arrays, to inspect a submission before upload.
"""

from __future__ import annotations

import lzma
import struct
from typing import Dict, List, Tuple

import numpy as np

# (sequence, flo frame count, 0-based canonical frame), sorted-name order.
SINTEL_TEST_SEQS: List[Tuple[str, int, int]] = [
    ("PERTURBED_market_3", 49, 21), ("PERTURBED_shaman_1", 49, 22),
    ("ambush_1", 22, 20), ("ambush_3", 40, 24), ("bamboo_3", 49, 29),
    ("cave_3", 49, 15), ("market_1", 49, 17), ("market_4", 49, 46),
    ("mountain_2", 49, 43), ("temple_1", 49, 23), ("tiger", 49, 39),
    ("wall", 49, 39),
]
SELECTOR_SEED = 0x14224CB


def _ran0(state: int) -> Tuple[int, np.float32]:
    """Numerical Recipes ran0 (Park-Miller + XOR mask) on 64-bit state,
    matching the official binary's inlined copy bit-for-bit."""
    ia, im, iq, ir, mask = 16807, 2147483647, 127773, 2836, 123459876
    state ^= mask
    k = abs(state) // iq * (1 if state >= 0 else -1)  # C trunc-toward-zero
    state = ia * (state - k * iq) - ir * k
    if state < 0:
        state += im
    ans = np.float32(np.float64(state) / np.float64(im))
    return state ^ mask, ans


def generate_selector(w: int, h: int, seed: int = SELECTOR_SEED) -> np.ndarray:
    """The official "fixed, randomized subsample" selector: sel[j] in {0..9};
    frame f of every sequence samples row-major pixels with sel[j] == f % 10."""
    state = seed
    state, _ = _ran0(state)  # warm-up draw, discarded
    out = np.empty(w * h, np.int32)
    ten = np.float32(10.0)
    for j in range(w * h):
        state, f = _ran0(state)
        out[j] = int(np.floor(f * ten))
    return out


def read_bundle(path: str) -> Dict:
    """Decode an official-format bundle back into arrays.  Per-frame sample
    pixel indices are reconstructed from the selector (the container stores
    bare float pairs; the evaluation site regenerates positions the same way).
    """
    with open(path, "rb") as f:
        raw = lzma.decompress(f.read(), format=lzma.FORMAT_ALONE)
    w, h, ndirs, total, nseq = struct.unpack_from("<5I", raw, 0)
    seq_counts = struct.unpack_from(f"<{nseq}I", raw, 20)
    assert ndirs == 2 * nseq == 2 * len(SINTEL_TEST_SEQS)
    off = 20 + 4 * nseq
    npix = w * h

    def f32s(n):
        nonlocal off
        v = np.frombuffer(raw, "<f4", count=n, offset=off).copy()
        off += 4 * n
        return v

    passes = []
    for _ in range(2):
        seqs = []
        for name, _, _ in SINTEL_TEST_SEQS:
            u = f32s(npix).reshape(h, w)
            v = f32s(npix).reshape(h, w)
            seqs.append({"name": name, "canonical": np.stack([u, v], -1)})
        passes.append(seqs)

    sel = generate_selector(w, h)
    idx_by_res = [np.where(sel == r)[0] for r in range(10)]
    for seqs in passes:
        for (name, nframes, _), seq in zip(SINTEL_TEST_SEQS, seqs):
            frames = []
            for fidx in range(nframes):
                idx = idx_by_res[fidx % 10]
                uv = f32s(2 * len(idx)).reshape(len(idx), 2)
                frames.append({"indices": idx, "uv": uv})
            seq["frames"] = frames
    assert off == len(raw), (off, len(raw))
    return {"w": w, "h": h, "total_samples": total,
            "seq_counts": list(seq_counts), "passes": passes}
