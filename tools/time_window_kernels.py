"""A/B times of the hand kernels B1-B10 over CUDA events, for the
craft_tpu_torch package under --root (default: this checkout), so that two
checkouts can be compared in one call on one card:

    python tools/time_window_kernels.py --root build/parent --reps 20
        [--save DIR | --diff DIR] [--cases B2 B8]

(--cases: only the cases whose names start with one of these.)  Builds that checkout's kernels into its own build/kernels/.  The cases, at
the shapes their paths run them (serving: B=1, M=4, 440x1024 -> U=7040,
W8=128; chairs: B=8, 368x496 -> U=2852, W8=62; KITTI: 376x1248 -> U=7332,
W8=156):

  B1 (scores_global_max) at serving, md 64 and 32, and at chairs (B*M =
  32), and at serving in fp32 (its fp32 body);
  B2 (flash_mode_attention) at serving;
  B3 (fused_agg_corr_norm) at serving and KITTI, and at serving in fp32;
  B4 (mode_softmax_probs) int8 at serving and KITTI, bf16 probs at chairs
  (md 32 and 64), and fp32 at serving (its fp32 body);
  B5 (corr_lookup) forward and backward at serving and chairs, bf16 levels,
  and at D = 2 (two planes a level) where the checkout has it;
  B6 (fused_agg_corr) forward and backward at chairs, md 64 (the backward
  on the plain version's volume, so that both checkouts' backwards read
  the same bits);
  B6 dense and B4 dense (bf16 probs) at serving, each with no table and
  with the --f2radius 7 table;
  B7 (probs_bwd) at chairs, md 64 and 32, and md 64 in fp32 (its FMA
  body);
  B8 (flash_mode_attention_dense) at serving, with no table and with the
  --f2radius 7 table (pos_w * the dense window + the mask);
  B2 and B8 with the table again in fp32 (their fp32 body);
  B9 (corr_norm_sums, corr_norm_write) on both row shards of the serving
  grid at n = 2 (rows 0:28 and 28:55);
  B8 (no table and the shard's rows of the --f2radius 7 table), B6 dense
  and B4 dense (no table) on the same shards, as sequence parallelism
  runs them under lsinu and --f2radius (U1 < U2);
  B10 (gru_pass_fwd, gru_pass_bwd) at the serving and chairs grids, bf16
  h, Ch 128, Cx 384 (fp32 x, as the module passes it), both passes: h
  (stride 1) and v (stride W); the backward on the plain forward's z, r, q,
  so that both checkouts' backwards read the same bits; and the forward
  at serving in fp32 (its fp32 body);
  the aggregating kernels' FMA bodies at other mode counts (a mode dim of
  256 / M, a generator of their own): B3 at serving at 1, 8, 16 and, where
  the checkout takes them, 32 and 256 modes; B6 forward and backward at
  chairs, batch 2, at 8, 16 and, where taken, 32 modes; B9 on the second
  serving shard at 16 modes.
  B2 and B8's pipelined body (a generator of its own): B2 at F 128, md
  32 on a Sintel batch of 11 at serving (the lazy intra aggregator), at md
  256 (one mode) and md 128 (two modes), and B8 at md 256 with the
  --f2radius 7 table.

Seeded inputs from CPU generators (q, k ~ N(0, 1.5^2) bf16, the window ~
N(0, 0.5^2)), the clamp off.  Each case is timed in ROUNDS rounds of `reps`
calls, the rounds of all cases interleaved, so that a disturbance of the
card spreads over all of them; a round's time is its mean per call.  After
the rounds, one more run of `reps` calls of each case under torch.profiler
gives its kernels' device time per call (`_dev_ms`, and per kernel in
`_kernels`): where a kernel is shorter than its wrapper's host work, the
events time the host, and the device time is the kernel's own.  Prints the card (nvidia-smi name, power
limit) and one JSON line with the card again and, per case, the median
round (ms per call), every round, the device time and a SHA-256 prefix of
its output bytes (equal prefixes: the checkouts' results are
bit-identical).

For the cases whose bits a change may move (SAVED), `--save DIR` writes
their outputs to DIR and `--diff DIR` adds `<case>_max_abs_diff`, the
largest |difference| from the outputs saved there by another checkout's
run (A B B A: the first A saves, the others diff); for B4's int8 cases
that is the numerators', and `<case>_scale_rel_diff` adds the row scales'
largest relative difference; for B7 that is dc's, and `<case>_dlsum_max_
abs_diff` adds dlsum's; for B6's backward dc's, and `B6_bwd_da_max_abs_
diff` adds da's; for those two the `_rel_diff` keys give each largest
|difference| over the largest |value| of the other checkout's output.
Where the first output is bf16, `<case>_max_ulp_diff` adds how many bf16
steps apart its elements lie at most.  For B10's backward (WHOLE) every
output is kept: `_max_abs_diff` is the largest over dh, dx and the weight
and bias gradients, `_rel_diff` the largest of each one's over its largest
|value|.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 7
SAVED = ("B1", "B1_md32", "B1_chairs", "B1_fp32", "B2", "B2_fp32", "B3",
         "B3_kitti", "B3_fp32", "B4", "B4_kitti", "B4_chairs_md32",
         "B4_chairs_md64", "B4_dense", "B4_dense_table", "B5", "B5_chairs",
         "B8", "B8_table", "B8_fp32_table", "B9_sums_r0", "B9_sums_r1",
         "B9_write_r0", "B9_write_r1", "B7_md64", "B7_md32", "B7_fp32_md64",
         "B6", "B6_bwd", "B6_dense", "B6_dense_table")
# The second output kept beside the first, by case: B7's dlsum, B6
# backward's da.
SECOND = {"B7_md64": "dlsum", "B7_md32": "dlsum", "B7_fp32_md64": "dlsum",
          "B6_bwd": "da"}
# B10: the pass's forward and backward, each pass, serving and chairs.
B10_CASES = tuple(f"B10{b}{g}_{p}" for b in ("", "_bwd")
                  for g in ("", "_chairs") for p in ("h", "v"))
B10_FP32_CASES = ("B10_fp32_h", "B10_fp32_v")
SAVED += B10_CASES + B10_FP32_CASES
# The aggregating kernels' FMA bodies at other mode counts (mode dim 256 /
# M); the counts past 16 only where the checkout takes them.
AGG_SERVE_MODES, AGG_TRAIN_MODES = (1, 8, 16, 32, 256), (8, 16, 32)
AGG_CASES = (tuple(f"B3_m{m}" for m in AGG_SERVE_MODES)
             + tuple(f"B6{b}_m{m}" for b in ("", "_bwd")
                     for m in AGG_TRAIN_MODES)
             + ("B9_sums_m16_r1", "B9_write_m16_r1"))
SAVED += AGG_CASES
# B2 and B8 past md 64 and B2 at F 128 (the pipelined body): their bits
# move by bf16 rounding between the parent's FMA or 64-key body and it.
FLASH_CASES = ("B2_f128", "B2_md256", "B2_md128", "B8_md256")
SAVED += FLASH_CASES
SECOND.update({f"B6_bwd_m{m}": "da" for m in AGG_TRAIN_MODES})
# Cases whose every output is kept and compared.
WHOLE = tuple(c for c in B10_CASES if c.startswith("B10_bwd"))
GRU_CH, GRU_CX = 128, 384
SERVING, CHAIRS, KITTI = (55, 128), (46, 62), (47, 156)
RADIUS, LEVELS, F2RADIUS = 4, 4, 7


def _lookup_inputs(torch, gen, dev, batch, grid):
    """bf16 levels [Q, h / 2^l, w / 2^l] ~ N(0, 1) and coords: the token
    grid moved by up to 6 px, some queries outside every level."""
    h8, w8 = grid
    Q = batch * h8 * w8
    levels = [torch.randn(Q, h8 >> l, w8 >> l, generator=gen).to(
        dev, torch.bfloat16) for l in range(LEVELS)]
    ys, xs = torch.meshgrid(torch.arange(h8), torch.arange(w8),
                            indexing="ij")
    base = torch.stack([xs, ys], -1).float()[None].expand(batch, -1, -1, -1)
    coords = base + torch.rand(batch, h8, w8, 2, generator=gen) * 12 - 6
    flat = coords.reshape(-1, 2)
    flat[::13] = -200.0 - flat[::13]
    flat[::17] += 150.0 + max(h8, w8)
    return levels, coords.to(dev)


def _cases(torch, dev):
    """{name: a call of one kernel wrapper on this run's seeded inputs}."""
    from craft_tpu_torch.nn.setrans import attention_mask
    from craft_tpu_torch.ops.kernels import corr_lookup as lk
    from craft_tpu_torch.ops.kernels import corr_vjp as cv
    from craft_tpu_torch.ops.kernels import mode_attention as ma
    from craft_tpu_torch.ops.kernels import probs_vjp as pv
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    def qk(batch, u, md):
        return (randn(batch, 4, u, md, std=1.5) for _ in range(2))

    u, uc, uk = (g[0] * g[1] for g in (SERVING, CHAIRS, KITTI))
    q64, k64 = qk(1, u, 64)
    q32, k32 = qk(1, u, 32)
    qc64, kc64 = qk(8, uc, 64)
    qc32, kc32 = qk(8, uc, 32)
    qk64, kk64 = qk(1, uk, 64)
    qk32, kk32 = qk(1, uk, 32)
    v = randn(1, 4, u, 256)
    biases = randn(15, 15, std=0.5, dtype=torch.float32)
    clip = torch.tensor(1e30, device=dev)
    one = torch.tensor(1.0, device=dev)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    table = (0.5 * ma.sliding_pos_biases(biases, *SERVING)
             + attention_mask(*SERVING, F2RADIUS, dev))
    q64f, k64f, vf, q32f, k32f = (x.float() for x in (q64, k64, v, q32,
                                                     k32))
    cases = {
        "B1": lambda: ma.scores_global_max(q64, k64, 0.125),
        "B1_md32": lambda: ma.scores_global_max(q32, k32, 32 ** -0.5),
        "B1_chairs": lambda: ma.scores_global_max(qc64, kc64, 0.125),
        "B1_fp32": lambda: ma.scores_global_max(q64f, k64f, 0.125),
        "B2": lambda: ma.flash_mode_attention(q64, k64, v, biases, SERVING,
                                              clip, 0.5),
        "B3": lambda: ma.fused_agg_corr_norm(q64, k64, biases, SERVING,
                                             100.0, 0.5, one, one),
        "B3_kitti": lambda: ma.fused_agg_corr_norm(qk64, kk64, biases, KITTI,
                                                   100.0, 0.5, one, one),
        "B3_fp32": lambda: ma.fused_agg_corr_norm(
            q64f, k64f, biases, SERVING, 100.0, 0.5, one, one,
            out_dtype=torch.float32),
        "B4": lambda: ma.mode_softmax_probs(q32, k32, biases, SERVING, clip,
                                            1.0, quantized=True),
        "B4_kitti": lambda: ma.mode_softmax_probs(qk32, kk32, biases, KITTI,
                                                  clip, 1.0, quantized=True),
        "B4_fp32": lambda: ma.mode_softmax_probs(q32f, k32f, biases, SERVING,
                                                 clip, 1.0,
                                                 out_dtype=torch.float32),
        "B4_dense": lambda: ma.mode_softmax_probs_dense(q32, k32, None, clip,
                                                        1.0),
        "B4_dense_table": lambda: ma.mode_softmax_probs_dense(
            q32, k32, table, clip, 1.0),
        "B6_dense": lambda: cv.fused_agg_corr_dense(q64, k64, None, clip,
                                                    0.5, agg_w, agg_b),
        "B6_dense_table": lambda: cv.fused_agg_corr_dense(
            q64, k64, table, clip, 0.5, agg_w, agg_b),
        "B8": lambda: ma.flash_mode_attention_dense(q64, k64, v, None, clip,
                                                    0.5),
        "B8_table": lambda: ma.flash_mode_attention_dense(q64, k64, v, table,
                                                          clip, 1.0),
        "B2_fp32": lambda: ma.flash_mode_attention(q64f, k64f, vf, biases,
                                                   SERVING, clip, 0.5),
        "B8_fp32_table": lambda: ma.flash_mode_attention_dense(
            q64f, k64f, vf, table, clip, 1.0),
    }
    for label, batch, grid in (("", 1, SERVING), ("_chairs", 8, CHAIRS)):
        levels, coords = _lookup_inputs(torch, gen, dev, batch, grid)
        shapes = [tuple(lv.shape) for lv in levels]
        g = torch.randn(batch, *grid, LEVELS * (2 * RADIUS + 1) ** 2,
                        generator=gen).to(dev)
        cases["B5" + label] = functools.partial(lk.corr_lookup, levels,
                                                coords, RADIUS)
        cases["B5_bwd" + label] = functools.partial(
            lk.corr_lookup_bwd, coords, g, shapes, torch.bfloat16, RADIUS)
    vol = cv.fused_agg_corr_plain(qc64, kc64, biases, CHAIRS, clip, 0.5,
                                  agg_w, agg_b)
    g_vol = randn(8, uc, uc, dtype=torch.float32)
    cases["B6"] = lambda: cv.fused_agg_corr(qc64, kc64, biases, CHAIRS, clip,
                                            0.5, agg_w, agg_b)
    cases["B6_bwd"] = lambda: cv.agg_corr_bwd(qc64, kc64, g_vol, vol, biases,
                                              CHAIRS, clip, 0.5, agg_w)
    # B9 at n = 2: the clamp predicate and the sums from the plain versions,
    # so that both checkouts' kernels take the same values.
    gmax = ma.scores_global_max_plain(q64, k64, 0.125)
    sums = ma.corr_norm_sums_plain(q64, k64, biases, SERVING, gmax, 100.0,
                                   0.5, agg_w, agg_b)
    for r, (h0, h1) in enumerate(((0, 28), (28, SERVING[0]))):
        ql = q64[:, :, h0 * SERVING[1]:h1 * SERVING[1]].contiguous()
        cases[f"B9_sums_r{r}"] = functools.partial(
            ma.corr_norm_sums, ql, k64, biases, SERVING, gmax, 100.0, 0.5,
            agg_w, agg_b, q_row0=h0)
        cases[f"B9_write_r{r}"] = functools.partial(
            ma.corr_norm_write, ql, k64, biases, SERVING, gmax, sums, 100.0,
            0.5, agg_w, agg_b, q_row0=h0)
        u0, u1 = h0 * SERVING[1], h1 * SERVING[1]
        q64l, q32l = (x[:, :, u0:u1].contiguous() for x in (q64, q32))
        cases[f"B8_r{r}"] = functools.partial(
            ma.flash_mode_attention_dense, q64l, k64, v, None, clip, 0.5)
        cases[f"B8_table_r{r}"] = functools.partial(
            ma.flash_mode_attention_dense, q64l, k64, v,
            table[u0:u1].contiguous(), clip, 1.0)
        cases[f"B6_dense_r{r}"] = functools.partial(
            cv.fused_agg_corr_dense, q64l, k64, None, clip, 0.5, agg_w,
            agg_b)
        cases[f"B4_dense_r{r}"] = functools.partial(
            ma.mode_softmax_probs_dense, q32l, k32, None, clip, 1.0)
    _gru_cases(torch, gen, dev, cases)
    for md, (q, k), pos_w in ((32, (qc32, kc32), 1.0),
                              (64, (qc64, kc64), 0.5)):
        cases[f"B4_chairs_md{md}"] = functools.partial(
            ma.mode_softmax_probs, q, k, biases, CHAIRS, clip, pos_w)
    g_p = randn(8, 4, uc, uc)
    for md, (q, k), pos_w in ((64, (qc64, kc64), 0.5),
                              (32, (qc32, kc32), 1.0)):
        # B7's probs from B4's plain version, so that both checkouts' B7
        # read the same bits.
        p = ma.mode_softmax_probs_plain(q, k, biases, CHAIRS, clip, pos_w)
        cases[f"B7_md{md}"] = functools.partial(pv.probs_bwd, q, k, p, g_p,
                                                clip)
    # B7's FMA body: md 64 in fp32, from the same inputs.
    q, k = qc64.float(), kc64.float()
    p = ma.mode_softmax_probs_plain(q, k, biases, CHAIRS, clip, 0.5,
                                    out_dtype=torch.float32)
    cases["B7_fp32_md64"] = functools.partial(pv.probs_bwd, q, k, p,
                                              g_p.float(), clip)
    if "dim" in inspect.signature(lk.corr_lookup).parameters:
        # B5 at D = 2 (two-way correlation), in a checkout that has it:
        # each level two planes, from a generator of its own, so that the
        # cases above draw the same inputs in every checkout.
        gen2 = torch.Generator().manual_seed(2)
        for label, batch, grid in (("", 1, SERVING), ("_chairs", 8, CHAIRS)):
            levels, coords = _lookup_inputs(torch, gen2, dev, batch, grid)
            planes = [p for lv in levels for p in (lv, torch.randn(
                lv.shape, generator=gen2).to(dev, lv.dtype))]
            shapes = [tuple(p.shape) for p in planes]
            g = torch.randn(batch, *grid, len(planes) * (2 * RADIUS + 1) ** 2,
                            generator=gen2).to(dev)
            cases["B5_d2" + label] = functools.partial(
                lk.corr_lookup, planes, coords, RADIUS, 2)
            cases["B5_bwd_d2" + label] = functools.partial(
                lk.corr_lookup_bwd, coords, g, shapes, torch.bfloat16, RADIUS,
                2)
    _agg_mode_cases(torch, dev, ma, cv, biases, cases)
    _flash_cases(torch, dev, ma, biases, table, cases)
    return cases


def _flash_cases(torch, dev, ma, biases, table, cases) -> None:
    """B2 at F 128, md 32 on a Sintel batch of 11 (the lazy intra
    aggregator), at md 256 (one mode) and md 128 (two) on the serving grid,
    and B8 at md 256 with the --f2radius table, from a generator of their
    own (the cases above draw the same inputs in every checkout)."""
    gen = torch.Generator().manual_seed(4)
    clip = torch.tensor(1e30, device=dev)
    u = SERVING[0] * SERVING[1]

    def qkv(batch, m, md, F):
        q, k = ((torch.randn(batch, m, u, md, generator=gen) * 1.5).to(
            dev, torch.bfloat16) for _ in range(2))
        return q, k, torch.randn(batch, m, u, F, generator=gen).to(
            dev, torch.bfloat16)
    for name, batch, m, md, F in (("B2_f128", 11, 4, 32, 128),
                                  ("B2_md256", 1, 1, 256, 256),
                                  ("B2_md128", 1, 2, 128, 256)):
        q, k, v = qkv(batch, m, md, F)
        cases[name] = functools.partial(ma.flash_mode_attention, q, k, v,
                                        biases, SERVING, clip,
                                        1.0 if F == 128 else 0.5)
    q, k, v = qkv(1, 1, 256, 256)
    cases["B8_md256"] = functools.partial(ma.flash_mode_attention_dense, q,
                                          k, v, table, clip, 1.0)


def _agg_mode_cases(torch, dev, ma, cv, biases, cases) -> None:
    """B3, B6, B6 backward and B9 at other mode counts, from a generator
    of their own (the cases above draw the same inputs in every
    checkout)."""
    gen = torch.Generator().manual_seed(3)
    takes = 256 in getattr(ma, "AGG_MODES", ())
    clip = torch.tensor(1e30, device=dev)
    one = torch.tensor(1.0, device=dev)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    u, uc = (g[0] * g[1] for g in (SERVING, CHAIRS))

    def qk(batch, m, uu):
        return [(torch.randn(batch, m, uu, 256 // m, generator=gen) * 1.5)
                .to(dev, torch.bfloat16) for _ in range(2)]
    for m in AGG_SERVE_MODES:
        q, k = qk(1, m, u)
        if m <= 16 or takes:
            cases[f"B3_m{m}"] = functools.partial(
                ma.fused_agg_corr_norm, q, k, biases, SERVING, 100.0, 0.5,
                one, one)
        if m == 16:
            gmax = ma.scores_global_max_plain(q, k, 0.25)
            r0 = 28 * SERVING[1]
            sums = torch.tensor([[1e7, 1e8]], dtype=torch.float64,
                                device=dev)
            ql = q[:, :, r0:].contiguous()
            cases["B9_sums_m16_r1"] = functools.partial(
                ma.corr_norm_sums, ql, k, biases, SERVING, gmax, 100.0, 0.5,
                agg_w, agg_b, q_row0=28)
            cases["B9_write_m16_r1"] = functools.partial(
                ma.corr_norm_write, ql, k, biases, SERVING, gmax, sums,
                100.0, 0.5, agg_w, agg_b, q_row0=28)
    for m in AGG_TRAIN_MODES:
        q, k = qk(2, m, uc)
        if m > 16 and not takes:
            continue
        vol = torch.randn(2, uc, uc, generator=gen).to(dev)
        g_vol = torch.randn(2, uc, uc, generator=gen).to(dev)
        cases[f"B6_m{m}"] = functools.partial(
            cv.fused_agg_corr, q, k, biases, CHAIRS, clip, 0.5, agg_w, agg_b)
        cases[f"B6_bwd_m{m}"] = functools.partial(
            cv.agg_corr_bwd, q, k, g_vol, vol, biases, CHAIRS, clip, 0.5,
            agg_w)


def _gru_cases(torch, gen, dev, cases) -> None:
    """B10's forward and backward at the serving and chairs grids, both
    passes: h in (-1, 1) bf16, x ~ N(0, 1) fp32, fp32 taps ~ N(0, 1 /
    2560) (so that the weight gradients come back in fp32), biases ~ N(0,
    0.1^2), the cotangent ~ N(0, 1)."""
    from craft_tpu_torch.ops.kernels import sep_conv_gru as sg
    std = (5 * (GRU_CH + GRU_CX)) ** -0.5
    for label, batch, (h8, w8) in (("", 1, SERVING), ("_chairs", 8, CHAIRS)):
        rows = h8 * w8

        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen) * s).to(dev)
        h = randn(batch, rows, GRU_CH).tanh().bfloat16()
        x = randn(batch, rows, GRU_CX)
        ws = [randn(5, c, GRU_CH, s=std) for _ in range(3)
              for c in (GRU_CH, GRU_CX)]
        bs = [randn(GRU_CH, s=0.1) for _ in range(3)]
        g = randn(batch, rows, GRU_CH)
        for p, geo in (("h", (1, w8)), ("v", (w8, rows))):
            args = (h, x, *ws, *bs, *geo)
            _, z, r, q = sg.gru_pass_fwd_plain(*args)
            cases[f"B10{label}_{p}"] = functools.partial(sg.gru_pass_fwd,
                                                         *args)
            cases[f"B10_bwd{label}_{p}"] = functools.partial(
                sg.gru_pass_bwd, h, x, z, r, q, g, *ws, *geo)
            if not label:
                cases[f"B10_fp32_{p}"] = functools.partial(
                    sg.gru_pass_fwd, h.float(), *args[1:])


def _max_ulp_diff(torch, a, b) -> int:
    """The most bf16 steps between elements of a and b: each bit pattern
    as an integer ordered like its value (+0 and -0 both 0)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _digest(torch, res) -> str:
    digest = hashlib.sha256()
    for t in res if isinstance(res, (tuple, list)) else (res,):
        digest.update(t.contiguous().reshape(-1).view(torch.uint8).cpu()
                      .numpy().tobytes())
    return digest.hexdigest()[:16]


def _device_ms(torch, fn, reps: int) -> tuple:
    """Kernel time per call on the device, from torch.profiler: (the total,
    {kernel name: its share})."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                kernels[e.key[:60]] = getattr(e, attr) / 1e3 / reps
                break
    return sum(kernels.values()), kernels


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", help="write the SAVED cases' outputs here")
    ap.add_argument("--diff", help="max |difference| from the outputs "
                    "saved here")
    ap.add_argument("--cases", nargs="*", help="run only the cases whose "
                    "names start with one of these (all by default)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from craft_tpu_torch.ops.kernels import mode_attention as ma
    if not torch.cuda.is_available():
        print("time_window_kernels: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    assert Path(ma.__file__).resolve().is_relative_to(root), ma.__file__
    cases = {name: fn for name, fn in _cases(torch, torch.device("cuda"))
             .items() if not args.cases
             or any(name.startswith(c) for c in args.cases)}
    out = {"root": str(root), "card": card}
    for name, fn in cases.items():
        res = fn()
        torch.cuda.synchronize()
        out[name + "_sha"] = _digest(torch, res)
        first = res[0] if isinstance(res, (tuple, list)) else res
        # B4 int8: (numerators, row scales); the scales are kept too, and
        # the SECOND outputs.
        scales = res[1] if first.dtype == torch.int8 else None
        second = res[1] if name in SECOND else None
        if name in WHOLE:
            if args.save:
                Path(args.save).mkdir(parents=True, exist_ok=True)
                torch.save([t.cpu() for t in res],
                           Path(args.save) / f"{name}.pt")
            if args.diff:
                refs = torch.load(Path(args.diff) / f"{name}.pt")
                diffs = [float((t.cpu().double() - r.double()).abs().max())
                         for t, r in zip(res, refs)]
                out[name + "_max_abs_diff"] = max(diffs)
                out[name + "_rel_diff"] = max(
                    d / float(r.double().abs().max())
                    for d, r in zip(diffs, refs))
        elif name in SAVED and args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            torch.save(tuple(None if t is None else t.cpu()
                             for t in (first, scales, second)),
                       Path(args.save) / f"{name}.pt")
        if name in SAVED and name not in WHOLE and args.diff and (
                Path(args.diff) / f"{name}.pt").exists():
            ref, ref_scales, ref_second = torch.load(
                Path(args.diff) / f"{name}.pt")
            out[name + "_max_abs_diff"] = float(
                (first.cpu().double() - ref.double()).abs().max())
            if first.dtype == torch.bfloat16:
                out[name + "_max_ulp_diff"] = _max_ulp_diff(
                    torch, first.cpu(), ref)
            if scales is not None:
                out[name + "_scale_rel_diff"] = float(
                    ((scales.cpu().double() - ref_scales.double()).abs()
                     / ref_scales.double()).max())
            if second is not None:
                out[name + "_rel_diff"] = out[name + "_max_abs_diff"] / float(
                    ref.double().abs().max())
                key = f"{name}_{SECOND[name]}"
                d = float((second.cpu().double() - ref_second.double()).abs()
                          .max())
                out[key + "_max_abs_diff"] = d
                out[key + "_rel_diff"] = d / float(
                    ref_second.double().abs().max())
        del res, first, scales, second
    rounds = {name: [] for name in cases}
    for _ in range(ROUNDS):
        for name, fn in cases.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            rounds[name].append(start.elapsed_time(end) / args.reps)
    for name, times in rounds.items():
        out[name + "_ms"] = statistics.median(times)
        out[name + "_rounds"] = times
        out[name + "_dev_ms"], out[name + "_kernels"] = _device_ms(
            torch, cases[name], args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
