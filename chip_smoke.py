"""GPU smoke run of the PyTorch/CUDA port (craft_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from craft_tpu_torch/csrc into
build/kernels/ (one nvcc per source, all started together), then runs
these phases and fails on the first that fails:

  1. card: prints `nvidia-smi --query-gpu=name,power.limit`; TF32 off.
  2. kernels: each serving kernel (B1-B4) against its plain PyTorch
     version on seeded inputs at the main-path shapes (B=1, M=4, 440x1024
     -> U=7040), the clamp off and on; a dropped bias and a missing clamp,
     planted in the plain version, must each fall outside the bound.
     Then the training kernels at the chairs shapes (B=8, M=4, 46x62 ->
     U=2852, md 64 and 32): B1 and B4 float at this ragged U, B6 forward,
     B6 backward (dc, da) and B7 backward (dc, dlsum), each with faults
     planted in its plain version.
  3. oracle: full-width CRAFT with the weights of
     tests/data/oracle_craft_128.npz at 128x128, 12 iterations, against the
     reference flow: fp32 within 1e-3 px, the mixed-precision config
     within 0.15 px.  Then one fp32 training step (dropout off, 2
     iterations) on the card through the kernels against the same step on
     the CPU through the plain versions: loss, every gradient, batch stats.
  4. main path: craft_config(mixed_precision=True), 436x1024 padded to
     440x1024, 12 iterations, one warm-up pair then 3 seeded frame pairs;
     per-pair ms, frame-pairs/s and peak device memory.  Every kernel's
     launch count is zeroed just before and read just after.  Then the
     training path: the same config at 368x496 (the chairs crops), batch
     8, 12 iterations, dropout at the config's rates, one warm-up step and
     3 timed steps; ms per step, samples/s, peak memory, each step's loss
     and grad norm, and the launches of its own run.
  5. kernel times over CUDA events at the main-path shapes, beside each
     plain version, the bound and (B2) scaled_dot_product_attention; then
     the training kernels and B1/B4 at the chairs shapes.

Prints the card line and a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is unavailable.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from craft_tpu_torch.config import craft_config
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.ops.geometry import InputPadder
from craft_tpu_torch.ops.kernels import build, launch
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv
from craft_tpu_torch.training.train_step import (create_train_state,
                                                 host_metrics,
                                                 make_train_step)
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

ORACLE = Path(__file__).resolve().parent / "tests/data/oracle_craft_128.npz"
FULLPREC_BOUND_PX = 1e-3
BF16_BOUND_PX = 0.15
FRAME_H, FRAME_W, ITERS = 436, 1024, 12  # Sintel frames, padded to 440
H8, W8 = 55, 128          # 440x1024 / 8
U = H8 * W8
BF16_TFLOPS, HBM_TBS = 989.0, 3.35  # H100 SXM dense bf16 peak, HBM rate
SOURCE = "craft_tpu_torch/csrc/{}.cu"
TPU_KERNEL = "craft_tpu/ops/pallas/mode_attention.py:{}"
# The training path: the chairs stage of the reference curriculum.
CROP_H, CROP_W, TRAIN_BATCH = 368, 496, 8
CHAIRS_GRID = (CROP_H // 8, CROP_W // 8)  # 46 x 62 -> U = 2852


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops = flops / (BF16_TFLOPS * 1e12) * 1e3
    t_mem = nbytes / (HBM_TBS * 1e12) * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


# Phase 2 inputs.  q, k ~ N(0, QK_STD^2) give scores scale * q.k with a
# standard deviation of QK_STD^2 = 2.25 at every mode dim, so each softmax
# row is dominated by a few keys (a near-uniform softmax over 7040 keys
# would hide a wrong kernel in outputs that all sit near the mean of v).
# The bias window ~ N(0, BIAS_STD^2) moves its keys by pos_w * 3 (f2, inter)
# or 1 * 3 (intra) standard deviations' worth, and CLIP_ON clamps about
# two thirds of the scores, so dropping either changes the output by far
# more than the tolerances below; each check plants both faults in the
# plain version and fails unless its bound catches them.
QK_STD, BIAS_STD, CLIP_ON, CLIP_OFF = 1.5, 3.0, 1.0, 1e30
# Tolerances, each set from what is compared:
B1_RTOL = 1e-5      # fp32 max of fp32 products: summation order only
B2_TOL = 2e-2       # max |diff| / max |plain|, both bf16: 1 ulp <= 2^-7
B3_ATOL, B3_RTOL = 3e-2, 1e-2   # normed volume (std 1), bf16 out vs fp32
B4_NUM_TOL, B4_SCALE_RTOL = 1, 1e-4  # int8 numerators, fp32 row scales
# per row, over the row max; bf16 against fp32: half an ulp <= 2^-8
B4_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def inputs(gen, md, dev, u=U, batch=1):
    """Seeded q, k [batch, 4, u, md] bf16 with scores of std QK_STD^2."""
    def one():
        x = torch.randn(batch, 4, u, md, generator=gen) * QK_STD
        return x.to(dev, torch.bfloat16)
    return one(), one()


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over the whole tensor."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def row_rel_err(got, want) -> float:
    """Per row (last dim): max |got - want| / max |want|; the worst row."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1)).max())


def num_err(got, want) -> float:
    """Largest difference of two int8 numerator tensors."""
    return float((got.int() - want.int()).abs().max())


def b3_err(got, want) -> float:
    """Worst |got - want| / (B3_ATOL + B3_RTOL |want|): <= 1 passes."""
    d = (got.float() - want.float()).abs()
    return float((d / (B3_ATOL + B3_RTOL * want.float().abs())).max())


def hold(label, got, want, err_fn, tol, faults) -> float:
    """err_fn(got, want) <= tol, and err_fn(fault, want) > tol for each
    planted fault {name: plain output with that fault}: a bound that a
    dropped bias or a missing clamp would pass proves nothing."""
    err = err_fn(got, want)
    print(f"{label}: error {err:.3e} (bound {tol:g})")
    assert err <= tol, f"{label}: kernel disagrees with its plain version"
    for name, out in faults.items():
        ferr = err_fn(out, want)
        print(f"{label}: planted fault '{name}' gives {ferr:.3e}")
        assert ferr > tol, f"{label}: the bound misses a '{name}' fault"
    return err


def clamped_share(q, k, clip: float) -> float:
    """Share of the scores scale * q.k that |.| > clip clamps."""
    s = torch.einsum("bmid,bmjd->bmij", q.float(), k.float())
    return float((s.abs() > clip * math.sqrt(q.shape[-1])).float().mean())


def check_kernels(dev, gen, report, grid=(H8, W8)) -> None:
    """Phase 2: every kernel against its plain version on the same inputs
    (the plain versions run on the card too), with the clamp off and on.
    On CPU tensors the wrappers take the plain versions themselves, which
    is how the tests run this phase with planted faults."""
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    u = grid[0] * grid[1]

    # B1 at the f2/inter (md 64) and intra (md 32) shapes.
    errs = []
    for md in (64, 32):
        q, k = inputs(gen, md, dev, u)
        scale = 1.0 / math.sqrt(md)
        got = float(ma.scores_global_max(q, k, scale))
        sync(dev)
        want = float(ma.scores_global_max_plain(q, k, scale))
        print(f"B1 md={md}: kernel {got:.6f} plain {want:.6f}")
        assert abs(got - want) <= B1_RTOL * abs(want), "B1 disagrees"
        errs.append(abs(got - want))
    report["scores_global_max"]["max_abs_err"] = max(errs)

    # B2 (f2 site, pos_w 0.5), bf16.
    q, k = inputs(gen, 64, dev, u)
    v = torch.randn(1, 4, u, 256, generator=gen).to(dev, torch.bfloat16)
    print(f"B2/B3 inputs: clip {CLIP_ON} clamps "
          f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
    errs = []
    for clip in (CLIP_OFF, CLIP_ON):
        clip_t = torch.tensor(clip, device=dev)
        got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
        sync(dev)
        plain = lambda c, w: ma.flash_mode_attention_plain(  # noqa: E731
            q, k, v, biases, grid, torch.tensor(c, device=dev), w)
        faults = {"no bias": plain(clip, 0.0)}
        if clip != CLIP_OFF:
            faults["no clamp"] = plain(CLIP_OFF, 0.5)
        want = plain(clip, 0.5)
        hold(f"B2 clip={clip:g}", got, want, rel_err, B2_TOL, faults)
        errs.append(float((got.float() - want.float()).abs().max()))
        del got, want, faults
    report["flash_mode_attention"]["max_abs_err"] = max(errs)

    # B3 (inter site, pos_w 0.5), bf16 output against the fp32 plain
    # volume, the clamp inactive (attn_clip 100 > raw max) and active.
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    errs = []
    for attn_clip in (100.0, CLIP_ON):
        got, stats = ma.fused_agg_corr_norm(q, k, biases, grid, attn_clip,
                                            0.5, agg_w, agg_b)
        sync(dev)
        plain = lambda c, w: ma.fused_agg_corr_norm_plain(  # noqa: E731
            q, k, biases, grid, c, w, agg_w, agg_b, out_dtype=torch.float32)
        faults = {"no bias": plain(attn_clip, 0.0)[0]}
        if attn_clip != 100.0:
            faults["no clamp"] = plain(CLIP_OFF, 0.5)[0]
        want, wstats = plain(attn_clip, 0.5)
        hold(f"B3 attn_clip={attn_clip:g}", got, want, b3_err, 1.0, faults)
        print(f"B3 stats {stats.flatten().tolist()} plain "
              f"{wstats.flatten().tolist()}")
        torch.testing.assert_close(stats, wstats, rtol=1e-4, atol=1e-5)
        errs.append(float((got.float() - want).abs().max()))
        del got, want, faults
    report["fused_agg_corr_norm"]["max_abs_err"] = max(errs)
    del v

    # B4 (intra site, pos_w 1.0): quantized (the main path) and float.
    q, k = inputs(gen, 32, dev, u)
    print(f"B4 inputs: clip {CLIP_ON} clamps "
          f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
    errs = []
    for clip in (CLIP_OFF, CLIP_ON):
        clip_t = torch.tensor(clip, device=dev)
        num, sc = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                        quantized=True)
        sync(dev)
        plain = lambda c, w, **kw: ma.mode_softmax_probs_plain(  # noqa: E731
            q, k, biases, grid, torch.tensor(c, device=dev), w, **kw)
        faults = {"no bias": plain(clip, 0.0, quantized=True)}
        if clip != CLIP_OFF:
            faults["no clamp"] = plain(CLIP_OFF, 1.0, quantized=True)
        wnum, wsc = plain(clip, 1.0, quantized=True)
        hold(f"B4 int8 numerators clip={clip:g}", num, wnum, num_err,
             B4_NUM_TOL, {n: f[0] for n, f in faults.items()})
        hold(f"B4 int8 row scales clip={clip:g}", sc, wsc, lambda a, b: float(
            ((a - b).abs() / b).max()), B4_SCALE_RTOL,
            {n: f[1] for n, f in faults.items()})
        errs.append(float((num.float() * sc - wnum.float() * wsc).abs().max()))
        del num, sc, wnum, wsc, faults
        for odt in (torch.float32, torch.bfloat16):
            got = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                        out_dtype=odt)
            sync(dev)
            faults = {"no bias": plain(clip, 0.0, out_dtype=torch.float32)}
            if clip != CLIP_OFF:
                faults["no clamp"] = plain(CLIP_OFF, 1.0,
                                           out_dtype=torch.float32)
            want = plain(clip, 1.0, out_dtype=torch.float32)
            hold(f"B4 {odt} clip={clip:g}", got, want, row_rel_err,
                 B4_ROW_TOL[odt], faults)
            errs.append(float((got.float() - want).abs().max()))
            del got, want, faults
    report["mode_softmax_probs"]["max_abs_err"] = max(errs)


# Training-kernel tolerances, each set from what is compared:
B6_TOL = 1e-4       # fp32 volume / dc: fp32 sums of md products in
#                     another order (1e-6) and expf: max |diff| / max |plain|
B6_DA_RTOL = 1e-4   # da: one sum over B*M*U^2 terms, fp64 partials vs fp32
B7_DC_TOL = 1e-2    # bf16 dc per row, over the row max: half an ulp 2^-8
B7_DLSUM_TOL = 1e-4  # fp32 sum over B*M of dl from the same bf16 p, g
# A clamp-mask element flips where |c| lies within the rounding of the two
# q.k^T sums of the clip; those elements are left out of the dc checks.
MASK_BAND = 1e-4


def _outside_band(q, k, clip: float):
    """(bool mask of the elements whose |c| is farther than MASK_BAND *
    clip from clip, their share)."""
    c = ma.scores(q, k, 1.0 / math.sqrt(q.shape[-1])).abs()
    keep = (c - clip).abs() > MASK_BAND * clip
    return keep, float(1.0 - keep.float().mean())


def _masked(keep, *tensors):
    return [torch.where(keep, t.float(), torch.zeros((), device=t.device))
            for t in tensors]


def _b6_dc_fault(q, k, g, vol, biases, grid, clip, agg_w, drop_term=False,
                 mask=True):
    """The plain B6 backward's dc with a planted fault: t = p (the
    agg_w * (s - vol) term dropped), or no clamp mask."""
    c, s = ma.biased_scores(q, k, biases, grid, clip, 0.5)
    p = torch.softmax(agg_w * s, dim=1)
    t = p if drop_term else p * (1.0 + agg_w * (s - vol[:, None]))
    dc = g[:, None] * t
    return torch.where(c.abs() < clip, dc, 0.0) if mask else dc


def _b7_fault(q, k, p, g, clip, row_term=True, mask=True):
    """The plain B7 backward with a planted fault: dl = p * g (the softmax
    row term dropped), or no clamp mask."""
    c = ma.scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    p32, g32 = p.float(), g.float()
    dl = p32 * (g32 - (g32 * p32).sum(-1, keepdim=True)) if row_term \
        else p32 * g32
    dc = torch.where(c.abs() < clip, dl, 0.0) if mask else dl
    return dc.to(p.dtype), dl.sum(dim=(0, 1))


def check_train_kernels(dev, gen, report, grid=CHAIRS_GRID,
                        batch=TRAIN_BATCH) -> None:
    """Phase 2, training kernels: B1 and B4 float at the chairs U (no tile
    divides it), B6 forward and backward, B7 backward, each against its
    plain version on the same peaky inputs, the clamp off and on, with
    faults planted in the plain versions.  On CPU tensors the wrappers take
    the plain versions themselves (how the tests run this phase)."""
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    u = grid[0] * grid[1]
    dgen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=dgen, device=dev)

    # B1 at this ragged U, batch 8, md 64 (inter, f2) and 32 (intra).
    for md in (64, 32):
        q, k = inputs(gen, md, dev, u, batch)
        scale = 1.0 / math.sqrt(md)
        got = float(ma.scores_global_max(q, k, scale))
        sync(dev)
        want = float(ma.scores_global_max_plain(q, k, scale))
        print(f"B1 U={u} md={md}: kernel {got:.6f} plain {want:.6f}")
        assert abs(got - want) <= B1_RTOL * abs(want), "B1 disagrees"

    # B4 float (B7's forward) at this ragged U, intra site (pos_w 1).
    q, k = inputs(gen, 32, dev, u, batch)
    for clip in (CLIP_OFF, CLIP_ON):
        clip_t = torch.tensor(clip, device=dev)
        plain = lambda c, w: ma.mode_softmax_probs_plain(  # noqa: E731
            q, k, biases, grid, torch.tensor(c, device=dev), w,
            out_dtype=torch.float32)
        want = plain(clip, 1.0)
        faults = {"no bias": plain(clip, 0.0)}
        if clip != CLIP_OFF:
            faults["no clamp"] = plain(CLIP_OFF, 1.0)
        for odt in (torch.float32, torch.bfloat16):
            got = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                        out_dtype=odt)
            sync(dev)
            hold(f"B4 U={u} {odt} clip={clip:g}", got, want, row_rel_err,
                 B4_ROW_TOL[odt], faults)
        del want, faults, got

    # B6 forward (inter site, pos_w 0.5): the raw fp32 volume.
    q, k = inputs(gen, 64, dev, u, batch)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    print(f"B6 inputs: clip {CLIP_ON} clamps "
          f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
    errs = []
    for clip in (CLIP_OFF, CLIP_ON):
        got = cv.fused_agg_corr(q, k, biases, grid, clip, 0.5, agg_w, agg_b)
        sync(dev)
        plain = lambda c, w: cv.fused_agg_corr_plain(  # noqa: E731
            q, k, biases, grid, c, w, agg_w, agg_b)
        faults = {"no bias": plain(clip, 0.0)}
        if clip != CLIP_OFF:
            faults["no clamp"] = plain(CLIP_OFF, 0.5)
        want = plain(clip, 0.5)
        hold(f"B6 forward clip={clip:g}", got, want, rel_err, B6_TOL, faults)
        errs.append(float((got - want).abs().max()))
        del got, faults
    report["fused_agg_corr"]["max_abs_err"] = max(errs)

    # B6 backward: g ~ N(1, 1) so that da is a well-conditioned sum.
    vol = want
    g = randn(batch, u, u) + 1.0
    errs = []
    for clip in (CLIP_OFF, CLIP_ON):
        dc, da = cv.agg_corr_bwd(q, k, g, vol, biases, grid, clip, 0.5,
                                 agg_w)
        sync(dev)
        wdc, wda = cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip,
                                         0.5, agg_w)
        keep, band = _outside_band(q, k, clip)
        print(f"B6 backward clip={clip:g}: {band:.2e} of dc in the mask band")
        fdc = {"t = p": _b6_dc_fault(q, k, g, vol, biases, grid, clip,
                                     agg_w, drop_term=True)}
        if clip != CLIP_OFF:
            fdc["no clamp mask"] = _b6_dc_fault(q, k, g, vol, biases, grid,
                                                clip, agg_w, mask=False)
        got_m, want_m = _masked(keep, dc, wdc)
        hold(f"B6 backward dc clip={clip:g}", got_m, want_m, rel_err, B6_TOL,
             {n: _masked(keep, f)[0] for n, f in fdc.items()})
        del fdc, got_m, want_m
        hold(f"B6 backward da clip={clip:g}", da, wda,
             lambda a, b: float((a - b).abs() / b.abs()), B6_DA_RTOL,
             {"no bias": cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid,
                                               clip, 0.0, agg_w)[1]})
        errs.append(float(((dc - wdc) * keep).abs().max()))
        del dc, wdc, keep
    report["agg_corr_bwd"]["max_abs_err"] = max(errs)
    del vol, g, q, k

    # B7 backward at the f2 (md 64, pos_w 0.5) and intra (md 32) shapes,
    # from the site's own bf16 probs and a bf16 cotangent.
    errs = []
    for md, pos_w in ((64, 0.5), (32, 1.0)):
        q, k = inputs(gen, md, dev, u, batch)
        g = randn(batch, 4, u, u).to(torch.bfloat16)
        for clip in (CLIP_OFF, CLIP_ON):
            p = ma.mode_softmax_probs_plain(
                q, k, biases, grid, torch.tensor(clip, device=dev), pos_w,
                out_dtype=torch.bfloat16)
            dc, dlsum = pv.probs_bwd(q, k, p, g, clip)
            sync(dev)
            wdc, wdlsum = pv.probs_bwd_plain(q, k, p, g, clip)
            # dl = p * g: the softmax row term dropped.
            no_row = _b7_fault(q, k, p, g, clip, row_term=False)
            keep, band = _outside_band(q, k, clip)
            print(f"B7 backward md={md} clip={clip:g}: {band:.2e} of dc in "
                  "the mask band")
            fdc = {"no row term": no_row[0]}
            if clip != CLIP_OFF:
                fdc["no clamp mask"] = _b7_fault(q, k, p, g, clip,
                                                 mask=False)[0]
            got_m, want_m = _masked(keep, dc, wdc)
            hold(f"B7 backward dc md={md} clip={clip:g}", got_m, want_m,
                 row_rel_err, B7_DC_TOL,
                 {n: _masked(keep, f)[0] for n, f in fdc.items()})
            hold(f"B7 backward dlsum md={md} clip={clip:g}", dlsum, wdlsum,
                 rel_err, B7_DLSUM_TOL, {"no row term": no_row[1]})
            errs.append(float((dlsum - wdlsum).abs().max()))
            del p, dc, dlsum, wdc, wdlsum, no_row, fdc, got_m, want_m, keep
        del q, k, g
    report["probs_bwd"]["max_abs_err"] = max(errs)


def check_oracle(dev) -> dict:
    """Phase 3: the 128x128 oracle on the card."""
    img1, img2, want, tree = load_oracle_npz(ORACLE)
    sd = state_dict_from_flax(tree)
    errs = {}
    for label, mp, bound in (("fp32", False, FULLPREC_BOUND_PX),
                             ("mixed", True, BF16_BOUND_PX)):
        model = create_model(craft_config(mixed_precision=mp), device=dev)
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            _, flows = model(torch.from_numpy(img1).to(dev),
                             torch.from_numpy(img2).to(dev), iters=ITERS)
        got = flows[-1].cpu().numpy()
        err = float(np.abs(got - want).max())
        print(f"oracle {label}: max |flow diff| {err:.3e} px "
              f"(mean {float(np.abs(got - want).mean()):.3e}, bound {bound})")
        assert np.isfinite(got).all() and err < bound, f"oracle {label}"
        errs[label] = err
    return errs


def main_path_model(dev):
    """craft_config(mixed_precision=True) with the oracle's full-width
    weights, in eval mode on `dev`."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    model = create_model(craft_config(mixed_precision=True), device=dev)
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    return model


def frame_pairs(dev, n: int, seed: int = 0):
    """(InputPadder, n seeded noise frame pairs at FRAME_H x FRAME_W padded
    to 440x1024, NHWC in [0, 255] on `dev`)."""
    padder = InputPadder((1, FRAME_H, FRAME_W, 3), mode="sintel")
    rng = np.random.RandomState(seed)

    def frame():
        return torch.from_numpy(rng.uniform(0, 255, (
            1, FRAME_H, FRAME_W, 3)).astype(np.float32)).to(dev)
    return padder, [padder.pad(frame(), frame()) for _ in range(n)]


def serve(model, pairs):
    """Answer each pair with ITERS iterations, synchronizing after each:
    (host ms per pair, each pair's final padded flow)."""
    times, flows = [], []
    with torch.inference_mode():
        for a, b in pairs:
            t0 = time.perf_counter()
            _, f = model(a, b, iters=ITERS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            flows.append(f[-1])
    return times, flows


def main_path(dev, n_pairs: int = 3) -> dict:
    """Phase 4: full-size serving of seeded frame pairs, after one warm-up
    pair."""
    model = main_path_model(dev)
    padder, pairs = frame_pairs(dev, n_pairs + 1)
    serve(model, pairs[:1])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    times, flows = serve(model, pairs[1:])
    counts = {fn.__name__: fn.launches for fn in ma.KERNELS}
    for flow in flows:
        out = padder.unpad(flow)
        assert out.shape == (1, FRAME_H, FRAME_W, 2)
        assert bool(torch.isfinite(out).all())
    res = {"pair_ms": times, "pairs_per_s": n_pairs / (sum(times) / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts}
    print("main path:", json.dumps(res))
    for name, n in counts.items():
        assert n > 0, f"{name} was not launched on the main path"
    return res


# Oracle training step, card against CPU (fp32, TF32 off): the loss as the
# forward's fp32 sums in another order; BatchNorm running stats; each module
# group's gradient in the norm of the group, within 1e-2: the encoders'
# norm backward (E[x^2] - E[x]^2, the JAX package's form) amplifies the two
# devices' different rounding, and on these frames the CPU's own fp32 fnet
# gradient is 1.45e-3 from a float64 run.  A wrong kernel moves a group by
# O(1).
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STATS_TOL = 1e-5, 1e-2, 1e-4
GROUPS = ("fnet", "cnet", "f2_trans", "att", "corr_fn", "update_block")
# The kernels a training step launches (B1, B4 float, B6 and B7).
TRAIN_KERNELS = ("scores_global_max", "mode_softmax_probs", "fused_agg_corr",
                 "agg_corr_bwd", "probs_bwd")


def _no_dropout(cfg):
    return cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0) for site in ("inter", "f2",
                                                       "intra")})


def _oracle_train_step(dev, batch):
    """One fp32 training step (dropout off, 2 iterations) from the oracle
    weights on `dev`: (metrics, {name: gradient}, {name: buffer})."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    cfg = _no_dropout(craft_config(mixed_precision=False))
    state = create_train_state(cfg, state_dict_from_flax(tree), device=dev,
                               num_steps=100)
    step = make_train_step(cfg, iters=2)
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    model = state.model
    return (host_metrics(metrics),
            {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()},
            {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if "running_" in n})


def check_oracle_train(dev) -> None:
    """Phase 3, training: one fp32 step on the card (kernels) against the
    same step on the CPU (plain versions)."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    rng = np.random.RandomState(0)
    batch = {"image1": torch.from_numpy(img1),
             "image2": torch.from_numpy(img2),
             "flow": torch.from_numpy(
                 (rng.randn(*img1.shape[:3], 2) * 3).astype(np.float32)),
             "valid": torch.ones(img1.shape[:3])}
    launch.reset_launch_counts()
    got, grads, stats = _oracle_train_step(dev, batch)
    counts = launch.launch_counts()
    want, wgrads, wstats = _oracle_train_step(torch.device("cpu"), batch)
    print("oracle train step: card", json.dumps(got))
    print("oracle train step: cpu ", json.dumps(want))
    print("oracle train step launches:", json.dumps(counts))
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    print(f"oracle train step: loss rel diff {rel:.3e} "
          f"(bound {TRAIN_LOSS_RTOL:g})")
    assert rel <= TRAIN_LOSS_RTOL, "oracle train step: loss"
    assert all(np.isfinite(v) for v in got.values())
    bad = []
    for group in GROUPS:
        names = [n for n in wgrads if n.startswith(group)]
        num = sum(float(((grads[n] - wgrads[n]) ** 2).sum()) for n in names)
        den = sum(float((wgrads[n] ** 2).sum()) for n in names)
        err, tol = math.sqrt(num / den), TRAIN_GRAD_TOL
        worst = max(names, key=lambda n: float(
            (grads[n] - wgrads[n]).abs().max()
            / wgrads[n].abs().max().clamp(min=1e-30)))
        print(f"oracle train step: {group} gradient rel diff {err:.3e} "
              f"(bound {tol:g}); worst tensor {worst}")
        if err > tol:
            bad.append(group)
    assert not bad, f"oracle train step: gradients of {bad}"
    serr = max(float(((stats[n] - wstats[n]).abs()
                      / (wstats[n].abs() + 1e-3)).max()) for n in wstats)
    print(f"oracle train step: batch stats rel diff {serr:.3e} "
          f"(bound {TRAIN_STATS_TOL:g})")
    assert serr <= TRAIN_STATS_TOL, "oracle train step: batch stats"
    for name in TRAIN_KERNELS:
        assert counts[name] > 0, f"oracle train step: {name} not launched"


def train_batch(dev, seed: int = 0) -> dict:
    """A seeded chairs-size batch: noise frames in [0, 255], a smooth-ish
    flow of a few pixels, every pixel valid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (TRAIN_BATCH, CROP_H, CROP_W)
    return {"image1": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
            "image2": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
            "flow": torch.randn(*shape, 2, generator=gen, device=dev) * 4,
            "valid": torch.ones(*shape, device=dev)}


def train_setup(dev):
    """(state, step, batch) of the training path:
    craft_config(mixed_precision=True) with the oracle's full-width weights,
    dropout at the config's rates, 12 iterations, a chairs-size batch."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    cfg = craft_config(mixed_precision=True)
    state = create_train_state(cfg, state_dict_from_flax(tree), device=dev,
                               num_steps=1000)
    return state, make_train_step(cfg, iters=ITERS), train_batch(dev)


def train_steps(state, step, batch, n: int):
    """Run n steps, synchronizing after each: (state, host ms per step,
    each step's host metrics)."""
    times, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(host_metrics(m))
    return state, times, metrics


def train_path(dev, n_steps: int = 3) -> dict:
    """Phase 4, training: one warm-up step, then n_steps timed steps."""
    state, step, batch = train_setup(dev)
    state, _, _ = train_steps(state, step, batch, 1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    state, times, metrics = train_steps(state, step, batch, n_steps)
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    counts = launch.launch_counts()
    res = {"step_ms": times,
           "samples_per_s": TRAIN_BATCH * n_steps / (sum(times) / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss": losses, "grad_norm": norms,
           "launches_per_step": {k: v / n_steps for k, v in counts.items()}}
    print("training path:", json.dumps(res))
    assert all(math.isfinite(x) for x in losses + norms), "non-finite step"
    for name in TRAIN_KERNELS:
        assert counts[name] > 0, f"{name} was not launched on the train path"
    for name in ("flash_mode_attention", "fused_agg_corr_norm"):
        assert counts[name] == 0, f"{name} was launched on the train path"
    res["launches"] = counts
    return res


def time_train_kernels(dev, gen, report) -> None:
    """Phase 5, training: times at the chairs shapes (B=8, U=2852) beside
    each plain version and the bound."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    grid = CHAIRS_GRID
    u = grid[0] * grid[1]
    B, n = TRAIN_BATCH, TRAIN_BATCH * 4 * u * u
    dgen = torch.Generator(device=dev).manual_seed(2)
    q64, k64 = inputs(gen, 64, dev, u, B)
    q32, k32 = inputs(gen, 32, dev, u, B)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    clip = torch.tensor(CLIP_OFF, device=dev)
    vol = cv.fused_agg_corr(q64, k64, biases, grid, clip, 0.5, agg_w, agg_b)
    g_vol = torch.randn(B, u, u, generator=dgen, device=dev)
    p64 = ma.mode_softmax_probs(q64, k64, biases, grid, clip, 0.5)
    g_p = torch.randn(B, 4, u, u, generator=dgen, device=dev).to(
        torch.bfloat16)
    qk_flops = lambda md: 2.0 * n * md  # noqa: E731
    qk_bytes = lambda md: 2 * B * 4 * u * md * 2  # noqa: E731
    fwd = (q64, k64, biases, grid, clip, 0.5, agg_w, agg_b)
    bwd = (q64, k64, g_vol, vol, biases, grid, clip, 0.5, agg_w)
    pb = (q64, k64, p64, g_p, clip)
    cases = {
        "fused_agg_corr": (
            lambda: cv.fused_agg_corr(*fwd),
            lambda: cv.fused_agg_corr_plain(*fwd),
            bound_ms(qk_flops(64), qk_bytes(64) + 4 * B * u * u)),
        "agg_corr_bwd": (
            lambda: cv.agg_corr_bwd(*bwd), lambda: cv.agg_corr_bwd_plain(*bwd),
            bound_ms(qk_flops(64), qk_bytes(64) + 2 * 4 * B * u * u
                     + 4 * n + 4)),
        "probs_bwd": (
            lambda: pv.probs_bwd(*pb), lambda: pv.probs_bwd_plain(*pb),
            bound_ms(qk_flops(64), qk_bytes(64) + 3 * 2 * n + 4 * u * u)),
    }
    for name, (kern, plain, (bms, by)) in cases.items():
        r = report[name]
        r["ms"] = time_ms(kern, 5)
        r["plain_ms"] = time_ms(plain, 2)
        r["bound_ms"], r["bound_by"] = bms, by
        print(f"{name} (chairs, B=8): {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {bms:.4f} ms ({by}), library "
              "None")
        torch.cuda.empty_cache()
    del vol, g_vol, p64
    # The intra shape (md 32) of B7, and B4 bf16 / B1 at the chairs U.
    p32 = ma.mode_softmax_probs(q32, k32, biases, grid, clip, 1.0)
    extra = {
        "probs_bwd md=32": (
            lambda: pv.probs_bwd(q32, k32, p32, g_p, clip),
            lambda: pv.probs_bwd_plain(q32, k32, p32, g_p, clip),
            bound_ms(qk_flops(32), qk_bytes(32) + 3 * 2 * n + 4 * u * u)),
        "mode_softmax_probs bf16 md=32": (
            lambda: ma.mode_softmax_probs(q32, k32, biases, grid, clip, 1.0),
            lambda: ma.mode_softmax_probs_plain(q32, k32, biases, grid, clip,
                                                1.0),
            bound_ms(qk_flops(32), qk_bytes(32) + 2 * n)),
        "mode_softmax_probs bf16 md=64": (
            lambda: ma.mode_softmax_probs(q64, k64, biases, grid, clip, 0.5),
            lambda: ma.mode_softmax_probs_plain(q64, k64, biases, grid, clip,
                                                0.5),
            bound_ms(qk_flops(64), qk_bytes(64) + 2 * n)),
        "scores_global_max md=64": (
            lambda: ma.scores_global_max(q64, k64, 0.125),
            lambda: ma.scores_global_max_plain(q64, k64, 0.125),
            bound_ms(qk_flops(64), qk_bytes(64) + 4)),
    }
    for label, (kern, plain, (bms, by)) in extra.items():
        ms, pms = time_ms(kern, 5), time_ms(plain, 2)
        print(f"{label} (chairs, B=8): {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.4f} ms ({by})")
        torch.cuda.empty_cache()


def time_kernels(dev, gen, report) -> None:
    """Phase 5: times at the main-path shapes."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    grid = (H8, W8)
    clip = torch.tensor(1e30, device=dev)
    q64, k64 = inputs(gen, 64, dev)
    q32, k32 = inputs(gen, 32, dev)
    v = torch.randn(1, 4, U, 256, generator=gen).to(dev, torch.bfloat16)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    n = 4 * U * U
    qk_flops = lambda md: 2.0 * n * md  # noqa: E731
    qk_bytes = lambda md: 2 * 4 * U * md * 2  # noqa: E731
    dense = (0.5 * ma.sliding_pos_biases(biases, *grid)).to(torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q64, k64, v, attn_mask=dense)
    flash_args = (q64, k64, v, biases, grid, clip, 0.5)
    corr_args = (q64, k64, biases, grid, 100.0, 0.5, agg_w, agg_b)
    probs_args = (q32, k32, biases, grid, clip, 1.0)

    cases = {
        "scores_global_max": (
            lambda: ma.scores_global_max(q64, k64, 0.125),
            lambda: ma.scores_global_max_plain(q64, k64, 0.125), None,
            bound_ms(qk_flops(64), qk_bytes(64) + 4)),
        "flash_mode_attention": (
            lambda: ma.flash_mode_attention(*flash_args),
            lambda: ma.flash_mode_attention_plain(*flash_args), sdpa,
            bound_ms(qk_flops(64) + 2.0 * n * 256,
                     qk_bytes(64) + 2 * 2 * 4 * U * 256)),
        "fused_agg_corr_norm": (
            lambda: ma.fused_agg_corr_norm(*corr_args),
            lambda: ma.fused_agg_corr_norm_plain(*corr_args), None,
            bound_ms(qk_flops(64), qk_bytes(64) + 2 * U * U + 16)),
        "mode_softmax_probs": (
            lambda: ma.mode_softmax_probs(*probs_args, quantized=True),
            lambda: ma.mode_softmax_probs_plain(*probs_args, quantized=True),
            None,
            bound_ms(qk_flops(32), qk_bytes(32) + n + 4 * 4 * U)),
    }
    for name, (kern, plain, lib, (bms, by)) in cases.items():
        r = report[name]
        r["ms"] = time_ms(kern, 5)
        r["plain_ms"] = time_ms(plain, 2)
        r["library_ms"] = time_ms(lib, 5) if lib is not None else None
        r["bound_ms"], r["bound_by"] = bms, by
        print(f"{name}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), library {r['library_ms']}")
        torch.cuda.empty_cache()
    md32 = time_ms(lambda: ma.scores_global_max(q32, k32, 0.17677669), 5)
    print(f"scores_global_max at the intra shape (md 32): {md32:.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build.build_all()
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    fn_of = {"scores_global_max": ("scores_max", "scores_global_max"),
             "flash_mode_attention": ("flash_attn", "flash_mode_attention_mt"),
             "fused_agg_corr_norm": ("corr_norm", "fused_agg_corr_norm_mt"),
             "mode_softmax_probs": ("softmax_probs", "mode_softmax_probs_mt")}
    lines = {"scores_global_max": 76, "flash_mode_attention_mt": 295,
             "fused_agg_corr_norm_mt": 646, "mode_softmax_probs_mt": 900}
    report = {name: {"name": name, "route": "cuda",
                     "source": SOURCE.format(src),
                     "replaces": TPU_KERNEL.format(tpu) + f":{lines[tpu]}",
                     "launches": None, "max_abs_err": None, "ms": None,
                     "plain_ms": None, "bound_ms": None, "bound_by": None,
                     "library_ms": None}
              for name, (src, tpu) in fn_of.items()}
    pallas = "craft_tpu/ops/pallas/"
    for name, src, tpu in (
            ("fused_agg_corr", "agg_corr",
             TPU_KERNEL.format("fused_agg_corr_mt:394")),
            ("agg_corr_bwd", "agg_corr",
             pallas + "corr_vjp.py:_pallas_agg_corr_bwd:75"),
            ("probs_bwd", "probs_bwd",
             pallas + "probs_vjp.py:_pallas_probs_bwd:80")):
        report[name] = dict(report["scores_global_max"], name=name,
                            source=SOURCE.format(src), replaces=tpu)

    gen = torch.Generator().manual_seed(0)
    check_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_train_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_oracle(dev)
    check_oracle_train(dev)
    res = main_path(dev)
    for name, n in res["launches"].items():
        report[name]["launches"] = n
    torch.cuda.empty_cache()
    tres = train_path(dev)
    for name in ("fused_agg_corr", "agg_corr_bwd", "probs_bwd"):
        report[name]["launches"] = tres["launches"][name]
    torch.cuda.empty_cache()
    time_kernels(dev, gen, report)
    time_train_kernels(dev, gen, report)

    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
