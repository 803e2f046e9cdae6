"""GPU smoke run of the PyTorch/CUDA port (craft_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the four hand-written CUDA kernels from craft_tpu_torch/csrc into
build/kernels/, then runs these phases and fails on the first that fails:

  1. card: prints `nvidia-smi --query-gpu=name,power.limit`; TF32 off.
  2. kernels: each kernel against its plain PyTorch version on seeded
     inputs at the main-path shapes (B=1, M=4, 440x1024 -> U=7040), the
     clamp off and on; a dropped bias and a missing clamp, planted in the
     plain version, must each fall outside the bound.
  3. oracle: full-width CRAFT with the weights of
     tests/data/oracle_craft_128.npz at 128x128, 12 iterations, against the
     reference flow: fp32 within 1e-3 px, the mixed-precision config
     within 0.15 px.
  4. main path: craft_config(mixed_precision=True), 436x1024 padded to
     440x1024, 12 iterations, one warm-up pair then 3 seeded frame pairs;
     per-pair ms, frame-pairs/s and peak device memory.  Every kernel's
     launch count is zeroed just before and read just after.
  5. kernel times over CUDA events at the main-path shapes, beside each
     plain version, the bound and (B2) scaled_dot_product_attention.

Prints the card line and a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is unavailable.  Imports nothing of JAX.
"""

from __future__ import annotations

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
from craft_tpu_torch.ops.kernels import build
from craft_tpu_torch.ops.kernels import mode_attention as ma
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


def inputs(gen, md, dev, u=U):
    """Seeded q, k [1, 4, u, md] bf16 with scores of std QK_STD^2."""
    def one():
        x = torch.randn(1, 4, u, md, generator=gen) * QK_STD
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
    ma.reset_launch_counts()
    times, flows = serve(model, pairs[1:])
    counts = ma.launch_counts()
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

    gen = torch.Generator().manual_seed(0)
    check_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_oracle(dev)
    res = main_path(dev)
    for name, n in res["launches"].items():
        report[name]["launches"] = n
    torch.cuda.empty_cache()
    time_kernels(dev, gen, report)

    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
