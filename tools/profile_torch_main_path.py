"""Where the time goes in the PyTorch port's main path, on one GPU.

    python3 tools/profile_torch_main_path.py [--pairs 2] [--train]
        [--config main|lsinu|f2radius|f1_shared|f1_private|raft|gma|
                  craft_gma|craft_nogma|craft_f2_none|modes1|modes8]

The main path of chip_smoke.py (its model, frame pairs and serving loop):
full CRAFT at 436x1024 padded to 440x1024, bf16 with int8 intra probs, 12
iterations, the weights of the oracle snapshot; with --config, the same
served under lsinu (all three sites), --f2radius 7 or two-way
correlation, --f1 shared or private (chip_smoke.py's serving_model), or
another family with its seeded weights (chip_smoke.py's
family_model and family_train_setup), or one or eight modes at every
SETrans site (modes1, modes8: chip_smoke.py's mode_model and
mode_train_setup).  After one warm-up pair it
times `--pairs` frame pairs on the host clock, then traces the same pairs
with torch.profiler, and prints per pair: the host wall time (untraced and
traced), the kernel time under each phase range (craft.* in
FlowModel.forward and the train step), kernel time by family, the device
busy share (kernel time over the untraced wall time), and the 20 costliest
kernels.  With --train the unit is a training step of chip_smoke.py's
training path (368x496, batch 8; under --config lsinu, f2radius,
f1_shared or f1_private its train_setup of that config) instead of a pair.  The last line is one
JSON object with those numbers.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("B1 scores_max", ("scores_max_kernel", "scores_max_wgmma_kernel",
                       "max_reduce_kernel")),
    # The dense-table kernels share their window twins' names: under lsinu
    # and --f2radius the B2, B4 and B6 rows hold B8, B4 dense and B6 dense.
    ("B2 / B8 flash_attn", ("flash_attn_kernel", "flash_wgmma_kernel")),
    # B9's halves (--seq_parallel) run B3's sweep kernels.
    ("B3 corr_norm", ("corr_stats_kernel", "corr_moments_kernel",
                      "corr_write_kernel", "corr_sweep_kernel",
                      "corr_shard_sums_kernel", "corr_finish_kernel")),
    ("B4 / B4 dense probs", ("probs_kernel", "probs_wgmma_kernel")),
    # B6 backward and B7: their fp32 bodies and their bf16 (wgmma) bodies.
    ("B6 agg_corr_bwd", ("agg_corr_bwd_kernel", "agg_bwd_wgmma_kernel",
                         "sum_partials_kernel")),
    ("B6 / B6 dense agg_corr", ("agg_corr_kernel",
                                "agg_corr_wgmma_kernel")),
    ("B7 probs_bwd", ("probs_bwd_kernel", "probs_bwd_wgmma_kernel",
                      "probs_row_kernel")),
    ("B5 lookup_bwd", ("lookup_bwd_kernel",)),
    ("B5 lookup", ("lookup_fwd_kernel",)),
    # B10, the fused SepConvGRU pass (SepConvGRU(fused='on'); no FlowModel
    # path builds it, so a model profile shows it only when a caller does).
    # Its fp32 tiles, and its bf16 (wgmma) tiles with their weights' layout.
    ("B10 gru_pass", ("gru_zr_kernel", "gru_q_kernel",
                      "gru_fwd_wgmma_kernel", "gru_pack_taps_kernel")),
    # B10's backward: its fp32 tiles and its bf16 (wgmma) tiles.
    ("B10 gru_pass_bwd", ("gru_bwd_elem_kernel", "gru_drh_kernel",
                          "gru_dhx_kernel", "gru_wgrad_kernel",
                          "gru_tconv_wgmma_kernel", "gru_wgrad_wgmma_kernel",
                          "sum_splits_kernel")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "winograd")),
    ("matmul", ("gemm", "cutlass", "sm90", "ampere")),
    ("gather/index", ("gather", "index", "scatter")),
)


def _self_dev_time(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def _phase_kernel_ms(events, n: int) -> dict:
    """Kernel time under each craft.* range, per pair, attributed on the
    device timeline.  The profiler records each range also as a device-side
    annotation spanning its kernels; a kernel belongs to the annotation its
    start falls in.  (The host-side op tree would miss the kernels launched
    through ctypes: no PyTorch op sits above them.)"""
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name.startswith("craft."))
    starts = [s[0] for s in spans]
    out = {}
    for e in dev:
        if e.name.startswith("craft."):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        name = spans[i][2] if i >= 0 and t < spans[i][1] else "(no phase)"
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2,
                    help="frame pairs (or training steps) to time")
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of serving")
    ap.add_argument("--config", default="main",
                    choices=["main", "lsinu", "f2radius",
                             *chip_smoke.TWO_WAY, *chip_smoke.FAMILIES,
                             *chip_smoke.MODE_FULL],
                    help="the configuration served or trained")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card)
    family = args.config in chip_smoke.FAMILIES
    modes = args.config in chip_smoke.MODE_FULL
    if args.train:
        state, step, batch = (
            chip_smoke.family_train_setup(dev, args.config) if family
            else chip_smoke.mode_train_setup(dev, args.config) if modes
            else chip_smoke.train_setup(dev, args.config))

        def wall_ms_per_pair():
            return sum(chip_smoke.train_steps(state, step, batch,
                                              args.pairs)[1]) / args.pairs

        chip_smoke.train_steps(state, step, batch, 1)  # warm-up
    else:
        model = (chip_smoke.family_model(dev, args.config, True) if family
                 else chip_smoke.mode_model(dev, args.config, True) if modes
                 else chip_smoke.serving_model(dev, args.config))
        _, pairs = chip_smoke.frame_pairs(dev, args.pairs + 1)

        def wall_ms_per_pair():
            return sum(chip_smoke.serve(model, pairs[1:])[0]) / args.pairs

        chip_smoke.serve(model, pairs[:1])  # warm-up
    wall_ms = wall_ms_per_pair()  # without the profiler's overhead
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = wall_ms_per_pair()

    n = args.pairs
    phases = _phase_kernel_ms(prof.events(), n)
    families, kernels, total = {}, [], 0.0
    for e in prof.key_averages():
        t = _self_dev_time(e) / 1e3 / n
        if t <= 0 or e.key.startswith("craft.") or e.device_type != \
                torch.autograd.DeviceType.CUDA:
            continue
        total += t
        kernels.append((t, e.count // n, e.key))
        low = e.key.lower()
        fam = next((f for f, subs in FAMILIES
                    if any(s.lower() in low for s in subs)), "elementwise/other")
        families[fam] = families.get(fam, 0.0) + t
    kernels.sort(reverse=True)
    print(f"host wall per pair {wall_ms:.3f} ms ({traced_wall_ms:.3f} ms "
          f"traced); device kernel time {total:.3f} ms; busy share "
          f"{total / wall_ms:.3f}")
    for name, t in sorted(phases.items(), key=lambda x: -x[1]):
        print(f"phase {name}: {t:.3f} ms of kernels")
    for fam, t in sorted(families.items(), key=lambda x: -x[1]):
        print(f"family {fam}: {t:.3f} ms")
    for t, count, name in kernels[:20]:
        print(f"kernel {t:8.3f} ms  x{count:<4d} {name[:110]}")
    print(json.dumps({"card": card, "config": ("train " if args.train
                                                else "") + args.config,
                      "wall_ms_per_pair": wall_ms,
                      "traced_wall_ms_per_pair": traced_wall_ms,
                      "device_ms_per_pair": total,
                      "busy_share": total / wall_ms, "phases_ms": phases,
                      "families_ms": families}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
