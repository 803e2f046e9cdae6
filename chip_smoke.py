"""GPU smoke run of the PyTorch/CUDA port (craft_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from craft_tpu_torch/csrc into
build/kernels/ (one nvcc per source, all started together), then runs
these phases and fails on the first that fails:

  1. card: prints `nvidia-smi --query-gpu=name,power.limit`; TF32 off.
  2. kernels: each serving kernel (B1-B4) against its plain PyTorch
     version on seeded inputs at the main-path shapes (B=1, M=4, 440x1024
     -> U=7040; B3 also at the KITTI grid, 47x156), the clamp off and on;
     a dropped bias and a missing clamp (for B2 and B3 also the window's
     outer ring dropped), planted in the plain version, must each fall
     outside the bound.  B1 must return a planted peak (the last mode, the
     last query row, the last ragged key) exactly at the serving (md 64
     and 32), chairs and KITTI shapes and on the last rows of a shard; the
     plain version with its last key tile or its mode 3 dropped must miss
     it.  B4 int8 and bf16 also at the KITTI (47x156) and chairs (B=8,
     46x62) shapes; for int8 a row max taken over one key tile is planted
     too (at serving as well).
     Then the training kernels at the chairs shapes (B=8, M=4, 46x62 ->
     U=2852, md 64 and 32): B1 and B4 float at this ragged U, B6 forward,
     B6 backward (dc, da) and B7 backward (dc, dlsum), each with faults
     planted in its plain version, among them faults against the bf16
     bodies' tiles (B6 forward: every mode's vol from mode 0's scores, the
     window over one warpgroup's 32 keys of each tile, a normalisation
     offset left in; B6 backward: every mode's dc from mode 0's scores, da
     over the first key group; B7: the row term over the first 128-column
     tile, dlsum of the last bm); B6 forward also at md 32 and B = 1, B6
     backward at B = 1 and B7 at BM = 1, and each launched twice, which
     must give the same bits.
     Then B5, the pyramid lookup, forward
     and backward at the serving, chairs and oracle shapes, with four
     faults planted in its plain version; then B5 at D = 2 (the two-way
     pyramid's 8 planes) at the same shapes, with the two planes of a
     level swapped, every plane scaled as a level of its own, the channels
     in (level, i, j, d) order and a plane's backward written into the
     other planted.  Then the dense-table kernels
     B8, B6 dense and B4 dense at the serving shapes: no table and a
     seeded one, U1 != U2 with ragged keys, the clamp off and on, bf16 and
     fp32, with a transposed table, a table scaled by pos_w twice, ragged
     keys left unmasked and a missing clamp planted in the plain versions
     (B6 dense also its vol from mode 0's scores, the table read with the
     other 64-row half of a block and a normalisation offset, and two
     launches that must give the same bits).
     Then sequence parallelism: B9 (sums and write) on every shard of the
     serving grid split over 1, 2 and 4 ranks (55 rows: 28/27,
     14/14/14/13), clamp off and on, bf16 and fp32, against its plain
     versions, and the shards assembled against B3's plain volume, with the
     row offset dropped, the moments over the shard's own element count
     and the shard's own max as the clamp predicate planted in the plain
     versions; B1, B2 and B4 on a shard with its row offset (offset
     dropped planted); B8, B6 dense and B4 dense on every row shard of
     the serving grid at 2 and 4 ranks and of the KITTI grid at 2 (24/23
     rows, off the kernels' row tiles), every rank a thread whose
     collectives meet in one process (``LocalGroup``), its clamp from
     ``sp_clip``, with no table (lsinu) and with the shard's rows of a
     table (B8: the --f2radius mask and window as the dense site builds
     them, against the rows of the whole table), bf16 and fp32, the
     table's rows from grid row 0 and the shard's own max as the clamp
     predicate planted, and B6 dense's shards normed by
     ``build_pyramid(shard=...)`` with every rank's moments, the shard's
     own moments planted; B9 in both directions of the two-way volume
     through ``sp_fused_agg_corr_norm_mt``, the first direction's moments
     planted in the second; GMA's
     attention (position and content, max_pos_size 40 below the grid's
     sides) on rank 1 of 2 against the unsharded rows, x0 = 0 planted.
     Then B10, the fused SepConvGRU pass, at the GRU's
     full width (hidden 128, x 384) on the serving grid (B=1, 55x128) and
     the chairs grid (B=8, 46x62), bf16 and fp32: both passes (horizontal,
     stride 1 with the image-row mask; vertical, stride W over the same
     rows), forward and backward, with the row mask dropped, q over h,
     the blend reversed, r h read as zero across the forward's 64-row
     tiles, halo rows counted twice in the weight gradients
     and dh without its drh r term planted in the plain versions; two
     backwards of one input must be bit-identical.  Then B3 and B5 at the
     HD1K grid (136 x 320, U = 43520: a 3.79e9-byte bf16 volume, past
     2^31 bytes) on the last two grid rows against their plain versions
     (B3's moments and raw max taken over whole grid rows at a time), with
     a dropped bias and another query's slab planted.  Then B2 at the
     lazy intra aggregator's width (F 128, md 32), bf16 and fp32, clamp off
     and on, at the serving grid, a ragged grid (37 x 61) and HD1K's last
     two grid rows, a dropped bias, a missing clamp and keys 64-127 of
     every 128-key tile dropped (against the pipelined body's tiles)
     planted.  Then the
     mode counts other than 4 (check_mode_kernels): the checks above
     (check_kernels, check_train_kernels, check_dense_kernels,
     check_sp_kernels, check_b2_lazy), each taking the 256-wide sites'
     and the intra site's (modes, mode dim), run again at 1, 2, 8, 16, 32,
     64, 128 and 256 modes of the 256-wide sites (md 256 to 1) and 1, 2,
     8, 16, 32, 64 and 128 of the intra site (md 128 to 1), bf16 and fp32;
     the training kernels at the chairs grid with batch 8 at 1 and 8
     modes and batch 2 at the others; past 32 modes at the cut grids
     MODE_CUT_GRID and MODE_CUT_TRAIN_GRID (the plain versions' fp32
     scores at 256 modes would take 50.7 GB on the serving grid); beside
     each check's own faults, the modes past the first group of four
     dropped (the aggregating kernels), q's first two 64-wide md chunks
     swapped (md 128 and 256), B6 backward's dc in the next mode's plane,
     and below md 16 a nonzero pad column (the per-mode kernels' padded q
     and k), modes 16-19 skipped and the running max reset between groups
     of four modes (the aggregating kernels) planted, one fault at a
     time; at one and two modes (md 256, 128) also B2 and B8 (no table,
     and the --f2radius table) on the serving grid and a ragged one (37 x
     61: 4 and 3 key splits), with q.k over md chunk 3 skipped planted at
     md 256.
  3. oracle: full-width CRAFT with the weights of
     tests/data/oracle_craft_128.npz at 128x128, 12 iterations, against the
     reference flow: fp32 within 1e-3 px, the mixed-precision config
     within 0.15 px.  The same tree with seeded pos_fc weights in place of
     the sliding windows, under lsinu (all three sites), on the card
     against the CPU within the same bounds.  Then one fp32 training step
     (dropout off, 2 iterations) on the card through the kernels against
     the same step on the CPU through the plain versions: loss, every
     gradient, batch stats, and its exact launches; the same under lsinu
     (every site on the plain path: B5 alone).  Then remat_att_sites on
     against off: one fp32 step with dropout on (128x128, batch 2, 2
     iterations) of the main config (its recompute relaunches B1, B4, B6)
     and under lsinu, cuDNN deterministic: the loss and every gradient
     bit-identical, and a dropout-off step moving them.
  4. main path: craft_config(mixed_precision=True), 436x1024 padded to
     440x1024, 12 iterations, one warm-up pair then 3 seeded frame pairs;
     per-pair ms, frame-pairs/s and peak device memory.  Every kernel's
     launch count is zeroed just before and read just after (B5: 12 per
     pair; 12 forward and 12 backward per training step).  Then the
     training path: the same config at 368x496 (the chairs crops), batch
     8, 12 iterations, dropout at the config's rates, one warm-up step and
     3 timed steps; ms per step, samples/s, peak memory, each step's loss
     and grad norm, and the launches of its own run (exact, with the
     attention sites recomputed in the backward: B1 6, B4 4, B6 2, B6
     backward 1, B7 2, B5 and its backward 12 a step).  Then the training
     paths at the same crops with remat_att_sites on and off: 3 steps each
     of the main config, under lsinu and under --f2radius 7, and the main
     config's --attn_diag step (its three metrics finite, attn_max > 0)
     followed by a fast step with the training path's launches: device ms
     a step (CUDA events), peak memory and exact launches.
     Then the dense-table paths: the lsinu config served as the main path
     (3 pairs after a warm-up: 3 launches each of B8, B6 dense and B4
     dense, 9 of B1, 36 of B5, none of B2-B4), and one pair of the main
     config under --f2radius 7 (B8 with its table in place of B2).
     Then the evaluation entry point (craft_tpu_torch.evaluate.main) on
     the card: the oracle as a reference .pth over a one-pair Sintel tree
     whose ground truth is the port's CPU flow (fp32 within 1e-3 px,
     mixed within 0.15 px), then KITTI (2 pairs at 375x1242) and Sintel
     (3 frames at 436x1024, --batch_size 2) at full size: metrics,
     pairs/s and launches (B1-B5 in each); then --interpos/--intrapos
     lsinu on the KITTI tree, and --f2radius 7 over a one-pair Sintel tree
     whose ground truth is the port's CPU flow under that flag.
     Then sequence parallelism (--seq_parallel): two ranks of this script
     on the one card under torch.distributed.run (gloo: the ranks share
     the card), each serving the main path's 3 pairs (launches per rank and
     pair: B1 3, B2 1, B4 1, B9 sums 1, B9 write 1, B5 12, no B3), one fp32
     pair, one 1088x1920 pair and the evaluator CLI with --seq_parallel on
     a KITTI tree (47 rows: 24/23), mixed and --fullprec; their flows
     against the unsharded ones (0.15 px mixed, 1e-3 px fp32), the CLI's
     metrics against the unsharded CLI's, and each rank's peak memory
     below the unsharded peak at 440x1024 and 1088x1920; then one rank
     without torchrun on NCCL (world = the card count) against unsharded.
     Then two ranks (--sp-config-rank, gloo) for each other configuration
     the evaluator takes (lsinu, --f2radius 7, --f1 shared and private,
     RAFT, GMA with --position_and_content, CRAFT with GMA attention,
     craft_nogma, --f2 none; SP_CONFIG_KERNELS): 3 mixed pairs at 440x1024
     after a warm-up against the unsharded forward (0.15 px), launches per
     rank and pair asserted, event and device ms; one fp32 pair of lsinu
     and GMA (1e-3 px); one 1088x1920 pair of each, each rank's peak below
     the unsharded peak; the evaluator CLI with --seq_parallel over a
     KITTI tree with --f1 private and with --raft against the unsharded
     CLI.
     Then the lazy intra path (intra probs past 4e9 bytes): one HD1K pair
     (1088x2560) of the main config with its launches asserted (B2 13, 12
     of them at F 128; no B4) and its peak below 8e9 B, against the same
     pair with the probs materialised (0.15 px), and each forward's device
     time; one fp32 batch of 6 Sintel pairs lazy against materialised
     (1e-3 px).
     Then the GRU path: SepConvGRU(fused='on') against fused='off' with
     the oracle tree's update-block GRU, 12 chained calls (h carried, a
     fresh x each call): serving forward in bf16, chairs forward and
     backward (autograd from a seeded loss on the last h) in bf16 and
     fp32; the last h and every weight gradient within stated bounds; 24
     forward passes per 12 calls, 24 backward passes per backward, none
     under `static` (asserted).
     Then the rest of the evaluator: every image fixture of tests/data
     decoded on this host (no PIL here): the VIPER JPEGs to PIL's pixel
     hashes, and each form of tests/data/formats (progressive,
     arithmetic-coded, lossless, CMYK and YCCK JPEG; interlaced, 1/2/4-bit
     and tRNS PNG) to the JAX package's array, or refused where it
     refuses, with each file's decode ms (each new form also as one
     1920x1080 frame); the single-pair demo on the
     progressive 1920x1080 pair (its flow's shape, finite, launches on
     the lazy intra path); the further validators at
     their sets' full shapes (things 540x960, sintel_occ 436x1024,
     kittitrain 375x1242, hd1k 1080x2560, viper's 1920x1080 JPEGs at 0.5,
     slowflow 436x1024), the Sintel submission with --warm_start (3
     frames, 32 iterations), the KITTI and VIPER submissions (24), the
     shift sweep (100,50), (200,100), (300,150) on the Sintel tree and
     --flop at 440x1024, each with its launches asserted (B1 3, B2-B4 1,
     B5 the iterations, a forward; HD1K on the lazy intra path: B2 13, no
     B4), pairs/s and peak memory (HD1K's below 8e9 B); then each further
     validator on small trees (128x128), card (--fullprec, mixed) against
     the port's fp32 CPU metrics.
     Then the training entry point (python -m craft_tpu_torch.train, run
     in this process) on a synthetic FlyingChairs tree at 384x512 (48
     training and 4 validation pairs, written by the port's PPM and .flo
     writers under build/chip_smoke_train/) with the chairs stage's flags:
     6 steps with --val_freq 5 (one checkpoint, one chairs validation);
     the steps' launches (the training path's, exact) and the
     validation's (B1-B5) apart;
     a resume from the checkpoint with --loadopt --loadsched to the same
     step and learning rate; the loader alone; two ranks of the CLI under
     torch.distributed.run on the one card (gloo), 2 steps, one writer;
     2 steps under --interpos lsinu --intrapos lsinu --f2radius 7
     --attn_diag --print_freq 2 (B5 alone; the status line prints the
     three attention metrics).
     Then 2 steps with --raft and 2 with --upsample_mode final (trained
     as packed), each with its steps' launches asserted.
     Its step wall and steps/s beside the fixed-batch step wall above,
     the loader's batches/s and the peak memory.
     Then the other families (RAFT, GMA, CRAFT with GMA attention,
     craft_nogma, --f2 none), seeded weights (the oracle tree's where it
     has them): each at 128x128 on the card against the CPU (fp32 within
     1e-3 px, mixed within 0.15 px); each served at 440x1024 (mixed, one
     warm-up pair, 3 pairs: ms between CUDA events, the profiler's kernel
     ms of a pair, peak memory, launches asserted: B5 12 a pair, B1 once
     at each SETrans site, B2 at f2, B3 at TransCorr, B4 at SETrans
     intra); one packed pair of the main config, its unpacked final frame
     bit-identical to the 'all' pair's; RAFT, GMA and craft_nogma training
     at the chairs crops (3 steps after a warm-up: events ms, peak, loss,
     grad norm, launches); one fp32 step (2 iterations) of each family on
     the card against the CPU (phase 3's bounds) and one packed step of
     the main config against its 'all' step; the evaluator CLI with
     --raft, --nogma and without --setrans over each family's .pth on a
     one-pair Sintel tree whose ground truth is the family's CPU flow
     (--fullprec within 1e-3 px, mixed within 0.15 px) and a KITTI tree at
     375x1242, launches asserted.
     Then two-way correlation (--f1): the oracle tree with a seeded
     private f1 site at 128x128 on the card against the CPU (fp32 within
     1e-3 px, mixed within 0.15 px); 'shared' and 'private' served at
     440x1024 (one warm-up pair, 3 pairs: events ms, the profiler's kernel
     ms, peak memory, launches asserted: B1 5, B2 2, B3 2, B4 1, B5 12 a
     pair); one fp32 'private' step on the card against the CPU (phase 3's
     bounds, launches) and 3 mixed steps at the chairs crops (events ms,
     peak, launches: B1 10, B4 6, B6 4, B6 backward 2, B7 3, B5 12 + 12);
     the evaluator CLI with --f1 shared over a one-pair Sintel tree whose
     ground truth is the CPU flow (--fullprec, mixed).  Then one pair each
     of the ablations (pos codes 'zero', 'rand', 'sinu' at every site;
     ablate_multihead at the f2 site) on the card against the CPU, fp32 and
     mixed, launches asserted; and attvis: dump_attention on the card
     against the CPU (the same keys and shapes, each array within 1e-4 of
     its largest value; no B2, B3 or B4 while capturing, B3 and B4 in the
     next forward) and vis_attention's PNGs.
     Then the mode counts other than 4 (modes_phase): eleven configurations
     (MODE_CONFIGS: one, two, eight, sixteen, 32 and 256 modes, two mixed
     ones, --f1 private at 8 inter modes, --nogma at 2, one mode under
     --f2radius 7) at 128x128 on the
     card against the CPU (fp32 within 1e-3 px, mixed within 0.15 px), the
     oracle's weights where their shapes hold and seeded first linears;
     modes1, modes8, modes32, modes256 (on the lazy intra path, its B2
     launches by width asserted), modes_small_mixed, modes2 (B2 at md 128)
     and modes1 under --f2radius 7 (B8 at md 256) served at 440x1024
     (one warm-up pair, 2 pairs: event ms, the profiler's device ms and
     busy share, peak memory, the path's launches asserted) and trained at
     the chairs crops (batch 8, modes256 and modes_small_mixed batch 2; 2
     steps: event ms, device ms, peak, launches), one fp32 step of modes1,
     modes8 and modes32 card against CPU; the evaluator CLI with modes8's
     and modes32's flags over a one-pair Sintel tree whose ground truth is
     the CPU flow (--fullprec, mixed) and the training CLI with modes1's
     and modes32's flags (2 steps, launches asserted); two gloo ranks of
     this script (--sp-modes-rank) at 8 and 32 modes, 128x128, mixed and
     fp32, against the unsharded flows.
  5. kernel times over CUDA events at the main-path shapes, beside each
     plain version, the bound and (B2) scaled_dot_product_attention; B2 at
     F 128 at a Sintel batch of 11 and at HD1K (the plain version there in
     chunks of grid rows); B2-B4
     at the KITTI shape (U=7332, W8=156); the training kernels and B1/B4
     at the chairs shapes; B5 forward and backward at the serving and
     chairs shapes beside per-level F.grid_sample and its backward, at
     D = 1 and D = 2 (per plane); B8,
     B6 dense and B4 dense at the serving shape (B8 and B6 dense also with
     the --f2radius table, B8 beside scaled_dot_product_attention with it
     as its mask); B9 sums and write per shard at 2 and 4 shards beside their
     plain versions, bounds and B3; B8, B6 dense and B4 dense at the
     shards of the serving grid over 2 ranks (rows 0:28 and 28:55; B8
     also with its --f2radius table's rows); B10 forward and backward of
     each
     pass at the serving and chairs grids (bf16) beside the plain
     versions, the bounds and the same pass in the cuDNN conv form.
     B4's, B6's and B6 dense's lines add the floor of their exponentials
     on the SFUs.  Then B1, B2, B3, B4 int8 (serving) and B6, B6 backward
     and B7 (chairs, batch 8) at 1, 8 and 32 modes, as modes1, modes8 and
     modes32 run them, beside their plain versions (at 32 modes over two
     samples at a time), bounds and exponentials' floors, and B8 at 32
     modes beside scaled_dot_product_attention; B2 at two modes (md 128)
     beside SDPA with the window as its mask, and B8 at one mode (md 256)
     with the --f2radius table beside SDPA with it as its mask (and with no
     table beside SDPA without a mask).

Prints the card line and a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is unavailable.  Imports nothing of JAX.  `--sp-rank DIR [--sp-nccl]`
runs one rank of the sequence-parallel phase, `--sp-config-rank DIR` one
of the configurations' sequence-parallel phase, `--sp-modes-rank DIR` one
of the mode-count phase's (the script starts them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from craft_tpu_torch import evaluate as evaluate_cli
from craft_tpu_torch import train as train_cli
from craft_tpu_torch.config import (craft_config, craft_nogma_config,
                                    gma_config, raft_config)
from craft_tpu_torch.data import frame_utils, imgio
from craft_tpu_torch.data.datasets import fetch_training_dataset
from craft_tpu_torch.data.loader import MultiprocessLoader
from craft_tpu_torch.eval import evaluate as tev
from craft_tpu_torch.models.flow_model import FlowModel, create_model
from craft_tpu_torch.nn import setrans
from craft_tpu_torch.nn.update import SepConvGRU
from craft_tpu_torch.ops.geometry import (InputPadder, coords_grid,
                                          unpack_upsampled)
from craft_tpu_torch.ops.kernels import build, launch
from craft_tpu_torch.ops.kernels import corr_lookup as lk
from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg
from craft_tpu_torch.parallel.sp import RowShard, row_split
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
FP32_TFLOPS = 67.0  # H100 SXM fp32 peak outside the tensor cores
SOURCE = "craft_tpu_torch/csrc/{}.cu"
TPU_KERNEL = "craft_tpu/ops/pallas/mode_attention.py:{}"
# The training path: the chairs stage of the reference curriculum.
CROP_H, CROP_W, TRAIN_BATCH = 368, 496, 8
CHAIRS_GRID = (CROP_H // 8, CROP_W // 8)  # 46 x 62 -> U = 2852
# The KITTI evaluation grid: 375x1242 padded to 376x1248 -> 47 x 156,
# U = 7332 (W8 = 156: 64-key tiles and 16-row warps straddle grid rows).
KITTI_GRID = (47, 156)


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


def device_ms(fn, reps: int, match=None) -> float:
    """Kernel time per call on the device (torch.profiler): where a call is
    shorter than its host work, time_ms measures the host instead.  With
    `match`, only the kernels whose names hold one of its substrings."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        # A craft.* range also shows as a device-side span over its
        # kernels: counting it would count them twice.
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.key.startswith("craft.") and (
                    match is None or any(m in e.key for m in match)):
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3 / reps


def bound_ms(flops: float, nbytes: float, tflops: float = BF16_TFLOPS
             ) -> tuple:
    t_ops = flops / (tflops * 1e12) * 1e3
    t_mem = nbytes / (HBM_TBS * 1e12) * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


# The exponentials beside the bound: the SFUs take 16 a clock on each of
# the 132 SMs, at the 1.98 GHz boost clock of the H100 SXM.  B4 takes one a
# score in each of its two sweeps, B6 and B6 dense one a score.
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def exp_ms(n_exp: float) -> float:
    """The least time of n_exp exponentials on the SFUs."""
    return n_exp / SFU_EXP_PER_S * 1e3


def sfu_ms(n_scores: float) -> float:
    """The least time of B4's 2 n_scores exponentials on the SFUs."""
    return exp_ms(2.0 * n_scores)


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


def inputs(gen, md, dev, u=U, batch=1, modes=4, dtype=torch.bfloat16):
    """Seeded q, k [batch, modes, u, md] with scores of std QK_STD^2."""
    def one():
        x = torch.randn(batch, modes, u, md, generator=gen) * QK_STD
        return x.to(dev, dtype)
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
    planted fault {name: plain output with that fault, or a function that
    makes it, called and freed one at a time}: a bound that a dropped bias
    or a missing clamp would pass proves nothing."""
    err = err_fn(got, want)
    print(f"{label}: error {err:.3e} (bound {tol:g})")
    assert err <= tol, f"{label}: kernel disagrees with its plain version"
    for name, out in faults.items():
        ferr = err_fn(out() if callable(out) else out, want)
        print(f"{label}: planted fault '{name}' gives {ferr:.3e}")
        assert ferr > tol, f"{label}: the bound misses a '{name}' fault"
    return err


# The faults planted against the mode counts other than 4: the aggregating
# kernels' second and later groups of four modes dropped (B3, B6, B6 dense,
# B9 at 8 and 16 modes); q's first two 64-wide chunks of the mode dim
# swapped (the FMA bodies staged past 64, md 128 and 256); B6 backward's
# dc planes one mode off.
GROUP_DROPPED, CHUNK_SWAPPED, DC_MODE_OFF = (
    "modes past the first group of four dropped",
    "q's first two 64-wide md chunks swapped",
    "dc written into the next mode's plane")
# Past 16 modes at a 256-wide site (md 8 to 1): a nonzero pad column where
# the per-mode kernels (B1, B2, B4, B7, B8, B4 dense) take q and k
# zero-padded to 16 columns (a pad holding a copy of column 0 adds q_0 k_0
# to every score: column 0 counted twice); the aggregating kernels' fifth
# group of four modes (16-19) skipped (M > 16); their running max reset at
# each group, each group's exponentials taken against its own max and
# summed unrescaled (M > 4).
PAD_NONZERO, GROUP_SKIPPED, MAX_RESET = (
    "a nonzero pad column (column 0 counted twice)",
    "the group of modes 16-19 skipped",
    "the running max reset between groups of four modes")


# Against B2's and B8's pipelined body (csrc/flash_attn.cu): q.k over md
# chunk 3 (columns 192-255) skipped at md 256 (its k loop over 64-wide
# chunks one short), and at F 128 the second half (keys 64-127) of every
# 128-key tile dropped.
CHUNK_SKIPPED, HALF_TILE = (
    "q.k over md chunk 3 (columns 192-255) skipped",
    "keys 64-127 of every 128-key tile dropped")


def skip_md_chunk3(x):
    """x with columns 192-255 of its mode dim zeroed."""
    y = x.clone()
    y[..., 192:256] = 0
    return y


def flash_faults(md, fn, q, k) -> dict:
    """{CHUNK_SKIPPED: fn(q', k)} at md 256 (B2, B8), else {}."""
    return ({CHUNK_SKIPPED: lambda: fn(skip_md_chunk3(q), k)} if md > 192
            else {})


def b2_half_tile(q, k, v, biases, grid, clip, pos_w, q_row0: int = 0):
    """Plain B2 with keys 64-127 of every 128-key tile masked out."""
    _, s = ma.biased_scores(q, k, biases, grid, clip, pos_w, q_row0)
    keys = torch.arange(k.shape[2], device=s.device)
    s = s.masked_fill(keys % 128 >= 64, float("-inf"))
    return (torch.softmax(s, -1) @ v.float()).to(v.dtype)


def swap_md_chunks(x):
    """x with its mode dim's chunks [0, 64) and [64, 128) swapped: what an
    FMA body that staged its chunks out of order would multiply."""
    return torch.cat([x[..., 64:128], x[..., :64], x[..., 128:]], -1)


def pad_col_fault(x):
    """x with column 0 scaled by sqrt(2): q' k'^T = q k^T + q_0 k_0^T, what
    a pad column holding a copy of column 0 would add."""
    y = x.clone()
    y[..., 0] *= math.sqrt(2.0)
    return y


def skip_group(x):
    """x [B, M, ...] without modes 16-19 (the fifth group of four)."""
    return torch.cat([x[:, :16], x[:, 20:]], 1)


def group_max_weights(lg):
    """The mode softmax's weights of logits lg [B, M, ...] with its running
    max reset at each group of four modes: each exponential against its
    own group's max, normalised over every mode unrescaled."""
    g = lg.unflatten(1, (lg.shape[1] // 4, 4))
    e = torch.exp(g - g.amax(2, keepdim=True)).flatten(1, 2)
    return e / e.sum(1, keepdim=True)


def max_reset_volume(q, k, table, clip, pos_w, agg_w, agg_b):
    """The plain aggregated volume [B, U1, U2] (B6, B6 dense) with the
    MAX_RESET fault: s_m = clamp(c_m, +-clip) + pos_w * table (the window's
    dense rows, a table, or None) weighted by group_max_weights."""
    s = ma.table_scores(q, k, table, clip, pos_w)
    return (group_max_weights(agg_w * s + agg_b) * s).sum(1)


def b3_max_reset(q, k, biases, grid, attn_clip, pos_w, agg_w, agg_b):
    """Plain B3's normed fp32 volume with the MAX_RESET fault."""
    gmax = ma.scores(q, k, 1.0 / math.sqrt(q.shape[-1])).amax()
    clip = torch.where(gmax > attn_clip, attn_clip, 1e30)
    vol = max_reset_volume(q, k, ma.window_rows(biases, grid, q, k), clip,
                           pos_w, agg_w, agg_b)
    return ma._normed(vol, ma._volume_sums(vol), float(k.shape[2]) ** 2,
                      1e-12)[0]


def mode_faults(M, md, fn, q, k, agg=False, normed=False):
    """{fault: function giving fn(q', k')} of the faults that apply at (M,
    md): for an aggregating kernel (agg) the modes past the first group of
    four dropped (M > 4) and modes 16-19 skipped (M > 16; for the normed
    volume of B3 and B9 (normed) up to 64 modes: at 128 and 256 four
    modes move it by less than the bf16 bound, and B6's raw volume, from
    the same FMA tiles, holds the fault there); for a per-mode kernel a
    nonzero pad column (md < 16); and q's md chunks swapped (md > 64)."""
    out = {}
    if agg and M > 4:
        out[GROUP_DROPPED] = lambda: fn(q[:, :4], k[:, :4])
    if agg and M > 16 and not (normed and M > 64):
        out[GROUP_SKIPPED] = lambda: fn(skip_group(q), skip_group(k))
    if not agg and md < ma.MMA_K:
        out[PAD_NONZERO] = lambda: fn(pad_col_fault(q), pad_col_fault(k))
    if md > 64:
        out[CHUNK_SWAPPED] = lambda: fn(swap_md_chunks(q), k)
    return out


def note_err(report, name, M, err) -> None:
    """Fold err into the kernels line's max_abs_err of `name` at M modes
    (<name>_m<M> where M != 4), where the report has that row."""
    r = report.get(name if M == 4 else f"{name}_m{M}")
    if r is not None:
        prev = r.get("max_abs_err")
        r["max_abs_err"] = err if prev is None else max(prev, err)


def drop_outer_ring(biases):
    """The window with its outer ring (|dh| = R or |dw| = R) set to 0: what
    a kernel whose band or window test is one row or column too tight
    computes."""
    w = biases.clone()
    w[0], w[-1], w[:, 0], w[:, -1] = 0.0, 0.0, 0.0, 0.0
    return w


def clamped_share(q, k, clip: float) -> float:
    """Share of the scores scale * q.k that |.| > clip clamps."""
    s = torch.einsum("bmid,bmjd->bmij", q.float(), k.float())
    return float((s.abs() > clip * math.sqrt(q.shape[-1])).float().mean())


def check_kernels(dev, gen, report, grid=(H8, W8),
                  b3_grids=((H8, W8), KITTI_GRID), wide=(4, 64),
                  intra=(4, 32), dtype=torch.bfloat16) -> None:
    """Phase 2: every kernel against its plain version on the same inputs
    (the plain versions run on the card too), with the clamp off and on;
    B3 also at a ragged grid width (b3_grids).  wide is the (modes, mode
    dim) of the 256-wide sites (B1, B2, B3), intra the intra site's (B1,
    B4; None: not checked), dtype the inputs' (B4 int8 takes bf16 only);
    mode_faults are planted beside the others.  On CPU tensors the
    wrappers take the plain versions themselves, which is how the tests
    run this phase with planted faults."""
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    u = grid[0] * grid[1]

    # B1 at the f2/inter (md 64) and intra (md 32) shapes.
    for M, md in [wide] + ([intra] if intra else []):
        q, k = inputs(gen, md, dev, u, modes=M, dtype=dtype)
        scale = 1.0 / math.sqrt(md)
        got = float(ma.scores_global_max(q, k, scale))
        sync(dev)
        want = float(ma.scores_global_max_plain(q, k, scale))
        tag = f"B1 M={M} md={md} {dtype}"
        print(f"{tag}: kernel {got:.6f} plain {want:.6f}")
        assert abs(got - want) <= B1_RTOL * abs(want), f"{tag} disagrees"
        for name, f in mode_faults(M, md, lambda a, b: float(
                ma.scores_global_max_plain(a, b, scale)), q, k).items():
            f = f()
            print(f"{tag}: planted fault '{name}' gives {f:.6f}")
            assert abs(f - want) > B1_RTOL * abs(want), \
                f"{tag}: the bound misses a '{name}' fault"
        note_err(report, "scores_global_max", M, abs(got - want))

    # B2 (f2 site, pos_w 0.5).
    M, md = wide
    q, k = inputs(gen, md, dev, u, modes=M, dtype=dtype)
    v = torch.randn(1, M, u, 256, generator=gen).to(dev, dtype)
    print(f"B2/B3 inputs: clip {CLIP_ON} clamps "
          f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
    for clip in (CLIP_OFF, CLIP_ON):
        clip_t = torch.tensor(clip, device=dev)
        got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
        sync(dev)

        def plain(c, w, a=q, b=k, bias=biases):
            return ma.flash_mode_attention_plain(
                a, b, v, bias, grid, torch.tensor(c, device=dev), w)
        faults = {"no bias": lambda: plain(clip, 0.0),
                  "outer ring dropped": lambda: plain(
                      clip, 0.5, bias=drop_outer_ring(biases))}
        if clip != CLIP_OFF:
            faults["no clamp"] = lambda: plain(CLIP_OFF, 0.5)
        faults.update(mode_faults(M, md, lambda a, b: plain(clip, 0.5, a, b),
                                  q, k))
        faults.update(flash_faults(md, lambda a, b: plain(clip, 0.5, a, b),
                                   q, k))
        want = plain(clip, 0.5)
        hold(f"B2 M={M} md={md} {dtype} clip={clip:g}", got, want, rel_err,
             b2_tol(dtype), faults)
        note_err(report, "flash_mode_attention", M,
                 float((got.float() - want.float()).abs().max()))
        del got, want, faults
    del v

    # B3 (inter site, pos_w 0.5), its output in dtype against the fp32
    # plain volume, the clamp inactive (attn_clip 100 > raw max) and
    # active; at the serving grid and at the KITTI width, whose key tiles
    # cross grid rows where the band test decides which tiles take the
    # window.
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    err_fn, tol = vol_err(dtype)
    for g3 in b3_grids:
        if g3 != grid:
            q, k = inputs(gen, md, dev, g3[0] * g3[1], modes=M, dtype=dtype)
        for attn_clip in (100.0, CLIP_ON):
            got, stats = ma.fused_agg_corr_norm(q, k, biases, g3, attn_clip,
                                                0.5, agg_w, agg_b,
                                                out_dtype=dtype)
            sync(dev)

            def plain(c, w, b=biases, x=q, y=k):
                return ma.fused_agg_corr_norm_plain(
                    x, y, b, g3, c, w, agg_w, agg_b, out_dtype=torch.float32)
            faults = {"no bias": lambda: plain(attn_clip, 0.0)[0],
                      "outer ring dropped": lambda: plain(
                          attn_clip, 0.5, drop_outer_ring(biases))[0]}
            if attn_clip != 100.0:
                faults["no clamp"] = lambda: plain(CLIP_OFF, 0.5)[0]
            faults.update(mode_faults(M, md, lambda a, b: plain(
                attn_clip, 0.5, x=a, y=b)[0], q, k, agg=True,
                normed=True))
            if M > 4:
                faults[MAX_RESET] = lambda: b3_max_reset(
                    q, k, biases, g3, attn_clip, 0.5, agg_w, agg_b)
            want, wstats = plain(attn_clip, 0.5)
            hold(f"B3 M={M} md={md} {dtype} {g3[0]}x{g3[1]} "
                 f"attn_clip={attn_clip:g}", got, want, err_fn, tol, faults)
            print(f"B3 stats {stats.flatten().tolist()} plain "
                  f"{wstats.flatten().tolist()}")
            torch.testing.assert_close(stats, wstats, rtol=1e-4, atol=1e-5)
            note_err(report, "fused_agg_corr_norm", M,
                     float((got.float() - want).abs().max()))
            del got, want, faults
    if intra is None:
        return

    # B4 (intra site, pos_w 1.0): quantized (the main path, bf16) and float.
    M, md = intra
    q, k = inputs(gen, md, dev, u, modes=M, dtype=dtype)
    print(f"B4 inputs: clip {CLIP_ON} clamps "
          f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
    tag = f"M={M} md={md} {dtype}"
    for clip in (CLIP_OFF, CLIP_ON):
        clip_t = torch.tensor(clip, device=dev)

        def plain(c, w, a=q, b=k, **kw):
            return ma.mode_softmax_probs_plain(
                a, b, biases, grid, torch.tensor(c, device=dev), w, **kw)
        if dtype == torch.bfloat16:
            num, sc = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                            quantized=True)
            sync(dev)
            faults = {"no bias": plain(clip, 0.0, quantized=True),
                      "row max taken over one key tile": b4_tile_max_fault(
                          q, k, biases, grid, clip_t, 1.0)}
            if clip != CLIP_OFF:
                faults["no clamp"] = plain(CLIP_OFF, 1.0, quantized=True)
            faults.update({n: f() for n, f in mode_faults(
                M, md, lambda a, b: plain(clip, 1.0, a, b, quantized=True),
                q, k).items()})
            wnum, wsc = plain(clip, 1.0, quantized=True)
            hold(f"B4 int8 numerators {tag} clip={clip:g}", num, wnum,
                 num_err, B4_NUM_TOL, {n: f[0] for n, f in faults.items()})
            hold(f"B4 int8 row scales {tag} clip={clip:g}", sc, wsc,
                 lambda a, b: float(((a - b).abs() / b).max()),
                 B4_SCALE_RTOL, {n: f[1] for n, f in faults.items()})
            note_err(report, "mode_softmax_probs", M, float(
                (num.float() * sc - wnum.float() * wsc).abs().max()))
            del num, sc, wnum, wsc, faults
        for odt in probs_out_dtypes(dtype):
            got = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                        out_dtype=odt)
            sync(dev)
            faults = {"no bias": lambda: plain(clip, 0.0,
                                               out_dtype=torch.float32)}
            if clip != CLIP_OFF:
                faults["no clamp"] = lambda: plain(CLIP_OFF, 1.0,
                                                   out_dtype=torch.float32)
            faults.update(mode_faults(M, md, lambda a, b: plain(
                clip, 1.0, a, b, out_dtype=torch.float32), q, k))
            want = plain(clip, 1.0, out_dtype=torch.float32)
            hold(f"B4 {tag} out {odt} clip={clip:g}", got, want, row_rel_err,
                 B4_ROW_TOL[odt], faults)
            note_err(report, "mode_softmax_probs", M,
                     float((got.float() - want).abs().max()))
            del got, want, faults


def probs_out_dtypes(dtype):
    """B4 float's output dtypes from inputs in dtype: fp32 and bf16 from
    bf16 (the mixed-precision sites), fp32 from fp32."""
    return ((torch.float32, torch.bfloat16) if dtype == torch.bfloat16
            else (torch.float32,))


def b4_tile_max_fault(q, k, biases, grid, clip, pos_w, q_row0: int = 0):
    """B4's int8 output from a row max taken over the first key tile (64
    keys) only, as a split-key kernel that lost its other chunks would
    give: numerators above 127 saturate, and the row scales follow."""
    _, s = ma.biased_scores(q, k, biases, grid, clip, pos_w, q_row0)
    e = torch.exp(s - s[..., :64].amax(dim=-1, keepdim=True))
    del s
    num = torch.round(e * 127.0).clamp(-128, 127).to(torch.int8)
    return num, 1.0 / (127.0 * e.sum(dim=-1, keepdim=True))


# B4 at the other shapes its paths run: (label, batch, grid) of the KITTI
# evaluation grid (W8 = 156, U = 7332: int8 rows 4-byte aligned, bf16 rows
# 8-byte) and the chairs training batch (W8 = 62, U = 2852: every 64-key
# tile crosses a grid row), int8 and bf16 probs, md 32 (the intra site).
B4_SHAPES = (("KITTI", 1, KITTI_GRID), ("chairs", TRAIN_BATCH, CHAIRS_GRID))


def check_b4_shapes(dev, gen, report, shapes=B4_SHAPES) -> None:
    """Phase 2: B4 int8 (numerators, row scales) and bf16 probs against the
    plain version at each shape, the clamp on, with no bias, no clamp and
    (int8) a row max over one key tile planted in the plain version."""
    errs = []
    for label, batch, grid in shapes:
        biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
        q, k = inputs(gen, 32, dev, grid[0] * grid[1], batch)
        clip_t = torch.tensor(CLIP_ON, device=dev)
        plain = lambda c, w, **kw: ma.mode_softmax_probs_plain(  # noqa: E731
            q, k, biases, grid, torch.tensor(c, device=dev), w, **kw)
        num, sc = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                        quantized=True)
        sync(dev)
        faults = {"no bias": plain(CLIP_ON, 0.0, quantized=True),
                  "no clamp": plain(CLIP_OFF, 1.0, quantized=True),
                  "row max taken over one key tile": b4_tile_max_fault(
                      q, k, biases, grid, clip_t, 1.0)}
        wnum, wsc = plain(CLIP_ON, 1.0, quantized=True)
        hold(f"B4 {label} int8 numerators", num, wnum, num_err, B4_NUM_TOL,
             {n: f[0] for n, f in faults.items()})
        hold(f"B4 {label} int8 row scales", sc, wsc, lambda a, b: float(
            ((a - b).abs() / b).max()), B4_SCALE_RTOL,
            {n: f[1] for n, f in faults.items()})
        errs.append(float((num.float() * sc - wnum.float() * wsc).abs().max()))
        del num, sc, wnum, wsc, faults
        got = ma.mode_softmax_probs(q, k, biases, grid, clip_t, 1.0,
                                    out_dtype=torch.bfloat16)
        sync(dev)
        want = plain(CLIP_ON, 1.0, out_dtype=torch.float32)
        hold(f"B4 {label} bf16", got, want, row_rel_err,
             B4_ROW_TOL[torch.bfloat16],
             {"no bias": plain(CLIP_ON, 0.0, out_dtype=torch.float32),
              "no clamp": plain(CLIP_OFF, 1.0, out_dtype=torch.float32)})
        errs.append(float((got.float() - want).abs().max()))
        del got, want, q, k
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    r = report["mode_softmax_probs"]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), *errs)


# B1's planted peaks: (label, batch, grid, query rows (h0, h1) of a shard
# or None, mode dim).  The peak sits at the last mode, the last query row
# and the last key, which is ragged in every case: serving (7040 = 110
# tiles of 64), chairs (2852), KITTI (7332), and the last row of the
# serving grid's last shard of 4 (rows 42..54).
B1_PEAK_CASES = (("serving", 1, (H8, W8), None, 64),
                 ("serving md 32", 1, (H8, W8), None, 32),
                 ("chairs", TRAIN_BATCH, CHAIRS_GRID, None, 64),
                 ("KITTI", 1, KITTI_GRID, None, 64),
                 ("shard 4 of 4", 1, (H8, W8), (42, H8), 64))
PEAK = 3.0  # every feature of the peak's q row and k row
B1_FAULTS = ("last key tile dropped", "mode 3 dropped")


def plant_peak(q, k):
    """q, k with q[:, 3, -1] = k[:, 3, -1] = PEAK in every feature: their
    score PEAK^2 md scale is exact in any summation order (bf16 PEAK, sums
    of equal products) and above every other score (std QK_STD^2 = 2.25),
    so a max that skips the last key tile, mode 3 or the last query row
    misses it."""
    q, k = q.clone(), k.clone()
    q[:, 3, -1] = PEAK
    k[:, 3, -1] = PEAK
    return q, k


def b1_fault(q, k, scale, fault):
    """The plain B1 with `fault` planted: the last (ragged) key tile of 64
    dropped, or mode 3 dropped."""
    if fault == "last key tile dropped":
        k = k[:, :, :(k.shape[2] - 1) // 64 * 64]
    else:
        q, k = q[:, :3], k[:, :3]
    return ma.scores_global_max_plain(q, k, scale)


def check_b1_peaks(dev, gen, cases=B1_PEAK_CASES) -> None:
    """Phase 2: B1 returns each planted peak exactly, and each of B1_FAULTS
    planted in the plain version misses it (on CPU tensors the wrapper is
    the plain version, which is how the tests plant a fault in it)."""
    for label, batch, grid, rows, md in cases:
        q, k = inputs(gen, md, dev, grid[0] * grid[1], batch)
        if rows is not None:
            q = q[:, :, rows[0] * grid[1]:rows[1] * grid[1]]
        q, k = plant_peak(q, k)
        scale = 1.0 / math.sqrt(md)
        peak = float(torch.tensor(PEAK * PEAK * md) * scale)
        got = float(ma.scores_global_max(q, k, scale))
        sync(dev)
        print(f"B1 peak {label} (U1 {q.shape[2]}, U2 {k.shape[2]}, md {md}): "
              f"kernel {got!r}, planted {peak!r}")
        assert got == peak, f"B1 {label}: the kernel disagrees with the peak"
        for fault in B1_FAULTS:
            missed = float(b1_fault(q, k, scale, fault))
            print(f"B1 peak {label}: planted fault '{fault}' gives {missed!r}")
            assert missed != peak, f"B1 {label}: the check misses '{fault}'"
        del q, k


# Training-kernel tolerances, each set from what is compared:
B6_TOL = 1e-4       # fp32 volume / dc: fp32 sums of md products in
#                     another order (1e-6) and expf: max |diff| / max |plain|
B6_DA_RTOL = 1e-4   # da: one sum over B*M*U^2 terms, fp64 partials vs fp32
B7_DC_TOL = 1e-2    # bf16 dc per row, over the row max: half an ulp 2^-8
B7_DLSUM_TOL = 1e-4  # fp32 sum over B*M of dl from the same bf16 p, g
# fp32 dc over the tensor's largest value: the row terms (sums of U
# products) in another order; per row a weak row's dc is within 1e-4 of
# the terms it cancels, not of itself.
B7_FP32_DC_TOL = 1e-4
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


# The bf16 bodies' tiles that the planted faults below follow: B7's column
# tile (csrc/probs_bwd.cu B7_COLS) and the keys of a B6 backward block
# (csrc/agg_corr.cu B6B_KEYS x B6B_KGROUP).
B7_COL_TILE = 128
B6_KEY_GROUP = cv.B6B_KEYS * cv.B6B_KGROUP
# B6's forward and B6 dense in bf16 run B3's sweep (csrc/agg_modes.cuh
# B3_ROWS, B3_KEYS): a block's 128 query rows are two warpgroups' halves of
# 64 rows, each 64-key tile two warpgroups' halves of 32 keys.  The faults
# planted against them:
B6_ROW_HALF, B6_KEY_HALF = 64, 32
B6_MODE0, B6_HALF_WINDOW, B6_TABLE_ROWS, B6_WB = (
    "every mode's vol from mode 0's scores",
    "the window bias over one warpgroup's keys only",
    "the table read with another warpgroup's rows",
    "the normalisation's wb left at a nonzero value")


def _b6_dc_fault(q, k, g, vol, biases, grid, clip, agg_w, drop_term=False,
                 mask=True, mode0=False, max_reset=False):
    """The plain B6 backward's dc with a planted fault: t = p (the
    agg_w * (s - vol) term dropped), no clamp mask, every mode's dc from
    mode 0's scores, or p with MAX_RESET."""
    if mode0:
        q, k = q[:, :1].expand_as(q), k[:, :1].expand_as(k)
    c, s = ma.biased_scores(q, k, biases, grid, clip, 0.5)
    p = group_max_weights(agg_w * s) if max_reset else \
        torch.softmax(agg_w * s, dim=1)
    t = p if drop_term else p * (1.0 + agg_w * (s - vol[:, None]))
    dc = g[:, None] * t
    return torch.where(c.abs() < clip, dc, 0.0) if mask else dc


def b6_fwd_fault(q, k, table, clip, pos_w, agg_w, agg_b, fault):
    """The plain B6 volume with s_m = clamp(c_m, +-clip) + pos_w * table
    (the window's dense rows for B6, B6 dense's table; None: no bias) and
    `fault` planted: every mode's scores from mode 0's q and k, the bias on
    the first B6_KEY_HALF keys of every 64-key tile only, the table's row r
    read at r ^ B6_ROW_HALF (the other warpgroup's half of a 128-row block;
    its own row where that lies past U1), or vol - mean(vol) per sample
    (the normalisation's offset where B6 takes none).  Without a table the
    two bias faults change nothing."""
    if fault == B6_MODE0:
        q, k = q[:, :1].expand_as(q), k[:, :1].expand_as(k)
    elif table is None:
        pass
    elif fault == B6_HALF_WINDOW:
        cols = torch.arange(table.shape[1], device=table.device)
        table = table * (cols % (2 * B6_KEY_HALF) < B6_KEY_HALF)
    elif fault == B6_TABLE_ROWS:
        rows = torch.arange(table.shape[0], device=table.device)
        other = rows ^ B6_ROW_HALF
        table = table[torch.where(other < table.shape[0], other, rows)]
    vol = cv.fused_agg_corr_dense_plain(q, k, table, clip, pos_w, agg_w,
                                        agg_b)
    if fault == B6_WB:
        vol = vol - vol.mean(dim=(1, 2), keepdim=True)
    return vol


def _b6_da_fault(q, k, g, vol, biases, grid, clip, agg_w):
    """The plain B6 backward's da over the first B6_KEY_GROUP keys only."""
    g = g.clone()
    g[..., B6_KEY_GROUP:] = 0.0
    return cv.agg_corr_bwd_plain(q, k, g, vol, biases, grid, clip, 0.5,
                                 agg_w)[1]


# The fp32 row term sum_j g_j p_j of U <= 2^13 terms rounds within
# U 2^-24 = 2^-11 of sum_j |g_j p_j| in any order.
B7_ROW_TERM_ULP = 2.0 ** -11


def b7_row_err(p, g):
    """B7's bf16 dc error per row: max |got - want| over the larger of the
    row's max |want| and what the fp32 row term's rounding moves dc by
    (B7_ROW_TERM_ULP * max_i p_i * sum_j |g_j p_j|); the worst row.  In a
    row whose softmax sits on one key, dc = p (g - sum g p) is a difference
    of near-equal sums that fp32 leaves at that level in any summation
    order (the plain version against its float64 self: 2.6e-2 of the row's
    max |dc| at md 2, 4.5e-5 at md 64)."""
    pf, gf = p.float(), g.float()
    floor = B7_ROW_TERM_ULP * pf.amax(-1) * (gf * pf).abs().sum(-1)
    del pf, gf

    def err(got, want):
        d = (got.float() - want.float()).abs().amax(-1)
        return float((d / torch.maximum(want.float().abs().amax(-1),
                                        floor)).max())
    return err


def _b7_fault(q, k, p, g, clip, row_term=True, mask=True, row_cols=None,
              last_bm=False):
    """The plain B7 backward with a planted fault: dl = p * g (the softmax
    row term dropped), no clamp mask, the row term over the first row_cols
    columns only, or dlsum of the last bm only."""
    c = ma.scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    p32, g32 = p.float(), g.float()
    gp = g32 * p32 if row_cols is None else (g32 * p32)[..., :row_cols]
    dl = p32 * (g32 - gp.sum(-1, keepdim=True)) if row_term else p32 * g32
    dc = torch.where(c.abs() < clip, dl, 0.0) if mask else dl
    dlsum = dl.flatten(0, 1)[-1] if last_bm else dl.sum(dim=(0, 1))
    return dc.to(p.dtype), dlsum


def check_b6_forward(dev, gen, report, biases, grid=CHAIRS_GRID,
                     batch=TRAIN_BATCH, modes=4, mds=(64, 32),
                     dtype=torch.bfloat16):
    """Phase 2, B6 forward (inter site, pos_w 0.5): the raw fp32 volume at
    `modes` modes of each dim in mds (64: the inter site; 32), the whole
    batch and one sample, the clamp off and on, each launched twice (the
    same bits), with faults planted in the plain version, among them three
    against the bf16 body's tiles, and mode_faults.  Returns the first md's
    q, k and the plain volume of the whole batch with the clamp on.  On CPU
    tensors the wrapper takes the plain version itself (how the tests run
    this check)."""
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    u = grid[0] * grid[1]
    # At one mode every mode is mode 0, and vol = s has no offset to leave.
    tile_faults = (B6_MODE0, B6_HALF_WINDOW, B6_WB) if modes > 1 else (
        B6_HALF_WINDOW,)
    for md in mds:
        q, k = inputs(gen, md, dev, u, batch, modes, dtype)
        print(f"B6 inputs M={modes} md={md} {dtype}: clip {CLIP_ON} clamps "
              f"{clamped_share(q, k, CLIP_ON):.3f} of the scores")
        for bsz, clip in ((batch, CLIP_OFF), (batch, CLIP_ON), (1, CLIP_OFF),
                          (1, CLIP_ON)):
            qb, kb = q[:bsz], k[:bsz]
            got = cv.fused_agg_corr(qb, kb, biases, grid, clip, 0.5, agg_w,
                                    agg_b)
            sync(dev)

            def plain(c, w, a=qb, b=kb):
                return cv.fused_agg_corr_plain(a, b, biases, grid, c, w,
                                               agg_w, agg_b)
            window = ma.window_rows(biases, grid, qb, kb)
            faults = {"no bias": lambda: plain(clip, 0.0)}
            if clip != CLIP_OFF:
                faults["no clamp"] = lambda: plain(CLIP_OFF, 0.5)
            for fault in tile_faults:
                faults[fault] = lambda fault=fault: b6_fwd_fault(
                    qb, kb, window, clip, 0.5, agg_w, agg_b, fault)
            faults.update(mode_faults(modes, md, lambda a, b: plain(
                clip, 0.5, a, b), qb, kb, agg=True))
            if modes > 4:
                faults[MAX_RESET] = lambda: max_reset_volume(
                    qb, kb, window, clip, 0.5, agg_w, agg_b)
            want = plain(clip, 0.5)
            label = f"B6 forward M={modes} md={md} {dtype} B={bsz} " \
                f"clip={clip:g}"
            hold(label, got, want, rel_err, B6_TOL, faults)
            note_err(report, "fused_agg_corr", modes,
                     float((got - want).abs().max()))
            got2 = cv.fused_agg_corr(qb, kb, biases, grid, clip, 0.5, agg_w,
                                     agg_b)
            sync(dev)
            assert torch.equal(got, got2), f"{label}: two launches differ"
            if md == mds[0] and bsz == batch and clip == CLIP_ON:
                q0, k0, vol = q, k, want
            del got, got2, faults, window, want
        del q, k
    return q0, k0, vol


def check_train_kernels(dev, gen, report, grid=CHAIRS_GRID,
                        batch=TRAIN_BATCH, wide=(4, 64), intra=(4, 32),
                        dtype=torch.bfloat16) -> None:
    """Phase 2, training kernels: B1 and B4 float at the chairs U (no tile
    divides it), B6 forward and backward, B7 backward, each against its
    plain version on the same peaky inputs, the clamp off and on, with
    faults planted in the plain versions (mode_faults, and DC_MODE_OFF in
    B6 backward's dc, among them), built and freed one at a time.  wide is
    the (modes, mode dim) of the 256-wide sites (B1, B4 float and B7 at the
    f2 site, B6 at the inter site), intra the intra site's (B1, B4 float,
    B7, B6 forward's second md; None: not checked), dtype the inputs'.  On
    CPU tensors the wrappers take the plain versions themselves (how the
    tests run this phase)."""
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    u = grid[0] * grid[1]
    dgen = torch.Generator(device=dev).manual_seed(1)
    sites = [(wide, 0.5)] + ([(intra, 1.0)] if intra else [])

    def randn(*shape):
        return torch.randn(*shape, generator=dgen, device=dev)

    # B1 at this ragged U, batch 8, md 64 (inter, f2) and 32 (intra).
    for (M, md), _ in sites:
        q, k = inputs(gen, md, dev, u, batch, M, dtype)
        scale = 1.0 / math.sqrt(md)
        got = float(ma.scores_global_max(q, k, scale))
        sync(dev)
        want = float(ma.scores_global_max_plain(q, k, scale))
        tag = f"B1 U={u} B={batch} M={M} md={md} {dtype}"
        print(f"{tag}: kernel {got:.6f} plain {want:.6f}")
        assert abs(got - want) <= B1_RTOL * abs(want), f"{tag} disagrees"
        for name, f in mode_faults(M, md, lambda a, b: float(
                ma.scores_global_max_plain(a, b, scale)), q, k).items():
            f = f()
            print(f"{tag}: planted fault '{name}' gives {f:.6f}")
            assert abs(f - want) > B1_RTOL * abs(want), \
                f"{tag}: the bound misses a '{name}' fault"
        if (M, md) == wide:
            qw, kw = q, k

    # B4 float (B7's forward) at this ragged U: the f2 site (pos_w 0.5) on
    # B1's inputs, then the intra site (pos_w 1).
    b4_cases = [(qw, kw, wide, 0.5)]
    if intra:
        b4_cases.append((*inputs(gen, intra[1], dev, u, batch, intra[0],
                                 dtype), intra, 1.0))
    del qw, kw
    while b4_cases:
        q, k, (M, md), pos_w = b4_cases.pop(0)
        for clip in (CLIP_OFF, CLIP_ON):
            clip_t = torch.tensor(clip, device=dev)

            def plain(c, w, a=q, b=k):
                return ma.mode_softmax_probs_plain(
                    a, b, biases, grid, torch.tensor(c, device=dev), w,
                    out_dtype=torch.float32)
            want = plain(clip, pos_w)
            faults = {"no bias": lambda: plain(clip, 0.0)}
            if clip != CLIP_OFF:
                faults["no clamp"] = lambda: plain(CLIP_OFF, pos_w)
            faults.update(mode_faults(M, md, lambda a, b: plain(
                clip, pos_w, a, b), q, k))
            for odt in probs_out_dtypes(dtype):
                got = ma.mode_softmax_probs(q, k, biases, grid, clip_t, pos_w,
                                            out_dtype=odt)
                sync(dev)
                hold(f"B4 U={u} M={M} md={md} {dtype} out {odt} "
                     f"clip={clip:g}", got, want, row_rel_err,
                     B4_ROW_TOL[odt], faults)
                del got
            del want, faults
        del q, k

    # B6 forward, then its backward on the wide md's inputs and the plain
    # volume of the whole batch with the clamp on.
    M, md = wide
    q, k, vol = check_b6_forward(
        dev, gen, report, biases, grid, batch, M,
        (md,) + ((intra[1],) if intra else ()), dtype)
    agg_w = torch.tensor(1.3, device=dev)

    # B6 backward: g ~ N(1, 1) so that da is a well-conditioned sum; the
    # whole batch, then one sample.
    g = randn(batch, u, u) + 1.0
    for bsz, clip in ((batch, CLIP_OFF), (batch, CLIP_ON), (1, CLIP_ON)):
        args = (q[:bsz], k[:bsz], g[:bsz], vol[:bsz], biases, grid, clip)
        dc, da = cv.agg_corr_bwd(*args, 0.5, agg_w)
        sync(dev)
        wdc, wda = cv.agg_corr_bwd_plain(*args, 0.5, agg_w)
        keep, band = _outside_band(q[:bsz], k[:bsz], clip)
        label = f"B6 backward M={M} md={md} {dtype} B={bsz} clip={clip:g}"
        print(f"{label}: {band:.2e} of dc in the mask band")
        fdc = {"no bias": lambda: cv.agg_corr_bwd_plain(
            *args[:-1], clip, 0.0, agg_w)[0]}
        if M > 1:  # at one mode t = p = 1, and mode 0 is every mode
            fdc["t = p"] = lambda: _b6_dc_fault(*args, agg_w, drop_term=True)
            fdc["dc of every mode from mode 0's scores"] = \
                lambda: _b6_dc_fault(*args, agg_w, mode0=True)
            fdc[DC_MODE_OFF] = lambda: wdc.roll(1, dims=1)
        if clip != CLIP_OFF:
            fdc["no clamp mask"] = lambda: _b6_dc_fault(*args, agg_w,
                                                        mask=False)
        if M > 4:
            fdc[GROUP_DROPPED] = lambda: torch.cat(
                [wdc[:, :4], torch.zeros_like(wdc[:, 4:])], 1)
            fdc[MAX_RESET] = lambda: _b6_dc_fault(*args, agg_w,
                                                  max_reset=True)
        if M > 16:
            fdc[GROUP_SKIPPED] = lambda: torch.cat(
                [wdc[:, :16], torch.zeros_like(wdc[:, 16:20]), wdc[:, 20:]],
                1)
        if md > 64:
            fdc[CHUNK_SWAPPED] = lambda: cv.agg_corr_bwd_plain(
                swap_md_chunks(args[0]), *args[1:], 0.5, agg_w)[0]
        got_m, want_m = _masked(keep, dc, wdc)
        hold(f"{label} dc", got_m, want_m, rel_err, B6_TOL,
             {n: (lambda f=f: _masked(keep, f())[0]) for n, f in fdc.items()})
        del fdc, got_m, want_m
        fda = {"no bias": lambda: cv.agg_corr_bwd_plain(
            *args[:-1], clip, 0.0, agg_w)[1]}
        if float(wda) == 0.0:
            # One mode and its own volume: vol = s, so da = sum g s (s -
            # vol) = 0 at any agg_w; without the bias s != vol.
            print(f"{label} da: {float(da):.3e} (one mode: 0)")
            assert float(da) == 0.0, f"{label}: kernel disagrees on da"
            for name, f in fda.items():
                f = float(f())
                print(f"{label} da: planted fault '{name}' gives {f:.3e}")
                assert f != 0.0, f"{label} da: the check misses '{name}'"
        else:
            if M == 1:
                # One mode against another clamp's volume: da is the
                # clamp's s (s - vol), which the bias barely moves; the dc
                # check above holds the bias.
                del fda["no bias"]
            if u > B6_KEY_GROUP:
                fda["da from the first key group only"] = \
                    lambda: _b6_da_fault(*args, agg_w)
            hold(f"{label} da", da, wda,
                 lambda a, b: float((a - b).abs() / b.abs()), B6_DA_RTOL,
                 fda)
        dc2, da2 = cv.agg_corr_bwd(*args, 0.5, agg_w)
        sync(dev)
        assert torch.equal(dc, dc2) and torch.equal(da, da2), \
            f"{label}: two launches differ"
        note_err(report, "agg_corr_bwd", M,
                 float(((dc - wdc) * keep).abs().max()))
        del dc, wdc, dc2, keep
    del vol, g, q, k

    # B7 backward at the f2 (md 64, pos_w 0.5) and intra (md 32) shapes,
    # from the site's own probs and a cotangent in dtype; then at the f2
    # shape one (b, mode) slice, BM = 1.  fp32 dc is held over the tensor's
    # largest value (B7_FP32_DC_TOL), bf16 per row.
    bf16_dc = dtype == torch.bfloat16
    for (M, md), pos_w in sites:
        q, k = inputs(gen, md, dev, u, batch, M, dtype)
        g = randn(batch, M, u, u).to(dtype)
        cases = [(M * batch, CLIP_OFF), (M * batch, CLIP_ON)]
        if (M, md) == wide:
            cases.append((1, CLIP_ON))
        for bm, clip in cases:
            p = ma.mode_softmax_probs_plain(
                q, k, biases, grid, torch.tensor(clip, device=dev), pos_w,
                out_dtype=dtype)
            args = (q, k, p, g) if bm > 1 else tuple(
                x[:1, :1] for x in (q, k, p, g))
            dc, dlsum = pv.probs_bwd(*args, clip)
            sync(dev)
            wdc, wdlsum = pv.probs_bwd_plain(*args, clip)
            label = f"B7 backward M={M} md={md} {dtype} BM={bm} clip={clip:g}"
            keep, band = _outside_band(args[0], args[1], clip)
            print(f"{label}: {band:.2e} of dc in the mask band")
            # dl = p * g: the softmax row term dropped.
            faults = {"no row term": dict(row_term=False)}
            if u > B7_COL_TILE:
                faults["row term over the first column tile only"] = dict(
                    row_cols=B7_COL_TILE)
            fdc = {n: (lambda kw=kw: _b7_fault(*args, clip, **kw)[0])
                   for n, kw in faults.items()}
            fsum = {n: (lambda kw=kw: _b7_fault(*args, clip, **kw)[1])
                    for n, kw in faults.items()}
            if bm > 1:
                fsum["dlsum of the last bm only"] = lambda: _b7_fault(
                    *args, clip, last_bm=True)[1]
            if clip != CLIP_OFF:  # q and k enter dc through the mask only
                fdc["no clamp mask"] = lambda: _b7_fault(*args, clip,
                                                         mask=False)[0]
                if md > 64:
                    fdc[CHUNK_SWAPPED] = lambda: pv.probs_bwd_plain(
                        swap_md_chunks(args[0]), *args[1:], clip)[0]
                if md < ma.MMA_K:
                    fdc[PAD_NONZERO] = lambda: pv.probs_bwd_plain(
                        pad_col_fault(args[0]), pad_col_fault(args[1]),
                        *args[2:], clip)[0]
            got_m, want_m = _masked(keep, dc, wdc)
            dc_err, dc_tol = ((b7_row_err(args[2], args[3]), B7_DC_TOL)
                              if bf16_dc else (rel_err, B7_FP32_DC_TOL))
            hold(f"{label} dc", got_m, want_m, dc_err, dc_tol,
                 {n: (lambda f=f: _masked(keep, f())[0])
                  for n, f in fdc.items()})
            hold(f"{label} dlsum", dlsum, wdlsum, rel_err, B7_DLSUM_TOL,
                 fsum)
            dc2, dlsum2 = pv.probs_bwd(*args, clip)
            sync(dev)
            assert torch.equal(dc, dc2) and torch.equal(dlsum, dlsum2), \
                f"{label}: two launches differ"
            note_err(report, "probs_bwd", M,
                     float((dlsum - wdlsum).abs().max()))
            del p, args, dc, dlsum, dc2, dlsum2, wdc, wdlsum, fdc, fsum
            del got_m, want_m, keep
        del q, k, g
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# B5, the pyramid lookup: (label, batch, H8, W8, level type) of the serving
# pair (440x1024), a chairs training batch (368x496, batch 8) and the oracle
# (128x128, fp32).
LOOKUP_SHAPES = (("serving", 1, H8, W8, torch.bfloat16),
                 ("chairs", TRAIN_BATCH, *CHAIRS_GRID, torch.bfloat16),
                 ("oracle", 1, 16, 16, torch.float32))
RADIUS, LEVELS = 4, 4
# Forward: kernel and plain version blend the same four level values in
# fp32 with the same operations, so the bound is 4 fp32 ulps of max |level|.
B5_FWD_TOL = 4 * 2.0 ** -23
# Backward, each element against the plain version on fp32 levels: one bf16
# rounding (half an ulp, 2^-8 of the value) for bf16 levels, 4 fp32 ulps of
# the value for fp32 levels.
B5_BWD_TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 4 * 2.0 ** -23}
B5_FAULTS = ("i, j swapped", "clamped padding", "level scale 2^(l+1)",
             "no y blend")


def lookup_inputs(dev, batch, h8, w8, dtype, seed=3):
    """Seeded levels [Q, h8 / 2^l, w8 / 2^l] ~ N(0, 1) in `dtype` (odd
    edges dropped, as the pyramid pools) and coords [batch, h8, w8, 2]: the
    token grid moved by up to 6 px, so windows near the edges lie partly
    outside; every 5th query on integers; every 13th left of and above
    every level, every 17th beyond it (wholly outside)."""
    dgen = torch.Generator(device=dev).manual_seed(seed)
    Q = batch * h8 * w8
    levels = [torch.randn(Q, h8 >> l, w8 >> l, generator=dgen,
                          device=dev).to(dtype) for l in range(LEVELS)]
    coords = coords_grid(batch, h8, w8, device=dev) + torch.rand(
        batch, h8, w8, 2, generator=dgen, device=dev) * 12 - 6
    flat = coords.view(-1, 2)
    flat[::5] = flat[::5].round()
    flat[::13] = -200.0 - flat[::13]
    flat[::17] += 150.0 + max(h8, w8)
    return levels, coords


def _b5_fault(levels, coords, r, fault):
    """The plain lookup with one planted fault (B5_FAULTS): the channel
    order (x-offset, y-offset) swapped, out-of-level corners clamped to the
    edge instead of read as zero, level l at coords / 2^(l+1), or the y
    blend dropped (each window row read at its integer row)."""
    B, H1, W1, _ = coords.shape
    n, Q = 2 * r + 1, B * H1 * W1
    flat = coords.reshape(Q, 2).float()
    t = torch.arange(n + 1, device=coords.device)
    out = []
    for i, level in enumerate(levels):
        h, w = level.shape[1], level.shape[2]
        if h == 0 or w == 0:
            out.append(flat.new_zeros(B, H1, W1, n * n))
            continue
        base = flat / 2.0 ** (i + (fault == "level scale 2^(l+1)"))
        x0, y0 = torch.floor(base[:, 0]), torch.floor(base[:, 1])
        fx = (base[:, 0] - x0)[:, None, None]
        fy = (base[:, 1] - y0)[:, None, None]
        cols = x0.long()[:, None] - r + t[None]
        rows = y0.long()[:, None] - r + t[None]
        valid = (((rows >= 0) & (rows < h))[:, :, None]
                 & ((cols >= 0) & (cols < w))[:, None, :])
        if fault == "clamped padding":
            valid = torch.ones_like(valid)
        idx = rows.clamp(0, h - 1)[:, :, None] * w \
            + cols.clamp(0, w - 1)[:, None, :]
        g = torch.gather(level.reshape(Q, h * w), 1, idx.reshape(Q, -1))
        g = g.reshape(Q, n + 1, n + 1).float() * valid
        gy = g[:, :n] if fault == "no y blend" else \
            (1 - fy) * g[:, :n] + fy * g[:, 1:]
        win = (1 - fx) * gy[:, :, :n] + fx * gy[:, :, 1:]  # [Q, j, i]
        if fault != "i, j swapped":
            win = win.transpose(1, 2)
        out.append(win.reshape(B, H1, W1, n * n))
    return torch.cat(out, dim=-1)


def _b5_bwd_fault(coords, g, shapes, r, fault):
    """Level gradients of _b5_fault (fp32), by autograd."""
    with torch.enable_grad():
        levels = [torch.zeros(s, device=coords.device, requires_grad=True)
                  for s in shapes]
        out = _b5_fault(levels, coords, r, fault)
        grads = torch.autograd.grad(out, levels, g, allow_unused=True)
    return [torch.zeros_like(lv) if d is None else d
            for lv, d in zip(levels, grads)]


# B5's backward writes each level as 16-byte units (8 bf16, 4 fp32), one
# writer each; at odd slab sizes a unit straddles two queries.  A kernel
# that skipped such a unit, or had two writers add into it, would show as
# these faults.
B5_UNIT_FAULTS = ("straddling unit dropped", "straddling unit doubled")


def _b5_unit_faults(want, dtype) -> dict:
    """{fault: want with every nonzero unit that straddles two queries
    zeroed or doubled}, for the B5_UNIT_FAULTS that these shapes can show
    (none where every slab fills whole units)."""
    ue = 16 // torch.empty((), dtype=dtype).element_size()
    sel = []
    for d in want:
        hw, n = d.shape[1] * d.shape[2], d.numel()
        if n == 0:
            sel.append(None)
            continue
        nu = -(-n // ue)
        first = torch.arange(nu, device=d.device) * ue
        last = (first + ue).clamp(max=n) - 1
        pad = d.new_zeros(nu * ue)
        pad[:n] = d.reshape(-1).abs()
        unit = ((first // hw != last // hw)
                & (pad.view(nu, ue).amax(1) > 0))
        sel.append(unit.repeat_interleave(ue)[:n].view_as(d))
    if not any(m is not None and bool(m.any()) for m in sel):
        return {}
    return {f: [d if m is None else torch.where(
        m, d * (0.0 if f == B5_UNIT_FAULTS[0] else 2.0), d)
        for d, m in zip(want, sel)] for f in B5_UNIT_FAULTS}


def level_rel_err(got, want) -> float:
    """Per element |got - want| / |want| (0 where both are 0), the worst
    over every level."""
    return max(float(((a.float() - b.float()).abs()
                      / b.float().abs().clamp(min=1e-30)).max())
               for a, b in zip(got, want) if b.numel())


def check_lookup(dev, report, shapes=LOOKUP_SHAPES) -> None:
    """Phase 2, B5: the lookup kernel and its backward against the plain
    versions, with the four B5_FAULTS planted in the plain versions."""
    errs = {"corr_lookup": [], "corr_lookup_bwd": []}
    for label, batch, h8, w8, dtype in shapes:
        levels, coords = lookup_inputs(dev, batch, h8, w8, dtype)
        top = max(float(lv.float().abs().max()) for lv in levels
                  if lv.numel())
        got = lk.corr_lookup(levels, coords, RADIUS)
        sync(dev)
        want = lk.corr_lookup_plain(levels, coords, RADIUS)
        hold(f"B5 forward {label} {dtype}", got, want,
             lambda a, b: float((a - b).abs().max()) / top, B5_FWD_TOL,
             {f: _b5_fault(levels, coords, RADIUS, f) for f in B5_FAULTS})
        errs["corr_lookup"].append(float((got - want).abs().max()))
        shapes_ = [tuple(lv.shape) for lv in levels]
        g = torch.randn(got.shape, generator=torch.Generator(
            device=dev).manual_seed(4), device=dev)
        del got, want, levels
        got = lk.corr_lookup_bwd(coords, g, shapes_, dtype, RADIUS)
        sync(dev)
        want = lk.corr_lookup_bwd_plain(coords, g, shapes_, torch.float32,
                                        RADIUS)
        hold(f"B5 backward {label} {dtype}", got, want, level_rel_err,
             B5_BWD_TOL[dtype],
             {**{f: _b5_bwd_fault(coords, g, shapes_, RADIUS, f)
                 for f in B5_FAULTS}, **_b5_unit_faults(want, dtype)})
        errs["corr_lookup_bwd"].append(max(
            float((a.float() - b).abs().max()) for a, b in zip(got, want)
            if b.numel()))
        del got, want, g
    for name, e in errs.items():
        report[name]["max_abs_err"] = max(e)


# B5 at slabs of odd sizes (11 x 15 -> 165, 35, 6 and 1 values a query:
# 16-byte units straddle queries at every level), batch 3, at the radii
# 0, 1, 4 and 7 (each a kernel of its own).
LOOKUP_ODD_GRID = ("odd slabs", 3, 11, 15)
LOOKUP_RADII = (0, 1, 4, 7)


def check_lookup_radii(dev, report, grid=LOOKUP_ODD_GRID,
                       radii=LOOKUP_RADII) -> None:
    """Phase 2, B5 at odd slab sizes and every radius of LOOKUP_RADII, bf16
    and fp32 levels: forward and backward against the plain versions, the
    backward with B5_UNIT_FAULTS planted (they must be plantable here)."""
    label, batch, h8, w8 = grid
    for dtype in (torch.bfloat16, torch.float32):
        levels, coords = lookup_inputs(dev, batch, h8, w8, dtype, seed=5)
        top = max(float(lv.float().abs().max()) for lv in levels
                  if lv.numel())
        shapes = [tuple(lv.shape) for lv in levels]
        for r in radii:
            tag = f"B5 {label} r={r} {dtype}"
            got = lk.corr_lookup(levels, coords, r)
            sync(dev)
            want = lk.corr_lookup_plain(levels, coords, r)
            hold(f"{tag} forward", got, want,
                 lambda a, b: float((a - b).abs().max()) / top, B5_FWD_TOL,
                 {})
            g = torch.randn(got.shape, generator=torch.Generator(
                device=dev).manual_seed(6), device=dev)
            got = lk.corr_lookup_bwd(coords, g, shapes, dtype, r)
            sync(dev)
            want = lk.corr_lookup_bwd_plain(coords, g, shapes, torch.float32,
                                            r)
            faults = _b5_unit_faults(want, dtype)
            assert set(faults) == set(B5_UNIT_FAULTS), tag
            hold(f"{tag} backward", got, want, level_rel_err,
                 B5_BWD_TOL[dtype], faults)
            report["corr_lookup_bwd"]["max_abs_err"] = max(
                report["corr_lookup_bwd"].get("max_abs_err") or 0.0,
                *(float((a.float() - b).abs().max())
                  for a, b in zip(got, want) if b.numel()))
            del got, want, g, faults


# B5 at D = 2 (two-way correlation, --f1): every level two planes, the L D
# planes in (level, d) order, plane p sampled at coords / 2^(p // 2), its
# outputs channel block p.  Faults planted in the plain versions: the two
# planes of each level swapped, every plane scaled as a level of its own
# (plane p at coords / 2^p: the one-way rule over 8 planes), the channels
# in (level, i, j, d) order, and each level's two plane gradients swapped
# (a plane's backward written into the other).
LOOKUP_D = 2
B5_PLANE_FAULTS = ("planes swapped", "plane p scaled as level p",
                   "channels (i, j, d)", "backward into the other plane")


def lookup_planes(dev, batch, h8, w8, dtype, seed=3):
    """lookup_inputs with LOOKUP_D planes a level: (planes, coords)."""
    dgen = torch.Generator(device=dev).manual_seed(seed + 100)
    levels, coords = lookup_inputs(dev, batch, h8, w8, dtype, seed)
    planes = []
    for lv in levels:
        planes.append(lv)
        planes += [torch.randn(lv.shape, generator=dgen, device=dev)
                   .to(dtype) for _ in range(LOOKUP_D - 1)]
    return planes, coords


def _swap_pairs(items):
    out = list(items)
    for p in range(0, len(out), LOOKUP_D):
        out[p:p + LOOKUP_D] = out[p:p + LOOKUP_D][::-1]
    return out


def _b5_plane_fault(planes, coords, r, fault):
    """The plain D = 2 lookup with one B5_PLANE_FAULTS fault (forward)."""
    if fault == "planes swapped":
        return lk.corr_lookup_plain(_swap_pairs(planes), coords, r, LOOKUP_D)
    if fault == "plane p scaled as level p":
        return lk.corr_lookup_plain(planes, coords, r, 1)
    out = lk.corr_lookup_plain(planes, coords, r, LOOKUP_D)
    if fault == "channels (i, j, d)":
        lead, L = out.shape[:3], len(planes) // LOOKUP_D
        out = out.reshape(*lead, L, LOOKUP_D, -1).transpose(-1, -2) \
            .reshape(*lead, -1)
    return out


def _b5_plane_bwd_fault(coords, g, shapes, r, fault):
    """Plane gradients (fp32) of the plain D = 2 lookup with one fault."""
    if fault == "backward into the other plane":
        return _swap_pairs(lk.corr_lookup_bwd_plain(
            coords, g, shapes, torch.float32, r, LOOKUP_D))
    with torch.enable_grad():
        planes = [torch.zeros(s, device=coords.device, requires_grad=True)
                  for s in shapes]
        out = _b5_plane_fault(planes, coords, r, fault)
        grads = torch.autograd.grad(out, planes, g, allow_unused=True)
    return [torch.zeros_like(lv) if d is None else d
            for lv, d in zip(planes, grads)]


def check_lookup_planes(dev, report, shapes=LOOKUP_SHAPES) -> None:
    """Phase 2, B5 at D = 2: the lookup and its backward against the plain
    versions at the serving, chairs and oracle shapes (8 planes), with the
    B5_PLANE_FAULTS planted in the plain versions; the forward's bound is
    D = 1's, the backward's too."""
    errs = {"corr_lookup_d2": [], "corr_lookup_bwd_d2": []}
    for label, batch, h8, w8, dtype in shapes:
        planes, coords = lookup_planes(dev, batch, h8, w8, dtype)
        top = max(float(lv.float().abs().max()) for lv in planes
                  if lv.numel())
        got = lk.corr_lookup(planes, coords, RADIUS, LOOKUP_D)
        sync(dev)
        want = lk.corr_lookup_plain(planes, coords, RADIUS, LOOKUP_D)
        assert got.shape[-1] == LEVELS * LOOKUP_D * (2 * RADIUS + 1) ** 2
        hold(f"B5 D=2 forward {label} {dtype}", got, want,
             lambda a, b: float((a - b).abs().max()) / top, B5_FWD_TOL,
             {f: _b5_plane_fault(planes, coords, RADIUS, f)
              for f in B5_PLANE_FAULTS[:3]})
        errs["corr_lookup_d2"].append(float((got - want).abs().max()))
        shapes_ = [tuple(lv.shape) for lv in planes]
        g = torch.randn(got.shape, generator=torch.Generator(
            device=dev).manual_seed(4), device=dev)
        del got, want, planes
        got = lk.corr_lookup_bwd(coords, g, shapes_, dtype, RADIUS, LOOKUP_D)
        sync(dev)
        want = lk.corr_lookup_bwd_plain(coords, g, shapes_, torch.float32,
                                        RADIUS, LOOKUP_D)
        hold(f"B5 D=2 backward {label} {dtype}", got, want, level_rel_err,
             B5_BWD_TOL[dtype],
             {f: _b5_plane_bwd_fault(coords, g, shapes_, RADIUS, f)
              for f in B5_PLANE_FAULTS})
        errs["corr_lookup_bwd_d2"].append(max(
            float((a.float() - b).abs().max()) for a, b in zip(got, want)
            if b.numel()))
        del got, want, g
    for name, e in errs.items():
        report[name]["max_abs_err"] = max(e)


# Phase 2, the dense-table kernels (B8, B6 dense, B4 dense) at the serving
# shapes.  The seeded table ~ N(0, BIAS_STD^2), as the window; pos_w 0.5 at
# every kernel, so that a table scaled by pos_w twice differs.  The
# rectangular case's U2 = 129 leaves 63 ragged keys in its last 64-key
# tile: a kernel that read them as scores of 0 would move about a tenth of
# each softmax row's weight onto zero keys.
RECT_U2 = 129
# B3 and B5 at the HD1K grid (1080x2560 padded to 1088x2560: 136 x 320,
# U = 43520): the level-0 volume holds U^2 = 1.89e9 elements, 3.79e9 bytes
# in bf16, past 2^31, so a byte offset or a char* sum in 32 bits would
# wrap on the last rows.  The plain versions over all U rows do not fit:
# the global moments and the raw max come from whole grid rows at a time
# (B9's plain shard functions), and the outputs are compared on the last
# rows only.
HD1K_GRID = (136, 320)
HD1K_LAST_ROWS = 2       # grid rows compared at the end of the volume
HD1K_CHUNK_ROWS = 4      # grid rows a plain chunk


def check_hd1k_grid(dev, gen, grid=HD1K_GRID, last=HD1K_LAST_ROWS,
                    chunk=HD1K_CHUNK_ROWS) -> dict:
    """Phase 2: B3 (its bf16 volume, stats) and B5 forward at the HD1K
    grid, on the last `last` grid rows, against their plain versions; a
    dropped bias (B3) and the slabs of the grid row above (B5: a query
    reading another query's slab) planted, which must fail the bounds."""
    H8, W8 = grid
    u = H8 * W8
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    q, k = inputs(gen, 64, dev, u)
    agg_w = torch.tensor(1.3, device=dev)
    agg_b = torch.tensor(0.1, device=dev)
    attn_clip, pos_w = CLIP_ON, 0.5
    got, stats = ma.fused_agg_corr_norm(q, k, biases, grid, attn_clip,
                                        pos_w, agg_w, agg_b)
    sync(dev)
    print(f"B3 HD1K {H8}x{W8}: volume {got.numel()} elements, "
          f"{got.numel() * got.element_size()} bytes")
    scale = 1.0 / math.sqrt(64)
    rows = [(r0, min(r0 + chunk, H8)) for r0 in range(0, H8, chunk)]
    gmax = max(float(ma.scores(q[:, :, r0 * W8:r1 * W8], k, scale).amax())
               for r0, r1 in rows)
    gmax = torch.tensor(gmax, device=dev)
    sums = sum(ma.corr_norm_sums_plain(q[:, :, r0 * W8:r1 * W8], k, biases,
                                       grid, gmax, attn_clip, pos_w, agg_w,
                                       agg_b, q_row0=r0)
               for r0, r1 in rows)
    n_elems = float(u) * float(u)
    r0 = H8 - last

    def plain(pw):
        return ma.corr_norm_write_plain(
            q[:, :, r0 * W8:], k, biases, grid, gmax, sums, n_elems,
            attn_clip, pw, agg_w, agg_b, q_row0=r0, out_dtype=torch.float32)
    want = plain(pos_w)
    out = {"b3": hold(f"B3 HD1K last {last} rows", got[:, r0 * W8:], want,
                      b3_err, 1.0, {"no bias": plain(0.0)})}
    mean, ex2 = sums[0, 0] / n_elems, sums[0, 1] / n_elems
    torch.testing.assert_close(
        stats[0, 0, :3], torch.stack([gmax, mean.float(), ex2.float()]),
        rtol=1e-4, atol=1e-5)
    del got, want, q, k
    torch.cuda.empty_cache()

    levels, coords = lookup_inputs(dev, 1, H8, W8, torch.bfloat16)
    got = lk.corr_lookup(levels, coords, RADIUS)
    sync(dev)
    n_last = last * W8
    top = max(float(lv[-n_last:].float().abs().max()) for lv in levels
              if lv.numel())

    def plain_lookup(shift):
        lv = [x[x.shape[0] - n_last - shift:x.shape[0] - shift]
              for x in levels]
        return lk.corr_lookup_plain(lv, coords[:, H8 - last:].contiguous(),
                                    RADIUS)
    out["b5"] = hold(f"B5 HD1K last {last} rows", got[:, H8 - last:],
                     plain_lookup(0),
                     lambda a, b: float((a - b).abs().max()) / top,
                     B5_FWD_TOL, {"the slabs of the row above":
                                  plain_lookup(W8)})
    del got, levels
    torch.cuda.empty_cache()
    return out


# Phase 2, B2 at the lazy intra aggregator's width (F 128, md 32, the intra
# site's pos_w 1.0), bf16 and fp32, the clamp off and on: the serving grid
# at B = 1, a ragged grid (37 x 61: neither U nor W8 a multiple of a tile)
# and HD1K's last two grid rows of a whole-grid launch (U * U = 1.89e9,
# within 12 % of 2^31; the plain version over all rows would be a 30 GB
# fp32 tensor, so it takes those rows with q_row0).
LAZY_F, LAZY_MD, LAZY_POS_W = 128, 32, 1.0
B2_LAZY_GRIDS = (("serving", (H8, W8)), ("ragged", (37, 61)))


def b2_tol(dtype) -> float:
    """B2_TOL for bf16; fp32 sums in another order: DENSE_FP32_TOL."""
    return B2_TOL if dtype == torch.bfloat16 else DENSE_FP32_TOL


def check_b2_lazy(dev, gen, report, grids=B2_LAZY_GRIDS, hd1k=HD1K_GRID,
                  last=HD1K_LAST_ROWS, modes=(4, LAZY_MD)) -> None:
    """Phase 2: B2 at F 128 at the intra site's (modes, mode dim) against
    its plain version on each grid (and on the last `last` grid rows of
    `hd1k`; None: none), bf16 and fp32, the clamp off and on; a dropped
    bias, a missing clamp, keys 64-127 of every 128-key tile dropped
    (HALF_TILE, against the pipelined body's tiles) and mode_faults
    planted in the plain version must fall outside the bound."""
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    M, md = modes
    cases = [(label, grid, 0) for label, grid in grids]
    if hd1k is not None:
        cases.append((f"HD1K {hd1k[0]}x{hd1k[1]} last {last} rows", hd1k,
                      last))
    for label, grid, last_rows in cases:
        u = grid[0] * grid[1]
        t0 = (grid[0] - last_rows) * grid[1] if last_rows else 0
        q, k = inputs(gen, md, dev, u, modes=M)
        v = torch.randn(1, M, u, LAZY_F, generator=gen).to(dev,
                                                           torch.bfloat16)
        for dt in (torch.bfloat16, torch.float32):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            qp = qd[:, :, t0:]
            for clip in (CLIP_OFF, CLIP_ON):
                got = ma.flash_mode_attention(
                    qd, kd, vd, biases, grid, torch.tensor(clip, device=dev),
                    LAZY_POS_W)[:, :, t0:]
                sync(dev)

                def plain(c, w, a=qp, b=kd):
                    return ma.flash_mode_attention_plain(
                        a, b, vd, biases, grid,
                        torch.tensor(c, device=dev), w,
                        q_row0=t0 // grid[1])
                faults = {"no bias": lambda: plain(clip, 0.0)}
                if clip != CLIP_OFF:
                    faults["no clamp"] = lambda: plain(CLIP_OFF, LAZY_POS_W)
                faults.update(mode_faults(M, md, lambda a, b: plain(
                    clip, LAZY_POS_W, a, b), qp, kd))
                faults[HALF_TILE] = lambda: b2_half_tile(
                    qp, kd, vd, biases, grid, torch.tensor(clip, device=dev),
                    LAZY_POS_W, q_row0=t0 // grid[1])
                want = plain(clip, LAZY_POS_W)
                hold(f"B2 F={LAZY_F} M={M} md={md} {label} {dt} "
                     f"clip={clip:g}", got, want, rel_err, b2_tol(dt),
                     faults)
                note_err(report, "flash_mode_attention_f128", M,
                         float((got.float() - want.float()).abs().max()))
                del got, want, faults
        del q, k, v, qd, kd, vd, qp
        if dev.type == "cuda":
            torch.cuda.empty_cache()


DENSE_POS_W = 0.5
DENSE_FP32_TOL = 1e-4  # fp32 out, max |diff| / max |plain|: fp32 sums of md
#                        products in another order and an online softmax
AGG_WB = (1.3, 0.1)  # the inter site's learned (agg_w, agg_b) in the checks


def _pad_keys(x, mult: int = 64):
    """x [B, M, U2, d] with zero rows up to a multiple of `mult`: the keys a
    kernel with its ragged keys left unmasked would read as scores of 0."""
    pad = -x.shape[2] % mult
    return torch.cat([x, x.new_zeros(*x.shape[:2], pad, x.shape[3])], 2) \
        if pad else x


def _dense_plains(wide=(4, 64), intra=(4, 32)):
    """{wrapper name: (plain(q, k, table, clip, pos_w, v), (modes, mode
    dim), io dtype -> (err_fn, tol), the plain version with its ragged keys
    left unmasked or None)}: B8 and B6 dense at the 256-wide sites' count,
    B4 dense at the intra site's (none where intra is None)."""
    def b8(q, k, table, clip, pos_w, v):
        return ma.flash_mode_attention_dense_plain(q, k, v, table, clip, pos_w)

    def b8_ragged(q, k, table, clip, pos_w, v):
        u2 = k.shape[2]
        t = None if table is None else torch.nn.functional.pad(
            table, (0, -u2 % 64))
        return b8(q, _pad_keys(k), t, clip, pos_w, _pad_keys(v))

    def b6(q, k, table, clip, pos_w, v):
        return cv.fused_agg_corr_dense_plain(q, k, table, clip, pos_w,
                                             *AGG_WB)

    def b4(q, k, table, clip, pos_w, v):
        return ma.mode_softmax_probs_dense_plain(q, k, table, clip, pos_w,
                                                 out_dtype=torch.float32)

    def b4_ragged(q, k, table, clip, pos_w, v):
        u2 = k.shape[2]
        t = None if table is None else torch.nn.functional.pad(
            table, (0, -u2 % 64))
        return b4(q, _pad_keys(k), t, clip, pos_w, v)[..., :u2]

    def b8_tol(dtype):
        return rel_err, b2_tol(dtype)
    out = {
        "flash_mode_attention_dense": (b8, wide, b8_tol, b8_ragged),
        "fused_agg_corr_dense": (b6, wide, lambda _: (rel_err, B6_TOL),
                                 None)}
    if intra:
        out["mode_softmax_probs_dense"] = (b4, intra, lambda dtype: (
            row_rel_err, B4_ROW_TOL[dtype]), b4_ragged)
    return out


def _dense_call(name, q, k, table, clip, v):
    """The kernel wrapper `name` on one case (v: B8's values)."""
    module = ma if name != "fused_agg_corr_dense" else cv
    fn = getattr(module, name)
    if name == "flash_mode_attention_dense":
        return fn(q, k, v, table, clip, DENSE_POS_W)
    if name == "fused_agg_corr_dense":
        return fn(q, k, table, clip, DENSE_POS_W, *AGG_WB)
    return fn(q, k, table, clip, DENSE_POS_W, out_dtype=q.dtype)


def check_dense_kernels(dev, gen, report, grid=(H8, W8),
                        rect_u2=RECT_U2, wide=(4, 64), intra=(4, 32),
                        only=None) -> None:
    """Phase 2, the dense-table kernels against their plain versions, each
    with faults planted in the plain version: no table and a seeded one, a
    U1 != U2 case with ragged keys, the clamp off and on, bf16 and fp32
    inputs (only: the labels of the cases to run; None: all), at the mode
    counts of _dense_plains(wide, intra), with mode_faults.  On CPU tensors
    the wrappers take the plain versions themselves (how the tests run
    this phase with faults planted in the wrappers)."""
    u = grid[0] * grid[1]
    tables = {u: (torch.randn(u, u, generator=gen) * BIAS_STD).to(dev),
              rect_u2: (torch.randn(u, rect_u2, generator=gen)
                        * BIAS_STD).to(dev)}
    # (label, U2, io dtype, with a table, clip)
    cases = [("no table, clip off", u, torch.bfloat16, False, CLIP_OFF),
             ("no table, clip on", u, torch.bfloat16, False, CLIP_ON),
             ("table, clip off", u, torch.bfloat16, True, CLIP_OFF),
             ("table, clip on", u, torch.bfloat16, True, CLIP_ON),
             (f"U1={u} U2={rect_u2}, table, clip on", rect_u2,
              torch.bfloat16, True, CLIP_ON),
             ("fp32, table, clip on", u, torch.float32, True, CLIP_ON)]
    cases = [c for c in cases if only is None or c[0] in only]
    for name, (plain, (M, md), tol_of, ragged) in _dense_plains(
            wide, intra).items():
        # At one mode every mode is mode 0, and vol = s has no offset.
        b6_faults = (B6_MODE0, B6_WB) if M > 1 else ()
        for label, u2, dtype, with_table, clip in cases:
            q = (torch.randn(1, M, u, md, generator=gen) * QK_STD).to(dev,
                                                                      dtype)
            k = (torch.randn(1, M, u2, md, generator=gen) * QK_STD).to(
                dev, dtype)
            v = torch.randn(1, M, u2, 256, generator=gen).to(dev, dtype)
            full = tables[u2]
            table = full if with_table else None
            clip_t = torch.tensor(clip, device=dev)
            got = _dense_call(name, q, k, table, clip_t, v)
            sync(dev)
            want = plain(q, k, table, clip_t, DENSE_POS_W, v)
            if with_table:
                faults = {"table scaled by pos_w twice": lambda: plain(
                    q, k, table, clip_t, DENSE_POS_W ** 2, v)}
                if u2 == u:
                    faults["table transposed"] = lambda: plain(
                        q, k, table.t(), clip_t, DENSE_POS_W, v)
            else:
                faults = {"a table where there is none": lambda: plain(
                    q, k, full, clip_t, DENSE_POS_W, v)}
            if clip != CLIP_OFF:
                faults["no clamp"] = lambda: plain(
                    q, k, table, torch.tensor(CLIP_OFF, device=dev),
                    DENSE_POS_W, v)
            if ragged is not None and u2 != u:
                faults["ragged keys unmasked"] = lambda: ragged(
                    q, k, table, clip_t, DENSE_POS_W, v)
            if name == "fused_agg_corr_dense":  # against B6's bf16 tiles
                for fault in b6_faults + (
                        (B6_TABLE_ROWS,) if with_table else ()):
                    faults[fault] = lambda fault=fault: b6_fwd_fault(
                        q, k, table, clip_t, DENSE_POS_W, *AGG_WB, fault)
            faults.update(mode_faults(M, md, lambda a, b: plain(
                a, b, table, clip_t, DENSE_POS_W, v), q, k,
                agg=name == "fused_agg_corr_dense"))
            if name == "flash_mode_attention_dense":
                faults.update(flash_faults(md, lambda a, b: plain(
                    a, b, table, clip_t, DENSE_POS_W, v), q, k))
            if name == "fused_agg_corr_dense" and M > 4:
                faults[MAX_RESET] = lambda: max_reset_volume(
                    q, k, table, clip_t, DENSE_POS_W, *AGG_WB)
            err_fn, tol = tol_of(dtype)
            hold(f"{name} M={M} md={md} {label}", got, want, err_fn, tol,
                 faults)
            note_err(report, name, M,
                     float((got.float() - want.float()).abs().max()))
            if name == "fused_agg_corr_dense":
                got2 = _dense_call(name, q, k, table, clip_t, v)
                sync(dev)
                assert torch.equal(got, got2), \
                    f"{name} {label}: two launches differ"
                del got2
            del got, want, faults
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# Phase 2, sequence parallelism: B9 on row shards of the serving grid (55
# rows over 1, 2 and 4 shards: 55, 28/27, 14/14/14/13), and B1, B2 and B4
# on a shard with its row offset.  The B9 inputs give every score a shift
# of +SP_SHIFT on the first shard's grid rows at the most shards ([0, 14)
# at the serving grid) and -SP_SHIFT on the rest (q and k share a
# direction, scaled so that scale * q.k moves by SP_SHIFT), over scores of
# std about 0.6: every shard but the first sees only negative scores, whose
# local max stays below SP_CLIP_ON while the global max is above it, so the
# clamp (at +-SP_CLIP_ON) moves most of their elements in all four modes.
# A shard that took its own max for the clamp predicate (the planted "local
# gmax" fault) would leave them unclamped.
SP_WORLDS = (1, 2, 4)
SP_SHIFT, SP_CLIP_ON, SP_CLIP_OFF, SP_STD = 4.0, 3.0, 100.0, 0.5
# Sums: fp64 sums of fp32 volumes that differ by fp32 rounding (~1e-6 of a
# value): |d sum| / (N rms) and |d sum of squares| / (sum of squares).
B9_SUMS_TOL = 1e-5
# fp32 volume out against the fp32 plain one: max |d| / (1e-4 + 1e-4 |want|)
B9_FP32_ATOL = B9_FP32_RTOL = 1e-4


def sp_inputs(gen, md, dev, dtype, pos_rows, grid=(H8, W8), batch=1,
              modes=4):
    """q, k [batch, modes, U, md] for the B9 checks, the positive shift on
    grid rows [0, pos_rows) (see SP_SHIFT)."""
    u = grid[0] * grid[1]
    w = torch.randn(md, generator=gen)
    w = w / w.norm() * math.sqrt(SP_SHIFT) * md ** 0.25
    sign = torch.full((u, 1), -1.0)
    sign[:pos_rows * grid[1]] = 1.0
    q = torch.randn(batch, modes, u, md, generator=gen) * SP_STD + sign * w
    k = torch.randn(batch, modes, u, md, generator=gen) * SP_STD + w
    return q.to(dev, dtype), k.to(dev, dtype)


def sums_err(n: float):
    """The error of B9 sums [B, 2] over n elements: the worst of |d sum| /
    sqrt(n sum of squares) (= n rms) and |d sum of squares| / sum of
    squares."""
    def err(got, want):
        got, want = got.double(), want.double()
        return float(max(((got[:, 0] - want[:, 0]).abs()
                          / (n * want[:, 1]).sqrt()).max(),
                         ((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max()))
    return err


def vol_err(dtype):
    """(err_fn, bound) of a normed volume in `dtype` against the fp32 plain
    one: B3's for bf16."""
    if dtype == torch.bfloat16:
        return b3_err, 1.0

    def err(got, want):
        d = (got.float() - want.float()).abs()
        return float((d / (B9_FP32_ATOL + B9_FP32_RTOL
                           * want.float().abs())).max())
    return err, 1.0


def check_sp_kernels(dev, gen, report, grid=(H8, W8), worlds=SP_WORLDS,
                     wide=(4, 64), intra=(4, 32)) -> None:
    """Phase 2, sequence parallelism: B9 sums and write on every shard
    against their plain versions (the plain write taking the kernels'
    summed sums), the written shards assembled against plain B3, with the
    row offset dropped, the moments over the shard's own element count,
    the shard's own max as the clamp predicate and (where the clamp is
    off: at SP_CLIP_ON most scores sit at +-clip in every mode, which a
    dropped mode group barely moves) mode_faults planted in the plain
    versions; then B1, B2 and B4 on a shard with its row offset,
    the offset dropped planted.  wide is the (modes, mode dim) of B9, B1
    and B2, intra B4's (None: not checked).  On CPU tensors the wrappers
    take the plain versions themselves (how the tests run this phase with
    faults planted in the wrappers)."""
    from craft_tpu_torch.parallel.sp import row_split
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    H, Wd = grid
    M, md = wide
    scale = 1.0 / math.sqrt(md)
    agg = (torch.tensor(AGG_WB[0], device=dev),
           torch.tensor(AGG_WB[1], device=dev))
    errs = {"corr_norm_sums": [0.0], "corr_norm_write": [0.0]}
    pos_rows = row_split(H, max(worlds), 0)[1]
    for dtype in (torch.bfloat16, torch.float32):
        q, k = sp_inputs(gen, md, dev, dtype, pos_rows, grid, modes=M)
        n_all = float(k.shape[2]) ** 2
        err_fn, tol = vol_err(dtype)
        for attn_clip in (SP_CLIP_OFF, SP_CLIP_ON):
            b3, _ = ma.fused_agg_corr_norm_plain(q, k, biases, grid,
                                                 attn_clip, 0.5, *agg,
                                                 out_dtype=torch.float32)
            for world in worlds:
                shards = [row_split(H, world, r) for r in range(world)]
                ql = [q[:, :, h0 * Wd:h1 * Wd] for h0, h1 in shards]
                lmax = [ma.scores_global_max(x, k, scale) for x in ql]
                gmax = torch.stack(lmax).amax()
                sync(dev)
                tag = f"B9 M={M} md={md} {dtype} attn_clip={attn_clip:g} " \
                    f"n={world}"
                clamps = float(gmax) > attn_clip
                sums = []
                for x, lm, (h0, h1) in zip(ql, lmax, shards):
                    got = ma.corr_norm_sums(x, k, biases, grid, gmax,
                                            attn_clip, 0.5, *agg, q_row0=h0)
                    sync(dev)

                    def plain(a, b, gm, r0=h0):
                        return ma.corr_norm_sums_plain(
                            a, b, biases, grid, gm, attn_clip, 0.5, *agg,
                            q_row0=r0)
                    faults = {}
                    if h0 > 0 and M == 4:
                        # A full window's bias sums the same at any row, so
                        # the offset moves the sums by the edge rows alone:
                        # at 16 modes 4.2e-6 against 1e-5; the write below
                        # holds it at every count.
                        faults["row offset dropped"] = lambda: plain(
                            x, k, gmax, r0=0)
                    if clamps and float(lm) <= attn_clip:
                        faults["local gmax"] = lambda: plain(x, k, lm)
                    if not clamps:
                        faults.update(mode_faults(M, md, lambda a, b: plain(
                            a, b, gmax), x, k, agg=True, normed=True))
                    want = plain(x, k, gmax)
                    hold(f"{tag} sums rows {h0}:{h1}", got, want,
                         sums_err(float(x.shape[2] * k.shape[2])),
                         B9_SUMS_TOL, faults)
                    errs["corr_norm_sums"].append(
                        float((got - want).abs().max()))
                    sums.append(got)
                total = torch.stack(sums).sum(0)
                parts = []
                for x, lm, (h0, h1) in zip(ql, lmax, shards):
                    got = ma.corr_norm_write(x, k, biases, grid, gmax, total,
                                             attn_clip, 0.5, *agg, q_row0=h0,
                                             out_dtype=dtype)
                    sync(dev)

                    def plain(a, b, gm, n, r0=h0):
                        return ma.corr_norm_write_plain(
                            a, b, biases, grid, gm, total, n, attn_clip, 0.5,
                            *agg, q_row0=r0, out_dtype=torch.float32)
                    faults = {}
                    if h0 > 0:
                        faults["row offset dropped"] = lambda: plain(
                            x, k, gmax, n_all, r0=0)
                    if world > 1:
                        faults["moments over the local count"] = \
                            lambda: plain(x, k, gmax,
                                          float(x.shape[2] * k.shape[2]))
                    if clamps and float(lm) <= attn_clip:
                        faults["local gmax"] = lambda: plain(x, k, lm, n_all)
                    if not clamps:
                        faults.update(mode_faults(M, md, lambda a, b: plain(
                            a, b, gmax, n_all), x, k, agg=True,
                            normed=True))
                    want = plain(x, k, gmax, n_all)
                    hold(f"{tag} write rows {h0}:{h1}", got, want, err_fn,
                         tol, faults)
                    errs["corr_norm_write"].append(
                        float((got.float() - want).abs().max()))
                    parts.append(got)
                    del faults, want
                got = torch.cat(parts, dim=1)
                err = err_fn(got, b3)
                print(f"{tag}: shards assembled against plain B3, error "
                      f"{err:.3e} (bound {tol:g})")
                assert err <= tol, f"{tag}: the shards disagree with B3"
                del got, parts
            del b3
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    for name, e in errs.items():
        note_err(report, name, M, max(e))

    # B1, B2 (wide), B4 (intra) on shard 2 of 4 (rows 28..41 of the
    # serving grid).
    h0, h1 = row_split(H, 4, 2) if H >= 4 else (H - 1, H)
    q, k = inputs(gen, md, dev, H * Wd, modes=M)
    ql = q[:, :, h0 * Wd:h1 * Wd]
    got = float(ma.scores_global_max(ql, k, scale))
    sync(dev)
    want = float(ma.scores_global_max_plain(ql, k, scale))
    print(f"B1 M={M} md={md} rows {h0}:{h1}: kernel {got:.6f} plain "
          f"{want:.6f}")
    assert abs(got - want) <= B1_RTOL * abs(want), "B1 disagrees on a shard"
    v = torch.randn(1, M, H * Wd, 256, generator=gen).to(dev, torch.bfloat16)
    clip_t = torch.tensor(CLIP_ON, device=dev)
    got = ma.flash_mode_attention(ql, k, v, biases, grid, clip_t, 0.5,
                                  q_row0=h0)
    sync(dev)
    plain = functools.partial(ma.flash_mode_attention_plain, ql, k, v,
                              biases, grid, clip_t, 0.5)
    hold(f"B2 M={M} md={md} rows {h0}:{h1}", got, plain(q_row0=h0), rel_err,
         B2_TOL, {"row offset dropped": plain()})
    del v, got
    if intra is None:
        return
    M, md = intra
    q, k = inputs(gen, md, dev, H * Wd, modes=M)
    ql = q[:, :, h0 * Wd:h1 * Wd]
    plain = functools.partial(ma.mode_softmax_probs_plain, ql, k, biases,
                              grid, clip_t, 1.0)
    num, sc = ma.mode_softmax_probs(ql, k, biases, grid, clip_t, 1.0,
                                    quantized=True, q_row0=h0)
    sync(dev)
    wnum, wsc = plain(quantized=True, q_row0=h0)
    fnum, fsc = plain(quantized=True)
    tag = f"M={M} md={md} rows {h0}:{h1}"
    hold(f"B4 int8 numerators {tag}", num, wnum, num_err,
         B4_NUM_TOL, {"row offset dropped": fnum})
    hold(f"B4 int8 row scales {tag}", sc, wsc, lambda a, b: float(
        ((a - b).abs() / b).max()), B4_SCALE_RTOL, {"row offset dropped": fsc})
    got = ma.mode_softmax_probs(ql, k, biases, grid, clip_t, 1.0,
                                out_dtype=torch.bfloat16, q_row0=h0)
    sync(dev)
    hold(f"B4 bf16 {tag}", got,
         plain(out_dtype=torch.float32, q_row0=h0), row_rel_err,
         B4_ROW_TOL[torch.bfloat16],
         {"row offset dropped": plain(out_dtype=torch.float32)})


# Phase 2, sequence parallelism under the dense tables and for the other
# families: B8, B6 dense and B4 dense on every row shard of the serving
# grid at 2 and 4 ranks (28/27 and 14/14/14/13 rows) and of the KITTI grid
# at 2 (24/23 rows: 3744 and 3588 query tokens, off the 64- and 128-row
# tiles), each with no table (lsinu) and with the shard's rows of a table
# (B8: the --f2radius mask and window's rows, ``f2_table_rows``; B6 dense
# and B4 dense: a seeded one), the clamp from ``parallel/
# sequence_parallel.py:sp_clip``, each rank a thread of a LocalGroup: the
# port's RowShard with its all-reduce met in one process.  The inputs are
# sp_inputs's: every shard but the first sees only scores whose local max
# is below SP_CLIP_ON while the global max is above it.  Planted in the
# plain versions: the table's rows taken from grid row 0 instead of the
# shard's first row, and the clamp predicate from the shard's own max (no
# all_max); B6 dense's shards are then normed by ``build_pyramid(...,
# shard=)`` (RowShard.layer_norm_moments) against the plain whole volume's
# norm, the moments of the shard's own rows (no all_sum) planted.  Then B9
# in both directions of the two-way volume at 2 ranks through
# ``sp_fused_agg_corr_norm_mt``, each direction's moments its own (the
# first direction's planted in the second), and GMA's attention on rank 1
# of 2 against the unsharded attention's rows, at a max_pos_size below the
# grid's sides, its relative positions from grid row 0 (x0 = 0) planted.
SP_DENSE_CASES = (((H8, W8), 2), ((H8, W8), 4), (KITTI_GRID, 2))
SP_GMA_MAX_POS = 40  # RelPosEmb rows 2 * 40 - 1, below 55 and 128
# The shards' normed B6 dense volume (fp32, std 1) against the plain one:
# max |d| / (1e-4 + 1e-4 |want|), the fp32 raw volume's B6_TOL carried
# through the norm.
SP_NORM_TOL = 1.0
SP_GMA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # row_rel_err


class LocalGroup:
    """`world` stand-in ranks of a RowShard group in one process: ``run``
    calls a function on each rank's LocalShard, each in a thread of its
    own, and their collectives meet at a barrier, where every rank's tensor
    is reduced in rank order."""

    def __init__(self, world: int):
        self.world = world
        self._slots = [None] * world
        self._barrier = threading.Barrier(world)

    def reduce(self, rank: int, x, op):
        self._slots[rank] = x
        self._barrier.wait()
        stacked = torch.stack(self._slots)
        out = stacked.amax(0) if op == dist.ReduceOp.MAX else stacked.sum(0)
        self._barrier.wait()
        return out

    def run(self, fn, grid) -> list:
        """[fn(shard) for each rank's LocalShard of `grid`], the ranks run
        together; a rank's exception breaks the barrier for the others and
        is raised here."""
        out, errors = [None] * self.world, []
        self._barrier = threading.Barrier(self.world)

        def rank_body(r):
            try:
                out[r] = fn(LocalShard(self, grid, r))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)
                self._barrier.abort()
        threads = [threading.Thread(target=rank_body, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        if errors:
            raise errors[0]
        return out


class LocalShard(RowShard):
    """Rank `rank`'s RowShard of `grid` in a LocalGroup: the port's own
    RowShard (its split, its collectives, its layer-norm moments), with the
    transport's all-reduce met in the group."""

    def __init__(self, group: LocalGroup, grid, rank: int):
        super().__init__(SimpleNamespace(world=group.world, rank=rank), *grid)
        self.local, self.rank = group, rank

    def _all_reduce(self, x, op):
        return x.copy_(self.local.reduce(self.rank, x, op))


def _sp_clip(gmax, attn_clip: float):
    return torch.where(gmax > attn_clip, torch.full_like(gmax, attn_clip),
                       torch.full_like(gmax, 1e30))


def _sp_dense(name, q, k, table, clip, pos_w, v, plain=False):
    """Kernel `name` (its plain version if `plain`) on the rows q."""
    if name == "flash_mode_attention_dense":
        fn = ma.flash_mode_attention_dense_plain if plain \
            else ma.flash_mode_attention_dense
        return fn(q, k, v, table, clip, pos_w)
    if name == "fused_agg_corr_dense":
        fn = cv.fused_agg_corr_dense_plain if plain \
            else cv.fused_agg_corr_dense
        return fn(q, k, table, clip, pos_w, *AGG_WB)
    fn = ma.mode_softmax_probs_dense_plain if plain \
        else ma.mode_softmax_probs_dense
    return fn(q, k, table, clip, pos_w,
              out_dtype=torch.float32 if plain else q.dtype)


def f2_table_rows(biases, grid, dev, h0: int, rows: int):
    """The f2 site's --f2radius table on grid rows h0 .. h0 + rows - 1 as
    the port's dense site builds it (``nn/setrans.py:_dense_forward``):
    the row-range mask + DENSE_POS_W * the window's rows."""
    return setrans.attention_mask(*grid, F2RADIUS, dev, h0, rows) + \
        DENSE_POS_W * ma.sliding_pos_biases(biases, *grid, h0, rows)


def _sp_tables(name, grid, seeded, biases, dev):
    """(the whole table of kernel `name`, its pos_w, the shard's rows of the
    table as the port builds them: shard -> [U_local, U]): for B8 the f2
    site's --f2radius mask and window (the whole table as the unsharded
    site sums them, the shard's by f2_table_rows), for B6 dense and B4
    dense the seeded table."""
    if name != "flash_mode_attention_dense":
        return seeded, DENSE_POS_W, lambda sh: seeded[sh.u0:sh.u1]
    whole = setrans.attention_mask(*grid, F2RADIUS, dev) + DENSE_POS_W * \
        ma.sliding_pos_biases(biases, *grid)
    return whole, 1.0, lambda sh: f2_table_rows(biases, grid, dev, sh.h0,
                                                sh.rows)


def check_sp_dense_kernels(dev, gen, report, cases=SP_DENSE_CASES,
                           wide=(4, 64), intra=(4, 32)) -> None:
    """Phase 2: B8, B6 dense and B4 dense on row shards (SP_DENSE_CASES'
    grids and rank counts; bf16, and fp32 at the first case), each rank's
    clamp from ``sp_clip``, then B6 dense's shards normed by
    ``build_pyramid``, with the planted faults above.  On CPU tensors the
    kernels' wrappers take the plain versions themselves."""
    from craft_tpu_torch.ops.corr import global_layer_norm
    from craft_tpu_torch.parallel import sequence_parallel as spw
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    sites = (("flash_mode_attention_dense", wide),
             ("fused_agg_corr_dense", wide),
             ("mode_softmax_probs_dense", intra))
    tols = {"flash_mode_attention_dense": lambda dt: (rel_err, b2_tol(dt)),
            "fused_agg_corr_dense": lambda dt: (rel_err, B6_TOL),
            "mode_softmax_probs_dense": lambda dt: (row_rel_err,
                                                    B4_ROW_TOL[dt])}
    for i, (grid, world) in enumerate(cases):
        H, Wd = grid
        u = H * Wd
        shards = [row_split(H, world, r) for r in range(world)]
        seeded = (torch.randn(u, u, generator=gen) * BIAS_STD).to(dev)
        dtypes = (torch.bfloat16, torch.float32) if i == 0 \
            else (torch.bfloat16,)
        for dtype, (name, (M, md)), with_table in (
                (dt, s, t) for dt in dtypes for s in sites
                for t in (False, True)):
            q, k = sp_inputs(gen, md, dev, dtype, shards[0][1], grid,
                             modes=M)
            v = torch.randn(1, M, u, 256, generator=gen).to(dev, dtype)
            ql = [q[:, :, h0 * Wd:h1 * Wd] for h0, h1 in shards]
            lmax = [ma.scores_global_max_plain(x, k, md ** -0.5) for x in ql]
            gmax = torch.stack(lmax).amax()
            clip = _sp_clip(gmax, SP_CLIP_ON)
            err_fn, tol = tols[name](dtype)
            tag = f"{name} M={M} md={md} {dtype} grid {H}x{Wd} n={world} " \
                f"{'table' if with_table else 'no table'}"
            whole, pos_w, rows_of = _sp_tables(name, grid, seeded, biases,
                                               dev)

            def rank_call(shard):
                x = q[:, :, shard.u0:shard.u1]
                return _sp_dense(name, x, k,
                                 rows_of(shard) if with_table else None,
                                 spw.sp_clip(shard, x, k, SP_CLIP_ON), pos_w,
                                 v)
            gots = LocalGroup(world).run(rank_call, grid)
            sync(dev)
            raws = []
            for got, x, lm, (h0, h1) in zip(gots, ql, lmax, shards):
                n = x.shape[2]
                want_table = whole[h0 * Wd:h1 * Wd] if with_table else None

                def plain(tab=want_table, c=clip, x=x):
                    return _sp_dense(name, x, k, tab, c, pos_w, v, plain=True)
                faults = {}
                if with_table and h0 > 0:
                    faults["table rows from grid row 0"] = \
                        lambda n=n: plain(tab=whole[:n])
                if float(lm) <= SP_CLIP_ON < float(gmax):
                    faults["local clamp predicate"] = \
                        lambda lm=lm: plain(c=_sp_clip(lm, SP_CLIP_ON))
                want = plain()
                hold(f"{tag} rows {h0}:{h1}", got, want, err_fn, tol, faults)
                note_err(report, name, M,
                         float((got.float() - want.float()).abs().max()))
                if name == "fused_agg_corr_dense":
                    raws.append(want)
                del want, faults, want_table
            if raws:
                _check_sp_norm(tag, grid, world, gots, raws,
                               global_layer_norm)
            del q, k, v, ql, gots, raws, whole
        del seeded
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _check_sp_norm(tag, grid, world, gots, wants, global_layer_norm) -> None:
    """Each rank's raw B6 dense volume (`gots`) normed by the port's
    ``build_pyramid(..., shard=)`` (level 0: the moments of every rank's
    rows through RowShard.layer_norm_moments) against those rows of the
    plain whole volume's norm (`wants` the plain shards), the moments of
    the shard's own rows planted."""
    from craft_tpu_torch.ops.corr import build_pyramid
    H, Wd = grid
    B = wants[0].shape[0]
    levels = LocalGroup(world).run(lambda sh: build_pyramid(
        gots[sh.rank][:, :, None], B, H, Wd, 1, do_global_norm=True,
        shard=sh).levels[0], grid)
    whole = torch.cat(wants, dim=1)
    want = global_layer_norm(whole.reshape(B, 1, -1)).reshape(whole.shape)
    err_fn, _ = vol_err(torch.float32)
    n0 = 0
    for got, w in zip(levels, wants):
        n = w.shape[1]
        local = global_layer_norm(w.reshape(B, 1, -1)).reshape(w.shape)
        hold(f"{tag} normed rows of {n} tokens", got.reshape(w.shape),
             want[:, n0:n0 + n], err_fn, SP_NORM_TOL,
             {"moments of the shard's own rows": local})
        n0 += n


def check_sp_two_way_b9(dev, gen, report, grid=(H8, W8), world=2,
                        md=64) -> None:
    """Phase 2: B9 in both directions of the two-way volume on the shards
    of `grid` over `world` ranks, clamp on, each direction through the
    port's ``sp_fused_agg_corr_norm_mt`` (B1, all_max, B9 sums, all_sum,
    B9 write) on every rank, assembled against plain B3 of that
    direction; the second direction written with the first direction's
    sums planted (its scores shifted up on every row, the first
    direction's on the first shard's rows alone, so that their moments
    differ)."""
    from craft_tpu_torch.parallel import sequence_parallel as spw
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    agg = (torch.tensor(AGG_WB[0], device=dev),
           torch.tensor(AGG_WB[1], device=dev))
    H, Wd = grid
    shards = [row_split(H, world, r) for r in range(world)]
    n_all = float(H * Wd) ** 2
    err_fn, tol = vol_err(torch.bfloat16)
    first_sums = None
    for d, pos_rows in enumerate((shards[0][1], H)):
        q, k = sp_inputs(gen, md, dev, torch.bfloat16, pos_rows, grid)
        got = torch.cat(LocalGroup(world).run(
            lambda sh: spw.sp_fused_agg_corr_norm_mt(
                sh, q[:, :, sh.u0:sh.u1], k, biases, SP_CLIP_ON, 0.5, *agg,
                out_dtype=torch.bfloat16), grid), 1)
        sync(dev)
        ql = [q[:, :, h0 * Wd:h1 * Wd] for h0, h1 in shards]
        gmax = torch.stack([ma.scores_global_max_plain(x, k, md ** -0.5)
                            for x in ql]).amax()
        args = (biases, grid, gmax)
        sums = torch.stack([ma.corr_norm_sums_plain(
            x, k, *args, SP_CLIP_ON, 0.5, *agg, q_row0=h0)
            for x, (h0, _) in zip(ql, shards)]).sum(0)
        first_sums = sums if d == 0 else first_sums
        want, _ = ma.fused_agg_corr_norm_plain(q, k, biases, grid,
                                               SP_CLIP_ON, 0.5, *agg,
                                               out_dtype=torch.float32)
        faults = {}
        if d == 1:
            faults["the first direction's moments"] = lambda: torch.cat([
                ma.corr_norm_write_plain(
                    x, k, *args, first_sums, n_all, SP_CLIP_ON, 0.5, *agg,
                    q_row0=h0, out_dtype=torch.float32)
                for x, (h0, _) in zip(ql, shards)], 1)
        hold(f"B9 two-way direction {d + 1} n={world}: shards against B3",
             got, want, err_fn, tol, faults)
        note_err(report, "corr_norm_write", 4,
                 float((got.float() - want).abs().max()))
        del q, k, ql, got, want, faults
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def gma_x0_fault(att, fmap, shard):
    """Attention on `shard` with its relative positions read from grid row
    0 instead of the shard's first row: the planted fault of a rank that
    passes a local row offset."""
    probs = att._probs
    att._probs = lambda q, kt, h, w, x0: probs(q, kt, h, w, x0 - shard.h0)
    try:
        return att(fmap, shard=shard)
    finally:
        del att._probs


def check_sp_gma(dev, gen, grid=(H8, W8), max_pos=SP_GMA_MAX_POS, world=2,
                 rank=1) -> None:
    """Phase 2: GMA's attention (position and content, max_pos_size below
    both sides of `grid`) on rank `rank` of `world` against the unsharded
    attention's rows, fp32 and bf16, x0 = 0 planted (gma_x0_fault)."""
    from craft_tpu_torch.nn.gma import Attention
    shard = LocalShard(LocalGroup(world), grid, rank)
    h0, h1 = shard.h0, shard.h1
    fmap = torch.randn(1, *grid, 128, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        att = Attention(dim=128, max_pos_size=max_pos, dim_head=128,
                        position_and_content=True, dtype=dtype)
        with torch.no_grad():
            for p in att.parameters():
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (1.0 if p.dim() == 2 else 128 ** -0.5))
        att = att.to(dev).eval()
        x = fmap.to(dev)
        with torch.inference_mode():
            want = att(x)[:, :, h0 * grid[1]:h1 * grid[1]]
            got = att(x, shard=shard)
            sync(dev)
            hold(f"GMA attention {dtype} grid {grid[0]}x{grid[1]} max_pos "
                 f"{max_pos} rows {h0}:{h1}", got, want, row_rel_err,
                 SP_GMA_TOL[dtype],
                 {"x0 = 0 on rank 1": lambda: gma_x0_fault(att, x, shard)})
        del att, want, got


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


def lsinu_config(mixed_precision: bool = True):
    """craft_config with learned sinusoid codes at all three sites
    (--interpos lsinu --intrapos lsinu)."""
    cfg = craft_config(mixed_precision=mixed_precision)
    return cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), pos_code_type="lsinu")
        for site in ("inter", "f2", "intra")})


def f2radius_config(radius: int, mixed_precision: bool = True):
    """craft_config with the masked f2 attention (--f2radius radius)."""
    cfg = craft_config(mixed_precision=mixed_precision)
    return cfg.replace(f2=dataclasses.replace(cfg.f2,
                                              attn_mask_radius=radius))


POS_FC_STD = 2.0  # seeded pos_fc weights: O(1) phases across the grid


def lsinu_state_dict(sd: dict, seed: int = 7) -> dict:
    """The oracle's state_dict with each site's sliding window replaced by
    seeded pos_fc weights ~ N(0, POS_FC_STD^2) (pos_fc takes the (y, x)
    coordinates in [0, 1]), for the lsinu config."""
    gen = torch.Generator().manual_seed(seed)
    want = FlowModel(lsinu_config(False)).state_dict()
    out = {k: v for k, v in sd.items() if k in want}
    for key in sorted(set(want) - set(out)):
        out[key] = torch.randn(want[key].shape, generator=gen) * POS_FC_STD
    return out


def check_oracle_lsinu(dev) -> dict:
    """Phase 3, lsinu: the oracle tree with seeded pos_fc weights in place of
    the windows, at 128x128 and 12 iterations, on the card against the same
    model on the CPU (plain versions): fp32 within 1e-3 px, mixed within
    0.15 px."""
    img1, img2, _, tree = load_oracle_npz(ORACLE)
    sd = lsinu_state_dict(state_dict_from_flax(tree))
    errs = {}
    for label, mp, bound in (("fp32", False, FULLPREC_BOUND_PX),
                             ("mixed", True, BF16_BOUND_PX)):
        flows = []
        for d in (dev, torch.device("cpu")):
            model = create_model(lsinu_config(mp), device=d)
            model.load_state_dict(sd, strict=True)
            with torch.inference_mode():
                _, f = model(torch.from_numpy(img1).to(d),
                             torch.from_numpy(img2).to(d), iters=ITERS)
            flows.append(f[-1].float().cpu().numpy())
        got, want = flows
        err = float(np.abs(got - want).max())
        print(f"oracle lsinu {label}: card against the CPU, max |flow diff| "
              f"{err:.3e} px (max |flow| {float(np.abs(want).max()):.3f}, "
              f"bound {bound})")
        assert np.isfinite(got).all() and err < bound, f"oracle lsinu {label}"
        errs[label] = err
    return errs


def variant_weights(variant: str, mixed_precision: bool):
    """(config, state_dict) under `variant`: 'main' (craft_config),
    'lsinu' (every site, the oracle's windows replaced by seeded pos_fc
    weights), 'f2radius' (--f2radius F2RADIUS), 'f1_shared' or 'f1_private'
    (two-way correlation, ``two_way_state_dict``), with the oracle's
    full-width weights."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    sd = state_dict_from_flax(tree)
    if variant == "lsinu":
        return lsinu_config(mixed_precision), lsinu_state_dict(sd)
    if variant == "f2radius":
        return f2radius_config(F2RADIUS, mixed_precision), sd
    if variant in TWO_WAY:
        cfg = craft_config(mixed_precision=mixed_precision,
                           f1trans=TWO_WAY[variant])
        return cfg, two_way_state_dict(sd, cfg)
    return craft_config(mixed_precision=mixed_precision), sd


# Two-way correlation (--f1): the variants and their f1trans.
TWO_WAY = {"f1_shared": "shared", "f1_private": "private"}
F1_NOISE = 0.02       # the private f1 site: the oracle's f2 site + noise
F1_WINDOW_STD = 0.5   # ... its sliding window ~ N(0, F1_WINDOW_STD^2)


def two_way_state_dict(sd: dict, cfg, seed: int = 11) -> dict:
    """The oracle's state_dict completed for the two-way config `cfg`: under
    'private' the f1 site is the oracle's f2 site moved by seeded noise (its
    window replaced by a seeded one), so that the two transformers differ;
    the motion encoder's first conv, which reads 648 channels here against
    the oracle's 324, takes the oracle's kernel for the first direction and
    a seeded permutation of it, halved, for the second.  Under 'shared'
    f1_trans.* are the f2_trans.* tensors."""
    gen = torch.Generator().manual_seed(seed)
    want = FlowModel(cfg).state_dict()
    out = {}
    for key, v in want.items():
        if key in sd and sd[key].shape == v.shape:
            out[key] = sd[key]
        elif key.startswith("f1_trans."):
            src = sd["f2_trans." + key[len("f1_trans."):]]
            if cfg.f1trans == "shared":
                out[key] = src
            elif key.endswith("pos_coder.biases"):
                out[key] = torch.randn(src.shape, generator=gen) \
                    * F1_WINDOW_STD
            elif src.is_floating_point():
                out[key] = src + torch.randn(src.shape, generator=gen) \
                    * F1_NOISE
            else:
                out[key] = src
        else:  # update_block.encoder.convc1.weight [256, 648, 1, 1]
            half = sd[key]
            perm = torch.randperm(half.shape[1], generator=gen)
            out[key] = torch.cat([half, half[:, perm] * 0.5], dim=1)
            assert out[key].shape == v.shape, key
    return out


def serving_model(dev, variant: str = "main"):
    """The serving model in eval mode on `dev`, mixed precision, under
    `variant` (``variant_weights``)."""
    cfg, sd = variant_weights(variant, True)
    model = create_model(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    return model


def frame_pairs(dev, n: int, seed: int = 0, hw=(FRAME_H, FRAME_W)):
    """(InputPadder, n seeded noise frame pairs at hw (FRAME_H x FRAME_W)
    padded to a multiple of 8 (440x1024), NHWC in [0, 255] on `dev`)."""
    padder = InputPadder((1, *hw, 3), mode="sintel")
    rng = np.random.RandomState(seed)

    def frame():
        return torch.from_numpy(rng.uniform(0, 255, (1, *hw, 3)).astype(
            np.float32)).to(dev)
    return padder, [padder.pad(frame(), frame()) for _ in range(n)]


def serve(model, pairs, seq_parallel=None):
    """Answer each pair with ITERS iterations, synchronizing after each:
    (host ms per pair, each pair's final padded flow); with a SeqParallel
    group, as this rank."""
    times, flows = [], []
    with torch.inference_mode():
        for a, b in pairs:
            t0 = time.perf_counter()
            _, f = model(a, b, iters=ITERS, seq_parallel=seq_parallel)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            flows.append(f[-1])
    return times, flows


# The kernels a served pair launches (B1-B4, B5 forward).
SERVE_KERNELS = ("scores_global_max", "flash_mode_attention",
                 "fused_agg_corr_norm", "mode_softmax_probs", "corr_lookup")


def main_path(dev, n_pairs: int = 3) -> dict:
    """Phase 4: full-size serving of seeded frame pairs, after one warm-up
    pair."""
    model = serving_model(dev)
    padder, pairs = frame_pairs(dev, n_pairs + 1)
    serve(model, pairs[:1])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    times, flows = serve(model, pairs[1:])
    counts = launch.launch_counts()
    for flow in flows:
        out = padder.unpad(flow)
        assert out.shape == (1, FRAME_H, FRAME_W, 2)
        assert bool(torch.isfinite(out).all())
    res = {"pair_ms": times, "pairs_per_s": n_pairs / (sum(times) / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts}
    print("main path:", json.dumps(res))
    for name in SERVE_KERNELS:
        assert counts[name] > 0, f"{name} was not launched on the main path"
    assert counts["corr_lookup"] == ITERS * n_pairs, "B5: 12 per pair"
    for name in set(counts) - set(SERVE_KERNELS):
        assert counts[name] == 0, f"{name} was launched on the main path"
    return res


# The kernels a pair served under lsinu launches, and how many per pair
# (B1 once per site, B5 once per iteration).
LSINU_KERNELS = {"scores_global_max": 3, "flash_mode_attention_dense": 1,
                 "fused_agg_corr_dense": 1, "mode_softmax_probs_dense": 1,
                 "corr_lookup": ITERS}
F2RADIUS = 7
# A pair of the main config under --f2radius: B8 with its table in place of
# B2, the rest as the main path.
F2RADIUS_KERNELS = {"scores_global_max": 3, "flash_mode_attention_dense": 1,
                    "fused_agg_corr_norm": 1, "mode_softmax_probs": 1,
                    "corr_lookup": ITERS}


def _assert_launches(label, counts, per_pair, n_pairs) -> None:
    """Each kernel of `per_pair` launched that many times a pair, every
    other kernel never."""
    for name, n in counts.items():
        want = per_pair.get(name, 0) * n_pairs
        assert n == want, f"{label}: {name} launched {n} times, not {want}"


def dense_paths(dev, n_pairs: int = 3) -> dict:
    """Phase 4, the dense-table paths: the lsinu config (all three sites)
    served like the main path (one warm-up pair, then n_pairs seeded pairs
    with the launch counts zeroed just before), then one pair of the main
    config under --f2radius F2RADIUS (its own counts)."""
    model = serving_model(dev, "lsinu")
    padder, pairs = frame_pairs(dev, n_pairs + 1, seed=1)
    serve(model, pairs[:1])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    times, flows = serve(model, pairs[1:])
    counts = launch.launch_counts()
    for flow in flows:
        out = padder.unpad(flow)
        assert out.shape == (1, FRAME_H, FRAME_W, 2)
        assert bool(torch.isfinite(out).all())
    res = {"lsinu": {"pair_ms": times,
                     "pairs_per_s": n_pairs / (sum(times) / 1e3),
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "launches": counts}}
    print("lsinu path:", json.dumps(res["lsinu"]))
    _assert_launches("lsinu path", counts, LSINU_KERNELS, n_pairs)
    del model, flows
    torch.cuda.empty_cache()

    model = serving_model(dev, "f2radius")
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    times, flows = serve(model, pairs[1:2])
    counts = launch.launch_counts()
    assert bool(torch.isfinite(flows[0]).all())
    res["f2radius"] = {"pair_ms": times,
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated(),
                       "launches": counts}
    print(f"f2radius {F2RADIUS} pair:", json.dumps(res["f2radius"]))
    _assert_launches("f2radius pair", counts, F2RADIUS_KERNELS, 1)
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
# Which sites of a training step take the training kernels (B1 + B4 float
# with B7 as its backward at the f2 and intra sites, B1 + B6 with its
# backward at the inter site); the others run the plain path (lsinu, the
# --f2radius f2 site, every site on the --attn_diag step).
KERNEL_SITES = {"main": ("f2", "intra", "inter"), "lsinu": (),
                "f2radius": ("intra", "inter"), "diag": ()}


def step_launches(variant: str, remat: bool = True, iters: int = ITERS
                  ) -> dict:
    """The hand kernels one training step of `variant` launches, and how
    many times: B5 and its backward once an iteration; at each kernel
    site B1 and its forward kernel once in the forward and once more in
    the backward's recompute (the inter site always, the f2 and intra
    sites under remat_att_sites), and its backward kernel once."""
    out = {"corr_lookup": iters, "corr_lookup_bwd": iters}
    for site in KERNEL_SITES[variant]:
        fwd, bwd = (("fused_agg_corr", "agg_corr_bwd") if site == "inter"
                    else ("mode_softmax_probs", "probs_bwd"))
        n = 2 if remat or site == "inter" else 1
        for name in ("scores_global_max", fwd):
            out[name] = out.get(name, 0) + n
        out[bwd] = out.get(bwd, 0) + 1
    return out


def _no_dropout(cfg):
    return cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0) for site in ("inter", "f2",
                                                       "intra")})


def _train_step_grads(dev, cfg, sd, batch, upsample_mode=None):
    """One step (2 iterations) of `cfg` from the state_dict `sd` on `dev`:
    (metrics, {name: gradient}, {name: BatchNorm running stat})."""
    state = create_train_state(cfg, sd, device=dev, num_steps=100)
    step = make_train_step(cfg, iters=2, upsample_mode=upsample_mode)
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    model = state.model
    return (host_metrics(metrics),
            {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()},
            {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if "running_" in n})


def _oracle_train_step(dev, batch, variant="main"):
    """One fp32 training step (dropout off, 2 iterations) from the oracle
    weights under `variant` on `dev`: (metrics, {name: gradient},
    {name: buffer})."""
    cfg, sd = variant_weights(variant, False)
    return _train_step_grads(dev, _no_dropout(cfg), sd, batch)


def oracle_batch() -> dict:
    """The oracle frames with a seeded flow of a few pixels, all valid."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    rng = np.random.RandomState(0)
    return {"image1": torch.from_numpy(img1),
            "image2": torch.from_numpy(img2),
            "flow": torch.from_numpy(
                (rng.randn(*img1.shape[:3], 2) * 3).astype(np.float32)),
            "valid": torch.ones(img1.shape[:3])}


def hold_step(label, card, cpu, loss_rtol=TRAIN_LOSS_RTOL,
              grad_tol=TRAIN_GRAD_TOL, stats_tol=TRAIN_STATS_TOL) -> None:
    """A step's (metrics, gradients, stats) against another's: the loss
    within loss_rtol, each module group's gradient within grad_tol in the
    norm of the group (the groups the model has), the batch stats within
    stats_tol."""
    (got, grads, stats), (want, wgrads, wstats) = card, cpu
    print(f"{label}: got ", json.dumps(got))
    print(f"{label}: want", json.dumps(want))
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    print(f"{label}: loss rel diff {rel:.3e} (bound {loss_rtol:g})")
    assert rel <= loss_rtol, f"{label}: loss"
    assert all(np.isfinite(v) for v in got.values())
    bad = []
    for group in GROUPS:
        names = [n for n in wgrads if n.startswith(group)]
        if not names:
            continue
        num = sum(float(((grads[n] - wgrads[n]) ** 2).sum()) for n in names)
        den = sum(float((wgrads[n] ** 2).sum()) for n in names)
        err = math.sqrt(num / den)
        worst = max(names, key=lambda n: float(
            (grads[n] - wgrads[n]).abs().max()
            / wgrads[n].abs().max().clamp(min=1e-30)))
        print(f"{label}: {group} gradient rel diff {err:.3e} "
              f"(bound {grad_tol:g}); worst tensor {worst}")
        if err > grad_tol:
            bad.append(group)
    assert not bad, f"{label}: gradients of {bad}"
    serr = max(float(((stats[n] - wstats[n]).abs()
                      / (wstats[n].abs() + 1e-3)).max()) for n in wstats)
    print(f"{label}: batch stats rel diff {serr:.3e} (bound {stats_tol:g})")
    assert serr <= stats_tol, f"{label}: batch stats"


def check_oracle_train(dev, variant: str = "main") -> None:
    """Phase 3, training: one fp32 step on the card (kernels; under lsinu
    the plain path) against the same step on the CPU (plain versions),
    with its launches."""
    batch = oracle_batch()
    label = f"oracle train step {variant}"
    launch.reset_launch_counts()
    card = _oracle_train_step(dev, batch, variant)
    counts = launch.launch_counts()
    cpu = _oracle_train_step(torch.device("cpu"), batch, variant)
    print(f"{label} launches:", json.dumps(counts))
    hold_step(label, card, cpu)
    _assert_launches(label, counts, step_launches(variant, iters=2), 1)


REMAT_HW, REMAT_BATCH = (128, 128), 2


def check_remat(dev) -> None:
    """Phase 3, remat: one fp32 step with dropout on (2 iterations, a
    seeded 128x128 batch of 2) on the card with remat_att_sites on and off,
    on the main config (whose recompute relaunches B1, B4 and B6) and under
    lsinu, with cuDNN deterministic (its default backward sums in another
    order from run to run: fnet's weight gradients moved by 2.7e-5 of
    their largest value between the two runs): the loss and every gradient
    bit-identical; a step with dropout off must move the gradients."""
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (REMAT_BATCH, *REMAT_HW)
    batch = {"image1": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
             "image2": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
             "flow": torch.randn(*shape, 2, generator=gen, device=dev) * 3,
             "valid": torch.ones(*shape, device=dev)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for variant in ("main", "lsinu"):
            _remat_runs(dev, variant, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _remat_runs(dev, variant, batch) -> None:
    cfg, sd = variant_weights(variant, False)
    runs = {}
    for remat, drop in ((True, True), (False, True), (True, False)):
        c = cfg.replace(remat_att_sites=remat)
        if not drop:
            c = _no_dropout(c)
        state = create_train_state(c, sd, device=dev, num_steps=100)
        state, m = make_train_step(c, iters=2, seed=5)(state, batch)
        runs[remat, drop] = (host_metrics(m)["loss"], {
            n: p.grad.detach().clone()
            for n, p in state.model.named_parameters()})
        del state
    (l_on, g_on), (l_off, g_off) = runs[True, True], runs[False, True]
    l_still, g_still = runs[True, False]
    differ = [n for n in g_on if not torch.equal(g_on[n], g_off[n])]
    moved = max(float((g_still[n] - g_on[n]).abs().max()
                      / g_on[n].abs().max().clamp(min=1e-30)) for n in g_on)
    print(f"remat {variant}: loss on {l_on!r} off {l_off!r}; gradients "
          f"that differ: {differ}; dropout off moves them by up to "
          f"{moved:.3e} (loss {l_still!r})")
    assert l_on == l_off, f"remat {variant}: loss"
    assert not differ, f"remat {variant}: gradients"
    assert moved > 1e-2, f"remat {variant}: masks"


def train_batch(dev, seed: int = 0) -> dict:
    """A seeded chairs-size batch: noise frames in [0, 255], a smooth-ish
    flow of a few pixels, every pixel valid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (TRAIN_BATCH, CROP_H, CROP_W)
    return {"image1": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
            "image2": torch.rand(*shape, 3, generator=gen, device=dev) * 255,
            "flow": torch.randn(*shape, 2, generator=gen, device=dev) * 4,
            "valid": torch.ones(*shape, device=dev)}


def train_setup(dev, variant: str = "main", remat: bool = True,
                attn_diag: bool = False):
    """(state, step, batch) of the training path: craft_config(
    mixed_precision=True) under `variant` ('main', 'lsinu', 'f2radius';
    ``variant_weights``) with the oracle's full-width weights, dropout at
    the config's rates, remat_att_sites as given, 12 iterations, a
    chairs-size batch; `attn_diag` gives the diagnostics step."""
    cfg, sd = variant_weights(variant, True)
    cfg = cfg.replace(remat_att_sites=remat)
    state = create_train_state(cfg, sd, device=dev, num_steps=1000)
    return (state, make_train_step(cfg, iters=ITERS, attn_diag=attn_diag),
            train_batch(dev))


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
    _assert_launches("training path", counts, step_launches("main"),
                     n_steps)
    res["launches"] = counts
    return res


def _event_steps(state, step, batch, n: int):
    """n steps, each between two CUDA events: (state, each step's device
    ms, each step's host metrics)."""
    ms, metrics = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append(host_metrics(m))
    return state, ms, metrics


DENSE_TRAIN_STEPS = 3


def dense_train_phase(dev) -> dict:
    """Phase 4, the training paths of the plain sites at the chairs crops
    (368x496, batch 8, 12 iterations, dropout at the config's rates), each
    with remat_att_sites on and off: DENSE_TRAIN_STEPS steps of the main
    config (the kernel sites, for comparison), under lsinu (every site
    plain) and under --f2radius F2RADIUS (the f2 site plain) after a
    warm-up step; then the main config's --attn_diag step (every site
    plain) after its warm-up, with its three metrics, followed by one fast
    step whose launches must be the training path's.  Each run's
    device ms a step (CUDA events around the step), its peak memory (from
    after its warm-up) and its launches, which must be ``step_launches``."""
    res = {}
    runs = [(v, r, False) for v in ("main", "lsinu", "f2radius")
            for r in (True, False)] + [("main", r, True) for r in (True,
                                                                  False)]
    for variant, remat, diag in runs:
        label = (f"train {'diag' if diag else variant} remat "
                 f"{'on' if remat else 'off'}")
        state, step, batch = train_setup(dev, variant, remat, diag)
        state, _, _ = _event_steps(state, step, batch, 1)  # warm-up
        n = 1 if diag else DENSE_TRAIN_STEPS
        torch.cuda.reset_peak_memory_stats()
        launch.reset_launch_counts()
        state, ms, metrics = _event_steps(state, step, batch, n)
        counts = launch.launch_counts()
        r = {"step_device_ms": ms,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "loss": [m["loss"] for m in metrics],
             "launches": {k: c for k, c in counts.items() if c}}
        if diag:
            r.update({k: metrics[0][k] for k in ("attn_max",
                                                 "attn_clamp_frac",
                                                 "attn_avg_abs")})
        print(f"{label}:", json.dumps(r))
        assert all(math.isfinite(v) for m in metrics for v in m.values()), \
            f"{label}: non-finite metrics"
        _assert_launches(label, counts,
                         step_launches("diag" if diag else variant, remat), n)
        if diag:
            assert r["attn_max"] > 0, f"{label}: attn_max"
            fast = make_train_step(state.model.cfg, iters=ITERS)
            launch.reset_launch_counts()
            state, fms, _ = _event_steps(state, fast, batch, 1)
            _assert_launches(f"{label}, the fast step after it",
                             launch.launch_counts(),
                             step_launches("main", remat), 1)
            r["fast_step_device_ms"] = fms
        res[label] = r
        del state, step, batch
        torch.cuda.empty_cache()
    return res


# The other model families: RAFT and GMA (the plain volume, B5 alone), CRAFT
# with GMA attention, craft_nogma and CRAFT without the f2 transformer.
def _served(label, model, padder, pairs, per_pair) -> dict:
    """`model` served as the main path (12 iterations): a warm-up pair
    (pairs[0]), then the others with the launch counts zeroed just before:
    each pair's ms between CUDA events, the profiler's device ms of one
    more pair and the busy share (that over the median event ms), peak
    memory and the exact launches of `per_pair` a pair."""
    _final(model, *pairs[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    ms = []
    for a, b in pairs[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        flow = _final(model, a, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        out = padder.unpad(flow)
        assert out.shape == (1, FRAME_H, FRAME_W, 2)
        assert bool(torch.isfinite(out).all()), f"{label} serving"
    counts = launch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dev_ms = device_ms(lambda: _final(model, *pairs[1]), 1)
    r = {"pair_ms": ms, "pair_device_ms": dev_ms,
         "busy_share": dev_ms / float(np.median(ms)),
         "max_memory_allocated": peak,
         "launches": {k: c for k, c in counts.items() if c}}
    print(f"{label} serving:", json.dumps(r))
    _assert_launches(f"{label} serving", counts, per_pair, len(pairs) - 1)
    return r


def _trained(label, state, step, batch, n_steps, variant) -> dict:
    """One warm-up step, then n_steps steps with the launch counts zeroed
    just before: each step's ms between CUDA events, peak memory, loss,
    grad norm and the exact launches of ``step_launches(variant)``."""
    state, _, _ = _event_steps(state, step, batch, 1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    state, ms, metrics = _event_steps(state, step, batch, n_steps)
    counts = launch.launch_counts()
    r = {"step_ms": ms,
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "loss": [m["loss"] for m in metrics],
         "grad_norm": [m["grad_norm"] for m in metrics],
         "launches": {k: c for k, c in counts.items() if c}}
    print(f"{label} training:", json.dumps(r))
    assert all(math.isfinite(v) for m in metrics for v in m.values()), \
        f"{label} training: non-finite metrics"
    _assert_launches(f"{label} training", counts, step_launches(variant),
                     n_steps)
    return r


def _step_card_vs_cpu(dev, label, cfg, sd, variant) -> None:
    """One fp32 step (dropout off, 2 iterations, the oracle frames) of
    `cfg` from `sd` on the card against the CPU (phase 3's bounds), its
    launches those of ``step_launches(variant, iters=2)``."""
    batch = oracle_batch()
    cfg = _no_dropout(cfg)
    launch.reset_launch_counts()
    card = _train_step_grads(dev, cfg, sd, batch)
    counts = launch.launch_counts()
    hold_step(label, card, _train_step_grads(torch.device("cpu"), cfg, sd,
                                             batch))
    _assert_launches(label, counts, step_launches(variant, iters=2), 1)


FAMILIES = {
    "raft": lambda mp: raft_config(mixed_precision=mp),
    "gma": lambda mp: gma_config(mixed_precision=mp),
    "craft_gma": lambda mp: craft_config(mixed_precision=mp,
                                         use_setrans=False),
    "craft_nogma": lambda mp: craft_nogma_config(mixed_precision=mp),
    "craft_f2_none": lambda mp: craft_config(mixed_precision=mp,
                                             f2trans="none"),
}
# The hand kernels a served pair of each family launches: B5 once an
# iteration; B1 once at each SETrans site (the f2 and inter sites of CRAFT
# with GMA attention and of craft_nogma, the intra and inter sites without
# f2); B2 at the f2 site; B3 at the inter site (TransCorr); B4 (int8) at
# the SETrans intra site.  GMA attention, its aggregation and the plain
# volume are stock PyTorch, as the JAX package leaves them to XLA.
_TRANSCORR_F2 = {"scores_global_max": 2, "flash_mode_attention": 1,
                 "fused_agg_corr_norm": 1, "corr_lookup": ITERS}
FAMILY_SERVE = {
    "raft": {"corr_lookup": ITERS},
    "gma": {"corr_lookup": ITERS},
    "craft_gma": _TRANSCORR_F2,
    "craft_nogma": _TRANSCORR_F2,
    "craft_f2_none": {"scores_global_max": 2, "fused_agg_corr_norm": 1,
                      "mode_softmax_probs": 1, "corr_lookup": ITERS},
}
# Training: the kernel sites of each family (``step_launches``).
KERNEL_SITES.update({"raft": (), "gma": (), "craft_gma": ("f2", "inter"),
                     "craft_nogma": ("f2", "inter"),
                     "craft_f2_none": ("intra", "inter")})
FAMILY_TRAIN = ("raft", "gma", "craft_nogma")
FAMILY_GAMMA = 0.5  # Aggregate's gate, seeded off its initial zero
FAMILY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_families"
# The evaluator CLI's flags for a family (``craft_tpu_torch/cli.py``).
FAMILY_FLAGS = {"raft": ["--raft"], "craft_nogma": ["--nogma"],
                "craft_gma": ["--craft"]}


def family_weights(name: str, seed: int = 17) -> dict:
    """The state_dict of `name`: PyTorch's initialisation under `seed`,
    each tensor the oracle tree also has taken from it (its leading part
    where the oracle's is larger: BasicUpdateBlock's GRU reads 384 input
    channels of GMAUpdateBlock's 512), Aggregate's gamma at FAMILY_GAMMA
    (it starts at zero, where the aggregation shows nothing)."""
    oracle = state_dict_from_flax(load_oracle_npz(ORACLE)[3])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = FlowModel(FAMILIES[name](False)).state_dict()
    for key, v in sd.items():
        o = oracle.get(key)
        if o is not None and o.dim() == v.dim() and all(
                a >= b for a, b in zip(o.shape, v.shape)):
            sd[key] = o[tuple(slice(0, n) for n in v.shape)].clone()
    if "update_block.aggregator.gamma" in sd:
        sd["update_block.aggregator.gamma"] = torch.full((1,), FAMILY_GAMMA)
    return sd


def family_model(dev, name, mixed_precision, sd=None):
    model = create_model(FAMILIES[name](mixed_precision), device=dev)
    model.load_state_dict(family_weights(name) if sd is None else sd,
                          strict=True)
    return model


def _final(model, a, b, **kw):
    with torch.inference_mode():
        return model(a, b, iters=ITERS, **kw)[1][-1]


def families_card_vs_cpu(dev) -> dict:
    """Each family at 128x128 (the oracle frames rounded to uint8), 12
    iterations, on the card against the CPU (plain versions): fp32 within
    FULLPREC_BOUND_PX, mixed within BF16_BOUND_PX.  Returns the frames and
    each family's fp32 CPU flow."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    frames = [np.round(x[0]).astype(np.uint8) for x in (img1, img2)]
    pair = [torch.from_numpy(f[None].astype(np.float32)) for f in frames]
    out = {"frames": frames}
    for name in FAMILIES:
        sd = family_weights(name)
        for label, mp, bound in (("fp32", False, FULLPREC_BOUND_PX),
                                 ("mixed", True, BF16_BOUND_PX)):
            want = _final(family_model("cpu", name, mp, sd), *pair).float()
            got = _final(family_model(dev, name, mp, sd),
                         *(t.to(dev) for t in pair)).float().cpu()
            err = float((got - want).abs().max())
            print(f"family {name} {label}: card against the CPU, max |flow "
                  f"diff| {err:.3e} px (max |flow| "
                  f"{float(want.abs().max()):.3f}, bound {bound})")
            assert bool(torch.isfinite(got).all()) and err < bound, \
                f"family {name} {label}"
            if not mp:
                out[name] = want[0].numpy()
    return out


def families_serving(dev, n_pairs: int = 3) -> dict:
    """Each family served as the main path (mixed precision, 440x1024, 12
    iterations, one warm-up pair, then n_pairs seeded pairs with the
    launch counts zeroed just before): each pair's ms between CUDA events,
    the device's kernel ms of one more pair (torch.profiler), the peak
    memory and the exact launches of FAMILY_SERVE.  Then one pair of the
    main config with upsample_mode='packed', whose unpacked final frame
    must be the 'all' pair's, bit for bit."""
    padder, pairs = frame_pairs(dev, n_pairs + 1, seed=3)
    res = {}
    for name in FAMILIES:
        model = family_model(dev, name, True)
        res[name] = _served(f"family {name}", model, padder, pairs,
                            FAMILY_SERVE[name])
        del model
        torch.cuda.empty_cache()
    model = serving_model(dev)
    a, b = pairs[1]
    want = _final(model, a, b)
    packed = _final(model, a, b, upsample_mode="packed")
    assert packed.shape == (1, H8, W8, 128)
    same = torch.equal(unpack_upsampled(packed), want)
    print(f"main config packed pair: unpacked final frame bit-identical to "
          f"the 'all' pair's: {same}")
    assert same, "packed pair"
    return res


def family_train_setup(dev, name: str):
    """(state, step, batch) of family `name`'s training path: mixed
    precision, ``family_weights``, dropout at the config's rates, 12
    iterations, a chairs-size batch."""
    cfg = FAMILIES[name](True)
    state = create_train_state(cfg, family_weights(name), device=dev,
                               num_steps=1000)
    return state, make_train_step(cfg, iters=ITERS), train_batch(dev)


def families_training(dev, n_steps: int = 3) -> dict:
    """RAFT, GMA and craft_nogma at the chairs crops (368x496, batch 8, 12
    iterations, dropout at the config's rates, mixed precision), one
    warm-up step, then n_steps steps: device ms a step (CUDA events), peak
    memory, loss, grad norm and the exact launches of ``step_launches``.
    Then one fp32 step (dropout off, 2 iterations, the oracle frames) of
    every family on the card against the CPU (phase 3's bounds), and one
    packed step of the main config against its 'all' step on the card."""
    res = {}
    for name in FAMILY_TRAIN:
        state, step, batch = family_train_setup(dev, name)
        res[name] = _trained(f"family {name}", state, step, batch, n_steps,
                             name)
        del state, step, batch
        torch.cuda.empty_cache()

    for name in FAMILIES:
        _step_card_vs_cpu(dev, f"family {name} train step",
                          FAMILIES[name](False), family_weights(name), name)
    cfg, sd = variant_weights("main", False)
    cfg, batch = _no_dropout(cfg), oracle_batch()
    # The packed loss sums the same terms in another order.
    hold_step("main packed train step",
              _train_step_grads(dev, cfg, sd, batch, "packed"),
              _train_step_grads(dev, cfg, sd, batch, "all"),
              loss_rtol=1e-6, grad_tol=1e-4, stats_tol=0.0)
    return res


def families_eval_cli(dev, cpu_flows, frames) -> dict:
    """The evaluator CLI on the card with --raft, --nogma and without
    --setrans (GMA attention), over each family's weights as a reference
    .pth: a one-pair Sintel tree of the oracle frames whose ground truth is
    the family's fp32 CPU flow (--fullprec within FULLPREC_BOUND_PX, mixed
    within BF16_BOUND_PX), then a KITTI tree (2 pairs at 375x1242, mixed);
    metrics, pairs/s and the exact launches of FAMILY_SERVE a forward."""
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    FAMILY_DIR.mkdir(parents=True)
    kitti_hw = (KITTI_H, KITTI_W)
    rng = np.random.RandomState(8)
    write_kitti_tree(FAMILY_DIR / "kitti",
                     [tuple(rng.randint(0, 256, (*kitti_hw, 3)).astype(
                         np.uint8) for _ in range(2)) for _ in range(2)],
                     [rng.uniform(-10, 10, (*kitti_hw, 2)).astype(np.float32)
                      for _ in range(2)])
    out = {}
    for name, flags in FAMILY_FLAGS.items():
        pth = FAMILY_DIR / f"{name}.pth"
        torch.save({f"module.{k}": v
                    for k, v in family_weights(name).items()}, pth)
        write_sintel_tree(FAMILY_DIR / name, frames, [cpu_flows[name]])
        argv = ["--model", str(pth), *flags, "--iters", str(ITERS),
                "--device", str(dev), "--dataset"]
        runs = (("sintel fp32", ["sintel", "--fullprec"], name, 2, 2),
                ("sintel mixed", ["sintel"], name, 2, 2),
                ("kitti mixed", ["kitti"], "kitti", 2, 2))
        for label, ds_args, root, n_pairs, n_fwd in runs:
            r = _timed_cli(f"{name} {label}", argv + ds_args + [
                "--data_root", str(FAMILY_DIR / root)], n_pairs)
            _assert_launches(f"eval {name} {label}", r["launches"],
                             FAMILY_SERVE[name], n_fwd)
            if root == name:
                epe = r["metrics"]["sintel_clean_epe"]
                bound = FULLPREC_BOUND_PX if "fp32" in label \
                    else BF16_BOUND_PX
                print(f"eval {name} {label}: sintel_clean_epe {epe:.3e} px "
                      f"against the port's CPU flow (bound {bound})")
                assert epe < bound, f"eval {name} {label}"
            out[f"{name} {label}"] = r
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    return out


def families_phase(dev) -> dict:
    """The other families: card against CPU, serving at full width,
    training at the chairs crops and the evaluator CLI (the training CLI's
    --raft and --upsample_mode final runs are in ``train_cli_phase``)."""
    t0 = time.perf_counter()
    flows = families_card_vs_cpu(dev)
    res = {"serving": families_serving(dev)}
    torch.cuda.empty_cache()
    res["training"] = families_training(dev)
    torch.cuda.empty_cache()
    res["eval"] = families_eval_cli(dev, flows, flows["frames"])
    print(f"families phase: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Two-way correlation (--f1), the SETrans ablations and attvis
# ---------------------------------------------------------------------------

# A served two-way pair: B1 at the f1, f2 and intra sites and once inside
# each direction's B3; B2 at the f1 and f2 sites; B3 once a direction; B4
# (int8) at the intra site; B5 (D = 2) once an iteration.
TWO_WAY_SERVE = {"scores_global_max": 5, "flash_mode_attention": 2,
                 "fused_agg_corr_norm": 2, "mode_softmax_probs": 1,
                 "corr_lookup": ITERS}
# A training step: the f1, f2 and intra sites' B1 + B4 float (B7 as the
# backward), each direction's B1 + B6 (B6 backward), B5 and its backward.
KERNEL_SITES["f1_private"] = KERNEL_SITES["f1_shared"] = (
    "f1", "f2", "intra", "inter", "inter")
GROUPS = GROUPS + ("f1_trans",)
TWO_WAY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_two_way"


def _variant_model(dev, variant, mixed_precision, sd=None):
    cfg, vsd = variant_weights(variant, mixed_precision)
    model = create_model(cfg, device=dev)
    model.load_state_dict(vsd if sd is None else sd, strict=True)
    return model


def two_way_card_vs_cpu(dev) -> dict:
    """The oracle tree with a seeded private f1 site at 128x128, 12
    iterations, on the card against the CPU (plain versions): fp32 within
    FULLPREC_BOUND_PX, mixed within BF16_BOUND_PX; and the shared config's
    fp32 CPU flow, the ground truth of the CLI run.  Returns the frames and
    the fp32 CPU flows."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    frames = [np.round(x[0]).astype(np.uint8) for x in (img1, img2)]
    pair = [torch.from_numpy(f[None].astype(np.float32)) for f in frames]
    out = {"frames": frames}
    runs = (("f1_private", "fp32", False, FULLPREC_BOUND_PX),
            ("f1_private", "mixed", True, BF16_BOUND_PX),
            ("f1_shared", "fp32", False, FULLPREC_BOUND_PX))
    for variant, label, mp, bound in runs:
        want = _final(_variant_model("cpu", variant, mp), *pair).float()
        got = _final(_variant_model(dev, variant, mp),
                     *(t.to(dev) for t in pair)).float().cpu()
        err = float((got - want).abs().max())
        print(f"two-way {variant} {label}: card against the CPU, max |flow "
              f"diff| {err:.3e} px (max |flow| {float(want.abs().max()):.3f}"
              f", bound {bound})")
        assert bool(torch.isfinite(got).all()) and err < bound, \
            f"two-way {variant} {label}"
        if not mp:
            out[variant] = want[0].numpy()
    return out


def two_way_serving(dev, n_pairs: int = 3) -> dict:
    """'shared' and 'private' served as the main path (mixed, 440x1024, 12
    iterations, one warm-up pair, then n_pairs seeded pairs with the launch
    counts zeroed just before): ms between CUDA events, the profiler's
    kernel ms of a pair, peak memory and the exact TWO_WAY_SERVE."""
    padder, pairs = frame_pairs(dev, n_pairs + 1, seed=4)
    res = {}
    for variant in TWO_WAY:
        model = serving_model(dev, variant)
        res[variant] = _served(f"two-way {variant}", model, padder, pairs,
                               TWO_WAY_SERVE)
        del model
        torch.cuda.empty_cache()
    return res


def two_way_training(dev, n_steps: int = 3) -> dict:
    """One fp32 step (dropout off, 2 iterations, the oracle frames) of the
    private config on the card against the CPU (phase 3's bounds, exact
    launches), then the private config at the chairs crops (mixed, dropout
    at the config's rates, 12 iterations): one warm-up step and n_steps
    steps, device ms (CUDA events), peak memory and exact launches."""
    cfg, sd = variant_weights("f1_private", False)
    _step_card_vs_cpu(dev, "two-way f1_private train step", cfg, sd,
                      "f1_private")
    state, step, batch = train_setup(dev, "f1_private")
    return _trained("two-way f1_private", state, step, batch, n_steps,
                    "f1_private")


def two_way_eval_cli(dev, cpu_flow, frames) -> dict:
    """The evaluator CLI with --f1 shared on the card over the shared
    weights as a reference .pth, on a one-pair Sintel tree of the oracle
    frames whose ground truth is the shared config's fp32 CPU flow:
    --fullprec within FULLPREC_BOUND_PX, mixed within BF16_BOUND_PX, the
    exact TWO_WAY_SERVE a forward."""
    shutil.rmtree(TWO_WAY_DIR, ignore_errors=True)
    TWO_WAY_DIR.mkdir(parents=True)
    _, sd = variant_weights("f1_shared", False)
    pth = TWO_WAY_DIR / "f1_shared.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    write_sintel_tree(TWO_WAY_DIR / "sintel", frames, [cpu_flow])
    out = {}
    for label, extra, bound in (("fp32", ["--fullprec"], FULLPREC_BOUND_PX),
                                ("mixed", [], BF16_BOUND_PX)):
        argv = ["--model", str(pth), "--craft", "--setrans", "--f1",
                "shared", "--iters", str(ITERS), "--device", str(dev),
                "--dataset", "sintel", "--data_root",
                str(TWO_WAY_DIR / "sintel"), *extra]
        r = _timed_cli(f"two-way f1_shared {label}", argv, 2)
        _assert_launches(f"eval two-way {label}", r["launches"],
                         TWO_WAY_SERVE, 2)
        epe = r["metrics"]["sintel_clean_epe"]
        print(f"eval two-way {label}: sintel_clean_epe {epe:.3e} px against "
              f"the port's CPU flow (bound {bound})")
        assert epe < bound, f"eval two-way {label}"
        out[label] = r
    shutil.rmtree(TWO_WAY_DIR, ignore_errors=True)
    return out


# The SETrans ablations: the positional codes at every site, and the
# multi-head output at the f2 site.  A pair under a code launches the
# dense-table kernels without a table (lsinu's); under ablate_multihead the
# f2 site runs the plain path (B1 once inside B3, once at the intra site).
ABLATIONS = ("zero", "rand", "sinu", "multihead")
ABLATION_SERVE = {"multihead": {"scores_global_max": 2,
                                "fused_agg_corr_norm": 1,
                                "mode_softmax_probs": 1,
                                "corr_lookup": ITERS}}


def ablation_config(variant: str, mixed_precision: bool):
    cfg = craft_config(mixed_precision=mixed_precision)
    if variant == "multihead":
        return cfg.replace(f2=dataclasses.replace(cfg.f2,
                                                  ablate_multihead=True))
    return cfg.replace(**{site: dataclasses.replace(
        getattr(cfg, site), pos_code_type=variant)
        for site in ("inter", "f2", "intra")})


def ablation_state_dict(variant: str, grid, seed: int = 13) -> dict:
    """The oracle's state_dict for `variant`, each tensor it lacks seeded:
    a 'rand' table of one N(0, 1) row a token of `grid`, the multi-head
    output's linears as PyTorch initialises them (first_linear the leading
    part of the oracle's)."""
    sd = state_dict_from_flax(load_oracle_npz(ORACLE)[3])
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        want = FlowModel(ablation_config(variant, False)).state_dict()
    out = {}
    for key, v in want.items():
        o = sd.get(key)
        if key.endswith("pos_coder.pos_embed"):
            out[key] = torch.randn(grid[0] * grid[1], v.shape[1],
                                   generator=gen)
        elif o is not None and o.dim() == v.dim() and all(
                a >= b for a, b in zip(o.shape, v.shape)):
            out[key] = o[tuple(slice(0, n) for n in v.shape)].clone()
        else:
            out[key] = v
    return out


def ablations_card_vs_cpu(dev) -> dict:
    """One pair (the oracle frames, 128x128, 12 iterations) of each
    ablation on the card against the CPU: fp32 within FULLPREC_BOUND_PX,
    mixed within BF16_BOUND_PX, and the card's launches."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    pair = [torch.from_numpy(x) for x in (img1, img2)]
    grid = (img1.shape[1] // 8, img1.shape[2] // 8)
    res = {}
    for variant in ABLATIONS:
        sd = ablation_state_dict(variant, grid)
        for label, mp, bound in (("fp32", False, FULLPREC_BOUND_PX),
                                 ("mixed", True, BF16_BOUND_PX)):
            flows = []
            for d in (torch.device("cpu"), dev):
                model = create_model(ablation_config(variant, mp), device=d)
                model.load_state_dict(sd, strict=True)
                launch.reset_launch_counts()
                flows.append(_final(model, *(t.to(d) for t in pair))
                             .float().cpu())
            counts = launch.launch_counts()
            want, got = flows
            err = float((got - want).abs().max())
            print(f"ablation {variant} {label}: card against the CPU, max "
                  f"|flow diff| {err:.3e} px (max |flow| "
                  f"{float(want.abs().max()):.3f}, bound {bound})")
            assert bool(torch.isfinite(got).all()) and err < bound, \
                f"ablation {variant} {label}"
            _assert_launches(f"ablation {variant} {label}", counts,
                             ABLATION_SERVE.get(variant, LSINU_KERNELS), 1)
            res[f"{variant} {label}"] = err
    return res


ATTVIS_POINTS = ((0, 0), (5, 9), (15, 15))


def attvis_on_card(dev) -> dict:
    """attvis: dump_attention of the private two-way config (fp32, the
    oracle frames, 1 iteration) on the card and on the CPU: the same keys
    and shapes, the arrays within 1e-4 of each array's largest value; no
    B2, B3 or B4 launch while capturing, and B3 and B4 launching again in
    the next forward; then vis_attention's PNGs of the intra probs."""
    from craft_tpu_torch.eval import attvis

    img1, img2, _, _ = load_oracle_npz(ORACLE)
    cfg, sd = variant_weights("f1_private", False)
    shutil.rmtree(TWO_WAY_DIR, ignore_errors=True)
    TWO_WAY_DIR.mkdir(parents=True)
    launch.reset_launch_counts()
    got = attvis.dump_attention(cfg, sd, img1, img2,
                                str(TWO_WAY_DIR / "card.npz"), iters=1,
                                device=dev)
    counts = launch.launch_counts()
    for name in ("flash_mode_attention", "fused_agg_corr_norm",
                 "mode_softmax_probs"):
        assert counts[name] == 0, f"attvis: {name} launched while capturing"
    assert counts["corr_lookup"] == 1, "attvis: B5 once an iteration"
    want = attvis.dump_attention(cfg, sd, img1, img2,
                                 str(TWO_WAY_DIR / "cpu.npz"), iters=1,
                                 device="cpu")
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    errs = {}
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        errs[key] = float(np.abs(got[key] - w).max() / np.abs(w).max())
        assert errs[key] < 1e-4, f"attvis {key}: {errs[key]:.3e}"
    print("attvis: card against the CPU, max |diff| / max |value| per key",
          json.dumps(errs))
    launch.reset_launch_counts()
    _final(_variant_model(dev, "f1_private", False),
           *(torch.from_numpy(x).to(dev) for x in (img1, img2)))
    counts = launch.launch_counts()
    assert counts["fused_agg_corr_norm"] == 2 and \
        counts["mode_softmax_probs"] == 1, "attvis: the kernels after it"
    n = attvis.vis_attention(got["att/setrans/attn_probs"][0], img2[0],
                             ATTVIS_POINTS, str(TWO_WAY_DIR / "vis"),
                             (img1.shape[1] // 8, img1.shape[2] // 8))
    pngs = sorted(p.name for p in (TWO_WAY_DIR / "vis").glob("*.png"))
    print(f"attvis: {n} PNGs written: {pngs}")
    assert n == len(pngs) == len(ATTVIS_POINTS)
    assert imgio.load(str(TWO_WAY_DIR / "vis" / pngs[0])).shape == \
        img2.shape[1:]
    shutil.rmtree(TWO_WAY_DIR, ignore_errors=True)
    return {"keys": {k: list(v.shape) for k, v in got.items()},
            "errs": errs}


def two_way_phase(dev) -> dict:
    """Two-way correlation (card against CPU, serving at full width,
    training, the evaluator CLI), the SETrans ablations and attvis."""
    t0 = time.perf_counter()
    flows = two_way_card_vs_cpu(dev)
    res = {"serving": two_way_serving(dev)}
    torch.cuda.empty_cache()
    res["training"] = two_way_training(dev)
    torch.cuda.empty_cache()
    res["eval"] = two_way_eval_cli(dev, flows["f1_shared"], flows["frames"])
    res["ablations"] = ablations_card_vs_cpu(dev)
    res["attvis"] = attvis_on_card(dev)
    torch.cuda.empty_cache()
    print(f"two-way phase: {time.perf_counter() - t0:.1f} s")
    return res


# The evaluation phase: reference-format checkpoint, synthetic dataset
# trees (written by the port's own codecs), the port's CLI on the card.
EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
KITTI_H, KITTI_W = 375, 1242  # KITTI 2015 frames, padded to 376x1248


def _img(path: Path, img) -> None:
    """A frame as PNG (uint8 array) or as JPEG bytes already encoded."""
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(img, bytes):
        path.write_bytes(img)
    else:
        imgio.write_png(str(path), img)


def _flo(path: Path, flow) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    frame_utils.write_flo(str(path), flow)


def _kitti_png(path: Path, flow) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    frame_utils.write_flow_kitti(str(path), flow)


# Synthetic trees in each dataset's own layout (the port's datasets read
# them as they read the real ones); shared with the CPU tests, which write
# them small.
def write_sintel_tree(root: Path, frames, flows=None, occs=None,
                      split="training", scene="alley_1") -> None:
    """Sintel: the same frames as the clean and the final pass; flows[i]
    (training) and occs[i] (uint8 0/255 occlusion masks) for pair i."""
    for i, frame in enumerate(frames):
        for sub in ("clean", "final"):
            _img(root / "Sintel" / split / sub / scene
                 / f"frame_{i + 1:04d}.png", frame)
    for i, flow in enumerate(flows or []):
        _flo(root / "Sintel" / split / "flow" / scene
             / f"frame_{i + 1:04d}.flo", flow)
    for i, occ in enumerate(occs or []):
        _img(root / "Sintel" / split / "occlusions" / scene
             / f"frame_{i + 1:04d}.png", occ)


def write_kitti_tree(root: Path, pairs, flows=None, split="training") -> None:
    """KITTI 2015: pair i as image_2/<i>_10.png, <i>_11.png, its flow as a
    16-bit KITTI PNG in flow_occ (training only)."""
    for i, (a, b) in enumerate(pairs):
        for suf, img in (("10", a), ("11", b)):
            _img(root / "KITTI" / split / "image_2" / f"{i:06d}_{suf}.png",
                 img)
    for i, flow in enumerate(flows or []):
        _kitti_png(root / "KITTI" / split / "flow_occ" / f"{i:06d}_10.png",
                   flow)


def write_things_tree(root: Path, frames, flows) -> None:
    """FlyingThings3D's TEST subset, one scene, both passes: frames[i] and
    flows[i] (into the future and, the same arrays, into the past); the
    validation filter keeps the into-future pairs only."""
    for sub in ("frames_cleanpass", "frames_finalpass"):
        for i, frame in enumerate(frames):
            _img(root / "FlyingThings3D" / sub / "TEST" / "A" / "0000"
                 / "left" / f"{i + 6:04d}.png", frame)
    for direction in ("into_future", "into_past"):
        for i, flow in enumerate(flows):
            _flo(root / "FlyingThings3D" / "optical_flow" / "TEST" / "A"
                 / "0000" / direction / "left" / f"{i + 6:04d}.flo", flow)
    n = len(flows) - 1
    np.savetxt(root / "things_val_test_set.txt", [1] * n + [0] * n,
               fmt="%d")


def write_hd1k_tree(root: Path, frames, flows) -> None:
    """HD1K: one sequence, frames[i] and the 16-bit KITTI PNG flows[i]."""
    for i, frame in enumerate(frames):
        _img(root / "HD1k" / "hd1k_input" / "image_2" / f"000000_{i:04d}.png",
             frame)
    for i, flow in enumerate(flows):
        _kitti_png(root / "HD1k" / "hd1k_flow_gt" / "flow_occ"
                   / f"000000_{i:04d}.png", flow)


def write_viper_tree(root: Path, pairs, flows=None, split="val") -> None:
    """VIPER: scene 001, pair i as 001_<10 (i + 1)>.jpg and the next frame
    (JPEG bytes), the val split's flows as 16-bit KITTI PNGs; the test
    split lists its first frames in test_frames.txt."""
    firsts = []
    for i, (a, b) in enumerate(pairs):
        idx = 10 * (i + 1)
        firsts.append(f"001_{idx:05d}")
        for j, img in ((idx, a), (idx + 1, b)):
            _img(root / "viper" / "jpg" / split / "img" / "001"
                 / f"001_{j:05d}.jpg", img)
    for i, flow in enumerate(flows or []):
        _kitti_png(root / "viper" / "jpg" / split / "flow" / "001"
                   / f"001_{10 * (i + 1):05d}.png", flow)
    if split == "test":
        (root / "viper" / "test_frames.txt").write_text(
            "".join(f"{t}\n" for t in firsts))


def write_slowflow_tree(root: Path, pairs, flows) -> None:
    """SlowFlow at blur magnitude 100: pair i as seq1_<i>0.png and
    seq1_<i>1.png, its flow as seq1_<i>0.flo."""
    for i, ((a, b), flow) in enumerate(zip(pairs, flows)):
        for j, img in ((0, a), (1, b)):
            _img(root / "slowflow" / "100" / "sequence" / "scene"
                 / f"seq1_{i:03d}{j}.png", img)
        _flo(root / "slowflow" / "100" / "flow" / "scene"
             / f"seq1_{i:03d}0.flo", flow)


def _timed_cli(label, argv, n_pairs) -> dict:
    """Run craft_tpu_torch.evaluate.main(argv) with the launch counts set
    to 0 just before: its metrics, host seconds, pairs/s and launches."""
    launch.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_cli.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = {"metrics": res, "seconds": sec, "pairs_per_s": n_pairs / sec,
           "launches": launch.launch_counts()}
    print(f"eval {label}:", json.dumps(out))
    assert all(math.isfinite(v) for v in res.values()), f"eval {label}"
    return out


def eval_phase(dev, kitti_hw=(KITTI_H, KITTI_W),
               sintel_hw=(FRAME_H, FRAME_W)) -> dict:
    """The evaluation entry point on the card.  (1) The oracle's full-width
    tree saved as a reference .pth ('module.' keys); (2) a one-pair Sintel
    tree of the oracle frames rounded to uint8, whose ground truth is the
    port's fp32 CPU flow for them; (3) the CLI with --fullprec and mixed,
    held within the oracle bounds; (4) a KITTI tree (2 pairs) and a Sintel
    scene (3 frames) at full size, run with --dataset kitti and --dataset
    sintel --batch_size 2 (cold, then warm): finite metrics, pairs/s, and
    B1-B5 launched in each (B3 at KITTI's W8 = 156); (5) the steady
    forward rate of the evaluator at those padded shapes."""
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    img1, img2, _, tree = load_oracle_npz(ORACLE)
    sd = state_dict_from_flax(tree)
    pth = EVAL_DIR / "craft-oracle.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    frames = [np.round(x[0]).astype(np.uint8) for x in (img1, img2)]
    cpu = create_model(craft_config(mixed_precision=False), device="cpu")
    cpu.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        _, flows = cpu(*(torch.from_numpy(f[None].astype(np.float32))
                         for f in frames), iters=ITERS)
    write_sintel_tree(EVAL_DIR / "oracle", frames, [flows[-1][0].numpy()])
    argv = ["--model", str(pth), "--craft", "--setrans", "--iters",
            str(ITERS), "--device", str(dev), "--dataset"]
    out = {}
    for label, extra, bound in (("fp32", ["--fullprec"], FULLPREC_BOUND_PX),
                                ("mixed", [], BF16_BOUND_PX)):
        r = _timed_cli(f"oracle sintel {label}", argv + [
            "sintel", "--data_root", str(EVAL_DIR / "oracle")] + extra, 2)
        epe = r["metrics"]["sintel_clean_epe"]
        print(f"eval oracle {label}: sintel_clean_epe {epe:.3e} px against "
              f"the port's CPU flow (bound {bound})")
        assert epe < bound, f"eval oracle {label}"
        out[f"oracle_{label}_epe"] = epe

    rng = np.random.RandomState(5)

    def frame(hw):
        return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)

    def flow(hw):
        return rng.uniform(-10, 10, (*hw, 2)).astype(np.float32)
    big = EVAL_DIR / "full"
    write_kitti_tree(big, [(frame(kitti_hw), frame(kitti_hw))
                           for _ in range(2)],
                     [flow(kitti_hw) for _ in range(2)])
    write_sintel_tree(big, [frame(sintel_hw) for _ in range(3)],
                      [flow(sintel_hw) for _ in range(2)])
    # (CLI arguments, pairs, forwards): Sintel's 2 pairs make one batch
    # per pass, clean and final.
    runs = {"kitti": (["kitti"], 2, 2),
            "sintel batch 2": (["sintel", "--batch_size", "2"], 4, 2)}
    for label, (ds_args, n_pairs, n_forwards) in runs.items():
        for warm in ("cold", "warm"):
            r = _timed_cli(f"{label} {warm}", argv + ds_args + [
                "--data_root", str(big)], n_pairs)
            out[f"{label} {warm}"] = r
            n = r["launches"]
            for name in SERVE_KERNELS:
                assert n[name] > 0, f"eval {label}: {name} not launched"
            assert n["corr_lookup"] == ITERS * n_forwards, "B5: 12 a forward"
    out.update(eval_dense(dev, sd, frames, argv, big))
    shutil.rmtree(EVAL_DIR, ignore_errors=True)

    # The CLI runs above are mostly set-up (model build, checkpoint load,
    # decode) at 2-4 pairs; the steady rate of the same evaluator forward
    # at each padded shape, one warm-up then 3 timed forwards:
    ev = tev.Evaluator(craft_config(mixed_precision=True), sd, iters=ITERS,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    pad8 = lambda n: -(-n // 8) * 8  # noqa: E731
    for label, batch, (h, w) in (("kitti", 1, kitti_hw),
                                 ("sintel batch 2", 2, sintel_hw)):
        img = torch.rand(batch, pad8(h), pad8(w), 3, generator=gen,
                         device=dev) * 255
        ev(img, img)
        t0 = time.perf_counter()
        for _ in range(3):
            ev(img, img)
        sec = time.perf_counter() - t0
        steady = {"ms_per_forward": sec / 3 * 1e3,
                  "pairs_per_s": 3 * batch / sec}
        print(f"eval {label} steady ({batch}x{pad8(h)}x{pad8(w)}):",
              json.dumps(steady))
        out[f"{label} steady"] = steady
    return out


# The rest of the evaluator: the six further validators, the submission
# writers, the shift sweep and --flop, each at its dataset's full shape;
# then the same validators on small trees, card against CPU.
SETS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_sets"
FIXTURES = Path(__file__).resolve().parent / "tests" / "data"
THINGS_HW = (540, 960)
HD1K_HW = (1080, 2560)
SHIFTS = ((100, 50), (200, 100), (300, 150))  # scripts/shifteval.sh
SMALL_HW = (128, 128)  # the small trees: U = 256, as the oracle
# Per forward: B1 at the three sites, B2 (f2), B3 (inter), B4 (intra) once,
# B5 once per iteration.
SERVE_PER_PAIR = {"scores_global_max": 3, "flash_mode_attention": 1,
                  "fused_agg_corr_norm": 1, "mode_softmax_probs": 1,
                  "corr_lookup": ITERS}
# A forward on the lazy intra path (the intra probs past
# setrans.LAZY_PROBS_BYTES, as at HD1K): B2 at the f2 site (F 256) and in
# every iteration's aggregator (F 128), no B4.
LAZY_PER_PAIR = dict(SERVE_PER_PAIR, flash_mode_attention=1 + ITERS,
                     mode_softmax_probs=0)
LAZY_PEAK_BOUND = 8e9  # bytes, one HD1K pair on the lazy path
# bytes, one HD1K pair on the materialised path before the lazy one
# existed (PERF.md section 5)
MATERIALISED_HD1K_PEAK = 28_286_863_872


def _image_digest(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def check_image_fixtures(names=None) -> dict:
    """Every image fixture of tests/data decoded by the port's decoder on
    this host, which has no PIL: the VIPER JPEGs (tools/make_jpeg_fixtures.py)
    to PIL's pixel hashes, and each file of tests/data/formats
    (tools/make_image_fixtures.py: progressive, arithmetic-coded, lossless,
    CMYK and YCCK JPEG, interlaced, 1/2/4-bit and tRNS PNG, and the forms
    the JAX package refuses) to the array the JAX package's load gives
    (its native core's, or PIL's where the core refuses the file) in
    dtype, shape and bytes, or to a ValueError where it raises.  Prints
    each file's decode ms on the host and a line of the 1920x1080 files'
    ms.  `names` limits the files checked.  Returns {name: bytes} of the
    VIPER JPEGs."""
    out, full_ms = {}, {}
    for name, m in json.loads((FIXTURES / "viper_jpeg.json").read_text()
                              ).items():
        if names is not None and name not in names:
            continue
        data = (FIXTURES / name).read_bytes()
        t0 = time.perf_counter()
        img = imgio.decode_jpeg(data)
        ms = (time.perf_counter() - t0) * 1e3
        assert list(img.shape) == m["shape"] and \
            _image_digest(img) == m["pixels_sha256"], \
            f"JPEG {name}: the port's pixels disagree with PIL's"
        print(f"jpeg {name}: {img.shape[1]}x{img.shape[0]} decoded on the "
              f"host in {ms:.1f} ms, pixels identical to PIL's")
        out[name] = data
    meta = json.loads((FIXTURES / "image_formats.json").read_text())
    for name, m in meta.items():
        if names is not None and name not in names:
            continue
        path = FIXTURES / "formats" / name
        want = m[m["load"]] if m["load"] else None
        t0 = time.perf_counter()
        try:
            img, err = imgio.load(str(path)), None
        except ValueError as e:
            img, err = None, e
        ms = (time.perf_counter() - t0) * 1e3
        if want is None:
            assert img is None, \
                f"image {name} ({m['form']}): the port decodes a file the " \
                "JAX package refuses: it disagrees"
            print(f"image {name}: {m['form']}, refused as by the JAX "
                  f"package ({err})")
            continue
        assert img is not None, \
            f"image {name} ({m['form']}): the port disagrees with the JAX " \
            f"package's {m['load']} decode: it raised {err}"
        assert [list(img.shape), str(img.dtype), _image_digest(img)] == \
            [want["shape"], want["dtype"], want["sha256"]], \
            f"image {name} ({m['form']}): the port's array disagrees with " \
            f"the JAX package's {m['load']} decode"
        if img.shape[:2] == (1080, 1920):
            full_ms[name] = ms
        print(f"image {name}: {m['form']}, {img.shape[1]}x{img.shape[0]} "
              f"decoded on the host in {ms:.1f} ms, identical to the JAX "
              f"package's ({m['load']})")
    print("image decode ms on the host, 1920x1080 files:",
          json.dumps(full_ms))
    return out


def demo_progressive(dev, pth: Path) -> dict:
    """The single-pair demo (python -m craft_tpu_torch.evaluate --img1
    --img2, eval/demo.py's gen_flow) on the card on the progressive
    1920x1080 pair (tests/data/formats/viper_prog_0001{0,1}.jpg) with the
    main path's configuration: the flow's shape, that it is finite, its
    launches (1080x1920 takes the lazy intra path) and the wall with the
    decode."""
    frames = [FIXTURES / "formats" / f"viper_prog_000{i}.jpg"
              for i in (10, 11)]
    launch.reset_launch_counts()
    t0 = time.perf_counter()
    flow = evaluate_cli.main(["--model", str(pth), "--craft", "--setrans",
                              "--device", str(dev), "--img1", str(frames[0]),
                              "--img2", str(frames[1]), "--output_path",
                              str(SETS_DIR / "demo")])
    sync(dev)
    sec = time.perf_counter() - t0
    _assert_launches("demo progressive", launch.launch_counts(),
                     LAZY_PER_PAIR, 1)
    finite = bool(np.isfinite(flow).all())
    out = {"shape": list(flow.shape), "finite": finite, "seconds": sec,
           "png": [p.name for p in (SETS_DIR / "demo").glob("*.png")]}
    print("demo on the progressive 1920x1080 pair:", json.dumps(out), "|",
          card_line())
    assert out["shape"] == [1080, 1920, 2] and finite and out["png"], \
        "demo progressive"
    return out


def _eval_path(dev, label, argv, n_pairs, forwards, iters=ITERS,
               per_pair=SERVE_PER_PAIR) -> dict:
    """One CLI run of the rest of the evaluator on the card with its
    launches (per_pair a forward: B1-B5, or the lazy path's; B5 `iters`
    times) asserted and its peak memory recorded."""
    assert dev.type == "cuda", dev
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_cli.main(argv)
    sync(dev)
    sec = time.perf_counter() - t0
    counts = launch.launch_counts()
    _assert_launches(f"eval {label}", counts,
                     dict(per_pair, corr_lookup=iters), forwards)
    out = {"seconds": sec, "pairs_per_s": n_pairs / sec,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in counts.items() if v},
           "b2_by_width": dict(ma.flash_mode_attention.launches_by),
           "result": res}
    print(f"eval {label}:", json.dumps(out), "|", card_line())
    for r in res if isinstance(res, list) else [res]:
        if isinstance(r, dict):
            assert all(math.isfinite(v) for v in r.values()), label
    return out


def _flow_tree_files_finite(paths) -> None:
    for p in paths:
        flow = frame_utils.read_flo(str(p)) if p.suffix == ".flo" else \
            frame_utils.read_flow_kitti(str(p))[0]
        assert np.isfinite(flow).all() and flow.shape[-1] == 2, p


def write_set_trees(root: Path, rng, jpegs, hw=None) -> None:
    """The further evaluation sets under root at their datasets' shapes
    (or all at hw for the small trees): things (2 frames: one pair a
    pass), Sintel training with occlusions (2 frames) and test (3 frames),
    KITTI training (2 pairs: kittitrain holds out 1) and testing (1),
    HD1K (1 pair), VIPER val and test (the JPEG pair `jpegs`), SlowFlow
    (1 pair); noise frames, flows uniform in +-10 px."""
    def frame(shape):
        return rng.randint(0, 256, (*shape, 3)).astype(np.uint8)

    def flow(shape):
        return rng.uniform(-10, 10, (*shape, 2)).astype(np.float32)
    things, sintel = hw or THINGS_HW, hw or (FRAME_H, FRAME_W)
    kitti, hd1k = hw or (KITTI_H, KITTI_W), hw or HD1K_HW
    if hw:  # the sparse sets a little off the multiple of 8
        kitti = hd1k = (hw[0] - 4, hw[1] - 4)
    write_things_tree(root, [frame(things) for _ in range(2)],
                      [flow(things) for _ in range(2)])
    write_sintel_tree(root, [frame(sintel) for _ in range(2)],
                      [flow(sintel)],
                      [np.where(rng.uniform(size=sintel) < 0.2, 255,
                                0).astype(np.uint8)])
    write_sintel_tree(root, [frame(sintel) for _ in range(3)], split="test")
    write_kitti_tree(root, [(frame(kitti), frame(kitti)) for _ in range(2)],
                     [flow(kitti) for _ in range(2)])
    write_kitti_tree(root, [(frame(kitti), frame(kitti))], split="testing")
    write_hd1k_tree(root, [frame(hd1k) for _ in range(2)],
                    [flow(hd1k) for _ in range(2)])
    viper = imgio.decode_jpeg(jpegs[0]).shape[:2]
    write_viper_tree(root, [tuple(jpegs)], [flow(viper)])
    write_viper_tree(root, [tuple(jpegs)], split="test")
    write_slowflow_tree(root, [(frame(sintel), frame(sintel))],
                        [flow(sintel)])


def eval_sets_phase(dev) -> dict:
    """The rest of the evaluator on the card (craft_tpu_torch.evaluate.main,
    the oracle tree as a reference .pth, mixed precision): each further
    --dataset at its shape (things 540x960, sintel_occ 436x1024,
    kittitrain 375x1242, hd1k 1080x2560 (U = 43520), viper's 1920x1080
    JPEG fixtures at 0.5 (544x960), slowflow 436x1024), after the image
    fixtures' check and the demo on the progressive pair, the Sintel
    submission with --warm_start (3 frames, 32 iterations), the KITTI and
    VIPER submissions (24), the shift sweep of scripts/shifteval.sh on
    the Sintel tree and --flop at 440x1024: pairs/s, launches asserted
    (B1 3, B2-B4 1, B5 the iterations, a forward) and peak memory.  Then
    each further validator on small trees (128x128; VIPER's 256x256 JPEG
    fixtures at 0.5), card (--fullprec, and mixed) against the port's
    fp32 CPU metrics: every EPE within 1e-3 px, and 0.15 px mixed."""
    jpegs = check_image_fixtures()
    print("the image fixtures' host |", card_line())
    shutil.rmtree(SETS_DIR, ignore_errors=True)
    SETS_DIR.mkdir(parents=True)
    _, _, _, tree = load_oracle_npz(ORACLE)
    sd = state_dict_from_flax(tree)
    pth = SETS_DIR / "craft-oracle.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    out = {"demo progressive": demo_progressive(dev, pth)}
    full = SETS_DIR / "full"
    write_set_trees(full, np.random.RandomState(8),
                    [jpegs[f"viper_000{i}.jpg"] for i in (10, 11)])
    argv = ["--model", str(pth), "--craft", "--setrans", "--device",
            str(dev), "--data_root", str(full)]
    # (label, CLI arguments, pairs, forwards, iterations)
    runs = [("things", ["--dataset", "things"], 2, 2, ITERS),
            ("sintel_occ", ["--dataset", "sintel_occ"], 2, 2, ITERS),
            ("kittitrain", ["--dataset", "kittitrain"], 1, 1, ITERS),
            ("hd1k", ["--dataset", "hd1k"], 1, 1, ITERS),
            ("viper", ["--dataset", "viper"], 1, 1, ITERS),
            ("slowflow", ["--dataset", "slowflow"], 1, 1, ITERS),
            ("sintel submission --warm_start",
             ["--submission", "sintel", "--warm_start", "--output_path",
              str(SETS_DIR / "sub_sintel")], 4, 4, 32),
            ("kitti submission", ["--submission", "kitti", "--output_path",
                                  str(SETS_DIR / "sub_kitti")], 1, 1, 24),
            ("viper submission", ["--submission", "viper", "--output_path",
                                  str(SETS_DIR / "sub_viper")], 1, 1, 24),
            ("shift sweep", ["--dataset", "sintel", "--xshifts",
                             ",".join(str(x) for x, _ in SHIFTS),
                             "--yshifts", ",".join(str(y) for _, y in
                                                   SHIFTS)],
             2 * len(SHIFTS), 2 * len(SHIFTS), ITERS)]
    for label, extra, n_pairs, forwards, iters in runs:
        out[label] = _eval_path(dev, label, argv + extra, n_pairs, forwards,
                                iters, LAZY_PER_PAIR if label == "hd1k"
                                else SERVE_PER_PAIR)
    assert len(out["shift sweep"]["result"]) == len(SHIFTS)
    assert out["hd1k"]["b2_by_width"] == {256: 1, LAZY_F: ITERS}, \
        "eval hd1k: B2's launches by width"
    _flow_tree_files_finite(
        sorted((SETS_DIR / "sub_sintel").glob("*/*/*.flo"))
        + sorted((SETS_DIR / "sub_kitti").glob("*.png"))
        + sorted((SETS_DIR / "sub_viper").glob("*.flo")))
    assert len(list((SETS_DIR / "sub_sintel").glob("*/*/*.flo"))) == 4
    peak = out["hd1k"]["peak_bytes"]
    print(f"eval hd1k: peak {peak} B at U = {HD1K_GRID[0] * HD1K_GRID[1]} "
          f"on the lazy intra path (bound {LAZY_PEAK_BOUND:g} B; "
          f"materialised before: {MATERIALISED_HD1K_PEAK} B) |",
          card_line())
    assert peak < LAZY_PEAK_BOUND, "eval hd1k: peak memory"

    # --flop: the analytic breakdown and one counted forward at 440x1024.
    rng = np.random.RandomState(9)
    flop_hw = (FRAME_H + 4, FRAME_W)
    for i in (1, 2):
        imgio.write_png(str(SETS_DIR / f"flop_{i}.png"), rng.randint(
            0, 256, (*flop_hw, 3)).astype(np.uint8))
    launch.reset_launch_counts()
    flops = evaluate_cli.main(argv + ["--flop", "--img1",
                                      str(SETS_DIR / "flop_1.png"),
                                      "--img2", str(SETS_DIR / "flop_2.png")])
    print(f"eval --flop {flop_hw[0]}x{flop_hw[1]}:", json.dumps(
        {k: v for k, v in flops.items() if k != "analytic_gflops"}),
        "analytic total", flops["analytic_gflops"]["total"], "G")
    assert flops["torch_flops"] > 0 and flops["kernel_flops"] > 0
    _assert_launches("eval --flop", launch.launch_counts(), SERVE_PER_PAIR, 1)
    out["flop"] = flops

    out["small"] = eval_sets_small(dev, sd, pth, jpegs)
    shutil.rmtree(SETS_DIR, ignore_errors=True)
    return out


def eval_sets_small(dev, sd, pth, jpegs) -> dict:
    """Each further validator on small trees: the CLI on the card with
    --fullprec and mixed against the validator on the CPU in fp32.  EPEs
    (all pixels, magnitude buckets, occluded / not) within 1e-3 px and
    0.15 px; shares of pixels are not compared (a flow 0.1 px away moves a
    pixel across a threshold)."""
    small = SETS_DIR / "small"
    write_set_trees(small, np.random.RandomState(10),
                    [jpegs["viper_small_00010.jpg"],
                     jpegs["viper_small_00011.jpg"]], SMALL_HW)
    argv = ["--model", str(pth), "--craft", "--setrans", "--device",
            str(dev), "--data_root", str(small), "--dataset"]
    cfg = craft_config(mixed_precision=False)
    out = {}
    for name in ("things", "sintel_occ", "kittitrain", "hd1k", "viper",
                 "slowflow"):
        want = tev.VALIDATORS[name](cfg, sd, iters=ITERS,
                                    data_root=str(small), device="cpu")
        for label, extra, bound in (
                ("fp32", ["--fullprec"], FULLPREC_BOUND_PX),
                ("mixed", [], BF16_BOUND_PX)):
            got = evaluate_cli.main(argv + [name] + extra)
            assert sorted(got) == sorted(want), name
            err = max(abs(got[k] - want[k]) for k in want
                      if k.endswith("_epe"))
            print(f"eval {name} small {label}: largest EPE difference "
                  f"card - CPU {err:.3e} px (bound {bound})")
            assert err < bound, f"eval {name} small {label}"
            out[f"{name} {label}"] = err
    return out


@contextlib.contextmanager
def materialised_probs():
    """The intra site materialises its probs at any size (the module
    constant raised) inside the block: the path the lazy one replaces."""
    old = setrans.LAZY_PROBS_BYTES
    setrans.LAZY_PROBS_BYTES = math.inf
    try:
        yield
    finally:
        setrans.LAZY_PROBS_BYTES = old


def _final_flow(model, a, b):
    with torch.inference_mode():
        return model(a, b, iters=ITERS)[1][-1]


def _intra_run(dev, label, model, a, b, per_pair, f128,
               timed=True) -> tuple:
    """One forward of `model` on the batch (a, b) with the launch counts
    set to 0 just before and read just after (per_pair for the forward;
    B2 at F 128 f128 times) and its peak memory; then (timed) one more
    forward's device time by CUDA events, after a warm-up forward.
    Returns (final flow, stats)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    flow = _final_flow(model, a, b)
    sync(dev)
    counts = launch.launch_counts()
    by = dict(ma.flash_mode_attention.launches_by)
    stats = {"peak_bytes": torch.cuda.max_memory_allocated(),
             "launches": {k: v for k, v in counts.items() if v},
             "b2_by_width": by}
    _assert_launches(label, counts, per_pair, 1)
    assert by.get(LAZY_F, 0) == f128, f"{label}: B2 by width {by}"
    assert bool(torch.isfinite(flow).all()), label
    if timed:
        stats["ms"] = time_ms(lambda: _final_flow(model, a, b), 1)
    print(f"lazy intra {label}:", json.dumps(stats), "|", card_line())
    return flow, stats


def lazy_intra_phase(dev) -> dict:
    """Phase 4, the lazy intra path.  One HD1K pair (1080x2560 padded to
    1088x2560, U = 43520) of the main config: lazy (B2 13 a forward, 12 of
    them at F 128 in the aggregator; no B4), its peak below
    LAZY_PEAK_BOUND, then the same pair with the probs materialised (the
    module constant raised); the two flows within 0.15 px, and each
    forward's device time (CUDA events).  Then one
    fp32 batch of 6 Sintel pairs at 440x1024, lazy at the real threshold
    (6 * 4 * 7040^2 * 4 = 4.76e9 B), against its materialised flow within
    1e-3 px."""
    out = {}
    model = serving_model(dev)
    _, pairs = frame_pairs(dev, 1, seed=12, hw=HD1K_HW)
    a, b = pairs[0]
    u = (a.shape[1] // 8) * (a.shape[2] // 8)
    assert setrans.probs_go_lazy(1, 4, u, u, torch.bfloat16)
    lazy, out["hd1k lazy"] = _intra_run(dev, "hd1k", model, a, b,
                                        LAZY_PER_PAIR, ITERS)
    with materialised_probs():
        mat, out["hd1k materialised"] = _intra_run(
            dev, "hd1k materialised", model, a, b, SERVE_PER_PAIR, 0)
    peak = out["hd1k lazy"]["peak_bytes"]
    err = _max_diff([lazy], [mat])
    print(f"lazy intra hd1k: max |flow diff| against the materialised path "
          f"{err:.3e} px (bound {BF16_BOUND_PX}); peak {peak} B (bound "
          f"{LAZY_PEAK_BOUND:g}; materialised "
          f"{out['hd1k materialised']['peak_bytes']} B, before "
          f"{MATERIALISED_HD1K_PEAK} B); a forward's device time (CUDA "
          f"events) lazy {out['hd1k lazy']['ms']:.3f} ms against materialised "
          f"{out['hd1k materialised']['ms']:.3f} ms |", card_line())
    assert peak < LAZY_PEAK_BOUND, "lazy intra hd1k: peak memory"
    assert err < BF16_BOUND_PX, "lazy intra hd1k: flow"
    out["hd1k err_px"] = err
    del model, pairs, a, b, lazy, mat
    torch.cuda.empty_cache()

    batch = 6
    model = create_model(craft_config(mixed_precision=False), device=dev)
    model.load_state_dict(state_dict_from_flax(load_oracle_npz(ORACLE)[3]))
    _, pairs = frame_pairs(dev, batch, seed=13)
    a = torch.cat([p[0] for p in pairs])
    b = torch.cat([p[1] for p in pairs])
    assert setrans.probs_go_lazy(batch, 4, U, U, torch.float32)
    label = f"sintel fp32 batch {batch}"
    # Untimed: at this batch the fp32 convolutions dominate (cuDNN's FFT
    # algorithms, seconds a forward).
    lazy, out[label] = _intra_run(dev, label, model, a, b, LAZY_PER_PAIR,
                                  ITERS, timed=False)
    with materialised_probs():
        mat, out[f"{label} materialised"] = _intra_run(
            dev, f"{label} materialised", model, a, b, SERVE_PER_PAIR, 0,
            timed=False)
    err = _max_diff([lazy], [mat])
    print(f"lazy intra {label}: max |flow diff| against the materialised "
          f"path {err:.3e} px (bound {FULLPREC_BOUND_PX}) |", card_line())
    assert err < FULLPREC_BOUND_PX, f"lazy intra {label}: flow"
    out[f"{label} err_px"] = err
    del model, pairs, a, b, lazy, mat
    torch.cuda.empty_cache()
    return out


def eval_dense(dev, sd, frames, argv, big) -> dict:
    """The evaluation entry point under the dense-table flags.  (1) The
    lsinu state_dict saved as a reference .pth, and the CLI with --interpos
    lsinu --intrapos lsinu on the KITTI tree (2 pairs at 375x1242): finite
    metrics, B8, B6 dense and B4 dense in place of B2-B4.  (2) The oracle
    .pth with --f2radius F2RADIUS over a one-pair Sintel tree of the oracle
    frames whose ground truth is the port's fp32 CPU flow under the same
    flag: within 1e-3 px with --fullprec and 0.15 px mixed, B8 in place of
    B2."""
    pth = EVAL_DIR / "craft-lsinu.pth"
    torch.save({f"module.{k}": v for k, v in lsinu_state_dict(sd).items()},
               pth)
    lsinu_argv = ["--model", str(pth)] + argv[2:-1] + [
        "--interpos", "lsinu", "--intrapos", "lsinu", "--dataset"]
    out = {}
    r = _timed_cli("kitti lsinu", lsinu_argv + ["kitti", "--data_root",
                                                str(big)], 2)
    _assert_launches("eval kitti lsinu", r["launches"], LSINU_KERNELS, 2)
    out["kitti lsinu"] = r

    cpu = create_model(f2radius_config(F2RADIUS, False), device="cpu")
    cpu.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        _, flows = cpu(*(torch.from_numpy(f[None].astype(np.float32))
                         for f in frames), iters=ITERS)
    root = EVAL_DIR / "oracle_f2radius"
    write_sintel_tree(root, frames, [flows[-1][0].numpy()])
    for label, extra, bound in (("fp32", ["--fullprec"], FULLPREC_BOUND_PX),
                                ("mixed", [], BF16_BOUND_PX)):
        r = _timed_cli(f"f2radius {F2RADIUS} sintel {label}", argv + [
            "sintel", "--data_root", str(root), "--f2radius",
            str(F2RADIUS)] + extra, 2)
        epe = r["metrics"]["sintel_clean_epe"]
        print(f"eval f2radius {label}: sintel_clean_epe {epe:.3e} px against "
              f"the port's CPU flow (bound {bound})")
        assert epe < bound, f"eval f2radius {label}"
        # Clean and final: two forwards.
        _assert_launches(f"eval f2radius {label}", r["launches"],
                         F2RADIUS_KERNELS, 2)
        out[f"f2radius_{label}_epe"] = epe
    return out


# Phase 4, sequence parallelism: ranks of this script (--sp-rank) under
# torch.distributed.run, two on the one card (gloo), and one rank without
# torchrun (NCCL: a card of its own).
SP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_sp"
SP_RANKS = 2
BIG_H, BIG_W = 1088, 1920  # one 1080p-class pair: H8 = 136, W8 = 240
# Per rank and pair: B1 at the three sites, B2 (f2), B4 (intra), B9 (inter,
# in place of B3), B5 per iteration.
SP_KERNELS = {"scores_global_max": 3, "flash_mode_attention": 1,
              "mode_softmax_probs": 1, "corr_norm_sums": 1,
              "corr_norm_write": 1, "corr_lookup": ITERS}
SP_TIMEOUT = 900  # seconds for one multi-rank command


def _run_ranks(cmd, label, timeout: float = SP_TIMEOUT) -> str:
    """Run a rank command in its own process group, print its output, and
    kill the whole group if it outlives `timeout` seconds; fail unless it
    exits 0.  Returns the output."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for line in out.splitlines():
        print(f"[{label}] {line}")
    print(f"{label}: exit {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s")
    assert proc.returncode == 0, f"{label} failed"
    return out


def _sp_kitti_argv(pth, root) -> list:
    return ["--model", str(pth), "--craft", "--setrans", "--iters",
            str(ITERS), "--device", "cuda", "--dataset", "kitti",
            "--data_root", str(root)]


def sp_rank_main(outdir: str, nccl_only: bool) -> int:
    """One rank of the sequence-parallel phase: the main config's 3 pairs
    (after a warm-up) with the launches and peak memory of this rank; then
    (not nccl_only) one fp32 pair, one BIG_H x BIG_W pair, and the evaluator
    CLI with --seq_parallel on the KITTI tree the parent wrote, mixed and
    --fullprec.  Writes rank<r>[_nccl].json and the flows under outdir."""
    from craft_tpu_torch.parallel import sp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = sp.init("cuda")
    dev, r = group.device, group.rank
    out = Path(outdir)
    tag = f"rank{r}" + ("_nccl" if nccl_only else "")
    res = {"rank": r, "world": group.world, "backend": group.backend,
           "device": str(dev)}
    model = serving_model(dev)
    _, pairs = frame_pairs(dev, 4, seed=0)
    serve(model, pairs[:1], group)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launch_counts()
    times, flows = serve(model, pairs[1:], group)
    res["launches"] = launch.launch_counts()
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["pair_ms"] = times
    _assert_launches(f"sp {tag}", res["launches"], SP_KERNELS, 3)
    torch.save([f.cpu() for f in flows], out / f"{tag}_mixed.pt")
    del model, flows
    if not nccl_only:
        model = create_model(craft_config(mixed_precision=False), device=dev)
        model.load_state_dict(state_dict_from_flax(load_oracle_npz(ORACLE)[3]))
        _, flows = serve(model, pairs[1:2], group)
        torch.save([f.cpu() for f in flows], out / f"{tag}_fp32.pt")
        del model, flows, pairs
        torch.cuda.empty_cache()
        model = serving_model(dev)
        _, big = frame_pairs(dev, 1, seed=8, hw=(BIG_H, BIG_W))
        torch.cuda.reset_peak_memory_stats()
        times, flows = serve(model, big, group)
        res["big"] = {"pair_ms": times, "max_memory_allocated":
                      torch.cuda.max_memory_allocated()}
        torch.save([f.cpu() for f in flows], out / f"{tag}_big.pt")
        del model, flows, big
        torch.cuda.empty_cache()
        argv = _sp_kitti_argv(out / "craft-oracle.pth", out / "data")
        for label, extra in (("mixed", []), ("fp32", ["--fullprec"])):
            launch.reset_launch_counts()
            metrics = evaluate_cli.main(argv + extra + ["--seq_parallel"])
            res[f"kitti_{label}"] = {"metrics": metrics,
                                     "launches": launch.launch_counts()}
            _assert_launches(f"sp {tag} kitti {label}",
                             res[f"kitti_{label}"]["launches"], SP_KERNELS, 2)
    (out / f"{tag}.json").write_text(json.dumps(res))
    print(f"sp {tag}:", json.dumps(res), flush=True)
    return 0


def _max_diff(a, b) -> float:
    return float(max((x.float() - y.float()).abs().max()
                     for x, y in zip(a, b)))


# The training entry point (python -m craft_tpu_torch.train) on a synthetic
# FlyingChairs tree at the dataset's 384x512, written by the port's own PPM
# and .flo writers: the canonical chairs stage's flags.
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
CHAIRS_HW = (384, 512)
# 48 training pairs: the 6 steps below are one epoch of batch 8, so no
# worker restart (the loader's, at each epoch) falls inside the timed steps.
TRAIN_PAIRS, VAL_PAIRS = 48, 4
CLI_STEPS, CLI_VAL_FREQ = 6, 5   # one checkpoint and validation, at step 5
TRAIN_CLI_ARGS = ["--stage", "chairs", "--craft", "--setrans", "--f2", "full",
                  "--mixed_precision", "--lr", "2.5e-4", "--image_size",
                  str(CROP_H), str(CROP_W), "--batch_size", str(TRAIN_BATCH),
                  "--workers", "4", "--iters", str(ITERS), "--name", "smoke"]
DP_TIMEOUT = 300  # seconds for the two CLI ranks


def write_chairs(root, n_train: int, n_val: int, hw, seed: int = 0) -> None:
    """A FlyingChairs tree under root (FlyingChairs_release/data/NNNNN_img1
    .ppm, _img2.ppm, _flow.flo and the split file: the first n_train pairs
    train, the rest validate): noise frames and blockwise-smooth flows of a
    few pixels, written by the port's own codecs."""
    rng = np.random.RandomState(seed)
    data = Path(root) / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    H, W = hw
    for i in range(n_train + n_val):
        for k in (1, 2):
            imgio.write_ppm(str(data / f"{i + 1:05d}_img{k}.ppm"),
                            rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
        coarse = rng.uniform(-4, 4, (H // 16 + 1, W // 16 + 1, 2))
        flow = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:H, :W]
        frame_utils.write_flo(str(data / f"{i + 1:05d}_flow.flo"),
                              flow.astype(np.float32))
    np.savetxt(str(Path(root) / "FlyingChairs_release" /
                   "FlyingChairs_train_val.txt"),
               np.array([1] * n_train + [2] * n_val), fmt="%d")


def _instrumented_cli(argv) -> dict:
    """train_cli.main(argv) with the launch counts set to 0 just before,
    recording each step's host start, the validation's launches and wall
    and the checkpoint saves' walls (each after a synchronize).  Returns
    the final state, the counts of the steps alone and of the validation,
    the upsample_mode each train step was made with, and the step wall
    over steps 2..n (validation and saves taken out)."""
    rec = {"entries": [], "val": [], "saves": [], "modes": []}
    factory, validate, save = (train_cli.make_train_step,
                               train_cli._run_validation,
                               train_cli.save_checkpoint)

    def make_step(*a, **k):
        step = factory(*a, **k)
        rec["modes"].append(k.get("upsample_mode"))

        def timed(state, batch):
            rec["entries"].append(time.perf_counter())
            return step(state, batch)
        return timed

    def counted_validation(*a, **k):
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), launch.launch_counts()
        validate(*a, **k)
        torch.cuda.synchronize()
        rec["val"].append((time.perf_counter() - t0, {
            n: c - before[n] for n, c in launch.launch_counts().items()}))

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(*a, **k)
        rec["saves"].append((t0, time.perf_counter() - t0))

    train_cli.make_train_step = make_step
    train_cli._run_validation = counted_validation
    train_cli.save_checkpoint = timed_save
    try:
        launch.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state = train_cli.main(argv)
    finally:
        train_cli.make_train_step = factory
        train_cli._run_validation = validate
        train_cli.save_checkpoint = save
    total = launch.launch_counts()
    val = {n: sum(v[1][n] for v in rec["val"]) for n in total}
    steps = {n: total[n] - val[n] for n in total}
    out = {"state": state, "steps": steps, "validation": val,
           "upsample_modes": rec["modes"],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    e = rec["entries"]
    if len(e) >= 3:
        # Steps 2..n end where the final save starts (after a sync).
        end = rec["saves"][-1][0]
        inside = sum(v[0] for v in rec["val"]) + sum(
            d for t0, d in rec["saves"][:-1] if t0 > e[1])
        out["step_ms"] = (end - e[1] - inside) / (len(e) - 1) * 1e3
        out["val_s"] = [v[0] for v in rec["val"]]
    return out


def loader_rate(root, n_warm: int = 8, n_batches: int = 24) -> dict:
    """The chairs stage's loader alone (batch 8, 4 worker processes): the
    first batch's wait and the steady batches/s over n_batches after
    n_warm, within one epoch (the tree's list repeated 100 times)."""
    ds = 100 * fetch_training_dataset("chairs", (CROP_H, CROP_W),
                                      data_root=str(root))
    it = iter(MultiprocessLoader(ds, TRAIN_BATCH, num_workers=4, seed=1234))
    t0 = time.perf_counter()
    batch = next(it)
    first = time.perf_counter() - t0
    assert batch["image1"].shape == (TRAIN_BATCH, CROP_H, CROP_W, 3)
    for _ in range(n_warm):
        next(it)
    t1 = time.perf_counter()
    for _ in range(n_batches):
        next(it)
    rate = n_batches / (time.perf_counter() - t1)
    it.close()
    return {"first_batch_s": first, "batches_per_s": rate}


def train_cli_phase(dev, fixed_step_ms) -> dict:
    """The training CLI on the card: (1) CLI_STEPS steps of the chairs stage
    with --val_freq CLI_VAL_FREQ (one checkpoint, one chairs validation on
    VAL_PAIRS pairs), each step's launches those of ``step_launches``;
    B1-B5 during the validation; (2) a resume from that checkpoint with
    --loadopt --loadsched for the last 2 steps, which must end at the
    uninterrupted run's step and learning rate; (3) the loader alone; (4)
    two ranks of the CLI on the one card under torch.distributed.run
    (gloo), 2 steps, only rank 0 writing; (5) 2 steps under --interpos
    lsinu --intrapos lsinu --f2radius F2RADIUS --attn_diag --print_freq 2:
    the diagnostics step at step 0, its status line with the three
    metrics, only B5 and its backward launched; (6) 2 steps with --raft
    (B5 and its backward) and 2 with --upsample_mode final, which the CLI
    trains as packed (the training path's launches).  Prints the CLI's step
    wall beside phase 4's fixed-batch step wall (`fixed_step_ms`), the
    loader's batches/s and the peak memory."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    data = TRAIN_DIR / "data"
    write_chairs(data, TRAIN_PAIRS, VAL_PAIRS, CHAIRS_HW)
    base = TRAIN_CLI_ARGS + ["--data_root", str(data), "--device", str(dev),
                             "--num_steps", str(CLI_STEPS), "--val_freq",
                             str(CLI_VAL_FREQ), "--print_freq", "3"]
    run = _instrumented_cli(base + ["--validation", "chairs", "--output",
                                    str(TRAIN_DIR / "run")])
    steps, val = run["steps"], run["validation"]
    print("train cli: steps' launches", json.dumps(steps))
    print("train cli: validation's launches", json.dumps(val))
    assert run["state"].step == CLI_STEPS
    _assert_launches("train cli", steps, step_launches("main"), CLI_STEPS)
    for name in SERVE_KERNELS:  # the chairs validation, mixed precision
        assert val[name] > 0, f"train cli validation: {name} not launched"
    assert val["corr_lookup"] == ITERS * VAL_PAIRS
    ckpt = TRAIN_DIR / "run" / f"{CLI_VAL_FREQ}_smoke.pth"
    assert ckpt.is_file() and (TRAIN_DIR / "run" / "smoke.pth").is_file()

    resumed = _instrumented_cli(base + [
        "--restore_ckpt", str(ckpt), "--loadopt", "--loadsched", "--output",
        str(TRAIN_DIR / "resumed")])
    a, b = run["state"], resumed["state"]
    lr_a = a.optimizer.param_groups[0]["lr"]
    lr_b = b.optimizer.param_groups[0]["lr"]
    print(f"train cli: resumed at step {b.step} lr {lr_b!r}; uninterrupted "
          f"step {a.step} lr {lr_a!r}")
    assert b.step == a.step and lr_b == lr_a, "train cli: resume"
    # The checkpoint holds step CLI_VAL_FREQ - 1.
    n_resumed = CLI_STEPS - (CLI_VAL_FREQ - 1)
    assert resumed["steps"]["corr_lookup"] == ITERS * n_resumed
    rate = loader_rate(data)

    out = TRAIN_DIR / "ranks"
    log = _run_ranks([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", "-m",
                      "craft_tpu_torch.train", *TRAIN_CLI_ARGS, "--data_root",
                      str(data), "--device", str(dev), "--num_steps", "2",
                      "--output", str(out)], "train cli ranks", DP_TIMEOUT)
    assert "distributed: 2 rank(s), backend gloo" in log
    assert log.count("Parameter Count") == 2
    assert log.count(" saved") == 1, "train cli ranks: rank 1 wrote"
    # (Plots, where matplotlib imports, go there too.)
    assert [f for f in os.listdir(out) if not f.endswith(".png")] == [
        "smoke.pth"]

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dense = _instrumented_cli(TRAIN_CLI_ARGS + [
            "--data_root", str(data), "--device", str(dev), "--num_steps",
            "2", "--val_freq", "1000", "--print_freq", "2", "--interpos",
            "lsinu", "--intrapos", "lsinu", "--f2radius", str(F2RADIUS),
            "--attn_diag", "--output", str(TRAIN_DIR / "dense")])
    log = buf.getvalue()
    print(log, end="")
    print("train cli dense + diag: steps' launches",
          json.dumps(dense["steps"]), "peak", dense["max_memory_allocated"])
    assert dense["state"].step == 2
    _assert_launches("train cli dense", dense["steps"],
                     step_launches("lsinu"), 2)
    status = [ln for ln in log.splitlines() if ln.startswith("[")]
    assert len(status) == 1 and all(
        f"{k} " in status[0] for k in ("attn_max", "attn_clamp_frac",
                                       "attn_avg_abs")), "train cli diag"

    # The other families: --raft, and the main config under
    # --upsample_mode final, which the CLI trains as packed.
    fam = {}
    for label, extra, variant, mode in (
            ("raft", ["--raft"], "raft", "all"),
            ("final", ["--upsample_mode", "final"], "main", "packed")):
        r = _instrumented_cli(TRAIN_CLI_ARGS + extra + [
            "--data_root", str(data), "--device", str(dev), "--num_steps",
            "2", "--val_freq", "1000", "--output", str(TRAIN_DIR / label)])
        print(f"train cli {label}: steps' launches", json.dumps(r["steps"]),
              "modes", r["upsample_modes"], "peak",
              r["max_memory_allocated"])
        assert r["state"].step == 2 and r["upsample_modes"] == [mode]
        _assert_launches(f"train cli {label}", r["steps"],
                         step_launches(variant), 2)
        fam[label] = {"max_memory_allocated": r["max_memory_allocated"],
                      "launches": {k: c for k, c in r["steps"].items() if c}}

    res = {"cli_step_ms": run["step_ms"],
           "cli_steps_per_s": 1e3 / run["step_ms"],
           "fixed_batch_step_ms": fixed_step_ms,
           "host_share": 1.0 - fixed_step_ms / run["step_ms"],
           "loader_batches_per_s": rate["batches_per_s"],
           "loader_first_batch_s": rate["first_batch_s"],
           "validation_s": run["val_s"],
           "max_memory_allocated": run["max_memory_allocated"],
           "families": fam}
    print("train cli:", json.dumps(res))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return res


def sp_paths(dev) -> dict:
    """Phase 4, sequence parallelism.  The unsharded references here (the
    main config's 3 pairs, one fp32 pair, one BIG_H x BIG_W pair, the KITTI
    CLI mixed and --fullprec, with peak memory), then SP_RANKS ranks of
    this script on the one card (gloo) and one NCCL rank; each rank's flows
    against the unsharded ones (0.15 px mixed, 1e-3 px fp32), its launches
    (SP_KERNELS per pair, no B3) and its peak memory (below the unsharded
    peak at 440x1024 and at BIG_H x BIG_W).  The unsharded BIG_H x BIG_W
    pair materialises its intra probs as the ranks do (materialised_probs):
    unsharded it would take the lazy path."""
    shutil.rmtree(SP_DIR, ignore_errors=True)
    SP_DIR.mkdir(parents=True)
    res = {}
    model = serving_model(dev)
    _, pairs = frame_pairs(dev, 4, seed=0)
    serve(model, pairs[:1])
    torch.cuda.reset_peak_memory_stats()
    _, mixed = serve(model, pairs[1:])
    res["unsharded_peak"] = torch.cuda.max_memory_allocated()
    model32 = create_model(craft_config(mixed_precision=False), device=dev)
    model32.load_state_dict(model.state_dict())
    _, fp32 = serve(model32, pairs[1:2])
    del model32, pairs
    torch.cuda.empty_cache()
    _, big = frame_pairs(dev, 1, seed=8, hw=(BIG_H, BIG_W))
    torch.cuda.reset_peak_memory_stats()
    # Its intra probs (8.5e9 B in bf16) would go lazy unsharded; a rank
    # materialises its rows' probs, as the JAX package does under sequence
    # parallelism, so the reference materialises them too.
    with materialised_probs():
        times, big_flow = serve(model, big)
    res["big_unsharded"] = {"pair_ms": times, "max_memory_allocated":
                            torch.cuda.max_memory_allocated()}
    print("sp: unsharded", json.dumps(res))
    ref = {"mixed": [f.cpu() for f in mixed], "fp32": [f.cpu() for f in fp32],
           "big": [f.cpu() for f in big_flow]}
    del model, big, mixed, fp32, big_flow
    torch.cuda.empty_cache()

    # The KITTI tree (H8 = 47: 24/23 rows over two ranks), unsharded CLI.
    _, _, _, tree = load_oracle_npz(ORACLE)
    torch.save({f"module.{k}": v
                for k, v in state_dict_from_flax(tree).items()},
               SP_DIR / "craft-oracle.pth")
    rng = np.random.RandomState(9)
    hw = (KITTI_H, KITTI_W)
    write_kitti_tree(SP_DIR / "data", [(
        rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
        rng.randint(0, 256, (*hw, 3)).astype(np.uint8)) for _ in range(2)],
        [rng.uniform(-10, 10, (*hw, 2)).astype(np.float32)
         for _ in range(2)])
    argv = _sp_kitti_argv(SP_DIR / "craft-oracle.pth", SP_DIR / "data")
    kitti = {label: _timed_cli(f"sp kitti unsharded {label}", argv + extra,
                               2)["metrics"]
             for label, extra in (("mixed", []), ("fp32", ["--fullprec"]))}
    torch.cuda.empty_cache()

    script = str(Path(__file__).resolve())
    _run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(SP_RANKS), script, "--sp-rank",
                str(SP_DIR)], f"sp {SP_RANKS} ranks")
    _run_ranks([sys.executable, script, "--sp-rank", str(SP_DIR),
                "--sp-nccl"], "sp 1 rank nccl")
    ranks = [json.loads((SP_DIR / f"rank{r}.json").read_text())
             for r in range(SP_RANKS)]
    for r, rk in enumerate(ranks):
        assert (rk["world"], rk["backend"]) == (SP_RANKS, "gloo"), rk
        for label, bound in (("mixed", BF16_BOUND_PX),
                             ("fp32", FULLPREC_BOUND_PX),
                             ("big", BF16_BOUND_PX)):
            got = torch.load(SP_DIR / f"rank{r}_{label}.pt")
            err = _max_diff(got, ref[label])
            print(f"sp rank {r} {label}: max |flow diff| against unsharded "
                  f"{err:.3e} px (bound {bound})")
            assert all(bool(torch.isfinite(f).all()) for f in got)
            assert err < bound, f"sp rank {r} {label}"
            rk[f"{label}_err_px"] = err
        for label, bound in (("mixed", BF16_BOUND_PX),
                             ("fp32", FULLPREC_BOUND_PX)):
            got, want = rk[f"kitti_{label}"]["metrics"], kitti[label]
            d_epe = abs(got["kitti_epe"] - want["kitti_epe"])
            d_f1 = abs(got["kitti_f1"] - want["kitti_f1"])
            print(f"sp rank {r} kitti {label}: epe {got['kitti_epe']:.6f} "
                  f"against {want['kitti_epe']:.6f} (|d| {d_epe:.3e}, bound "
                  f"{bound}); f1 {got['kitti_f1']:.4f} against "
                  f"{want['kitti_f1']:.4f} (|d| {d_f1:.3e} points)")
            assert d_epe < bound, f"sp rank {r} kitti {label} epe"
        for label, peak, unsharded in (
                ("440x1024", rk["max_memory_allocated"],
                 res["unsharded_peak"]),
                (f"{BIG_H}x{BIG_W}", rk["big"]["max_memory_allocated"],
                 res["big_unsharded"]["max_memory_allocated"])):
            print(f"sp rank {r} peak memory at {label}: {peak / 1e9:.3f} GB "
                  f"against unsharded {unsharded / 1e9:.3f} GB")
            assert peak < unsharded, f"sp rank {r} peak memory at {label}"
    rank_flows = [torch.load(SP_DIR / f"rank{r}_mixed.pt")
                  for r in range(SP_RANKS)]
    print(f"sp: the ranks' flows differ by "
          f"{_max_diff(rank_flows[0], rank_flows[1]):.3e} px")
    nccl = json.loads((SP_DIR / "rank0_nccl.json").read_text())
    assert (nccl["world"], nccl["backend"]) == (1, "nccl"), nccl
    err = _max_diff(torch.load(SP_DIR / "rank0_nccl_mixed.pt"), ref["mixed"])
    print(f"sp nccl rank: max |flow diff| against unsharded {err:.3e} px "
          f"(bound {BF16_BOUND_PX})")
    assert err < BF16_BOUND_PX, "sp nccl rank"
    res.update(ranks=ranks, nccl=nccl, nccl_err_px=err, kitti=kitti)
    shutil.rmtree(SP_DIR, ignore_errors=True)
    return res


def time_sp_kernels(dev, gen, report, b3_ms) -> None:
    """Phase 5, B9 at the serving shape: sums and write of each shard at
    n = 2 and 4 beside the plain versions and each shard's bound (one q.k^T
    sweep of its rows; q, k read once, the sums or its bf16 rows written
    once), their sum over the shards beside B3 (b3_ms); the kernels line
    takes n = 2's larger shard."""
    from craft_tpu_torch.parallel.sp import row_split
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    q, k = inputs(gen, 64, dev)
    agg = (torch.tensor(AGG_WB[0], device=dev),
           torch.tensor(AGG_WB[1], device=dev))
    grid = (H8, W8)
    gmax = ma.scores_global_max(q, k, 0.125)
    sums = ma.fused_agg_corr_norm_plain(q, k, biases, grid, 100.0, 0.5,
                                        *agg)[1][:, 0, 1:3].double() * U * U
    for world in (2, 4):
        total = 0.0
        for rank in range(world):
            h0, h1 = row_split(H8, world, rank)
            ql = q[:, :, h0 * W8:h1 * W8].contiguous()
            u1 = ql.shape[2]
            flops = 2.0 * 4 * u1 * U * 64
            qk = 2 * 4 * (u1 + U) * 64
            sargs = (ql, k, biases, grid, gmax, 100.0, 0.5, *agg)
            wargs = (ql, k, biases, grid, gmax, sums, 100.0, 0.5, *agg)
            cases = {
                "corr_norm_sums": (
                    lambda: ma.corr_norm_sums(*sargs, q_row0=h0),
                    lambda: ma.corr_norm_sums_plain(*sargs, q_row0=h0),
                    bound_ms(flops, qk + 16)),
                "corr_norm_write": (
                    lambda: ma.corr_norm_write(*wargs, q_row0=h0),
                    lambda: ma.corr_norm_write_plain(
                        *wargs[:6], float(U) * U, *wargs[6:], q_row0=h0),
                    bound_ms(flops, qk + 2 * u1 * U)),
            }
            for name, (kern, plain, (bms, by)) in cases.items():
                ms, pms = time_ms(kern, 5), time_ms(plain, 2)
                total += ms
                print(f"{name} n={world} rows {h0}:{h1}: {ms:.3f} ms, plain "
                      f"{pms:.3f} ms, bound {bms:.4f} ms ({by})")
                if world == 2 and rank == 0:
                    report[name].update(ms=ms, plain_ms=pms, library_ms=None,
                                        bound_ms=bms, bound_by=by)
            torch.cuda.empty_cache()
        print(f"B9 n={world}: sums + write over the shards {total:.3f} ms "
              f"against B3 {b3_ms:.3f} ms")


# Phase 4, sequence parallelism of every configuration the evaluator takes
# beside full CRAFT with the sliding bias: two ranks of this script
# (--sp-config-rank) under torch.distributed.run on the one card (gloo),
# each configuration of SP_CONFIG_KERNELS at 440x1024, mixed, against the
# unsharded forward of this process.  Per rank and pair, the launches:
#   lsinu           B1 3, B8 1, B6 dense 1, B4 dense 1, B5 12
#   --f2radius 7    B1 3, B8 1, B9 sums 1 + write 1, B4 int8 1, B5 12
#   --f1            B1 5, B2 2, B9 2 + 2, B4 int8 1, B5 12 (at D = 2)
#   RAFT, GMA       B5 12
#   CRAFT with GMA attention, craft_nogma
#                   B1 2, B2 1, B9 1 + 1, B5 12
#   --f2 none       B1 2, B9 1 + 1, B4 int8 1, B5 12
SP_CONFIG_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_sp_configs"
_SP_TWO_WAY = {"scores_global_max": 5, "flash_mode_attention": 2,
               "corr_norm_sums": 2, "corr_norm_write": 2,
               "mode_softmax_probs": 1, "corr_lookup": ITERS}
_SP_F2_INTER = {"scores_global_max": 2, "flash_mode_attention": 1,
                "corr_norm_sums": 1, "corr_norm_write": 1,
                "corr_lookup": ITERS}
SP_CONFIG_KERNELS = {
    "lsinu": LSINU_KERNELS,
    "f2radius": {"scores_global_max": 3, "flash_mode_attention_dense": 1,
                 "corr_norm_sums": 1, "corr_norm_write": 1,
                 "mode_softmax_probs": 1, "corr_lookup": ITERS},
    "f1_shared": _SP_TWO_WAY,
    "f1_private": _SP_TWO_WAY,
    "raft": {"corr_lookup": ITERS},
    "gma_pc": {"corr_lookup": ITERS},
    "craft_gma": _SP_F2_INTER,
    "craft_nogma": _SP_F2_INTER,
    "craft_f2_none": {"scores_global_max": 2, "corr_norm_sums": 1,
                      "corr_norm_write": 1, "mode_softmax_probs": 1,
                      "corr_lookup": ITERS},
}
SP_CONFIG_PAIRS = 3
SP_CONFIG_FP32 = ("lsinu", "gma_pc")  # also one fp32 pair
SP_CONFIG_BIG = ("lsinu", "gma_pc")   # also one BIG_H x BIG_W pair
# The evaluator CLI with --seq_parallel over the KITTI tree (47 rows:
# 24/23), mixed.
SP_CONFIG_CLI = {"f1_private": ["--craft", "--setrans", "--f1", "private"],
                 "raft": ["--raft"]}


def sp_config_weights(name: str, mixed_precision: bool):
    """(config, state_dict) of SP_CONFIG_KERNELS' `name`: the variants'
    (variant_weights), GMA with --position_and_content (gma_pc: GMA's
    family weights; the flag adds no parameter) and the families'."""
    if name in ("lsinu", "f2radius", *TWO_WAY):
        return variant_weights(name, mixed_precision)
    if name == "gma_pc":
        return (gma_config(mixed_precision=mixed_precision).replace(
            position_and_content=True), family_weights("gma"))
    return FAMILIES[name](mixed_precision), family_weights(name)


def sp_config_model(dev, name: str, mixed_precision: bool):
    cfg, sd = sp_config_weights(name, mixed_precision)
    model = create_model(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    return model


def _sp_config_argv(name: str) -> list:
    return ["--model", str(SP_CONFIG_DIR / f"{name}.pth"),
            *SP_CONFIG_CLI[name], "--iters", str(ITERS), "--device", "cuda",
            "--dataset", "kitti", "--data_root", str(SP_CONFIG_DIR / "data")]


def sp_config_rank_main(outdir: str) -> int:
    """One rank of the configurations' sequence-parallel phase: each
    configuration's SP_CONFIG_PAIRS pairs after a warm-up (launches,
    event ms, the profiler's device ms of one more pair, peak memory),
    one fp32 pair of SP_CONFIG_FP32's, one BIG_H x BIG_W pair of
    SP_CONFIG_BIG's, and the evaluator CLI of SP_CONFIG_CLI's on the KITTI
    tree the parent wrote.  Writes rank<r>.json and the flows under
    outdir."""
    from craft_tpu_torch.parallel import sp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = sp.init("cuda")
    dev, r = group.device, group.rank
    out = Path(outdir)
    res = {"rank": r, "world": group.world, "backend": group.backend}
    _, pairs = frame_pairs(dev, SP_CONFIG_PAIRS + 1, seed=4)
    for name, per_pair in SP_CONFIG_KERNELS.items():
        model = sp_config_model(dev, name, True)
        serve(model, pairs[:1], group)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        launch.reset_launch_counts()
        times, flows = serve(model, pairs[1:], group)
        counts = launch.launch_counts()
        rr = {"pair_ms": times,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": {k: c for k, c in counts.items() if c}}
        _assert_launches(f"sp {name} rank{r}", counts, per_pair,
                         SP_CONFIG_PAIRS)
        rr["pair_device_ms"] = device_ms(
            lambda: serve(model, pairs[1:2], group), 1)
        torch.save([f.cpu() for f in flows], out / f"rank{r}_{name}_mixed.pt")
        del model, flows
        if name in SP_CONFIG_FP32:
            model = sp_config_model(dev, name, False)
            _, flows = serve(model, pairs[1:2], group)
            torch.save([f.cpu() for f in flows],
                       out / f"rank{r}_{name}_fp32.pt")
            del model, flows
        torch.cuda.empty_cache()
        res[name] = rr
        print(f"sp {name} rank{r}:", json.dumps(rr), flush=True)
    del pairs
    for name in SP_CONFIG_BIG:
        model = sp_config_model(dev, name, True)
        _, big = frame_pairs(dev, 1, seed=8, hw=(BIG_H, BIG_W))
        torch.cuda.reset_peak_memory_stats()
        times, flows = serve(model, big, group)
        res[f"{name}_big"] = {"pair_ms": times, "max_memory_allocated":
                              torch.cuda.max_memory_allocated()}
        torch.save([f.cpu() for f in flows], out / f"rank{r}_{name}_big.pt")
        del model, big, flows
        torch.cuda.empty_cache()
    for name in SP_CONFIG_CLI:
        launch.reset_launch_counts()
        metrics = evaluate_cli.main(_sp_config_argv(name) + ["--seq_parallel"])
        counts = launch.launch_counts()
        _assert_launches(f"sp {name} kitti rank{r}", counts,
                         SP_CONFIG_KERNELS[name], 2)
        res[f"{name}_kitti"] = {"metrics": metrics, "launches": {
            k: c for k, c in counts.items() if c}}
    (out / f"rank{r}.json").write_text(json.dumps(res))
    print(f"sp configs rank{r}:", json.dumps(res), flush=True)
    return 0


def sp_configs_phase(dev) -> dict:
    """Phase 4, the configurations' sequence parallelism: the unsharded
    references here (each configuration's pairs, event and device ms;
    the fp32 and big pairs, with the big pairs' peak memory; the KITTI
    CLI's metrics), then SP_RANKS ranks of this script on the one card;
    each rank's flows against the unsharded ones (BF16_BOUND_PX mixed,
    FULLPREC_BOUND_PX fp32), its launches (asserted in the rank), its peak
    below the unsharded one at BIG_H x BIG_W and its CLI metrics against
    the unsharded CLI's."""
    t0 = time.perf_counter()
    shutil.rmtree(SP_CONFIG_DIR, ignore_errors=True)
    SP_CONFIG_DIR.mkdir(parents=True)
    _, pairs = frame_pairs(dev, SP_CONFIG_PAIRS + 1, seed=4)
    ref, unsharded = {}, {}
    for name in SP_CONFIG_KERNELS:
        model = sp_config_model(dev, name, True)
        serve(model, pairs[:1])
        times, flows = serve(model, pairs[1:])
        unsharded[name] = {"pair_ms": times, "pair_device_ms": device_ms(
            lambda: serve(model, pairs[1:2]), 1)}
        ref[name, "mixed"] = [f.cpu() for f in flows]
        del model, flows
        if name in SP_CONFIG_FP32:
            model = sp_config_model(dev, name, False)
            ref[name, "fp32"] = [f.cpu() for f in serve(model,
                                                         pairs[1:2])[1]]
            del model
        torch.cuda.empty_cache()
    del pairs
    for name in SP_CONFIG_BIG:
        model = sp_config_model(dev, name, True)
        _, big = frame_pairs(dev, 1, seed=8, hw=(BIG_H, BIG_W))
        torch.cuda.reset_peak_memory_stats()
        times, flows = serve(model, big)
        unsharded[f"{name}_big"] = {"pair_ms": times, "max_memory_allocated":
                                    torch.cuda.max_memory_allocated()}
        ref[name, "big"] = [f.cpu() for f in flows]
        del model, big, flows
        torch.cuda.empty_cache()
    print("sp configs: unsharded", json.dumps(unsharded))
    rng = np.random.RandomState(9)
    hw = (KITTI_H, KITTI_W)
    write_kitti_tree(SP_CONFIG_DIR / "data", [(
        rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
        rng.randint(0, 256, (*hw, 3)).astype(np.uint8)) for _ in range(2)],
        [rng.uniform(-10, 10, (*hw, 2)).astype(np.float32)
         for _ in range(2)])
    kitti = {}
    for name in SP_CONFIG_CLI:
        torch.save({f"module.{k}": v for k, v in
                    sp_config_weights(name, False)[1].items()},
                   SP_CONFIG_DIR / f"{name}.pth")
        kitti[name] = _timed_cli(f"sp kitti unsharded {name}",
                                 _sp_config_argv(name), 2)["metrics"]
    torch.cuda.empty_cache()

    _run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(SP_RANKS),
                str(Path(__file__).resolve()), "--sp-config-rank",
                str(SP_CONFIG_DIR)],
               f"sp configs {SP_RANKS} ranks")
    ranks = [json.loads((SP_CONFIG_DIR / f"rank{r}.json").read_text())
             for r in range(SP_RANKS)]
    for r, rk in enumerate(ranks):
        assert (rk["world"], rk["backend"]) == (SP_RANKS, "gloo"), rk
        for (name, label), want in ref.items():
            bound = FULLPREC_BOUND_PX if label == "fp32" else BF16_BOUND_PX
            got = torch.load(SP_CONFIG_DIR / f"rank{r}_{name}_{label}.pt")
            err = _max_diff(got, want)
            print(f"sp {name} rank {r} {label}: max |flow diff| against "
                  f"unsharded {err:.3e} px (bound {bound})")
            assert all(bool(torch.isfinite(f).all()) for f in got)
            assert err < bound, f"sp {name} rank {r} {label}"
            rk.setdefault("err_px", {})[f"{name}_{label}"] = err
        for name in SP_CONFIG_BIG:
            peak = rk[f"{name}_big"]["max_memory_allocated"]
            whole = unsharded[f"{name}_big"]["max_memory_allocated"]
            print(f"sp {name} rank {r} peak memory at {BIG_H}x{BIG_W}: "
                  f"{peak / 1e9:.3f} GB against unsharded {whole / 1e9:.3f} "
                  f"GB")
            assert peak < whole, f"sp {name} rank {r} peak memory"
        for name, want in kitti.items():
            got = rk[f"{name}_kitti"]["metrics"]
            d_epe = abs(got["kitti_epe"] - want["kitti_epe"])
            print(f"sp {name} rank {r} kitti: epe {got['kitti_epe']:.6f} "
                  f"against {want['kitti_epe']:.6f} (|d| {d_epe:.3e}, bound "
                  f"{BF16_BOUND_PX}); f1 {got['kitti_f1']:.4f} against "
                  f"{want['kitti_f1']:.4f}")
            assert d_epe < BF16_BOUND_PX, f"sp {name} rank {r} kitti epe"
    for name in SP_CONFIG_KERNELS:
        flows = [torch.load(SP_CONFIG_DIR / f"rank{r}_{name}_mixed.pt")
                 for r in range(SP_RANKS)]
        print(f"sp {name}: the ranks' flows differ by "
              f"{_max_diff(flows[0], flows[1]):.3e} px; rank 0 pair ms "
              f"{ranks[0][name]['pair_ms']}, device ms "
              f"{ranks[0][name]['pair_device_ms']:.3f} (unsharded "
              f"{unsharded[name]['pair_ms']}, device ms "
              f"{unsharded[name]['pair_device_ms']:.3f}) | {card_line()}")
    shutil.rmtree(SP_CONFIG_DIR, ignore_errors=True)
    print(f"sp configs phase: {time.perf_counter() - t0:.1f} s")
    return {"unsharded": unsharded, "ranks": ranks, "kitti": kitti}


def time_sp_dense_kernels(dev, gen) -> None:
    """Phase 5, B8, B6 dense and B4 dense at the shard shapes of the
    serving grid over two ranks (rows 0:28 and 28:55), as the lsinu path
    runs them (no table) and B8 as --f2radius runs it (the shard's rows of
    its table), beside the plain versions and the bounds (each input read
    once, the output written once), over CUDA events.  These calls are
    shorter than their wrappers' host work, so the events time the host;
    their device times come from tools/time_window_kernels.py (the
    profiler of a fresh process: late in this run it drops records of the
    kernels launched through ctypes)."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    q, k = inputs(gen, 64, dev)
    qi, ki = inputs(gen, 32, dev)
    v = torch.randn(1, 4, U, 256, generator=gen).to(dev, torch.bfloat16)
    clip = torch.tensor(1e30, device=dev)
    for h0, h1 in (row_split(H8, 2, r) for r in range(2)):
        u0, u1 = h0 * W8, (h1 - h0) * W8
        ql, qil = q[:, :, u0:u0 + u1], qi[:, :, u0:u0 + u1]
        table = f2_table_rows(biases, (H8, W8), dev, h0, h1 - h0)
        n = 4.0 * u1 * U
        qk = lambda md: 2 * 4 * (u1 + U) * md  # noqa: E731
        cases = {
            "flash_mode_attention_dense": (
                lambda: ma.flash_mode_attention_dense(ql, k, v, None, clip,
                                                      0.5),
                lambda: ma.flash_mode_attention_dense_plain(ql, k, v, None,
                                                            clip, 0.5),
                bound_ms(2.0 * n * (64 + 256),
                         qk(64) + 2 * 4 * U * 256 + 2 * 4 * u1 * 256)),
            "flash_mode_attention_dense table": (
                lambda: ma.flash_mode_attention_dense(ql, k, v, table, clip,
                                                      1.0),
                lambda: ma.flash_mode_attention_dense_plain(ql, k, v, table,
                                                            clip, 1.0),
                bound_ms(2.0 * n * (64 + 256),
                         qk(64) + 2 * 4 * U * 256 + 2 * 4 * u1 * 256
                         + 4 * u1 * U)),
            "fused_agg_corr_dense": (
                lambda: cv.fused_agg_corr_dense(ql, k, None, clip, 0.5,
                                                *AGG_WB),
                lambda: cv.fused_agg_corr_dense_plain(ql, k, None, clip, 0.5,
                                                      *AGG_WB),
                bound_ms(2.0 * n * 64, qk(64) + 4 * u1 * U)),
            "mode_softmax_probs_dense": (
                lambda: ma.mode_softmax_probs_dense(qil, ki, None, clip, 1.0),
                lambda: ma.mode_softmax_probs_dense_plain(qil, ki, None, clip,
                                                          1.0),
                bound_ms(2.0 * n * 32, qk(32) + 2 * n)),
        }
        for name, (kern, plain, (bms, by)) in cases.items():
            ms, pms = time_ms(kern, 5), time_ms(plain, 2)
            print(f"{name} shard rows {h0}:{h1} (U1 {u1}, U2 {U}): "
                  f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms "
                  f"({by}) | {card_line()}")
        del table
        torch.cuda.empty_cache()


def time_kitti_kernels(dev, gen) -> None:
    """Phase 5, the KITTI evaluation shape (376x1248: H8 = 47, W8 = 156,
    U = 7332, B = 1): B2-B4 beside their plain versions and bounds."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    grid = KITTI_GRID
    u = grid[0] * grid[1]
    clip = torch.tensor(1e30, device=dev)
    q64, k64 = inputs(gen, 64, dev, u)
    q32, k32 = inputs(gen, 32, dev, u)
    v = torch.randn(1, 4, u, 256, generator=gen).to(dev, torch.bfloat16)
    one = torch.tensor(1.0, device=dev)
    n = 4 * u * u
    qk_bytes = lambda md: 2 * 4 * u * md * 2  # noqa: E731
    cases = {
        "flash_mode_attention": (
            (q64, k64, v, biases, grid, clip, 0.5), {},
            bound_ms(2.0 * n * 64 + 2.0 * n * 256,
                     qk_bytes(64) + 2 * 2 * 4 * u * 256)),
        "fused_agg_corr_norm": (
            (q64, k64, biases, grid, 100.0, 0.5, one, one), {},
            bound_ms(2.0 * n * 64, qk_bytes(64) + 2 * u * u + 16)),
        "mode_softmax_probs": (
            (q32, k32, biases, grid, clip, 1.0), {"quantized": True},
            bound_ms(2.0 * n * 32, qk_bytes(32) + n + 4 * 4 * u)),
    }
    for name, (args, kw, (bms, by)) in cases.items():
        kern = getattr(ma, name)
        plain = getattr(ma, name + "_plain")
        ms = time_ms(lambda: kern(*args, **kw), 5)
        pms = time_ms(lambda: plain(*args, **kw), 2)
        print(f"{name} (KITTI, U={u}, W8={grid[1]}): {ms:.3f} ms, plain "
              f"{pms:.3f} ms, bound {bms:.4f} ms ({by})")
        torch.cuda.empty_cache()
    print(f"mode_softmax_probs (KITTI): exponentials floor {sfu_ms(n):.4f} ms")


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
    print(f"fused_agg_corr (chairs, B=8): exponentials floor {exp_ms(n):.4f} "
          "ms (4 B U^2 on the SFUs)")
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
    print(f"mode_softmax_probs (chairs, B=8): exponentials floor "
          f"{sfu_ms(n):.4f} ms")


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
        if lib is not None:
            print(f"{name}: {r['library_ms'] / r['ms']:.3f} x the speed of "
                  "its library call")
        torch.cuda.empty_cache()
    print(f"mode_softmax_probs: exponentials floor {sfu_ms(n):.4f} ms "
          "(2 M U^2 on the SFUs)")
    md32 = time_ms(lambda: ma.scores_global_max(q32, k32, 0.17677669), 5)
    print(f"scores_global_max at the intra shape (md 32): {md32:.3f} ms")
    # Device times: B1 alone, and B3's sweeps and moments without the B1
    # launch of its phase 0 (which B1's launches count).
    for label, fn, match in (
            ("scores_global_max md 64", cases["scores_global_max"][0], None),
            ("scores_global_max md 32",
             lambda: ma.scores_global_max(q32, k32, 0.17677669), None),
            ("fused_agg_corr_norm sweeps and moments",
             cases["fused_agg_corr_norm"][0], ("corr_",))):
        print(f"{label}: device {device_ms(fn, 5, match):.4f} ms")


# Phase 5, B2 at F 128 where the lazy intra path runs it: a Sintel batch of
# 11 (the first bf16 batch past the threshold) and HD1K (B = 1).
B2_LAZY_TIMED = (("Sintel batch 11", 11, (H8, W8)), ("HD1K", 1, HD1K_GRID))
CHUNK_ROWS = 8  # grid rows a chunk of the plain version at HD1K


def window_mask(biases, grid, pos_w, chunk=CHUNK_ROWS) -> torch.Tensor:
    """pos_w * the dense window table [U, U] in bf16, built a chunk of
    grid rows at a time (scaled_dot_product_attention's mask)."""
    H, W = grid
    mask = torch.empty(H * W, H * W, dtype=torch.bfloat16,
                       device=biases.device)
    for h0 in range(0, H, chunk):
        rows = min(chunk, H - h0)
        mask[h0 * W:(h0 + rows) * W] = pos_w * ma.sliding_pos_biases(
            biases, H, W, h0, rows)
    return mask


def time_b2_lazy(dev, gen, report) -> None:
    """Phase 5: B2 at F 128, md 32 at each B2_LAZY_TIMED shape beside its
    plain version (in chunks of grid rows where a whole plain run would not
    fit: [B, M, U, U] fp32 scores twice over), its bound, the exponentials'
    floor and scaled_dot_product_attention with the window as its mask;
    the HD1K numbers go into the kernels line."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    clip = torch.tensor(1e30, device=dev)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    for label, batch, grid in B2_LAZY_TIMED:
        u = grid[0] * grid[1]
        q, k = inputs(gen, LAZY_MD, dev, u, batch)
        v = torch.randn(batch, 4, u, LAZY_F, generator=gen).to(
            dev, torch.bfloat16)
        n = batch * 4 * u * u
        bms, by = bound_ms(2.0 * n * (LAZY_MD + LAZY_F),
                           2 * batch * 4 * u * LAZY_MD * 2
                           + 2 * batch * 4 * u * LAZY_F * 2)
        args = (q, k, v, biases, grid, clip, LAZY_POS_W)
        ms = time_ms(lambda: ma.flash_mode_attention(*args), 5)
        # The plain version holds about four [B, M, U, U] fp32 tensors.
        if 4 * 4 * n < 0.6 * free:
            plain_ms = time_ms(lambda: ma.flash_mode_attention_plain(*args),
                               1)
            plain_how = "whole"
        else:
            def chunked():
                for h0 in range(0, grid[0], CHUNK_ROWS):
                    t = slice(h0 * grid[1],
                              min(h0 + CHUNK_ROWS, grid[0]) * grid[1])
                    ma.flash_mode_attention_plain(
                        q[:, :, t], k, v, biases, grid, clip, LAZY_POS_W,
                        q_row0=h0)
            plain_ms = time_ms(chunked, 1)
            plain_how = (f"in chunks of {CHUNK_ROWS} grid rows: whole it "
                         f"needs about {4 * 4 * n / 1e9:.0f} GB")
        torch.cuda.empty_cache()
        mask = window_mask(biases, grid, LAZY_POS_W)
        try:
            lib_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 3)
            lib_how = "the window as its mask"
        except torch.cuda.OutOfMemoryError as e:
            lib_ms, lib_how = None, f"does not fit: {str(e)[:160]}"
        del mask
        torch.cuda.empty_cache()
        print(f"flash_mode_attention F={LAZY_F} md={LAZY_MD} ({label}, "
              f"B={batch}, U={u}): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms ({plain_how}), bound {bms:.4f} ms ({by}), "
              f"exponentials floor {exp_ms(n):.4f} ms, "
              f"scaled_dot_product_attention {lib_ms} ms ({lib_how}) |",
              card_line())
        if label == "HD1K":
            report["flash_mode_attention_f128"].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)
        del q, k, v, args
        torch.cuda.empty_cache()


def time_dense_kernels(dev, gen, report) -> None:
    """Phase 5, the dense-table kernels at the serving shapes (B=1, U=7040),
    beside the plain versions and the bounds, as the lsinu path runs them
    (no table; B4 dense with bf16 output), and B8 and B6 dense with the
    --f2radius F2RADIUS table (pos_w * the dense window + the mask), B8
    beside scaled_dot_product_attention with that table as its float
    attn_mask (clip off).  The B8 row of the kernels line takes the table
    case, the B6 dense row the lsinu path's (no table)."""
    from craft_tpu_torch.nn.setrans import attention_mask
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    clip = torch.tensor(CLIP_OFF, device=dev)
    q64, k64 = inputs(gen, 64, dev)
    q32, k32 = inputs(gen, 32, dev)
    v = torch.randn(1, 4, U, 256, generator=gen).to(dev, torch.bfloat16)
    table = (0.5 * ma.sliding_pos_biases(biases, H8, W8)
             + attention_mask(H8, W8, F2RADIUS, dev))
    mask = table.to(torch.bfloat16)
    n = 4 * U * U
    qk_flops = lambda md: 2.0 * n * md  # noqa: E731
    qk_bytes = lambda md: 2 * 4 * U * md * 2  # noqa: E731
    v_bytes = 2 * 2 * 4 * U * 256  # v read, out written, bf16
    agg = (torch.tensor(AGG_WB[0], device=dev),
           torch.tensor(AGG_WB[1], device=dev))
    cases = {
        "flash_mode_attention_dense": (
            lambda: ma.flash_mode_attention_dense(q64, k64, v, table, clip,
                                                  1.0),
            lambda: ma.flash_mode_attention_dense_plain(q64, k64, v, table,
                                                        clip, 1.0),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q64, k64, v, attn_mask=mask),
            bound_ms(qk_flops(64) + 2.0 * n * 256,
                     qk_bytes(64) + v_bytes + 4 * U * U)),
        "flash_mode_attention_dense no table": (
            lambda: ma.flash_mode_attention_dense(q64, k64, v, None, clip,
                                                  0.5),
            lambda: ma.flash_mode_attention_dense_plain(q64, k64, v, None,
                                                        clip, 0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q64, k64, v),
            bound_ms(qk_flops(64) + 2.0 * n * 256, qk_bytes(64) + v_bytes)),
        "fused_agg_corr_dense": (
            lambda: cv.fused_agg_corr_dense(q64, k64, None, clip, 0.5, *agg),
            lambda: cv.fused_agg_corr_dense_plain(q64, k64, None, clip, 0.5,
                                                  *agg),
            None, bound_ms(qk_flops(64), qk_bytes(64) + 4 * U * U)),
        "fused_agg_corr_dense table": (
            lambda: cv.fused_agg_corr_dense(q64, k64, table, clip, 0.5, *agg),
            lambda: cv.fused_agg_corr_dense_plain(q64, k64, table, clip, 0.5,
                                                  *agg),
            None, bound_ms(qk_flops(64), qk_bytes(64) + 2 * 4 * U * U)),
        "mode_softmax_probs_dense": (
            lambda: ma.mode_softmax_probs_dense(q32, k32, None, clip, 1.0),
            lambda: ma.mode_softmax_probs_dense_plain(q32, k32, None, clip,
                                                      1.0),
            None, bound_ms(qk_flops(32), qk_bytes(32) + 2 * n)),
    }
    for name, (kern, plain, lib, (bms, by)) in cases.items():
        ms, pms = time_ms(kern, 5), time_ms(plain, 2)
        lms = time_ms(lib, 5) if lib is not None else None
        print(f"{name}: {ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms "
              f"({by}), library {lms}")
        if lms is not None:
            print(f"{name}: {lms / ms:.3f} x the speed of its library call")
        if name in report:
            report[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                bound_ms=bms, bound_by=by)
        torch.cuda.empty_cache()
    print(f"mode_softmax_probs_dense: exponentials floor {sfu_ms(n):.4f} ms")
    print(f"fused_agg_corr_dense: exponentials floor {exp_ms(n):.4f} ms "
          "(4 U^2 on the SFUs)")


def window_elems(levels, coords, r=RADIUS, dim=1) -> int:
    """Level values that this run's windows must read: per query and plane
    (`dim` planes a level), the (2r+2)^2 corners that lie inside it."""
    flat = coords.reshape(-1, 2).float()
    total = 0
    for i, lv in enumerate(levels):
        h, w = lv.shape[1], lv.shape[2]
        lo = torch.floor(flat / 2.0 ** (i // dim)) - r

        def span(start, size):
            return ((start + 2 * r + 2).clamp(max=size)
                    - start.clamp(min=0)).clamp(min=0)
        total += int((span(lo[:, 0], w) * span(lo[:, 1], h)).sum())
    return total


def _grid_sample_args(levels, coords, g, r=RADIUS, dim=1):
    """Per plane (`dim` planes a level): the fp32 plane [Q, 1, h, w], the
    grid of its window taps normalized for F.grid_sample(align_corners=True)
    [Q, n, n, 2] (the reference's bilinear_sampler, corr.py:47-71: axis 1
    offsets x, axis 2 y) and that plane's output cotangent [Q, 1, n, n]."""
    n = 2 * r + 1
    Q = coords.numel() // 2
    flat = coords.reshape(Q, 1, 1, 2).float()
    d = torch.arange(-r, r + 1, device=coords.device, dtype=torch.float32)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)[None]
    args = []
    for i, lv in enumerate(levels):
        h, w = lv.shape[1], lv.shape[2]
        xy = flat / 2.0 ** (i // dim) + delta
        grid = torch.stack([2 * xy[..., 0] / (w - 1) - 1,
                            2 * xy[..., 1] / (h - 1) - 1], -1)
        gl = g.reshape(Q, len(levels), n, n)[:, i, None].contiguous()
        args.append((lv.float()[:, None].contiguous(), grid, gl))
    return args


def time_lookup(dev, report, dim: int = 1) -> None:
    """Phase 5, B5: forward and backward at the serving and chairs shapes,
    beside the plain versions, the bounds and the library: per plane
    F.grid_sample (forward) and its backward (aten.grid_sampler_2d_backward),
    on fp32 copies of the planes made outside the timing.  The forward row
    of the kernels line takes the serving shape, the backward row the
    chairs shape (the backward runs only in training).  With dim = 2 the
    two-way pyramid's 8 planes (the rows corr_lookup_d2 and
    corr_lookup_bwd_d2)."""
    F = torch.nn.functional
    n2 = (2 * RADIUS + 1) ** 2
    suffix = "" if dim == 1 else f"_d{dim}"
    for label, batch, h8, w8, dtype in LOOKUP_SHAPES[:2]:
        levels, coords = (lookup_inputs if dim == 1 else lookup_planes)(
            dev, batch, h8, w8, dtype)
        Q = coords.numel() // 2
        P = len(levels)
        shapes = [tuple(lv.shape) for lv in levels]
        g = torch.randn(batch, h8, w8, P * n2, device=dev)
        isz = levels[0].element_size()
        taps = Q * P * n2
        out_b, g_b = 4 * taps, 4 * taps
        fwd_bytes = window_elems(levels, coords, dim=dim) * isz + 8 * Q \
            + out_b
        bwd_bytes = g_b + 8 * Q + isz * sum(lv.numel() for lv in levels)
        lib = _grid_sample_args(levels, coords, g, dim=dim)
        want = lk.corr_lookup_plain(levels, coords, RADIUS, dim)
        got_lib = torch.cat([F.grid_sample(x, gr, align_corners=True)
                             .reshape(batch, h8, w8, n2)
                             for x, gr, _ in lib], -1)
        lib_err = float((got_lib - want).abs().max())
        print(f"B5{suffix} {label}: grid_sample against the plain version "
              f"{lib_err:.3e}")
        assert lib_err < 1e-3 * float(want.abs().max()), "grid_sample"
        del want, got_lib
        cases = {
            "corr_lookup": (
                lambda: lk.corr_lookup(levels, coords, RADIUS, dim),
                lambda: lk.corr_lookup_plain(levels, coords, RADIUS, dim),
                lambda: [F.grid_sample(x, gr, align_corners=True)
                         for x, gr, _ in lib],
                bound_ms(12.0 * taps, fwd_bytes, FP32_TFLOPS)),
            "corr_lookup_bwd": (
                lambda: lk.corr_lookup_bwd(coords, g, shapes, dtype, RADIUS,
                                           dim),
                lambda: lk.corr_lookup_bwd_plain(coords, g, shapes, dtype,
                                                 RADIUS, dim),
                lambda: [torch.ops.aten.grid_sampler_2d_backward(
                    gl, x, gr, 0, 0, True, [True, False])
                    for x, gr, gl in lib],
                bound_ms(16.0 * taps, bwd_bytes, FP32_TFLOPS)),
        }
        for name, (kern, plain, libf, (bms, by)) in cases.items():
            ms, pms, lms = time_ms(kern, 20), time_ms(plain, 5), \
                time_ms(libf, 10)
            print(f"{name}{suffix} ({label}, {dtype}): {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), library "
                  f"{lms:.4f} ms")
            if (name == "corr_lookup") == (label == "serving"):
                report[name + suffix].update(ms=ms, plain_ms=pms,
                                             library_ms=lms, bound_ms=bms,
                                             bound_by=by)
        del lib, levels, g
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# B10, the fused SepConvGRU pass (phases 2, 4 and 5)
# ---------------------------------------------------------------------------

# (label, batch, H8, W8) of a served pair (440x1024) and a chairs training
# batch (368x496, batch 8); the GRU's full width: hidden 128, x = inp 128 +
# motion 128 + aggregated motion 128.
GRU_GRIDS = (("serving", 1, H8, W8), ("chairs", TRAIN_BATCH, *CHAIRS_GRID))
# Phase 2 also checks a ragged grid: 2 x 37 x 61 = 4514 rows, a multiple
# neither of the backward's 128-row tiles nor of its 64-row weight-gradient
# steps, in two row splits of 2304 and 2210 rows.
GRU_CHECK_GRIDS = GRU_GRIDS + (("ragged", 2, 37, 61),)
GRU_CH, GRU_CX = 128, 384
# max |kernel - plain| / max |plain| per tensor: (io outputs h', z, r, q,
# dh, dx; fp32 weight and bias gradients).  fp32: sums of 5 (Ch + Cx) =
# 2560 products (22,816 rows for a weight gradient) in another order, well
# under 1e-4 of the largest value.  bf16: an io output may round one ulp
# the other way (2^-7 of the largest value at most) where the two fp32 sums
# straddle a rounding boundary; the weight and bias gradients are fp32 sums
# of exact products of the same bf16 operands, of which those that
# straddled a boundary (dqh, dzh, drhat) move one term of a sum of
# thousands by 2^-8 of itself.
B10_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
B10_FAULTS = ("no row mask", "q over h", "blend reversed",
              "r h halo dropped", "halo rows twice", "no drh r term")
B10_FWD_FAULTS = B10_FAULTS[:4]
B10_TILE = 64  # rows of a tile whose halo 'halo rows twice' counts again
# Rows of the bf16 forward's tile (csrc/sep_conv_gru.cu GF_ROWS), whose q
# reads r h from the neighbouring tiles in 'r h halo dropped'.
B10_FWD_TILE = 64


def gru_inputs(dev, batch, h8, w8, dtype, seed=21):
    """The 13 arguments of a horizontal pass and a cotangent of h', seeded:
    h in (-1, 1) in `dtype`, x ~ N(0, 1) fp32 (the module passes fp32 x to
    a bf16 pass), fp32 taps ~ N(0, 1 / 2560) so that each gate's
    pre-activation has unit scale, fp32 biases ~ N(0, 0.1^2), g ~ N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std
    rows = h8 * w8
    h = randn(batch, rows, GRU_CH).tanh().to(dtype)
    x = randn(batch, rows, GRU_CX)
    std = (5 * (GRU_CH + GRU_CX)) ** -0.5
    ws = [randn(5, c, GRU_CH, std=std) for _ in range(3)
          for c in (GRU_CH, GRU_CX)]
    bs = [randn(GRU_CH, std=0.1) for _ in range(3)]
    return [h, x, *ws, *bs], randn(batch, rows, GRU_CH)


def _gru_fwd_fault(args, stride, width, fault):
    """The plain forward with one planted fault: taps crossing an image row
    read (no row mask), q over h in place of r h, the blend reversed to
    (1 - z) q + z h, or q's taps of r h reading zero from rows of another
    B10_FWD_TILE-row tile of the flattened batch (r h halo dropped)."""
    h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq = args
    if fault == "no row mask":
        return sg.gru_pass_fwd_plain(*args, stride, h.shape[1])
    io, acc = h.dtype, sg.acc_type(h.dtype)
    x = x.to(io)
    geo = (stride, width, acc)

    def gate(a, wh, wx, b):
        return (sg.conv_rows(a, wh.to(io), *geo)
                + sg.conv_rows(x, wx.to(io), *geo) + b.to(acc))
    z = torch.sigmoid(gate(h, wzh, wzx, bz))
    r = torch.sigmoid(gate(h, wrh, wrx, br))
    hf = h.to(acc)
    rh = h if fault == "q over h" else (r * hf).to(io)
    if fault == "r h halo dropped":
        B, HW = h.shape[:2]
        rows = torch.arange(B * HW, device=h.device).view(B, HW, 1)
        q = torch.tanh(sum(
            torch.where((rows + (t - 2) * stride) // B10_FWD_TILE
                        == rows // B10_FWD_TILE,
                        sg.shift_rows(rh, t - 2, stride, width), 0).to(acc)
            @ wqh[t].to(io).to(acc) for t in range(5))
            + sg.conv_rows(x, wqx.to(io), *geo) + bq.to(acc))
    else:
        q = torch.tanh(gate(rh, wqh, wqx, bq))
    hout = (1 - z) * q + z * hf if fault == "blend reversed" else \
        (1 - z) * hf + z * q
    return hout.to(io), z.to(io), r.to(io), q.to(io)


def _gru_bwd_fault(res, stride, width, fault):
    """The plain backward with one planted fault: no row mask, the weight
    gradients also summed over the rows within 2 * stride of each 64-row
    tile's edges (a halo row counted twice), or dh without its drh r term."""
    h, x, z, r, q, g, *ws = res
    if fault == "no row mask":
        return sg.gru_pass_bwd_plain(*res, stride, h.shape[1])
    out = list(sg.gru_pass_bwd_plain(*res, stride, width))
    io, acc = h.dtype, sg.acc_type(h.dtype)
    geo = (stride, width, acc)
    hf, zf, rf, qf = (t.to(acc) for t in (h, z, r, q))
    gf = g.to(io).to(acc)
    dqh = (gf * zf * (1.0 - qf * qf)).to(io)
    drh = sg.conv_rows_t(dqh, ws[4].to(io), *geo)
    if fault == "no drh r term":
        out[0] = (out[0].to(acc) - drh * rf).to(h.dtype)
    elif fault == "halo rows twice":
        dzh = (gf * (qf - hf) * zf * (1.0 - zf)).to(io)
        drhat = (drh * hf * rf * (1.0 - rf)).to(io)
        p = torch.arange(h.shape[1], device=h.device) % B10_TILE
        edge = ((p < 2 * stride) | (p >= B10_TILE - 2 * stride))[None, :,
                                                                  None]
        xi, rh = x.to(io), (rf * hf).to(io)
        for i, (a, d) in enumerate(((h, dzh), (xi, dzh), (h, drhat),
                                    (xi, drhat), (rh, dqh), (xi, dqh))):
            extra = sg.wgrad_rows(a, torch.where(edge, d, 0), *geo)
            out[2 + i] = out[2 + i] + extra.to(out[2 + i].dtype)
    return tuple(out)


def tensors_rel_err(got, want) -> float:
    """The worst rel_err over paired tensors."""
    return max(rel_err(a, b) for a, b in zip(got, want))


def check_gru(dev, report, grids=GRU_CHECK_GRIDS) -> None:
    """Phase 2, B10: both passes (horizontal: stride 1, masked at image
    rows; vertical: stride W over the same rows), forward and backward, at
    the serving, chairs and ragged grids, bf16 and fp32 (TF32 off), against
    the plain versions on the same inputs, with the B10_FAULTS planted in
    the plain versions; two backwards of one input bit-identical."""
    errs = {"gru_pass_fwd": [], "gru_pass_bwd": []}
    for label, batch, h8, w8 in grids:
        for dtype in (torch.bfloat16, torch.float32):
            args, g = gru_inputs(dev, batch, h8, w8, dtype)
            io_tol, w_tol = B10_TOL[dtype]
            for name, geo in (("h", (1, w8)), ("v", (w8, h8 * w8))):
                tag = f"B10 {label} {name} {dtype}"
                got = sg.gru_pass_fwd(*args, *geo)
                sync(dev)
                want = sg.gru_pass_fwd_plain(*args, *geo)
                faults = {f: _gru_fwd_fault(args, *geo, f)
                          for f in B10_FWD_FAULTS
                          if name == "h" or f != "no row mask"}
                hold(f"{tag} forward", got, want, tensors_rel_err, io_tol,
                     faults)
                errs["gru_pass_fwd"].append(max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)))
                del got, faults
                res = (args[0], args[1], *want[1:], g, *args[2:8])
                got = sg.gru_pass_bwd(*res, *geo)
                again = sg.gru_pass_bwd(*res, *geo)
                sync(dev)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"{tag}: two backwards differ"
                del again
                want_b = sg.gru_pass_bwd_plain(*res, *geo)
                bwd_faults = [f for f in ("no row mask", "no drh r term",
                                          "halo rows twice")
                              if name == "h" or f != "no row mask"]
                fb = {f: _gru_bwd_fault(res, *geo, f) for f in bwd_faults}
                hold(f"{tag} backward dh, dx", got[:2], want_b[:2],
                     tensors_rel_err, io_tol,
                     {f: o[:2] for f, o in fb.items()
                      if f != "halo rows twice"})
                hold(f"{tag} backward weights, biases", got[2:], want_b[2:],
                     tensors_rel_err, w_tol,
                     {f: o[2:] for f, o in fb.items()
                      if f != "no drh r term"})
                errs["gru_pass_bwd"].append(max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want_b)))
                del got, want, want_b, fb, res
            del args, g
    for name, e in errs.items():
        report[name]["max_abs_err"] = max(e)


GRU_CALLS = 12  # the refinement loop's iterations
# The path's bounds, fused against the conv form over GRU_CALLS chained
# calls of two passes each.  bf16: the conv form rounds its conv outputs,
# gate sums, z, r, q and the blend to bf16 (about 4 roundings of at most
# 2^-9 of values below 1 a pass) where the fused pass keeps fp32, so the
# last h may move by 24 * 4 * 2^-9 = 0.19; the gradients, rounded to bf16
# as often through the conv form's backward, by the same share of their
# largest value.  fp32 (TF32 off): sums in another order only.
GRU_PATH_TOL = {torch.bfloat16: (0.1875, 0.1875), torch.float32: (1e-4, 1e-3)}


def gru_modules(dev, dtype):
    """SepConvGRU(fused='on') and (fused='off') with the oracle tree's
    update-block GRU weights, on `dev`."""
    _, _, _, tree = load_oracle_npz(ORACLE)
    prefix = "update_block.gru."
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(tree).items()
          if k.startswith(prefix)}
    mods = []
    for fused in ("on", "off"):
        m = SepConvGRU(GRU_CH, GRU_CX, dtype, fused=fused).to(dev)
        m.load_state_dict(sd, strict=True)
        mods.append(m)
    return mods


def _gru_chain(mod, h, xs, static=None):
    for x in xs:
        h = mod(h, x, static=static)
    return h


def gru_path(dev) -> dict:
    """Phase 4, the GRU path: SepConvGRU(fused='on') against fused='off',
    12 chained calls (h carried, a fresh seeded x each call, as the
    refinement loop runs it).  Serving (B=1, 55x128): forward, bf16.
    Chairs (B=8, 46x62): forward and backward through autograd from a
    seeded loss on the last h, bf16 and fp32.  The last h and every weight
    gradient within GRU_PATH_TOL; launches asserted: 24 forward passes per
    12 calls, 24 backward passes per backward, none with `static`."""
    res = {}
    for label, batch, h8, w8 in GRU_GRIDS:
        for dtype in ((torch.bfloat16,) if label == "serving"
                      else (torch.bfloat16, torch.float32)):
            gen = torch.Generator(device=dev).manual_seed(31)
            shape = (batch, h8, w8)
            h0 = torch.randn(*shape, GRU_CH, generator=gen,
                             device=dev).tanh().to(dtype)
            xs = [torch.randn(*shape, GRU_CX, generator=gen, device=dev)
                  for _ in range(GRU_CALLS)]
            wgt = torch.randn(*shape, GRU_CH, generator=gen, device=dev)
            train = label == "chairs"
            on, off = gru_modules(dev, dtype)
            outs = []
            for mod in (on, off):
                launch.reset_launch_counts()
                t0 = time.perf_counter()
                with torch.set_grad_enabled(train):
                    h = _gru_chain(mod, h0, xs)
                    if train:
                        (h.float() * wgt).sum().backward()
                sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
                grads = [p.grad for p in mod.parameters()] if train else []
                outs.append((h.detach().float(), grads, ms,
                             launch.launch_counts()))
            counts = outs[0][3]
            h_tol, g_tol = GRU_PATH_TOL[dtype]
            herr = float((outs[0][0] - outs[1][0]).abs().max())
            gerr = max((rel_err(a, b) for a, b in zip(outs[0][1],
                                                      outs[1][1])),
                       default=0.0)
            tag = f"GRU path {label} {dtype}"
            print(f"{tag}: last h on vs off {herr:.3e} (bound {h_tol:g}), "
                  f"gradients {gerr:.3e} (bound {g_tol:g}); "
                  f"{'forward and backward' if train else 'forward'} "
                  f"{outs[0][2]:.1f} ms fused, {outs[1][2]:.1f} ms conv form"
                  f", launches {counts['gru_pass_fwd']} forward, "
                  f"{counts['gru_pass_bwd']} backward")
            assert bool(torch.isfinite(outs[0][0]).all()), tag
            assert herr <= h_tol and gerr <= g_tol, f"{tag}: on != off"
            assert counts["gru_pass_fwd"] == 2 * GRU_CALLS, tag
            assert counts["gru_pass_bwd"] == (2 * GRU_CALLS if train else 0)
            for name, n in counts.items():
                if not name.startswith("gru_pass"):
                    assert n == 0, f"{tag}: {name} launched"
            assert not any(outs[1][3].values()), f"{tag}: the conv form " \
                "launched a kernel"
            res[f"{label} {dtype}"] = counts
            # With the context's share given (`static`), the conv form runs.
            launch.reset_launch_counts()
            with torch.no_grad():
                _gru_chain(on, h0, [x[..., 128:] for x in xs[:2]],
                           static=on.static_contrib(xs[0][..., :128]))
            sync(dev)
            assert not any(launch.launch_counts().values()), \
                f"{tag}: a kernel launched under static"
            del on, off, outs, xs
            torch.cuda.empty_cache()
    return res


def time_gru(dev, report) -> None:
    """Phase 5, B10: forward and backward of each pass at the serving and
    chairs grids in bf16, beside the plain versions, the bounds and the
    library: the same pass in the conv form (SepConvGRU.conv_pass: cuDNN
    convs and the gates, bf16 parameters; its backward by autograd).  The
    conv form is a dozen launches, so beside the event times the kernels'
    device times (torch.profiler) of B10 and of the conv form."""
    for label, batch, h8, w8 in GRU_GRIDS:
        args, g = gru_inputs(dev, batch, h8, w8, torch.bfloat16)
        args = [a.to(torch.bfloat16) for a in args[:8]] + args[8:]
        rows, isz = batch * h8 * w8, 2
        cin = GRU_CH + GRU_CX
        flops = 2.0 * rows * 5 * cin * GRU_CH * 3
        w_bytes = 15 * cin * GRU_CH * isz + 3 * GRU_CH * 4
        fwd_bytes = rows * (cin + 4 * GRU_CH) * isz + w_bytes
        bwd_bytes = (rows * (5 * GRU_CH + GRU_CX + cin) * isz + w_bytes
                     + 15 * cin * GRU_CH * 4 + 3 * GRU_CH * 4)
        mod = SepConvGRU(GRU_CH, GRU_CX, torch.bfloat16).to(
            dev, torch.bfloat16)
        h4 = args[0].reshape(batch, h8, w8, GRU_CH).permute(0, 3, 1, 2)
        x4 = args[1].reshape(batch, h8, w8, GRU_CX).permute(0, 3, 1, 2)
        g4 = g.to(torch.bfloat16).reshape(batch, h8, w8, GRU_CH).permute(
            0, 3, 1, 2)
        for name, geo in (("h", (1, w8)), ("v", (w8, h8 * w8))):
            out = sg.gru_pass_fwd(*args, *geo)
            res = (args[0], args[1], *out[1:], g, *args[2:8])
            hr = h4.detach().requires_grad_()
            xr = x4.detach().requires_grad_()
            y = mod.conv_pass(hr, xr, name)
            lib_in = [hr, xr, *mod.parameters()]
            cases = {
                "gru_pass_fwd": (
                    lambda: sg.gru_pass_fwd(*args, *geo),
                    lambda: sg.gru_pass_fwd_plain(*args, *geo),
                    lambda: mod.conv_pass(h4, x4, name),
                    bound_ms(flops, fwd_bytes)),
                "gru_pass_bwd": (
                    lambda: sg.gru_pass_bwd(*res, *geo),
                    lambda: sg.gru_pass_bwd_plain(*res, *geo),
                    lambda: torch.autograd.grad(y, lib_in, g4,
                                                retain_graph=True,
                                                allow_unused=True),
                    bound_ms(2 * flops, bwd_bytes)),
            }
            for kname, (kern, plain, lib, (bms, by)) in cases.items():
                with torch.no_grad() if kname == "gru_pass_fwd" else \
                        torch.enable_grad():
                    ms, pms, lms = time_ms(kern, 10), time_ms(plain, 3), \
                        time_ms(lib, 10)
                    dms, dlms = device_ms(kern, 10), device_ms(lib, 10)
                print(f"{kname} ({label}, pass {name}, bf16): {ms:.3f} ms, "
                      f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}), conv "
                      f"form {lms:.3f} ms; device time {dms:.3f} ms, conv "
                      f"form {dlms:.3f} ms")
                if name == "h" and (kname == "gru_pass_fwd") == (
                        label == "serving"):
                    report[kname].update(ms=ms, plain_ms=pms, library_ms=lms,
                                         bound_ms=bms, bound_by=by)
            del out, res, y, lib_in
        del args, g, mod
        torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Mode counts other than 4 (--intermodes, --f2modes, --intramodes)
# ---------------------------------------------------------------------------

# The checks' counts: ((modes, mode dim) of the 256-wide inter, f2 and f1
# sites, that of the 128-wide intra site or None where another count
# checks it) of modes1, modes2, modes8, modes16, and past 16 modes (md 8
# to 1: modes32, modes_small_mixed's and modes256's counts; md = width /
# M).
MODE_COUNTS = (((1, 256), (1, 128)), ((2, 128), (2, 64)),
               ((8, 32), (8, 16)), ((16, 16), None),
               ((32, 8), (16, 8)), ((64, 4), (32, 4)), ((128, 2), (64, 2)),
               ((256, 1), (128, 1)))
# The kernels whose instantiations the new counts add, in the kernels line
# as <name>_m1, <name>_m8 and <name>_m32 (the modes1, modes8 and modes32
# configurations: MODE_ROWS).
MODE_KERNELS = ("scores_global_max", "flash_mode_attention",
                "fused_agg_corr_norm", "mode_softmax_probs",
                "fused_agg_corr", "agg_corr_bwd", "probs_bwd")
MODE_ROWS = (1, 8, 32)
# B2 at md 128 (two modes: modes2) and B8 at md 256 with the --f2radius
# table (modes1_f2radius), rows of their own in the kernels line.
FLASH_ROWS = (("flash_mode_attention", 2), ("flash_mode_attention_dense", 1))
# The training checks' batch at the chairs grid: TRAIN_BATCH at the counts
# that modes1 and modes8 train at full width, two samples at the others,
# which hold every tile and mode of the kernels at a quarter of the plain
# versions' memory.
MODE_CHECK_BATCH = 2
# Past 32 modes the checks run at cut grids: the plain versions' fp32
# scores at 256 modes would take 50.7 GB on the serving grid, 4.5 GB a
# tensor on (30, 70) (U 2100, ragged: 32.8 key tiles), and the training
# checks' (20, 41) (U 820) at batch 2.  Both have several query and key
# tiles and key groups.
MODE_CUT_GRID, MODE_CUT_TRAIN_GRID, MODE_CUT_PAST = (30, 70), (20, 41), 32
# The dense-table cases at the new counts (check_dense_kernels' labels).
MODE_DENSE_CASES = ("table, clip on", "fp32, table, clip on")


# B2 and B8 past md 64 (one or two modes at the f2 site: the pipelined
# body) on the serving grid and a ragged one, whose 37 x 61 = 2257 tokens
# end in a ragged key tile and a ragged q tile and take 4 key splits at one
# mode, 3 at two.
FLASH_WIDE_GRIDS = (("serving", (H8, W8)), ("ragged", (37, 61)))


def check_flash_wide(dev, gen, report, wide, grids=FLASH_WIDE_GRIDS) -> None:
    """Phase 2, B2 (the window, pos_w 0.5) and B8 (no table, and the f2
    site's --f2radius table: pos_w * the dense window + the radius mask,
    pos_w 1) at the f2 site's (modes, mode dim) `wide` on each grid, bf16,
    the clamp on, against their plain versions; a dropped bias (B8: a table
    where there is none, the table dropped), a missing clamp, mode_faults
    and flash_faults planted in the plain versions must fall outside the
    bound."""
    M, md = wide
    biases = (torch.randn(15, 15, generator=gen) * BIAS_STD).to(dev)
    clip_t = torch.tensor(CLIP_ON, device=dev)
    no_clip = torch.tensor(CLIP_OFF, device=dev)
    for label, grid in grids:
        u = grid[0] * grid[1]
        q, k = inputs(gen, md, dev, u, modes=M)
        v = torch.randn(1, M, u, 256, generator=gen).to(dev, torch.bfloat16)
        tag = f"M={M} md={md} {label} {grid[0]}x{grid[1]}"

        def b2(a=q, b=k, w=0.5, c=clip_t):
            return ma.flash_mode_attention_plain(a, b, v, biases, grid, c, w)
        faults = {"no bias": lambda: b2(w=0.0), "no clamp": lambda: b2(
            c=no_clip)}
        faults.update(mode_faults(M, md, lambda a, b: b2(a, b), q, k))
        faults.update(flash_faults(md, lambda a, b: b2(a, b), q, k))
        got = ma.flash_mode_attention(q, k, v, biases, grid, clip_t, 0.5)
        sync(dev)
        want = b2()
        hold(f"B2 {tag}", got, want, rel_err, B2_TOL, faults)
        note_err(report, "flash_mode_attention", M,
                 float((got.float() - want.float()).abs().max()))
        del got, want, faults
        table = (0.5 * ma.sliding_pos_biases(biases, *grid)
                 + setrans.attention_mask(*grid, F2RADIUS, dev))
        for tab in (None, table):

            def b8(a=q, b=k, t=tab, c=clip_t):
                return ma.flash_mode_attention_dense_plain(a, b, v, t, c, 1.0)
            faults = ({"a table where there is none": lambda: b8(t=table)}
                      if tab is None else {"the table dropped": lambda: b8(
                          t=None)})
            faults["no clamp"] = lambda: b8(c=no_clip)
            faults.update(mode_faults(M, md, lambda a, b: b8(a, b), q, k))
            faults.update(flash_faults(md, lambda a, b: b8(a, b), q, k))
            got = ma.flash_mode_attention_dense(q, k, v, tab, clip_t, 1.0)
            sync(dev)
            want = b8()
            hold(f"B8 {tag} {'no table' if tab is None else 'table'}", got,
                 want, rel_err, B2_TOL, faults)
            note_err(report, "flash_mode_attention_dense", M,
                     float((got.float() - want.float()).abs().max()))
            del got, want, faults
        del q, k, v, table
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def check_mode_kernels(dev, gen, report, grid=(H8, W8),
                       train_grid=CHAIRS_GRID,
                       b3_grids=((H8, W8), KITTI_GRID),
                       counts=MODE_COUNTS, cut_grid=MODE_CUT_GRID,
                       cut_train_grid=MODE_CUT_TRAIN_GRID,
                       flash_grids=FLASH_WIDE_GRIDS) -> None:
    """Phase 2, the mode counts other than 4: the checks of the four modes
    (check_kernels, check_train_kernels, check_dense_kernels,
    check_sp_kernels at two shards, check_b2_lazy at the serving grid) at
    each count, bf16 and fp32, their faults and mode_faults planted, and
    past md 64 check_flash_wide (B2 and B8 on flash_grids); past
    MODE_CUT_PAST modes at cut_grid and cut_train_grid in place of grid,
    b3_grids and train_grid.  On CPU tensors the wrappers take the plain
    versions themselves (how the tests run this check)."""
    full = (grid, train_grid, b3_grids)
    for wide, intra in counts:
        grid, train_grid, b3_grids = full if wide[0] <= MODE_CUT_PAST else (
            cut_grid, cut_train_grid, (cut_grid,))
        batch = TRAIN_BATCH if wide[0] in (1, 8) else MODE_CHECK_BATCH
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(dev, gen, report, grid, b3_grids, wide, intra,
                          dtype)
            check_train_kernels(dev, gen, report, train_grid, batch, wide,
                                intra, dtype)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        check_dense_kernels(dev, gen, report, grid, wide=wide, intra=intra,
                            only=MODE_DENSE_CASES)
        check_sp_kernels(dev, gen, report, grid, worlds=(2,), wide=wide,
                         intra=intra)
        if wide[1] > ma.MMA_MODE_DIM:
            check_flash_wide(dev, gen, report, wide, flash_grids)
        if intra:
            check_b2_lazy(dev, gen, report, grids=((f"{grid[0]}x{grid[1]}",
                                                    grid),),
                          hd1k=None, modes=intra)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# The configurations of the mode-count phase: each site's mode count (the
# flags --intermodes, --f2modes, --intramodes); the full-width ones
# (MODE_FULL: modes1, modes8, modes32) are served and trained at the main
# path's shapes, modes256 and modes_small_mixed served at 440x1024 and
# trained at a cut batch (MODE_TRAIN_BATCH), every one runs card against
# CPU at 128x128.  two_way8 is --f1 private --intermodes 8, nogma2 --nogma
# --intramodes 2 (craft_nogma's f2 site takes --intramodes).
MODE_CONFIGS = {
    "modes1": (1, 1, 1), "modes8": (8, 8, 8), "modes2": (2, 2, 2),
    "modes16": (16, 16, 8), "modes_mixed": (2, 16, 1),
    "two_way8": (8, 4, 4), "nogma2": (4, 2, 2),
    "modes32": (32, 32, 16), "modes256": (256, 256, 128),
    "modes_small_mixed": (64, 128, 32), "modes1_f2radius": (1, 1, 1)}
MODE_FULL = ("modes1", "modes8", "modes32")
# The served configurations and their launches a pair: modes256's intra
# probs (128 x 7040^2 bf16, 12.7 GB) pass setrans.LAZY_PROBS_BYTES, so it
# serves on the lazy intra path (B2 at F 128 each iteration, no B4);
# modes2 launches B2 at md 128 and modes1_f2radius B8 at md 256 with the
# --f2radius table (the kernels line's flash_mode_attention_m2 and
# flash_mode_attention_dense_m1).
MODE_SERVED = {"modes1": "SERVE_PER_PAIR", "modes8": "SERVE_PER_PAIR",
               "modes32": "SERVE_PER_PAIR",
               "modes_small_mixed": "SERVE_PER_PAIR",
               "modes256": "LAZY_PER_PAIR", "modes2": "SERVE_PER_PAIR",
               "modes1_f2radius": "F2RADIUS_KERNELS"}
# The training batch at the chairs crops: TRAIN_BATCH at full width; the
# f2 site's bf16 probs are [B, M, 2852, 2852], 16.3 MB a mode and sample,
# 33 GB at 256 modes and batch 8 before their gradient and dropout, so
# modes256 and modes_small_mixed train at batch 2.
MODE_TRAIN_BATCH = {"modes1": TRAIN_BATCH, "modes8": TRAIN_BATCH,
                    "modes32": TRAIN_BATCH, "modes256": 2,
                    "modes_small_mixed": 2}
MODE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_modes"
MODE_SP_RANKS = 2
MODE_SP_CONFIGS = ("modes8", "modes32")


def mode_flags(name: str) -> list:
    """The CLIs' flags of configuration `name` (``craft_tpu_torch/cli.py``,
    ``craft_tpu/cli.py``'s)."""
    inter, f2, intra = MODE_CONFIGS[name]
    if name == "nogma2":
        return ["--nogma", "--intramodes", str(intra)]
    flags = ["--craft", "--setrans", "--intermodes", str(inter), "--f2modes",
             str(f2), "--intramodes", str(intra)]
    if name == "modes1_f2radius":  # B8 at md 256 with the f2 table
        flags += ["--f2radius", str(F2RADIUS)]
    return flags + (["--f1", "private"] if name == "two_way8" else [])


def mode_config(name: str, mixed_precision: bool):
    """The ModelConfig the CLI builds from ``mode_flags(name)``."""
    from craft_tpu_torch import cli
    import argparse
    p = argparse.ArgumentParser()
    cli.add_model_args(p)
    args = p.parse_args(mode_flags(name) + (
        ["--mixed_precision"] if mixed_precision else []))
    return cli.model_config_from_args(args)


def config_weights(cfg, seed: int = 23) -> dict:
    """The state_dict of `cfg`: the oracle tree's tensors where it has them
    at the same shape (the encoders, the update block, the sites' q and k
    projections, which keep their width at every mode count; an f1 site
    from the f2 site's), the rest (the feature sites' first linears of
    M x F outputs, the two-way convc1) as PyTorch initialises them under
    `seed`."""
    oracle = _oracle_state_dict()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = FlowModel(cfg).state_dict()
    for key, v in sd.items():
        src = oracle.get(key)
        if src is None and key.startswith("f1_trans."):
            src = oracle.get("f2_trans." + key[len("f1_trans."):])
        if src is not None and src.shape == v.shape:
            sd[key] = src.clone()
    return sd


@functools.lru_cache(maxsize=None)
def _oracle_state_dict() -> dict:
    return state_dict_from_flax(load_oracle_npz(ORACLE)[3])


def mode_weights(name: str) -> dict:
    """``config_weights`` of configuration `name`."""
    return config_weights(mode_config(name, False))


def mode_model(dev, name, mixed_precision):
    model = create_model(mode_config(name, mixed_precision), device=dev)
    model.load_state_dict(mode_weights(name), strict=True)
    return model


def modes_card_vs_cpu(dev) -> dict:
    """Every configuration at 128x128 (the oracle frames rounded to uint8),
    12 iterations, on the card against the CPU (plain versions): fp32 within
    FULLPREC_BOUND_PX, mixed within BF16_BOUND_PX.  Returns the frames and
    the fp32 CPU flows."""
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    frames = [np.round(x[0]).astype(np.uint8) for x in (img1, img2)]
    pair = [torch.from_numpy(f[None].astype(np.float32)) for f in frames]
    out = {"frames": frames}
    for name in MODE_CONFIGS:
        for label, mp, bound in (("fp32", False, FULLPREC_BOUND_PX),
                                 ("mixed", True, BF16_BOUND_PX)):
            want = _final(mode_model("cpu", name, mp), *pair).float()
            got = _final(mode_model(dev, name, mp),
                         *(t.to(dev) for t in pair)).float().cpu()
            err = float((got - want).abs().max())
            print(f"{name} {label}: card against the CPU, max |flow diff| "
                  f"{err:.3e} px (max |flow| {float(want.abs().max()):.3f}, "
                  f"bound {bound})")
            assert bool(torch.isfinite(got).all()) and err < bound, \
                f"{name} {label}"
            if not mp:
                out[name] = want
    return out


def modes_serving(dev, n_pairs: int = 2) -> dict:
    """The MODE_SERVED configurations served as the main path (mixed,
    440x1024, 12 iterations, one warm-up pair, then n_pairs seeded pairs
    with the launch counts zeroed just before): ms between CUDA events
    (wall), the profiler's device ms of one more pair and the busy share
    (that device ms over the median wall), peak memory and the exact
    launches a pair (SERVE_PER_PAIR: the sites are the same, at other mode
    counts; LAZY_PER_PAIR for modes256, its B2 launches at F 128 held to
    ITERS a pair)."""
    padder, pairs = frame_pairs(dev, n_pairs + 1, seed=6)
    res = {}
    for name, per_pair in MODE_SERVED.items():
        model = mode_model(dev, name, True)
        res[name] = _served(name, model, padder, pairs, globals()[per_pair])
        if per_pair == "LAZY_PER_PAIR":
            ma.flash_mode_attention.launches_by = {}
            _final(model, *pairs[1])
            by = dict(ma.flash_mode_attention.launches_by)
            print(f"{name}: B2 launches by width {by}")
            assert by == {256: 1, LAZY_F: ITERS}, f"{name} lazy path"
            res[name]["b2_by_width"] = by
        del model
        torch.cuda.empty_cache()
    return res


def mode_train_setup(dev, name: str):
    """(state, step, batch) of configuration `name`'s training path: mixed
    precision, ``mode_weights``, dropout at the config's rates, remat on,
    12 iterations, a chairs-size batch of MODE_TRAIN_BATCH samples."""
    cfg = mode_config(name, True)
    state = create_train_state(cfg, mode_weights(name), device=dev,
                               num_steps=1000)
    n = MODE_TRAIN_BATCH[name]
    batch = {k: v[:n] for k, v in train_batch(dev).items()}
    return state, make_train_step(cfg, iters=ITERS), batch


def modes_training(dev, n_steps: int = 2) -> dict:
    """The MODE_TRAIN_BATCH configurations at the chairs crops (368x496,
    their batch, 12 iterations, dropout at the config's rates, mixed
    precision, remat on), one warm-up step, then n_steps steps between
    CUDA events: their ms, the profiler's device ms of one more step, peak
    memory, loss, grad norm and the exact launches of the main config's
    step."""
    res = {}
    for name in MODE_TRAIN_BATCH:
        state, step, batch = mode_train_setup(dev, name)
        r = _trained(name, state, step, batch, n_steps, "main")
        box = [state]

        def one():
            box[0], _ = step(box[0], batch)
        r["step_device_ms"] = device_ms(one, 1)
        print(f"{name} training: device {r['step_device_ms']:.3f} ms a step")
        res[name] = r
        del state, step, batch, box
        torch.cuda.empty_cache()
    return res


def modes_step_card_vs_cpu(dev) -> None:
    """One fp32 step (dropout off, 2 iterations, the oracle frames) of each
    MODE_FULL configuration on the card against the CPU (phase 3's
    bounds), its launches asserted."""
    for name in MODE_FULL:
        _step_card_vs_cpu(dev, f"{name} train step", mode_config(name, False),
                          mode_weights(name), "main")


# The configurations that the CLIs run in the mode-count phase.
MODE_EVAL_CLI, MODE_TRAIN_CLI = ("modes8", "modes32"), ("modes1", "modes32")


def modes_clis(dev, cpu_flows, frames) -> dict:
    """The evaluator CLI with each MODE_EVAL_CLI configuration's flags over
    its weights as a reference .pth, on a one-pair Sintel tree of the
    oracle frames whose ground truth is that configuration's fp32 CPU flow
    (--fullprec within FULLPREC_BOUND_PX, mixed within BF16_BOUND_PX,
    SERVE_PER_PAIR a forward); then the training CLI with each
    MODE_TRAIN_CLI configuration's flags, 2 steps of the chairs stage on a
    small synthetic FlyingChairs tree (the steps' launches: the main
    config's, exact)."""
    shutil.rmtree(MODE_DIR, ignore_errors=True)
    MODE_DIR.mkdir(parents=True)
    out = {}
    for name in MODE_EVAL_CLI:
        pth = MODE_DIR / f"{name}.pth"
        torch.save({f"module.{k}": v for k, v in mode_weights(name).items()},
                   pth)
        write_sintel_tree(MODE_DIR / name, frames,
                          [cpu_flows[name][0].numpy()])
        for label, extra, bound in (("fp32", ["--fullprec"],
                                     FULLPREC_BOUND_PX),
                                    ("mixed", [], BF16_BOUND_PX)):
            argv = ["--model", str(pth), *mode_flags(name), "--iters",
                    str(ITERS), "--device", str(dev), "--dataset", "sintel",
                    "--data_root", str(MODE_DIR / name), *extra]
            r = _timed_cli(f"{name} {label}", argv, 2)
            _assert_launches(f"eval {name} {label}", r["launches"],
                             SERVE_PER_PAIR, 2)
            epe = r["metrics"]["sintel_clean_epe"]
            print(f"eval {name} {label}: sintel_clean_epe {epe:.3e} px "
                  f"against the port's CPU flow (bound {bound})")
            assert epe < bound, f"eval {name} {label}"
            out[f"eval {name} {label}"] = r
    write_chairs(MODE_DIR / "chairs", 8, 2, (128, 160))
    for name in MODE_TRAIN_CLI:
        argv = ["--stage", "chairs", *mode_flags(name), "--mixed_precision",
                "--lr", "2.5e-4", "--image_size", "96", "128",
                "--batch_size", "4", "--workers", "1", "--iters",
                str(ITERS), "--print_freq", "1", "--num_steps", "2",
                "--data_root", str(MODE_DIR / "chairs"), "--output",
                str(MODE_DIR / "out"), "--name", name, "--device", str(dev)]
        launch.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_cli.main(argv)
        counts = launch.launch_counts()
        r = {"seconds": time.perf_counter() - t0, "step": state.step,
             "launches": {k: c for k, c in counts.items() if c}}
        print(f"train CLI {name}:", json.dumps(r))
        assert state.step == 2 and state.model.cfg.inter.num_modes == \
            MODE_CONFIGS[name][0]
        assert all(bool(torch.isfinite(p).all())
                   for p in state.model.parameters()), f"train CLI {name}"
        _assert_launches(f"train CLI {name}", counts, step_launches("main"),
                         2)
        assert (MODE_DIR / "out" / f"{name}.pth").exists()
        out[f"train {name}"] = r
    shutil.rmtree(MODE_DIR, ignore_errors=True)
    return out


def mode_sp_rank_main(outdir: str) -> int:
    """One rank of the mode-count phase's sequence parallelism: each
    MODE_SP_CONFIGS configuration at 128x128 (the oracle frames), mixed
    and fp32, as this rank of a gloo group; writes its flows and launches
    under outdir."""
    from craft_tpu_torch.parallel import sp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = sp.init("cuda")
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    pair = [torch.from_numpy(np.round(x).astype(np.float32)).to(group.device)
            for x in (img1, img2)]
    res = {"rank": group.rank, "world": group.world,
           "backend": group.backend}
    for name in MODE_SP_CONFIGS:
        for label, mp in (("mixed", True), ("fp32", False)):
            model = mode_model(group.device, name, mp)
            launch.reset_launch_counts()
            _, flows = serve(model, [pair], group)
            res[f"launches_{name}_{label}"] = launch.launch_counts()
            torch.save(flows[0].cpu(), Path(outdir)
                       / f"rank{group.rank}_{name}_{label}.pt")
    (Path(outdir) / f"rank{group.rank}.json").write_text(json.dumps(res))
    print(f"modes sp rank{group.rank}:", json.dumps(res), flush=True)
    return 0


def modes_sp(dev) -> dict:
    """MODE_SP_RANKS ranks of this script on the one card (gloo) serving
    each MODE_SP_CONFIGS configuration at 128x128 against the unsharded
    card flow: mixed within BF16_BOUND_PX, fp32 within FULLPREC_BOUND_PX,
    SP_KERNELS per rank (B9 in place of B3, at 8 and 32 modes)."""
    sp_dir = MODE_DIR / "sp"
    shutil.rmtree(sp_dir, ignore_errors=True)
    sp_dir.mkdir(parents=True)
    img1, img2, _, _ = load_oracle_npz(ORACLE)
    pair = [torch.from_numpy(np.round(x).astype(np.float32)).to(dev)
            for x in (img1, img2)]
    ref = {(name, label): serve(mode_model(dev, name, mp), [pair])[1][0]
           .cpu() for name in MODE_SP_CONFIGS
           for label, mp in (("mixed", True), ("fp32", False))}
    script = str(Path(__file__).resolve())
    _run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(MODE_SP_RANKS), script,
                "--sp-modes-rank", str(sp_dir)], "modes sp ranks")
    res = {}
    for r in range(MODE_SP_RANKS):
        rk = json.loads((sp_dir / f"rank{r}.json").read_text())
        assert (rk["world"], rk["backend"]) == (MODE_SP_RANKS, "gloo"), rk
        for name in MODE_SP_CONFIGS:
            for label, bound in (("mixed", BF16_BOUND_PX),
                                 ("fp32", FULLPREC_BOUND_PX)):
                got = torch.load(sp_dir / f"rank{r}_{name}_{label}.pt")
                err = float((got.float() - ref[name, label].float()).abs()
                            .max())
                print(f"{name} sp rank {r} {label}: max |flow diff| "
                      f"against unsharded {err:.3e} px (bound {bound})")
                assert bool(torch.isfinite(got).all()) and err < bound, \
                    f"{name} sp rank {r} {label}"
                _assert_launches(f"{name} sp rank {r} {label}",
                                 rk[f"launches_{name}_{label}"], SP_KERNELS,
                                 1)
                rk[f"{name}_{label}_err_px"] = err
        res[r] = rk
    shutil.rmtree(sp_dir, ignore_errors=True)
    return res


def modes_phase(dev) -> dict:
    """The mode counts other than 4: card against CPU for every
    configuration, MODE_SERVED served at 440x1024 and MODE_TRAIN_BATCH
    trained at the chairs crops, one fp32 step of each MODE_FULL
    configuration card against CPU, the evaluator and training CLIs, and a
    gloo pair of sequence-parallel ranks at 8 and 32 modes."""
    t0 = time.perf_counter()
    flows = modes_card_vs_cpu(dev)
    res = {"serving": modes_serving(dev)}
    torch.cuda.empty_cache()
    res["training"] = modes_training(dev)
    torch.cuda.empty_cache()
    modes_step_card_vs_cpu(dev)
    res["cli"] = modes_clis(dev, flows, flows["frames"])
    torch.cuda.empty_cache()
    res["sp"] = modes_sp(dev)
    print(f"modes phase: {time.perf_counter() - t0:.1f} s")
    return res


def _in_slices(fn, n: int, batched: int, *args):
    """fn over the leading `batched` arguments' batch in slices of n
    samples (the plain versions at 32 modes and batch 8 would hold 8.3 GB
    fp32 tensors by the handful): tensors concatenated, 0-d sums and
    [U, U] sums added up."""
    B = args[0].shape[0]
    outs = [fn(*(a[i:i + n] for a in args[:batched]), *args[batched:])
            for i in range(0, B, n)]

    def join(parts):
        if parts[0].dim() in (0, 2):
            return sum(parts[1:], parts[0])
        return torch.cat(parts)
    if isinstance(outs[0], tuple):
        return tuple(join([o[j] for o in outs]) for j in range(len(outs[0])))
    return join(outs)


def time_mode_kernels(dev, gen, report) -> None:
    """Phase 5, the mode counts: each kernel of MODE_KERNELS at 1, 8 and
    32 modes where modes1, modes8 and modes32 run it (B1, B2, B3 and B4
    int8 at the serving shape: the f2 site's md for B1 and B2, the intra
    site's count and md for B4; B6, its backward and B7 at the chairs
    shape, batch 8, their plain versions over slices of two samples at 32
    modes), beside its plain version, its bound (bf16 inputs: the tensor
    cores' peak) and the floor of its exponentials on the SFUs; at 32
    modes also B8 (no table) at the serving shape beside SDPA."""
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    grid, tgrid = (H8, W8), CHAIRS_GRID
    ut, B = tgrid[0] * tgrid[1], TRAIN_BATCH
    clip = torch.tensor(1e30, device=dev)
    agg = (torch.tensor(1.3, device=dev), torch.tensor(0.1, device=dev))
    dgen = torch.Generator(device=dev).manual_seed(3)
    for M in MODE_ROWS:
        Mi = MODE_CONFIGS[f"modes{M}"][2]
        md, md_i = 256 // M, 128 // Mi
        q, k = inputs(gen, md, dev, U, modes=M)
        qi, ki = inputs(gen, md_i, dev, U, modes=Mi)
        v = torch.randn(1, M, U, 256, generator=gen).to(dev, torch.bfloat16)
        n, ni = M * U * U, Mi * U * U
        qk = lambda d, b=1, u=U, m=M: (2.0 * b * m * u * u * d,  # noqa: E731
                                       2 * b * m * u * d * 2)
        dense = (0.5 * ma.sliding_pos_biases(biases, *grid)).to(
            torch.bfloat16)
        fl_b1, by_b1 = qk(md)
        fl_b4, by_b4 = qk(md_i, m=Mi)
        flash = (q, k, v, biases, grid, clip, 0.5)
        corr = (q, k, biases, grid, 100.0, 0.5, *agg)
        probs = (qi, ki, biases, grid, clip, 1.0)
        b2_bound = bound_ms(fl_b1 + 2.0 * n * 256,
                            by_b1 + 2 * 2 * M * U * 256)
        cases = {
            "scores_global_max": (
                lambda: ma.scores_global_max(q, k, md ** -0.5),
                lambda: ma.scores_global_max_plain(q, k, md ** -0.5), None,
                bound_ms(fl_b1, by_b1 + 4), 0.0),
            "flash_mode_attention": (
                lambda: ma.flash_mode_attention(*flash),
                lambda: ma.flash_mode_attention_plain(*flash),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=dense),
                b2_bound, exp_ms(n)),
            "fused_agg_corr_norm": (
                lambda: ma.fused_agg_corr_norm(*corr),
                lambda: ma.fused_agg_corr_norm_plain(*corr), None,
                bound_ms(fl_b1, by_b1 + 2 * U * U + 16), exp_ms(2.0 * n)),
            "mode_softmax_probs": (
                lambda: ma.mode_softmax_probs(*probs, quantized=True),
                lambda: ma.mode_softmax_probs_plain(*probs, quantized=True),
                None, bound_ms(fl_b4, by_b4 + ni + 4 * Mi * U),
                exp_ms(2.0 * ni)),
        }
        if M == 32:
            cases["flash_mode_attention_dense"] = (
                lambda: ma.flash_mode_attention_dense(q, k, v, None, clip,
                                                      0.5),
                lambda: ma.flash_mode_attention_dense_plain(q, k, v, None,
                                                            clip, 0.5),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), b2_bound, exp_ms(n))
        _time_mode_cases(cases, report, M, f"serving, M={M}, intra M={Mi}")
        del q, k, qi, ki, v, dense
        torch.cuda.empty_cache()
        q, k = inputs(gen, md, dev, ut, B, M)
        nt = B * M * ut * ut
        fl_t, by_t = qk(md, B, ut)
        sl = 2 if M > 8 else B  # the plain versions' slices of samples
        vol = _in_slices(cv.fused_agg_corr_plain, sl, 2, q, k, biases, tgrid,
                         clip, 0.5, *agg)
        g_vol = torch.randn(B, ut, ut, generator=dgen, device=dev)
        p = ma.mode_softmax_probs(q, k, biases, tgrid, clip, 0.5)
        g_p = torch.randn(B, M, ut, ut, generator=dgen,
                          device=dev).to(torch.bfloat16)
        fwd = (q, k, biases, tgrid, clip, 0.5, *agg)
        bwd = (q, k, g_vol, vol, biases, tgrid, clip, 0.5, agg[0])
        pb = (q, k, p, g_p, clip)
        cases = {
            "fused_agg_corr": (
                lambda: cv.fused_agg_corr(*fwd),
                lambda: _in_slices(cv.fused_agg_corr_plain, sl, 2, *fwd),
                None, bound_ms(fl_t, by_t + 4 * B * ut * ut), exp_ms(nt)),
            "agg_corr_bwd": (
                lambda: cv.agg_corr_bwd(*bwd),
                lambda: _in_slices(cv.agg_corr_bwd_plain, sl, 4, *bwd), None,
                bound_ms(fl_t, by_t + 2 * 4 * B * ut * ut + 4 * nt + 4),
                exp_ms(nt)),
            "probs_bwd": (
                lambda: pv.probs_bwd(*pb),
                lambda: _in_slices(pv.probs_bwd_plain, sl, 4, *pb), None,
                bound_ms(fl_t, by_t + 3 * 2 * nt + 4 * ut * ut), 0.0),
        }
        _time_mode_cases(cases, report, M, f"chairs, B={B}, M={M}")
        del q, k, vol, g_vol, p, g_p
        torch.cuda.empty_cache()
    time_flash_rows(dev, gen, report, biases)


def time_flash_rows(dev, gen, report, biases) -> None:
    """Phase 5, FLASH_ROWS at the serving shape: B2 at two modes (md 128)
    beside SDPA with the window as its mask, and B8 at one mode (md 256)
    with the --f2radius table beside SDPA with that table as its mask (and
    with no table beside SDPA without a mask, printed only), each beside its
    plain version, its bound and its exponentials' floor."""
    clip = torch.tensor(1e30, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, M in FLASH_ROWS:
        md = 256 // M
        q, k = inputs(gen, md, dev, U, modes=M)
        v = torch.randn(1, M, U, 256, generator=gen).to(dev, torch.bfloat16)
        n = M * U * U
        flops, nbytes = 2.0 * n * (md + 256), 2 * 2 * M * U * (md + 256)
        bms = bound_ms(flops, nbytes)
        if name == "flash_mode_attention":
            dense = (0.5 * ma.sliding_pos_biases(biases, H8, W8)).to(
                torch.bfloat16)
            args = (q, k, v, biases, (H8, W8), clip, 0.5)
            cases = {name: (lambda: ma.flash_mode_attention(*args),
                            lambda: ma.flash_mode_attention_plain(*args),
                            lambda: sdpa(q, k, v, attn_mask=dense), bms,
                            exp_ms(n))}
        else:
            table = (0.5 * ma.sliding_pos_biases(biases, H8, W8)
                     + setrans.attention_mask(H8, W8, F2RADIUS, dev))
            tmask = table.to(torch.bfloat16)
            t_bms = bound_ms(flops, nbytes + 4 * U * U)
            cases = {name: (
                lambda: ma.flash_mode_attention_dense(q, k, v, table, clip,
                                                      1.0),
                lambda: ma.flash_mode_attention_dense_plain(q, k, v, table,
                                                            clip, 1.0),
                lambda: sdpa(q, k, v, attn_mask=tmask), t_bms, exp_ms(n)),
                f"{name} (no table)": (
                lambda: ma.flash_mode_attention_dense(q, k, v, None, clip,
                                                      1.0),
                lambda: ma.flash_mode_attention_dense_plain(q, k, v, None,
                                                            clip, 1.0),
                lambda: sdpa(q, k, v), bms, exp_ms(n))}
        _time_mode_cases(cases, report, M, f"serving, M={M}, md={md}")
        del q, k, v, cases
        torch.cuda.empty_cache()


def _time_mode_cases(cases, report, M, where) -> None:
    """Time each case; a case without a row in the kernels line (B8 at 32
    modes, which no configuration of the phase launches) is printed only."""
    for name, (kern, plain, lib, (bms, by), exps) in cases.items():
        r = report.get(f"{name}_m{M}", {})
        r["ms"] = time_ms(kern, 3)
        r["plain_ms"] = time_ms(plain, 2)
        r["library_ms"] = time_ms(lib, 3) if lib is not None else None
        r["bound_ms"], r["bound_by"] = bms, by
        print(f"{name}_m{M} ({where}): {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {bms:.4f} ms ({by}), "
              f"exponentials floor {exps:.4f} ms, library "
              f"{r['library_ms']} | {card_line()}")
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
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
            ("corr_lookup", "corr_lookup",
             pallas + "corr_lookup.py:corr_lookup_pallas:134"),
            # No pallas_call: the JAX package takes XLA's VJP of
            # corr_lookup_mxu as the lookup's backward.
            ("corr_lookup_bwd", "corr_lookup",
             pallas + "corr_lookup.py:_lookup_bwd:198"),
            # B5 at D = 2 (two-way correlation): the same pallas_call with
            # D planes a level.
            ("corr_lookup_d2", "corr_lookup",
             pallas + "corr_lookup.py:_lookup_all_levels:98"),
            ("corr_lookup_bwd_d2", "corr_lookup",
             pallas + "corr_lookup.py:_lookup_bwd:198"),
            ("fused_agg_corr", "agg_corr",
             TPU_KERNEL.format("fused_agg_corr_mt:394")),
            ("agg_corr_bwd", "agg_corr",
             pallas + "corr_vjp.py:_pallas_agg_corr_bwd:75"),
            ("probs_bwd", "probs_bwd",
             pallas + "probs_vjp.py:_pallas_probs_bwd:80"),
            ("flash_mode_attention_dense", "flash_attn",
             TPU_KERNEL.format("flash_mode_attention:201")),
            # B2 at the lazy intra aggregator's width (F 128).
            ("flash_mode_attention_f128", "flash_attn",
             TPU_KERNEL.format("flash_mode_attention_mt:295")),
            ("fused_agg_corr_dense", "agg_corr",
             TPU_KERNEL.format("fused_agg_corr:1137")),
            ("mode_softmax_probs_dense", "softmax_probs",
             TPU_KERNEL.format("mode_softmax_probs:1047")),
            ("corr_norm_sums", "corr_norm",
             TPU_KERNEL.format("corr_norm_sums_mt:733")),
            ("corr_norm_write", "corr_norm",
             TPU_KERNEL.format("corr_norm_write_mt:772")),
            ("gru_pass_fwd", "sep_conv_gru",
             pallas + "sep_conv_gru.py:_gru_fwd:277"),
            ("gru_pass_bwd", "sep_conv_gru",
             pallas + "sep_conv_gru.py:_gru_bwd_vjp:319")):
        report[name] = dict(report["scores_global_max"], name=name,
                            source=SOURCE.format(src), replaces=tpu)
    # The kernels at one, eight and 32 modes (modes1, modes8, modes32): the
    # FMA bodies past md 64, the aggregating kernels' mode groups, and md 8
    # (the per-mode kernels' padded q and k, the aggregating kernels' FMA
    # body past 16 modes).
    for name in MODE_KERNELS:
        for M in MODE_ROWS:
            report[f"{name}_m{M}"] = dict(report[name], name=f"{name}_m{M}")
    for name, M in FLASH_ROWS:
        report[f"{name}_m{M}"] = dict(report[name], name=f"{name}_m{M}")

    gen = torch.Generator().manual_seed(0)
    check_kernels(dev, gen, report)
    check_b4_shapes(dev, gen, report)
    check_b1_peaks(dev, gen)
    torch.cuda.empty_cache()
    check_train_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_lookup(dev, report)
    check_lookup_radii(dev, report)
    check_lookup_planes(dev, report)
    torch.cuda.empty_cache()
    check_hd1k_grid(dev, gen)
    torch.cuda.empty_cache()
    check_b2_lazy(dev, gen, report)
    torch.cuda.empty_cache()
    check_dense_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_sp_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_sp_dense_kernels(dev, gen, report)
    check_sp_two_way_b9(dev, gen, report)
    check_sp_gma(dev, gen)
    torch.cuda.empty_cache()
    check_gru(dev, report)
    torch.cuda.empty_cache()
    check_mode_kernels(dev, gen, report)
    torch.cuda.empty_cache()
    check_oracle(dev)
    check_oracle_lsinu(dev)
    check_oracle_train(dev)
    check_oracle_train(dev, "lsinu")
    check_remat(dev)
    res = main_path(dev)
    for name, n in res["launches"].items():
        report[name]["launches"] = n
    torch.cuda.empty_cache()
    dres = dense_paths(dev)
    for name in ("flash_mode_attention_dense", "fused_agg_corr_dense",
                 "mode_softmax_probs_dense"):
        report[name]["launches"] = dres["lsinu"]["launches"][name]
    torch.cuda.empty_cache()
    tres = train_path(dev)
    for name in ("fused_agg_corr", "agg_corr_bwd", "probs_bwd",
                 "corr_lookup_bwd"):
        report[name]["launches"] = tres["launches"][name]
    torch.cuda.empty_cache()
    dense_train_phase(dev)
    gres = gru_path(dev)
    report["gru_pass_fwd"]["launches"] = \
        gres["serving torch.bfloat16"]["gru_pass_fwd"]
    report["gru_pass_bwd"]["launches"] = \
        gres["chairs torch.bfloat16"]["gru_pass_bwd"]
    eval_phase(dev)
    torch.cuda.empty_cache()
    eval_sets_phase(dev)
    torch.cuda.empty_cache()
    lres = lazy_intra_phase(dev)
    report["flash_mode_attention_f128"]["launches"] = \
        lres["hd1k lazy"]["b2_by_width"][LAZY_F]
    train_cli_phase(dev, float(np.median(tres["step_ms"])))
    torch.cuda.empty_cache()
    families_phase(dev)
    torch.cuda.empty_cache()
    wres = two_way_phase(dev)
    report["corr_lookup_d2"]["launches"] = \
        wres["serving"]["f1_private"]["launches"]["corr_lookup"]
    report["corr_lookup_bwd_d2"]["launches"] = \
        wres["training"]["launches"]["corr_lookup_bwd"]
    torch.cuda.empty_cache()
    mres = modes_phase(dev)
    for name in MODE_KERNELS:
        for M in MODE_ROWS:
            runs = mres["serving"] if name in SERVE_PER_PAIR \
                else mres["training"]
            report[f"{name}_m{M}"]["launches"] = \
                runs[f"modes{M}"]["launches"][name]
    for (name, M), config in zip(FLASH_ROWS, ("modes2", "modes1_f2radius")):
        report[f"{name}_m{M}"]["launches"] = \
            mres["serving"][config]["launches"][name]
    torch.cuda.empty_cache()
    time_kernels(dev, gen, report)
    time_b2_lazy(dev, gen, report)
    time_kitti_kernels(dev, gen)
    time_train_kernels(dev, gen, report)
    time_lookup(dev, report)
    time_lookup(dev, report, dim=LOOKUP_D)
    time_dense_kernels(dev, gen, report)
    time_gru(dev, report)
    time_mode_kernels(dev, gen, report)

    sres = sp_paths(dev)
    for name in ("corr_norm_sums", "corr_norm_write"):
        report[name]["launches"] = sres["ranks"][0]["launches"][name]
    torch.cuda.empty_cache()
    time_sp_kernels(dev, gen, report, report["fused_agg_corr_norm"]["ms"]
                    - report["scores_global_max"]["ms"])
    torch.cuda.empty_cache()
    sp_configs_phase(dev)
    torch.cuda.empty_cache()
    time_sp_dense_kernels(dev, gen)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--sp-rank" in sys.argv:  # a rank of the sequence-parallel phase
        sys.exit(sp_rank_main(sys.argv[sys.argv.index("--sp-rank") + 1],
                              "--sp-nccl" in sys.argv))
    if "--sp-config-rank" in sys.argv:  # a rank of the configurations' SP
        sys.exit(sp_config_rank_main(
            sys.argv[sys.argv.index("--sp-config-rank") + 1]))
    if "--sp-modes-rank" in sys.argv:  # a rank of the mode-count phase
        sys.exit(mode_sp_rank_main(
            sys.argv[sys.argv.index("--sp-modes-rank") + 1]))
    sys.exit(main())
