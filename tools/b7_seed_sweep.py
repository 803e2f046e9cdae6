"""B7 backward (probs_bwd) in fp32 against its plain version on the card,
over many seeds of the cases of tests/test_torch_kernels_cuda.py::
test_b7_backward (grids 5x12 and 3x128, md 32 and 64, the clamp off and
on): the worst per-row error over the row max of dc (the bound of 1e-3 that
the test held before) and over A = sum_j |p_j g_j| (the bound it holds now,
(2U + 16) 2^-24, derived in the test's b7_fp32_bound).

    python tools/b7_seed_sweep.py [--seeds 200]

Prints the card (nvidia-smi name, power limit) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import test_torch_kernels_cuda as T  # noqa: E402
from craft_tpu_torch.ops.kernels import mode_attention as ma  # noqa: E402
from craft_tpu_torch.ops.kernels import probs_vjp as pv  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b7_seed_sweep: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    worst_old, worst_new, over_old = (0.0, None), (0.0, None), 0
    n = 0
    for seed in range(args.seeds):
        for grid in T.GRIDS:
            for md in (32, 64):
                for clip in (1e30, 0.4):
                    q, k, biases = T._inputs(dev, grid, md, torch.float32,
                                             seed=seed, **T._PEAKY)
                    p = ma.mode_softmax_probs_plain(
                        q, k, biases, grid, torch.tensor(clip, device=dev),
                        1.0, out_dtype=torch.float32)
                    g = torch.randn(p.shape, generator=T._gen(
                        seed + 1000)).to(dev)
                    dc, _ = pv.probs_bwd(q, k, p, g, clip)
                    wdc, _ = pv.probs_bwd_plain(q, k, p, g, clip)
                    keep = T._outside_band(q, k, clip)
                    old = T._rel(dc * keep, wdc * keep, -1)
                    new = T.b7_fp32_row_err(dc * keep, wdc * keep, p, g) \
                        / T.b7_fp32_bound(q.shape[2])
                    case = dict(seed=seed, grid=grid, md=md, clip=clip)
                    over_old += old > 1e-3
                    if old > worst_old[0]:
                        worst_old = (old, case)
                    if new > worst_new[0]:
                        worst_new = (new, case)
                    n += 1
    print(json.dumps({
        "cases": n,
        "worst_err_over_row_max": worst_old[0], "at": worst_old[1],
        "cases_over_1e-3": over_old,
        "worst_err_over_A_in_bounds": worst_new[0], "at_A": worst_new[1]}))
    return 0 if worst_new[0] <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
