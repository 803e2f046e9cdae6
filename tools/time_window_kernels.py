"""Times of the serving attention kernels with the sliding window, B1
(scores_global_max), B2 (flash_mode_attention), B3 (fused_agg_corr_norm) and
B4 (mode_softmax_probs, int8), at the serving shape (B=1, M=4, 440x1024 ->
U=7040, W8=128) over CUDA events, for the craft_tpu_torch package under
--root (default: this checkout), so that two checkouts can be compared in
one call on one card:

    python tools/time_window_kernels.py --root build/parent --reps 20

Builds that checkout's kernels into its own build/kernels/.  Seeded inputs
(q, k ~ N(0, 1.5^2) bf16, the window ~ N(0, 0.5^2)), the clamp off.  Each
kernel is timed in ROUNDS rounds of `reps` calls (the rounds of the four
kernels interleaved, so that a disturbance of the card spreads over all of
them); a round's time is its mean per call.  Prints the card (nvidia-smi
name, power limit) and one JSON line: per kernel the median round (ms per
call), every round, and a SHA-256 prefix of its output bytes (equal
prefixes: the checkouts' results are bit-identical).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 7


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from craft_tpu_torch.ops.kernels import mode_attention as ma
    if not torch.cuda.is_available():
        print("time_window_kernels: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    assert Path(ma.__file__).resolve().is_relative_to(root), ma.__file__
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    grid = (55, 128)
    u = grid[0] * grid[1]

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)
    q64, k64 = (randn(1, 4, u, 64, std=1.5).bfloat16() for _ in range(2))
    q32, k32 = (randn(1, 4, u, 32, std=1.5).bfloat16() for _ in range(2))
    v = randn(1, 4, u, 256).bfloat16()
    biases = randn(15, 15, std=0.5)
    clip = torch.tensor(1e30, device=dev)
    one = torch.tensor(1.0, device=dev)
    cases = {
        "B1_ms": lambda: ma.scores_global_max(q64, k64, 0.125),
        "B2_ms": lambda: ma.flash_mode_attention(q64, k64, v, biases, grid,
                                                 clip, 0.5),
        "B3_ms": lambda: ma.fused_agg_corr_norm(q64, k64, biases, grid,
                                                100.0, 0.5, one, one),
        "B4_ms": lambda: ma.mode_softmax_probs(q32, k32, biases, grid, clip,
                                               1.0, quantized=True),
    }
    out = {"root": str(root)}
    for name, fn in cases.items():
        res = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in res if isinstance(res, tuple) else (res,):
            digest.update(t.reshape(-1).view(torch.uint8).cpu().numpy()
                          .tobytes())
        out[name.replace("_ms", "_sha")] = digest.hexdigest()[:16]
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
        out[name] = statistics.median(times)
        out[name.replace("_ms", "_rounds")] = times
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
