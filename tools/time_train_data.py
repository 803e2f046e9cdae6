"""Host-side cost of the training data: the chairs stage's items and loader.

    python tools/time_train_data.py [--root DIR] [--items 24]

Writes a synthetic FlyingChairs tree at the dataset's 384x512 with
``chip_smoke.write_chairs`` (under build/time_train_data/ unless --root),
then prints one JSON line: ms per augmented item of the port's
``fetch_training_dataset("chairs")`` (decode, augmentation, casts), the
same for the JAX package's dataset where it imports (it needs PIL and
OpenCV), and the steady batches/s of the port's loader (batch 8, 4 worker
processes, ``chip_smoke.loader_rate``).  These are host numbers of the
machine it runs on, whose CPU it names.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from craft_tpu_torch.data.datasets import fetch_training_dataset  # noqa: E402


def item_ms(dataset, n: int) -> float:
    """Mean ms of dataset[i] over n items, both global streams seeded."""
    np.random.seed(0)
    random.seed(0)
    dataset[0]  # colour tables, file cache
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i % len(dataset)]
    return (time.perf_counter() - t0) / n * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO / "build" / "time_train_data"))
    ap.add_argument("--items", type=int, default=24)
    args = ap.parse_args()
    root = Path(args.root)
    if not (root / "FlyingChairs_release").is_dir():
        chip_smoke.write_chairs(root, chip_smoke.TRAIN_PAIRS,
                                chip_smoke.VAL_PAIRS, chip_smoke.CHAIRS_HW)
    crop = (chip_smoke.CROP_H, chip_smoke.CROP_W)
    out = {"cpu": platform.processor() or platform.machine(),
           "cpu_count": os.cpu_count(),
           "port_item_ms": item_ms(fetch_training_dataset(
               "chairs", crop, data_root=str(root)), args.items)}
    try:
        from craft_tpu.data.datasets import fetch_training_dataset as jax_fetch
    except ImportError as e:  # no PIL or OpenCV on this machine
        out["jax_item_ms"] = f"not measured: {e}"
    else:
        out["jax_item_ms"] = item_ms(jax_fetch("chairs", crop,
                                               data_root=str(root)),
                                     args.items)
    out.update({f"loader_{k}": v
                for k, v in chip_smoke.loader_rate(root).items()})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
