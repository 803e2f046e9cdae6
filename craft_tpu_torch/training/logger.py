"""Training logger (port of ``craft_tpu.training.logger``; reference
train.py:88-130, 288-308).

Running means with the learning rate and an ETA every print_freq steps;
validation histories plotted to {output}/{key}.png and train_epe.png
through matplotlib's Agg backend when matplotlib imports (the card's
machine has none: no plot, no error).  Its state is a plain dict, saved in
the checkpoints.

The metrics pushed may be 0-d tensors on the card: they stay there until a
status line, which brings them to the host in one copy.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def _host_means(running: Dict[str, list]) -> Dict[str, float]:
    """The mean of each metric's values; the tensors among them cross to
    the host in one copy."""
    keys, tensors = [], []
    for k, vals in running.items():
        for v in vals:
            if isinstance(v, torch.Tensor):
                keys.append(k)
                tensors.append(v.detach().float().reshape(()))
    host = torch.stack(tensors).tolist() if tensors else []
    it = iter(host)
    out = {}
    for k, vals in running.items():
        xs = [next(it) if isinstance(v, torch.Tensor) else float(v)
              for v in vals]
        out[k] = float(np.mean(xs))
    return out


class Logger:
    def __init__(self, num_steps: int, print_freq: int = 100,
                 output: str = "checkpoints"):
        self.num_steps = num_steps
        self.print_freq = print_freq
        self.output = output
        self.total_steps = 0
        self.running: Dict[str, list] = {}
        self.train_epe_list: List[float] = []
        self.train_steps_list: List[int] = []
        self.val_steps_list: List[int] = []
        self.val_results_dict: Dict[str, List[float]] = {}

    def state_dict(self) -> Dict:
        return {k: getattr(self, k) for k in
                ("total_steps", "train_epe_list", "train_steps_list",
                 "val_steps_list", "val_results_dict")}

    def load_state_dict(self, state: Dict):
        self.__dict__.update(state)

    def push(self, metrics: Dict, lr: float):
        self.total_steps += 1
        for k, v in metrics.items():
            self.running.setdefault(k, []).append(v)
        if self.total_steps % self.print_freq == self.print_freq - 1:
            self._print_status(lr)

    def _print_status(self, lr: float):
        means = _host_means(self.running)
        keys = sorted(means)
        header = f"[{self.total_steps + 1:6d}, {lr:10.7f}] "
        body = ", ".join(f"{k} {means[k]:.4f}" for k in keys if k != "time")
        eta = ""
        if "time" in means:
            left = int((self.num_steps - self.total_steps - 1) * means["time"])
            eta = f"  {left // 3600:02d}h{left % 3600 // 60:02d}m"
        print(header + body + eta, flush=True)
        if "epe" in means:
            self.train_epe_list.append(means["epe"])
            self.train_steps_list.append(self.total_steps)
        self.running = {}

    def push_validation(self, results: Dict[str, float]):
        for k, v in results.items():
            self.val_results_dict.setdefault(k, []).append(float(v))
        self.val_steps_list.append(self.total_steps)

    def plot_train(self):
        self._plot(self.train_steps_list, self.train_epe_list, "EPE",
                   os.path.join(self.output, "train_epe.png"),
                   "Running training error (EPE)")

    def plot_val(self):
        for key, vals in self.val_results_dict.items():
            self._plot(self.val_steps_list[-len(vals):], vals, key,
                       os.path.join(self.output, f"{key}.png"),
                       f"Results for {key} for the validation set")

    @staticmethod
    def _plot(xs, ys, ylabel, path, title):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.figure()
        plt.plot(xs, ys)
        plt.xlabel("x_steps")
        plt.ylabel(ylabel)
        plt.title(title)
        plt.savefig(path, bbox_inches="tight")
        plt.close()
