"""One training step at mode dims below 16, port against the JAX train
path on the CPU: the modes32 configuration (--intermodes 32 --f2modes 32
--intramodes 16: md 8 at every site; B6 and its backward at 32 modes, B4
and B7 at md 8) with the tree of tests/test_torch_modes.py, at 64x64,
batch 2, 2 iterations, dropout rates 0, fp32, at
tests/test_torch_training.py's bounds (tests/test_torch_modes_train.py's
check: the encoders' fp32 gradients against the same encoder run in
float64 on the step's own inputs and output cotangent; the mixed-precision
step at other counts is there).
"""

from test_torch_modes import _one_thread, modes_tree  # noqa: F401
from test_torch_modes_train import _batch, _jax_step, check_fp32_step

NAME = "modes32"


def test_fp32_train_step_matches_jax_below_md16():
    check_fp32_step(_jax_step(False, modes_tree(NAME), _batch(), NAME), NAME)
