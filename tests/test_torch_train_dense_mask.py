"""The port's training step under --f2radius 3 (the f2 site's mask over
pos_w times the dense sliding bias) against the JAX train path on the
CPU, in fp32 and mixed precision: tests/test_torch_train_dense.py's
checks, the sliding window's gradient among those held in fp32.  Under
--f2radius alone only the f2 site takes the plain path; the intra and
inter sites keep the training kernels' plain versions (B1, B4 float with
B7, B6 with its backward)."""

import pytest

from test_torch_train_dense import _one_thread  # noqa: F401
from test_torch_train_dense import check_fp32, check_mixed


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
def test_f2radius_train_step_matches_jax(mixed):
    (check_mixed if mixed else check_fp32)("f2radius 3")
