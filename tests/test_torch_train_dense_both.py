"""The port's training step under lsinu at every site and --f2radius 3
together (the f2 site's mask with no sliding bias) against the JAX train
path on the CPU, in fp32 and mixed precision: tests/
test_torch_train_dense.py's checks, pos_fc's gradients among those held
in fp32."""

import pytest

from test_torch_train_dense import _one_thread  # noqa: F401
from test_torch_train_dense import check_fp32, check_mixed


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
def test_lsinu_f2radius_train_step_matches_jax(mixed):
    (check_mixed if mixed else check_fp32)("lsinu, f2radius 3")
