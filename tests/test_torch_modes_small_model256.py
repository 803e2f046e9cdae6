"""The modes256 model (--intermodes 256 --f2modes 256 --intramodes 128: a
mode dim of 1 at every site) against the JAX package on the CPU at 64x64,
3 iterations (tests/test_torch_modes_model.py's check and bounds: fp32
flows within 1e-4 px, mixed precision within 0.05 px).
"""

import pytest

from test_torch_modes import _one_thread  # noqa: F401
from test_torch_modes_model import test_flow_matches_jax as _flow


@pytest.mark.parametrize("mixed_precision", [False, True],
                         ids=["fp32", "mixed"])
def test_modes256_flow_matches_jax(mixed_precision):
    _flow("modes256", mixed_precision)
