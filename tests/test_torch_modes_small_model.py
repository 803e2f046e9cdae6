"""Whole models at mode dims below 16, port against the JAX package on the
CPU at 64x64, 3 iterations (tests/test_torch_modes_model.py's check):
modes32 (--intermodes 32 --f2modes 32 --intramodes 16, md 8 at every site;
modes256, 256, 256 and 128 modes at md 1, in
tests/test_torch_modes_small_model256.py), with the trees of
tests/test_torch_modes.py.  Bounds: fp32 flows within 1e-4 px, mixed
precision within 0.05 px.
"""

import pytest

from test_torch_modes import _one_thread  # noqa: F401
from test_torch_modes_model import test_flow_matches_jax as _flow


@pytest.mark.parametrize("mixed_precision", [False, True],
                         ids=["fp32", "mixed"])
def test_flow_matches_jax_below_md16(mixed_precision):
    _flow("modes32", mixed_precision)
