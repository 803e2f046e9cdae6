"""The f2 SETrans site at 128 and 256 modes (md 2 and 1): eval and
``jax.vjp`` against the JAX package on the CPU (tests/test_torch_modes_small_
f2.py's check at the other counts past 16).
"""

import pytest

from test_torch_modes_small_sites import MODES, clip
from test_torch_modes_sites import (
    test_site_eval_matches_jax as _eval,
    test_site_gradients_match_jax_vjp as _vjp)
from test_torch_train_dense import _one_thread  # noqa: F401


@pytest.mark.parametrize("modes", (128, 256))
def test_f2_site_eval_matches_jax_below_md16(modes):
    _eval("f2", modes, clip("f2", modes))


@pytest.mark.parametrize("modes", (128, 256))
def test_f2_site_gradients_match_jax_vjp_below_md16(modes):
    _vjp("f2", modes, clip("f2", modes))
