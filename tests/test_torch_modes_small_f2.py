"""The f2 SETrans site at 32 and 64 modes (md 8 and 4), port against the
JAX package's XLA path on the CPU: in eval mode (B2's plain version) and
through ``jax.vjp`` in train mode, every parameter and the input, from a
seeded cotangent (tests/test_torch_modes_small_sites.py's cases, bounds and
clamp; 128 and 256 modes in test_torch_modes_small_f2_wide.py).
"""

import pytest

from test_torch_modes_small_sites import MODES, clip
from test_torch_modes_sites import (
    test_site_eval_matches_jax as _eval,
    test_site_gradients_match_jax_vjp as _vjp)
from test_torch_train_dense import _one_thread  # noqa: F401


@pytest.mark.parametrize("modes", (32, 64))
def test_f2_site_eval_matches_jax_below_md16(modes):
    _eval("f2", modes, clip("f2", modes))


@pytest.mark.parametrize("modes", (32, 64))
def test_f2_site_gradients_match_jax_vjp_below_md16(modes):
    _vjp("f2", modes, clip("f2", modes))
