"""The intra SETrans site at mode dims below 16 (16 to 128 modes, md 8 to
1), port against the JAX package's XLA path on the CPU: in eval mode (B4
float's plain version), through ``jax.vjp`` in train mode, and on the plain
path at 16 modes (tests/test_torch_modes_small_sites.py's cases, bounds and
clamp).
"""

import pytest

from test_torch_modes_small_sites import MODES, clip
from test_torch_modes_sites import (
    test_plain_site_matches_jax_vjp as _plain_vjp,
    test_site_eval_matches_jax as _eval,
    test_site_gradients_match_jax_vjp as _vjp)
from test_torch_train_dense import _one_thread  # noqa: F401


@pytest.mark.parametrize("modes", MODES["intra"])
def test_intra_site_eval_matches_jax_below_md16(modes):
    _eval("intra", modes, clip("intra", modes))


@pytest.mark.parametrize("modes", MODES["intra"])
def test_intra_site_gradients_match_jax_vjp_below_md16(modes):
    _vjp("intra", modes, clip("intra", modes))


def test_intra_plain_site_matches_jax_vjp_below_md16():
    _plain_vjp("intra", 16, clip("intra", 16))
