"""The --attn_diag step under lsinu at every site (seeded pos_fc weights in
the oracle tree) against the JAX package's on the CPU:
tests/test_torch_attn_diag.py's check, with attn_clip at its default and
at 1.0 (every site clamps)."""

import pytest

from test_torch_attn_diag import CLAMP_CLIP, check_diagnostics
from test_torch_train_dense import _one_thread  # noqa: F401


@pytest.mark.parametrize("clip", [None, CLAMP_CLIP], ids=["default", "1.0"])
def test_lsinu_diagnostics_step_matches_jax(clip):
    check_diagnostics("lsinu", clip)
