"""The training CLI at mode dims below 16, on the CPU: each set of flags
that exited before the port took them (32 f2 modes, craft_nogma's f2 site
at 64, --f1 shared at 32 f2 modes, 16 intra modes) gives the JAX CLI's
config, field by field, and one step of the chairs stage runs with it
(tests/test_torch_train_cli.py's check, out of that file: it is the
tier-1 run's longest).
"""

import pytest

from test_torch_modes import _one_thread  # noqa: F401
from test_torch_train_cli import (
    chairs_tree,  # noqa: F401  (the module fixture, a tree of its own here)
    test_cli_trains_other_mode_counts as _trains)


@pytest.mark.parametrize("flags", [
    ["--f2modes", "32"], ["--nogma", "--intramodes", "64"],
    ["--f1", "shared", "--f2modes", "32"], ["--intramodes", "16"]],
    ids=lambda v: "_".join(v))
def test_cli_trains_mode_dims_below_16(chairs_tree, tmp_path,  # noqa: F811
                                       flags):
    _trains(chairs_tree, tmp_path, flags)
