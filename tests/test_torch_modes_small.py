"""Mode dims below 16 (32 to 256 modes at the 256-wide sites, 16 to 128 at
the 128-wide intra site) in the port's CLIs, weights and FLOP count, on
the CPU (tests/test_torch_modes.py's checks at these counts).

* Each count at each site, and under each family and flag that has such a
  site, resolves to the JAX CLI's ``ModelConfig`` field by field.
* ``--flop``'s analytic table at modes32, modes256 and modes_small_mixed
  against the JAX package's (craft_tpu/eval/flops.py).
* The modes32 and modes256 trees round-trip through
  ``state_dict_from_flax`` and the JAX package's ``convert_torch_state``
  bit for bit and load strictly into the port's FlowModel;
  ``tools/jax_checkpoint_to_pth.py`` carries a JAX checkpoint of them into
  the port, weights and Adam moments bit for bit.
"""

import pytest

import craft_tpu.cli as jcli
from craft_tpu_torch import cli as tcli

from test_torch_modes import (
    _one_thread, parse, same_config,  # noqa: F401
    test_flop_breakdown_matches_jax as _flops,
    test_jax_checkpoint_tool_carries_the_tree as _tool,
    test_trees_round_trip_and_load as _round_trip)

SETRANS = ["--craft", "--setrans"]
ACCEPTED = (
    [SETRANS + ["--intermodes", str(m)] for m in (32, 64, 128, 256)]
    + [SETRANS + ["--f2modes", str(m)] for m in (32, 64, 128, 256)]
    + [SETRANS + ["--intramodes", str(m)] for m in (16, 32, 64, 128)]
    + [SETRANS + ["--f1", "private", "--intermodes", "64"],
       SETRANS + ["--f1", "shared", "--f2modes", "128"],
       SETRANS + ["--f2radius", "3", "--f2modes", "32"],
       SETRANS + ["--interpos", "lsinu", "--intrapos", "lsinu",
                  "--intermodes", "256", "--intramodes", "128"],
       SETRANS + ["--f2", "none", "--intermodes", "32"],
       ["--craft", "--intermodes", "128", "--f2modes", "64"],
       ["--nogma", "--intramodes", "256"], ["--nogma", "--intermodes", "32"],
       SETRANS + ["--intermodes", "64", "--f2modes", "128", "--intramodes",
                  "32", "--mixed_precision"]])


@pytest.mark.parametrize("flags", ACCEPTED,
                         ids=lambda v: "_".join(v).replace("--", ""))
def test_small_md_counts_resolve_to_the_jax_config(flags):
    same_config(tcli.model_config_from_args(parse(tcli, flags)),
                jcli.model_config_from_args(parse(jcli, flags)))


@pytest.mark.parametrize("flags", [
    SETRANS + ["--intermodes", "512"], SETRANS + ["--intramodes", "256"],
    SETRANS + ["--f2modes", "96"], ["--nogma", "--intramodes", "48"]],
    ids=lambda v: "_".join(v).replace("--", ""))
def test_counts_past_the_width_exit(flags):
    """A count past the width, or one that does not divide it, exits."""
    with pytest.raises(SystemExit, match="must divide"):
        tcli.model_config_from_args(parse(tcli, flags))


@pytest.mark.parametrize("name", ["modes32", "modes256",
                                  "modes_small_mixed"])
def test_flop_breakdown_matches_jax_below_md16(name):
    _flops(name)


@pytest.mark.parametrize("name", ["modes32", "modes256"])
def test_trees_round_trip_and_load_below_md16(name):
    _round_trip(name)


@pytest.mark.parametrize("name", ["modes32", "modes256"])
def test_jax_checkpoint_tool_carries_the_tree_below_md16(name, tmp_path):
    _tool(name, tmp_path)
