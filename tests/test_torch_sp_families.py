"""Sequence parallelism of the port for the families other than full CRAFT,
on the CPU: RAFT (the plain volume's rows), GMA with --position_and_content
(the attention's rows with their global relative positions, at a reduced
max_pos_size of 6 below both grid sides, so that every row reads the table
where JAX's gather wraps and clamps), CRAFT with GMA attention, craft_nogma
and --f2 none, each at 64x64 (H8 = W8 = 8), 2 iterations, on 2 and 3
ranks against the JAX package's ``Evaluator(seq_parallel=True)`` and the
port's unsharded forward, with ``test_torch_sp_dense.py``'s machinery,
weights and bounds.  GMA's rows of one shard are also held against the
unsharded attention in process, grid row by grid row.  A spawned rank
imports this module, so it imports no JAX at module level.
"""

import types

import pytest
import torch

from craft_tpu_torch.nn.gma import Attention
from test_torch_sp_dense import SpRuns, WORLDS, check_flows

MAX_POS = 6  # GMA's RelPosEmb tables of 2 * 6 - 1 rows, below 8

# name -> builder(config module, mixed_precision) of the same config in
# both packages.
CONFIGS = {
    "raft": lambda c, mp: c.raft_config(mixed_precision=mp),
    "gma_position_and_content": lambda c, mp: c.gma_config(
        mixed_precision=mp).replace(position_and_content=True,
                                    gma_max_pos_size=MAX_POS),
    "craft_gma": lambda c, mp: c.craft_config(mixed_precision=mp,
                                              use_setrans=False),
    "craft_nogma": lambda c, mp: c.craft_nogma_config(mixed_precision=mp),
    "craft_f2_none": lambda c, mp: c.craft_config(mixed_precision=mp,
                                                  f2trans="none"),
}
HW = (64, 64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return SpRuns("test_torch_sp_families", CONFIGS, HW,
                  tmp_path_factory.mktemp("sp_families"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sp_flow_matches_jax_and_unsharded(runs, name, world):
    check_flows(runs, name, world)


@pytest.mark.parametrize("rows", [(0, 3), (3, 6), (6, 8), (5, 7)])
@pytest.mark.parametrize("mode", ["position_only", "position_and_content"])
def test_gma_attention_rows_of_a_shard(rows, mode):
    """Attention on a shard (rows h0:h1 of an 8 x 12 grid, above MAX_POS on
    both sides) gives those rows of the unsharded attention within fp32
    rounding, in serving (row chunks) and under autograd (one piece)."""
    torch.manual_seed(0)
    att = Attention(dim=32, max_pos_size=MAX_POS, dim_head=16,
                    **{mode: True}).eval()
    for emb in (att.pos_emb.rel_height, att.pos_emb.rel_width):
        torch.nn.init.normal_(emb.weight)
    fmap = torch.randn(1, 8, 12, 32)
    h0, h1 = rows
    shard = types.SimpleNamespace(h0=h0, h1=h1)
    want = att(fmap)[:, :, h0 * 12:h1 * 12]
    with torch.no_grad():
        torch.testing.assert_close(att(fmap, shard=shard), want, rtol=1e-5,
                                   atol=1e-7)
    torch.testing.assert_close(att(fmap, shard=shard).detach(), want,
                               rtol=1e-5, atol=1e-7)
