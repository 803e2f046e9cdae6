"""The row-sharded inter site (the port's counterpart of
``craft_tpu.parallel.sequence_parallel``): each rank computes its RowShard's
query rows of the normed volume against every key with the same hand
kernels as one device, and the shards meet in RowShard's collectives where
the norm needs the whole volume.  The f2 and intra sites need no wrapper:
B1, B2 and B4 take the shard's row offset (``q_row0``) and its rows of q
directly, with the clamp predicate all-maxed over the ranks
(``nn/setrans.py``).
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.mode_attention import (
    corr_norm_sums, corr_norm_write, scores_global_max)
from craft_tpu_torch.parallel.sp import RowShard


def sp_fused_agg_corr_norm_mt(shard: RowShard, q, k, biases,
                              attn_clip: float, pos_w: float, agg_w, agg_b,
                              out_dtype=torch.bfloat16, eps: float = 1e-12):
    """The shard's rows [B, U_local, U] of B3's volume, clamped by the
    global raw max and normed by the moments of the whole volume: local B1
    -> all_max -> B9 sums -> all_sum -> B9 write.  q holds the shard's rows
    [B, M, U_local, md], k every token."""
    grid_hw = (shard.H8, shard.W8)
    gmax = shard.all_max(scores_global_max(q, k, 1.0 / math.sqrt(q.shape[-1])))
    sums = shard.all_sum(corr_norm_sums(q, k, biases, grid_hw, gmax,
                                        attn_clip, pos_w, agg_w, agg_b,
                                        q_row0=shard.h0))
    return corr_norm_write(q, k, biases, grid_hw, gmax, sums, attn_clip,
                           pos_w, agg_w, agg_b, q_row0=shard.h0,
                           out_dtype=out_dtype, eps=eps)
