"""The row-sharded attention and correlation sites (the port's counterpart
of ``craft_tpu.parallel.sequence_parallel``): each rank computes its
RowShard's query rows against every key with the same hand kernels as one
device, and the shards meet in RowShard's collectives where a result needs
every row: the clamp predicate (B1's local maximum, all-maxed over the
ranks) and the volume's moments.

Every site takes the clamp of ``sp_clip``.  With the sliding bias, B2 and
B4 take the shard's row offset (``q_row0``) and its rows of q directly
(``nn/setrans.py``), and the inter site runs ``sp_fused_agg_corr_norm_mt``
(B9 in place of B3).  With a dense table (lsinu, the --f2radius mask) the
table holds the shard's rows and the dense kernels run on them as they
are: B6 dense (the raw fp32 volume, normed by
``ops/corr.py:build_pyramid`` with the moments of every rank's rows), B8
(the f2 and f1 sites) and B4 dense (the intra site's float probs); these
are the counterparts of the JAX package's ``sp_fused_agg_corr`` and
``sp_flash_mode_attention`` (``craft_tpu/parallel/sequence_parallel.py:96,
225``).
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.mode_attention import (
    corr_norm_sums, corr_norm_write, scores_global_max)
from craft_tpu_torch.parallel.sp import RowShard


def sp_clip(shard: RowShard, q, k, attn_clip: float) -> torch.Tensor:
    """The clamp of the shard's rows q against every key k: attn_clip where
    the raw max of the scores over every rank's rows exceeds it, else none
    (1e30); a 0-d fp32 tensor on q's device."""
    gmax = shard.all_max(scores_global_max(q.detach(), k.detach(),
                                           1.0 / math.sqrt(q.shape[-1])))
    return torch.where(gmax > attn_clip, torch.full_like(gmax, attn_clip),
                       torch.full_like(gmax, 1e30))


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
