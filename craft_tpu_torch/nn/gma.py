"""GMA attention and aggregation (PyTorch port of ``craft_tpu.nn.gma``;
reference core/gma.py:6-142).

``Attention`` gives softmaxed [B, heads, U, U] attention over frame 1's
context features (content, positions through ``RelPosEmb``, or both);
``Aggregate`` applies it to the projected motion features, with a learned
scalar gate on the residual.  Every product runs in the compute dtype with
fp32 accumulation and the softmax in fp32, its output cast to the compute
dtype, as the JAX package's einsums and ``nn.softmax``.  The JAX package
leaves all of it to XLA, so the port runs stock PyTorch here.

Outside autograd (serving) the attention is built a few grid rows at a
time into its output, so the fp32 scores never exist whole (7.6 GB each
at HD1K's U = 43520); with gradients on it is one piece, whose fp32 softmax
output autograd keeps for the backward.

Under sequence parallelism (`shard`, a ``RowShard``; serving) ``Attention``
builds only the shard's query rows against every key, its relative
positions read from the shard's global grid rows, and ``Aggregate`` takes
those rows against every token's values, adds the residual of the shard's
rows and gathers the result to every rank: the JAX package's
``sp_shard(sim, 2)`` (``craft_tpu/nn/gma.py:93-96``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# Scores (elements) a row chunk of the attention holds outside autograd.
ROW_CHUNK_ELEMS = 1 << 27


def rel_pos_index(n: int, max_pos_size: int, device=None) -> torch.Tensor:
    """[n, n] rows of a 2 * max_pos_size - 1 row table, index j - i +
    max_pos_size - 1 at (i, j), read as the JAX package's gather reads it
    (``craft_tpu/nn/gma.py:41-46``): a negative index wraps once, then
    every index is clamped into the table.  Only a grid side above
    max_pos_size reaches outside the table (HD1K's W8 = 320)."""
    rows = 2 * max_pos_size - 1
    ar = torch.arange(n, device=device)
    idx = ar[None, :] - ar[:, None] + max_pos_size - 1
    idx = torch.where(idx < 0, idx + rows, idx)
    return idx.clamp(0, rows - 1)


def _linear(x, module: nn.Conv2d, dtype):
    """A bias-free 1x1 conv on NHWC x, in `dtype`."""
    return F.linear(x.to(dtype), module.weight.flatten(1).to(dtype))


class RelPosEmb(nn.Module):
    """Decomposed relative position scores (reference gma.py:6-50): for a
    query at grid (x, y) and a key at (u, v), <q, rel_height[u - x]> +
    <q, rel_width[v - y]>."""

    def __init__(self, max_pos_size: int = 160, dim_head: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.max_pos_size = max_pos_size
        self.dtype = dtype
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)

    def forward(self, q: torch.Tensor, h: int, w: int, x0: int = 0
                ) -> torch.Tensor:
        """q: [B, heads, xs, w, d], the queries of grid rows x0:x0 + xs.
        Returns their [B, heads, xs, w, h, w] scores in q's dtype."""
        dt, xs = self.dtype, q.shape[2]
        idx_h = rel_pos_index(h, self.max_pos_size, q.device)[x0:x0 + xs]
        idx_w = rel_pos_index(w, self.max_pos_size, q.device)
        emb_h = self.rel_height.weight[idx_h].to(dt)  # [xs, h, d] (x, u)
        emb_w = self.rel_width.weight[idx_w].to(dt)   # [w, w, d] (y, v)
        height = torch.einsum("bnxyd,xud->bnxyu", q, emb_h)
        width = torch.einsum("bnxyd,yvd->bnxyv", q, emb_w)
        return height[..., :, None] + width[..., None, :]


class Attention(nn.Module):
    """GMA attention over context features (reference gma.py:53-102):
    [B, heads, U, U] in the compute dtype.  Content-only attention keeps
    pos_emb's parameters unused, as the reference model does."""

    def __init__(self, dim: int = 128, max_pos_size: int = 160,
                 heads: int = 1, dim_head: int = 128,
                 position_only: bool = False,
                 position_and_content: bool = False, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.position_only = position_only
        self.position_and_content = position_and_content
        self.to_qk = nn.Conv2d(dim, heads * dim_head * 2, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head, dtype)

    def forward(self, fmap: torch.Tensor, shard=None) -> torch.Tensor:
        """fmap: [B, h, w, dim] -> [B, heads, h*w, h*w]; under `shard` the
        shard's query rows, [B, heads, rows*w, h*w]."""
        B, h, w, _ = fmap.shape
        dt, n, d = self.dtype, self.heads, self.dim_head
        U = h * w
        h0, h1 = (0, h) if shard is None else (shard.h0, shard.h1)
        q, k = _linear(fmap, self.to_qk, dt).chunk(2, dim=-1)
        # The scale is rounded to the compute dtype first, as JAX's
        # weakly typed scalar.
        q = q[:, h0:h1].reshape(B, h1 - h0, w, n, d).permute(0, 3, 1, 2, 4) \
            * torch.tensor(d ** -0.5, dtype=dt, device=q.device)
        kt = k.reshape(B, U, n, d).permute(0, 2, 3, 1)  # [B, n, d, U]
        if torch.is_grad_enabled():
            return self._probs(q, kt, h, w, h0)
        out = torch.empty(B, n, (h1 - h0) * w, U, dtype=dt,
                          device=fmap.device)
        rows = max(1, ROW_CHUNK_ELEMS // (B * n * w * U))
        for x0 in range(h0, h1, rows):
            x1 = min(h1, x0 + rows)
            out[:, :, (x0 - h0) * w:(x1 - h0) * w] = self._probs(
                q[:, :, x0 - h0:x1 - h0], kt, h, w, x0)
        return out

    def _probs(self, q, kt, h, w, x0):
        """The softmaxed attention of the query rows q [B, n, xs, w, d]
        (grid rows x0:x0 + xs) against every key."""
        B, n, xs = q.shape[:3]
        sim = None
        if not self.position_only:
            sim = torch.matmul(q.reshape(B, n, xs * w, -1), kt)
        if self.position_only or self.position_and_content:
            pos = self.pos_emb(q, h, w, x0).reshape(B, n, xs * w, h * w)
            sim = pos if sim is None else sim + pos
        return torch.softmax(sim.float(), dim=-1).to(self.dtype)


class Aggregate(nn.Module):
    """Attention-weighted aggregation of the motion features with a gated
    residual (reference gma.py:105-142); ``project`` exists only when
    heads * dim_head != dim, and ``gamma`` starts at zero."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.project = (nn.Conv2d(inner, dim, 1, bias=False)
                        if inner != dim else None)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor, shard=None
                ) -> torch.Tensor:
        """attn: [B, heads, U, U]; fmap: [B, h, w, dim] -> [B, h, w, dim].
        Under `shard` attn holds the shard's query rows [B, heads,
        rows*w, U], and the shard's rows of the output are gathered to
        every rank."""
        B, h, w, C = fmap.shape
        dt, n, d = self.dtype, self.heads, self.dim_head
        v = _linear(fmap, self.to_v, dt).reshape(B, h * w, n, d)
        out = torch.matmul(attn.to(dt), v.transpose(1, 2))  # [B, n, U1, d]
        out = out.transpose(1, 2).reshape(B, -1, w, n * d)
        if self.project is not None:
            out = _linear(out, self.project, dt)
        if shard is None:
            return fmap + self.gamma.to(dt) * out
        out = fmap[:, shard.h0:shard.h1] + self.gamma.to(dt) * out
        return shard.gather(out.reshape(B, -1, C)).reshape(B, h, w, C)
