"""The SETrans attention kernels of the inference path, each beside its
plain PyTorch version (counterparts of ``craft_tpu/ops/pallas/
mode_attention.py``):

  B1 scores_global_max      max of scale * q k^T (the clamp predicate)
  B2 flash_mode_attention   softmax(clamp(s) + pos_w * bias) @ v, f2 site
                            (F 256) and the lazy intra aggregator (F 128)
  B3 fused_agg_corr_norm    clamped, mode-aggregated, globally normed
                            volume, inter site
  B4 mode_softmax_probs     softmax probs (float, or int8 + row scale),
                            intra site
  B8 flash_mode_attention_dense   B2 with a dense [U1, U2] table or none
  B4 mode_softmax_probs_dense     B4 float with a dense table or none
  B9 corr_norm_sums, corr_norm_write   B3 for a row shard of the queries
                            (sequence parallelism): the shard's volume
                            sums, then its rows normed with the sums of
                            every shard

(B6 dense, the inter site's raw volume with a dense table, is in
``corr_vjp.py`` beside B6.)  q and k are [B, M, U, md] with U = H8 * W8
row-major tokens; the sliding bias is the (2R+1)^2 window `biases`, and a
dense table is an fp32 [U1, U2] tensor (q has U1 tokens, k U2) or None
(pos_code_type 'lsinu').  Under sequence parallelism q holds a shard of
whole grid rows, U1 = rows * W8 tokens from grid row `q_row0`, against all
U2 = H8 * W8 keys; B1 takes any U1 and U2, and B2, B4 and B9 take the
shard's `q_row0` so that the window lands on the right diagonals.  The
tensor decides the route: CUDA tensors launch the hand-written kernel
(csrc/*.cu) or raise, CPU tensors take the plain version.  In bf16, B1,
B3, B4 and B9 run tensor-core (wgmma) bodies up to a mode dim of 64 (B3
and B9 at four modes), B2 and B8 at every mode dim up to 256 (their
pipelined body past md 64 and at F 128, flash_pipe_body, with key splits
where the q tiles would leave SMs idle, flash_splits); these take a mode
dim that is a multiple of 16 and 16-byte aligned inputs
(check_mma_tiles); below 16 (8, 4, 2 or 1: 32 to 256 modes at a 256-wide
site) the per-mode kernels B1, B2, B4, B8 and B4 dense take a copy of q
and k zero-padded to 16 columns (pad_mode_dim), the scale staying
1/sqrt(md).  fp32, and bf16 past those (B1 and B4 at md 128 and 256; B3
and B9 at 1, 2 or 8 to 256 modes), run FMA bodies (mma_body,
flash_mma_body, agg_mma_body).  Each kernel's launches are counted in
``<wrapper>.launches`` where the kernel is launched: B1's count includes
the B1 launch that B3 makes as its phase 0.  The clamp value `clip` is a device tensor, so the
predicate never syncs the host.
"""

from __future__ import annotations

import math

import torch

from craft_tpu_torch.ops.kernels.launch import (D as _D, F as _F, I as _I,
                                                L as _L, MAX_MODE_DIM,
                                                MMA_MODE_DIM, P as _P, call,
                                                counted, f32 as _f32,
                                                prep as _prep, ptr as _ptr,
                                                stream as _stream)

_SIGNATURES = {
    "scores_max_launch": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _P],
    "flash_attn_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "corr_norm_launch": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _F, _F, _I, _I, _P],
    "corr_norm_sums_launch": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _I, _P],
    "corr_norm_write_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _D, _F, _I, _I, _P],
    "probs_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _F, _F, _I, _I, _P],
    "flash_attn_dense_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _P],
    "probs_dense_launch": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F,
                           _F, _I, _I, _P],
}
_LIB_OF = {"scores_max_launch": "scores_max",
           "flash_attn_launch": "flash_attn",
           "corr_norm_launch": "corr_norm",
           "corr_norm_sums_launch": "corr_norm",
           "corr_norm_write_launch": "corr_norm",
           "probs_launch": "softmax_probs",
           "flash_attn_dense_launch": "flash_attn",
           "probs_dense_launch": "softmax_probs"}
# The value widths B2 and B8 take (csrc/flash_attn.cu's F): the f2 site's
# feat_dim 256, and the intra aggregator's 128 (the lazy intra path).
FLASH_FEAT = (128, 256)
# Scratch sizes follow the kernels' grids: the fp32 bodies' tiles
# (csrc/common.cuh TILE, csrc/agg_modes.cuh KGROUP) and the bf16 bodies'
# (csrc/scores_max.cu B1_*, csrc/agg_modes.cuh B3_* (B3's and B9's sweeps,
# which B6's forward shares), csrc/softmax_probs.cu B4_*).  The kernels
# refuse a scratch of another size, and tests/test_torch_kernel_grids.py
# holds these constants against the sources.
_TILE, _KGROUP = 64, 8
_B1_ROWS, _B1_KEYS, _B1_KCHUNK = 128, 64, 16
_B3_ROWS, _B3_KEYS, _B3_KGROUP = 128, 64, 8
_B4_ROWS, _B4_KEYS, _B4_KCHUNK = 128, 64, 16
# B2's and B8's pipelined body (csrc/flash_attn.cu PROWS, PMAX_SPLITS,
# pipe_keys): 128-row blocks, at most 4 key splits of a q tile.
_P_ROWS, _P_MAX_SPLITS = 128, 4
assert (MMA_MODE_DIM, MAX_MODE_DIM) == (64, 256)  # common.cuh MAXMD(_FMA)
# The mode counts of the aggregating kernels' FMA bodies (B3, B6, B6 dense,
# B9, B6 backward: csrc/agg_modes.cuh, NM modes with NM * md <= 256: a
# template each up to 16, one instance with a run-time count past it), and
# the count of their wgmma bodies.
AGG_MODES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MMA_MODES = 4
# The k step of the wgmma bodies: a bf16 mode dim below it is zero-padded
# to it (pad_mode_dim).
MMA_K = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mma_body(bf16: int, md: int) -> int:
    """Whether a per-mode kernel (B1, B4, B7, B4 dense) runs its wgmma
    body: bf16 up to md 64; fp32 and bf16 past it take the FMA one, whose
    scratch the grids below count.  csrc/common.cuh mma_body, which every
    launcher takes, is the same test."""
    return int(bool(bf16) and md <= MMA_MODE_DIM)


def flash_mma_body(bf16: int, md: int) -> int:
    """Whether B2 and B8 run a wgmma body: bf16 at every mode dim they take
    (up to 256); fp32 takes the FMA one (csrc/common.cuh flash_mma_body)."""
    return int(bool(bf16) and md <= MAX_MODE_DIM)


def flash_pipe_body(bf16: int, md: int, F: int) -> int:
    """Whether B2 and B8 run their pipelined wgmma body (csrc/flash_attn.cu
    launch_f): at F 128 (up to md 128, check_flash_dims), at F 256 past md
    64 (up to md 64 the F = 256 body, which takes no key split)."""
    return int(flash_mma_body(bf16, md) and (F == 128 or md > MMA_MODE_DIM))


def flash_keys(md: int, F: int) -> int:
    """The pipelined body's keys a tile (pipe_keys): 128 at F 128, 64 at F
    256."""
    return 128 if F == 128 else 64


def flash_splits(BM: int, U1: int, U2: int, md: int, F: int, bf16: int,
                 sms: int) -> int:
    """The key splits of the pipelined body's grid: as many as keep the
    BM x ceil(U1 / 128) q tiles' blocks within one wave of `sms` SMs, at
    most 4 and one key tile a split (1 for the other bodies).  The serving
    shape at one mode (55 q tiles) takes 2, at two modes 1."""
    if not flash_pipe_body(bf16, md, F):
        return 1
    blocks = BM * _cdiv(U1, _P_ROWS)
    return max(1, min(_P_MAX_SPLITS, _cdiv(U2, flash_keys(md, F)),
                      sms // blocks))


def flash_partials(BM: int, U1: int, F: int, nsplit: int) -> int:
    """The fp32 scratch of nsplit key splits (csrc/flash_attn.cu
    pipe_partials): each split's unnormalised o [BM, U1, F] and (max, sum)
    rows [BM, U1, 2]; none for one split."""
    return nsplit * BM * U1 * (F + 2) if nsplit > 1 else 0


def check_flash_dims(what: str, bf16: int, md: int, F: int) -> None:
    """B2's and B8's value width F is 128 or 256 (FLASH_FEAT); in bf16 F
    128 takes a mode dim up to 128, the intra site's width (the pipelined
    body has no wider instance at F 128).  Raises on anything else."""
    if F not in FLASH_FEAT:
        raise ValueError(f"{what}: the kernel takes feature dims "
                         f"{FLASH_FEAT}, got {F}")
    if bf16 and F == 128 and md > 128:
        raise ValueError(f"{what}: bf16 at feature dim 128 takes a mode dim "
                         f"up to 128, got {md}")


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _flash_scratch(BM, U1, U2, md, F, bf16, like):
    """(scratch tensor or None, its floats, splits) of a B2 / B8 launch."""
    nsplit = flash_splits(BM, U1, U2, md, F, bf16, _sm_count(like.device))
    n = flash_partials(BM, U1, F, nsplit)
    part = (torch.empty(n, dtype=torch.float32, device=like.device)
            if n else None)
    return part, n, nsplit


def agg_mma_body(bf16: int, M: int, md: int) -> int:
    """Whether an aggregating kernel (B3, B9, B6, B6 dense, B6 backward)
    runs its wgmma body: bf16 at four modes up to md 64
    (csrc/agg_modes.cuh agg_mma_body)."""
    return int(mma_body(bf16, md) and M == MMA_MODES)


def check_agg_modes(what: str, M: int, md: int) -> None:
    """The aggregating kernels take AGG_MODES modes (1, 2, 4, ..., 256)
    with M * md <= 256 (their FMA bodies' staging); raises on anything
    else."""
    if M not in AGG_MODES or M * md > MAX_MODE_DIM:
        raise ValueError(f"{what}: {M} modes of dim {md}; the kernel takes "
                         f"{AGG_MODES} modes with modes * dim <= "
                         f"{MAX_MODE_DIM}")


def scores_max_partials(BM: int, U1: int, U2: int, bf16: int) -> int:
    """B1's partial maxima: one per block, [BM * ceil(U1/64)] fp32 (FMA
    body) or [BM * ceil(U1/128) * key chunks] (wgmma body: bf16 = 1 here
    names the body, mma_body)."""
    if not bf16:
        return BM * _cdiv(U1, _TILE)
    return (BM * _cdiv(U1, _B1_ROWS)
            * _cdiv(_cdiv(U2, _B1_KEYS), _B1_KCHUNK))


def corr_partials(B: int, U1: int, U2: int, bf16: int) -> int:
    """fp64 scratch of B3's and B9's stats sweep: a (sum, sum of squares)
    pair per block, the blocks of the body that bf16 selects (1: the wgmma
    sweep, agg_mma_body)."""
    if bf16:
        nq, ng = (_cdiv(U1, _B3_ROWS),
                  _cdiv(_cdiv(U2, _B3_KEYS), _B3_KGROUP))
    else:
        nq, ng = _cdiv(U1, _TILE), _cdiv(_cdiv(U2, _TILE), _KGROUP)
    return 2 * B * nq * ng


def probs_partials(BM: int, U1: int, U2: int, bf16: int) -> int:
    """B4's (max, sum) pairs of the wgmma body's stats sweep (bf16 = 1
    names that body, mma_body): one per (b * M, 128-row q tile, chunk of
    16 key tiles, row of the tile); none for the FMA body."""
    if not bf16:
        return 0
    return (BM * _cdiv(U1, _B4_ROWS) * _cdiv(_cdiv(U2, _B4_KEYS), _B4_KCHUNK)
            * _B4_ROWS)


def _probs_scratch(BM: int, U1: int, U2: int, bf16: int, like):
    """A B4 launch's scratch: fp32 [pairs, 2] on like's device, or None
    (the FMA body; bf16 here names the body, mma_body)."""
    n = probs_partials(BM, U1, U2, bf16)
    return (torch.empty(n, 2, dtype=torch.float32, device=like.device)
            if n else None)


def _call(fn_name: str, *args) -> None:
    call(_LIB_OF[fn_name], fn_name, _SIGNATURES[fn_name], *args)


# ---------------------------------------------------------------------------
# Plain PyTorch pieces shared by the plain versions
# ---------------------------------------------------------------------------

def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: fp32, or fp64 for fp64 inputs (the
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def sliding_pos_biases(biases: torch.Tensor, H: int, W: int,
                       q_row0: int = 0, q_rows=None) -> torch.Tensor:
    """Dense table of the (2R+1)^2 window over an H x W token grid, the
    rows of query grid rows q_row0 .. q_row0 + q_rows - 1 (every row by
    default): [q_rows * W, H * W] with pos[(i - q_row0) * W + j, h * W + w]
    = biases[h-i+R, w-j+R] when |h-i| <= R and |w-j| <= R, else 0."""
    R = (biases.shape[0] - 1) // 2
    q_rows = H - q_row0 if q_rows is None else q_rows
    ar_q = torch.arange(q_row0, q_row0 + q_rows, device=biases.device)
    ar_h = torch.arange(H, device=biases.device)
    ar_w = torch.arange(W, device=biases.device)
    dh = ar_h[None, :] - ar_q[:, None]
    dw = ar_w[None, :] - ar_w[:, None]
    ih = (dh + R).clamp(0, 2 * R)
    iw = (dw + R).clamp(0, 2 * R)
    table = biases[ih][:, :, iw]  # [i, h, j, w]
    mask = (dh.abs() <= R)[:, :, None, None] & (dw.abs() <= R)[None, None]
    return (table * mask).permute(0, 2, 1, 3).reshape(q_rows * W, H * W)


def query_rows(q, k, grid_hw, q_row0: int = 0) -> int:
    """The grid rows that q holds: q's U1 tokens are whole rows of the
    H8 x W8 grid from row q_row0, k holds all U2 = H8 * W8.  Raises on
    anything else."""
    H8, W8 = grid_hw
    U1, U2 = q.shape[-2], k.shape[-2]
    rows = U1 // W8
    if U2 != H8 * W8 or U1 != rows * W8 or not (
            rows > 0 and 0 <= q_row0 and q_row0 + rows <= H8):
        raise ValueError(f"q rows {U1} from grid row {q_row0}, k {U2} keys: "
                         f"not whole rows of the {H8}x{W8} grid")
    return rows


def window_rows(biases, grid_hw, q, k, q_row0: int = 0) -> torch.Tensor:
    """The dense window table of q's query rows against every key,
    [U1, U2] in acc_dtype(q)."""
    return sliding_pos_biases(biases.to(acc_dtype(q)), *grid_hw, q_row0,
                              query_rows(q, k, grid_hw, q_row0))


def scores(q, k, scale):
    """scale * q k^T, [B, M, U1, U2] in acc_dtype(q)."""
    dt = acc_dtype(q)
    return torch.einsum("bmid,bmjd->bmij", q.to(dt), k.to(dt)) * scale


def clamped_scores(q, k, clip):
    """(c, clamp(c, +-clip)) with c = scale * q k^T, both [B, M, U1, U2] in
    acc_dtype(q)."""
    c = scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    clip = torch.as_tensor(clip, dtype=c.dtype, device=c.device)
    return c, torch.minimum(torch.maximum(c, -clip), clip)


def biased_scores(q, k, biases, grid_hw, clip, pos_w, q_row0: int = 0):
    """(c, clamp(c, +-clip) + pos_w * bias) with c = scale * q k^T, both
    [B, M, U1, U2] in acc_dtype(q); q holds the grid rows from q_row0."""
    c, s = clamped_scores(q, k, clip)
    return c, s + pos_w * window_rows(biases, grid_hw, q, k, q_row0)


def table_scores(q, k, table, clip, pos_w):
    """clamp(scale * q k^T, +-clip) + pos_w * table, [B, M, U1, U2] in
    acc_dtype(q); no bias when table is None."""
    _, s = clamped_scores(q, k, clip)
    return s if table is None else s + pos_w * table.to(s.dtype)


def check_table(table, q, k) -> None:
    """A dense table must be None or an fp32 [U1, U2] tensor on q's
    device."""
    if table is None:
        return
    want = (q.shape[-2], k.shape[-2])
    if (tuple(table.shape) != want or table.dtype != torch.float32
            or table.device != q.device):
        raise ValueError(f"dense bias table: want fp32 {want} on {q.device}, "
                         f"got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")


def check_mma_tiles(what: str, bf16: int, md: int, names: str,
                    *tensors) -> None:
    """bf16 inputs (the tensor-core bodies of B1-B4, B6-B9, and the FMA
    bodies that take bf16 past them) take a mode dim that is a multiple of
    16, or below 16 (the per-mode kernels take it padded, pad_mode_dim; the
    aggregating kernels' FMA bodies past 16 modes as it is), and 16-byte
    aligned tensors (`names`); raises on anything else.  fp32 takes any md
    <= 256."""
    if not bf16:
        return
    if md % MMA_K and md > MMA_K:
        raise ValueError(f"{what}: bf16 needs a mode dim that is a multiple "
                         f"of 16 or below 16, got {md}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: bf16 needs {names} 16-byte aligned")


def pad_mode_dim(bf16: int, *tensors):
    """The per-mode kernels' q and k (B1, B2, B4, B7, B8, B4 dense): bf16
    at a mode dim below 16 as contiguous copies zero-padded to 16 columns,
    the wgmma bodies' k step (zeros add nothing to q.k^T; the caller keeps
    the scale at 1/sqrt(md)); anything else as it is.  Returns (tensors,
    the mode dim the kernel is given)."""
    md = tensors[0].shape[-1]
    if not bf16 or md >= MMA_K:
        return list(tensors), md
    return [torch.nn.functional.pad(t, (0, MMA_K - md)) for t in tensors], \
        MMA_K


def table_ptr(table) -> _P:
    """The kernels' table (or scratch) argument: a pointer to a contiguous
    tensor (the caller keeps it alive), or null for None."""
    return _P(None) if table is None else _ptr(table)


# ---------------------------------------------------------------------------
# B1: global max of the scores
# ---------------------------------------------------------------------------

def _launch_scores_max(q, k, scale) -> torch.Tensor:
    (q, k), bf16 = _prep(q, k)
    B, M, U1, md = q.shape
    U2 = k.shape[2]
    if k.shape[:2] != (B, M) or k.shape[3] != md:
        raise ValueError(f"scores_global_max: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    (q, k), mdk = pad_mode_dim(bf16, q, k)
    check_mma_tiles("scores_global_max", bf16, mdk, "q and k", q, k)
    n_partial = scores_max_partials(B * M, U1, U2, mma_body(bf16, mdk))
    partial = torch.empty(n_partial, dtype=torch.float32, device=q.device)
    out = torch.empty(1, dtype=torch.float32, device=q.device)
    _call("scores_max_launch", _ptr(q), _ptr(k), _ptr(partial), n_partial,
          _ptr(out), B * M, U1, U2, mdk, scale, bf16, _stream(q))
    scores_global_max.launches += 1
    scores_global_max.flops += 2.0 * B * M * U1 * U2 * md
    return out


def scores_global_max_plain(q, k, scale: float) -> torch.Tensor:
    return scores(q, k, scale).amax()


@counted
def scores_global_max(q: torch.Tensor, k: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Max of scale * q_m k_m^T over batch, modes and tokens, as a 0-d fp32
    tensor on q's device.  q: [B, M, U1, md], k: [B, M, U2, md] (U1 < U2
    for a row shard of the queries)."""
    if not q.is_cuda:
        return scores_global_max_plain(q, k, scale)
    return _launch_scores_max(q, k, scale)[0]


# ---------------------------------------------------------------------------
# B2: flash multi-mode attention with the sliding bias
# ---------------------------------------------------------------------------

def flash_mode_attention_plain(q, k, v, biases, grid_hw, clip, pos_w,
                               q_row0: int = 0):
    p = torch.softmax(biased_scores(q, k, biases, grid_hw, clip, pos_w,
                                    q_row0)[1], -1)
    return (p @ v.float()).to(v.dtype)


@counted
def flash_mode_attention(q, k, v, biases, grid_hw, clip, pos_w: float,
                         q_row0: int = 0):
    """out[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * bias) @ v.

    q: [B, M, U1, md], the grid rows from q_row0 (all of them by default);
    k: [B, M, U2, md] and v: [B, M, U2, F], every token of the H8 x W8
    grid, F in FLASH_FEAT (the f2 site's 256, the lazy intra aggregator's
    128); biases: [2R+1, 2R+1]; clip: 0-d tensor.  Returns [B, M, U1, F]
    in v's dtype.  Launches are also counted by F in `launches_by`."""
    query_rows(q, k, grid_hw, q_row0)
    if not q.is_cuda:
        return flash_mode_attention_plain(q, k, v, biases, grid_hw, clip,
                                          pos_w, q_row0)
    (q, k, v), bf16 = _prep(q, k, v)
    B, M, U1, md = q.shape
    U2, F = k.shape[2], v.shape[-1]
    if k.shape[:2] != (B, M) or v.shape[:3] != (B, M, U2):
        raise ValueError(f"flash_mode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    check_flash_dims("flash_mode_attention", bf16, md, F)
    R = (biases.shape[0] - 1) // 2
    W8 = grid_hw[1]
    out = torch.empty(B, M, U1, F, dtype=v.dtype, device=v.device)
    (q, k), mdk = pad_mode_dim(bf16, q, k)
    check_mma_tiles("flash_mode_attention", bf16, mdk, "q, k, v and out",
                    q, k, v, out)
    win, clip_t = _f32(biases, q), _f32(clip, q)
    part, n_part, nsplit = _flash_scratch(B * M, U1, U2, mdk, F, bf16, q)
    _call("flash_attn_launch", _ptr(q), _ptr(k), _ptr(v), _ptr(out),
          _ptr(win), _ptr(clip_t), table_ptr(part), n_part, nsplit, B * M,
          U1, U2, q_row0 * W8, mdk, F, W8, R, 1.0 / math.sqrt(md), pos_w,
          bf16, _stream(q))
    flash_mode_attention.launches += 1
    flash_mode_attention.launches_by[F] = \
        flash_mode_attention.launches_by.get(F, 0) + 1
    flash_mode_attention.flops += 2.0 * B * M * U1 * U2 * (md + F)
    return out


# ---------------------------------------------------------------------------
# B8: flash multi-mode attention with a dense table
# ---------------------------------------------------------------------------

def flash_mode_attention_dense_plain(q, k, v, table, clip, pos_w):
    p = torch.softmax(table_scores(q, k, table, clip, pos_w), -1)
    return (p @ v.to(p.dtype)).to(v.dtype)


@counted
def flash_mode_attention_dense(q, k, v, table, clip, pos_w: float):
    """out[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * table) @ v,
    the counterpart of ``craft_tpu.ops.pallas.mode_attention.
    flash_mode_attention`` (B8).

    q: [B, M, U1, md]; k: [B, M, U2, md]; v: [B, M, U2, F]; table: fp32
    [U1, U2] or None (no bias); clip: 0-d tensor or float.  Returns
    [B, M, U1, F] in v's dtype."""
    check_table(table, q, k)
    if not q.is_cuda:
        return flash_mode_attention_dense_plain(q, k, v, table, clip, pos_w)
    (q, k, v), bf16 = _prep(q, k, v)
    B, M, U1, md = q.shape
    U2, F = k.shape[2], v.shape[-1]
    if k.shape[:2] != (B, M) or v.shape[:3] != (B, M, U2):
        raise ValueError(f"flash_mode_attention_dense: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    check_flash_dims("flash_mode_attention_dense", bf16, md, F)
    out = torch.empty(B, M, U1, F, dtype=v.dtype, device=v.device)
    (q, k), mdk = pad_mode_dim(bf16, q, k)
    check_mma_tiles("flash_mode_attention_dense", bf16, mdk,
                    "q, k, v and out", q, k, v, out)
    table = None if table is None else table.contiguous()
    clip_t = _f32(clip, q)
    part, n_part, nsplit = _flash_scratch(B * M, U1, U2, mdk, F, bf16, q)
    _call("flash_attn_dense_launch", _ptr(q), _ptr(k), _ptr(v), _ptr(out),
          table_ptr(table), _ptr(clip_t), table_ptr(part), n_part, nsplit,
          B * M, U1, U2, mdk, F, 1.0 / math.sqrt(md), pos_w, bf16,
          _stream(q))
    flash_mode_attention_dense.launches += 1
    flash_mode_attention_dense.flops += 2.0 * B * M * U1 * U2 * (md + F)
    return out


# ---------------------------------------------------------------------------
# B3: fused clamp + mode aggregation + global layer norm
# ---------------------------------------------------------------------------

def agg_volume(c, biases, grid_hw, gmax, attn_clip, pos_w, agg_w, agg_b,
               q_row0: int = 0):
    """The clamped, mode-aggregated volume [B, U1, U2] in c's dtype from the
    raw scores c = scale * q k^T [B, M, U1, U2] of the grid rows from
    q_row0: s_m = clamp(c_m, +-clip) + pos_w * bias with clip = attn_clip
    if gmax > attn_clip (else 1e30), vol = sum_m softmax_m(agg_w s_m +
    agg_b) s_m."""
    H8, W8 = grid_hw
    clip = torch.where(gmax > attn_clip, attn_clip, 1e30)
    s = torch.minimum(torch.maximum(c, -clip), clip) + pos_w * \
        sliding_pos_biases(biases.to(c.dtype), H8, W8, q_row0,
                           c.shape[2] // W8)
    lg = agg_w * s + agg_b
    e = torch.exp(lg - lg.amax(dim=1, keepdim=True))
    del lg
    return (e * s).sum(dim=1) / e.sum(dim=1)


def _normed(vol, sums, n_elems: float, eps: float):
    """(vol - mean) * rsqrt(var + eps) per sample, from fp64 sums [B, 2] =
    (sum, sum of squares) over n_elems elements; (out, mean, E[x^2])."""
    B = vol.shape[0]
    mean, ex2 = sums[:, 0] / n_elems, sums[:, 1] / n_elems
    rstd = torch.rsqrt((ex2 - mean * mean).clamp(min=0.0) + eps)
    out = (vol - mean.float().view(B, 1, 1)) * rstd.float().view(B, 1, 1)
    return out, mean, ex2


def _volume_sums(vol):
    """fp64 [B, 2]: per sample (sum, sum of squares) of vol."""
    v = vol.double()
    return torch.stack([v.sum(dim=(1, 2)), v.square().sum(dim=(1, 2))], -1)


def fused_agg_corr_norm_plain(q, k, biases, grid_hw, attn_clip, pos_w,
                              agg_w, agg_b, out_dtype=torch.bfloat16,
                              eps: float = 1e-12):
    B, M, U, md = q.shape
    c = scores(q, k, 1.0 / math.sqrt(md))
    gmax = c.amax()
    vol = agg_volume(c, biases, grid_hw, gmax, attn_clip, pos_w, agg_w,
                     agg_b)
    del c
    out, mean, ex2 = _normed(vol, _volume_sums(vol), float(U) * float(U),
                             eps)
    stats = torch.stack([gmax.expand(B), mean.float(), ex2.float(),
                         torch.zeros_like(gmax).expand(B)], dim=-1)
    return out.to(out_dtype), stats.view(B, 1, 4)


@counted
def fused_agg_corr_norm(q, k, biases, grid_hw, attn_clip: float,
                        pos_w: float, agg_w, agg_b,
                        out_dtype=torch.bfloat16, eps: float = 1e-12):
    """The inter-frame volume in one call.

    s_m = clamp(scale q_m k_m^T, +-clip) + pos_w * bias with clip =
    attn_clip if the batch-global raw max exceeds attn_clip (else 1e30);
    vol = sum_m softmax_m(agg_w s_m + agg_b) s_m; returns
    ((vol - mean) * rsqrt(var + eps) as [B, U, U] out_dtype,
     stats [B, 1, 4] fp32 = (raw max, mean, E[x^2], 0)), with per-sample
    moments over the whole volume.  q, k: [B, M, U, md], M in AGG_MODES
    with M * md <= 256 (M = 1: vol = s, the softmax over one mode being
    1).  Its phase 0 (B1) takes q and k padded where md < 16."""
    if not q.is_cuda:
        return fused_agg_corr_norm_plain(q, k, biases, grid_hw, attn_clip,
                                         pos_w, agg_w, agg_b, out_dtype, eps)
    B, M, U, md = q.shape
    scale = 1.0 / math.sqrt(md)
    check_agg_modes("fused_agg_corr_norm", M, md)
    (q, k), bf16 = _prep(q, k)
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            out_dtype == torch.bfloat16 and not bf16):
        raise ValueError(f"fused_agg_corr_norm: {q.dtype} -> {out_dtype}; "
                         "the kernel takes bf16 -> bf16, bf16 -> fp32 and "
                         "fp32 -> fp32")
    check_mma_tiles("fused_agg_corr_norm", bf16, md, "q and k", q, k)
    gmax = _launch_scores_max(q, k, scale)  # phase 0: the raw max (B1)
    R = (biases.shape[0] - 1) // 2
    dev = q.device
    n_partial = corr_partials(B, U, U, agg_mma_body(bf16, M, md))
    partial = torch.empty(n_partial, dtype=torch.float64, device=dev)
    stats = torch.empty(B, 1, 4, dtype=torch.float32, device=dev)
    norm = torch.empty(B, 2, dtype=torch.float32, device=dev)
    out = torch.empty(B, U, U, dtype=out_dtype, device=dev)
    win = _f32(biases, q)
    scal = torch.cat([_f32(attn_clip, q), _f32(pos_w, q), _f32(agg_w, q),
                      _f32(agg_b, q)])
    _call("corr_norm_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(scal),
          _ptr(gmax), _ptr(partial), n_partial, _ptr(stats), _ptr(norm),
          _ptr(out), B, M, U, md, grid_hw[1], R, scale, eps, bf16,
          int(out_dtype == torch.bfloat16), _stream(q))
    fused_agg_corr_norm.launches += 1
    fused_agg_corr_norm.flops += 2.0 * B * M * U * U * md
    return out, stats


# ---------------------------------------------------------------------------
# B9: B3 for a row shard of the queries (sequence parallelism)
# ---------------------------------------------------------------------------

def corr_norm_sums_plain(q, k, biases, grid_hw, gmax, attn_clip, pos_w,
                         agg_w, agg_b, q_row0: int = 0):
    c = scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    return _volume_sums(agg_volume(c, biases, grid_hw, gmax, attn_clip,
                                   pos_w, agg_w, agg_b, q_row0))


def corr_norm_write_plain(q, k, biases, grid_hw, gmax, sums, n_elems: float,
                          attn_clip, pos_w, agg_w, agg_b, q_row0: int = 0,
                          out_dtype=torch.bfloat16, eps: float = 1e-12):
    c = scores(q, k, 1.0 / math.sqrt(q.shape[-1]))
    vol = agg_volume(c, biases, grid_hw, gmax, attn_clip, pos_w, agg_w,
                     agg_b, q_row0)
    del c
    return _normed(vol, sums, n_elems, eps)[0].to(out_dtype)


def _shard_prep(q, k, grid_hw, q_row0, what):
    """Checks shared by the two B9 halves: (contiguous q, k, bf16 flag)."""
    query_rows(q, k, grid_hw, q_row0)
    B, M, U1, md = q.shape
    if k.shape[:2] != (B, M):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    check_agg_modes(what, M, md)
    (q, k), bf16 = _prep(q, k)
    check_mma_tiles(what, bf16, md, "q and k", q, k)
    return q, k, bf16


def _corr_scalars(attn_clip, pos_w, agg_w, agg_b, q):
    return torch.cat([_f32(attn_clip, q), _f32(pos_w, q), _f32(agg_w, q),
                      _f32(agg_b, q)])


@counted
def corr_norm_sums(q, k, biases, grid_hw, gmax, attn_clip: float,
                   pos_w: float, agg_w, agg_b, q_row0: int = 0):
    """The stats half of B3 for a row shard (counterpart of
    ``craft_tpu.ops.pallas.mode_attention.corr_norm_sums_mt``): per sample
    fp64 (sum, sum of squares) [B, 2] of this shard's rows of the clamped,
    aggregated volume, the clamp decided by `gmax`, the raw max over every
    shard.  q: [B, M, U1, md], the grid rows from q_row0; k: [B, M, U2, md],
    every token (M and md as B3).  Summed over the shards, they give B3's
    moments."""
    if not q.is_cuda:
        query_rows(q, k, grid_hw, q_row0)
        return corr_norm_sums_plain(q, k, biases, grid_hw, gmax, attn_clip,
                                    pos_w, agg_w, agg_b, q_row0)
    q, k, bf16 = _shard_prep(q, k, grid_hw, q_row0, "corr_norm_sums")
    B, M, U1, md = q.shape
    W8 = grid_hw[1]
    n_partial = corr_partials(B, U1, k.shape[2], agg_mma_body(bf16, M, md))
    partial = torch.empty(n_partial, dtype=torch.float64, device=q.device)
    sums = torch.empty(B, 2, dtype=torch.float64, device=q.device)
    # The kernel's inputs are held here until the launch.
    win, gmax = _f32(biases, q), _f32(gmax, q)
    scal = _corr_scalars(attn_clip, pos_w, agg_w, agg_b, q)
    _call("corr_norm_sums_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(scal),
          _ptr(gmax), _ptr(partial), n_partial, _ptr(sums), B, M, U1,
          k.shape[2], q_row0 * W8, md, W8, (biases.shape[0] - 1) // 2,
          1.0 / math.sqrt(md), bf16, _stream(q))
    corr_norm_sums.launches += 1
    corr_norm_sums.flops += 2.0 * B * q.shape[1] * U1 * k.shape[2] * md
    return sums


@counted
def corr_norm_write(q, k, biases, grid_hw, gmax, sums, attn_clip: float,
                    pos_w: float, agg_w, agg_b, q_row0: int = 0,
                    out_dtype=torch.bfloat16, eps: float = 1e-12):
    """The write half of B3 for a row shard (counterpart of
    ``craft_tpu.ops.pallas.mode_attention.corr_norm_write_mt``): this
    shard's rows of the volume, (vol - mean) * rsqrt(var + eps) as
    [B, U1, U2] out_dtype, the moments from `sums` (fp64 [B, 2], the
    shards' corr_norm_sums summed) over the global element count U2 * U2.
    Arguments otherwise as corr_norm_sums; the (in, out) types as B3."""
    n_elems = float(k.shape[2]) * float(k.shape[2])
    if not q.is_cuda:
        query_rows(q, k, grid_hw, q_row0)
        return corr_norm_write_plain(q, k, biases, grid_hw, gmax, sums,
                                     n_elems, attn_clip, pos_w, agg_w, agg_b,
                                     q_row0, out_dtype, eps)
    q, k, bf16 = _shard_prep(q, k, grid_hw, q_row0, "corr_norm_write")
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            out_dtype == torch.bfloat16 and not bf16):
        raise ValueError(f"corr_norm_write: {q.dtype} -> {out_dtype}; the "
                         "kernel takes bf16 -> bf16, bf16 -> fp32 and fp32 -> "
                         "fp32")
    B, M, U1, md = q.shape
    U2, W8 = k.shape[2], grid_hw[1]
    if sums.shape != (B, 2) or sums.dtype != torch.float64 or \
            sums.device != q.device:
        raise ValueError(f"corr_norm_write: sums must be fp64 [{B}, 2] on "
                         f"{q.device}")
    norm = torch.empty(B, 2, dtype=torch.float32, device=q.device)
    out = torch.empty(B, U1, U2, dtype=out_dtype, device=q.device)
    win, gmax, sums = _f32(biases, q), _f32(gmax, q), sums.contiguous()
    scal = _corr_scalars(attn_clip, pos_w, agg_w, agg_b, q)
    _call("corr_norm_write_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(scal),
          _ptr(gmax), _ptr(sums), _ptr(norm), _ptr(out), B, M, U1, U2,
          q_row0 * W8, md, W8,
          (biases.shape[0] - 1) // 2, 1.0 / math.sqrt(md), n_elems, eps,
          bf16, int(out_dtype == torch.bfloat16), _stream(q))
    corr_norm_write.launches += 1
    corr_norm_write.flops += 2.0 * B * q.shape[1] * U1 * U2 * md
    return out


# ---------------------------------------------------------------------------
# B4: blockwise softmax probabilities
# ---------------------------------------------------------------------------

def mode_softmax_probs_plain(q, k, biases, grid_hw, clip, pos_w,
                             out_dtype=torch.bfloat16, quantized=False,
                             q_row0: int = 0):
    _, s = biased_scores(q, k, biases, grid_hw, clip, pos_w, q_row0)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    l = e.sum(dim=-1, keepdim=True)
    if quantized:
        return torch.round(e * 127.0).to(torch.int8), 1.0 / (127.0 * l)
    return (e / l).to(out_dtype)


@counted
def mode_softmax_probs(q, k, biases, grid_hw, clip, pos_w: float,
                       out_dtype=torch.bfloat16, quantized: bool = False,
                       q_row0: int = 0):
    """probs[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * bias).

    q: [B, M, U1, md], the grid rows from q_row0 (all of them by default);
    k: [B, M, U2, md], every token.  Returns [B, M, U1, U2] out_dtype, or
    with quantized=True the int8 numerators round(exp(s - rowmax) * 127)
    [B, M, U1, U2] and fp32 row scales 1 / (127 * l) [B, M, U1, 1] (probs =
    num * scale)."""
    query_rows(q, k, grid_hw, q_row0)
    if not q.is_cuda:
        return mode_softmax_probs_plain(q, k, biases, grid_hw, clip, pos_w,
                                        out_dtype, quantized, q_row0)
    (q, k), bf16 = _prep(q, k)
    if not bf16 and (quantized or out_dtype != torch.float32):
        raise ValueError("mode_softmax_probs: fp32 inputs take fp32 output "
                         "only")
    B, M, U1, md = q.shape
    U2, W8 = k.shape[2], grid_hw[1]
    if k.shape[:2] != (B, M):
        raise ValueError(f"mode_softmax_probs: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    R = (biases.shape[0] - 1) // 2
    dev = q.device
    if quantized:
        out = torch.empty(B, M, U1, U2, dtype=torch.int8, device=dev)
        row_scale = torch.empty(B, M, U1, 1, dtype=torch.float32, device=dev)
        kind = 2
    else:
        kind = {torch.float32: 0, torch.bfloat16: 1}[out_dtype]
        out = torch.empty(B, M, U1, U2, dtype=out_dtype, device=dev)
        row_scale = out  # not written
    (q, k), mdk = pad_mode_dim(bf16, q, k)
    check_mma_tiles("mode_softmax_probs", bf16, mdk, "q, k and out", q, k,
                    out)
    win, clip_t = _f32(biases, q), _f32(clip, q)
    mma = mma_body(bf16, mdk)
    scratch = _probs_scratch(B * M, U1, U2, mma, q)
    _call("probs_launch", _ptr(q), _ptr(k), _ptr(win), _ptr(clip_t),
          table_ptr(scratch), probs_partials(B * M, U1, U2, mma), _ptr(out),
          _ptr(row_scale), B * M, U1, U2, q_row0 * W8, mdk, W8, R,
          1.0 / math.sqrt(md), pos_w, bf16, kind, _stream(q))
    mode_softmax_probs.launches += 1
    mode_softmax_probs.flops += 2.0 * B * M * U1 * U2 * md
    return (out, row_scale) if quantized else out


# ---------------------------------------------------------------------------
# B4 dense: softmax probabilities with a dense table
# ---------------------------------------------------------------------------

def mode_softmax_probs_dense_plain(q, k, table, clip, pos_w,
                                   out_dtype=torch.bfloat16):
    s = table_scores(q, k, table, clip, pos_w)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    return (e / e.sum(dim=-1, keepdim=True)).to(out_dtype)


@counted
def mode_softmax_probs_dense(q, k, table, clip, pos_w: float,
                             out_dtype=torch.bfloat16):
    """probs[b, m] = softmax(clamp(scale q k^T, +-clip) + pos_w * table),
    the counterpart of ``craft_tpu.ops.pallas.mode_attention.
    mode_softmax_probs`` (B4 dense).

    q: [B, M, U1, md]; k: [B, M, U2, md]; table: fp32 [U1, U2] or None (no
    bias); clip: 0-d tensor or float.  Returns float probs [B, M, U1, U2] in
    out_dtype (bf16 or fp32; fp32 inputs take fp32 only)."""
    check_table(table, q, k)
    if not q.is_cuda:
        return mode_softmax_probs_dense_plain(q, k, table, clip, pos_w,
                                              out_dtype)
    (q, k), bf16 = _prep(q, k)
    kinds = {torch.float32: 0, torch.bfloat16: 1}
    if out_dtype not in kinds or (not bf16 and out_dtype != torch.float32):
        raise ValueError(f"mode_softmax_probs_dense: {q.dtype} -> {out_dtype};"
                         " the kernel takes bf16 -> bf16 or fp32 and fp32 -> "
                         "fp32")
    B, M, U1, md = q.shape
    U2 = k.shape[2]
    if k.shape[:2] != (B, M):
        raise ValueError(f"mode_softmax_probs_dense: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    out = torch.empty(B, M, U1, U2, dtype=out_dtype, device=q.device)
    (q, k), mdk = pad_mode_dim(bf16, q, k)
    check_mma_tiles("mode_softmax_probs_dense", bf16, mdk, "q, k and out", q,
                    k, out)
    table = None if table is None else table.contiguous()
    clip_t = _f32(clip, q)
    mma = mma_body(bf16, mdk)
    scratch = _probs_scratch(B * M, U1, U2, mma, q)
    _call("probs_dense_launch", _ptr(q), _ptr(k), table_ptr(table),
          _ptr(clip_t), table_ptr(scratch),
          probs_partials(B * M, U1, U2, mma), _ptr(out), B * M, U1, U2, mdk,
          1.0 / math.sqrt(md), pos_w, bf16, kinds[out_dtype], _stream(q))
    mode_softmax_probs_dense.launches += 1
    mode_softmax_probs_dense.flops += 2.0 * B * M * U1 * U2 * md
    return out


KERNELS = (scores_global_max, flash_mode_attention, fused_agg_corr_norm,
           mode_softmax_probs)
