"""B10: one directional SepConvGRU pass, forward and backward, each beside
its plain PyTorch version, joined into the differentiable ``GruPass``
(counterparts of ``craft_tpu/ops/pallas/sep_conv_gru.py``: ``gru_pass``,
its forward ``_gru_fwd`` and its VJP ``_gru_bwd_vjp``).

A pass runs over rows: h [B, HW, Ch], x [B, HW, Cx], the taps of each gate
split at Ch as w*h [5, Ch, Ch] and w*x [5, Cx, Ch], biases b* [Ch]:

    z = sigmoid(sum_t h[p + o_t] Wzh_t + x[p + o_t] Wzx_t + bz), r alike,
    q = tanh(sum_t (r h)[p + o_t] Wqh_t + x[p + o_t] Wqx_t + bq),
    h' = (1 - z) h + z q,

with o_t = (t - 2) * stride.  stride 1 is the horizontal (1x5) pass over
image rows of `width`: a tap that leaves p's image row reads zero.  stride
W is the vertical (5x1) pass over the same row-major rows: a tap above or
below the image reads zero (the JAX module runs its vertical pass with
stride 1 on the transposed image; both give the same numbers).

The casts are the JAX kernel's: the io type is h's (bf16 or fp32); x and the
weights are cast to it, the bias stays fp32, every product sums in fp32;
r h is rounded to io from the fp32 r in the forward and from the saved,
rounded r in the backward; z, r, q are saved in io; dqh, dzh and drhat are
rounded to io before every product and bias sum that reads them; the
weight gradients are summed in fp32 and cast to the weights' dtype, the
bias gradients stay fp32, dh is in h's dtype and dx in x's.

CUDA tensors launch the hand-written kernels (csrc/sep_conv_gru.cu) or
raise; CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch

from craft_tpu_torch.ops.kernels.launch import (I, L, P, call, check_cuda,
                                                counted, ptr, stream)

TAPS, RAD = 5, 2
# The weight gradients' row splits (csrc/sep_conv_gru.cu wgrad_splits): up
# to FW_SPLITS of at least FW_SPLIT_ROWS rows for the fp32 body, up to
# GW_SPLITS of at least GW_SPLIT_ROWS for the bf16 (wgmma) body.
FW_SPLITS, FW_SPLIT_ROWS = 16, 1024
GW_SPLITS, GW_SPLIT_ROWS = 4, 2048
# Scratch buffers are carved into pieces that each start on a SCRATCH_ALIGN
# byte boundary (csrc/sep_conv_gru.cu).
SCRATCH_ALIGN = 256
GF_TILE = 16384  # bytes of one gate's weights in a bf16 forward stage
_FWD_SIG = [P] * 16 + [L] + [I] * 7 + [P]
_BWD_SIG = [P] * 14 + [I, P, L, I, P] + [I] * 7 + [P]


def fused_gru_vmem_ok(HW: int, Ch: int, Cx: int, stride: int = 1,
                      itemsize: int = 2) -> bool:
    """The JAX package's gate for its fused pass (the weights' budget in a
    TPU core's VMEM, and Ch % 8 == 0), kept as it is so that one
    configuration takes the same path in both packages.  The CUDA kernels'
    own limits are ``_check``'s."""
    del HW, stride
    weights = TAPS * 3 * (Ch * Ch + Cx * Ch) * itemsize
    return weights < 4 * 2 ** 20 and Ch % 8 == 0


def wgrad_splits(rows: int, io_bf16: bool) -> int:
    """The row splits of the backward's weight gradients, as the kernel
    counts them (it refuses a partial buffer of another count)."""
    most, least = (GW_SPLITS, GW_SPLIT_ROWS) if io_bf16 else \
        (FW_SPLITS, FW_SPLIT_ROWS)
    return max(1, min(most, rows // least))


def _align(n: int) -> int:
    return -(-n // SCRATCH_ALIGN) * SCRATCH_ALIGN


def fwd_scratch_bytes(rows: int, Ch: int, Cx: int, io_bf16: bool) -> int:
    """The forward's scratch, as the kernel carves it (it refuses another
    size): zf (fp32), then r h (io), each [rows, Ch], then for bf16 the
    weights laid out as the images of the kernel's stages (GF_TILE bytes
    for each gate, tap, 64-channel chunk of Ch and of Cx, and 128-column
    tile of Ch)."""
    n = rows * Ch
    images = 3 * TAPS * (-(-Ch // 64) + -(-Cx // 64)) * -(-Ch // 128) * \
        GF_TILE if io_bf16 else 0
    return _align(4 * n) + _align((2 if io_bf16 else 4) * n) + images


def bwd_scratch_bytes(rows: int, Ch: int, Cx: int, io_bf16: bool) -> int:
    """The backward's scratch, as the kernel carves it (it refuses another
    size): dqh, dzh, r h, drhat (io) and dhp (fp32), each [rows, Ch], then
    the weight gradients' partials, wgrad_splits(rows) x (15 (Ch + Cx) Ch
    + 3 Ch) fp32."""
    n = rows * Ch
    per_split = 15 * (Ch + Cx) * Ch + 3 * Ch
    return 4 * _align((2 if io_bf16 else 4) * n) + _align(4 * n) + \
        _align(4 * wgrad_splits(rows, io_bf16) * per_split)


def acc_type(io: torch.dtype) -> torch.dtype:
    """The type of the sums: fp32, or fp64 for fp64 tensors on the CPU."""
    return torch.promote_types(io, torch.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def tap_valid(HW: int, d: int, stride: int, width: int,
              device) -> torch.Tensor:
    """[HW] bool: row p's tap at offset d (in units of stride) lies in the
    image, and for stride 1 in p's image row of `width`."""
    p = torch.arange(HW, device=device)
    nb = p + d * stride
    ok = (nb >= 0) & (nb < HW)
    if stride == 1:
        w = p % width + d
        ok &= (w >= 0) & (w < width)
    return ok


def shift_rows(a: torch.Tensor, d: int, stride: int,
               width: int) -> torch.Tensor:
    """a [B, HW, C] -> the rows p + d * stride, zero where the tap leaves
    the image (tap_valid)."""
    HW = a.shape[1]
    o = d * stride
    pad = min(abs(o), HW)
    ap = torch.nn.functional.pad(a, (0, 0, pad, pad))
    out = ap[:, pad + o:pad + o + HW] if abs(o) < HW else torch.zeros_like(a)
    keep = tap_valid(HW, d, stride, width, a.device)[None, :, None]
    return torch.where(keep, out, torch.zeros((), dtype=a.dtype,
                                              device=a.device))


def conv_rows(a, w, stride, width, acc):
    """sum_t a[p + o_t] . w[t] in `acc`: a [B, HW, Cin], w [5, Cin, Cout]."""
    return sum(shift_rows(a, t - RAD, stride, width).to(acc) @ w[t].to(acc)
               for t in range(TAPS))


def conv_rows_t(d, w, stride, width, acc):
    """The transpose of conv_rows for w: sum_t d[p - o_t] . w[t]^T, d [B,
    HW, Cout] -> [B, HW, Cin], each tap masked as the forward masks it."""
    return sum(shift_rows(d, RAD - t, stride, width).to(acc)
               @ w[t].to(acc).T for t in range(TAPS))


def wgrad_rows(a, d, stride, width, acc):
    """[5, Cin, Cout]: sum over every row p of a[p + o_t]^T d[p]."""
    dd = d.to(acc).flatten(0, 1)
    return torch.stack([shift_rows(a, t - RAD, stride, width).to(acc)
                        .flatten(0, 1).T @ dd for t in range(TAPS)])


def gru_pass_fwd_plain(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq,
                       stride: int, width: int):
    """(h', z, r, q), each [B, HW, Ch] in h's dtype."""
    io = h.dtype
    acc = acc_type(io)
    x = x.to(io)
    wzh, wzx, wrh, wrx, wqh, wqx = (w.to(io) for w in
                                    (wzh, wzx, wrh, wrx, wqh, wqx))
    geo = (stride, width, acc)
    z = torch.sigmoid(conv_rows(h, wzh, *geo) + conv_rows(x, wzx, *geo)
                      + bz.to(acc))
    r = torch.sigmoid(conv_rows(h, wrh, *geo) + conv_rows(x, wrx, *geo)
                      + br.to(acc))
    hf = h.to(acc)
    rh = (r * hf).to(io)
    q = torch.tanh(conv_rows(rh, wqh, *geo) + conv_rows(x, wqx, *geo)
                   + bq.to(acc))
    hout = (1.0 - z) * hf + z * q
    return hout.to(io), z.to(io), r.to(io), q.to(io)


def gru_pass_bwd_plain(h, x, z, r, q, g, wzh, wzx, wrh, wrx, wqh, wqx,
                       stride: int, width: int):
    """(dh, dx, dwzh, dwzx, dwrh, dwrx, dwqh, dwqx, dbz, dbr, dbq) for the
    cotangent g of h', from the saved h, x, z, r, q."""
    io = h.dtype
    acc = acc_type(io)
    ws = [w.to(io) for w in (wzh, wzx, wrh, wrx, wqh, wqx)]
    wzh_, wzx_, wrh_, wrx_, wqh_, wqx_ = ws
    xi = x.to(io)
    hf, zf, rf, qf = (t.to(acc) for t in (h, z, r, q))
    gf = g.to(io).to(acc)
    geo = (stride, width, acc)
    dqh = (gf * zf * (1.0 - qf * qf)).to(io)
    dzh = (gf * (qf - hf) * zf * (1.0 - zf)).to(io)
    drh = conv_rows_t(dqh, wqh_, *geo)
    drhat = (drh * hf * rf * (1.0 - rf)).to(io)
    dh = (gf * (1.0 - zf) + drh * rf + conv_rows_t(dzh, wzh_, *geo)
          + conv_rows_t(drhat, wrh_, *geo))
    dx = (conv_rows_t(dzh, wzx_, *geo) + conv_rows_t(drhat, wrx_, *geo)
          + conv_rows_t(dqh, wqx_, *geo))
    rh = (rf * hf).to(io)
    dws = [wgrad_rows(a, dd, *geo) for a, dd in
           ((h, dzh), (xi, dzh), (h, drhat), (xi, drhat), (rh, dqh),
            (xi, dqh))]
    dbs = [dd.to(acc).sum(dim=(0, 1)) for dd in (dzh, drhat, dqh)]
    return (dh.to(h.dtype), dx.to(x.dtype),
            *(dw.to(w.dtype) for dw, w in
              zip(dws, (wzh, wzx, wrh, wrx, wqh, wqx))), *dbs)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _check(h, x, ws, stride, width, what):
    """The kernel's limits: h [B, HW, Ch] bf16 or fp32 on a CUDA device, x
    [B, HW, Cx] and the taps [5, Ch or Cx, Ch] on the same device, stride
    >= 1, width >= 1, and every row index of B * HW * max(Ch, Cx) within
    int32.  fp32 takes any Ch and Cx (the tiles mask ragged channels); bf16
    needs both to be multiples of 8 (its tiles load 8 channels at once)."""
    check_cuda(h, x, *ws)
    B, HW, Ch = h.shape
    Cx = x.shape[-1]
    shapes = [(TAPS, Ch, Ch), (TAPS, Cx, Ch)] * 3
    if h.dtype not in (torch.bfloat16, torch.float32) or \
            x.shape[:2] != (B, HW) or \
            [tuple(w.shape) for w in ws] != shapes:
        raise ValueError(f"{what}: h {tuple(h.shape)} {h.dtype}, x "
                         f"{tuple(x.shape)}, taps "
                         f"{[tuple(w.shape) for w in ws]}")
    if stride < 1 or width < 1 or B * HW * max(Ch, Cx) >= 2 ** 31:
        raise ValueError(f"{what}: stride {stride}, width {width}, "
                         f"{B * HW} rows")
    if h.dtype == torch.bfloat16 and (Ch % 8 or Cx % 8):
        raise ValueError(f"{what}: bf16 needs Ch and Cx multiples of 8, "
                         f"got {Ch}, {Cx}")
    return B, HW, Ch, Cx


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@counted
def gru_pass_fwd(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq,
                 stride: int, width: int):
    """(h', z, r, q), each [B, HW, Ch] in h's dtype: the pass and the
    residuals its backward reads."""
    if not h.is_cuda:
        return gru_pass_fwd_plain(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br,
                                  bq, stride, width)
    ws = (wzh, wzx, wrh, wrx, wqh, wqx)
    B, HW, Ch, Cx = _check(h, x, ws, stride, width, "gru_pass_fwd")
    io = h.dtype
    bf16 = io == torch.bfloat16
    h = _dense(h)
    x = _dense(x.to(io))
    ws = [_dense(w.to(io)) for w in ws]
    bs = [b.to(h.device, torch.float32).contiguous() for b in (bz, br, bq)]
    hout, z, r, q = (torch.empty_like(h) for _ in range(4))
    nbytes = fwd_scratch_bytes(B * HW, Ch, Cx, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=h.device)
    call("sep_conv_gru", "gru_fwd_launch", _FWD_SIG, ptr(h), ptr(x),
         *(ptr(w) for w in ws), *(ptr(b) for b in bs), ptr(hout), ptr(z),
         ptr(r), ptr(q), ptr(scratch), nbytes, B, HW, Ch, Cx, stride, width,
         int(bf16), stream(h))
    gru_pass_fwd.launches += 1
    return hout, z, r, q


@counted
def gru_pass_bwd(h, x, z, r, q, g, wzh, wzx, wrh, wrx, wqh, wqx,
                 stride: int, width: int):
    """(dh, dx, dwzh, dwzx, dwrh, dwrx, dwqh, dwqx, dbz, dbr, dbq) for the
    cotangent g of h'; the weight gradients are summed over every row in a
    fixed order, so two calls on one input give the same bits."""
    if not h.is_cuda:
        return gru_pass_bwd_plain(h, x, z, r, q, g, wzh, wzx, wrh, wrx, wqh,
                                  wqx, stride, width)
    ws0 = (wzh, wzx, wrh, wrx, wqh, wqx)
    B, HW, Ch, Cx = _check(h, x, ws0, stride, width, "gru_pass_bwd")
    io = h.dtype
    check_cuda(h, z, r, q, g)
    if any(t.shape != h.shape or t.dtype != io for t in (z, r, q)) or \
            g.shape != h.shape:
        raise ValueError("gru_pass_bwd: z, r, q and g must be h's shape, "
                         "z, r, q in h's dtype")
    h, z, r, q = (_dense(t) for t in (h, z, r, q))
    xi = _dense(x.to(io))
    g = _dense(g.to(io))
    ws = [_dense(w.to(io)) for w in ws0]
    dx_f32 = x.dtype != io
    bf16 = io == torch.bfloat16
    dh = torch.empty_like(h)
    dx = torch.empty(x.shape, dtype=torch.float32 if dx_f32 else io,
                     device=h.device)
    rows = B * HW
    nbytes = bwd_scratch_bytes(rows, Ch, Cx, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=h.device)
    # dw: per gate the h part [5, Ch, Ch], then the x part [5, Cx, Ch], then
    # the bias gradients [3, Ch]: each a contiguous piece.
    sizes = [TAPS * c * Ch for _ in range(3) for c in (Ch, Cx)] + [3 * Ch]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=h.device)
    call("sep_conv_gru", "gru_bwd_launch", _BWD_SIG, ptr(h), ptr(xi),
         ptr(z), ptr(r), ptr(q), ptr(g), *(ptr(w) for w in ws), ptr(dh),
         ptr(dx), int(dx_f32), ptr(scratch), nbytes,
         wgrad_splits(rows, bf16), ptr(dw), B, HW, Ch, Cx, stride, width,
         int(bf16), stream(h))
    gru_pass_bwd.launches += 1
    *dws, db = dw.split(sizes)
    db = db.view(3, Ch)
    return (dh, dx.to(x.dtype),
            *(d.view(w.shape).to(w.dtype) for d, w in zip(dws, ws0)),
            db[0], db[1], db[2])


# ---------------------------------------------------------------------------
# The differentiable pass
# ---------------------------------------------------------------------------

class GruPass(torch.autograd.Function):
    """h' of one pass (B10 forward); its backward is B10's backward."""

    @staticmethod
    def forward(ctx, h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq,
                stride, width):
        hout, z, r, q = gru_pass_fwd(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz,
                                     br, bq, stride, width)
        ctx.save_for_backward(h, x, z, r, q, wzh, wzx, wrh, wrx, wqh, wqx)
        ctx.geo = (stride, width)
        ctx.bias_dtypes = (bz.dtype, br.dtype, bq.dtype)
        return hout

    @staticmethod
    def backward(ctx, g):
        grads = gru_pass_bwd(*ctx.saved_tensors[:5], g,
                             *ctx.saved_tensors[5:], *ctx.geo)
        dbs = (d.to(dt) for d, dt in zip(grads[8:], ctx.bias_dtypes))
        return (*grads[:8], *dbs, None, None)


def gru_pass(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq, stride: int,
             width: int) -> torch.Tensor:
    """One pass (B10), differentiable in every tensor: h' [B, HW, Ch]."""
    return GruPass.apply(h, x, wzh, wzx, wrh, wrx, wqh, wqx, bz, br, bq,
                         stride, width)
