// B10: one directional SepConvGRU pass, forward and backward (sm_90a).
//
// Replaces craft_tpu/ops/pallas/sep_conv_gru.py: _gru_fwd (body
// _gru_fwd_kernel) and _gru_bwd_vjp (body _gru_bwd_kernel), reached through
// gru_pass.  Per pass over the rows p of h [B*HW, Ch] and x [B*HW, Cx]:
//   z = sigmoid(sum_t h[p+o_t] Wzh_t + x[p+o_t] Wzx_t + bz), r alike,
//   q = tanh(sum_t (r h)[p+o_t] Wqh_t + x[p+o_t] Wqx_t + bq),
//   h' = (1 - z) h + z q,
// with o_t = (t - 2) * s: s = 1 is the horizontal 1x5 pass, whose taps read
// zero where they leave the image row of p; s = W is the vertical 5x1 pass
// on the same NHWC rows, whose taps read zero above and below the image (the
// TPU kernel ran it on the transposed image instead).
//
// Bound on the H100: operations.  Each pass is a product of the rows with
// 5 * (Ch + Cx) weights per gate: at Ch = 128, Cx = 384 that is 2 * 5 * 512
// * 128 * 3 FLOP a row forward (13.8 GFLOP at B = 1, 440x1024), twice that
// backward (about 90 GFLOP at the chairs batch, 22,816 rows: 0.091 ms at
// the bf16 peak), over a few MB of rows, while the 15 taps of weights (1.97
// MB in bf16) are far above a block's shared memory.
//   The bf16 forward runs a wgmma body (below: gru_fwd_wgmma_kernel) in
// two launches, since q needs r h at the neighbouring rows: z and r over
// h | x on 64-row tiles of two warpgroups, then q over r h | x with the
// blend; the weights reach it as bulk copies of stage images that
// gru_pack_taps_kernel lays out once a pass.  The fp32 forward (and the
// fp32 backward) is a plain tiled product in FMA: a sweep of 64-row x
// 128-column output tiles, the depth (tap, then 32 channels at a time)
// staged through shared memory, the gate arithmetic in the epilogue, in
// the same two launches (z|r, then q with the blend).
//   The bf16 backward runs wgmma bodies (below: gru_tconv_wgmma_kernel,
// gru_wgrad_wgmma_kernel): 256 x 128 tiles of four warpgroups fed by a
// cp.async ring, the epilogues on the accumulator fragments.  Both
// backwards take five launches: the elementwise cotangents dqh, dzh (and
// r h), the conv-transpose drh with drhat in its epilogue, dh and dx, the
// weight and bias gradients as fixed row splits per (gate, tap, channel
// tile), and a fixed-order sum of the splits: no float atomics, so two
// backwards of one input are bit-identical.  The TPU kernel accumulated the
// weight gradients across sequential grid steps; blocks here run in
// parallel.
//
// Casts, as the TPU kernel's: x and the weights in the io type (h's), the
// bias fp32, every product summed in fp32; r h rounded to io from the fp32
// r in the forward and from the saved, rounded r in the backward; z, r, q
// saved in io; dqh, dzh and drhat rounded to io before every product and
// bias sum that reads them.
#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TAPS = 5, RAD = 2;
constexpr int BM = 64;   // output rows of a tile (weight gradients: channels)
constexpr int BN = 128;  // output columns of a tile
constexpr int BK = 32;   // depth staged per step: channels, or rows
constexpr int APAD = BM + 1, BPAD = BN + 1;
constexpr int MAX_OPS = 3;

// The rows of the pass: B images of HW rows each, taps s rows apart; a
// horizontal pass (s == 1) keeps its taps inside image rows of `width`.
struct Geo {
  int rows, HW, s, width;
};

// Row p's tap at offset d (in units of s): its source row, or -1 where the
// tap leaves the image (or the image row, for s == 1) and reads zero.
__device__ __forceinline__ int tap_src(const Geo& g, int p, int d) {
  if (p >= g.rows) return -1;
  const int local = p % g.HW;
  const int nb = local + d * g.s;
  if (nb < 0 || nb >= g.HW) return -1;
  if (g.s == 1) {
    const int w = local % g.width + d;
    if (w < 0 || w >= g.width) return -1;
  }
  return p + d * g.s;
}

// One term of a row convolution: sum_t A[src(p, d_t)] . W_t, A [rows, ka].
// W is [5, *, ldw] in the io type: W_t[k][col] for the forward conv (the
// tap stride is ka * ldw), W_t[col][k] for the conv-transpose (TRANS; the
// tap stride is ncol * ldw).
template <typename T>
struct Operand {
  const T* a;
  const T* w;
  int ka;
};

template <typename T>
struct RowConv {
  Operand<T> op[MAX_OPS];
  int nop, ncol, ldw;
};

__device__ __forceinline__ void zero_acc(float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j].
__device__ __forceinline__ void mac_tile(float acc[4][8], const float* As,
                                         int apad, const float* Bs,
                                         int bpad) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk * apad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bs[kk * bpad + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The 64 x 128 tile (rows row0.., columns col0..) of a row convolution
// (forward: d_t = t - 2) or of its transpose (TRANS: d_t = 2 - t, W_t
// transposed), in fp32 FMA.  Thread (tx, ty) holds rows ty + 16 i, columns
// tx + 16 j.
template <typename T, bool TRANS>
__device__ void rowconv_tile(const RowConv<T>& rc, const Geo& g,
                                 int row0, int col0, float acc[4][8]) {
  __shared__ float As[BK * APAD];
  __shared__ float Bs[BK * BPAD];
  const int tid = threadIdx.x;
  const int kk_a = tid % BK, r_a = tid / BK;  // A staging: 8 rows a thread
  zero_acc(acc);
  for (int o = 0; o < rc.nop; ++o) {
    const Operand<T> op = rc.op[o];
    for (int t = 0; t < TAPS; ++t) {
      const int d = TRANS ? RAD - t : t - RAD;
      int src[BM / 8];
#pragma unroll
      for (int it = 0; it < BM / 8; ++it)
        src[it] = tap_src(g, row0 + r_a + 8 * it, d);
      const T* wt =
          op.w + (size_t)t * (TRANS ? rc.ncol : op.ka) * rc.ldw;
      for (int k0 = 0; k0 < op.ka; k0 += BK) {
        __syncthreads();
        const int k = k0 + kk_a;
#pragma unroll
        for (int it = 0; it < BM / 8; ++it)
          As[kk_a * APAD + r_a + 8 * it] =
              src[it] >= 0 && k < op.ka
                  ? to_f(op.a[(size_t)src[it] * op.ka + k])
                  : 0.f;
#pragma unroll 4
        for (int e = tid; e < BK * BN; e += NTHREADS) {
          int kk, c;
          if (TRANS) {  // neighbouring threads on neighbouring k
            c = e / BK;
            kk = e % BK;
          } else {      // neighbouring threads on neighbouring columns
            kk = e / BN;
            c = e % BN;
          }
          const int kg = k0 + kk, col = col0 + c;
          float v = 0.f;
          if (kg < op.ka && col < rc.ncol)
            v = to_f(TRANS ? wt[(size_t)col * rc.ldw + kg]
                           : wt[(size_t)kg * rc.ldw + col]);
          Bs[kk * BPAD + c] = v;
        }
        __syncthreads();
        mac_tile(acc, As, APAD, Bs, BPAD);
      }
    }
  }
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---------------------------------------------------------------------------
// Forward (fp32)
// ---------------------------------------------------------------------------

// The gates' biases, [Ch] fp32 each.
struct Bias3 {
  const float *z, *r, *q;
};

// z (gate 0, blockIdx.z) or r (gate 1) over a tile.  z is kept in fp32 for
// the blend (zf), r is saved in io and r h rounded to io from the fp32 r.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_zr_kernel(RowConv<T> rz, RowConv<T> rr, Geo g, Bias3 bias,
                  const T* __restrict__ h, float* __restrict__ zf,
                  T* __restrict__ r_out, T* __restrict__ rh, int Ch) {
  const int gate = blockIdx.z;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
  rowconv_tile<T, false>(gate == 0 ? rz : rr, g, row0, col0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= Ch) continue;
      const size_t e = (size_t)p * Ch + c;
      const float b = (gate == 0 ? bias.z : bias.r)[c];
      const float v = sigmoidf_(acc[i][j] + b);
      if (gate == 0) {
        zf[e] = v;
      } else {
        r_out[e] = from_f<T>(v);
        rh[e] = from_f<T>(v * to_f(h[e]));
      }
    }
  }
}

// q over a tile, and the blend h' = (1 - z) h + z q with the fp32 z.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_q_kernel(RowConv<T> rq, Geo g, Bias3 bias, const T* __restrict__ h,
                 const float* __restrict__ zf, T* __restrict__ hout,
                 T* __restrict__ z_out, T* __restrict__ q_out, int Ch) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
  rowconv_tile<T, false>(rq, g, row0, col0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= Ch) continue;
      const size_t e = (size_t)p * Ch + c;
      const float q = tanhf(acc[i][j] + bias.q[c]);
      const float z = zf[e];
      hout[e] = from_f<T>((1.f - z) * to_f(h[e]) + z * q);
      z_out[e] = from_f<T>(z);
      q_out[e] = from_f<T>(q);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The elementwise cotangents of every row, from the io cotangent g and the
// saved io z, r, q: dqh = g z (1 - q^2), dzh = g (q - h) z (1 - z), both
// rounded to io, and r h rounded to io from the saved r.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_bwd_elem_kernel(const T* __restrict__ gr, const T* __restrict__ h,
                        const T* __restrict__ z, const T* __restrict__ r,
                        const T* __restrict__ q, T* __restrict__ dqh,
                        T* __restrict__ dzh, T* __restrict__ rh, size_t n) {
  for (size_t e = blockIdx.x * (size_t)NTHREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NTHREADS) {
    const float gv = to_f(gr[e]), hv = to_f(h[e]), zv = to_f(z[e]);
    const float qv = to_f(q[e]), rv = to_f(r[e]);
    dqh[e] = from_f<T>(gv * zv * (1.f - qv * qv));
    dzh[e] = from_f<T>(gv * (qv - hv) * zv * (1.f - zv));
    rh[e] = from_f<T>(rv * hv);
  }
}

// drh = the conv-transpose of dqh through Wqh, over a tile; its epilogue
// gives drhat = drh h r (1 - r) in io and the direct part of dh,
// g (1 - z) + drh r, in fp32.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_drh_kernel(RowConv<T> rc, Geo g, const T* __restrict__ gr,
                   const T* __restrict__ h, const T* __restrict__ z,
                   const T* __restrict__ r, T* __restrict__ drhat,
                   float* __restrict__ dhp, int Ch) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
  rowconv_tile<T, true>(rc, g, row0, col0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= Ch) continue;
      const size_t e = (size_t)p * Ch + c;
      const float drh = acc[i][j], rv = to_f(r[e]);
      drhat[e] = from_f<T>(drh * to_f(h[e]) * rv * (1.f - rv));
      dhp[e] = to_f(gr[e]) * (1.f - to_f(z[e])) + drh * rv;
    }
  }
}

// dh (column tiles below nh) = dhp + the conv-transposes of dzh and drhat
// through Wzh, Wrh; dx (the rest) = those of dzh, drhat, dqh through Wzx,
// Wrx, Wqx, written in fp32 (dx_f32) or io.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_dhx_kernel(RowConv<T> rch, RowConv<T> rcx, Geo g, int nh,
                   const float* __restrict__ dhp, T* __restrict__ dh,
                   void* __restrict__ dx, int dx_f32) {
  const bool is_h = (int)blockIdx.y < nh;
  const RowConv<T>& rc = is_h ? rch : rcx;
  const int row0 = blockIdx.x * BM;
  const int col0 = (is_h ? blockIdx.y : blockIdx.y - nh) * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
  rowconv_tile<T, true>(rc, g, row0, col0, acc);
  const int C = rc.ncol;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = row0 + ty + 16 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= C) continue;
      const size_t e = (size_t)p * C + c;
      if (is_h)
        dh[e] = from_f<T>(dhp[e] + acc[i][j]);
      else if (dx_f32)
        ((float*)dx)[e] = acc[i][j];
      else
        ((T*)dx)[e] = from_f<T>(acc[i][j]);
    }
  }
}

// Weight and bias gradients (fp32 FMA).  Block (channel tile, column tile)
// of gate blockIdx.y / 5, tap blockIdx.y % 5, row split blockIdx.z sums
//   dW_t[c][n] = sum_p A[src(p, t - 2)][c] D[p][n]
// over its split's rows, A = [h | x] (z, r) or [r h | x] (q), Cin = Ch + Cx
// channels, D = dzh, drhat, dqh: every row of every image once.  The blocks
// of the centre tap and channel tile 0 also sum D's columns (the bias
// gradient).  Partials go to part[split][gate][t][c][n], then the split's
// bias sums at part[split][15 Cin Ch + gate Ch + n].
__global__ void __launch_bounds__(NTHREADS)
    gru_wgrad_kernel(const float* __restrict__ h, const float* __restrict__ rh,
                     const float* __restrict__ x,
                     const float* __restrict__ dzh,
                     const float* __restrict__ drhat,
                     const float* __restrict__ dqh, Geo g, int Ch, int Cx,
                     int chunk, float* __restrict__ part) {
  __shared__ float As[BK * BM];  // rows x channels
  __shared__ float Ds[BK * BN];  // rows x columns
  const int Cin = Ch + Cx;
  const int nct = (Cin + BM - 1) / BM;
  const int c0 = (blockIdx.x % nct) * BM, n0 = (blockIdx.x / nct) * BN;
  const int gate = blockIdx.y / TAPS, t = blockIdx.y % TAPS;
  const int split = blockIdx.z;
  const float* ah = gate == 2 ? rh : h;
  const float* d = gate == 0 ? dzh : gate == 1 ? drhat : dqh;
  const int p0 = split * chunk;
  const int p1 = min(g.rows, p0 + chunk);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool bias_block = t == RAD && c0 == 0;
  float acc[4][8], db = 0.f;
  zero_acc(acc);
  const int ca = tid % BM, ka = tid / BM;    // A staging: 8 rows a thread
  const int nd = tid % BN, kd = tid / BN;    // D staging: 16 rows a thread
  const int c = c0 + ca;
  for (int k0 = p0; k0 < p1; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int it = 0; it < BK / 4; ++it) {
      const int kk = ka + 4 * it, p = k0 + kk;
      float v = 0.f;
      if (p < p1 && c < Cin) {
        const int src = tap_src(g, p, t - RAD);
        if (src >= 0)
          v = c < Ch ? ah[(size_t)src * Ch + c]
                     : x[(size_t)src * Cx + (c - Ch)];
      }
      As[kk * BM + ca] = v;
    }
#pragma unroll
    for (int it = 0; it < BK / 2; ++it) {
      const int kk = kd + 2 * it, p = k0 + kk, n = n0 + nd;
      Ds[kk * BN + nd] = p < p1 && n < Ch ? d[(size_t)p * Ch + n] : 0.f;
    }
    __syncthreads();
    mac_tile(acc, As, BM, Ds, BN);
    if (bias_block && tid < BN) {
      for (int kk = 0; kk < BK; ++kk) db += Ds[kk * BN + tid];
    }
  }
  const size_t per_split = (size_t)15 * Cin * Ch + 3 * Ch;
  float* out = part + split * per_split + (size_t)(gate * TAPS + t) * Cin * Ch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cc = c0 + ty + 16 * i;
    if (cc >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Ch) out[(size_t)cc * Ch + n] = acc[i][j];
    }
  }
  if (bias_block && tid < BN && n0 + tid < Ch)
    part[split * per_split + (size_t)15 * Cin * Ch + gate * Ch + n0 + tid] =
        db;
}

// dw[o] = the sum over the splits of the partials of its element, split 0
// first.  The partials lie [gate][tap][Ch + Cx][Ch] (then the biases [3]
// [Ch]), dw [gate][the h part: tap][Ch][Ch], [the x part: tap][Cx][Ch]
// (then the biases): each weight's gradient is one contiguous piece.
__global__ void __launch_bounds__(NTHREADS)
    sum_splits_kernel(const float* __restrict__ part, int nsplit, size_t n,
                      int Ch, int Cx, float* __restrict__ out) {
  const size_t hpart = (size_t)TAPS * Ch * Ch;
  const size_t gpart = (size_t)TAPS * (Ch + Cx) * Ch, wlen = 3 * gpart;
  for (size_t o = blockIdx.x * (size_t)NTHREADS + threadIdx.x; o < n;
       o += (size_t)gridDim.x * NTHREADS) {
    size_t i = o;
    if (o < wlen) {
      const size_t gate = o / gpart, rem = o % gpart;
      const bool xp = rem >= hpart;
      const size_t tap_len = (size_t)(xp ? Cx : Ch) * Ch;
      const size_t rr = xp ? rem - hpart : rem;
      i = gate * gpart + rr / tap_len * (Ch + Cx) * Ch +
          (xp ? (size_t)Ch * Ch : 0) + rr % tap_len;
    }
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + i];
    out[o] = s;
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// Two tile kernels, both 256 x 128 outputs a block of four consumer
// warpgroups (wgmma m64n128k16, fp32 sums in registers), their depth
// staged GB_DEPTH at a time through a ring of 16-byte cp.async copies that
// full/empty mbarriers count, 128-byte swizzled, one block an SM:
//   gru_tconv_wgmma_kernel, the conv-transposes drh (then, in a second
//   launch, dh | dx): rows x columns, the depth walking (operand, tap, 64
//   channels) through GB_TSTAGES stages; A = the operand's source rows of
//   the tap, K-major, a tap that leaves the image (or the image row, s = 1)
//   zero-filled by its copy; B = the tap's weights W_t[col][k], K-major as
//   they lie.  The epilogue reads the fragments: drh's gives drhat (io) and
//   dhp (fp32), dh's adds dhp, dx's writes fp32 or io.
//   gru_wgrad_wgmma_kernel, the weight gradients dW_t = A_t^T D: channels x
//   columns of one (gate, tap), the depth walking the rows of the block's
//   split through GB_WSTAGES stages.  A (rows x channels) and D (rows x
//   columns) lie MN-major in shared memory, so both descriptors take the
//   transpose bit.  GW_SPLITS row splits give 4 x 30 blocks at Ch 128, Cx
//   384 (15.7 MB of partials, not 16 x 3.93 MB); the centre tap's first
//   channel tile sums D's columns in row order for the bias gradients.
//   sum_splits_kernel adds the splits in order, so two backwards of one
//   input give the same bits.
// A 256 x 128 tile moves 85 FLOP a byte staged (a 128 x 128 one 64): the
// staged copies, from L2, bound both kernels more than the products do.
#define GB_WG 4        // consumer warpgroups a block: 256 rows (channels)
#define GB_COLS 128    // output columns a block (wgmma n)
#define GB_DEPTH 64    // depth a stage: channels, or rows for dW
#define GB_TSTAGES 3   // ring stages of the conv-transpose tiles
#define GB_WSTAGES 4   // ring stages of the weight-gradient tiles
#define GW_SPLITS 4      // row splits of the bf16 weight gradients
#define GW_SPLIT_ROWS 2048  // fewest rows a split sums

static_assert(GB_DEPTH * 2 == 128, "128-byte rows: the 128-byte swizzle");

// A body of GB_WG consumer warpgroups (64 GB_WG output rows, or channels
// for dW) and a ring of ST stages: its threads, tiles and shared memory.
template <int ST>
struct Tiles {
  static constexpr int THREADS = 128 * GB_WG, ROWS = 64 * GB_WG;
  static constexpr int A = ROWS * GB_DEPTH * 2;     // A tile, bytes
  static constexpr int B = GB_COLS * GB_DEPTH * 2;  // B (D) tile, bytes
  static constexpr int STAGE = A + B;
  static constexpr int SMEM = ST * STAGE + 2 * ST * 8 + 1024;
};

// wgmma m64n128k16, both operands from shared memory; TA, TB: the
// transpose bits (1: the operand is MN-major in shared memory).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float (*d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// A tile (stage base + offset) as the K-major operand of a 64-row
// warpgroup slice (rows of 128 bytes, 8-row groups 1024 bytes apart), or as
// an MN-major one (64-element blocks `blk` bytes apart, 8-row groups along
// the depth 1024 bytes apart), each 128-byte swizzled.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return gmma_desc(addr, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t blk) {
  return gmma_desc(addr, blk, 1024, 1);
}

// The byte offset of 16-byte chunk c (0..7) of tile row r in a 128-byte
// swizzled tile.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// The ring's barriers (full, empty a stage), shared by both kernels.
template <int ST, int THREADS>
struct Ring {
  uint32_t full0, empty0;
  __device__ __forceinline__ void init(unsigned char* bars) {
    full0 = smem_u32(bars);
    empty0 = full0 + 8 * ST;
    if (threadIdx.x == 0) {
      for (int i = 0; i < ST; ++i) {
        mbar_init(full0 + 8 * i, THREADS);
        mbar_init(empty0 + 8 * i, THREADS);
      }
    }
    __syncthreads();
  }
};

// Up to three conv-transpose operands (a [rows][Ch], the forward's taps w
// [5][ncol][Ch]) summed into one output of ncol columns.
struct TConv {
  const bf16 *a0, *a1, *a2, *w0, *w1, *w2;
  int nop, ncol;
};

struct TEpi {
  const bf16 *gr, *h, *z, *r;
  bf16* drhat;
  float* dhp;
  bf16* dh;
  void* dx;
  int dx_f32;
};

// One 64 GB_WG x 128 conv-transpose tile: DRH (grid: row tiles x column
// tiles of Ch) drh through rc0 with drhat and dhp in the epilogue; else
// (grid: row tiles x (nh column tiles of dh, then those of dx)) dh = dhp +
// rc0's sum, dx = rc1's.  Channels (Ch, Cx) are multiples of 8.
template <bool DRH, int ST>
__global__ void __launch_bounds__(128 * GB_WG, 1)
    gru_tconv_wgmma_kernel(TConv rc0, TConv rc1, Geo g, int Ch, int nh,
                           TEpi ep) {
  using TL = Tiles<ST>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  const bool first = DRH || (int)blockIdx.y < nh;
  const TConv rc = first ? rc0 : rc1;
  const int row0 = blockIdx.x * TL::ROWS;
  const int col0 = (first ? blockIdx.y : blockIdx.y - nh) * GB_COLS;
  Ring<ST, TL::THREADS> ring;
  ring.init(smem + ST * TL::STAGE);

  // Copies: chunk c of tile rows rr + RSTEP i (A: output rows; B:
  // columns).
  constexpr int RSTEP = TL::THREADS / 8;
  const int tid = threadIdx.x, c = tid & 7, rr = tid >> 3;
  int loc[4], wc[4];
  bool row_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = row0 + rr + RSTEP * i;
    row_in[i] = p < g.rows;
    loc[i] = p % g.HW;
    wc[i] = loc[i] % g.width;
  }
  const int nkc = (Ch + GB_DEPTH - 1) / GB_DEPTH;
  const int nk = rc.nop * TAPS * nkc;
  auto load_stage = [&](int ks, int s) {
    const int kc = ks % nkc, t = ks / nkc % TAPS, o = ks / (nkc * TAPS);
    const bf16* a = o == 0 ? rc.a0 : o == 1 ? rc.a1 : rc.a2;
    const bf16* w = (o == 0 ? rc.w0 : o == 1 ? rc.w1 : rc.w2) +
                    (size_t)t * rc.ncol * Ch;
    const int d = RAD - t, k = kc * GB_DEPTH + 8 * c;
    const bool k_in = k < Ch;
    const uint32_t sa = smem_u32(smem + s * TL::STAGE);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rr + RSTEP * i;
      const int nb = loc[i] + d * g.s;
      bool ok = k_in && row_in[i] && nb >= 0 && nb < g.HW;
      if (g.s == 1) ok = ok && wc[i] + d >= 0 && wc[i] + d < g.width;
      const int src = row0 + r + d * g.s;
      cp_async16(sa + swz128(r, c), ok ? a + (size_t)src * Ch + k : a, ok);
    }
#pragma unroll
    for (int i = 0; i < GB_COLS / RSTEP; ++i) {
      const int r = rr + RSTEP * i;
      const bool wok = k_in && col0 + r < rc.ncol;
      cp_async16(sa + TL::A + swz128(r, c),
                 wok ? w + (size_t)(col0 + r) * Ch + k : w, wok);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) {
      load_stage(i, i);
      mbar_arrive_copies(ring.full0 + 8 * i);
    }
  }

  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t base = smem_u32(smem);
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % ST;
    mbar_wait(ring.full0 + 8 * s, (ks / ST) & 1);
    fence_async_smem();
    const uint32_t st = base + s * TL::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GB_DEPTH / 16; ++kk)
      wgmma_ss128<0, 0>(acc, kmajor_desc(st + wg * 64 * 128 + 32 * kk),
                        kmajor_desc(st + TL::A + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[j][e]);
    mbar_arrive(ring.empty0 + 8 * s);
    const int nxt = ks + ST - 1;
    if (nxt < nk) {
      const int sp = nxt % ST;
      if (ks > 0) mbar_wait(ring.empty0 + 8 * sp, ((ks - 1) / ST) & 1);
      load_stage(nxt, sp);
      mbar_arrive_copies(ring.full0 + 8 * sp);
    }
  }

  // Epilogue on the fragments: rows 64 wg + 16 (warp % 4) + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1).
  const int C = rc.ncol;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = row0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col >= C) continue;
      const size_t e = (size_t)p * C + col;
      const float v0 = acc[j][2 * i], v1 = acc[j][2 * i + 1];
      if (DRH) {
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.h + e));
        const float2 rv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.r + e));
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.gr + e));
        const float2 zv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.z + e));
        *reinterpret_cast<uint32_t*>(ep.drhat + e) =
            pack_bf16(v0 * hv.x * rv.x * (1.f - rv.x),
                      v1 * hv.y * rv.y * (1.f - rv.y));
        *reinterpret_cast<float2*>(ep.dhp + e) =
            make_float2(gv.x * (1.f - zv.x) + v0 * rv.x,
                        gv.y * (1.f - zv.y) + v1 * rv.y);
      } else if (first) {
        const float2 d = *reinterpret_cast<const float2*>(ep.dhp + e);
        *reinterpret_cast<uint32_t*>(ep.dh + e) =
            pack_bf16(d.x + v0, d.y + v1);
      } else if (ep.dx_f32) {
        *reinterpret_cast<float2*>((float*)ep.dx + e) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>((bf16*)ep.dx + e) = pack_bf16(v0, v1);
      }
    }
  }
}

// Block (channel tile, column tile) of gate blockIdx.y / 5, tap
// blockIdx.y % 5, row split blockIdx.z: dW_t[c][n] = sum_p A[src(p, t -
// 2)][c] D[p][n] over the split's rows, A = [h | x] (z, r) or [r h | x]
// (q), D = dzh, drhat, dqh; written to part as gru_wgrad_kernel writes it.
template <int ST>
__global__ void __launch_bounds__(128 * GB_WG, 1)
    gru_wgrad_wgmma_kernel(const bf16* __restrict__ h,
                           const bf16* __restrict__ rh,
                           const bf16* __restrict__ x,
                           const bf16* __restrict__ dzh,
                           const bf16* __restrict__ drhat,
                           const bf16* __restrict__ dqh, Geo g, int Ch,
                           int Cx, int chunk, float* __restrict__ part) {
  using TL = Tiles<ST>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  const int Cin = Ch + Cx;
  const int nct = (Cin + TL::ROWS - 1) / TL::ROWS;
  const int c0 = (blockIdx.x % nct) * TL::ROWS;
  const int n0 = (blockIdx.x / nct) * GB_COLS;
  const int gate = blockIdx.y / TAPS, t = blockIdx.y % TAPS;
  const int split = blockIdx.z;
  const bf16* ah = gate == 2 ? rh : h;
  const bf16* dd = gate == 0 ? dzh : gate == 1 ? drhat : dqh;
  const int p0 = split * chunk, p1 = min(g.rows, p0 + chunk);
  const int nk = p1 > p0 ? (p1 - p0 + GB_DEPTH - 1) / GB_DEPTH : 0;
  Ring<ST, TL::THREADS> ring;
  ring.init(smem + ST * TL::STAGE);

  // Copies of A: 16-byte chunk cc (8 channels; 64-channel block cc / 8) of
  // depth rows kr + 16 i.  Each thread's rows step by GB_DEPTH a stage, so
  // their place in the image is stepped, not divided, per stage.  Copies
  // of D: chunk dc (8 columns) of rows dr + DSTEP i.
  constexpr int ACH = 8 * GB_WG, DSTEP = TL::THREADS / 16;
  const int tid = threadIdx.x, cc = tid % ACH, kr = tid / ACH;
  const int dc = tid & 15, dr = tid >> 4;
  const int d = t - RAD;
  int loc[4], wc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + kr + 16 * i;
    loc[i] = p % g.HW;
    wc[i] = loc[i] % g.width;
  }
  const int ch = c0 + 8 * cc, col = n0 + 8 * dc;
  const bool ch_in = ch < Cin, col_in = col < Ch;
  const bf16* asrc = ch < Ch ? ah + ch : x + (ch - Ch);
  const int lda = ch < Ch ? Ch : Cx;
  const uint32_t ablk = (uint32_t)(cc >> 3) * (GB_DEPTH * 128);
  const uint32_t dblk = TL::A + (uint32_t)(dc >> 3) * (GB_DEPTH * 128);
  auto load_stage = [&](int ks, int s) {
    const uint32_t sa = smem_u32(smem + s * TL::STAGE);
    const int pk = p0 + ks * GB_DEPTH;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kr + 16 * i, p = pk + r;
      const int nb = loc[i] + d * g.s;
      bool ok = ch_in && p < p1 && nb >= 0 && nb < g.HW;
      if (g.s == 1) ok = ok && wc[i] + d >= 0 && wc[i] + d < g.width;
      cp_async16(sa + ablk + swz128(r, cc & 7),
                 ok ? asrc + (size_t)(p + d * g.s) * lda : h, ok);
      // The next stage's rows lie GB_DEPTH further on.
      loc[i] += GB_DEPTH;
      if (loc[i] >= g.HW) {  // into the next image (rare): divide again
        loc[i] %= g.HW;
        wc[i] = loc[i] % g.width;
      } else if (g.s == 1) {
        wc[i] += GB_DEPTH;
        while (wc[i] >= g.width) wc[i] -= g.width;
      }
    }
#pragma unroll
    for (int i = 0; i < GB_DEPTH / DSTEP; ++i) {
      const int r = dr + DSTEP * i, p = pk + r;
      const bool dok = col_in && p < p1;
      cp_async16(sa + dblk + swz128(r, dc & 7),
                 dok ? dd + (size_t)p * Ch + col : dd, dok);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) {
      load_stage(i, i);
      mbar_arrive_copies(ring.full0 + 8 * i);
    }
  }

  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const bool bias_block = t == RAD && c0 == 0 && tid < GB_COLS;
  float acc[16][4], db = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t base = smem_u32(smem);
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % ST;
    mbar_wait(ring.full0 + 8 * s, (ks / ST) & 1);
    fence_async_smem();
    const uint32_t st = base + s * TL::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GB_DEPTH / 16; ++kk)
      wgmma_ss128<1, 1>(
          acc, mnmajor_desc(st + wg * (GB_DEPTH * 128) + kk * 16 * 128,
                            GB_DEPTH * 128),
          mnmajor_desc(st + TL::A + kk * 16 * 128, GB_DEPTH * 128), 1);
    wgmma_commit();
    if (bias_block) {  // column tid of D, its rows in order
      const unsigned char* ds = smem + s * TL::STAGE + TL::A +
                                (tid >> 6) * (GB_DEPTH * 128) +
                                2 * (tid & 7);
      const int c8 = (tid & 63) >> 3;
#pragma unroll 8
      for (int r = 0; r < GB_DEPTH; ++r)
        db += __bfloat162float(
            *reinterpret_cast<const bf16*>(ds + swz128(r, c8)));
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[j][e]);
    mbar_arrive(ring.empty0 + 8 * s);
    const int nxt = ks + ST - 1;
    if (nxt < nk) {
      const int sp = nxt % ST;
      if (ks > 0) mbar_wait(ring.empty0 + 8 * sp, ((ks - 1) / ST) & 1);
      load_stage(nxt, sp);
      mbar_arrive_copies(ring.full0 + 8 * sp);
    }
  }

  const size_t per_split = (size_t)15 * Cin * Ch + 3 * Ch;
  float* out = part + split * per_split + (size_t)(gate * TAPS + t) * Cin * Ch;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n < Ch)
        *reinterpret_cast<float2*>(out + (size_t)c * Ch + n) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
  if (bias_block && n0 + tid < Ch)
    part[split * per_split + (size_t)15 * Cin * Ch + gate * Ch + n0 + tid] =
        db;
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// One tile kernel, gru_fwd_wgmma_kernel, in two launches of 64 x 128
// outputs a block, one consumer warpgroup a gate (m64n128k16 from shared
// memory, fp32 sums in registers: one 64-float accumulator a thread), the
// depth (tap, segment, 64 channels) staged through a ring that full/empty
// mbarriers count:
//   ZR, two warpgroups: z and r over h | x.  The epilogue writes z (fp32)
//   for the blend, r and r h (io).
//   Q, one warpgroup: q over r h | x, which reads r h at rows +-2s, then
//   h' = (1 - z) h + z q, z and q in io.
// A stage holds the tap's source rows of the segment (K-major, 128-byte
// swizzled), copied 16 bytes a thread by cp.async, so that a tap that
// leaves the image or the image row is zero-filled by its copy; and the
// gates' weights W_t[k][col] as they lie (N-contiguous: 64-column blocks
// of 128-byte depth rows, MN-major, the transpose bit on B only), one bulk
// copy (the copy engine, counted in bytes on the full barrier) of the
// stage's image that gru_pack_taps_kernel lays out once a pass.  Each
// warpgroup keeps one step's products in flight while it refills the ring.
// What bounds a block is its chain of waits a step (copies, barriers, the
// products), so the tiles are the smallest wgmma takes: 64 rows fill 110
// SMs at serving (128-row tiles of four warpgroups filled 55 and took half
// as long again), and the q launch's small ring lets three blocks share an
// SM.  No sum crosses blocks: two forwards of one input give the same
// bits.
#define GF_ROWS 64      // output rows of a forward block (the wgmma m)
#define GF_ZSTAGES 4    // ring stages of the z | r launch
#define GF_QSTAGES 3    // ring stages of the q launch
#define GF_TILE 16384   // bytes of one gate's weights in a stage

static_assert(GB_COLS * GB_DEPTH * 2 == GF_TILE, "a gate's B tile");

// A forward body of NG gates (a consumer warpgroup each) and a ring of ST
// stages: its rows, threads and shared memory.
template <int NG, int ST>
struct FTiles {
  static constexpr int ROWS = GF_ROWS, THREADS = 128 * NG;
  static constexpr int A = ROWS * GB_DEPTH * 2;  // A tile, bytes
  static constexpr int STAGE = A + NG * GF_TILE;
  static constexpr int SMEM = ST * STAGE + 2 * ST * 8 + 1024;
};

// 16-byte units of the stage images: per launch (ZR's two gates over h |
// x, then Q's one over r h | x), per column tile, stage (tap t, then the
// 64-channel chunks of both segments) and gate, GF_TILE bytes: two
// 64-column blocks of 64 depth rows of 128 bytes, swz128-swizzled, zeros
// beyond the segment's channels and beyond Ch.
struct Taps {
  const bf16* w[6];  // wzh, wzx, wrh, wrx, wqh, wqx: [5][Ch or Cx][Ch]
  int Ch, Cx;
};

__device__ __forceinline__ int chunks64(int k) {
  return (k + GB_DEPTH - 1) / GB_DEPTH;
}

__global__ void __launch_bounds__(NTHREADS)
    gru_pack_taps_kernel(Taps tp, uint4* __restrict__ out, long long n) {
  const int nkt = chunks64(tp.Ch) + chunks64(tp.Cx), nk = TAPS * nkt;
  const int nct = (tp.Ch + GB_COLS - 1) / GB_COLS;
  const long long zr_tiles = 2LL * nct * nk;
  for (long long u = blockIdx.x * (long long)NTHREADS + threadIdx.x; u < n;
       u += (long long)gridDim.x * NTHREADS) {
    long long tile = u >> 10;
    const int in = (int)(u & 1023), blk = in >> 9, r = (in >> 3) & 63;
    const int c = (in & 7) ^ (r & 7);
    int gate;  // 0..2: z, r, q
    if (tile < zr_tiles) {
      gate = (int)(tile & 1);
      tile >>= 1;
    } else {
      gate = 2;
      tile -= zr_tiles;
    }
    const int ct = (int)(tile / nk), ks = (int)(tile % nk);
    const int t = ks / nkt, j = ks % nkt, nkh = chunks64(tp.Ch);
    const bool seg = j >= nkh;
    const int ka = seg ? tp.Cx : tp.Ch;
    const int k = (seg ? j - nkh : j) * GB_DEPTH + r;
    const int col = ct * GB_COLS + 64 * blk + 8 * c;
    const bf16* w = tp.w[2 * gate + (seg ? 1 : 0)];
    out[u] = k < ka && col < tp.Ch
                 ? *reinterpret_cast<const uint4*>(
                       w + ((size_t)t * ka + k) * tp.Ch + col)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The copy engine: bytes from global to shared memory, their arrival
// counted on the mbarrier at bar (whose phase waits for them after
// mbar_arrive_expect_tx, wgmma.cuh, has announced them).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The depth of a forward launch: two segments of source rows (h and x, or
// r h and x), a[s] [rows][k[s]], and the launch's stage images.
struct FConv {
  const bf16* a[2];
  const unsigned char* wimg;
  int k[2], ncol;
};

struct FEpi {
  const float *bz, *br, *bq;
  const bf16* h;
  float* zf;
  bf16 *r, *rh, *hout, *z, *q;
};

template <bool ZR, int ST>
__global__ void __launch_bounds__(ZR ? 256 : 128, ZR ? 1 : 3)
    gru_fwd_wgmma_kernel(FConv fc, Geo g, FEpi ep) {
  constexpr int NG = ZR ? 2 : 1;
  using TL = FTiles<NG, ST>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  const int row0 = blockIdx.x * TL::ROWS, col0 = blockIdx.y * GB_COLS;
  const int tid = threadIdx.x;
  // Full: every thread's copies and the bulk copy's bytes (thread 0's
  // extra arrival announces them); empty: every thread.
  const uint32_t full0 = smem_u32(smem + ST * TL::STAGE);
  const uint32_t empty0 = full0 + 8 * ST;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full0 + 8 * i, TL::THREADS + 1);
      mbar_init(empty0 + 8 * i, TL::THREADS);
    }
  }
  __syncthreads();

  // Warpgroup gate: z or r (ZR), q.  Copies of A: chunk c (8 channels) of
  // tile rows rr + RSTEP i, each row's place in the image found once.
  constexpr int RSTEP = TL::THREADS / 8, AI = TL::ROWS / RSTEP;
  const int c = tid & 7, rr = tid >> 3;
  const int warp = tid >> 5, lane = tid & 31, gate = warp >> 2;
  int loc[AI], wc[AI];
  bool row_in[AI];
#pragma unroll
  for (int i = 0; i < AI; ++i) {
    const int p = row0 + rr + RSTEP * i;
    row_in[i] = p < g.rows;
    loc[i] = p % g.HW;
    wc[i] = loc[i] % g.width;
  }
  const int nk0 = chunks64(fc.k[0]);
  const int nkt = nk0 + chunks64(fc.k[1]), nk = TAPS * nkt;
  const unsigned char* wimg =
      fc.wimg + (size_t)blockIdx.y * nk * NG * GF_TILE;
  auto load_stage = [&](int ks, int s) {
    const int t = ks / nkt, j = ks % nkt;
    const bool seg = j >= nk0;
    const int kc = seg ? j - nk0 : j, ka = seg ? fc.k[1] : fc.k[0];
    const bf16* a = seg ? fc.a[1] : fc.a[0];
    const int d = t - RAD, k = kc * GB_DEPTH + 8 * c;
    const bool k_in = k < ka;
    const uint32_t sa = smem_u32(smem + s * TL::STAGE);
    if (tid == 0) {
      mbar_arrive_expect_tx(full0 + 8 * s, NG * GF_TILE);
      bulk_copy(sa + TL::A, wimg + (size_t)ks * NG * GF_TILE, NG * GF_TILE,
                full0 + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = rr + RSTEP * i;
      const int nb = loc[i] + d * g.s;
      bool ok = k_in && row_in[i] && nb >= 0 && nb < g.HW;
      if (g.s == 1) ok = ok && wc[i] + d >= 0 && wc[i] + d < g.width;
      const int src = row0 + r + d * g.s;
      cp_async16(sa + swz128(r, c), ok ? a + (size_t)src * ka + k : a, ok);
    }
    mbar_arrive_copies(full0 + 8 * s);
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i)
    if (i < nk) load_stage(i, i);

  // Step ks: its products go in flight, then those of step ks - 1 are
  // waited for, their stage released and refilled with step ks + ST - 1.
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t base = smem_u32(smem);
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % ST;
    mbar_wait(full0 + 8 * s, (ks / ST) & 1);
    fence_async_smem();
    const uint32_t st = base + s * TL::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GB_DEPTH / 16; ++kk)
      wgmma_ss128<0, 1>(
          acc, kmajor_desc(st + 32 * kk),
          mnmajor_desc(st + TL::A + gate * GF_TILE + kk * 16 * 128,
                       GB_DEPTH * 128),
          1);
    wgmma_commit();
    wgmma_wait1();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[j][e]);
    const int sp = (ks + ST - 1) % ST;  // step ks - 1's stage
    if (ks > 0) mbar_arrive(empty0 + 8 * sp);
    if (ks + ST - 1 < nk) {
      if (ks > 0) mbar_wait(empty0 + 8 * sp, ((ks - 1) / ST) & 1);
      load_stage(ks + ST - 1, sp);
    }
  }
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(acc[j][e]);

  // Epilogue on the fragments: rows 16 (warp % 4) + lane / 4 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1).
  const int C = fc.ncol;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = row0 + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cl = col0 + 8 * j + 2 * (lane & 3);
      if (cl >= C) continue;
      const size_t e = (size_t)p * C + cl;
      const float v0 = acc[j][2 * i], v1 = acc[j][2 * i + 1];
      if (ZR && gate == 0) {
        *reinterpret_cast<float2*>(ep.zf + e) = make_float2(
            sigmoidf_(v0 + ep.bz[cl]), sigmoidf_(v1 + ep.bz[cl + 1]));
      } else if (ZR) {
        const float r0 = sigmoidf_(v0 + ep.br[cl]);
        const float r1 = sigmoidf_(v1 + ep.br[cl + 1]);
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.h + e));
        *reinterpret_cast<uint32_t*>(ep.r + e) = pack_bf16(r0, r1);
        *reinterpret_cast<uint32_t*>(ep.rh + e) =
            pack_bf16(r0 * hv.x, r1 * hv.y);
      } else {
        const float2 zv = *reinterpret_cast<const float2*>(ep.zf + e);
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.h + e));
        const float q0 = tanhf(v0 + ep.bq[cl]);
        const float q1 = tanhf(v1 + ep.bq[cl + 1]);
        *reinterpret_cast<uint32_t*>(ep.hout + e) =
            pack_bf16((1.f - zv.x) * hv.x + zv.x * q0,
                      (1.f - zv.y) * hv.y + zv.y * q1);
        *reinterpret_cast<uint32_t*>(ep.z + e) = pack_bf16(zv.x, zv.y);
        *reinterpret_cast<uint32_t*>(ep.q + e) = pack_bf16(q0, q1);
      }
    }
  }
}

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

inline int elem_blocks(size_t n) {
  return (int)std::min<size_t>((n + NTHREADS - 1) / NTHREADS, 132 * 16);
}

template <typename T>
RowConv<T> rowconv(int ncol, int ldw, std::initializer_list<Operand<T>> ops) {
  RowConv<T> rc{};
  rc.nop = 0;
  for (const auto& op : ops) rc.op[rc.nop++] = op;
  rc.ncol = ncol;
  rc.ldw = ldw;
  return rc;
}

// Scratch buffers are carved into pieces that each start on a
// SCRATCH_ALIGN-byte boundary.
#define SCRATCH_ALIGN 256
inline long long align_up(long long n) {
  return (n + SCRATCH_ALIGN - 1) / SCRATCH_ALIGN * SCRATCH_ALIGN;
}
struct Carve {
  unsigned char* p;
  template <typename T>
  T* take(long long bytes) {
    T* out = reinterpret_cast<T*>(p);
    p += align_up(bytes);
    return out;
  }
};

// The forward's scratch, in bytes: zf (fp32), then r h (io), each
// [rows][Ch], then for bf16 the stage images of the weights (GF_TILE bytes
// for each of 3 gates, 5 taps, the 64-channel chunks of Ch and of Cx, and
// the 128-column tiles of Ch); the wrapper repeats the rule (another size
// is refused).
long long fwd_scratch_bytes(int rows, int Ch, int Cx, int io_bf16) {
  const long long n = (long long)rows * Ch;
  const long long images =
      io_bf16 ? 3LL * TAPS * (cdiv(Ch, GB_DEPTH) + cdiv(Cx, GB_DEPTH)) *
                    cdiv(Ch, GB_COLS) * GF_TILE
              : 0;
  return align_up(4 * n) + align_up((io_bf16 ? 2 : 4) * n) + images;
}

int fwd_fp32(const float* h, const float* x, const float* const* w,
             Bias3 bias, float* hout, float* z, float* r, float* q,
             Carve sc, const Geo& g, int Ch, int Cx, cudaStream_t st) {
  const long long n = (long long)g.rows * Ch;
  float* zf = sc.take<float>(4 * n);
  float* rh = sc.take<float>(4 * n);
  const dim3 grid(cdiv(g.rows, BM), cdiv(Ch, BN), 2);
  gru_zr_kernel<float><<<grid, NTHREADS, 0, st>>>(
      rowconv<float>(Ch, Ch, {{h, w[0], Ch}, {x, w[1], Cx}}),
      rowconv<float>(Ch, Ch, {{h, w[2], Ch}, {x, w[3], Cx}}), g, bias, h,
      zf, r, rh, Ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_q_kernel<float><<<dim3(grid.x, grid.y), NTHREADS, 0, st>>>(
      rowconv<float>(Ch, Ch, {{rh, w[4], Ch}, {x, w[5], Cx}}), g, bias, h,
      zf, hout, z, q, Ch);
  return (int)cudaGetLastError();
}

int fwd_bf16(const bf16* h, const bf16* x, const bf16* const* w, Bias3 bias,
             bf16* hout, bf16* z, bf16* r, bf16* q, Carve sc, const Geo& g,
             int Ch, int Cx, cudaStream_t st) {
  const long long n = (long long)g.rows * Ch;
  FEpi ep{bias.z, bias.r, bias.q, h, nullptr, r, nullptr, hout, z, q};
  ep.zf = sc.take<float>(4 * n);
  ep.rh = sc.take<bf16>(2 * n);
  uint4* images = reinterpret_cast<uint4*>(sc.p);
  const uintptr_t align = (uintptr_t)h | (uintptr_t)x | (uintptr_t)w[0] |
                          (uintptr_t)w[1] | (uintptr_t)w[2] |
                          (uintptr_t)w[3] | (uintptr_t)w[4] |
                          (uintptr_t)w[5] | (uintptr_t)ep.zf;
  const uintptr_t align4 = (uintptr_t)hout | (uintptr_t)z | (uintptr_t)r |
                           (uintptr_t)q;
  if (Ch % 8 || Cx % 8 || (align & 15) || (align4 & 3))
    return (int)cudaErrorInvalidValue;
  const int nct = cdiv(Ch, GB_COLS);
  const long long zr_bytes = 2LL * TAPS *
                             (cdiv(Ch, GB_DEPTH) + cdiv(Cx, GB_DEPTH)) *
                             nct * GF_TILE;
  const long long units = zr_bytes / 2 * 3 / 16;
  gru_pack_taps_kernel<<<elem_blocks(units), NTHREADS, 0, st>>>(
      Taps{{w[0], w[1], w[2], w[3], w[4], w[5]}, Ch, Cx}, images, units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned char* img = reinterpret_cast<const unsigned char*>(images);
  using ZT = FTiles<2, GF_ZSTAGES>;
  using QT = FTiles<1, GF_QSTAGES>;
  auto zr_k = gru_fwd_wgmma_kernel<true, GF_ZSTAGES>;
  auto q_k = gru_fwd_wgmma_kernel<false, GF_QSTAGES>;
  if ((err = allow_smem(zr_k, ZT::SMEM)) != cudaSuccess ||
      (err = allow_smem(q_k, QT::SMEM)) != cudaSuccess)
    return (int)err;
  const dim3 grid(cdiv(g.rows, ZT::ROWS), nct);
  const FConv zr{{h, x}, img, {Ch, Cx}, Ch};
  zr_k<<<grid, ZT::THREADS, ZT::SMEM, st>>>(zr, g, ep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const FConv qc{{ep.rh, x}, img + zr_bytes, {Ch, Cx}, Ch};
  q_k<<<grid, QT::THREADS, QT::SMEM, st>>>(qc, g, ep);
  return (int)cudaGetLastError();
}

// Row splits of the weight gradients, a rule the wrapper repeats to size
// the partials (another count is refused): fp32 up to FW_SPLITS of at
// least FW_SPLIT_ROWS rows, bf16 up to GW_SPLITS of at least GW_SPLIT_ROWS.
#define FW_SPLITS 16
#define FW_SPLIT_ROWS 1024
int wgrad_splits(int rows, int io_bf16) {
  const int most = io_bf16 ? GW_SPLITS : FW_SPLITS;
  const int n = rows / (io_bf16 ? GW_SPLIT_ROWS : FW_SPLIT_ROWS);
  return n < 1 ? 1 : n > most ? most : n;
}

// The backward's scratch, in bytes: dqh, dzh, r h and drhat (io), dhp
// (fp32), each [rows][Ch], then part (fp32, nsplit x the length of dw);
// the wrapper repeats the rule (another size is refused).
long long bwd_scratch_bytes(int rows, int Ch, int Cx, int nsplit,
                            int io_bf16) {
  const long long n = (long long)rows * Ch;
  const long long per_split = 15LL * (Ch + Cx) * Ch + 3 * Ch;
  return 4 * align_up((io_bf16 ? 2 : 4) * n) + align_up(4 * n) +
         align_up(4 * nsplit * per_split);
}

struct BwdScratch {
  void *dqh, *dzh, *rh, *drhat;
  float *dhp, *part;
};

int bwd_fp32(const float* h, const float* x, const float* z, const float* r,
             const float* q, const float* gr, const float* const* w,
             void* dh, void* dx, BwdScratch sc, int nsplit, float* dw,
             const Geo& g, int Ch, int Cx, cudaStream_t st) {
  const float *wzh = w[0], *wzx = w[1], *wrh = w[2], *wrx = w[3];
  const float *wqh = w[4], *wqx = w[5];
  float *dqh = (float*)sc.dqh, *dzh = (float*)sc.dzh, *rh = (float*)sc.rh;
  float* drhat = (float*)sc.drhat;
  const size_t n = (size_t)g.rows * Ch;
  gru_bwd_elem_kernel<float><<<elem_blocks(n), NTHREADS, 0, st>>>(
      gr, h, z, r, q, dqh, dzh, rh, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nr = cdiv(g.rows, BM), nh = cdiv(Ch, BN);
  gru_drh_kernel<float><<<dim3(nr, nh), NTHREADS, 0, st>>>(
      rowconv<float>(Ch, Ch, {{dqh, wqh, Ch}}), g, gr, h, z, r, drhat,
      sc.dhp, Ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gru_dhx_kernel<float><<<dim3(nr, nh + cdiv(Cx, BN)), NTHREADS, 0, st>>>(
      rowconv<float>(Ch, Ch, {{dzh, wzh, Ch}, {drhat, wrh, Ch}}),
      rowconv<float>(Cx, Ch,
                     {{dzh, wzx, Ch}, {drhat, wrx, Ch}, {dqh, wqx, Ch}}),
      g, nh, sc.dhp, (float*)dh, dx, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int chunk = cdiv(cdiv(g.rows, nsplit), BK) * BK;
  const int Cin = Ch + Cx;
  gru_wgrad_kernel<<<dim3(cdiv(Cin, BM) * nh, 3 * TAPS, nsplit), NTHREADS,
                      0, st>>>(h, rh, x, dzh, drhat, dqh, g, Ch, Cx, chunk,
                               sc.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t per_split = (size_t)15 * Cin * Ch + 3 * Ch;
  sum_splits_kernel<<<elem_blocks(per_split), NTHREADS, 0, st>>>(
      sc.part, nsplit, per_split, Ch, Cx, dw);
  return (int)cudaGetLastError();
}

int bwd_bf16(const bf16* h, const bf16* x, const bf16* z, const bf16* r,
             const bf16* q, const bf16* gr, const bf16* const* w, void* dh,
             void* dx, int dx_f32, BwdScratch sc, int nsplit, float* dw,
             const Geo& g, int Ch, int Cx, cudaStream_t st) {
  using TT = Tiles<GB_TSTAGES>;
  using WT = Tiles<GB_WSTAGES>;
  bf16 *dqh = (bf16*)sc.dqh, *dzh = (bf16*)sc.dzh, *rh = (bf16*)sc.rh;
  bf16* drhat = (bf16*)sc.drhat;
  const uintptr_t align = (uintptr_t)h | (uintptr_t)x | (uintptr_t)z |
                          (uintptr_t)r | (uintptr_t)gr | (uintptr_t)dh |
                          (uintptr_t)dx | (uintptr_t)dqh | (uintptr_t)dzh |
                          (uintptr_t)rh | (uintptr_t)drhat |
                          (uintptr_t)sc.dhp | (uintptr_t)sc.part |
                          (uintptr_t)w[0] | (uintptr_t)w[1] |
                          (uintptr_t)w[2] | (uintptr_t)w[3] |
                          (uintptr_t)w[4] | (uintptr_t)w[5];
  if (Ch % 8 || Cx % 8 || (align & 15)) return (int)cudaErrorInvalidValue;
  auto drh_k = gru_tconv_wgmma_kernel<true, GB_TSTAGES>;
  auto dhx_k = gru_tconv_wgmma_kernel<false, GB_TSTAGES>;
  auto wgrad_k = gru_wgrad_wgmma_kernel<GB_WSTAGES>;
  cudaError_t err;
  if ((err = allow_smem(drh_k, TT::SMEM)) != cudaSuccess ||
      (err = allow_smem(dhx_k, TT::SMEM)) != cudaSuccess ||
      (err = allow_smem(wgrad_k, WT::SMEM)) != cudaSuccess)
    return (int)err;
  const size_t n = (size_t)g.rows * Ch;
  gru_bwd_elem_kernel<bf16><<<elem_blocks(n), NTHREADS, 0, st>>>(
      gr, h, z, r, q, dqh, dzh, rh, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const TEpi ep{gr, h, z, r, drhat, sc.dhp, (bf16*)dh, dx, dx_f32};
  const int nr = cdiv(g.rows, TT::ROWS), nh = cdiv(Ch, GB_COLS);
  const TConv none{};
  drh_k<<<dim3(nr, nh), TT::THREADS, TT::SMEM, st>>>(
      TConv{dqh, nullptr, nullptr, w[4], nullptr, nullptr, 1, Ch}, none, g,
      Ch, nh, ep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dhx_k<<<dim3(nr, nh + cdiv(Cx, GB_COLS)), TT::THREADS, TT::SMEM, st>>>(
      TConv{dzh, drhat, nullptr, w[0], w[2], nullptr, 2, Ch},
      TConv{dzh, drhat, dqh, w[1], w[3], w[5], 3, Cx}, g, Ch, nh, ep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int chunk = cdiv(cdiv(g.rows, nsplit), GB_DEPTH) * GB_DEPTH;
  const int Cin = Ch + Cx;
  wgrad_k<<<dim3(cdiv(Cin, WT::ROWS) * nh, 3 * TAPS, nsplit), WT::THREADS,
            WT::SMEM, st>>>(h, rh, x, dzh, drhat, dqh, g, Ch, Cx, chunk,
                            sc.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t per_split = (size_t)15 * Cin * Ch + 3 * Ch;
  sum_splits_kernel<<<elem_blocks(per_split), NTHREADS, 0, st>>>(
      sc.part, nsplit, per_split, Ch, Cx, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B*HW, Ch], x [B*HW, Cx] and the weights w = (wzh, wzx, wrh, wrx, wqh,
// wqx: [5, Ch or Cx, Ch]) contiguous, all bf16 (in_bf16) or all fp32; the
// biases bz, br, bq [Ch] fp32.  Writes hout, z, r, q [B*HW, Ch] in that
// type.  scratch: fwd_scratch_bytes(B*HW, Ch, Cx, in_bf16) bytes (refused
// otherwise).  bf16: Ch, Cx multiples of 8, the inputs and scratch 16-byte
// aligned.
extern "C" int gru_fwd_launch(const void* h, const void* x, const void* wzh,
                              const void* wzx, const void* wrh,
                              const void* wrx, const void* wqh,
                              const void* wqx, const void* bz, const void* br,
                              const void* bq, void* hout, void* z, void* r,
                              void* q, void* scratch, long long scratch_bytes,
                              int B, int HW, int Ch, int Cx, int s, int width,
                              int in_bf16, void* stream) {
  const Geo g{B * HW, HW, s, width};
  if (scratch_bytes != fwd_scratch_bytes(g.rows, Ch, Cx, in_bf16))
    return (int)cudaErrorInvalidValue;
  const Bias3 bias{(const float*)bz, (const float*)br, (const float*)bq};
  const Carve sc{(unsigned char*)scratch};
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    const bf16* w[6] = {(const bf16*)wzh, (const bf16*)wzx, (const bf16*)wrh,
                        (const bf16*)wrx, (const bf16*)wqh, (const bf16*)wqx};
    return fwd_bf16((const bf16*)h, (const bf16*)x, w, bias, (bf16*)hout,
                    (bf16*)z, (bf16*)r, (bf16*)q, sc, g, Ch, Cx, st);
  }
  const float* w[6] = {(const float*)wzh, (const float*)wzx,
                       (const float*)wrh, (const float*)wrx,
                       (const float*)wqh, (const float*)wqx};
  return fwd_fp32((const float*)h, (const float*)x, w, bias, (float*)hout,
                  (float*)z, (float*)r, (float*)q, sc, g, Ch, Cx, st);
}

// The saved h, x, z, r, q and the cotangent g of h' (all in the io type,
// contiguous, as gru_fwd_launch's), the weights as there.  Writes dh
// [B*HW, Ch] (io) and dx [B*HW, Cx] (fp32 when dx_f32, else io; fp32 io
// takes fp32), and dw: the fp32 weight gradients, per gate the h part [5]
// [Ch][Ch] then the x part [5][Cx][Ch], followed by the bias gradients
// [3][Ch].  scratch: bwd_scratch_bytes(B*HW, Ch, Cx, nsplit, in_bf16)
// bytes, nsplit = wgrad_splits(B*HW, in_bf16) (both refused otherwise).
// bf16: Ch, Cx multiples of 8, every tensor 16-byte aligned.
extern "C" int gru_bwd_launch(const void* h, const void* x, const void* z,
                              const void* r, const void* q, const void* g,
                              const void* wzh, const void* wzx,
                              const void* wrh, const void* wrx,
                              const void* wqh, const void* wqx, void* dh,
                              void* dx, int dx_f32, void* scratch,
                              long long scratch_bytes, int nsplit, void* dw,
                              int B, int HW, int Ch, int Cx, int s, int width,
                              int in_bf16, void* stream) {
  const Geo geo{B * HW, HW, s, width};
  if (nsplit != wgrad_splits(geo.rows, in_bf16))
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes != bwd_scratch_bytes(geo.rows, Ch, Cx, nsplit, in_bf16))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)geo.rows * Ch, io = in_bf16 ? 2 : 4;
  Carve cv{(unsigned char*)scratch};
  BwdScratch sc;
  sc.dqh = cv.take<unsigned char>(io * n);
  sc.dzh = cv.take<unsigned char>(io * n);
  sc.rh = cv.take<unsigned char>(io * n);
  sc.drhat = cv.take<unsigned char>(io * n);
  sc.dhp = cv.take<float>(4 * n);
  sc.part = (float*)cv.p;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    const bf16* w[6] = {(const bf16*)wzh, (const bf16*)wzx, (const bf16*)wrh,
                        (const bf16*)wrx, (const bf16*)wqh, (const bf16*)wqx};
    return bwd_bf16((const bf16*)h, (const bf16*)x, (const bf16*)z,
                    (const bf16*)r, (const bf16*)q, (const bf16*)g, w, dh, dx,
                    dx_f32, sc, nsplit, (float*)dw, geo, Ch, Cx, st);
  }
  const float* w[6] = {(const float*)wzh, (const float*)wzx,
                       (const float*)wrh, (const float*)wrx,
                       (const float*)wqh, (const float*)wqx};
  return bwd_fp32((const float*)h, (const float*)x, (const float*)z,
                  (const float*)r, (const float*)q, (const float*)g, w, dh,
                  dx, sc, nsplit, (float*)dw, geo, Ch, Cx, st);
}
