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
// backward, over a few MB of rows, while the 15 taps of weights (1.97 MB in
// bf16) are far above a block's shared memory.  The design is a plain tiled
// product: every kernel below is a sweep of 64-row x 128-column output
// tiles, with the depth (tap, then 32 channels at a time) staged through
// shared memory, the weights streamed by tap and channel tile, and the gate
// arithmetic in the epilogue.  bf16 tiles are staged with 16-byte loads and
// multiplied on the tensor cores (WMMA, fp32 sums); fp32 tiles in fp32 FMA.
// No stage is double-buffered.  A tap's shifted rows are re-read from L2
// rather than held as a halo.  The forward takes two launches (z|r,
// then q with the blend), since q needs r h at the neighbouring rows.  The
// backward takes five: the elementwise cotangents dqh, dzh (and r h), the
// conv-transpose drh with drhat in its epilogue, dh and dx, the weight and
// bias gradients as fixed row splits per (gate, tap, channel tile), and a
// fixed-order sum of the splits: no float atomics, so two backwards of one
// input are bit-identical.  The TPU kernel accumulated the weight gradients
// across sequential grid steps; blocks here run in parallel.
//
// Casts, as the TPU kernel's: x and the weights in the io type (h's), the
// bias fp32, every product summed in fp32; r h rounded to io from the fp32
// r in the forward and from the saved, rounded r in the backward; z, r, q
// saved in io; dqh, dzh and drhat rounded to io before every product and
// bias sum that reads them.
#include <mma.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TAPS = 5, RAD = 2;
constexpr int BM = 64;   // output rows of a tile (weight gradients: channels)
constexpr int BN = 128;  // output columns of a tile
constexpr int BK = 32;   // depth staged per step: channels, or rows
constexpr int APAD = BM + 1, BPAD = BN + 1;
constexpr int MAX_OPS = 3;
// bf16 tiles on the tensor cores (WMMA 16x16x16, fp32 sums): eight warps
// of 32 x 32 outputs each over the 64 x 128 tile.  Leading dimensions are
// padded by 16 bytes (a multiple of 8 bf16, as WMMA needs); the fp32
// result tile Cs reuses the staging memory after the sweep.
using bf16 = __nv_bfloat16;
constexpr int WM = 16;
constexpr int LDA_TC = BK + 8;  // As [BM][LDA_TC]: rows x depth
constexpr int LDB_TC = BN + 8;  // Bs [BK][LDB_TC]: depth x columns
constexpr int LDBT_TC = BK + 8; // Bs [BN][LDBT_TC]: columns x depth (TRANS)
constexpr int LDC_TC = BN + 4;  // Cs [BM][LDC_TC] fp32
constexpr int TC_SMEM = BM * LDC_TC * 4;
static_assert(BM * LDA_TC * 2 + BN * LDBT_TC * 2 <= TC_SMEM, "tc staging");
static_assert(BK * (BM + 8) * 2 + BK * LDB_TC * 2 <= TC_SMEM, "tc wgrad");

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
__device__ void rowconv_tile_fma(const RowConv<T>& rc, const Geo& g,
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

// Eight bf16 (16 bytes) at p, which the caller keeps 16-byte aligned: the
// bf16 kernels take channel counts that are multiples of 8.
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 zero8() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Cs's fp32 tile into the FMA layout: thread (tx, ty) takes rows ty + 16 i,
// columns tx + 16 j, so that every epilogue reads one layout.
__device__ __forceinline__ void tile_to_acc(const float* Cs,
                                            float acc[4][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = Cs[(ty + 16 * i) * LDC_TC + tx + 16 * j];
}

using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, WM, WM, WM,
                                     float>;

// The warp's 32 x 32 outputs (2 x 2 fragments at rows wm * 32, columns
// wn * 32) into Cs, after every warp has left the staging memory.
__device__ __forceinline__ void store_frags(FragC c[2][2], float* Cs) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * 32 + WM * i) * LDC_TC + wn * 32 + WM * j, c[i][j],
          LDC_TC, wmma::mem_row_major);
  __syncthreads();
}

// rowconv_tile_fma's tile for bf16 operands on the tensor cores: the same
// staging order (tap, then 32 channels), bf16 kept as it is in shared
// memory, the products summed in fp32 by WMMA.
template <bool TRANS>
__device__ void rowconv_tile_tc(const RowConv<bf16>& rc, const Geo& g,
                                int row0, int col0, float acc[4][8]) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[TC_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + BM * LDA_TC * 2);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  // A staging: one row and 8 channels (16 bytes) a thread.
  const int r_v = tid >> 2, k_v = (tid & 3) * 8;
  FragC c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  for (int o = 0; o < rc.nop; ++o) {
    const Operand<bf16> op = rc.op[o];
    for (int t = 0; t < TAPS; ++t) {
      const int d = TRANS ? RAD - t : t - RAD;
      const int src = tap_src(g, row0 + r_v, d);
      const bf16* wt =
          op.w + (size_t)t * (TRANS ? rc.ncol : op.ka) * rc.ldw;
      for (int k0 = 0; k0 < op.ka; k0 += BK) {
        __syncthreads();
        const int k = k0 + k_v;
        *reinterpret_cast<uint4*>(As + r_v * LDA_TC + k_v) =
            src >= 0 && k < op.ka ? load8(op.a + (size_t)src * op.ka + k)
                                  : zero8();
        // B staging: 8 consecutive depths (TRANS) or columns a load.
#pragma unroll
        for (int e = tid; e < BK * BN / 8; e += NTHREADS) {
          int kk, cc;
          if (TRANS) {
            cc = e / (BK / 8);
            kk = e % (BK / 8) * 8;
          } else {
            kk = e / (BN / 8);
            cc = e % (BN / 8) * 8;
          }
          const int kg = k0 + kk, col = col0 + cc;
          const bool in = kg < op.ka && col < rc.ncol;
          if (TRANS)
            *reinterpret_cast<uint4*>(Bs + cc * LDBT_TC + kk) =
                in ? load8(wt + (size_t)col * rc.ldw + kg) : zero8();
          else
            *reinterpret_cast<uint4*>(Bs + kk * LDB_TC + cc) =
                in ? load8(wt + (size_t)kg * rc.ldw + col) : zero8();
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK; ks += WM) {
          wmma::fragment<wmma::matrix_a, WM, WM, WM, bf16, wmma::row_major>
              a[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                a[i], As + (wm * 32 + WM * i) * LDA_TC + ks, LDA_TC);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = wn * 32 + WM * j;
            if (TRANS) {
              wmma::fragment<wmma::matrix_b, WM, WM, WM, bf16,
                             wmma::col_major> b;
              wmma::load_matrix_sync(b, Bs + n * LDBT_TC + ks, LDBT_TC);
#pragma unroll
              for (int i = 0; i < 2; ++i)
                wmma::mma_sync(c[i][j], a[i], b, c[i][j]);
            } else {
              wmma::fragment<wmma::matrix_b, WM, WM, WM, bf16,
                             wmma::row_major> b;
              wmma::load_matrix_sync(b, Bs + ks * LDB_TC + n, LDB_TC);
#pragma unroll
              for (int i = 0; i < 2; ++i)
                wmma::mma_sync(c[i][j], a[i], b, c[i][j]);
            }
          }
        }
      }
    }
  }
  float* Cs = reinterpret_cast<float*>(smem);
  store_frags(c, Cs);
  tile_to_acc(Cs, acc);
}

// The tile of a row convolution: bf16 on the tensor cores, fp32 in FMA.
template <typename T, bool TRANS>
__device__ __forceinline__ void rowconv_tile(const RowConv<T>& rc,
                                             const Geo& g, int row0,
                                             int col0, float acc[4][8]) {
  if constexpr (std::is_same<T, bf16>::value)
    rowconv_tile_tc<TRANS>(rc, g, row0, col0, acc);
  else
    rowconv_tile_fma<T, TRANS>(rc, g, row0, col0, acc);
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// z (gate 0, blockIdx.z) or r (gate 1) over a tile.  z is kept in fp32 for
// the blend (zf), r is saved in io and r h rounded to io from the fp32 r.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_zr_kernel(RowConv<T> rz, RowConv<T> rr, Geo g,
                  const float* __restrict__ bias, const T* __restrict__ h,
                  float* __restrict__ zf, T* __restrict__ r_out,
                  T* __restrict__ rh, int Ch) {
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
      const float v = sigmoidf_(acc[i][j] + bias[gate * Ch + c]);
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
    gru_q_kernel(RowConv<T> rq, Geo g, const float* __restrict__ bias,
                 const T* __restrict__ h, const float* __restrict__ zf,
                 T* __restrict__ hout, T* __restrict__ z_out,
                 T* __restrict__ q_out, int Ch) {
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
      const float q = tanhf(acc[i][j] + bias[2 * Ch + c]);
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

// Weight and bias gradients.  Block (channel tile, column tile) of gate
// blockIdx.y / 5, tap blockIdx.y % 5, row split blockIdx.z sums
//   dW_t[c][n] = sum_p A[src(p, t - 2)][c] D[p][n]
// over its split's rows, A = [h | x] (z, r) or [r h | x] (q), Cin = Ch + Cx
// channels, D = dzh, drhat, dqh: every row of every image once.  The blocks
// of the centre tap and channel tile 0 also sum D's columns (the bias
// gradient).  Partials go to part[split][gate][t][c][n], then the split's
// bias sums at part[split][15 Cin Ch + gate Ch + n].
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    gru_wgrad_kernel(const T* __restrict__ h, const T* __restrict__ rh,
                     const T* __restrict__ x, const T* __restrict__ dzh,
                     const T* __restrict__ drhat, const T* __restrict__ dqh,
                     Geo g, int Ch, int Cx, int chunk,
                     float* __restrict__ part) {
  // bf16 operands stay bf16 in shared memory for the tensor cores; fp32
  // ones go through FMA.  As [BK][LDA] (rows x channels), Ds [BK][LDD].
  constexpr bool TC = std::is_same<T, bf16>::value;
  constexpr int LDA = TC ? BM + 8 : BM, LDD = TC ? BN + 8 : BN;
  constexpr int SMEM = TC ? TC_SMEM : (BK * BM + BK * BN) * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Ds = reinterpret_cast<T*>(smem + BK * LDA * sizeof(T));
  const int Cin = Ch + Cx;
  const int nct = (Cin + BM - 1) / BM;
  const int c0 = (blockIdx.x % nct) * BM, n0 = (blockIdx.x / nct) * BN;
  const int gate = blockIdx.y / TAPS, t = blockIdx.y % TAPS;
  const int split = blockIdx.z;
  const T* ah = gate == 2 ? rh : h;
  const T* d = gate == 0 ? dzh : gate == 1 ? drhat : dqh;
  const int p0 = split * chunk;
  const int p1 = min(g.rows, p0 + chunk);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  const bool bias_block = t == RAD && c0 == 0;
  const T zero = from_f<T>(0.f);
  float acc[4][8], db = 0.f;
  zero_acc(acc);
  FragC frag[2][2];
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(frag[i][j], 0.f);
  }
  const int ca = tid % BM, ka = tid / BM;    // A staging: 8 rows a thread
  const int nd = tid % BN, kd = tid / BN;    // D staging: 16 rows a thread
  const int c = c0 + ca;
  // bf16: one row and 8 channels of A a thread, 8 columns of D a load.
  const int kv = tid >> 3, cv = (tid & 7) * 8;
  for (int k0 = p0; k0 < p1; k0 += BK) {
    __syncthreads();
    if constexpr (TC) {
      const int p = k0 + kv, cc = c0 + cv;
      uint4 v = zero8();
      if (p < p1 && cc < Cin) {
        const int src = tap_src(g, p, t - RAD);
        if (src >= 0)
          v = cc < Ch ? load8(ah + (size_t)src * Ch + cc)
                      : load8(x + (size_t)src * Cx + (cc - Ch));
      }
      *reinterpret_cast<uint4*>(As + kv * LDA + cv) = v;
#pragma unroll
      for (int e = tid; e < BK * BN / 8; e += NTHREADS) {
        const int kk = e / (BN / 8), n8 = e % (BN / 8) * 8;
        const int pp = k0 + kk, n = n0 + n8;
        *reinterpret_cast<uint4*>(Ds + kk * LDD + n8) =
            pp < p1 && n < Ch ? load8(d + (size_t)pp * Ch + n) : zero8();
      }
    } else {
#pragma unroll
      for (int it = 0; it < BK / 4; ++it) {
        const int kk = ka + 4 * it, p = k0 + kk;
        T v = zero;
        if (p < p1 && c < Cin) {
          const int src = tap_src(g, p, t - RAD);
          if (src >= 0)
            v = c < Ch ? ah[(size_t)src * Ch + c]
                       : x[(size_t)src * Cx + (c - Ch)];
        }
        As[kk * LDA + ca] = v;
      }
#pragma unroll
      for (int it = 0; it < BK / 2; ++it) {
        const int kk = kd + 2 * it, p = k0 + kk, n = n0 + nd;
        Ds[kk * LDD + nd] = p < p1 && n < Ch ? d[(size_t)p * Ch + n] : zero;
      }
    }
    __syncthreads();
    if constexpr (TC) {
      using namespace nvcuda;
#pragma unroll
      for (int ks = 0; ks < BK; ks += WM) {
        // dW's rows are channels: A^T, read from As as column-major.
        wmma::fragment<wmma::matrix_a, WM, WM, WM, bf16, wmma::col_major>
            a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + ks * LDA + wm * 32 + WM * i,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, WM, WM, WM, bf16, wmma::row_major>
              b;
          wmma::load_matrix_sync(b, Ds + ks * LDD + wn * 32 + WM * j, LDD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(frag[i][j], a[i], b, frag[i][j]);
        }
      }
    } else {
      mac_tile(acc, reinterpret_cast<const float*>(As), LDA,
               reinterpret_cast<const float*>(Ds), LDD);
    }
    if (bias_block && tid < BN) {
      for (int kk = 0; kk < BK; ++kk) db += to_f(Ds[kk * LDD + tid]);
    }
  }
  if constexpr (TC) {
    float* Cs = reinterpret_cast<float*>(smem);
    store_frags(frag, Cs);
    tile_to_acc(Cs, acc);
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

// out[i] = sum over the splits of part[split][i], split 0 first.
__global__ void __launch_bounds__(NTHREADS)
    sum_splits_kernel(const float* __restrict__ part, int nsplit, size_t n,
                      float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)NTHREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NTHREADS) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + i];
    out[i] = s;
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

template <typename T>
int fwd(const void* h_, const void* x_, const void* const* w,
        const float* bias, void* hout, void* z, void* r, void* q, float* zf,
        void* rh, int B, int HW, int Ch, int Cx, int s, int width,
        cudaStream_t st) {
  const T *h = (const T*)h_, *x = (const T*)x_;
  const T *wzh = (const T*)w[0], *wzx = (const T*)w[1];
  const T *wrh = (const T*)w[2], *wrx = (const T*)w[3];
  const T *wqh = (const T*)w[4], *wqx = (const T*)w[5];
  const Geo g{B * HW, HW, s, width};
  const dim3 grid(cdiv(g.rows, BM), cdiv(Ch, BN), 2);
  gru_zr_kernel<T><<<grid, NTHREADS, 0, st>>>(
      rowconv<T>(Ch, Ch, {{h, wzh, Ch}, {x, wzx, Cx}}),
      rowconv<T>(Ch, Ch, {{h, wrh, Ch}, {x, wrx, Cx}}), g, bias, h, zf,
      (T*)r, (T*)rh, Ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_q_kernel<T><<<dim3(grid.x, grid.y), NTHREADS, 0, st>>>(
      rowconv<T>(Ch, Ch, {{(const T*)rh, wqh, Ch}, {x, wqx, Cx}}), g, bias,
      h, zf, (T*)hout, (T*)z, (T*)q, Ch);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* h_, const void* x_, const void* z_, const void* r_,
        const void* q_, const void* g_, const void* const* w, void* dh,
        void* dx, int dx_f32, void* dqh_, void* dzh_, void* rh_,
        void* drhat_, float* dhp, float* part, int nsplit, float* dw, int B,
        int HW, int Ch, int Cx, int s, int width, cudaStream_t st) {
  const T *h = (const T*)h_, *x = (const T*)x_, *z = (const T*)z_;
  const T *r = (const T*)r_, *q = (const T*)q_, *gr = (const T*)g_;
  const T *wzh = (const T*)w[0], *wzx = (const T*)w[1];
  const T *wrh = (const T*)w[2], *wrx = (const T*)w[3];
  const T *wqh = (const T*)w[4], *wqx = (const T*)w[5];
  T *dqh = (T*)dqh_, *dzh = (T*)dzh_, *rh = (T*)rh_, *drhat = (T*)drhat_;
  const Geo g{B * HW, HW, s, width};
  const size_t n = (size_t)g.rows * Ch;
  gru_bwd_elem_kernel<T><<<elem_blocks(n), NTHREADS, 0, st>>>(
      gr, h, z, r, q, dqh, dzh, rh, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nr = cdiv(g.rows, BM), nh = cdiv(Ch, BN);
  gru_drh_kernel<T><<<dim3(nr, nh), NTHREADS, 0, st>>>(
      rowconv<T>(Ch, Ch, {{dqh, wqh, Ch}}), g, gr, h, z, r, drhat, dhp, Ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gru_dhx_kernel<T><<<dim3(nr, nh + cdiv(Cx, BN)), NTHREADS, 0, st>>>(
      rowconv<T>(Ch, Ch, {{dzh, wzh, Ch}, {drhat, wrh, Ch}}),
      rowconv<T>(Cx, Ch, {{dzh, wzx, Ch}, {drhat, wrx, Ch}, {dqh, wqx, Ch}}),
      g, nh, dhp, (T*)dh, dx, dx_f32);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int chunk = cdiv(cdiv(g.rows, nsplit), BK) * BK;
  const int Cin = Ch + Cx;
  gru_wgrad_kernel<T>
      <<<dim3(cdiv(Cin, BM) * nh, 3 * TAPS, nsplit), NTHREADS, 0, st>>>(
          h, rh, x, dzh, drhat, dqh, g, Ch, Cx, chunk, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t per_split = (size_t)15 * Cin * Ch + 3 * Ch;
  sum_splits_kernel<<<elem_blocks(per_split), NTHREADS, 0, st>>>(
      part, nsplit, per_split, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B*HW, Ch], x [B*HW, Cx] and the weights w = (wzh, wzx, wrh, wrx, wqh,
// wqx: [5, Ch or Cx, Ch]) contiguous, all bf16 (in_bf16) or all fp32; bias
// [3, Ch] fp32.  Writes hout, z, r, q [B*HW, Ch] in that type; zf [B*HW, Ch]
// fp32 and rh [B*HW, Ch] are scratch.
extern "C" int gru_fwd_launch(const void* h, const void* x, const void* wzh,
                              const void* wzx, const void* wrh,
                              const void* wrx, const void* wqh,
                              const void* wqx, const void* bias, void* hout,
                              void* z, void* r, void* q, void* zf, void* rh,
                              int B, int HW, int Ch, int Cx, int s, int width,
                              int in_bf16, void* stream) {
  const void* w[6] = {wzh, wzx, wrh, wrx, wqh, wqx};
  cudaStream_t st = (cudaStream_t)stream;
  return in_bf16
             ? fwd<__nv_bfloat16>(h, x, w, (const float*)bias, hout, z, r, q,
                                  (float*)zf, rh, B, HW, Ch, Cx, s, width, st)
             : fwd<float>(h, x, w, (const float*)bias, hout, z, r, q,
                          (float*)zf, rh, B, HW, Ch, Cx, s, width, st);
}

// The saved h, x, z, r, q and the cotangent g of h' (all in the io type,
// contiguous, as gru_fwd_launch's), the weights as there.  Writes dh
// [B*HW, Ch] (io) and dx [B*HW, Cx] (fp32 when dx_f32, else io), and dw:
// the fp32 weight gradients [3 gates][5][Ch + Cx][Ch] (rows of the h part,
// then of the x part) followed by the bias gradients [3][Ch].  dqh, dzh,
// rh, drhat [B*HW, Ch] (io), dhp [B*HW, Ch] fp32 and part [nsplit][len(dw)]
// fp32 are scratch.
extern "C" int gru_bwd_launch(const void* h, const void* x, const void* z,
                              const void* r, const void* q, const void* g,
                              const void* wzh, const void* wzx,
                              const void* wrh, const void* wrx,
                              const void* wqh, const void* wqx, void* dh,
                              void* dx, int dx_f32, void* dqh, void* dzh,
                              void* rh, void* drhat, void* dhp, void* part,
                              int nsplit, void* dw, int B, int HW, int Ch,
                              int Cx, int s, int width, int in_bf16,
                              void* stream) {
  const void* w[6] = {wzh, wzx, wrh, wrx, wqh, wqx};
  cudaStream_t st = (cudaStream_t)stream;
  return in_bf16
             ? bwd<__nv_bfloat16>(h, x, z, r, q, g, w, dh, dx, dx_f32, dqh,
                                  dzh, rh, drhat, (float*)dhp, (float*)part,
                                  nsplit, (float*)dw, B, HW, Ch, Cx, s, width,
                                  st)
             : bwd<float>(h, x, z, r, q, g, w, dh, dx, dx_f32, dqh, dzh, rh,
                          drhat, (float*)dhp, (float*)part, nsplit,
                          (float*)dw, B, HW, Ch, Cx, s, width, st);
}
