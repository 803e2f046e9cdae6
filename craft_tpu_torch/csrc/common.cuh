// Shared tile machinery for the SETrans attention kernels (sm_90a).
//
// Every kernel here is a q.k^T tile sweep with an epilogue: a block owns a
// TILE x TILE tile of scores, held as a 4x4 micro-tile per thread (rows
// ty + 16*i, columns tx + 16*j with tx = tid % 16, ty = tid / 16).  q and k
// tiles are staged in shared memory as fp32, transposed to [d][row] so the
// inner product reads one broadcast word (q) and 16 consecutive words (k)
// per warp.  Inputs are bf16 or fp32; products and sums run in fp32 FMA.
//
// The positional bias of a score element comes from one of three sources
// (the bias-source structs below), and each kernel that adds a bias is a
// template over them.  The sliding window is read straight from the
// (2R+1)^2 window in shared memory: bias(u1, u2) = w[kh - qh + R][kw - qw
// + R] inside the window, 0 outside, with u = h * W8 + w (row-major tokens).
// A query row shard (sequence parallelism) counts its query tokens from the
// global token q_tok0, so the window lands on the right diagonals; the
// offset enters the row coordinates once per block, not the inner loops.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64
#define SPAD (TILE + 1)
#define MAXMD 64       // the wgmma bodies' widest mode dim
#define MAXMD_FMA 256  // the FMA bodies' (md 128 and 256: one or two modes)
#define NTHREADS 256
#define MAXWIN 225  // (2R+1)^2 for R <= 7
#define NEG_INF (-1e30f)

// The body a per-mode kernel runs (B1, B2, B4, B7, B8, B4 dense): wgmma for
// bf16 inputs up to md MAXMD, FMA for fp32 and for bf16 past it.  The
// wrappers mirror it (ops/kernels/mode_attention.py mma_body) to size the
// scratch, whose size every launcher checks.
__host__ __device__ constexpr bool mma_body(int md, int in_bf16) {
  return in_bf16 && md <= MAXMD;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + TILE) of a row-major [U, md] matrix into dst[d][r]
// (row stride SPAD) as fp32; rows past U read as zero.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
                                            int row0, int U, int md) {
  for (int e = threadIdx.x; e < TILE * md; e += NTHREADS) {
    int r = e / md, d = e - r * md;
    int row = row0 + r;
    dst[d * SPAD + r] = row < U ? to_f(src[(size_t)row * md + d]) : 0.f;
  }
}

// acc[i][j] = sum_d q[ty + 16i][d] * k[tx + 16j][d] over the staged tiles.
__device__ __forceinline__ void score_tile(float acc[4][4], const float* qs,
                                           const float* ks, int md) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < md; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[d * SPAD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[d * SPAD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void load_window(float* win, const float* biases,
                                            int R) {
  const int n = (2 * R + 1) * (2 * R + 1);
  for (int e = threadIdx.x; e < n; e += NTHREADS) win[e] = biases[e];
}

// Sliding-window bias between query token (qh, qw) and key token (kh, kw).
__device__ __forceinline__ float window_bias(const float* win, int qh, int qw,
                                             int kh, int kw, int R) {
  int dh = kh - qh, dw = kw - qw;
  if (dh < -R || dh > R || dw < -R || dw > R) return 0.f;
  return win[(dh + R) * (2 * R + 1) + dw + R];
}

// ---------------------------------------------------------------------------
// Bias sources.  A kernel that adds pos_w * bias to its clamped scores is a
// template over one of these; they differ only in where the bias comes from:
//   NoBias      none (pos_code_type 'lsinu' carries the positions in the
//               tokens);
//   WindowBias  the (2R+1)^2 sliding window in shared memory (B2-B4, B6);
//   TableBias   a dense fp32 [U1, U2] table (B8, B6 and B4 dense: the f2
//               site's additive mask under --f2radius), staged one TILE x
//               TILE tile at a time in shared memory with loads coalesced
//               along the keys.
// Per block: init(smem, args, qt) once (the caller's first __syncthreads
// publishes what it loads).  Per k tile kt: load(kt) between the
// __syncthreads pair that guards the k tile's staging, so a table tile is
// visible after the second and is not overwritten before every thread has
// read it; cols(kt) after the tile's q.k^T products (the window's column
// coordinates, kept out of the registers of the product loop); then
// at(i, j) is the bias of the thread's micro-tile element (row ty + 16 i,
// column tx + 16 j).  SMEM is the floats of shared memory the source takes
// at `smem`.
// ---------------------------------------------------------------------------
struct BiasArgs {
  const float* data;  // the window [(2R+1)^2], the table [U1, U2], or null
  int W8, R;          // window: token grid width and radius
  int U1, U2;         // table: rows (queries) and columns (keys)
  int q_tok0;         // window: global token of query row 0 (a row shard
                      // of the grid under sequence parallelism; else 0)
};

struct NoBias {
  static constexpr int SMEM = 0;
  __device__ __forceinline__ void init(float*, const BiasArgs&, int) {}
  __device__ __forceinline__ void load(int) {}
  __device__ __forceinline__ void cols(int) {}
  __device__ __forceinline__ float at(int, int) const { return 0.f; }
};

struct WindowBias {
  static constexpr int SMEM = MAXWIN;
  const float* win;
  int W8, R;
  int qh[4], qw[4], kh[4], kw[4];  // token coordinates of rows and columns
  __device__ __forceinline__ void init(float* sm, const BiasArgs& a, int qt) {
    win = sm;
    W8 = a.W8;
    R = a.R;
    load_window(sm, a.data, R);
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = a.q_tok0 + qt * TILE + ty + 16 * i;
      qh[i] = u / W8;
      qw[i] = u - qh[i] * W8;
    }
  }
  __device__ __forceinline__ void load(int) {}
  __device__ __forceinline__ void cols(int kt) {
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = kt * TILE + tx + 16 * j;
      kh[j] = u / W8;
      kw[j] = u - kh[j] * W8;
    }
  }
  __device__ __forceinline__ float at(int i, int j) const {
    return window_bias(win, qh[i], qw[i], kh[j], kw[j], R);
  }
};

struct TableBias {
  static constexpr int SMEM = TILE * SPAD;
  float* tile;  // [TILE][SPAD]: rows of this q tile, columns of k tile kt
  const float* table;
  int U1, U2, row0;
  __device__ __forceinline__ void init(float* sm, const BiasArgs& a, int qt) {
    tile = sm;
    table = a.data;
    U1 = a.U1;
    U2 = a.U2;
    row0 = qt * TILE;
  }
  // Neighbouring threads read neighbouring columns of one table row;
  // elements past U1 or U2 stage as 0 (ragged keys are masked by the caller).
  // The 16 loads of a thread are unrolled so that they are in flight
  // together.
  __device__ __forceinline__ void load(int kt) {
    const int col0 = kt * TILE;
#pragma unroll
    for (int it = 0; it < TILE * TILE / NTHREADS; ++it) {
      const int e = threadIdx.x + it * NTHREADS;
      const int r = e / TILE, c = e - r * TILE;
      const int row = row0 + r, col = col0 + c;
      tile[r * SPAD + c] =
          row < U1 && col < U2 ? table[(size_t)row * U2 + col] : 0.f;
    }
  }
  __device__ __forceinline__ void cols(int) {}
  __device__ __forceinline__ float at(int i, int j) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    return tile[(ty + 16 * i) * SPAD + tx + 16 * j];
  }
};

// Max / sum over the 16 lanes that share a micro-tile row (same ty).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Host side: opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
