// The inter-site mode aggregation, shared by the volume kernels B3
// (corr_norm.cu) and B6 (agg_corr.cu):
//   s_m = clamp(scale * q_m k_m^T, +-clip) + pos_w * bias
//   vol = sum_m softmax_m(agg_w * s_m + agg_b) * s_m
// A block holds all four modes' q tiles (one 64-row slice) in shared memory
// and sweeps k tiles past them; the four per-mode scores of each element
// stay in registers.
#pragma once

#include "common.cuh"

#define NMODES 4
#define KGROUP 8  // k tiles per block
// Dynamic shared memory of a block: the q tiles of all modes, one k tile,
// and the bias window.
#define AGG_SMEM (((NMODES + 1) * MAXMD * SPAD + MAXWIN) * sizeof(float))

// s[m] = q_m k_m^T (unscaled) over k tile kt, for every mode.  qs holds the
// q tiles at qs + m * MAXMD * SPAD; ks is the k staging buffer.
template <typename T>
__device__ __forceinline__ void mode_score_tiles(float s[NMODES][4][4],
                                                 const T* __restrict__ kb,
                                                 const float* qs, float* ks,
                                                 int kt, int U, int md) {
#pragma unroll
  for (int m = 0; m < NMODES; ++m) {
    __syncthreads();
    load_tile_t(ks, kb + (size_t)m * U * md, kt * TILE, U, md);
    __syncthreads();
    score_tile(s[m], qs + m * MAXMD * SPAD, ks, md);
  }
}

// vol of one (q tile, k tile kt), as a 4x4 micro-tile per thread.
template <typename T>
__device__ __forceinline__ void agg_tile(
    float vol[4][4], const T* __restrict__ kb, const float* qs, float* ks,
    const float* win, int kt, int U, int md, int W8, int R, float scale,
    float clip, float pos_w, float agg_w, float agg_b, const int qh[4],
    const int qw[4]) {
  const int tx = threadIdx.x & 15;
  float s[NMODES][4][4];
  mode_score_tiles(s, kb, qs, ks, kt, U, md);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = kt * TILE + tx + 16 * j;
    const int kh = u / W8, kw = u - (u / W8) * W8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bias = pos_w * window_bias(win, qh[i], qw[i], kh, kw, R);
      float x[NMODES], lg[NMODES];
#pragma unroll
      for (int m = 0; m < NMODES; ++m) {
        x[m] = fminf(fmaxf(s[m][i][j] * scale, -clip), clip) + bias;
        lg[m] = agg_w * x[m] + agg_b;
      }
      float mmax = lg[0];
#pragma unroll
      for (int m = 1; m < NMODES; ++m) mmax = fmaxf(mmax, lg[m]);
      float denom = 0.f, acc = 0.f;
#pragma unroll
      for (int m = 0; m < NMODES; ++m) {
        const float e = expf(lg[m] - mmax);
        denom += e;
        acc += e * x[m];
      }
      vol[i][j] = acc / denom;
    }
  }
}

// This block's q tiles (all modes), the bias window, and its rows' token
// coordinates (qh, qw).  The caller's first __syncthreads (in
// mode_score_tiles) publishes them.
template <typename T>
__device__ __forceinline__ void load_q_modes(const T* __restrict__ qb,
                                             const float* __restrict__ biases,
                                             float* qs, float* win, int qt,
                                             int U, int md, int W8, int R,
                                             int qh[4], int qw[4]) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int m = 0; m < NMODES; ++m)
    load_tile_t(qs + m * MAXMD * SPAD, qb + (size_t)m * U * md, qt * TILE, U,
                md);
  load_window(win, biases, R);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = qt * TILE + ty + 16 * i;
    qh[i] = u / W8;
    qw[i] = u - qh[i] * W8;
  }
}

// One block: out[0] = the sum of partial[0..n) in a fixed order (each
// thread a strided share, then a tree over the block), so the result does
// not depend on how the producing blocks were scheduled.
__global__ void __launch_bounds__(NTHREADS)
    sum_partials_kernel(const double* __restrict__ partial, int n,
                        float* __restrict__ out) {
  __shared__ double red[NTHREADS];
  double acc = 0.0;
  for (int e = threadIdx.x; e < n; e += NTHREADS) acc += partial[e];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = NTHREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)red[0];
}

// Sum of a double over the block in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < NTHREADS / 32; ++w) v += red[w];
  return v;
}
