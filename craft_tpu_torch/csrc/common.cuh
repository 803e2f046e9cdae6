// Shared tile machinery for the SETrans attention kernels (sm_90a).
//
// Every kernel here is a q.k^T tile sweep with an epilogue: a block owns a
// TILE x TILE tile of scores, held as a 4x4 micro-tile per thread (rows
// ty + 16*i, columns tx + 16*j with tx = tid % 16, ty = tid / 16).  q and k
// tiles are staged in shared memory as fp32, transposed to [d][row] so the
// inner product reads one broadcast word (q) and 16 consecutive words (k)
// per warp.  Inputs are bf16 or fp32; products and sums run in fp32 FMA.
//
// The sliding positional bias is read straight from the (2R+1)^2 window in
// shared memory: bias(u1, u2) = w[kh - qh + R][kw - qw + R] inside the
// window, 0 outside, with u = h * W8 + w (row-major tokens).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64
#define SPAD (TILE + 1)
#define MAXMD 64
#define NTHREADS 256
#define MAXWIN 225  // (2R+1)^2 for R <= 7
#define NEG_INF (-1e30f)

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
