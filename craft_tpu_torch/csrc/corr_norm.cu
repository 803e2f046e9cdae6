// B3: the inter-frame correlation volume, conditionally clamped,
// mode-aggregated and globally layer-normed, written once:
//   s_m  = clamp(scale * q_m k_m^T, +-clip) + pos_w * bias
//   vol  = sum_m softmax_m(agg_w * s_m + agg_b) * s_m
//   out  = (vol - mean_b) * rsqrt(var_b + eps)
// with clip = attn_clip if the batch-global raw max exceeds attn_clip, else
// 1e30, and per-sample mean / variance over the whole U x U volume.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:fused_agg_corr_norm_mt
// (bodies _corr_stats_kernel, _agg_modes, _corr_norm_write_kernel).
//
// Bound on the H100: operations.  At the inter site (B=1, M=4, U=7040,
// md=64) each q.k^T sweep is 25.4 GFLOP and the only volume-sized traffic
// is the 99 MB bf16 write (30 us of memory time).  The raw max is the B1
// kernel run on the same q, k (the caller passes its result); then
//   1. a stats sweep recomputes the aggregated volume tile by tile and
//      writes per-block fp64 partial sums of vol and vol^2 (49.6 M
//      elements per sample: fp32 running sums would lose digits);
//   2. a one-block-per-sample pass sums the partials in a fixed order, so
//      the result is deterministic (no float atomics);
//   3. a write sweep recomputes the volume and writes it normalized.
// A block holds all four modes' q tiles (one 64-row slice) in shared
// memory and sweeps a group of k tiles (agg_modes.cuh, shared with B6).
// Any W8 works: the bias window is indexed directly and ragged U is masked
// in-kernel.
#include "agg_modes.cuh"

// Shared prologue: this block's q tiles, window and token coordinates
// (load_q_modes), and the clip value from the raw max.
template <typename T>
__device__ __forceinline__ float prologue(const T* __restrict__ qb,
                                          const float* __restrict__ biases,
                                          const float* __restrict__ scal,
                                          const float* __restrict__ gmax,
                                          float* qs, float* win,
                                          WindowBias& wb, int qt, int U,
                                          int md, int W8, int R) {
  load_q_modes(qb, qs, win, wb, BiasArgs{biases, W8, R, U, U}, qt, U, md);
  const float attn_clip = scal[0];
  return gmax[0] > attn_clip ? attn_clip : 1e30f;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    corr_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ biases,
                      const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      double* __restrict__ partial, int U, int md, int W8,
                      int R, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  __shared__ double red[2][NTHREADS / 32];
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t off = (size_t)b * NMODES * U * md;
  WindowBias wb;
  const float clip = prologue(q + off, biases, scal, gmax, qs, win, wb, qt,
                              U, md, W8, R);
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const int nk = (U + TILE - 1) / TILE;
  double sum = 0.0, sumsq = 0.0;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile(vol, k + off, qs, ks, wb, kt, U, md, scale, clip, pos_w, agg_w,
             agg_b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (qt * TILE + ty + 16 * i >= U) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kt * TILE + tx + 16 * j >= U) continue;
        const double x = vol[i][j];
        sum += x;
        sumsq += x * x;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = sum;
    red[1][threadIdx.x >> 5] = sumsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NTHREADS / 32; ++w) {
      sum += red[0][w];
      sumsq += red[1][w];
    }
    const size_t blk = (size_t)b * gridDim.x * gridDim.y +
                       (size_t)g * gridDim.x + qt;
    partial[2 * blk] = sum;
    partial[2 * blk + 1] = sumsq;
  }
}

// One block per sample: fixed-order fp64 sums of the partials ->
// stats[b] = (gmax, mean, E[x^2], 0) and norm[b] = (mean, rsqrt(var+eps)).
__global__ void __launch_bounds__(NTHREADS)
    corr_moments_kernel(const double* __restrict__ partial, int nblk,
                        const float* __restrict__ gmax, double n_elems,
                        float eps, float* __restrict__ stats,
                        float* __restrict__ norm) {
  __shared__ double red[2][NTHREADS];
  const int b = blockIdx.x;
  double sum = 0.0, sumsq = 0.0;
  for (int e = threadIdx.x; e < nblk; e += NTHREADS) {
    sum += partial[2 * ((size_t)b * nblk + e)];
    sumsq += partial[2 * ((size_t)b * nblk + e) + 1];
  }
  red[0][threadIdx.x] = sum;
  red[1][threadIdx.x] = sumsq;
  __syncthreads();
  for (int w = NTHREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red[0][threadIdx.x] += red[0][threadIdx.x + w];
      red[1][threadIdx.x] += red[1][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double mean = red[0][0] / n_elems;
    const double ex2 = red[1][0] / n_elems;
    const double var = fmax(ex2 - mean * mean, 0.0);
    stats[4 * b + 0] = gmax[0];
    stats[4 * b + 1] = (float)mean;
    stats[4 * b + 2] = (float)ex2;
    stats[4 * b + 3] = 0.f;
    norm[2 * b + 0] = (float)mean;
    norm[2 * b + 1] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(NTHREADS)
    corr_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ biases,
                      const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      const float* __restrict__ norm, O* __restrict__ out,
                      int U, int md, int W8, int R, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t off = (size_t)b * NMODES * U * md;
  WindowBias wb;
  const float clip = prologue(q + off, biases, scal, gmax, qs, win, wb, qt,
                              U, md, W8, R);
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const float mean = norm[2 * b], rstd = norm[2 * b + 1];
  const int nk = (U + TILE - 1) / TILE;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile(vol, k + off, qs, ks, wb, kt, U, md, scale, clip, pos_w, agg_w,
             agg_b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * TILE + ty + 16 * i;
      if (row >= U) continue;
      O* orow = out + ((size_t)b * U + row) * U;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col < U) orow[col] = from_f<O>((vol[i][j] - mean) * rstd);
      }
    }
  }
}

template <typename T, typename O>
static int launch(const void* q, const void* k, const void* biases,
                  const void* scal, const void* gmax, void* partial,
                  void* stats, void* norm, void* out, int B, int U, int md,
                  int W8, int R, float scale, float eps, cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias>();
  const int nq = (U + TILE - 1) / TILE;
  const int ng = (nq + KGROUP - 1) / KGROUP;
  dim3 grid(nq, ng, B);
  cudaError_t err = allow_smem(corr_stats_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(corr_write_kernel<T, O>, smem);
  if (err != cudaSuccess) return (int)err;
  corr_stats_kernel<T><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const float*)biases, (const float*)scal,
      (const float*)gmax, (double*)partial, U, md, W8, R, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  corr_moments_kernel<<<B, NTHREADS, 0, s>>>(
      (const double*)partial, nq * ng, (const float*)gmax,
      (double)U * (double)U, eps, (float*)stats, (float*)norm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  corr_write_kernel<T, O><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const float*)biases, (const float*)scal,
      (const float*)gmax, (const float*)norm, (O*)out, U, md, W8, R, scale);
  return (int)cudaGetLastError();
}

// q, k: [B, 4, U, md] contiguous (bf16 when in_bf16, else fp32), md <= 64;
// scal: [4] fp32 (attn_clip, pos_w, agg_w, agg_b); gmax: [1] fp32, the raw
// max of scale * q k^T over the batch (B1); partial: [B * ceil(U/64) *
// ceil(ceil(U/64)/8) * 2] fp64 scratch; stats: [B, 4] fp32; norm: [B, 2]
// fp32 scratch; out: [B, U, U] bf16 when out_bf16 else fp32.  The (in, out)
// pairs are bf16 -> bf16 (the main path), fp32 -> fp32 (the fp32 config)
// and bf16 -> fp32; fp32 -> bf16 is refused.
extern "C" int corr_norm_launch(const void* q, const void* k,
                                const void* biases, const void* scal,
                                const void* gmax, void* partial, void* stats,
                                void* norm, void* out, int B, int U, int md,
                                int W8, int R, float scale, float eps,
                                int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, biases, scal, gmax,
                                                partial, stats, norm, out, B,
                                                U, md, W8, R, scale, eps, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(q, k, biases, scal, gmax, partial,
                                        stats, norm, out, B, U, md, W8, R,
                                        scale, eps, s);
  if (out_bf16) return (int)cudaErrorInvalidValue;
  return launch<float, float>(q, k, biases, scal, gmax, partial, stats, norm,
                              out, B, U, md, W8, R, scale, eps, s);
}
