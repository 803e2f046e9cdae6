// B3 and B9: the inter-frame correlation volume, conditionally clamped,
// mode-aggregated and globally layer-normed, written once:
//   s_m  = clamp(scale * q_m k_m^T, +-clip) + pos_w * bias
//   vol  = sum_m softmax_m(agg_w * s_m + agg_b) * s_m
//   out  = (vol - mean_b) * rsqrt(var_b + eps)
// with clip = attn_clip if the batch-global raw max exceeds attn_clip, else
// 1e30, and per-sample mean / variance over the whole U2 x U2 volume.
//
// B3 replaces craft_tpu/ops/pallas/mode_attention.py:fused_agg_corr_norm_mt
// (bodies _corr_stats_kernel, _agg_modes, _corr_norm_write_kernel): one
// device holds the whole volume.  B9 replaces its two sequence-parallel
// halves, corr_norm_sums_mt (body _corr_sums_kernel) and corr_norm_write_mt
// (body _corr_norm_write_kernel), for a shard of U1 query rows (whole W8
// rows starting at global token q_tok0) against all U2 keys:
//   sums   the shard's per-sample fp64 (sum, sum of squares) of vol, given
//          the global raw max (the caller all-reduces the shards' B1
//          maxima); the caller all-reduces the sums over the shards;
//   write  the shard's rows normalized with the all-reduced sums and the
//          global element count U2 * U2.
// The TPU kernels carried running sums in SMEM across sequential grid
// steps; here blocks run in parallel, so each writes fixed-order fp64
// partials and a one-block-per-sample pass sums them, as in B3: the result
// does not depend on scheduling, and B9's shards summed give B3's moments up
// to fp64 rounding.
//
// Bound on the H100: operations.  At the inter site (B=1, M=4, U=7040,
// md=64) each q.k^T sweep is 25.4 GFLOP (a shard of U1 rows: U1 / U of it)
// and the only volume-sized traffic is the 99 MB bf16 write (30 us of
// memory time).  The raw max is the B1 kernel run on the same q, k (the
// caller passes its result); then
//   1. a stats sweep recomputes the aggregated volume tile by tile and
//      writes per-block fp64 partial sums of vol and vol^2 (49.6 M
//      elements per sample: fp32 running sums would lose digits);
//   2. a one-block-per-sample pass sums the partials in a fixed order;
//   3. a write sweep recomputes the volume and writes it normalized.
// A block holds all four modes' q tiles (one 64-row slice) in shared
// memory and sweeps a group of k tiles (agg_modes.cuh, shared with B6).
// Any W8 works: the bias window is indexed directly and ragged U1, U2 are
// masked in-kernel.
#include "agg_modes.cuh"

// Shared prologue: this block's q tiles, window and token coordinates
// (load_q_modes), and the clip value from the raw max.
template <typename T>
__device__ __forceinline__ float prologue(const T* __restrict__ qb,
                                          const BiasArgs& ba,
                                          const float* __restrict__ scal,
                                          const float* __restrict__ gmax,
                                          float* qs, float* win,
                                          WindowBias& wb, int qt, int md) {
  load_q_modes(qb, qs, win, wb, ba, qt, ba.U1, md);
  const float attn_clip = scal[0];
  return gmax[0] > attn_clip ? attn_clip : 1e30f;
}

// Per block: fixed-order fp64 sums of vol and vol^2 over its tile rows and
// k-tile group -> partial[2 * blk], partial[2 * blk + 1].
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    corr_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      BiasArgs ba, const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      double* __restrict__ partial, int md, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  __shared__ double red[2][NTHREADS / 32];
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int U1 = ba.U1, U2 = ba.U2;
  WindowBias wb;
  const float clip = prologue(q + (size_t)b * NMODES * U1 * md, ba, scal,
                              gmax, qs, win, wb, qt, md);
  const T* kb = k + (size_t)b * NMODES * U2 * md;
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const int nk = (U2 + TILE - 1) / TILE;
  double sum = 0.0, sumsq = 0.0;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile(vol, kb, qs, ks, wb, kt, U2, md, scale, clip, pos_w, agg_w,
             agg_b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (qt * TILE + ty + 16 * i >= U1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kt * TILE + tx + 16 * j >= U2) continue;
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

// Sample b's partials summed in a fixed order (each thread a strided
// share, then a tree over the block); the totals are valid in thread 0.
__device__ __forceinline__ void sum_sample_partials(
    const double* __restrict__ partial, int nblk, int b, double* sum,
    double* sumsq) {
  __shared__ double red[2][NTHREADS];
  double s = 0.0, s2 = 0.0;
  for (int e = threadIdx.x; e < nblk; e += NTHREADS) {
    s += partial[2 * ((size_t)b * nblk + e)];
    s2 += partial[2 * ((size_t)b * nblk + e) + 1];
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = s2;
  __syncthreads();
  for (int w = NTHREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red[0][threadIdx.x] += red[0][threadIdx.x + w];
      red[1][threadIdx.x] += red[1][threadIdx.x + w];
    }
    __syncthreads();
  }
  *sum = red[0][0];
  *sumsq = red[1][0];
}

// norm[b] = (mean, rsqrt(var + eps)) from the sums over n_elems elements,
// and, where stats is not null, stats[b] = (gmax, mean, E[x^2], 0).
__device__ __forceinline__ void finish_moments(double sum, double sumsq,
                                               double n_elems, float eps,
                                               float gmax, int b,
                                               float* __restrict__ stats,
                                               float* __restrict__ norm) {
  const double mean = sum / n_elems;
  const double ex2 = sumsq / n_elems;
  const double var = fmax(ex2 - mean * mean, 0.0);
  if (stats != nullptr) {
    stats[4 * b + 0] = gmax;
    stats[4 * b + 1] = (float)mean;
    stats[4 * b + 2] = (float)ex2;
    stats[4 * b + 3] = 0.f;
  }
  norm[2 * b + 0] = (float)mean;
  norm[2 * b + 1] = (float)(1.0 / sqrt(var + (double)eps));
}

// B3, one block per sample: the moments of the whole volume.
__global__ void __launch_bounds__(NTHREADS)
    corr_moments_kernel(const double* __restrict__ partial, int nblk,
                        const float* __restrict__ gmax, double n_elems,
                        float eps, float* __restrict__ stats,
                        float* __restrict__ norm) {
  double sum, sumsq;
  sum_sample_partials(partial, nblk, blockIdx.x, &sum, &sumsq);
  if (threadIdx.x == 0)
    finish_moments(sum, sumsq, n_elems, eps, gmax[0], blockIdx.x, stats,
                   norm);
}

// B9 sums, one block per sample: sums[b] = (sum, sum of squares) of the
// shard's rows, fp64.
__global__ void __launch_bounds__(NTHREADS)
    corr_shard_sums_kernel(const double* __restrict__ partial, int nblk,
                           double* __restrict__ sums) {
  double sum, sumsq;
  sum_sample_partials(partial, nblk, blockIdx.x, &sum, &sumsq);
  if (threadIdx.x == 0) {
    sums[2 * blockIdx.x] = sum;
    sums[2 * blockIdx.x + 1] = sumsq;
  }
}

// B9 write, before the sweep: norm of every sample from the all-reduced
// sums (one thread a sample).
__global__ void corr_finish_kernel(const double* __restrict__ sums, int B,
                                   double n_elems, float eps,
                                   float* __restrict__ norm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    finish_moments(sums[2 * b], sums[2 * b + 1], n_elems, eps, 0.f, b,
                   nullptr, norm);
}

template <typename T, typename O>
__global__ void __launch_bounds__(NTHREADS)
    corr_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      BiasArgs ba, const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      const float* __restrict__ norm, O* __restrict__ out,
                      int md, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int U1 = ba.U1, U2 = ba.U2;
  WindowBias wb;
  const float clip = prologue(q + (size_t)b * NMODES * U1 * md, ba, scal,
                              gmax, qs, win, wb, qt, md);
  const T* kb = k + (size_t)b * NMODES * U2 * md;
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const float mean = norm[2 * b], rstd = norm[2 * b + 1];
  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile(vol, kb, qs, ks, wb, kt, U2, md, scale, clip, pos_w, agg_w,
             agg_b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * TILE + ty + 16 * i;
      if (row >= U1) continue;
      O* orow = out + ((size_t)b * U1 + row) * U2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col < U2) orow[col] = from_f<O>((vol[i][j] - mean) * rstd);
      }
    }
  }
}

// The sweeps' grid: (q tiles, k-tile groups, samples).
static dim3 sweep_grid(int B, int U1, int U2) {
  const int nq = (U1 + TILE - 1) / TILE, nk = (U2 + TILE - 1) / TILE;
  return dim3(nq, (nk + KGROUP - 1) / KGROUP, B);
}

template <typename T>
static int launch_stats(const void* q, const void* k, const BiasArgs& ba,
                        const void* scal, const void* gmax, void* partial,
                        int B, int md, float scale, cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias>();
  cudaError_t err = allow_smem(corr_stats_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  corr_stats_kernel<T><<<sweep_grid(B, ba.U1, ba.U2), NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, ba, (const float*)scal, (const float*)gmax,
      (double*)partial, md, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
static int launch_write(const void* q, const void* k, const BiasArgs& ba,
                        const void* scal, const void* gmax, const void* norm,
                        void* out, int B, int md, float scale,
                        cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias>();
  cudaError_t err = allow_smem(corr_write_kernel<T, O>, smem);
  if (err != cudaSuccess) return (int)err;
  corr_write_kernel<T, O><<<sweep_grid(B, ba.U1, ba.U2), NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, ba, (const float*)scal, (const float*)gmax,
      (const float*)norm, (O*)out, md, scale);
  return (int)cudaGetLastError();
}

static int partial_blocks(int U1, int U2) {
  const dim3 g = sweep_grid(1, U1, U2);
  return (int)(g.x * g.y);
}

template <typename T, typename O>
static int launch(const void* q, const void* k, const BiasArgs& ba,
                  const void* scal, const void* gmax, void* partial,
                  void* stats, void* norm, void* out, int B, int md,
                  float scale, float eps, cudaStream_t s) {
  int err = launch_stats<T>(q, k, ba, scal, gmax, partial, B, md, scale, s);
  if (err != 0) return err;
  corr_moments_kernel<<<B, NTHREADS, 0, s>>>(
      (const double*)partial, partial_blocks(ba.U1, ba.U2),
      (const float*)gmax, (double)ba.U2 * (double)ba.U2, eps, (float*)stats,
      (float*)norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_write<T, O>(q, k, ba, scal, gmax, norm, out, B, md, scale, s);
}

// B3.  q, k: [B, 4, U, md] contiguous (bf16 when in_bf16, else fp32), md <=
// 64; scal: [4] fp32 (attn_clip, pos_w, agg_w, agg_b); gmax: [1] fp32, the
// raw max of scale * q k^T over the batch (B1); partial: [B * ceil(U/64) *
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
  const BiasArgs ba{(const float*)biases, W8, R, U, U, 0};
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, ba, scal, gmax,
                                                partial, stats, norm, out, B,
                                                md, scale, eps, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(q, k, ba, scal, gmax, partial, stats,
                                        norm, out, B, md, scale, eps, s);
  if (out_bf16) return (int)cudaErrorInvalidValue;
  return launch<float, float>(q, k, ba, scal, gmax, partial, stats, norm,
                              out, B, md, scale, eps, s);
}

// B9 sums.  q: [B, 4, U1, md], the shard's query rows (global tokens q_tok0
// .. q_tok0 + U1 - 1); k: [B, 4, U2, md], every key; contiguous, bf16 when
// in_bf16 else fp32, md <= 64; scal as B3; gmax: [1] fp32, the global raw
// max; partial: [B * ceil(U1/64) * ceil(ceil(U2/64)/8) * 2] fp64 scratch;
// sums: [B, 2] fp64 out.
extern "C" int corr_norm_sums_launch(const void* q, const void* k,
                                     const void* biases, const void* scal,
                                     const void* gmax, void* partial,
                                     void* sums, int B, int U1, int U2,
                                     int q_tok0, int md, int W8, int R,
                                     float scale, int in_bf16,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  int err = in_bf16 ? launch_stats<__nv_bfloat16>(q, k, ba, scal, gmax,
                                                  partial, B, md, scale, s)
                    : launch_stats<float>(q, k, ba, scal, gmax, partial, B,
                                          md, scale, s);
  if (err != 0) return err;
  corr_shard_sums_kernel<<<B, NTHREADS, 0, s>>>(
      (const double*)partial, partial_blocks(U1, U2), (double*)sums);
  return (int)cudaGetLastError();
}

// B9 write.  q, k, scal, gmax as B9 sums; sums: [B, 2] fp64, the sums over
// every shard; n_elems: the global element count U2 * U2; norm: [B, 2] fp32
// scratch; out: [B, U1, U2] bf16 when out_bf16 else fp32, the (in, out)
// pairs of B3.
extern "C" int corr_norm_write_launch(const void* q, const void* k,
                                      const void* biases, const void* scal,
                                      const void* gmax, const void* sums,
                                      void* norm, void* out, int B, int U1,
                                      int U2, int q_tok0, int md, int W8,
                                      int R, float scale, double n_elems,
                                      float eps, int in_bf16, int out_bf16,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && out_bf16) return (int)cudaErrorInvalidValue;
  corr_finish_kernel<<<(B + 31) / 32, 32, 0, s>>>(
      (const double*)sums, B, n_elems, eps, (float*)norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  if (in_bf16 && out_bf16)
    return launch_write<__nv_bfloat16, __nv_bfloat16>(q, k, ba, scal, gmax,
                                                      norm, out, B, md, scale,
                                                      s);
  if (in_bf16)
    return launch_write<__nv_bfloat16, float>(q, k, ba, scal, gmax, norm, out,
                                              B, md, scale, s);
  return launch_write<float, float>(q, k, ba, scal, gmax, norm, out, B, md,
                                    scale, s);
}
