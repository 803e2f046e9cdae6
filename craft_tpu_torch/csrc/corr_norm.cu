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
// Any W8 works: the bias window is indexed directly and ragged U1, U2 are
// masked in-kernel.  Two bodies for the sweeps:
//
// bf16 inputs (corr_sweep_kernel, bf16 or fp32 output; its body is
// agg_modes.cuh's corr_sweep, which B6 and B6 dense (agg_corr.cu) share
// with another epilogue and bias source): the products on the tensor
// cores, bf16 with fp32 sums as the Pallas bodies'
// dot_general(preferred_element_type=f32).  A block owns 128 query rows
// (B3_ROWS) and sweeps B3_KGROUP key tiles of 64; the four modes' q tiles
// stay in shared memory for the block (the A operand through its own
// descriptor: 64 KB at md 64, no registers), and each stage of a 4-stage
// cp.async ring counted by mbarriers holds the four modes' k tiles of one
// key tile (the B operand, 32 KB), swizzled as wgmma.cuh's descriptors
// name.  Four warpgroups split a tile into 64 rows x 32 keys each and take
// turns to issue their 4 modes x md / 16 wgmmas m64n32k16 into four
// accumulator sets of one fragment layout (64 registers a thread, 16 warps
// an SM): each thread holds the four modes' scores of the same (row,
// column), so the mode aggregation runs per thread without shuffles:
// clamp, the window bias (looked up only where the warp's rows and the 32
// keys are within +-R grid rows and columns, any W8), the softmax over the
// four modes on the exp2 scale (ex2.approx), then per-tile fp32 sums of
// vol and vol^2 added to fp64 per thread (stats) or the normalised value
// stored as a pair of columns (write).  The serving grid is 55 q tiles x
// 14 key groups = 770 blocks, one an SM (194 KB of shared memory).  The
// products take a fraction of the sweep: the epilogue's issue (about 27
// instructions and 5 SFU operations per volume element, 4 U^2 of the
// exponentials) and the window lookups bound it.  The wrapper raises
// unless md is a multiple of 16 and q and k are 16-byte aligned.
//
// fp32 inputs, and bf16 at a mode count other than four
// (corr_stats_kernel, corr_write_kernel): plain FMA, a template over the
// mode count NM (1, 2, 4, 8, 16, and NM_WIDE for 32 to 256 as a run-time
// count nm; NM md <= 256, any md).  A block holds all NM modes' q tiles
// (one 64-row slice) in shared memory and sweeps a group of k tiles
// (agg_modes.cuh's FMA tiles, shared with B6): past four modes the mode
// softmax runs over groups of four with a running (max, denominator,
// weighted sum); at NM 1 it is exactly 1 and vol = s.  A simple kernel
// that is right for the other mode counts: at the FMA rate, with NM U^2
// exponentials, not the tensor cores'.
#include "agg_modes.cuh"

// Shared prologue: this block's q tiles, window and token coordinates
// (load_q_modes), and the clip value from the raw max.
template <int NM, typename T>
__device__ __forceinline__ float prologue(const T* __restrict__ qb,
                                          const BiasArgs& ba,
                                          const float* __restrict__ scal,
                                          const float* __restrict__ gmax,
                                          float* qs, float* win,
                                          WindowBias& wb, int qt, int md,
                                          int nm) {
  load_q_modes<NM>(qb, qs, win, wb, ba, qt, ba.U1, md, nm);
  const float attn_clip = scal[0];
  return gmax[0] > attn_clip ? attn_clip : 1e30f;
}

// Per block: fixed-order fp64 sums of vol and vol^2 over its tile rows and
// k-tile group -> partial[2 * blk], partial[2 * blk + 1].  NM modes (nm
// at NM_WIDE) of input type T.
template <int NM, typename T>
__global__ void __launch_bounds__(NTHREADS)
    corr_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      BiasArgs ba, const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      double* __restrict__ partial, int md, int nm,
                      float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD_FMA * SPAD;
  float* win = smem + agg_bias_off<NM>();
  __shared__ double red[2][NTHREADS / 32];
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int U1 = ba.U1, U2 = ba.U2;
  WindowBias wb;
  const float clip = prologue<NM>(q + (size_t)b * modes_of<NM>(nm) * U1 * md,
                                  ba, scal, gmax, qs, win, wb, qt, md, nm);
  const T* kb = k + (size_t)b * modes_of<NM>(nm) * U2 * md;
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const int nk = (U2 + TILE - 1) / TILE;
  double sum = 0.0, sumsq = 0.0;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile<NM>(vol, kb, qs, ks, wb, kt, U2, md, nm, scale, clip, pos_w,
                 agg_w, agg_b);
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

// NM modes (nm at NM_WIDE) of input type T, output type O.
template <int NM, typename T, typename O>
__global__ void __launch_bounds__(NTHREADS)
    corr_write_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      BiasArgs ba, const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      const float* __restrict__ norm, O* __restrict__ out,
                      int md, int nm, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD_FMA * SPAD;
  float* win = smem + agg_bias_off<NM>();
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int U1 = ba.U1, U2 = ba.U2;
  WindowBias wb;
  const float clip = prologue<NM>(q + (size_t)b * modes_of<NM>(nm) * U1 * md,
                                  ba, scal, gmax, qs, win, wb, qt, md, nm);
  const T* kb = k + (size_t)b * modes_of<NM>(nm) * U2 * md;
  const float pos_w = scal[1], agg_w = scal[2], agg_b = scal[3];
  const float mean = norm[2 * b], rstd = norm[2 * b + 1];
  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile<NM>(vol, kb, qs, ks, wb, kt, U2, md, nm, scale, clip, pos_w,
                 agg_w, agg_b);
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

// The bf16 body of both sweeps: agg_modes.cuh's corr_sweep over the window,
// its clip from the raw max, normalised (write) or summed (stats).
template <int MDP, bool WRITE, typename O>
__global__ void __launch_bounds__(B3_THREADS, 1)
    corr_sweep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      BiasArgs ba, const float* __restrict__ scal,
                      const float* __restrict__ gmax,
                      const float* __restrict__ norm, O* __restrict__ out,
                      double* __restrict__ partial, int md, float scale) {
  corr_sweep<MDP, WRITE, false, O, CorrWindow>(q, k, ba, scal, gmax, norm,
                                               out, partial, md, scale);
}

// The stats sweep's fp64 partial pairs per sample (the wrapper's count is
// held against this by tests/test_torch_kernel_grids.py); mma: the body
// (agg_mma_body).
static int partial_blocks(int U1, int U2, int mma) {
  const dim3 g = sweep_grid(1, U1, U2, mma);
  return (int)(g.x * g.y);
}

template <int MDP, bool WRITE, typename O>
static int launch_sweep_md(const void* q, const void* k, const BiasArgs& ba,
                           const void* scal, const void* gmax,
                           const void* norm, void* out, void* partial, int B,
                           int md, float scale, cudaStream_t s) {
  const size_t smem = sweep_smem<MDP, CorrWindow>();
  auto kernel = corr_sweep_kernel<MDP, WRITE, O>;
  cudaError_t err = allow_sweep_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<sweep_grid(B, ba.U1, ba.U2, 1), B3_THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, ba, (const float*)scal,
      (const float*)gmax, (const float*)norm, (O*)out, (double*)partial, md,
      scale);
  return (int)cudaGetLastError();
}

// The bf16 body: md a multiple of 16 up to 64, q and k 16-byte aligned.
template <bool WRITE, typename O>
static int launch_sweep(const void* q, const void* k, const BiasArgs& ba,
                        const void* scal, const void* gmax, const void* norm,
                        void* out, void* partial, int B, int md, float scale,
                        cudaStream_t s) {
  if (!sweep_takes(q, k, md)) return (int)cudaErrorInvalidValue;
  if (md <= 16)
    return launch_sweep_md<16, WRITE, O>(q, k, ba, scal, gmax, norm, out,
                                         partial, B, md, scale, s);
  if (md <= 32)
    return launch_sweep_md<32, WRITE, O>(q, k, ba, scal, gmax, norm, out,
                                         partial, B, md, scale, s);
  return launch_sweep_md<64, WRITE, O>(q, k, ba, scal, gmax, norm, out,
                                       partial, B, md, scale, s);
}

// The FMA stats sweep of NM modes of input type T.
template <int NM, typename T>
static int launch_stats_fma(const void* q, const void* k, const BiasArgs& ba,
                            const void* scal, const void* gmax,
                            void* partial, int B, int md, int nm,
                            float scale, cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias, NM>();
  cudaError_t err = allow_smem(corr_stats_kernel<NM, T>, smem);
  if (err != cudaSuccess) return (int)err;
  corr_stats_kernel<NM, T>
      <<<sweep_grid(B, ba.U1, ba.U2, 0), NTHREADS, smem, s>>>(
          (const T*)q, (const T*)k, ba, (const float*)scal,
          (const float*)gmax, (double*)partial, md, nm, scale);
  return (int)cudaGetLastError();
}

// The FMA write sweep of NM modes, input T, output O.
template <int NM, typename T, typename O>
static int launch_write_fma(const void* q, const void* k, const BiasArgs& ba,
                            const void* scal, const void* gmax,
                            const void* norm, void* out, int B, int md,
                            int nm, float scale, cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias, NM>();
  cudaError_t err = allow_smem(corr_write_kernel<NM, T, O>, smem);
  if (err != cudaSuccess) return (int)err;
  corr_write_kernel<NM, T, O>
      <<<sweep_grid(B, ba.U1, ba.U2, 0), NTHREADS, smem, s>>>(
          (const T*)q, (const T*)k, ba, (const float*)scal,
          (const float*)gmax, (const float*)norm, (O*)out, md, nm, scale);
  return (int)cudaGetLastError();
}

// The stats sweep, either body, NM modes.
static int launch_stats(const void* q, const void* k, const BiasArgs& ba,
                        const void* scal, const void* gmax, void* partial,
                        int B, int NM, int md, float scale, int in_bf16,
                        cudaStream_t s) {
  if (agg_mma_body(NM, md, in_bf16))
    return launch_sweep<false, float>(q, k, ba, scal, gmax, nullptr, nullptr,
                                      partial, B, md, scale, s);
  if (!fma_takes(NM, md)) return (int)cudaErrorInvalidValue;
#define LAUNCH(NM_)                                                        \
  return in_bf16 ? launch_stats_fma<NM_, bf16>(q, k, ba, scal, gmax,       \
                                               partial, B, md, NM, scale, s) \
                 : launch_stats_fma<NM_, float>(q, k, ba, scal, gmax,      \
                                                partial, B, md, NM, scale, s);
  WITH_MODES(NM, LAUNCH)
#undef LAUNCH
}

// The write sweep, either body: (in, out) bf16 -> bf16, bf16 -> fp32 or
// fp32 -> fp32, NM modes.
static int launch_write(const void* q, const void* k, const BiasArgs& ba,
                        const void* scal, const void* gmax, const void* norm,
                        void* out, int B, int NM, int md, float scale,
                        int in_bf16, int out_bf16, cudaStream_t s) {
  if (!in_bf16 && out_bf16) return (int)cudaErrorInvalidValue;
  if (agg_mma_body(NM, md, in_bf16)) {
    if (out_bf16)
      return launch_sweep<true, bf16>(q, k, ba, scal, gmax, norm, out,
                                      nullptr, B, md, scale, s);
    return launch_sweep<true, float>(q, k, ba, scal, gmax, norm, out, nullptr,
                                     B, md, scale, s);
  }
  if (!fma_takes(NM, md)) return (int)cudaErrorInvalidValue;
#define LAUNCH(NM_)                                                        \
  if (!in_bf16)                                                            \
    return launch_write_fma<NM_, float, float>(q, k, ba, scal, gmax, norm, \
                                               out, B, md, NM, scale, s);  \
  if (out_bf16)                                                            \
    return launch_write_fma<NM_, bf16, bf16>(q, k, ba, scal, gmax, norm,   \
                                             out, B, md, NM, scale, s);    \
  return launch_write_fma<NM_, bf16, float>(q, k, ba, scal, gmax, norm,    \
                                            out, B, md, NM, scale, s);
  WITH_MODES(NM, LAUNCH)
#undef LAUNCH
}

// B3.  q, k: [B, NM, U, md] contiguous (bf16 when in_bf16, else fp32), NM
// 1, 2, 4, ..., 256 modes with NM md <= 256 (the wgmma sweep at four modes,
// md <= 64, bf16: a multiple of 16, q and k 16-byte aligned); scal: [4]
// fp32 (attn_clip, pos_w, agg_w, agg_b); gmax: [1] fp32, the raw max of
// scale * q k^T over the batch (B1); partial: [n_partial] fp64 scratch,
// n_partial = 2 B partial_blocks(U, U, agg_mma_body(NM, md, in_bf16))
// (refused otherwise); stats: [B, 4]
// fp32; norm: [B, 2] fp32 scratch; out: [B, U, U] bf16 when out_bf16 else
// fp32.  The (in, out) pairs are bf16 -> bf16 (the main path), fp32 -> fp32
// (the fp32 config) and bf16 -> fp32; fp32 -> bf16 is refused.
extern "C" int corr_norm_launch(const void* q, const void* k,
                                const void* biases, const void* scal,
                                const void* gmax, void* partial,
                                int n_partial, void* stats, void* norm,
                                void* out, int B, int NM, int U, int md,
                                int W8, int R, float scale, float eps,
                                int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = partial_blocks(U, U, agg_mma_body(NM, md, in_bf16));
  if (n_partial != 2 * B * nblk || (!in_bf16 && out_bf16))
    return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)biases, W8, R, U, U, 0};
  int err = launch_stats(q, k, ba, scal, gmax, partial, B, NM, md, scale,
                         in_bf16, s);
  if (err != 0) return err;
  corr_moments_kernel<<<B, NTHREADS, 0, s>>>(
      (const double*)partial, nblk, (const float*)gmax,
      (double)U * (double)U, eps, (float*)stats, (float*)norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_write(q, k, ba, scal, gmax, norm, out, B, NM, md, scale,
                      in_bf16, out_bf16, s);
}

// B9 sums.  q: [B, NM, U1, md], the shard's query rows (global tokens
// q_tok0 .. q_tok0 + U1 - 1); k: [B, NM, U2, md], every key; contiguous,
// bf16 when in_bf16 else fp32, NM and md as B3; scal as B3; gmax: [1]
// fp32, the global raw max; partial: [n_partial] fp64 scratch, n_partial =
// 2 B partial_blocks(U1, U2, agg_mma_body(NM, md, in_bf16)) (refused
// otherwise); sums: [B, 2] fp64 out.
extern "C" int corr_norm_sums_launch(const void* q, const void* k,
                                     const void* biases, const void* scal,
                                     const void* gmax, void* partial,
                                     int n_partial, void* sums, int B,
                                     int NM, int U1, int U2, int q_tok0,
                                     int md, int W8, int R, float scale,
                                     int in_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = partial_blocks(U1, U2, agg_mma_body(NM, md, in_bf16));
  if (n_partial != 2 * B * nblk) return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  int err = launch_stats(q, k, ba, scal, gmax, partial, B, NM, md, scale,
                         in_bf16, s);
  if (err != 0) return err;
  corr_shard_sums_kernel<<<B, NTHREADS, 0, s>>>((const double*)partial, nblk,
                                                (double*)sums);
  return (int)cudaGetLastError();
}

// B9 write.  q, k, scal, gmax as B9 sums; sums: [B, 2] fp64, the sums over
// every shard; n_elems: the global element count U2 * U2; norm: [B, 2] fp32
// scratch; out: [B, U1, U2] bf16 when out_bf16 else fp32, the (in, out)
// pairs of B3.
extern "C" int corr_norm_write_launch(const void* q, const void* k,
                                      const void* biases, const void* scal,
                                      const void* gmax, const void* sums,
                                      void* norm, void* out, int B, int NM,
                                      int U1, int U2, int q_tok0, int md,
                                      int W8, int R, float scale,
                                      double n_elems, float eps, int in_bf16,
                                      int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && out_bf16) return (int)cudaErrorInvalidValue;
  corr_finish_kernel<<<(B + 31) / 32, 32, 0, s>>>(
      (const double*)sums, B, n_elems, eps, (float*)norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  return launch_write(q, k, ba, scal, gmax, norm, out, B, NM, md, scale,
                      in_bf16, out_bf16, s);
}
