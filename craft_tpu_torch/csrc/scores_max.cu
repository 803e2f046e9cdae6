// B1: global max of scale * q_m k_m^T over batch, modes and tiles, without
// materializing the scores.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:scores_global_max (body
// _max_kernel), the predicate of the conditional attention clamp.
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64)
// it is 25.4 GFLOP over 3.6 MB of input; the design keeps each block's q
// tile resident in shared memory and sweeps every k tile past it, so each
// input byte is read once per q tile from L2 and never from a materialized
// [U, U] score tensor.  The TPU kernel carried the running max across
// sequential grid steps; here blocks run in parallel, so each block writes
// one partial max and a one-block second pass reduces the partials (no
// float atomics, deterministic).
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    scores_max_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      float* __restrict__ partial, int U1, int U2, int md,
                      float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + MAXMD * SPAD;
  __shared__ float red[NTHREADS / 32];
  const int qt = blockIdx.x, bm = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + (size_t)bm * U1 * md;
  const T* kb = k + (size_t)bm * U2 * md;
  load_tile_t(qs, qb, qt * TILE, U1, md);
  float m = NEG_INF;
  // The masks leave the sweep's index arithmetic: this thread's query rows
  // are tested once, its key columns against the count left in the tile.
  const int rows = U1 - qt * TILE - ty;
  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile_t(ks, kb, kt * TILE, U2, md);
    __syncthreads();
    float acc[4][4];
    score_tile(acc, qs, ks, md);
    const int cols = U2 - kt * TILE - tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (16 * i >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (16 * j < cols) m = fmaxf(m, acc[i][j] * scale);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NTHREADS / 32; ++w) m = fmaxf(m, red[w]);
    partial[(size_t)bm * gridDim.x + qt] = m;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    max_reduce_kernel(const float* __restrict__ partial, int n,
                      float* __restrict__ out) {
  __shared__ float red[NTHREADS / 32];
  float m = NEG_INF;
  for (int e = threadIdx.x; e < n; e += NTHREADS) m = fmaxf(m, partial[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NTHREADS / 32; ++w) m = fmaxf(m, red[w]);
    out[0] = m;
  }
}

// q: [BM, U1, md], k: [BM, U2, md] contiguous (bf16 when in_bf16, else
// fp32), md <= 64; U1 < U2 for a row shard of the queries.  partial:
// [BM * ceil(U1 / 64)] fp32 scratch; out: [1] fp32.
extern "C" int scores_max_launch(const void* q, const void* k, void* partial,
                                 void* out, int BM, int U1, int U2, int md,
                                 float scale, int in_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nq = (U1 + TILE - 1) / TILE;
  const size_t smem = 2 * MAXMD * SPAD * sizeof(float);
  dim3 grid(nq, BM);
  cudaError_t err;
  if (in_bf16) {
    err = allow_smem(scores_max_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    scores_max_kernel<__nv_bfloat16><<<grid, NTHREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (float*)partial,
        U1, U2, md, scale);
  } else {
    err = allow_smem(scores_max_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    scores_max_kernel<float><<<grid, NTHREADS, smem, s>>>(
        (const float*)q, (const float*)k, (float*)partial, U1, U2, md,
        scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_reduce_kernel<<<1, NTHREADS, 0, s>>>((const float*)partial, nq * BM,
                                           (float*)out);
  return (int)cudaGetLastError();
}
