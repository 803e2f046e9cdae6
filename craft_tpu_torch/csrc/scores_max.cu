// B1: global max of scale * q_m k_m^T over batch, modes and tiles, without
// materializing the scores.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:scores_global_max (body
// _max_kernel), the predicate of the conditional attention clamp.
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64)
// it is 25.4 GFLOP over 3.6 MB of input (26 us at the bf16 tensor-core
// peak).  The TPU kernel carried the running max across sequential grid
// steps; here blocks run in parallel, so each block writes one partial max
// and a one-block second pass (max_reduce_kernel) reduces the partials (no
// float atomics; a max is exact, so the result does not depend on the
// split or the order).  Two bodies:
//
// bf16 (scores_max_wgmma_kernel): bf16 products with fp32 sums on the
// tensor cores, as the Pallas body's dot_general(preferred_element_type=
// f32) computes them.  A block is one warpgroup owning 128 query rows of
// one (b, mode) as two 64-row halves, whose q fragments stay in registers
// (the A operand, read once from global memory); k tiles of 64 keys are
// the B operand, row-major [keys, md] being the K-major layout wgmma reads,
// copied by 16-byte cp.async into a 4-stage ring counted by mbarriers with
// the 128-, 64- or 32-byte swizzle of md 64, 32 or 16 (wgmma.cuh).  Per
// tile: 2 x md / 16 wgmmas m64n64k16, then an fmaxf over the 64 accumulator
// values of each thread into 8 running maxima.  The scale multiplies the
// block's max once (rounding is monotone, so max(scale x) = scale max(x)).
// Rows past U1 and keys past U2 read as zero and are masked only on the
// tiles that hold them (a warp-uniform test; a zero score must not enter
// the max when every real score is negative).  The keys are split across
// blocks in chunks of B1_KCHUNK tiles, so the card is filled: serving runs
// 55 q tiles x 4 modes x 7 chunks = 1540 blocks of 128 threads, several an
// SM, instead of 220.  What bounds it is the k traffic from L2 (each
// 128-row tile reads all of its mode's keys: 198 MB at serving, md 64) and
// the fmaxf over every score (4 U^2 of them), not the products.  The
// wrapper raises unless md is a multiple of 16 (md 48 runs the 64-wide
// tiles with zero columns) and q and k are 16-byte aligned.
//
// fp32 (scores_max_kernel): plain fp32 FMA over TILE x TILE tiles staged
// transposed in shared memory (common.cuh), kept for fp32 parity.  The same
// body takes bf16 inputs whose mode dim passes 64 (md 128 and 256: one or
// two modes at a 256-wide site, one at the intra site), staged at a 256
// stride (133 KB of shared memory); a simple kernel that is right, at
// the FMA rate, not the tensor cores'.
#include "common.cuh"
#include "wgmma.cuh"

#define B1_ROWS 128   // query rows a block (bf16): one warpgroup, 2 x 64
#define B1_KEYS 64    // keys a ring stage
#define B1_KCHUNK 16  // key tiles a block: the split of the keys
#define B1_STAGES 4   // ring depth
#define B1_THREADS 128

// The FMA body (fp32, and bf16 at a mode dim past the wgmma body's 64).
// SHARD is false when the queries are all of the keys' rows (U1 == U2,
// every path but sequence parallelism): the key count is then U1 itself,
// and the masks test the token indices in place.  The sharded
// instantiation tests its query rows against the rows left in the shard
// and its key columns against the keys left in each tile.  Keeping the
// unsharded sweep free of the shard's arithmetic keeps its time (see
// PERF.md, B1).  The bf16 body takes U1 != U2 as it is: its masks are
// tile-uniform tests of U1 and U2.  T: the input type; MDS: the staged
// tiles' mode dim stride (MAXMD, or MAXMD_FMA for md 128 and 256).
template <typename T, bool SHARD, int MDS>
__global__ void __launch_bounds__(NTHREADS)
    scores_max_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      float* __restrict__ partial, int U1, int U2_,
                      int md, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + MDS * SPAD;
  __shared__ float red[NTHREADS / 32];
  const int U2 = SHARD ? U2_ : U1;
  const int qt = blockIdx.x, bm = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + (size_t)bm * U1 * md;
  const T* kb = k + (size_t)bm * U2 * md;
  load_tile_t(qs, qb, qt * TILE, U1, md);
  float m = NEG_INF;
  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile_t(ks, kb, kt * TILE, U2, md);
    __syncthreads();
    float acc[4][4];
    score_tile(acc, qs, ks, md);
    if (SHARD) {
      const int rows = U1 - qt * TILE - ty;
      const int cols = U2 - kt * TILE - tx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (16 * i >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (16 * j < cols) m = fmaxf(m, acc[i][j] * scale);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (qt * TILE + ty + 16 * i >= U1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kt * TILE + tx + 16 * j < U2) m = fmaxf(m, acc[i][j] * scale);
      }
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

// The bf16 body.  Grid (key chunks, q tiles, b * M + m); partial[(bm *
// gridDim.y + qt) * gridDim.x + chunk] = scale * the block's max.  MDP: the
// tiles' mode dim (16, 32 or 64 >= md; columns past md are zero).
template <int MDP>
__global__ void __launch_bounds__(B1_THREADS, 3)
    scores_max_wgmma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            float* __restrict__ partial, int U1, int U2,
                            int md, float scale) {
  constexpr int KC = MDP / 8;                 // 16-byte chunks of a k row
  constexpr int STAGE = B1_KEYS * MDP * 2;    // bytes of a k tile
  constexpr int NT = B1_KEYS / 8;             // n tiles of 8 keys
  constexpr int KROWS = B1_THREADS / KC;      // k rows a pass of copies
  constexpr int KIT = B1_KEYS / KROWS;
  static_assert(KIT * KROWS == B1_KEYS, "whole passes");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  __shared__ float red[B1_THREADS / 32];
  const int chunk = blockIdx.x, qt = blockIdx.y, bm = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bm * U1 * md;
  const bf16* kb = k + (size_t)bm * U2 * md;
  const int nk = (U2 + B1_KEYS - 1) / B1_KEYS;
  const int kt0 = chunk * B1_KCHUNK;
  const int n = min(nk, kt0 + B1_KCHUNK) - kt0;  // >= 1

  const uint32_t full0 = smem_u32(smem + B1_STAGES * STAGE);
  if (threadIdx.x == 0)
    for (int i = 0; i < B1_STAGES; ++i) mbar_init(full0 + 8 * i, B1_THREADS);
  __syncthreads();

  // Each thread copies the same chunk column of k rows KROWS apart: its
  // offsets are fixed here (the swizzle repeats every 8 rows).
  const int k_r = threadIdx.x / KC, k_c = threadIdx.x % KC;
  const bool k_on = 8 * k_c < md;  // else zeros (md 48)
  const bf16* k_src = k_on ? kb + (size_t)k_r * md + 8 * k_c : kb;
  const uint32_t k_dst = k_r * MDP * 2 + 16 * swz<KC>(k_r, k_c);
  auto load_stage = [&](int kt, int s) {
    const uint32_t sa = smem_u32(smem + s * STAGE);
    const int key0 = kt * B1_KEYS, left = U2 - key0;
#pragma unroll
    for (int it = 0; it < KIT; ++it) {
      const bool ok = k_on && k_r + KROWS * it < left;
      cp_async16(sa + k_dst + it * KROWS * MDP * 2,
                 ok ? k_src + (size_t)(key0 + KROWS * it) * md : kb, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < B1_STAGES; ++i) {
    if (i < n) {
      load_stage(kt0 + i, i);
      mbar_arrive_copies(full0 + 8 * i);
    }
  }

  // q fragments (A of wgmma) of half h: rows r0 + 64 h and r0 + 64 h + 8,
  // r0 = qt * B1_ROWS + warp * 16 + g; a0 (row, 2t..2t+1), a1 (row + 8,
  // 2t..), a2 (row, 2t + 8..), a3 (row + 8, 2t + 8..) of each 16-wide slice.
  const int r0 = qt * B1_ROWS + warp * 16 + g;
  uint32_t qa[2][MDP / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kd = 0; kd < MDP / 16; ++kd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 64 * h + 8 * (e & 1);
        const int col = 16 * kd + 8 * (e >> 1) + 2 * t;
        qa[h][kd][e] = row < U1 && col < md
                           ? *reinterpret_cast<const uint32_t*>(
                                 qb + (size_t)row * md + col)
                           : 0u;
      }
  // Whether all 16 rows of this warp in half h exist (warp-uniform), and
  // whether the thread's own rows do.
  bool rows_all[2], row_ok[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows_all[h] = qt * B1_ROWS + 64 * h + warp * 16 + 16 <= U1;
    row_ok[h][0] = r0 + 64 * h < U1;
    row_ok[h][1] = r0 + 64 * h + 8 < U1;
  }

  float mx[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) mx[j] = NEG_INF;
  // The descriptor of stage 0; a tile adds its byte offset / 16.
  const uint64_t db0 = gmma_desc(smem_u32(smem), 16, KLayout<MDP>::SBO,
                                 KLayout<MDP>::TYPE);
  float acc[2][NT][4] = {};
  for (int i = 0; i < n; ++i) {
    const int s = i % B1_STAGES;
    mbar_wait(full0 + 8 * s, (i / B1_STAGES) & 1);
    fence_async_smem();
    const uint64_t db = db0 + (uint64_t)(s * STAGE / 16);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kd = 0; kd < MDP / 16; ++kd)
        wgmma_s(acc[h], qa[h][kd], db + 2 * kd, kd);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[h][j][e]);
    __syncthreads();  // every warp's products of stage s are done
    if (i + B1_STAGES < n) {
      load_stage(kt0 + i + B1_STAGES, s);
      mbar_arrive_copies(full0 + 8 * s);
    }
    const int key0 = (kt0 + i) * B1_KEYS;
    if (key0 + B1_KEYS <= U2 && rows_all[0] && rows_all[1]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx[j] = fmaxf(mx[j], fmaxf(fmaxf(acc[h][j][0], acc[h][j][1]),
                                     fmaxf(acc[h][j][2], acc[h][j][3])));
    } else {  // the ragged last key tile, or the rows past U1
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (row_ok[h][e >> 1] && key0 + 8 * j + 2 * t + (e & 1) < U2)
              mx[j] = fmaxf(mx[j], acc[h][j][e]);
    }
  }
  float m = mx[0];
#pragma unroll
  for (int j = 1; j < NT; ++j) m = fmaxf(m, mx[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < B1_THREADS / 32; ++w) m = fmaxf(m, red[w]);
    partial[((size_t)bm * gridDim.y + qt) * gridDim.x + chunk] = m * scale;
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

template <typename T, bool SHARD, int MDS>
static cudaError_t launch_max(const void* q, const void* k, void* partial,
                              dim3 grid, int U1, int U2, int md, float scale,
                              cudaStream_t s) {
  const size_t smem = 2 * MDS * SPAD * sizeof(float);
  cudaError_t err = allow_smem(scores_max_kernel<T, SHARD, MDS>, smem);
  if (err != cudaSuccess) return err;
  scores_max_kernel<T, SHARD, MDS><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (float*)partial, U1, U2, md, scale);
  return cudaGetLastError();
}

// The FMA body for input type T: the unsharded or the sharded sweep, at
// the stride of md.
template <typename T>
static cudaError_t launch_fma(const void* q, const void* k, void* partial,
                              int BM, int U1, int U2, int md, float scale,
                              cudaStream_t s) {
  if (md <= 0 || md > MAXMD_FMA) return cudaErrorInvalidValue;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  if (md <= MAXMD)
    return U1 == U2 ? launch_max<T, false, MAXMD>(q, k, partial, grid, U1,
                                                  U2, md, scale, s)
                    : launch_max<T, true, MAXMD>(q, k, partial, grid, U1, U2,
                                                 md, scale, s);
  return U1 == U2 ? launch_max<T, false, MAXMD_FMA>(q, k, partial, grid, U1,
                                                    U2, md, scale, s)
                  : launch_max<T, true, MAXMD_FMA>(q, k, partial, grid, U1,
                                                   U2, md, scale, s);
}

// The partial maxima of a launch: one per block of the body that mma
// selects (mma_body; tests/test_torch_kernel_grids.py holds the wrapper's
// count against this).
static int max_partials(int BM, int U1, int U2, int mma) {
  if (!mma) return BM * ((U1 + TILE - 1) / TILE);
  const int nk = (U2 + B1_KEYS - 1) / B1_KEYS;
  return BM * ((U1 + B1_ROWS - 1) / B1_ROWS) *
         ((nk + B1_KCHUNK - 1) / B1_KCHUNK);
}

template <int MDP>
static cudaError_t launch_wgmma_md(const void* q, const void* k,
                                   void* partial, int BM, int U1, int U2,
                                   int md, float scale, cudaStream_t s) {
  // + 1024: the ring starts at the first 1024-byte boundary.
  const size_t smem = B1_STAGES * (B1_KEYS * MDP * 2 + 8) + 1024;
  auto kernel = scores_max_wgmma_kernel<MDP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nk = (U2 + B1_KEYS - 1) / B1_KEYS;
  dim3 grid((nk + B1_KCHUNK - 1) / B1_KCHUNK, (U1 + B1_ROWS - 1) / B1_ROWS,
            BM);
  kernel<<<grid, B1_THREADS, smem, s>>>((const bf16*)q, (const bf16*)k,
                                        (float*)partial, U1, U2, md, scale);
  return cudaGetLastError();
}

// md a multiple of 16 up to 64, q and k 16-byte aligned.
static cudaError_t launch_wgmma(const void* q, const void* k, void* partial,
                                int BM, int U1, int U2, int md, float scale,
                                cudaStream_t s) {
  if (md <= 0 || md > MAXMD || md % 16 != 0 ||
      (((uintptr_t)q | (uintptr_t)k) & 15) != 0)
    return cudaErrorInvalidValue;
  if (md <= 16)
    return launch_wgmma_md<16>(q, k, partial, BM, U1, U2, md, scale, s);
  if (md <= 32)
    return launch_wgmma_md<32>(q, k, partial, BM, U1, U2, md, scale, s);
  return launch_wgmma_md<64>(q, k, partial, BM, U1, U2, md, scale, s);
}

// q: [BM, U1, md], k: [BM, U2, md] contiguous (bf16 when in_bf16, else
// fp32), md <= 256 (bf16 up to 64: a multiple of 16, q and k 16-byte
// aligned, on wgmma; past 64 and fp32 the FMA body); U1 < U2 for a row
// shard of the queries.  partial: [n_partial] fp32 scratch, n_partial =
// max_partials(BM, U1, U2, mma_body(md, in_bf16)) (refused otherwise); out:
// [1] fp32.
extern "C" int scores_max_launch(const void* q, const void* k, void* partial,
                                 int n_partial, void* out, int BM, int U1,
                                 int U2, int md, float scale, int in_bf16,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int mma = mma_body(md, in_bf16);
  const int np = max_partials(BM, U1, U2, mma);
  if (n_partial != np) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (mma)
    err = launch_wgmma(q, k, partial, BM, U1, U2, md, scale, s);
  else if (in_bf16)
    err = launch_fma<bf16>(q, k, partial, BM, U1, U2, md, scale, s);
  else
    err = launch_fma<float>(q, k, partial, BM, U1, U2, md, scale, s);
  if (err != cudaSuccess) return (int)err;
  max_reduce_kernel<<<1, NTHREADS, 0, s>>>((const float*)partial, np,
                                           (float*)out);
  return (int)cudaGetLastError();
}
