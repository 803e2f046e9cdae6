// The inter-site mode aggregation, shared by the volume kernels B3 and B9
// (corr_norm.cu) and B6 and B6 dense (agg_corr.cu):
//   s_m = clamp(scale * q_m k_m^T, +-clip) + pos_w * bias
//   vol = sum_m softmax_m(agg_w * s_m + agg_b) * s_m
// Two bodies.  FMA (the tiles first below), a template over the mode
// count NM (1, 2, 4, 8 or 16, or NM_WIDE: 32, 64, 128 or 256 as a run-time
// count) and the input type: a block holds all NM modes' q tiles (one
// 64-row slice; NM * md <= 256, MAXMD_FMA) in shared memory and sweeps k
// tiles past them; the per-mode scores of each element stay in registers,
// a group of at most four modes at a time.  With one group (NM <= 4) the
// softmax over the modes is one max, one sum; with more a running (max,
// denominator, weighted sum) per element is carried across the groups,
// rescaled where a group's max passes it, so the registers stay those of
// four modes.  Up to 16 modes a k tile is staged one mode at a time; past
// 16 (md 8 to 1 at a 256-wide site) every mode's k tile is staged at once,
// one barrier pair a k tile instead of two a mode.  It takes fp32 inputs at
// every NM, and bf16 at every NM but the four modes of the wgmma sweep, at
// any md (the tiles are loaded element by element).
// bf16 at four modes (corr_sweep, last below): the same sweep on wgmma, 128
// query rows a block, templated on its epilogue (B3's and B9's stats and
// normalised write, B6's raw fp32 volume) and its bias source (the window,
// none, a dense table).
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#define NMODES 4  // the wgmma sweep's modes, and the FMA bodies' group
#define KGROUP 8  // k tiles per block
#define NM_WIDE 0  // the FMA instance of the counts past 16 (run-time nm)

// The body an aggregating kernel runs (B3, B9, B6, B6 dense, B6 backward):
// the wgmma sweep for bf16 inputs at four modes up to md MAXMD, the FMA
// bodies otherwise (mirrored by mode_attention.py agg_mma_body).
__host__ __device__ constexpr bool agg_mma_body(int NM, int md, int in_bf16) {
  return mma_body(md, in_bf16) && NM == NMODES;
}

// The FMA bodies' mode dim stride in shared memory at NM modes (not
// NM_WIDE): 64 at four (MAXMD), up to 256 / NM, so that the NM q tiles take
// the bytes of four.  At NM_WIDE the stride is md itself.
template <int NM>
__host__ __device__ constexpr int agg_mds() {
  return MAXMD_FMA / NM;
}

// The columns of an FMA block's staged k tiles: one mode's, or at NM_WIDE
// every mode's (nm * md <= MAXMD_FMA).
template <int NM>
__host__ __device__ constexpr int agg_kcols() {
  if constexpr (NM == NM_WIDE)
    return MAXMD_FMA;
  else
    return agg_mds<NM>();
}

// The mode count of an FMA instance: NM, or the run-time nm at NM_WIDE.
template <int NM>
__device__ __forceinline__ int modes_of(int nm) {
  return NM == NM_WIDE ? nm : NM;
}

// Modes a group: all of them up to four, else four.
template <int NM>
__host__ __device__ constexpr int mode_group() {
  return NM != NM_WIDE && NM < NMODES ? NM : NMODES;
}

// Dynamic shared memory of an FMA block: the q tiles of all NM modes (256
// columns), the staged k tiles, and what the bias source takes.  The
// bias source's floats start at smem + agg_bias_off<NM>().
template <int NM>
__host__ __device__ constexpr int agg_bias_off() {
  return (MAXMD_FMA + agg_kcols<NM>()) * SPAD;
}
template <class Bias, int NM = NMODES>
constexpr size_t agg_smem() {
  return (agg_bias_off<NM>() + Bias::SMEM) * sizeof(float);
}

// Rows [row0, row0 + TILE) of nm row-major [U, md] matrices (mode m's at
// src + m U md) into dst as fp32, mode m's column d at dst[(m md + d) SPAD
// + r]; rows past U read as zero.  One strided pass over every mode's
// elements (NM_WIDE's q and k tiles).
template <typename T>
__device__ __forceinline__ void load_modes_t(float* dst, const T* src,
                                             int row0, int U, int md,
                                             int nm) {
  const int per = TILE * md;
  for (int e = threadIdx.x; e < nm * per; e += NTHREADS) {
    const int m = e / per, rem = e - m * per;
    const int r = rem / md, d = rem - r * md;
    const int row = row0 + r;
    dst[(m * md + d) * SPAD + r] =
        row < U ? to_f(src[((size_t)m * U + row) * md + d]) : 0.f;
  }
}

// NM_WIDE: k tile kt of all nm modes (kb is [nm, U2, md]) into ks between
// one barrier pair, the bias source's tile kt with it, then its columns.
template <typename T, class Bias>
__device__ __forceinline__ void stage_k_modes(float* ks,
                                              const T* __restrict__ kb,
                                              Bias& bias, int kt, int U2,
                                              int md, int nm) {
  __syncthreads();
  load_modes_t(ks, kb, kt * TILE, U2, md, nm);
  bias.load(kt);
  __syncthreads();
  bias.cols(kt);
}

// s[m] = q_m k_m^T (unscaled) over k tile kt, for the G modes of a group
// (their q tiles at qs + m * MDS * SPAD, their k rows [G, U2, md] at kb);
// with first, the bias source loads its tile kt with the group's first k
// tile.  The bias source sets up its columns after the products.
template <int G, int MDS, typename T, class Bias>
__device__ __forceinline__ void mode_score_tiles(float s[G][4][4],
                                                 const T* __restrict__ kb,
                                                 const float* qs, float* ks,
                                                 Bias& bias, int kt, int U2,
                                                 int md, bool first = true) {
#pragma unroll
  for (int m = 0; m < G; ++m) {
    __syncthreads();
    load_tile_t(ks, kb + (size_t)m * U2 * md, kt * TILE, U2, md);
    if (m == 0 && first) bias.load(kt);
    __syncthreads();
    score_tile(s[m], qs + m * MDS * SPAD, ks, md);
  }
  bias.cols(kt);
}

// s[m] = q_m k_m^T (unscaled) over k tile kt for the G modes of group gi
// of NM modes (kb is [NM, U2, md]).  At NM_WIDE the k tiles are staged
// already (stage_k_modes); otherwise this stages them, mode by mode.
template <int NM, int G, typename T, class Bias>
__device__ __forceinline__ void group_scores(float s[G][4][4],
                                             const T* __restrict__ kb,
                                             const float* qs, float* ks,
                                             Bias& bias, int kt, int U2,
                                             int md, int gi) {
  if constexpr (NM == NM_WIDE) {
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int col = (gi * G + m) * md * SPAD;
      score_tile(s[m], qs + col, ks + col, md);
    }
  } else {
    constexpr int MDS = agg_mds<NM>();
    mode_score_tiles<G, MDS>(s, kb + (size_t)gi * G * U2 * md,
                             qs + gi * G * MDS * SPAD, ks, bias, kt, U2, md,
                             gi == 0);
  }
}

// vol of one (q tile, k tile kt), as a 4x4 micro-tile per thread; kb is
// [NM, U2, md] (nm modes at NM_WIDE).
template <int NM, typename T, class Bias>
__device__ __forceinline__ void agg_tile(
    float vol[4][4], const T* __restrict__ kb, const float* qs, float* ks,
    Bias& bias, int kt, int U2, int md, int nm, float scale, float clip,
    float pos_w, float agg_w, float agg_b) {
  constexpr int G = mode_group<NM>();
  if constexpr (NM == G) {
    constexpr int MDS = agg_mds<NM>();
    float s[G][4][4];
    mode_score_tiles<G, MDS>(s, kb, qs, ks, bias, kt, U2, md);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float b = pos_w * bias.at(i, j);
        float x[G], lg[G];
#pragma unroll
        for (int m = 0; m < G; ++m) {
          x[m] = fminf(fmaxf(s[m][i][j] * scale, -clip), clip) + b;
          lg[m] = agg_w * x[m] + agg_b;
        }
        float mmax = lg[0];
#pragma unroll
        for (int m = 1; m < G; ++m) mmax = fmaxf(mmax, lg[m]);
        float denom = 0.f, acc = 0.f;
#pragma unroll
        for (int m = 0; m < G; ++m) {
          const float e = expf(lg[m] - mmax);
          denom += e;
          acc += e * x[m];
        }
        vol[i][j] = acc / denom;
      }
    }
  } else {
    // Groups of four modes, the softmax's (max, denominator, weighted
    // sum) carried across them.
    if constexpr (NM == NM_WIDE) stage_k_modes(ks, kb, bias, kt, U2, md, nm);
    float rmax[4][4], rden[4][4], racc[4][4];
#pragma unroll 1
    for (int gi = 0; gi < modes_of<NM>(nm) / G; ++gi) {
      float s[G][4][4];
      group_scores<NM, G>(s, kb, qs, ks, bias, kt, U2, md, gi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float b = pos_w * bias.at(i, j);
          float x[G], lg[G];
#pragma unroll
          for (int m = 0; m < G; ++m) {
            x[m] = fminf(fmaxf(s[m][i][j] * scale, -clip), clip) + b;
            lg[m] = agg_w * x[m] + agg_b;
          }
          float gmax = lg[0];
#pragma unroll
          for (int m = 1; m < G; ++m) gmax = fmaxf(gmax, lg[m]);
          const float mmax = gi == 0 ? gmax : fmaxf(rmax[i][j], gmax);
          const float a = gi == 0 ? 0.f : expf(rmax[i][j] - mmax);
          float denom = gi == 0 ? 0.f : rden[i][j] * a;
          float acc = gi == 0 ? 0.f : racc[i][j] * a;
#pragma unroll
          for (int m = 0; m < G; ++m) {
            const float e = expf(lg[m] - mmax);
            denom += e;
            acc += e * x[m];
          }
          rmax[i][j] = mmax;
          rden[i][j] = denom;
          racc[i][j] = acc;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) vol[i][j] = racc[i][j] / rden[i][j];
  }
}

// This block's q tiles (all NM modes, nm at NM_WIDE; qb is [NM, U1, md])
// and the bias source's set-up.  The caller's first __syncthreads (in
// mode_score_tiles or stage_k_modes) publishes them.
template <int NM, typename T, class Bias>
__device__ __forceinline__ void load_q_modes(const T* __restrict__ qb,
                                             float* qs, float* bsm,
                                             Bias& bias, const BiasArgs& ba,
                                             int qt, int U1, int md,
                                             int nm) {
  if constexpr (NM == NM_WIDE) {
    load_modes_t(qs, qb, qt * TILE, U1, md, nm);
  } else {
#pragma unroll
    for (int m = 0; m < NM; ++m)
      load_tile_t(qs + m * agg_mds<NM>() * SPAD, qb + (size_t)m * U1 * md,
                  qt * TILE, U1, md);
  }
  bias.init(bsm, ba, qt);
}

// The FMA bodies' mode counts, and whether NM modes of md take them.
__host__ __device__ constexpr bool fma_modes(int NM) {
  return NM == 1 || NM == 2 || NM == 4 || NM == 8 || NM == 16 || NM == 32 ||
         NM == 64 || NM == 128 || NM == 256;
}
static inline bool fma_takes(int NM, int md) {
  return fma_modes(NM) && md > 0 && NM * md <= MAXMD_FMA;
}

// The FMA launch of NM modes, as LAUNCH(NM) expands it: a template for 1,
// 2, 4, 8 and 16, NM_WIDE for 32 to 256 (fma_takes checked by the caller).
#define WITH_MODES(NM_, LAUNCH) \
  switch (NM_) {                \
    case 1: LAUNCH(1)           \
    case 2: LAUNCH(2)           \
    case 4: LAUNCH(4)           \
    case 8: LAUNCH(8)           \
    case 16: LAUNCH(16)         \
    default: LAUNCH(NM_WIDE)    \
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

// ---------------------------------------------------------------------------
// The bf16 body of the sweeps (B3 and B9: corr_norm.cu; B6 and B6 dense:
// agg_corr.cu)
// ---------------------------------------------------------------------------
#define B3_ROWS 128    // query rows a block (bf16): two warpgroups of 64
#define B3_KEYS 64     // keys a ring stage, in each of the four modes
#define B3_KGROUP 8    // key tiles a block
#define B3_STAGES 4    // ring depth
#define B3_TABLE_STAGES 2  // ring depth with a table tile in each stage
#define B3_THREADS 512  // four warpgroups: 2 row halves x 2 key halves

// The sweep's bias sources (wgmma.cuh): the window at any W8 (B3, B9, B6),
// none and a dense [U1, U2] table (B6 dense).
typedef MmaWindowT<B3_ROWS, B3_KEYS, B3_THREADS> CorrWindow;
typedef MmaTableT<B3_ROWS, B3_KEYS, B3_THREADS> CorrTable;

// Ring depth: a table tile (32 KB) in every stage leaves room for two.
template <class Bias>
__host__ __device__ constexpr int sweep_stages() {
  return Bias::STAGE ? B3_TABLE_STAGES : B3_STAGES;
}

// Dynamic shared memory of a sweep block: the four modes' q tiles, the ring
// (each stage: the four k tiles, the bias source's tile and two mbarriers),
// the bias source's own bytes, and 1024 so that the q tiles can start on a
// 1024-byte boundary.
template <int MDP, class Bias>
__host__ __device__ constexpr size_t sweep_smem() {
  return NMODES * B3_ROWS * MDP * 2 +
         sweep_stages<Bias>() *
             (NMODES * B3_KEYS * MDP * 2 + Bias::STAGE + 16) +
         Bias::SMEM + 1024;
}

// One sweep over the key tiles [grp * B3_KGROUP, +B3_KGROUP) of q tile qt
// of sample b (grid (q tiles, key groups, samples)).  Warpgroup w owns rows
// 64 (w % 2) .. + 63 of the tile and keys 32 (w / 2) .. + 31 of each key
// tile: four 64 x 32 accumulator sets (64 registers a thread), so that 16
// warps an SM hide the epilogue's latencies.  WRITE false (stats):
// partial[2 blk], partial[2 blk + 1] = the block's fp64 sums of vol and
// vol^2, blk = (b * gridDim.y + grp) * gridDim.x + qt.  WRITE true: out
// [B, U1, U2] = (vol - norm[2 b]) * norm[2 b + 1] as O, or with RAW (B6)
// vol itself.  RAW takes the clip as resolved (scal[0]; 1e30 when off),
// else the clip is attn_clip = scal[0] where the raw max gmax exceeds it.
// Bias: the bias source (CorrWindow, MmaNoBias, CorrTable).  MDP: the
// tiles' mode dim (16, 32 or 64 >= md; columns past md are zero).
//   The epilogue works in units of the raw products c = q.k: clamp(scale
// c, +-clip) = scale clamp(c, +-clip / scale) and the bias enters as
// pos_w / scale * w, so vol = scale * sum_m p_m x_m / sum_m p_m with x_m the
// unscaled s_m and p_m = 2^(x_m agg_w scale log2 e - max) (agg_b cancels in
// the softmax over the modes); the scale is applied once per sum (stats)
// or folded into the normalisation (write), or the store's factor (RAW).
template <int MDP, bool WRITE, bool RAW, typename O, class Bias>
__device__ __forceinline__ void corr_sweep(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const BiasArgs& ba,
    const float* __restrict__ scal, const float* __restrict__ gmax,
    const float* __restrict__ norm, O* __restrict__ out,
    double* __restrict__ partial, int md, float scale) {
  constexpr int KC = MDP / 8;                    // 16-byte chunks of a row
  constexpr int KTILE = B3_KEYS * MDP * 2;       // a mode's k tile
  constexpr int STAGES = sweep_stages<Bias>();
  constexpr int STAGE = NMODES * KTILE + Bias::STAGE;
  constexpr int QTILE = B3_ROWS * MDP * 2;       // a mode's q tile
  constexpr int WKEYS = B3_KEYS / 2;             // keys of a warpgroup
  constexpr int NT = WKEYS / 8;                  // its n tiles of 8 keys
  constexpr int NWG = B3_THREADS / 128;
  constexpr int PASS = B3_THREADS / KC;          // rows a pass of copies
  constexpr int QIT = PASS < B3_ROWS ? B3_ROWS / PASS : 1;
  constexpr int KIT = PASS < B3_KEYS ? B3_KEYS / PASS : 1;
  static_assert(QTILE % 1024 == 0 && KTILE % 1024 == 0 && STAGE % 1024 == 0,
                "swizzle atoms");
  static_assert(NWG == 4 && B3_ROWS == 128, "2 x 2 warpgroups");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* ring = smem + NMODES * QTILE;
  unsigned char* wsm = ring + STAGES * STAGE;
  const uint32_t full0 = smem_u32(wsm + Bias::SMEM);
  const uint32_t empty0 = full0 + 8 * STAGES;
  __shared__ double red[2][B3_THREADS / 32];
  const int qt = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int U1 = ba.U1, U2 = ba.U2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int wrow = 64 * (wg & 1), wkey = WKEYS * (wg >> 1);
  const bf16* qb = q + (size_t)b * NMODES * U1 * md;
  const bf16* kb = k + (size_t)b * NMODES * U2 * md;
  const int nk = (U2 + B3_KEYS - 1) / B3_KEYS;
  const int kt0 = grp * B3_KGROUP;
  const int n = min(nk, kt0 + B3_KGROUP) - kt0;  // >= 1

  Bias bias;
  bias.init(wsm, ba, qt);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, B3_THREADS);
      mbar_init(empty0 + 8 * i, B3_THREADS);
    }
  }
  __syncthreads();  // the barriers and the bias source

  // Each thread copies the same chunk column of rows PASS apart, q and k
  // alike (the swizzle repeats every 8 rows): offsets fixed here.
  const int c_r = threadIdx.x / KC, c_c = threadIdx.x % KC;
  const bool c_on = 8 * c_c < md;  // else zeros (md 48)
  const uint32_t c_dst = c_r * MDP * 2 + 16 * swz<KC>(c_r, c_c);
  const size_t c_src = (size_t)c_r * md + 8 * c_c;
  if (PASS <= B3_ROWS || c_r < B3_ROWS) {
    const uint32_t qa = smem_u32(smem) + c_dst;
    const int left = U1 - qt * B3_ROWS;
    const bf16* src = qb + (size_t)qt * B3_ROWS * md + c_src;
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int it = 0; it < QIT; ++it) {
        const bool ok = c_on && c_r + PASS * it < left;
        cp_async16(qa + m * QTILE + it * PASS * MDP * 2,
                   ok ? src + ((size_t)m * U1 + PASS * it) * md : qb, ok);
      }
  }
  auto load_stage = [&](int kt, int s) {
    bias.load(ring + s * STAGE + NMODES * KTILE, kt);
    if (PASS > B3_KEYS && c_r >= B3_KEYS) return;
    const uint32_t sa = smem_u32(ring + s * STAGE) + c_dst;
    const int left = min(U2 - kt * B3_KEYS, B3_KEYS);
    const bf16* src = kb + (size_t)kt * B3_KEYS * md + c_src;
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int it = 0; it < KIT; ++it) {
        const bool ok = c_on && c_r + PASS * it < left;
        cp_async16(sa + m * KTILE + it * PASS * MDP * 2,
                   ok ? src + ((size_t)m * U2 + PASS * it) * md : kb, ok);
      }
  };
  // The q tiles land with stage 0 (full[0] counts every earlier copy).
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) {
      load_stage(kt0 + i, i);
      mbar_arrive_copies(full0 + 8 * i);
    }
  }

  const float attn_clip = scal[0];
  const float bias_u = scal[1] / scale;            // pos_w / scale
  const float cws = scal[2] * scale * LOG2E;       // agg_w scale log2 e
  const float clip = RAW ? attn_clip
                         : gmax[0] > attn_clip ? attn_clip : 1e30f;
  const bool clip_on = clip < 1e30f;
  const float clip_u = clip / scale;
  float wa = 0.f, wb = 0.f;  // write: out = wa * (sum p x / sum p) + wb
  if (WRITE && RAW) {
    wa = scale;
  } else if (WRITE) {
    wa = scale * norm[2 * b + 1];
    wb = -norm[2 * b] * norm[2 * b + 1];
  }
  const int rt = wrow + 16 * (warp & 3) + g;  // tile rows rt, rt + 8
  const int r0 = qt * B3_ROWS + rt;
  const bool rows_all = r0 - g + 16 <= U1;  // warp-uniform
  const bool row_ok[2] = {r0 < U1, r0 + 8 < U1};
  const bool pairs = (U2 & 1) == 0;  // column pairs 4- or 8-byte aligned
  // Descriptors of mode 0's q rows of this warpgroup and of its keys in
  // stage 0; a tile adds its byte offset / 16 (the address field's unit).
  const uint64_t da0 = gmma_desc(smem_u32(smem) + wrow * MDP * 2, 16,
                                 KLayout<MDP>::SBO, KLayout<MDP>::TYPE);
  const uint64_t db0 = gmma_desc(smem_u32(ring) + wkey * MDP * 2, 16,
                                 KLayout<MDP>::SBO, KLayout<MDP>::TYPE);
  double dsum = 0.0, dsq = 0.0;

  float acc[NMODES][NT][4] = {};
  if (wg == NWG - 1) bar_arrive<256>(1);  // warpgroup 0 goes first
  for (int i = 0; i < n; ++i) {
    const int kt = kt0 + i, s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    fence_async_smem();
    const uint64_t db = db0 + (uint64_t)(s * STAGE / 16);
    // The warpgroups take turns to issue (named barriers 1 to 4, round
    // robin), so that the tensor cores finish one's products first.
    bar_sync<256>(1 + wg);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int kd = 0; kd < MDP / 16; ++kd)
        wgmma_ss32(acc[m], da0 + (m * QTILE + 32 * kd) / 16,
                   db + (m * KTILE + 32 * kd) / 16, kd);
    wgmma_commit();
    if (wg < NWG - 1 || i + 1 < n) bar_arrive<256>(1 + (wg + 1) % NWG);
    wgmma_wait0();
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[m][j][e]);
    // Done with stage s, unless its bias tile is still to be read.
    if constexpr (Bias::STAGE == 0) mbar_arrive(empty0 + 8 * s);

    // x_m = clamp(c_m, +-clip / scale) + pos_w / scale * bias, in place.
    if (clip_on) {
#pragma unroll
      for (int m = 0; m < NMODES; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][j][e] = fminf(fmaxf(acc[m][j][e], -clip_u), clip_u);
    }
    const int key0 = kt * B3_KEYS + wkey;
    bias.add_modes(acc, rt, key0, ring + s * STAGE + NMODES * KTILE, bias_u);
    if constexpr (Bias::STAGE != 0) mbar_arrive(empty0 + 8 * s);

    // vol / scale = sum_m p_m x_m / sum_m p_m, per element.
    const bool tile_all = rows_all && key0 + WKEYS <= U2;  // warp-uniform
    float tsum = 0.f, tsq = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l[NMODES];
#pragma unroll
        for (int m = 0; m < NMODES; ++m) l[m] = acc[m][j][e] * cws;
        const float lmax = fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3]));
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int m = 0; m < NMODES; ++m) {
          const float p = exp2_approx(l[m] - lmax);
          den += p;
          num = fmaf(p, acc[m][j][e], num);
        }
        v[e] = __fdividef(num, den);
      }
      const int col = key0 + 8 * j + 2 * t;
      if constexpr (!WRITE) {
        if (tile_all) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tsum += v[e];
            tsq = fmaf(v[e], v[e], tsq);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (row_ok[e >> 1] && col + (e & 1) < U2) {
              tsum += v[e];
              tsq = fmaf(v[e], v[e], tsq);
            }
        }
      } else {
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const float o0 = fmaf(v[2 * i2], wa, wb);
          const float o1 = fmaf(v[2 * i2 + 1], wa, wb);
          O* dst = out + ((size_t)b * U1 + r0 + 8 * i2) * U2 + col;
          if (tile_all && pairs) {
            if constexpr (sizeof(O) == 2) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
            } else {
              *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
            }
          } else if (row_ok[i2]) {
            if (col < U2) dst[0] = from_f<O>(o0);
            if (col + 1 < U2) dst[1] = from_f<O>(o1);
          }
        }
      }
    }
    if constexpr (!WRITE) {
      dsum += (double)tsum;
      dsq += (double)tsq;
    }

    // Key tile i + STAGES - 1 into the stage of tile i - 1, once every
    // warpgroup is done with that.
    if (i + STAGES - 1 < n) {
      const int sp = (i + STAGES - 1) % STAGES;
      if (i > 0) mbar_wait(empty0 + 8 * sp, ((i - 1) / STAGES) & 1);
      load_stage(kt + STAGES - 1, sp);
      mbar_arrive_copies(full0 + 8 * sp);
    }
  }
  if constexpr (!WRITE) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
      dsq += __shfl_xor_sync(0xffffffffu, dsq, o);
    }
    if (lane == 0) {
      red[0][warp] = dsum;
      red[1][warp] = dsq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < B3_THREADS / 32; ++w) {
        dsum += red[0][w];
        dsq += red[1][w];
      }
      const double sc = (double)scale;
      const size_t blk = ((size_t)b * gridDim.y + grp) * gridDim.x + qt;
      partial[2 * blk] = dsum * sc;
      partial[2 * blk + 1] = dsq * sc * sc;
    }
  }
}

// The sweeps' grid of the body that in_bf16 selects: (q tiles, key-tile
// groups, samples).
static dim3 sweep_grid(int B, int U1, int U2, int in_bf16) {
  if (in_bf16) {
    const int nk = (U2 + B3_KEYS - 1) / B3_KEYS;
    return dim3((U1 + B3_ROWS - 1) / B3_ROWS,
                (nk + B3_KGROUP - 1) / B3_KGROUP, B);
  }
  const int nq = (U1 + TILE - 1) / TILE, nk = (U2 + TILE - 1) / TILE;
  return dim3(nq, (nk + KGROUP - 1) / KGROUP, B);
}

// A sweep kernel's dynamic shared memory, with the carveout that lets a
// block have it.
template <class K>
static cudaError_t allow_sweep_smem(K kernel, size_t bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The bf16 body's inputs: md a multiple of 16 up to 64, q and k 16-byte
// aligned.
static bool sweep_takes(const void* q, const void* k, int md) {
  return md > 0 && md <= MAXMD && md % 16 == 0 &&
         (((uintptr_t)q | (uintptr_t)k) & 15) == 0;
}
