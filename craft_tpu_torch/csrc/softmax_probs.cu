// B4: two-phase blockwise softmax probabilities with a positional bias,
//   probs[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias),
// written once in the output type; fp32 scores never exist.  The bias is
// the sliding window (B4) or a dense [U1, U2] fp32 table or none (B4
// dense); one kernel body serves all three (a template over the bias
// source).
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:mode_softmax_probs_mt
// (bodies _probs_kernel_mt_q, quantized, and _probs_kernel_mt, float), the
// intra-frame attention site, and mode_softmax_probs (body _probs_kernel,
// float, dense table or none): the intra site under --intrapos lsinu, where
// the JAX package takes the XLA softmax and float probs in the compute
// dtype.  Quantized output: int8 num =
// rint(exp(s - rowmax) * 127) (round half to even, so every row's max is
// exactly 127) and an fp32 per-row scale 1 / (127 * l), probs = num * scale.
//
// Bound on the H100: bytes, and beside it the exponentials.  At the intra
// site (B=1, M=4, U=7040, md=32) the scores are 12.7 GFLOP (13 us at the
// bf16 peak; both sweeps do it) against a 198 MB int8 write (59 us of
// memory time); under lsinu the bf16 write is 396 MB (118 us).  Each
// sweep takes one exponential per score, 2 M U^2 = 396 M at serving: at
// 16 a clock per SM that is about 0.1 ms, a floor the bytes do not show.
// Two bodies:
//
// bf16 inputs (probs_wgmma_kernel, every output type and bias source): the
// products on the tensor cores, bf16 with fp32 sums.  A block is two
// warpgroups owning 128 query rows of one (b, mode), a warp 16 of them,
// whose q fragments stay in registers (the A operand); k tiles of 64 keys
// (the B operand) come through a 4-stage cp.async ring counted by
// mbarriers (2 stages with a table, whose 128 x 64 fp32 tile shares the
// stage), swizzled as wgmma.cuh's descriptors name.  The keys are split
// across blocks in chunks of B4_KCHUNK tiles, so both sweeps fill the card
// (serving: 4 modes x 7 chunks x 55 q tiles = 1540 blocks of 256 threads,
// against 220 of 128 rows, 1.67 waves), and the row statistics meet in
// scratch:
//   1. the stats sweep (OUT_STATS) keeps per thread and row the exact
//      running max of the biased scores and the sum of exp2 against a
//      reference max that moves only when a tile's max passes it by more
//      than B4_SLACK (log2 units), so the sum is rescaled on few tiles;
//      at the end the sum is moved onto the exact max, the four lanes of a
//      row are combined (two shuffles) and each (row, chunk) writes its
//      (max, sum) pair;
//   2. the write sweep combines a row's pairs over the chunks in a fixed
//      order (thread r of the block owns row r), so the max it subtracts
//      is the exact max of the scores that both sweeps compute with the
//      same instructions: every row's largest int8 numerator is 127.  The
//      int8 row scale is written by the blocks of chunk 0.
// The epilogue works in units of the raw products c = q.k: clamp(scale c,
// +-clip) = scale clamp(c, +-clip / scale), the bias enters as pos_w /
// scale * bias, and p = 2^(x scale log2 e - m') is one FFMA and one
// ex2.approx, where m' folds in the row max and, for int8, log2 127, for
// float outputs log2 l.  int8 numerators are rounded by adding 1.5 * 2^23
// (round half to even) and taking the float's low byte.  Each warp stages
// its 16 x 64 output tile in shared memory and writes 16-byte units that
// cover whole 32-byte sectors of the unpadded [B, M, U1, U2] output: where
// rows do not start on a sector (KITTI, U2 = 7332: int8 rows 4-byte
// aligned, bf16 rows 8-byte; chairs, U2 = 2852: bf16 rows 8-byte), each
// staged row stands as far into its staging row as the output row stands
// past its sector, and the bytes before the tile come over from the
// previous tile's staging (Staging); stores that left sectors part-written
// cost a third more.  The window is looked up only in the band of +-R grid
// rows around the warp's 16 queries, 8 keys at a time, from one window row
// where the keys and the queries each lie in one grid row.  The stats
// sweep and the int8 write hold 3 blocks an SM at md <= 32.  The wrapper
// raises unless md is a multiple of 16 (md 48 runs the 64-wide tiles with
// zero columns) and q, k and out are 16-byte aligned; the scratch is
// probs_partials(...) pairs (refused otherwise).
//
// fp32 inputs (probs_kernel, fp32 output): plain fp32 FMA, kept for fp32
// parity.  A block owns 64 query rows of one (b, m): sweep 1 keeps the
// running row max and sum in registers, sweep 2 recomputes the scores and
// writes each probability once.
#include "common.cuh"
#include "wgmma.cuh"

enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_INT8 = 2 };

template <typename T, int KIND, class Bias>
__global__ void __launch_bounds__(NTHREADS)
    probs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 BiasArgs ba, const float* __restrict__ clip_ptr,
                 void* __restrict__ out, float* __restrict__ row_scale,
                 int U1, int U2, int md, float scale, float pos_w) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD * SPAD;
  float* bsm = ks + MAXMD * SPAD;  // Bias::SMEM
  const int qt = blockIdx.x, bm = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qbase = (size_t)bm * U1, kbase = (size_t)bm * U2;
  load_tile_t(qs, q + qbase * md, qt * TILE, U1, md);
  Bias bias;
  bias.init(bsm, ba, qt);
  const float clip = clip_ptr[0];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
  }
  const int nk = (U2 + TILE - 1) / TILE;
  for (int phase = 0; phase < 2; ++phase) {
    for (int kt = 0; kt < nk; ++kt) {
      __syncthreads();
      load_tile_t(ks, k + kbase * md, kt * TILE, U2, md);
      bias.load(kt);
      __syncthreads();
      float s[4][4];
      score_tile(s, qs, ks, md);
      bias.cols(kt);
      bool kvalid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kvalid[j] = kt * TILE + tx + 16 * j < U2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = fminf(fmaxf(s[i][j] * scale, -clip), clip);
          x += pos_w * bias.at(i, j);
          s[i][j] = kvalid[j] ? x : NEG_INF;
        }
      }
      if (phase == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float tmax = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) tmax = fmaxf(tmax, s[i][j]);
          const float m_new = fmaxf(mrow[i], row_max16(tmax));
          float tsum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - m_new);
          lrow[i] = lrow[i] * expf(mrow[i] - m_new) + row_sum16(tsum);
          mrow[i] = m_new;
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qt * TILE + ty + 16 * i;
        if (row >= U1) continue;
        const size_t rbase = (qbase + row) * (size_t)U2 + kt * TILE + tx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!kvalid[j]) continue;
          const float e = expf(s[i][j] - mrow[i]);
          if (KIND == OUT_INT8)
            ((int8_t*)out)[rbase + 16 * j] = (int8_t)rintf(e * 127.f);
          else if (KIND == OUT_BF16)
            ((__nv_bfloat16*)out)[rbase + 16 * j] =
                __float2bfloat16_rn(e / lrow[i]);
          else
            ((float*)out)[rbase + 16 * j] = e / lrow[i];
        }
        if (KIND == OUT_INT8 && kt == 0 && tx == 0)
          row_scale[qbase + row] = 1.f / (127.f * lrow[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 body on the tensor cores
// ---------------------------------------------------------------------------

#define B4_ROWS 128    // query rows a block: two warpgroups of 64
#define B4_KEYS 64     // keys a ring stage
#define B4_KCHUNK 16   // key tiles a block: the split of the keys
#define B4_THREADS 256
#define B4_SLACK 8.f   // how far (log2) the stats sweep lets p exceed 1
#define LOG2_127 6.98868468677216585f

enum { OUT_STATS = 3 };  // the stats sweep of the bf16 body

typedef MmaWindowT<B4_ROWS, B4_KEYS, B4_THREADS> ProbsWindow;
typedef MmaTableT<B4_ROWS, B4_KEYS, B4_THREADS> ProbsTable;

template <class Bias>
__host__ __device__ constexpr int probs_stages() {
  return Bias::STAGE > 0 ? 2 : 4;
}

// A warp's staging tile: 16 rows x 64 keys of ES-byte outputs.  Row r
// stands m_r bytes into its row of RS bytes, m_r = the row's start in the
// output modulo 32 (0 where rows are not 4-byte aligned), so that 16-byte
// unit k of a staging row is the 16 bytes of the output from the sector
// before the row's start + 16 k: every unit goes out as one aligned store,
// and a row's units cover whole sectors.  Where m_r can be nonzero (two
// staging tiles a warp, in turn), units 0 and 1 first take the previous
// tile's last bytes (its units CPR and CPR + 1), the m_r bytes before this
// tile's start.  RS is one unit more than the CPR + 2 a row needs, which
// spreads the 8 rows of a fragment store over the banks.
template <int ES>
struct Staging {
  static constexpr int CPR = 4 * ES;           // 16-byte units of 64 keys
  static constexpr int RS = (CPR + 3) * 16;    // bytes a staging row
  static constexpr int BYTES = 16 * RS;
};

// Staging tiles a warp takes for rows of row_bytes: two where the rows
// start off the 32-byte sectors but on 4-byte words (shifted), else one.
__host__ __device__ __forceinline__ int staging_tiles(int row_bytes) {
  return (row_bytes & 31) != 0 && (row_bytes & 3) == 0 ? 2 : 1;
}

// 16 bytes at dst in pieces of vec bytes (2 or 1: the alignment that every
// row start has when U2 * ES is not a multiple of 4), the pieces from
// nvalid bytes on left out.
__device__ __forceinline__ void store_chunk(unsigned char* dst, uint4 v,
                                            int vec, int nvalid) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (vec == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < nvalid)
        *reinterpret_cast<uint16_t*>(dst + 2 * i) =
            (uint16_t)(w[i >> 1] >> (16 * (i & 1)));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nvalid) dst[i] = (unsigned char)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Blocks an SM is to hold, and so the registers a thread may take (255 at
// 1, 128 at 2, 80 at 3): the stats sweep and the int8 write at md <= 32
// fit 80 without spills, and 24 warps an SM hide more of their latencies;
// with a table (no model path takes one), fp32 output or md 64 keep 1 and
// take the registers they need.
template <int MDP, int KIND, class Bias>
__host__ __device__ constexpr int probs_min_blocks() {
  return Bias::STAGE > 0 && (KIND == OUT_F32 || MDP == 64) ? 1
         : (KIND == OUT_STATS || KIND == OUT_INT8) && MDP <= 32 ? 3
                                                                 : 2;
}

template <int MDP, int KIND, class Bias>
__global__ void
__launch_bounds__(B4_THREADS, probs_min_blocks<MDP, KIND, Bias>())
    probs_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       BiasArgs ba, const float* __restrict__ clip_ptr,
                       float2* __restrict__ partial, void* __restrict__ out,
                       float* __restrict__ row_scale, int md, float scale,
                       float pos_w) {
  constexpr bool STATS = KIND == OUT_STATS;
  constexpr int ES = KIND == OUT_F32 ? 4 : KIND == OUT_BF16 ? 2 : 1;
  typedef Staging<ES> Stg;
  constexpr int KC = MDP / 8;  // 16-byte chunks of a k row
  constexpr int K_BYTES = B4_KEYS * MDP * 2;
  constexpr int STAGE = K_BYTES + Bias::STAGE;
  constexpr int NST = probs_stages<Bias>();
  constexpr int NT = B4_KEYS / 8;  // n tiles of 8 keys
  const int stg_bytes =
      STATS ? 0 : staging_tiles(ba.U2 * ES) * (B4_THREADS / 32) * Stg::BYTES;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle atoms");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* stg = smem + NST * STAGE;
  unsigned char* bsm = stg + stg_bytes;
  float* rowc = reinterpret_cast<float*>(bsm + Bias::SMEM);  // [B4_ROWS]
  const uint32_t full0 = smem_u32(rowc + B4_ROWS);
  const int bm = blockIdx.x, chunk = blockIdx.y, qt = blockIdx.z;
  const int U1 = ba.U1, U2 = ba.U2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bm * U1 * md;
  const bf16* kb = k + (size_t)bm * U2 * md;
  const int nk = (U2 + B4_KEYS - 1) / B4_KEYS;
  const int nch = gridDim.y;
  const int kt0 = chunk * B4_KCHUNK;
  const int n = min(nk, kt0 + B4_KCHUNK) - kt0;  // >= 1
  const float sl = scale * LOG2E;

  Bias bias;
  bias.init(bsm, ba, qt);
  if (threadIdx.x == 0)
    for (int i = 0; i < NST; ++i) mbar_init(full0 + 8 * i, B4_THREADS);
  if (!STATS && threadIdx.x < B4_ROWS) {
    // Row r's max and sum over every chunk, in chunk order.
    const int r = threadIdx.x, row = qt * B4_ROWS + r;
    const float2* pp =
        partial + ((size_t)bm * gridDim.z + qt) * nch * B4_ROWS + r;
    float m = NEG_INF;
    for (int c = 0; c < nch; ++c) m = fmaxf(m, pp[(size_t)c * B4_ROWS].x);
    float l = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float2 v = pp[(size_t)c * B4_ROWS];
      l += v.y * exp2_approx((v.x - m) * sl);
    }
    // p = 2^(x sl + c): 127 e for int8, e / l for float outputs.
    rowc[r] = KIND == OUT_INT8 ? fmaf(-m, sl, LOG2_127)
                               : fmaf(-m, sl, -__log2f(l));
    if (KIND == OUT_INT8 && chunk == 0 && row < U1)
      row_scale[(size_t)bm * U1 + row] = 1.f / (127.f * l);
  }
  __syncthreads();  // the barriers, the bias source's and the rows' smem

  // Each thread copies the same chunk column of k rows KROWS apart: its
  // offsets are fixed here (the swizzle repeats every 8 rows).
  constexpr int KROWS = B4_THREADS / KC;
  constexpr int KIT = (B4_KEYS + KROWS - 1) / KROWS;
  const int k_r = threadIdx.x / KC, k_c = threadIdx.x % KC;
  const bool k_on = k_r < B4_KEYS && 8 * k_c < md;  // else zeros (md 48)
  const bf16* k_src = k_on ? kb + (size_t)k_r * md + 8 * k_c : kb;
  const uint32_t k_dst = k_r * MDP * 2 + 16 * swz<KC>(k_r, k_c);
  auto load_stage = [&](int kt, int s) {
    unsigned char* st = smem + s * STAGE;
    const uint32_t sa = smem_u32(st);
    const int key0 = kt * B4_KEYS, left = min(U2 - key0, B4_KEYS);
#pragma unroll
    for (int it = 0; it < KIT; ++it) {
      const bool ok = k_on && k_r + KROWS * it < left;
      if (KROWS <= B4_KEYS || k_r < B4_KEYS)  // MDP 16: threads 0..127
        cp_async16(sa + k_dst + it * KROWS * MDP * 2,
                   ok ? k_src + (size_t)(key0 + KROWS * it) * md : kb, ok);
    }
    bias.load(st + K_BYTES, kt);
  };
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    if (i < n) {
      load_stage(kt0 + i, i);
      mbar_arrive_copies(full0 + 8 * i);
    }
  }

  // q fragments (A of wgmma) of rows r0 = qt * B4_ROWS + warp * 16 + g and
  // r0 + 8: a0 (r0, 2t..2t+1), a1 (r0 + 8, 2t..), a2 (r0, 2t + 8..), a3
  // (r0 + 8, 2t + 8..) of each 16-wide slice.
  const int r0 = qt * B4_ROWS + warp * 16 + g;
  uint32_t qa[MDP / 16][4];
#pragma unroll
  for (int kd = 0; kd < MDP / 16; ++kd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), col = 16 * kd + 8 * (e >> 1) + 2 * t;
      qa[kd][e] = row < U1 && col < md
                      ? *reinterpret_cast<const uint32_t*>(
                            qb + (size_t)row * md + col)
                      : 0u;
    }
  const float clip = clip_ptr[0];
  const bool clip_on = clip < 1e30f;
  const float clip_u = clip / scale, bias_u = pos_w / scale;
  const float slack_u = B4_SLACK / sl;

  // Stats: per row i of the thread, the exact running max, the reference
  // max the sum is taken against (and -reference * sl), and the sum.  Until
  // a row meets a key, its reference is -inf and nml 0, so the masked keys
  // of a ragged tile add 2^(-huge) = 0.
  float mex[2] = {NEG_INF, NEG_INF}, mref[2] = {NEG_INF, NEG_INF};
  float nml[2] = {0.f, 0.f}, lsum[2] = {0.f, 0.f};
  // Write: the exponent offsets of the thread's rows.
  float cx[2] = {0.f, 0.f};
  if (!STATS) {
    cx[0] = rowc[warp * 16 + g];
    cx[1] = rowc[warp * 16 + g + 8];
  }
  const bool rows_all = qt * B4_ROWS + warp * 16 + 16 <= U1;  // warp-uniform
  // The keys of the warp's band of +-R grid rows, and whether its 16
  // queries lie in one grid row (the window only).
  int band_lo = 0, band_hi = 0;
  bool one_row = false;
  if constexpr (Bias::SMEM > 0) {
    band_lo = (bias.qh_lo - ba.R) * ba.W8;
    band_hi = (bias.qh_hi + ba.R + 1) * ba.W8;
    one_row = bias.qh_lo == bias.qh_hi;
  }
  const uint64_t db0 = gmma_desc(smem_u32(smem), 16, KLayout<MDP>::SBO,
                                 KLayout<MDP>::TYPE);
  // The output's row starts share the alignment of U2 * ES bytes.
  const int vec = STATS ? 16 : min(16, (U2 * ES) & -(U2 * ES));

  // Whether rows start off the 32-byte sectors (then each warp stages two
  // tiles in turn, for the bytes the previous one carries over), and where
  // the thread's fragment rows stand in their staging rows.
  const int nbuf = STATS ? 1 : staging_tiles(U2 * ES);
  const bool shifted = nbuf == 2;
  int mst[2] = {0, 0};
  if (!STATS && shifted) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mst[r] = (int)(((size_t)bm * U1 + r0 + 8 * r) * U2 * ES & 31);
  }

  float sc[NT][4] = {};
  for (int i = 0; i < n; ++i) {
    const int kt = kt0 + i, s = i % NST;
    unsigned char* st = smem + s * STAGE;
    mbar_wait(full0 + 8 * s, (i / NST) & 1);
    fence_async_smem();
    const uint64_t db = db0 + (uint64_t)(s * STAGE / 16);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < MDP / 16; ++kd) wgmma_s(sc, qa[kd], db + 2 * kd, kd);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(sc[j][e]);

    // x = clamp(c, +-clip / scale) + pos_w / scale * bias, in place.
    if (clip_on) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = fminf(fmaxf(sc[j][e], -clip_u), clip_u);
    }
    const int key0 = kt * B4_KEYS;
    if constexpr (Bias::STAGE > 0) {
      bias.add(sc, kt, st + K_BYTES, bias_u);
    } else if constexpr (Bias::SMEM > 0) {  // the window
      // Two compares drop the tiles outside the warp's band of +-R grid
      // rows.  Inside it, where the warp's 16 queries lie in one grid row,
      // an 8-key block in one grid row takes one window row: the entry of
      // the thread's row i and column c is wrow[base + 2 t - g - 8 i + c],
      // base = the block's first key column - the warp's first query
      // column + R, and a block whose entries all fall outside [0, 2R] is
      // skipped (warp-uniform tests).  A tile in one grid row does this
      // with one window row and no stepping; other blocks (the grid row
      // changes inside them, or the warp's does) look each entry up
      // (col_bias).
      if (key0 < band_hi && key0 + B4_KEYS > band_lo) {
        const int W8 = ba.W8, R = ba.R, side = 2 * R + 1;
        const int t_d = 2 * t - g;
        int bh = key0 / W8, bw = key0 - bh * W8;
        if (one_row && bw + B4_KEYS <= W8) {
          const int dh = bh - bias.qh_lo + R;
          if ((unsigned)dh <= (unsigned)(2 * R)) {
            const float* wrow = bias.win + dh * side;
            const int base = bw - bias.qw_lo + R;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (base + 8 * j + 7 >= 0 && base + 8 * j - 15 <= 2 * R) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int idx = base + 8 * j + t_d - 8 * (e >> 1) + (e & 1);
                  if ((unsigned)idx <= (unsigned)(2 * R))
                    sc[j][e] = __fmaf_rn(bias_u, wrow[idx], sc[j][e]);
                }
              }
            }
          }
        } else {
          int kh, kw;
          bias.first_col(key0, kh, kw);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int dh = bh - bias.qh_lo + R;
            const int base = bw - bias.qw_lo + R;
            if (one_row && bw + 7 < W8) {
              if ((unsigned)dh <= (unsigned)(2 * R) && base + 7 >= 0 &&
                  base - 15 <= 2 * R) {
                const float* wrow = bias.win + dh * side;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int idx = base + t_d - 8 * (e >> 1) + (e & 1);
                  if ((unsigned)idx <= (unsigned)(2 * R))
                    sc[j][e] = __fmaf_rn(bias_u, wrow[idx], sc[j][e]);
                }
              }
              kw += 8;
              while (kw >= W8) {
                kw -= W8;
                ++kh;
              }
            } else {
              float bj[4];
              bias.col_bias(kh, kw, bias_u, bj);
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] += bj[e];
            }
            bw += 8;
            while (bw >= W8) {
              bw -= W8;
              ++bh;
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (i + NST < n) {
      load_stage(kt + NST, s);
      mbar_arrive_copies(full0 + 8 * s);
    }
    const bool ragged = key0 + B4_KEYS > U2;  // block-uniform

    if constexpr (STATS) {
      if (ragged) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * j + 2 * t + (e & 1) >= U2) sc[j][e] = NEG_INF;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mex[r] = fmaxf(mex[r], mx);
        if (mx > mref[r] + slack_u) {
          lsum[r] *= exp2_approx((mref[r] - mx) * sl);
          mref[r] = mx;
          nml[r] = -mx * sl;
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sum += exp2_approx(fmaf(sc[j][2 * r + c], sl, nml[r]));
        lsum[r] += sum;
      }
    } else {
      // The previous tile's last bytes, then this tile's fragments into
      // this warp's staging tile (two in turn), then whole units out.
      unsigned char* ws =
          stg + (nbuf * warp + (shifted ? i & 1 : 0)) * Stg::BYTES;
      const unsigned char* wp =
          stg + (nbuf * warp + (shifted ? ~i & 1 : 0)) * Stg::BYTES;
      if (shifted && i > 0) {
        const int off = (lane >> 1) * Stg::RS + 16 * (lane & 1);
        *reinterpret_cast<uint4*>(ws + off) =
            *reinterpret_cast<const uint4*>(wp + off + 16 * Stg::CPR);
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2_approx(fmaf(sc[j][2 * r], sl, cx[r]));
          const float p1 = exp2_approx(fmaf(sc[j][2 * r + 1], sl, cx[r]));
          unsigned char* d = ws + (g + 8 * r) * Stg::RS + mst[r] +
                             (8 * j + 2 * t) * ES;
          if constexpr (KIND == OUT_INT8) {
            // rint by the magic 1.5 * 2^23 (half to even): the low byte.
            const uint32_t b0 = __float_as_uint(p0 + 12582912.f);
            const uint32_t b1 = __float_as_uint(p1 + 12582912.f);
            *reinterpret_cast<uint16_t*>(d) =
                (uint16_t)__byte_perm(b0, b1, 0x0040);
          } else if constexpr (KIND == OUT_BF16) {
            *reinterpret_cast<uint32_t*>(d) = pack_bf16(p0, p1);
          } else if (mst[r] & 7) {
            reinterpret_cast<float*>(d)[0] = p0;
            reinterpret_cast<float*>(d)[1] = p1;
          } else {
            *reinterpret_cast<float2*>(d) = make_float2(p0, p1);
          }
        }
      __syncwarp();
      // Unit k of row rr holds tile bytes 16 k - m .. + 15: written whole
      // unless it reaches before the block's first tile or past the
      // row's valid bytes nb (word by word then; where rows are not
      // 4-byte aligned, m = 0 and every unit goes byte by byte).  The
      // block's last tile also writes units CPR and CPR + 1, its last m
      // bytes.
      constexpr int RPP = 32 / Stg::CPR;  // rows a pass of the warp writes
      const int nb = min(U2 - key0, B4_KEYS) * ES;
      unsigned char* ob = reinterpret_cast<unsigned char*>(out);
      auto put = [&](int rr, int k) {
        const int row = qt * B4_ROWS + warp * 16 + rr;
        const uint4 v = *reinterpret_cast<const uint4*>(ws + rr * Stg::RS +
                                                        16 * k);
        if (!rows_all && row >= U1) return;
        const size_t a = (((size_t)bm * U1 + row) * U2 + key0) * ES;
        const int m = shifted ? (int)(a & 31) : 0;
        unsigned char* dst = ob + a - m + 16 * k;
        const int b0 = 16 * k - m;  // tile byte of the unit's first byte
        if (vec >= 4 && (b0 >= 0 || i > 0) && b0 + 16 <= nb) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else if (vec >= 4) {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((b0 + 4 * e >= 0 || i > 0) && b0 + 4 * e < nb)
              reinterpret_cast<uint32_t*>(dst)[e] = w[e];
        } else if (nb - b0 > 0) {
          store_chunk(dst, v, vec, nb - b0);
        }
      };
#pragma unroll
      for (int pass = 0; pass < 16 / RPP; ++pass)
        put(lane / Stg::CPR + RPP * pass, lane % Stg::CPR);
      if (shifted && i == n - 1) put(lane >> 1, Stg::CPR + (lane & 1));
      __syncwarp();  // the tile is read before the next one is staged
    }
  }

  if constexpr (STATS) {
    // Each row onto its exact max, then the quad's four lanes combined.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = mex[r];
      float l = lsum[r] * exp2_approx((mref[r] - m) * sl);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, off);
        const float lo = __shfl_xor_sync(0xffffffffu, l, off);
        const float mn = fmaxf(m, mo);
        l = l * exp2_approx((m - mn) * sl) + lo * exp2_approx((mo - mn) * sl);
        m = mn;
      }
      if (t == 0)
        partial[(((size_t)bm * gridDim.z + qt) * nch + chunk) * B4_ROWS +
                warp * 16 + g + 8 * r] = make_float2(m, l);
    }
  }
}

// The (max, sum) pairs of a bf16 launch: one per (b * M, q tile, key
// chunk, row of the tile); 0 for fp32 (tests/test_torch_kernel_grids.py
// holds the wrapper's count against this).
static int probs_partials(int BM, int U1, int U2, int in_bf16) {
  if (!in_bf16) return 0;
  const int nk = (U2 + B4_KEYS - 1) / B4_KEYS;
  return BM * ((U1 + B4_ROWS - 1) / B4_ROWS) *
         ((nk + B4_KCHUNK - 1) / B4_KCHUNK) * B4_ROWS;
}

template <int MDP, int KIND, class Bias>
static cudaError_t launch_sweep(const void* q, const void* k,
                                const BiasArgs& ba, const void* clip,
                                void* partial, void* out, void* row_scale,
                                int BM, int md, float scale, float pos_w,
                                cudaStream_t s) {
  constexpr int ES = KIND == OUT_F32 ? 4 : KIND == OUT_BF16 ? 2 : 1;
  const int stg_bytes = KIND == OUT_STATS ? 0
                                          : staging_tiles(ba.U2 * ES) *
                                                (B4_THREADS / 32) *
                                                Staging<ES>::BYTES;
  constexpr int NST = probs_stages<Bias>();
  // + 1024: the ring starts at the first 1024-byte boundary.
  const size_t smem = NST * (B4_KEYS * MDP * 2 + Bias::STAGE) + stg_bytes +
                      Bias::SMEM + B4_ROWS * 4 + 8 * NST + 1024;
  auto kernel = probs_wgmma_kernel<MDP, KIND, Bias>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nk = (ba.U2 + B4_KEYS - 1) / B4_KEYS;
  dim3 grid(BM, (nk + B4_KCHUNK - 1) / B4_KCHUNK,
            (ba.U1 + B4_ROWS - 1) / B4_ROWS);
  kernel<<<grid, B4_THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, ba, (const float*)clip,
      (float2*)partial, out, (float*)row_scale, md, scale, pos_w);
  return cudaGetLastError();
}

// The stats sweep, then the write sweep of output KIND.
template <int MDP, int KIND, class Bias>
static cudaError_t launch_md(const void* q, const void* k,
                             const BiasArgs& ba, const void* clip,
                             void* partial, void* out, void* row_scale,
                             int BM, int md, float scale, float pos_w,
                             cudaStream_t s) {
  cudaError_t err = launch_sweep<MDP, OUT_STATS, Bias>(
      q, k, ba, clip, partial, nullptr, nullptr, BM, md, scale, pos_w, s);
  if (err != cudaSuccess) return err;
  return launch_sweep<MDP, KIND, Bias>(q, k, ba, clip, partial, out,
                                       row_scale, BM, md, scale, pos_w, s);
}

// md a multiple of 16 up to 64, q, k and out 16-byte aligned.
template <int KIND, class Bias>
static int launch_wgmma(const void* q, const void* k, const BiasArgs& ba,
                        const void* clip, void* partial, void* out,
                        void* row_scale, int BM, int md, float scale,
                        float pos_w, cudaStream_t s) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)out;
  if (md <= 0 || md > MAXMD || md % 16 != 0 || (align & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (md <= 16)
    return (int)launch_md<16, KIND, Bias>(q, k, ba, clip, partial, out,
                                          row_scale, BM, md, scale, pos_w, s);
  if (md <= 32)
    return (int)launch_md<32, KIND, Bias>(q, k, ba, clip, partial, out,
                                          row_scale, BM, md, scale, pos_w, s);
  return (int)launch_md<64, KIND, Bias>(q, k, ba, clip, partial, out,
                                        row_scale, BM, md, scale, pos_w, s);
}

// ---------------------------------------------------------------------------
// The fp32 body's launch and the C interface
// ---------------------------------------------------------------------------

template <class Bias>
static int launch_fp32(const void* q, const void* k, const BiasArgs& ba,
                       const void* clip, void* out, int BM, int U1, int U2,
                       int md, float scale, float pos_w, cudaStream_t s) {
  const size_t smem = (2 * MAXMD * SPAD + Bias::SMEM) * sizeof(float);
  cudaError_t err = allow_smem(probs_kernel<float, OUT_F32, Bias>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  probs_kernel<float, OUT_F32, Bias><<<grid, NTHREADS, smem, s>>>(
      (const float*)q, (const float*)k, ba, (const float*)clip, out,
      nullptr, U1, U2, md, scale, pos_w);
  return (int)cudaGetLastError();
}

// B4.  q: [BM, U1, md], k: [BM, U2, md] contiguous (bf16 when in_bf16,
// else fp32), md <= 64 (bf16: a multiple of 16, q, k and out 16-byte
// aligned); the queries are the grid's tokens q_tok0 .. q_tok0 + U1 - 1 (a
// row shard; 0 and U1 = U2 for the whole grid), the keys all U2 = H8 * W8
// tokens; out: [BM, U1, U2] of out_kind (0 fp32, 1 bf16, 2 int8);
// row_scale: [BM, U1] fp32 (written for int8 only); biases: [(2R+1)^2]
// fp32; clip: [1] fp32; partial: n_partial = probs_partials(BM, U1, U2,
// in_bf16) fp32 pairs of scratch (refused otherwise; null and 0 for
// fp32).  bf16 inputs take every out_kind; fp32 inputs only fp32.
extern "C" int probs_launch(const void* q, const void* k, const void* biases,
                            const void* clip, void* partial, int n_partial,
                            void* out, void* row_scale, int BM, int U1,
                            int U2, int q_tok0, int md, int W8, int R,
                            float scale, float pos_w, int in_bf16,
                            int out_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_partial != probs_partials(BM, U1, U2, in_bf16))
    return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  if (!in_bf16)
    return out_kind == OUT_F32
               ? launch_fp32<WindowBias>(q, k, ba, clip, out, BM, U1, U2, md,
                                         scale, pos_w, s)
               : (int)cudaErrorInvalidValue;
#define CASE(KIND)                                                          \
  return launch_wgmma<KIND, ProbsWindow>(q, k, ba, clip, partial, out,      \
                                         row_scale, BM, md, scale, pos_w, s);
  if (out_kind == OUT_F32) CASE(OUT_F32)
  if (out_kind == OUT_BF16) CASE(OUT_BF16)
  if (out_kind == OUT_INT8) CASE(OUT_INT8)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// B4 dense.  q: [BM, U1, md]; k: [BM, U2, md] contiguous (bf16 when
// in_bf16, else fp32), md <= 64 (bf16: as B4); out: [BM, U1, U2] of
// out_kind (0 fp32, 1 bf16); table: [U1, U2] fp32, or null for no bias;
// clip: [1] fp32; partial as B4.  bf16 inputs take both out_kinds, fp32
// inputs fp32 only.
extern "C" int probs_dense_launch(const void* q, const void* k,
                                  const void* table, const void* clip,
                                  void* partial, int n_partial, void* out,
                                  int BM, int U1, int U2, int md, float scale,
                                  float pos_w, int in_bf16, int out_kind,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_partial != probs_partials(BM, U1, U2, in_bf16))
    return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
  if (!in_bf16) {
    if (out_kind != OUT_F32) return (int)cudaErrorInvalidValue;
    return table ? launch_fp32<TableBias>(q, k, ba, clip, out, BM, U1, U2,
                                          md, scale, pos_w, s)
                 : launch_fp32<NoBias>(q, k, ba, clip, out, BM, U1, U2, md,
                                       scale, pos_w, s);
  }
#define CASE(KIND)                                                          \
  return table ? launch_wgmma<KIND, ProbsTable>(q, k, ba, clip, partial,   \
                                                out, nullptr, BM, md,      \
                                                scale, pos_w, s)           \
               : launch_wgmma<KIND, MmaNoBias>(q, k, ba, clip, partial,    \
                                               out, nullptr, BM, md,       \
                                               scale, pos_w, s);
  if (out_kind == OUT_F32) CASE(OUT_F32)
  if (out_kind == OUT_BF16) CASE(OUT_BF16)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
