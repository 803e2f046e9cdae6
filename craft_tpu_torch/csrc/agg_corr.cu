// B6: the raw aggregated inter-frame volume and its backward, the
// training-side counterpart of B3:
//   c_m = scale * q_m k_m^T,  s_m = clamp(c_m, +-clip) + pos_w * bias
//   p   = softmax_m(agg_w * s_m + agg_b),  vol = sum_m p_m s_m   (fp32)
// Backward, from the volume's cotangent g and the saved vol:
//   t_m  = p_m * (1 + agg_w * (s_m - vol))
//   dc_m = g * t_m * 1[|c_m| < clip]                       (fp32 [B,M,U,U])
//   da   = sum g * sum_m p_m s_m (s_m - vol)               (the agg_w grad)
// agg_b cancels in the mode softmax, so its gradient is 0 and the backward
// leaves it out.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:fused_agg_corr_mt
// (forward, the window at any W8), fused_agg_corr (forward, B6 dense: a
// dense [U1, U2] fp32 table or none, the inter site under --interpos lsinu)
// and craft_tpu/ops/pallas/corr_vjp.py:_pallas_agg_corr_bwd (backward,
// window).
//
// Bound on the H100: bytes.  At the chairs crops (B=8, M=4, U=46*62=2852,
// md=64) one q.k^T sweep is 33 GFLOP (34 us at the bf16 peak) and 4 B U^2
// = 260 M exponentials (62 us on the SFUs) while the forward writes a 260
// MB fp32 volume (78 us); the backward reads g and vol (520 MB) and writes
// a 1.04 GB dc (0.47 ms).  At serving under lsinu (B=1, U=7040) the
// forward writes a 198 MB volume (59 us) against 25 GFLOP (26 us) and 198
// M exponentials (47 us).  Each block recomputes the four mode scores of
// its tiles in registers and touches each volume-sized element once.
//
// The forward's bf16 body (agg_corr_wgmma_kernel) is B3's write sweep
// (agg_modes.cuh corr_sweep) with the raw epilogue: the clip as resolved
// (scal[0]), no normalisation, fp32 stores of column pairs from the
// fragments (B3's layout: 128 rows a block, four warpgroups of 64 rows x
// 32 keys, every mode's scores of an element in one thread, the softmax
// over the modes on ex2.approx).  Its bias source is a template: the window
// at any W8 (B6), none or a dense table (B6 dense), the table's 128 x 64
// fp32 tile copied into each ring stage beside the k tiles (a two-stage
// ring: four would need 320 KB).  At chairs 23 q tiles x 6 key groups x 8
// samples = 1104 blocks, one an SM.
//
// The backward's bf16 body (agg_bwd_wgmma_kernel): the four mode scores on
// wgmma, B3's sweep rearranged for the traffic of the backward: 64-row
// blocks whose four warpgroups sit side by side along the keys, so that
// the four modes' q tiles take 32 KB and a ring stage has room for the
// tile's g and vol rows beside its k tiles (they arrive by cp.async with
// the products' operands instead of as register loads behind them), and dc
// leaves through a staging tile in whole 16-byte units along 256-byte
// rows.  At chairs it takes 0.911 ms, 1.091 with dc stored from the
// fragments (tools/time_bwd_variants.py, NVIDIA H100 80GB HBM3, 700 W); 45
// q tiles x 5 key groups x 8 samples = 1800 blocks of 512 threads, one an
// SM.  da is a fp64 per-block partial, summed by one block in a fixed
// order: no float atomics, deterministic.
//
// The wgmma bodies take md a multiple of 16 and q and k 16-byte aligned.
// fp32 inputs, and bf16 inputs at a mode count other than four, take the
// FMA bodies (agg_corr_kernel, agg_corr_bwd_kernel below; agg_modes.cuh's
// FMA tiles), templates over the mode count NM (1, 2, 4, 8, 16, and
// NM_WIDE for 32 to 256 as a run-time count; NM md <= 256, any md): a
// simple kernel that is right at those counts, at the FMA rate.
#include "agg_modes.cuh"

// The FMA forward: NM modes (nm at NM_WIDE) of input type T (fp32 at every
// NM; bf16 where the wgmma sweep does not take it).
template <int NM, typename T, class Bias>
__global__ void __launch_bounds__(NTHREADS)
    agg_corr_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    BiasArgs ba, const float* __restrict__ scal,
                    float* __restrict__ out, int U1, int U2, int md, int nm,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD_FMA * SPAD;
  float* bsm = smem + agg_bias_off<NM>();
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t nmodes = modes_of<NM>(nm);
  Bias bias;
  load_q_modes<NM>(q + (size_t)b * nmodes * U1 * md, qs, bsm, bias, ba, qt,
                   U1, md, nm);
  const T* kb = k + (size_t)b * nmodes * U2 * md;
  const float clip = scal[0], pos_w = scal[1], agg_w = scal[2],
              agg_b = scal[3];
  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile<NM>(vol, kb, qs, ks, bias, kt, U2, md, nm, scale, clip, pos_w,
                 agg_w, agg_b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * TILE + ty + 16 * i;
      if (row >= U1) continue;
      float* orow = out + ((size_t)b * U1 + row) * U2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col < U2) orow[col] = vol[i][j];
      }
    }
  }
}

// The bf16 forward: agg_modes.cuh's sweep with the raw epilogue, over the
// bias source Bias (CorrWindow, MmaNoBias, CorrTable).
template <int MDP, class Bias>
__global__ void __launch_bounds__(B3_THREADS, 1)
    agg_corr_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k, BiasArgs ba,
                          const float* __restrict__ scal,
                          float* __restrict__ out, int md, float scale) {
  corr_sweep<MDP, true, true, float, Bias>(q, k, ba, scal, nullptr, nullptr,
                                           out, nullptr, md, scale);
}

// The FMA backward: NM modes (nm at NM_WIDE) of input type T.  With one
// group of modes (NM <= 4) each element's mode softmax comes from its
// scores at once; with more, a first pass over the groups carries the
// softmax's running (max, denominator) and a second recomputes each
// group's scores for its dc planes (twice the products, the registers of
// four modes; at NM_WIDE both passes read the k tiles staged once).
template <int NM, typename T>
__global__ void __launch_bounds__(NTHREADS)
    agg_corr_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const float* __restrict__ g,
                        const float* __restrict__ vol,
                        const float* __restrict__ biases,
                        const float* __restrict__ scal,
                        float* __restrict__ dc, double* __restrict__ partial,
                        int U, int md, int nm, int W8, int R, float scale) {
  constexpr int G = mode_group<NM>();
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD_FMA * SPAD;
  float* win = smem + agg_bias_off<NM>();
  __shared__ double red[NTHREADS / 32];
  const int qt = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t nmodes = modes_of<NM>(nm);
  const size_t off = (size_t)b * nmodes * U * md;
  const size_t plane = (size_t)U * U;
  WindowBias wb;
  load_q_modes<NM>(q + off, qs, win, wb, BiasArgs{biases, W8, R, U, U, 0},
                   qt, U, md, nm);
  const float clip = scal[0], pos_w = scal[1], agg_w = scal[2];
  const int nk = (U + TILE - 1) / TILE;
  double da = 0.0;
  for (int kt = grp * KGROUP; kt < min(nk, (grp + 1) * KGROUP); ++kt) {
    if constexpr (NM == G) {
      constexpr int MDS = agg_mds<NM>();
      float s[G][4][4];
      mode_score_tiles<G, MDS>(s, k + off, qs, ks, wb, kt, U, md);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col >= U) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = qt * TILE + ty + 16 * i;
          if (row >= U) continue;
          const size_t e = (size_t)b * plane + (size_t)row * U + col;
          const float gv = g[e], vv = vol[e];
          const float bias = pos_w * wb.at(i, j);
          float c[G], x[G], p[G];
#pragma unroll
          for (int m = 0; m < G; ++m) {
            c[m] = s[m][i][j] * scale;
            x[m] = fminf(fmaxf(c[m], -clip), clip) + bias;
          }
          float mmax = agg_w * x[0];
#pragma unroll
          for (int m = 1; m < G; ++m) mmax = fmaxf(mmax, agg_w * x[m]);
          float denom = 0.f;
#pragma unroll
          for (int m = 0; m < G; ++m) {
            p[m] = expf(agg_w * x[m] - mmax);
            denom += p[m];
          }
          float dsum = 0.f;
#pragma unroll
          for (int m = 0; m < G; ++m) {
            const float pm = p[m] / denom;
            const float sv = x[m] - vv;
            const float t = pm * (1.f + agg_w * sv);
            dc[((size_t)b * NM + m) * plane + (size_t)row * U + col] =
                fabsf(c[m]) < clip ? gv * t : 0.f;
            dsum += pm * x[m] * sv;
          }
          da += (double)(gv * dsum);
        }
      }
    } else {
      // Pass 1: the mode softmax's running max and denominator.
      if constexpr (NM == NM_WIDE)
        stage_k_modes(ks, k + off, wb, kt, U, md, nm);
      const int ng = modes_of<NM>(nm) / G;
      float rmax[4][4], rden[4][4];
#pragma unroll 1
      for (int gi = 0; gi < ng; ++gi) {
        float s[G][4][4];
        group_scores<NM, G>(s, k + off, qs, ks, wb, kt, U, md, gi);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bias = pos_w * wb.at(i, j);
            float l[G];
#pragma unroll
            for (int m = 0; m < G; ++m)
              l[m] = agg_w *
                     (fminf(fmaxf(s[m][i][j] * scale, -clip), clip) + bias);
            float gmx = l[0];
#pragma unroll
            for (int m = 1; m < G; ++m) gmx = fmaxf(gmx, l[m]);
            const float mmax = gi == 0 ? gmx : fmaxf(rmax[i][j], gmx);
            float denom = gi == 0 ? 0.f : rden[i][j] * expf(rmax[i][j] - mmax);
#pragma unroll
            for (int m = 0; m < G; ++m) denom += expf(l[m] - mmax);
            rmax[i][j] = mmax;
            rden[i][j] = denom;
          }
      }
      // Pass 2: each group's scores again, its dc planes and da's terms.
      float dsum[4][4] = {};
#pragma unroll 1
      for (int gi = 0; gi < ng; ++gi) {
        float s[G][4][4];
        group_scores<NM, G>(s, k + off, qs, ks, wb, kt, U, md, gi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kt * TILE + tx + 16 * j;
          if (col >= U) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = qt * TILE + ty + 16 * i;
            if (row >= U) continue;
            const size_t e = (size_t)b * plane + (size_t)row * U + col;
            const float gv = g[e], vv = vol[e];
            const float bias = pos_w * wb.at(i, j);
#pragma unroll
            for (int m = 0; m < G; ++m) {
              const float c = s[m][i][j] * scale;
              const float x = fminf(fmaxf(c, -clip), clip) + bias;
              const float pm =
                  expf(agg_w * x - rmax[i][j]) / rden[i][j];
              const float sv = x - vv;
              const float t = pm * (1.f + agg_w * sv);
              dc[((size_t)b * nmodes + gi * G + m) * plane +
                 (size_t)row * U + col] = fabsf(c) < clip ? gv * t : 0.f;
              dsum[i][j] += pm * x * sv;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col >= U) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = qt * TILE + ty + 16 * i;
          if (row >= U) continue;
          const size_t e = (size_t)b * plane + (size_t)row * U + col;
          da += (double)(g[e] * dsum[i][j]);
        }
      }
    }
  }
  da = block_sum(da, red);
  if (threadIdx.x == 0)
    partial[((size_t)b * gridDim.y + grp) * gridDim.x + qt] = da;
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

#define B6B_ROWS 64      // query rows a block, shared by its warpgroups
#define B6B_KEYS 64      // keys a ring stage: 16 a warpgroup, every mode
#define B6B_KGROUP 9     // key tiles a block (45 at chairs: 5 groups)
#define B6B_STAGES 2     // ring depth
#define B6B_THREADS 512  // four warpgroups side by side along the keys
#define B6B_GROW 272     // bytes a staged row of g, vol or dc: 64 fp32 + 16

typedef MmaWindowT<B6B_ROWS, B6B_KEYS, B6B_THREADS> AggWindow;

// The backward over key tiles [grp * B6B_KGROUP, + B6B_KGROUP) of q tile
// qt of sample b (grid (q tiles, key groups, samples)).  The four modes' q
// tiles stay in shared memory (the A operand); each stage of the cp.async
// ring holds one key tile: the four modes' k tiles (the B operand) and the
// tile's g and vol rows, each row from the 16-byte unit that holds its
// first element and standing m_r = (its start) % 16 bytes into its
// staging row.  Warpgroup w owns keys 16 w .. 16 w + 15 of each tile, all
// 64 rows: four m64n16 accumulator sets of one fragment layout, so each
// thread holds the four modes' scores of the same (row, column) and runs
// the mode softmax on them without shuffles.  The epilogue follows the
// fp32 body's operations in scaled units (c = scale q.k, the clamp, the
// window bias), with the softmax on the exp2 scale (ex2.approx), and puts
// dc_m in place of the scores; then plane by plane the block stages its
// 64 rows x 64 keys (two staging tiles in turn, one barrier a plane) and
// writes them in whole 16-byte units along the rows (wgmma.cuh
// put_row_unit).  The stage of a tile is refilled with the tile two on
// once every thread has passed the first plane's barrier.  g * sum_m p_m
// s_m (s_m - vol) is summed per tile in fp32, added to an fp64 sum per
// thread, and the block's sum goes to partial[(b * gridDim.y + grp) *
// gridDim.x + qt] in a fixed order.  MDP: the tiles' mode dim (16, 32 or
// 64 >= md; columns past md are zero).
template <int MDP>
__global__ void __launch_bounds__(B6B_THREADS, 1)
    agg_bwd_wgmma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const float* __restrict__ g,
                         const float* __restrict__ vol, BiasArgs ba,
                         const float* __restrict__ scal,
                         float* __restrict__ dc, double* __restrict__ partial,
                         int md, float scale) {
  constexpr int KC = MDP / 8;                    // 16-byte chunks of a row
  constexpr int KTILE = B6B_KEYS * MDP * 2;      // a mode's k tile
  constexpr int QTILE = B6B_ROWS * MDP * 2;      // a mode's q tile
  constexpr int GB = B6B_ROWS * B6B_GROW;        // a g (vol, dc) tile
  constexpr int STAGE = NMODES * KTILE + 2 * GB;
  constexpr int UNITS = B6B_GROW / 16;           // 16-byte units a row
  constexpr int NWG = B6B_THREADS / 128;
  constexpr int WKEYS = B6B_KEYS / NWG;          // keys of a warpgroup
  constexpr int NT = WKEYS / 8;                  // its n tiles of 8 keys
  static_assert(QTILE % 1024 == 0 && KTILE % 1024 == 0 && STAGE % 1024 == 0,
                "swizzle atoms");
  static_assert(WKEYS == 16 && B6B_ROWS == 64, "m64n16 warpgroups");
  static_assert(B6B_GROW == 4 * B6B_KEYS + 16, "a row and its shift");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* ring = smem + NMODES * QTILE;
  unsigned char* stg = ring + B6B_STAGES * STAGE;  // [2][B6B_ROWS][B6B_GROW]
  unsigned char* wsm = stg + 2 * GB;
  const uint32_t full0 = smem_u32(wsm + AggWindow::SMEM);
  __shared__ double red[B6B_THREADS / 32];
  const int qt = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int U = ba.U1;
  const int row0 = qt * B6B_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int wkey = WKEYS * wg;
  const bf16* qb = q + (size_t)b * NMODES * U * md;
  const bf16* kb = k + (size_t)b * NMODES * U * md;
  const int nk = (U + B6B_KEYS - 1) / B6B_KEYS;
  const int kt0 = grp * B6B_KGROUP;
  const int n = min(nk, kt0 + B6B_KGROUP) - kt0;  // >= 1
  const size_t gbytes = (size_t)gridDim.z * U * U * 4;  // g's and vol's
  const unsigned char* g8 = reinterpret_cast<const unsigned char*>(g);
  const unsigned char* v8 = reinterpret_cast<const unsigned char*>(vol);
  unsigned char* dc8 = reinterpret_cast<unsigned char*>(dc);

  AggWindow win;
  win.init(wsm, ba, qt);
  if (threadIdx.x == 0)
    for (int i = 0; i < B6B_STAGES; ++i) mbar_init(full0 + 8 * i, B6B_THREADS);
  __syncthreads();  // the barriers and the window

  // This block's q tiles (they land with stage 0: full[0] counts every
  // earlier copy), then per stage the key tile's k tiles and g, vol rows.
  for (int e = threadIdx.x; e < NMODES * B6B_ROWS * KC; e += B6B_THREADS) {
    const int m = e / (B6B_ROWS * KC), rc = e % (B6B_ROWS * KC);
    const int r = rc / KC, c = rc % KC;
    const bool ok = row0 + r < U && 8 * c < md;  // else zeros (md 48)
    cp_async16(smem_u32(smem) + m * QTILE + r * MDP * 2 + 16 * swz<KC>(r, c),
               ok ? qb + ((size_t)m * U + row0 + r) * md + 8 * c : qb, ok);
  }
  auto load_stage = [&](int kt, int s) {
    const uint32_t sa = smem_u32(ring + s * STAGE);
    const int key0 = kt * B6B_KEYS;
    const int nkeys = min(B6B_KEYS, U - key0);
    for (int e = threadIdx.x; e < NMODES * B6B_KEYS * KC;
         e += B6B_THREADS) {
      const int m = e / (B6B_KEYS * KC), rc = e % (B6B_KEYS * KC);
      const int r = rc / KC, c = rc % KC;
      const bool ok = r < nkeys && 8 * c < md;
      cp_async16(sa + m * KTILE + r * MDP * 2 + 16 * swz<KC>(r, c),
                 ok ? kb + ((size_t)m * U + key0 + r) * md + 8 * c : kb, ok);
    }
    for (int e = threadIdx.x; e < 2 * B6B_ROWS * UNITS; e += B6B_THREADS) {
      const int tv = e >= B6B_ROWS * UNITS;  // 0: g, 1: vol
      const int ru = e - tv * B6B_ROWS * UNITS;
      const int r = ru / UNITS, u = ru % UNITS;
      const size_t a = 4 * (((size_t)b * U + row0 + r) * U + key0);
      const size_t a0 = (a & ~(size_t)15) + 16 * u;
      const bool ok = row0 + r < U && 16 * u < (int)(a & 15) + 4 * nkeys;
      const unsigned char* src = tv ? v8 : g8;
      cp_async16_n(sa + NMODES * KTILE + tv * GB + r * B6B_GROW + 16 * u,
                   ok ? src + a0 : src,
                   ok ? (int)min((size_t)16, gbytes - a0) : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < B6B_STAGES; ++i) {
    if (i < n) {
      load_stage(kt0 + i, i);
      mbar_arrive_copies(full0 + 8 * i);
    }
  }

  const float clip = scal[0], pos_w = scal[1], agg_w = scal[2];
  const float aw2 = agg_w * LOG2E;
  const int rl = 16 * (warp & 3) + gq;  // tile rows rl, rl + 8
  const bool row_ok[2] = {row0 + rl < U, row0 + rl + 8 < U};
  const bool pairs = (U & 1) == 0;  // g, vol, dc pairs on 8-byte words
  const uint64_t da0 = gmma_desc(smem_u32(smem), 16, KLayout<MDP>::SBO,
                                 KLayout<MDP>::TYPE);
  const uint64_t db0 = gmma_desc(smem_u32(ring) + wkey * MDP * 2, 16,
                                 KLayout<MDP>::SBO, KLayout<MDP>::TYPE);
  double da = 0.0;

  float acc[NMODES][NT][4] = {};
  for (int i = 0; i < n; ++i) {
    const int kt = kt0 + i, s = i % B6B_STAGES;
    const int key0 = kt * B6B_KEYS;
    const int nkeys = min(B6B_KEYS, U - key0);
    const unsigned char* st = ring + s * STAGE;
    mbar_wait(full0 + 8 * s, (i / B6B_STAGES) & 1);
    fence_async_smem();
    const uint64_t db = db0 + (uint64_t)(s * STAGE / 16);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int kd = 0; kd < MDP / 16; ++kd)
        wgmma_ss16(acc[m], da0 + (m * QTILE + 32 * kd) / 16,
                   db + (m * KTILE + 32 * kd) / 16, kd);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int m = 0; m < NMODES; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[m][j][e]);

    // The window bias of the warpgroup's keys, dc_m in place of the scores.
    const bool in_win = win.keys_in_window(key0 + wkey, WKEYS);
    int kh = 0, kw = 0;
    if (in_win) win.first_col(key0 + wkey, kh, kw);
    float tda = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float bj[4] = {0.f, 0.f, 0.f, 0.f};
      if (in_win) win.col_bias(kh, kw, pos_w, bj);
      const int cl = wkey + 8 * j + 2 * t;  // the tile's column
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = rl + 8 * i2;
        const size_t a = 4 * (((size_t)b * U + row0 + r) * U + key0);
        const unsigned char* gs =
            st + NMODES * KTILE + r * B6B_GROW + (int)(a & 15) + 4 * cl;
        float gv[2], vv[2];
        if (pairs) {
          const float2 g2 = *reinterpret_cast<const float2*>(gs);
          const float2 v2 = *reinterpret_cast<const float2*>(gs + GB);
          gv[0] = g2.x;
          gv[1] = g2.y;
          vv[0] = v2.x;
          vv[1] = v2.y;
        } else {
          gv[0] = reinterpret_cast<const float*>(gs)[0];
          gv[1] = reinterpret_cast<const float*>(gs)[1];
          vv[0] = reinterpret_cast<const float*>(gs + GB)[0];
          vv[1] = reinterpret_cast<const float*>(gs + GB)[1];
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * i2 + c;
          // Outside the volume g is 0, which zeroes the element's da term.
          const float gvc = row_ok[i2] && cl + c < nkeys ? gv[c] : 0.f;
          const float vvc = vv[c];
          float cm[NMODES], x[NMODES], l[NMODES];
#pragma unroll
          for (int m = 0; m < NMODES; ++m) {
            cm[m] = acc[m][j][e] * scale;
            x[m] = fminf(fmaxf(cm[m], -clip), clip) + bj[e];
            l[m] = x[m] * aw2;
          }
          const float lmax = fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3]));
          float pm[NMODES], den = 0.f;
#pragma unroll
          for (int m = 0; m < NMODES; ++m) {
            pm[m] = exp2_approx(l[m] - lmax);
            den += pm[m];
          }
          float dsum = 0.f;
#pragma unroll
          for (int m = 0; m < NMODES; ++m) {
            const float pn = __fdividef(pm[m], den);
            const float sv = x[m] - vvc;
            const float tm = pn * (1.f + agg_w * sv);
            acc[m][j][e] = fabsf(cm[m]) < clip ? gvc * tm : 0.f;  // dc_m
            dsum += pn * x[m] * sv;
          }
          tda = fmaf(gvc, dsum, tda);
        }
      }
    }
    da += (double)tda;

    // dc out, plane by plane through the two staging tiles.
#pragma unroll
    for (int m = 0; m < NMODES; ++m) {
      unsigned char* sb = stg + (m & 1) * GB;
      const size_t pl = ((size_t)b * NMODES + m) * U;  // the plane's row 0
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = rl + 8 * i2;
        const size_t a = 4 * ((pl + row0 + r) * U + key0);
        float* d = reinterpret_cast<float*>(sb + r * B6B_GROW +
                                            (int)(a & 15)) + wkey + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (pairs) {
            *reinterpret_cast<float2*>(d + 8 * j) =
                make_float2(acc[m][j][2 * i2], acc[m][j][2 * i2 + 1]);
          } else {
            d[8 * j] = acc[m][j][2 * i2];
            d[8 * j + 1] = acc[m][j][2 * i2 + 1];
          }
        }
      }
      __syncthreads();  // plane m is staged; stage s and plane m - 2's
                        // staging tile are free
      if (m == 0 && i + B6B_STAGES < n) {
        load_stage(kt + B6B_STAGES, s);
        mbar_arrive_copies(full0 + 8 * s);
      }
      for (int e = threadIdx.x; e < B6B_ROWS * UNITS; e += B6B_THREADS) {
        const int r = e / UNITS, u = e % UNITS;
        if (row0 + r >= U) continue;
        const size_t a = 4 * ((pl + row0 + r) * U + key0);
        put_row_unit(dc8 + a, sb + r * B6B_GROW, (int)(a & 15), 4 * nkeys, u);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) red[warp] = da;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < B6B_THREADS / 32; ++w) da += red[w];
    partial[((size_t)b * gridDim.y + grp) * gridDim.x + qt] = da;
  }
}

static dim3 agg_grid(int B, int U1, int U2) {
  const int nq = (U1 + TILE - 1) / TILE, nk = (U2 + TILE - 1) / TILE;
  return dim3(nq, (nk + KGROUP - 1) / KGROUP, B);
}

template <int MDP, class Bias>
static int launch_fwd_md(const void* q, const void* k, const BiasArgs& ba,
                         const void* scal, void* out, int B, int md,
                         float scale, cudaStream_t s) {
  const size_t smem = sweep_smem<MDP, Bias>();
  auto kernel = agg_corr_wgmma_kernel<MDP, Bias>;
  cudaError_t err = allow_sweep_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<sweep_grid(B, ba.U1, ba.U2, 1), B3_THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, ba, (const float*)scal, (float*)out, md,
      scale);
  return (int)cudaGetLastError();
}

template <int NM, typename T, class FmaBias>
static int launch_fwd_fma(const void* q, const void* k, const BiasArgs& ba,
                          const void* scal, void* out, int B, int md,
                          int nm, float scale, cudaStream_t s) {
  const size_t smem = agg_smem<FmaBias, NM>();
  cudaError_t err = allow_smem(agg_corr_kernel<NM, T, FmaBias>, smem);
  if (err != cudaSuccess) return (int)err;
  agg_corr_kernel<NM, T, FmaBias>
      <<<agg_grid(B, ba.U1, ba.U2), NTHREADS, smem, s>>>(
          (const T*)q, (const T*)k, ba, (const float*)scal, (float*)out,
          ba.U1, ba.U2, md, nm, scale);
  return (int)cudaGetLastError();
}

// The forward of NM modes over the bias source Bias: the bf16 body (four
// modes, md a multiple of 16 up to 64, q and k 16-byte aligned; refused
// otherwise) or the FMA one.
template <class Bias, class FmaBias>
static int launch_fwd(const void* q, const void* k, const BiasArgs& ba,
                      const void* scal, void* out, int B, int NM, int md,
                      float scale, int in_bf16, cudaStream_t s) {
  if (agg_mma_body(NM, md, in_bf16)) {
    if (!sweep_takes(q, k, md)) return (int)cudaErrorInvalidValue;
    if (md <= 16)
      return launch_fwd_md<16, Bias>(q, k, ba, scal, out, B, md, scale, s);
    if (md <= 32)
      return launch_fwd_md<32, Bias>(q, k, ba, scal, out, B, md, scale, s);
    return launch_fwd_md<64, Bias>(q, k, ba, scal, out, B, md, scale, s);
  }
  if (!fma_takes(NM, md)) return (int)cudaErrorInvalidValue;
#define LAUNCH(NM_)                                                         \
  return in_bf16 ? launch_fwd_fma<NM_, bf16, FmaBias>(q, k, ba, scal, out, \
                                                      B, md, NM, scale, s) \
                 : launch_fwd_fma<NM_, float, FmaBias>(q, k, ba, scal, out,\
                                                       B, md, NM, scale, s);
  WITH_MODES(NM, LAUNCH)
#undef LAUNCH
}

// The backward's grid for the body that in_bf16 selects: (q tiles, key-tile
// groups, samples).
static dim3 bwd_grid(int B, int U, int in_bf16) {
  if (!in_bf16) return agg_grid(B, U, U);
  const int nk = (U + B6B_KEYS - 1) / B6B_KEYS;
  return dim3((U + B6B_ROWS - 1) / B6B_ROWS,
              (nk + B6B_KGROUP - 1) / B6B_KGROUP, B);
}

// The backward's fp64 partials: one a block (tests/test_torch_kernel_grids.py
// holds the wrapper's count against this).
static int bwd_partials(int B, int U, int in_bf16) {
  const dim3 g = bwd_grid(B, U, in_bf16);
  return (int)(g.x * g.y * g.z);
}

template <int MDP>
static cudaError_t launch_bwd_wgmma(const void* q, const void* k,
                                    const void* g, const void* vol,
                                    const BiasArgs& ba, const void* scal,
                                    void* dc, void* partial, int B, int md,
                                    float scale, cudaStream_t s) {
  // The q tiles, the ring, two dc staging tiles, the window, the
  // barriers; + 1024: the q tiles start at the first 1024-byte boundary.
  const size_t smem =
      NMODES * B6B_ROWS * MDP * 2 +
      B6B_STAGES * (NMODES * B6B_KEYS * MDP * 2 + 2 * B6B_ROWS * B6B_GROW) +
      2 * B6B_ROWS * B6B_GROW + AggWindow::SMEM + 8 * B6B_STAGES + 1024;
  auto kernel = agg_bwd_wgmma_kernel<MDP>;
  cudaError_t err = allow_sweep_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<bwd_grid(B, ba.U1, 1), B6B_THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const float*)g, (const float*)vol, ba,
      (const float*)scal, (float*)dc, (double*)partial, md, scale);
  return cudaGetLastError();
}

template <int NM, typename T>
static cudaError_t launch_bwd_fma(const void* q, const void* k,
                                  const void* g, const void* vol,
                                  const void* biases, const void* scal,
                                  void* dc, void* partial, dim3 grid, int U,
                                  int md, int nm, int W8, int R, float scale,
                                  cudaStream_t s) {
  const size_t smem = agg_smem<WindowBias, NM>();
  cudaError_t err = allow_smem(agg_corr_bwd_kernel<NM, T>, smem);
  if (err != cudaSuccess) return err;
  agg_corr_bwd_kernel<NM, T><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const float*)g, (const float*)vol,
      (const float*)biases, (const float*)scal, (float*)dc, (double*)partial,
      U, md, nm, W8, R, scale);
  return cudaGetLastError();
}

static int launch_bwd(const void* q, const void* k, const void* g,
                      const void* vol, const void* biases, const void* scal,
                      void* dc, void* partial, void* da, int B, int NM, int U,
                      int md, int W8, int R, float scale, int in_bf16,
                      cudaStream_t s) {
  const int mma = agg_mma_body(NM, md, in_bf16);
  const dim3 grid = bwd_grid(B, U, mma);
  cudaError_t err;
  if (mma) {
    if (!sweep_takes(q, k, md)) return (int)cudaErrorInvalidValue;
    const BiasArgs ba{(const float*)biases, W8, R, U, U, 0};
    err = md <= 16   ? launch_bwd_wgmma<16>(q, k, g, vol, ba, scal, dc,
                                            partial, B, md, scale, s)
          : md <= 32 ? launch_bwd_wgmma<32>(q, k, g, vol, ba, scal, dc,
                                            partial, B, md, scale, s)
                     : launch_bwd_wgmma<64>(q, k, g, vol, ba, scal, dc,
                                            partial, B, md, scale, s);
  } else {
    if (!fma_takes(NM, md)) return (int)cudaErrorInvalidValue;
#define LAUNCH(NM_)                                                        \
  err = in_bf16 ? launch_bwd_fma<NM_, bf16>(q, k, g, vol, biases, scal, dc, \
                                            partial, grid, U, md, NM, W8,   \
                                            R, scale, s)                    \
                : launch_bwd_fma<NM_, float>(q, k, g, vol, biases, scal,    \
                                             dc, partial, grid, U, md, NM,  \
                                             W8, R, scale, s);              \
  break;
    WITH_MODES(NM, LAUNCH)
#undef LAUNCH
  }
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, NTHREADS, 0, s>>>(
      (const double*)partial, (int)(grid.x * grid.y * grid.z), (float*)da);
  return (int)cudaGetLastError();
}

// q, k: [B, NM, U, md] contiguous (bf16 when in_bf16, else fp32), NM 1, 2,
// 4, ..., 256 modes with NM md <= 256 (the wgmma body at four modes, md <=
// 64, bf16: a multiple of 16, q and k 16-byte aligned); biases: [(2R+1)^2]
// fp32; scal: [4] fp32 (clip, pos_w, agg_w, agg_b); out: [B, U, U] fp32.
extern "C" int agg_corr_launch(const void* q, const void* k,
                               const void* biases, const void* scal,
                               void* out, int B, int NM, int U, int md,
                               int W8, int R, float scale, int in_bf16,
                               void* stream) {
  const BiasArgs ba{(const float*)biases, W8, R, U, U, 0};
  return launch_fwd<CorrWindow, WindowBias>(q, k, ba, scal, out, B, NM, md,
                                            scale, in_bf16,
                                            (cudaStream_t)stream);
}

// B6 dense.  q: [B, NM, U1, md]; k: [B, NM, U2, md] contiguous (bf16 when
// in_bf16, else fp32), NM and md as B6; table: [U1, U2] fp32, or null for
// no bias; scal: [4] fp32 (clip, pos_w, agg_w, agg_b); out: [B, U1, U2]
// fp32.
extern "C" int agg_corr_dense_launch(const void* q, const void* k,
                                     const void* table, const void* scal,
                                     void* out, int B, int NM, int U1, int U2,
                                     int md, float scale, int in_bf16,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
  if (table == nullptr)
    return launch_fwd<MmaNoBias, NoBias>(q, k, ba, scal, out, B, NM, md,
                                         scale, in_bf16, s);
  return launch_fwd<CorrTable, TableBias>(q, k, ba, scal, out, B, NM, md,
                                          scale, in_bf16, s);
}

// q, k, biases, scal as above (agg_b unread); g, vol: [B, U, U] fp32; dc:
// [B, NM, U, U] fp32; partial: n_partial = bwd_partials(B, U,
// agg_mma_body(NM, md, in_bf16)) fp64 of scratch (refused otherwise); da:
// [1] fp32.
extern "C" int agg_corr_bwd_launch(const void* q, const void* k,
                                   const void* g, const void* vol,
                                   const void* biases, const void* scal,
                                   void* dc, void* partial, int n_partial,
                                   void* da, int B, int NM, int U, int md,
                                   int W8, int R, float scale, int in_bf16,
                                   void* stream) {
  if (n_partial != bwd_partials(B, U, agg_mma_body(NM, md, in_bf16)))
    return (int)cudaErrorInvalidValue;
  return launch_bwd(q, k, g, vol, biases, scal, dc, partial, da, B, NM, U,
                    md, W8, R, scale, in_bf16, (cudaStream_t)stream);
}
