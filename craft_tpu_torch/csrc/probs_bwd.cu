// B7 backward: the softmax-probs VJP of the f2 and intra attention sites,
// from the saved probs p and their cotangent g (both [BM, U, U] in the io
// type):
//   row   = sum_j g * p                          (per row, fp32)
//   dl    = p * (g - row)                        (d wrt the biased logits)
//   dc    = dl * 1[|scale * q k^T| < clip]       (io type, c recomputed)
//   dlsum = sum_{bm} dl                          ([U, U] fp32)
//
// Replaces craft_tpu/ops/pallas/probs_vjp.py:_pallas_probs_bwd (body
// _probs_bwd_kernel).
//
// Bound on the H100: bytes.  At the chairs crops (BM=32, U=2852) p and g
// are 1.04 GB of bf16 and dc is 520 MB; the c recompute is 33 (md 64) or
// 17 (md 32) GFLOP.  The TPU kernel held a full-width row stripe in VMEM
// and carried dlsum across its sequential bm grid axis.  Two bodies:
//
// bf16 (probs_row_kernel, then probs_bwd_wgmma_kernel): a row stripe does
// not fit a block, so the row term is a pass of its own and p and g are
// read twice (2.6 GB at chairs, 0.78 ms at 3.35 TB/s).
//   1. The row pass: one block a row of one bm, the row's p and g staged
//      in shared memory, summed in the fp32 body's order (so that with
//      the clamp off both bodies give the same dc and dlsum bits): row
//      [BM, UP] fp32, UP = U rounded up to B7_ROWS (padded rows 0), 0.31
//      ms of bytes at chairs.
//   2. The tile pass: a block owns B7_ROWS x B7_COLS elements of every bm
//      and walks bm = 0..BM-1 in order (grid 23 x 45 = 1035 blocks at
//      chairs, 7.8 waves of one block an SM).  Per bm a B7_STAGES-deep
//      cp.async ring counted by mbarriers brings the q and k tiles
//      (swizzled for wgmma), the p and g tiles and the tile's row terms;
//      four warpgroups of 64 rows x 32 columns take c = q k^T on wgmma
//      m64n32k16 (both operands from shared memory, md / 16 k-steps, fp32
//      sums), then per element dl, the mask and dc.  dl is added to a
//      dlsum accumulator in registers (16 a thread) that stays across all
//      bm and is written once at the end: each element's sum runs over bm
//      in order, with no read-modify-write and no atomics.
//   p, g and dc rows are 2U bytes long, so at chairs every other row starts
//   8 bytes off a 16-byte boundary (TMA cannot describe them).  Each staged
//   row is copied in 16-byte units from the unit that holds its first
//   element, and stands m_r = (its start) % 16 bytes into its staging row
//   of B7_PROW bytes; units past the row's last column are not read, a
//   unit past the tensor's end is cut short.  The fragment reads take the
//   pair at m_r + 2 col (a 4-byte word where U is even; two halves where
//   it is odd).  dc is staged the same way and leaves in whole 16-byte
//   units along each 256-byte row (wgmma.cuh put_row_unit): stored from
//   the fragments instead, 16 bytes a quad across 8 rows, B7 takes 1.471
//   ms at chairs md 64 against 1.088 (tools/time_bwd_variants.py, NVIDIA
//   H100 80GB HBM3, 700 W).  The staging rows' 272-byte stride spreads a
//   fragment access's 8 rows over the banks.  The wrapper raises unless
//   md is a multiple of 16 and q, k, p, g and dc are 16-byte aligned, and
//   sizes the row scratch from B7_ROWS (probs_rowterm_size, refused
//   otherwise).
//
// FMA (probs_bwd_kernel, kept for fp32 parity, and the bf16 body past md
// 64: one or two modes at the f2 site, one at the intra site; a simple
// kernel that is right, at the FMA rate): a block owns RB rows and
// walks bm = 0..BM-1 in order, as the TPU grid did, so dlsum for its rows
// is summed in a fixed order with no atomics: at bm = 0 it is written,
// after that read and added to by the one thread that owns the element.
// Per bm a first sweep over the row stripe takes the row sums (reduced
// across the block in a fixed order); a second sweep, 256 columns at a
// time with one column per thread and that k chunk staged in shared
// memory, recomputes c in FMA and writes dc.
#include "common.cuh"
#include "wgmma.cuh"

#define RB 8          // rows per block
#define CW NTHREADS   // columns per sweep-2 chunk, one per thread
#define CWP (CW + 1)  // padded row of the transposed k chunk

// T: the io type (fp32, or bf16 at a mode dim past 64).  The k chunk is
// staged 64 of its mode dim at a time (one stage up to md 64), c summed
// over them in order; q is kept chunk by chunk, so that a chunk's rows
// sit 64 floats apart as at md <= 64.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    probs_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ p, const T* __restrict__ g,
                     const float* __restrict__ clip_ptr, T* __restrict__ dc,
                     float* __restrict__ dlsum, int BM, int U, int md,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // [min(md, 64)][CWP]: k chunk, transposed
  float* qs = ks + MAXMD * CWP;   // [md / 64][RB][64]: this block's q rows
  __shared__ float red[RB][NTHREADS / 32];
  __shared__ float rowsum[RB];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * RB;
  const int nrows = min(RB, U - r0);
  const float clip = clip_ptr[0];
  for (int bm = 0; bm < BM; ++bm) {
    const size_t base = (size_t)bm * U;  // first row of this bm
    // Sweep 1: row sums of g * p.
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int j = t; j < U; j += NTHREADS) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) break;
        const size_t e = (base + r0 + r) * U + j;
        acc[r] = fmaf(to_f(g[e]), to_f(p[e]), acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float v = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[r][warp] = v;
    }
    __syncthreads();
    if (t < RB) {
      float v = 0.f;
      for (int w = 0; w < NTHREADS / 32; ++w) v += red[t][w];
      rowsum[t] = v;
    }
    for (int e = t; e < RB * md; e += NTHREADS) {
      const int r = e / md, d = e - r * md;
      qs[(d / MAXMD * RB + r) * MAXMD + d % MAXMD] =
          r < nrows ? to_f(q[(base + r0 + r) * md + d]) : 0.f;
    }
    __syncthreads();
    float row[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) row[r] = rowsum[r];
    // Sweep 2: dl, the clamp mask, dc and dlsum, CW columns at a time.
    for (int c0 = 0; c0 < U; c0 += CW) {
      const int j = c0 + t;
      float c[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) c[r] = 0.f;
      for (int ci = 0; ci * MAXMD < md; ++ci) {
        const int d0 = ci * MAXMD, dn = min(MAXMD, md - d0);
        __syncthreads();  // the previous chunk's readers are done with ks
        for (int e = t; e < CW * dn; e += NTHREADS) {
          const int col = e / dn, d = e - col * dn;
          const int jj = c0 + col;
          ks[d * CWP + col] =
              jj < U ? to_f(k[(base + jj) * md + d0 + d]) : 0.f;
        }
        __syncthreads();
        // The chunk's [RB][64], whole chunks past qs: aligned as qs is.
        const float* qc = qs + ci * (RB * MAXMD);
        if (j < U)
          for (int d = 0; d < dn; ++d) {
            const float kv = ks[d * CWP + t];
#pragma unroll
            for (int r = 0; r < RB; ++r)
              c[r] = fmaf(qc[r * MAXMD + d], kv, c[r]);
          }
      }
      if (j >= U) continue;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nrows) break;
        const size_t e = (base + r0 + r) * U + j;
        const float dl = to_f(p[e]) * (to_f(g[e]) - row[r]);
        dc[e] = from_f<T>(fabsf(c[r] * scale) < clip ? dl : 0.f);
        const size_t o = (size_t)(r0 + r) * U + j;
        dlsum[o] = bm == 0 ? dl : dlsum[o] + dl;
      }
    }
    __syncthreads();  // red, rowsum and qs are rewritten for the next bm
  }
}

// ---------------------------------------------------------------------------
// The bf16 body: the row pass, then the tile pass on the tensor cores
// ---------------------------------------------------------------------------

#define B7_ROWS 64     // query rows a tile block
#define B7_COLS 128    // key columns a tile block
#define B7_STAGES 3    // ring depth: bm steps in flight
#define B7_THREADS 512  // four warpgroups of 64 rows x 32 columns
#define B7_PROW 272    // bytes a staged row of p, g or dc: 2 B7_COLS + 16

// Two bf16 in a 32-bit word as floats (exact): the lower address first.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// row[bm * UP + r] = sum_j g * p over row r of bm (0 for r >= U), summed
// in the fp32 body's order, so that the two bodies' row terms are the same
// bits: thread t of NTHREADS takes j = t, t + NTHREADS, ... with fmaf in
// order, then a shuffle tree over each warp, then the warps' sums in order.
// One block a row: the row's p and g are staged in shared memory in
// 16-byte units from the unit that holds their first element (cp.async,
// cut short at the tensor's end), so the loads stay 16 bytes wide where
// rows start off the units.  p and g are 16-byte aligned.
__global__ void __launch_bounds__(NTHREADS)
    probs_row_kernel(const bf16* __restrict__ p, const bf16* __restrict__ g,
                     float* __restrict__ rowt, int BM, int U, int UP) {
  extern __shared__ __align__(16) unsigned char srow[];  // p row, g row
  __shared__ float red[NTHREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t r = blockIdx.x;
  const int bm = (int)(r / UP), row = (int)(r - (size_t)bm * UP);
  if (row >= U) {  // block-uniform
    if (t == 0) rowt[r] = 0.f;
    return;
  }
  const size_t a = 2 * (((size_t)bm * U + row) * U);  // the row's first byte
  const int m = (int)(a & 15);
  const int units = (m + 2 * U + 15) / 16;
  const size_t total = (size_t)BM * U * U * 2;
  for (int e = t; e < 2 * units; e += NTHREADS) {
    const int tg = e >= units;  // 0: p, 1: g
    const size_t src = (a & ~(size_t)15) + 16 * (e - tg * units);
    cp_async16_n(smem_u32(srow + 16 * e),
                 reinterpret_cast<const unsigned char*>(tg ? g : p) + src,
                 (int)min((size_t)16, total - src));
  }
  cp_async_wait_all();
  __syncthreads();
  const bf16* ps = reinterpret_cast<const bf16*>(srow + m);
  const bf16* gs = reinterpret_cast<const bf16*>(srow + 16 * units + m);
  float acc = 0.f;
  for (int j = t; j < U; j += NTHREADS)
    acc = fmaf(__bfloat162float(gs[j]), __bfloat162float(ps[j]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (t == 0) {
    float v = 0.f;
    for (int w = 0; w < NTHREADS / 32; ++w) v += red[w];
    rowt[r] = v;
  }
}

// The tile pass of one B7_ROWS x B7_COLS block (grid: column tiles, row
// tiles) over bm = 0..BM-1.  Warpgroup w owns columns 32 w .. 32 w + 31 of
// the tile, every row: c[j][e] (m64n32 fragments, wgmma.cuh) and dlsum's
// sums ds[j][e] at the same elements.  dc goes through a staging tile (two,
// by bm's parity, so that one barrier a bm suffices): each thread puts its
// bf16 pairs at the row's shift m_r, then the block writes whole 16-byte
// units along the rows.  MDP: the tiles' mode dim (16, 32 or 64 >= md;
// columns past md are zero).
template <int MDP>
__global__ void __launch_bounds__(B7_THREADS, 1)
    probs_bwd_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ p,
                           const bf16* __restrict__ g,
                           const float* __restrict__ rowt,
                           const float* __restrict__ clip_ptr,
                           bf16* __restrict__ dc, float* __restrict__ dlsum,
                           int BM, int U, int UP, int md, float scale) {
  constexpr int KC = MDP / 8;                  // 16-byte chunks of a q row
  constexpr int QB = B7_ROWS * MDP * 2;        // q tile
  constexpr int KB = B7_COLS * MDP * 2;        // k tile
  constexpr int PB = B7_ROWS * B7_PROW;        // p (g, dc) tile
  constexpr int UNITS = B7_PROW / 16;          // 16-byte units a p row
  constexpr int STAGE = (QB + KB + 2 * PB + B7_ROWS * 4 + 1023) / 1024 * 1024;
  constexpr int NWG = B7_THREADS / 128;        // warpgroups, side by side
  constexpr int WCOLS = B7_COLS / NWG;         // columns of a warpgroup
  constexpr int NT = WCOLS / 8;                // its n tiles of 8 columns
  static_assert(QB % 1024 == 0 && KB % 1024 == 0, "swizzle atoms");
  static_assert(B7_PROW == 2 * B7_COLS + 16, "a row and its shift");
  static_assert(B7_ROWS == 64 && WCOLS == 32,
                "warpgroups of 64 rows and 32 columns");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* stg = smem + B7_STAGES * STAGE;  // [2][B7_ROWS][B7_PROW]
  const uint32_t full0 = smem_u32(stg + 2 * PB);
  const uint32_t empty0 = full0 + 8 * B7_STAGES;
  const int col0 = blockIdx.x * B7_COLS, row0 = blockIdx.y * B7_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int ncols = min(B7_COLS, U - col0);
  const size_t pbytes = (size_t)BM * U * U * 2;  // p's and g's length
  const bool even = (U & 1) == 0;  // pairs on 4-byte words (grid-uniform)

  if (threadIdx.x == 0) {
    for (int i = 0; i < B7_STAGES; ++i) {
      mbar_init(full0 + 8 * i, B7_THREADS);
      mbar_init(empty0 + 8 * i, B7_THREADS);
    }
  }
  __syncthreads();

  // Stage s of bm: q rows row0.., k rows col0.., p and g rows (each from
  // the 16-byte unit that holds its first element), the tile's row terms.
  auto load_stage = [&](int bm, int s) {
    const uint32_t sa = smem_u32(smem + s * STAGE);
    const bf16* qb = q + (size_t)bm * U * md;
    const bf16* kb = k + (size_t)bm * U * md;
    for (int e = threadIdx.x; e < B7_ROWS * KC; e += B7_THREADS) {
      const int r = e / KC, c = e % KC;
      const bool ok = row0 + r < U && 8 * c < md;  // else zeros (md 48)
      cp_async16(sa + r * MDP * 2 + 16 * swz<KC>(r, c),
                 ok ? qb + (size_t)(row0 + r) * md + 8 * c : qb, ok);
    }
    for (int e = threadIdx.x; e < B7_COLS * KC; e += B7_THREADS) {
      const int r = e / KC, c = e % KC;
      const bool ok = r < ncols && 8 * c < md;
      cp_async16(sa + QB + r * MDP * 2 + 16 * swz<KC>(r, c),
                 ok ? kb + (size_t)(col0 + r) * md + 8 * c : kb, ok);
    }
    for (int e = threadIdx.x; e < 2 * B7_ROWS * UNITS; e += B7_THREADS) {
      const int tg = e >= B7_ROWS * UNITS;  // 0: p, 1: g
      const int ru = e - tg * B7_ROWS * UNITS;
      const int r = ru / UNITS, u = ru % UNITS;
      const size_t a = 2 * (((size_t)bm * U + row0 + r) * U + col0);
      const size_t a0 = (a & ~(size_t)15) + 16 * u;
      const bool ok = row0 + r < U && 16 * u < (int)(a & 15) + 2 * ncols;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(tg ? g : p);
      cp_async16_n(sa + QB + KB + tg * PB + r * B7_PROW + 16 * u,
                   ok ? src + a0 : src,
                   ok ? (int)min((size_t)16, pbytes - a0) : 0);
    }
    if (threadIdx.x < B7_ROWS / 4)
      cp_async16(sa + QB + KB + 2 * PB + 16 * threadIdx.x,
                 rowt + (size_t)bm * UP + row0 + 4 * threadIdx.x, true);
  };
#pragma unroll
  for (int i = 0; i < B7_STAGES - 1; ++i) {
    if (i < BM) {
      load_stage(i, i);
      mbar_arrive_copies(full0 + 8 * i);
    }
  }

  const float clip = clip_ptr[0];
  const int rl = 16 * (warp & 3) + gq;  // tile rows rl, rl + 8
  const int wc = WCOLS * wg;            // the warpgroup's first column
  const bool row_ok[2] = {row0 + rl < U, row0 + rl + 8 < U};
  const uint64_t da0 = gmma_desc(smem_u32(smem), 16, KLayout<MDP>::SBO,
                                 KLayout<MDP>::TYPE);
  const uint64_t db0 = gmma_desc(smem_u32(smem) + QB + wc * MDP * 2, 16,
                                 KLayout<MDP>::SBO, KLayout<MDP>::TYPE);
  unsigned char* dcb = reinterpret_cast<unsigned char*>(dc);
  float ds[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] = -0.f;  // -0 + dl == dl
  float acc[NT][4] = {};

  for (int bm = 0; bm < BM; ++bm) {
    const int s = bm % B7_STAGES;
    const unsigned char* st = smem + s * STAGE;
    unsigned char* sb = stg + (bm & 1) * PB;
    mbar_wait(full0 + 8 * s, (bm / B7_STAGES) & 1);
    fence_async_smem();
    const uint64_t doff = (uint64_t)(s * STAGE / 16);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < MDP / 16; ++kd)
      wgmma_ss32(acc, da0 + doff + 2 * kd, db0 + doff + 2 * kd, kd);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[j][e]);

    const float* rows = reinterpret_cast<const float*>(st + QB + KB + 2 * PB);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rl + 8 * i;
      const float rv = rows[r];
      const size_t e0 = ((size_t)bm * U + row0 + r) * U + col0;
      const int off = r * B7_PROW + (int)((2 * e0) & 15) + 2 * wc;
      const unsigned char* ps = st + QB + KB + off;
      const unsigned char* gs = ps + PB;
      unsigned char* ds_row = sb + off;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = 8 * j + 2 * t;
        float pv[2], gv[2];
        if (even) {
          const uint32_t pw = *reinterpret_cast<const uint32_t*>(ps + 2 * cl);
          const uint32_t gw = *reinterpret_cast<const uint32_t*>(gs + 2 * cl);
          pv[0] = bf_lo(pw);
          pv[1] = bf_hi(pw);
          gv[0] = bf_lo(gw);
          gv[1] = bf_hi(gw);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            pv[c] = __bfloat162float(
                *reinterpret_cast<const bf16*>(ps + 2 * (cl + c)));
            gv[c] = __bfloat162float(
                *reinterpret_cast<const bf16*>(gs + 2 * (cl + c)));
          }
        }
        float d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = pv[c] * (gv[c] - rv);
          d[c] = fabsf(acc[j][2 * i + c] * scale) < clip ? dl : 0.f;
          ds[j][2 * i + c] += dl;
        }
        if (even) {
          *reinterpret_cast<uint32_t*>(ds_row + 2 * cl) =
              pack_bf16(d[0], d[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *reinterpret_cast<bf16*>(ds_row + 2 * (cl + c)) =
                __float2bfloat16_rn(d[c]);
        }
      }
    }
    mbar_arrive(empty0 + 8 * s);  // done with stage s
    __syncthreads();              // the staged dc tile is whole

    // dc out: the block's rows in 16-byte units, each row's units from the
    // one that holds its first element.
    for (int e = threadIdx.x; e < B7_ROWS * UNITS; e += B7_THREADS) {
      const int r = e / UNITS, u = e % UNITS;
      if (row0 + r >= U) continue;
      const size_t a = 2 * (((size_t)bm * U + row0 + r) * U + col0);
      put_row_unit(dcb + a, sb + r * B7_PROW, (int)(a & 15), 2 * ncols, u);
    }

    // bm + B7_STAGES - 1 into the stage of bm - 1, once every thread is
    // done with that.
    if (bm + B7_STAGES - 1 < BM) {
      const int sp = (bm + B7_STAGES - 1) % B7_STAGES;
      if (bm > 0) mbar_wait(empty0 + 8 * sp, ((bm - 1) / B7_STAGES) & 1);
      load_stage(bm + B7_STAGES - 1, sp);
      mbar_arrive_copies(full0 + 8 * sp);
    }
  }

  // dlsum, written once.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    float* orow = dlsum + (size_t)(row0 + rl + 8 * i) * U + col0 + wc;
    const int nc = ncols - wc;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = 8 * j + 2 * t;
      if (even && cl + 1 < nc) {
        *reinterpret_cast<float2*>(orow + cl) =
            make_float2(ds[j][2 * i], ds[j][2 * i + 1]);
      } else {
        if (cl < nc) orow[cl] = ds[j][2 * i];
        if (cl + 1 < nc) orow[cl + 1] = ds[j][2 * i + 1];
      }
    }
  }
}

// The row scratch of a bf16 launch: one fp32 a row of every bm, the rows
// padded to B7_ROWS; 0 for fp32 (tests/test_torch_kernel_grids.py holds
// the wrapper's count against this).
static long long probs_rowterm_size(int BM, int U, int io_bf16) {
  if (!io_bf16) return 0;
  return (long long)BM * ((U + B7_ROWS - 1) / B7_ROWS) * B7_ROWS;
}

template <int MDP>
static int launch_wgmma_md(const void* q, const void* k, const void* p,
                           const void* g, const void* rowt, const void* clip,
                           void* dc, void* dlsum, int BM, int U, int UP,
                           int md, float scale, cudaStream_t s) {
  constexpr int STAGE = (B7_ROWS * MDP * 2 + B7_COLS * MDP * 2 +
                         2 * B7_ROWS * B7_PROW + B7_ROWS * 4 + 1023) /
                        1024 * 1024;
  // The ring, two dc staging tiles, the barriers; + 1024: the ring starts
  // at the first 1024-byte boundary.
  const size_t smem =
      B7_STAGES * (STAGE + 16) + 2 * B7_ROWS * B7_PROW + 1024;
  auto kernel = probs_bwd_wgmma_kernel<MDP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((U + B7_COLS - 1) / B7_COLS, (U + B7_ROWS - 1) / B7_ROWS);
  kernel<<<grid, B7_THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)p, (const bf16*)g,
      (const float*)rowt, (const float*)clip, (bf16*)dc, (float*)dlsum, BM,
      U, UP, md, scale);
  return (int)cudaGetLastError();
}

// The bf16 body: md a multiple of 16 up to 64; q, k, p, g and dc 16-byte
// aligned.
static int launch_bf16(const void* q, const void* k, const void* p,
                       const void* g, const void* clip, void* dc, void* dlsum,
                       void* rowt, int BM, int U, int md, float scale,
                       cudaStream_t s) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)p |
                          (uintptr_t)g | (uintptr_t)dc;
  if (md <= 0 || md > MAXMD || md % 16 != 0 || (align & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int UP = (U + B7_ROWS - 1) / B7_ROWS * B7_ROWS;
  // The row pass stages a row of p and of g: at most 2 U + 14 bytes each
  // from their 16-byte units.
  const size_t rsmem = 2 * (size_t)((2 * U + 14 + 15) / 16 * 16);
  cudaError_t err = allow_smem(probs_row_kernel, rsmem);
  if (err != cudaSuccess) return (int)err;
  probs_row_kernel<<<(unsigned)((long long)BM * UP), NTHREADS, rsmem, s>>>(
      (const bf16*)p, (const bf16*)g, (float*)rowt, BM, U, UP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (md <= 16)
    return launch_wgmma_md<16>(q, k, p, g, rowt, clip, dc, dlsum, BM, U, UP,
                               md, scale, s);
  if (md <= 32)
    return launch_wgmma_md<32>(q, k, p, g, rowt, clip, dc, dlsum, BM, U, UP,
                               md, scale, s);
  return launch_wgmma_md<64>(q, k, p, g, rowt, clip, dc, dlsum, BM, U, UP, md,
                             scale, s);
}

// The FMA body in io type T.
template <typename T>
static int launch_fma(const void* q, const void* k, const void* p,
                      const void* g, const void* clip, void* dc, void* dlsum,
                      int BM, int U, int md, float scale, cudaStream_t s) {
  const size_t smem = (MAXMD * CWP + RB * MAXMD_FMA) * sizeof(float);
  cudaError_t err = allow_smem(probs_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  probs_bwd_kernel<T><<<(U + RB - 1) / RB, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)p, (const T*)g,
      (const float*)clip, (T*)dc, (float*)dlsum, BM, U, md, scale);
  return (int)cudaGetLastError();
}

// q, k: [BM, U, md]; p, g, dc: [BM, U, U]; all contiguous, bf16 when
// io_bf16 else fp32; md <= 256 (bf16 up to 64: a multiple of 16, every
// tensor 16-byte aligned, on wgmma; past 64 and fp32 the FMA body); clip:
// [1] fp32; dlsum: [U, U] fp32; rowt: n_row = probs_rowterm_size(BM, U,
// io_bf16 && md <= 64) fp32 of scratch (refused otherwise; null and 0 for
// the FMA body).
extern "C" int probs_bwd_launch(const void* q, const void* k, const void* p,
                                const void* g, const void* clip, void* dc,
                                void* dlsum, void* rowt, long long n_row,
                                int BM, int U, int md, float scale,
                                int io_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int mma = mma_body(md, io_bf16);
  if (n_row != probs_rowterm_size(BM, U, mma))
    return (int)cudaErrorInvalidValue;
  if (mma)
    return launch_bf16(q, k, p, g, clip, dc, dlsum, rowt, BM, U, md, scale,
                       s);
  if (md <= 0 || md > MAXMD_FMA) return (int)cudaErrorInvalidValue;
  return io_bf16 ? launch_fma<bf16>(q, k, p, g, clip, dc, dlsum, BM, U, md,
                                    scale, s)
                 : launch_fma<float>(q, k, p, g, clip, dc, dlsum, BM, U, md,
                                     scale, s);
}
