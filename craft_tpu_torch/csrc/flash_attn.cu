// B2 and B8: flash multi-mode attention of the f2 transformer site,
//   out[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias) @ v,
// keys past U2 masked; the [U1, U2] scores never leave the block.  B2 takes
// the sliding window as its bias, B8 a dense [U1, U2] fp32 table or none;
// each body serves both (a template over the bias source).
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:flash_mode_attention_mt
// (body _flash_kernel_mt; B2, the window) and flash_mode_attention (body
// _flash_kernel; B8, the dense table: the f2 site under --intrapos lsinu,
// no table, and under --f2radius, the table pos_w * bias + the -1e9 mask).
// Two value widths F: 256, the f2 site's, and 128, the intra aggregator's,
// where the lazy intra path (probs past 4e9 bytes: HD1K, 1080p frames,
// large batches; craft_tpu/nn/setrans.py:826-836) runs B2 once an
// iteration with md 32.
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64,
// F=256) it is 127 GFLOP, 80 % of it p.v, over 36 MB of inputs and outputs
// (B8 with a table adds 198 MB of fp32 table, 59 us, still under the 128 us
// of the bf16 peak); at HD1K's lazy aggregator (B=1, M=4, U=43520, md=32,
// F=128) 2.42 TFLOP, and the exponentials (7.6e9) take 74 % as long on
// the SFUs.  Offsets that reach U1 * U2 or a row times F are formed in
// size_t: at HD1K U * U is within 12 % of 2^31.  Three bodies: for bf16
// the F = 256 body up to md 64 and the pipelined body (F = 128 up to md
// 128, F = 256 past md 64), for fp32 the FMA body.
//
// bf16, F = 256, md <= 64 (flash_wgmma_kernel): the products on the tensor
// cores as wgmma
// (sm_90a), bf16 operands and fp32 sums.  A block is two warpgroups, each
// owning 64 query rows (a warp 16): its q fragments stay in registers for
// the whole key sweep (read once from global memory, so q takes no shared
// memory), as does its 64 x F fp32 output accumulator (128 registers a
// thread).  Per key tile of 64: S = q k^T as 64 x 64 x 16 wgmmas (A = the q
// registers, B = k from shared memory); the clamp, the bias, the ragged-key
// mask and the online softmax (fp32, two quad shuffles per row max) run on
// S in its accumulator layout; p, rounded to bf16 as the Pallas kernels
// round it before p.v, is repacked in registers as the A operand of
// o += p v (64 x F x 16 wgmmas, v from shared memory, MN-major): the
// m16n8 accumulator layout of two adjacent n tiles is the m16k16 A layout,
// so p never touches shared memory.  A warpgroup starts o += p v(kt) and
// S(kt + 1) together and waits once; the two warpgroups take turns to start
// theirs (named barriers), so one's softmax runs under the other's
// products.  The running max moves only when a tile's max passes it by more
// than MAX_SLACK (p <= e^8), so o is rescaled on few tiles; the row sum
// takes the fp32 p and is reduced over the quad once, at the end.
//   Keys arrive through a ring of 4 stages (3 with a table) in shared
// memory: k (64 x md bf16), v (64 x F bf16) and a table's 128 x 64 fp32
// tile, 40 KB a stage at md 64 (72 KB with a table), filled by 16-byte
// cp.async
// whose completion an mbarrier counts (full); a second mbarrier per stage
// (empty) frees it once both warpgroups are done, and tile kt + 3 (kt + 2)
// is copied while tile kt is multiplied.  Each thread copies fixed chunk
// columns, its offsets set once per block.  k rows and v's 64-feature
// blocks (F / 64 of them) are laid out with the 128-, 64- or 32-byte
// swizzle that wgmma's descriptors name (16-byte chunk index XOR row bits),
// conflict-free.
//   Sizes: about 245 registers a thread, 160 (216) KB of shared memory, one
// block of 256 threads an SM.  Serving (U=7040, 4 modes) launches 55 x 4 =
// 220 blocks on 132 SMs, 1.67 waves; KITTI (U=7332) 58 x 4 = 232, 1.76
// waves (the last wave leaves a third of the SMs idle; 64-row blocks, two
// an SM, gave the same 1.67).  The grid runs the B*M blocks of one q tile
// back to back (modes fastest), so the table tile that the 4 modes of a q
// tile share comes from L2 after the first: B8 reads its 198 MB table from
// HBM once, not once per mode (792 MB).
//   The window (B2) sits in shared memory.  Per (16-row warp, key tile) one
// warp-uniform test decides whether any key lies within +-R grid rows of
// any of the warp's queries (about 31 of the 110 key tiles at R = 7,
// W8 = 128): outside that band the tile adds no bias; inside it each
// fragment element looks its window entry up from its (row, column) token
// coordinates, the key coordinates stepped along the thread's columns
// without a division per element.  The q_tok0 offset of a row shard enters
// the row coordinates once per block.  The wrappers raise unless a bf16 md
// is a multiple of 16 (md 48 runs the 64-wide tiles with zero columns, md
// 80 to 240 the 128- or 256-wide ones) and q, k, v and out are 16-byte
// aligned; a table whose rows are not (U2 % 4 != 0) is staged by 4-byte
// copies.
//
// bf16, the pipelined body (flash_pipe_kernel): F = 128 up to md 128 (the
// lazy intra aggregator; the intra site is 128 wide) and F = 256 past md
// 64 (one or two modes at a 256-wide site), on the same fragments, p
// repacking and MAX_SLACK as the F = 256 body, with what those shapes need
// beside it:
//   - k and v tiles come by the tensor memory accelerator (TMA: tensor maps
//     of k and v as [B * M * U2] rows, encoded per launch on the host,
//     boxes landing in the swizzled layouts that wgmma's descriptors name),
//     issued by a producer warpgroup beside the two consumer warpgroups:
//     its first thread copies every tile in order, each once its stage's
//     last tile is done (the stage's empty barrier), and announces its
//     bytes on the stage's full barrier.  The consumers spend no
//     instructions on copies, need no proxy fence and never wait for each
//     other.  The producer gives its registers up by setmaxnreg (24 a
//     thread), the consumers take them (240; 168 at launch for 384
//     threads).  tools/time_flash_variants.py: against the consumers'
//     thread 0 refilling the stage of the tile before last, 5-19 % less
//     time, but for B8's table (+1-3 %); a producer warp without
//     setmaxnreg spills (ptxas gives 288 threads 168 registers too).
//   - Past md 64, q (128 rows x md bf16, 32 or 64 KB) sits in shared memory
//     as md / 64 swizzled chunks and S takes both operands through
//     descriptors (wgmma_ss64): q's fragments would take 64 registers a
//     thread at md 256 beside o's 128.  k is staged as the same chunks, and
//     S loops over them (4 at md 256, 2 at 128).
//   - At F = 128 a key tile is 128 keys: S is 64 x 128 fp32 in the 64
//     accumulator registers F = 128 leaves free of o, S = two 64-key
//     wgmma halves, p v eight k16 steps; a block's barriers, row-max
//     shuffles and rescale tests are half as many a key.  64-key tiles at
//     F = 256, where o takes 128 registers.
//   - A warpgroup starts S(i) and o += p(i - 1) v(i - 1) together, waits
//     for S alone (wgmma_wait1) and runs S(i)'s epilogue while the tensor
//     cores take its own p v and the other warpgroup's products; then waits
//     for p v, rescales o and packs p(i).  The two warpgroups run free (no
//     turns: they cost 3-6 % at F = 128).  The softmax works in units of
//     q.k: the clamp at +-clip / scale, the bias times pos_w / scale, and
//     p = 2^(y c - m c) with c = scale log2 e (one FFMA an element); row
//     maxima and sums run in four partials a row.  The clamp is skipped
//     where clip is 1e30 (B1's predicate found nothing to clamp).
//   - The ring holds as many k | v stages as fit beside q (pipe_stages: 4,
//     3 past md 64 at F 128, 2 at md 256 and F 256).
//   - The grid runs q tiles fastest, so that the blocks on the card at once
//     share one (b, m)'s k and v in L2.
//   - Key splits (pipe_partials): where the q tiles would leave SMs idle
//     (55 blocks at one mode on the serving grid) the keys of each q tile
//     are split over up to PMAX_SPLITS blocks that write their unnormalised
//     o and (max, sum) rows; flash_combine_kernel adds them in split order,
//     so two runs give the same bits.  The wrapper chooses the split
//     (mode_attention.py flash_splits) and sizes the scratch.
//   - A table is read from global memory into the fragments
//     (MmaTableDirect, whole 32-byte sectors): beside q and two stages of
//     md 256 a staged table tile does not fit.
//
// fp32 (flash_attn_kernel): plain fp32 FMA, kept for fp32 parity (--fullprec
// and the fp32 oracle; TF32 would not hold 1e-5), at md up to 256, staged
// at a 256 stride past md 64.  Each block keeps a 64-row
// q tile and its 64 x F output accumulator resident (F / 4 floats a
// thread)
// and streams k and v tiles (and a table tile) through shared memory.  The
// running row max and sum are kept per thread for its four rows; the
// online-softmax rescale multiplies the thread's own accumulator rows.
//
// All bodies: a row whose first key tiles are all masked by -1e9 runs at
// max ~ -1e9 until its unmasked keys arrive, and then alpha = exp(-1e9 -
// max) = 0 wipes what it summed: the diagonal is never masked, so every
// row ends finite.  Ragged U1 and U2 are masked in the kernel, so there is
// no padded copy (the TPU's [2R+1, W8, W8] Toeplitz table was a Mosaic
// workaround).
#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

// F: the value / output width, 256 (the f2 site's feat_dim) or 128 (the
// intra aggregator's feat_dim, the lazy intra path); the launches refuse
// any other.  MDS: the staged tiles' mode dim stride (MAXMD, or MAXMD_FMA
// for md 128 and 256: 227 KB at F = 256 with a table).
template <int F, class Bias, int MDS>
__global__ void __launch_bounds__(NTHREADS)
    flash_attn_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      BiasArgs ba, const float* __restrict__ clip_ptr, int U1,
                      int U2, int md, float scale, float pos_w) {
  constexpr int FJ = F / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [MDS][SPAD]
  float* ks = qs + MDS * SPAD;         // [MDS][SPAD]
  float* ps = ks + MDS * SPAD;         // [TILE][SPAD]: p[key][row]
  float* vs = ps + TILE * SPAD;        // [TILE][F]
  float* bsm = vs + TILE * F;          // Bias::SMEM
  const int qt = blockIdx.x, bm = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qbase = (size_t)bm * U1, kbase = (size_t)bm * U2;
  load_tile_t(qs, q + qbase * md, qt * TILE, U1, md);
  Bias bias;
  bias.init(bsm, ba, qt);
  const float clip = clip_ptr[0];

  float o[4][FJ];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < FJ; ++j) o[i][j] = 0.f;
  }

  const int nk = (U2 + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile_t(ks, k + kbase * md, kt * TILE, U2, md);
    for (int e = threadIdx.x; e < TILE * F; e += NTHREADS) {
      int r = e / F, f = e - r * F;
      int row = kt * TILE + r;
      vs[e] = row < U2 ? to_f(v[(kbase + row) * F + f]) : 0.f;
    }
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
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = fminf(fmaxf(s[i][j] * scale, -clip), clip);
        x += pos_w * bias.at(i, j);
        s[i][j] = kvalid[j] ? x : NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = row_max16(tmax);
      const float m_new = fmaxf(mrow[i], tmax);
      const float alpha = expf(mrow[i] - m_new);
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        tsum += p;
        ps[(tx + 16 * j) * SPAD + ty + 16 * i] = p;
      }
      lrow[i] = lrow[i] * alpha + row_sum16(tsum);
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < FJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < TILE; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[kk * SPAD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        const float b = vs[kk * F + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(a[i], b, o[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = qt * TILE + ty + 16 * i;
    if (row >= U1) continue;
    const float inv = 1.f / lrow[i];
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      out[(qbase + row) * F + tx + 16 * j] = o[i][j] * inv;
  }
}

template <int F, class Bias, int MDS>
static int launch_fma_md(const void* q, const void* k, const void* v,
                         void* out, const BiasArgs& ba, const void* clip,
                         int BM, int U1, int U2, int md, float scale,
                         float pos_w, cudaStream_t s) {
  const size_t smem = (2 * MDS * SPAD + TILE * SPAD + TILE * F +
                       Bias::SMEM) * sizeof(float);
  cudaError_t err = allow_smem(flash_attn_kernel<F, Bias, MDS>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  flash_attn_kernel<F, Bias, MDS><<<grid, NTHREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, ba,
      (const float*)clip, U1, U2, md, scale, pos_w);
  return (int)cudaGetLastError();
}

// The FMA body: md up to 256, at the stride of md.
template <int F, class Bias>
static int launch_fma(const void* q, const void* k, const void* v, void* out,
                      const BiasArgs& ba, const void* clip, int BM, int U1,
                      int U2, int md, float scale, float pos_w,
                      cudaStream_t s) {
  if (md <= 0 || md > MAXMD_FMA) return (int)cudaErrorInvalidValue;
  if (md <= MAXMD)
    return launch_fma_md<F, Bias, MAXMD>(q, k, v, out, ba, clip, BM, U1, U2,
                                         md, scale, pos_w, s);
  return launch_fma_md<F, Bias, MAXMD_FMA>(q, k, v, out, ba, clip, BM, U1,
                                           U2, md, scale, pos_w, s);
}

// ---------------------------------------------------------------------------
// The bf16 body on the tensor cores
// ---------------------------------------------------------------------------

#define MROWS 128           // query rows per block: 2 warpgroups x 64
#define MKEYS 64            // keys per tile
#define MWARPS (MROWS / 16)  // a warp owns 16 query rows
#define MTHREADS (MWARPS * 32)
#define MAX_SLACK 8.f       // how far p's exponent may exceed 0

// The (2R+1)^2 window of B2 on this block's fragments (wgmma.cuh).
typedef MmaWindowT<MROWS, MKEYS, MTHREADS> MmaWindow;

// Bias sources of the bf16 body (wgmma.cuh): none, and a dense table's
// 128 x 64 fp32 tile a stage.
typedef MmaTableT<MROWS, MKEYS, MTHREADS> MmaTable;

// Ring depth: 4 stages of k and v (160 KB), 3 with a table tile (216 KB).
template <class Bias>
__host__ __device__ constexpr int ring_depth() {
  return Bias::STAGE > 0 ? 3 : 4;
}

// MDP: the tiles' mode dim (16, 32 or 64 >= md; columns past md are zero);
// F: the value / output width (the launchers take 256 alone).
template <int MDP, int F, class Bias>
__global__ void __launch_bounds__(MTHREADS, 1)
    flash_wgmma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       BiasArgs ba, const float* __restrict__ clip_ptr,
                       int U1, int U2, int md, float scale, float pos_w) {
  constexpr int KC = MDP / 8;    // 16-byte chunks of a k row
  constexpr int K_BYTES = MKEYS * MDP * 2, V_BYTES = MKEYS * F * 2;
  constexpr int VBLK = MKEYS * 128;  // v: F / 64 blocks of 64 keys x 64
                                     // features
  constexpr int STAGE = K_BYTES + V_BYTES + Bias::STAGE;
  constexpr int NST = ring_depth<Bias>();
  static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle atoms");
  constexpr int NT = MKEYS / 8;  // n tiles of 8 keys in a key tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  const int bm = blockIdx.x, qt = blockIdx.y;  // modes fastest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bm * U1 * md;
  const bf16* kb = k + (size_t)bm * U2 * md;
  const bf16* vb = v + (size_t)bm * U2 * F;

  const int wg = threadIdx.x >> 7;  // warpgroup 0 or 1
  Bias bias;
  bias.init(smem + NST * STAGE, ba, qt);
  // Ring barriers: full[s] completes when the 256 threads' copies into
  // stage s have landed, empty[s] when all 256 threads are done with it.
  const uint32_t full0 = smem_u32(smem + NST * STAGE + Bias::SMEM);
  const uint32_t empty0 = full0 + 8 * NST;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(full0 + 8 * i, MTHREADS);
      mbar_init(empty0 + 8 * i, MTHREADS);
    }
  }
  __syncthreads();  // the barriers and the bias source's shared memory

  // k rows at MDP * 2 bytes, their chunks swizzled; v as F / 64 blocks of
  // 64 features, 128-byte rows, chunks swizzled by key % 8 (the 128-byte
  // swizzle of an MN-major wgmma operand).  Each thread copies the same
  // chunk column of rows KROWS (k) and VROWS (v: 8 at F = 256, 16 at 128)
  // apart, so its shared and global offsets are fixed here and a tile adds
  // key0 and constants.
  constexpr int KROWS = MTHREADS / KC;  // k rows a pass covers
  constexpr int KIT = (MKEYS + KROWS - 1) / KROWS;
  const int tid = threadIdx.x;
  const int k_r = tid / KC, k_c = tid % KC;
  const bool k_on = k_r < MKEYS && 8 * k_c < md;  // else zeros (md 48)
  const bf16* k_src =
      k_on ? kb + (size_t)k_r * md + 8 * k_c : kb;
  const uint32_t k_dst = k_r * MDP * 2 + 16 * swz<KC>(k_r, k_c);
  constexpr int VC = F / 8;              // 16-byte chunks of a v row
  constexpr int VROWS = MTHREADS / VC;   // v rows a pass covers
  static_assert(MKEYS % VROWS == 0, "whole passes of v rows");
  const int v_r = tid / VC, v_c = tid % VC;  // row + VROWS it
  const bf16* v_src = vb + (size_t)v_r * F + 8 * v_c;
  const uint32_t v_dst = K_BYTES + (v_c >> 3) * VBLK + v_r * 128 +
                         16 * ((v_c & 7) ^ (v_r & 7));
  auto load_stage = [&](int kt, int s) {
    unsigned char* st = smem + s * STAGE;
    const uint32_t sa = smem_u32(st);
    const int key0 = kt * MKEYS;
    const int left = U2 - key0;  // keys of this tile that exist
#pragma unroll
    for (int it = 0; it < KIT; ++it) {
      const bool ok = k_on && k_r + KROWS * it < min(left, MKEYS);
      if (KROWS <= MKEYS || k_r < MKEYS)  // MDP 16: threads 0..127
        cp_async16(sa + k_dst + it * KROWS * MDP * 2,
                   ok ? k_src + (size_t)(key0 + KROWS * it) * md : kb, ok);
    }
    const bf16* vsrc = v_src + (size_t)key0 * F;
    if (left >= MKEYS) {
#pragma unroll
      for (int it = 0; it < MKEYS / VROWS; ++it)
        cp_async16(sa + v_dst + it * VROWS * 128, vsrc + it * VROWS * F,
                   true);
    } else {
#pragma unroll
      for (int it = 0; it < MKEYS / VROWS; ++it) {
        const bool ok = v_r + VROWS * it < left;
        cp_async16(sa + v_dst + it * VROWS * 128,
                   ok ? vsrc + it * VROWS * F : vb, ok);
      }
    }
    bias.load(st + K_BYTES + V_BYTES, kt);
  };

  const int nk = (U2 + MKEYS - 1) / MKEYS;
#pragma unroll
  for (int kt = 0; kt < NST - 1; ++kt) {
    if (kt < nk) {
      load_stage(kt, kt);
      mbar_arrive_copies(full0 + 8 * kt);
    }
  }

  // q fragments (A of m16n8k16 and of the warp's share of wgmma) for rows
  // r0 = warp * 16 + g and r0 + 8: a0 (r0, 2t..2t+1), a1 (r0 + 8, 2t..),
  // a2 (r0, 2t + 8..), a3 (r0 + 8, 2t + 8..) of each 16-wide slice.
  const int r0 = qt * MROWS + warp * 16 + g;
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

  float o[F / 8][4];
#pragma unroll
  for (int n = 0; n < F / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

  // S = q k^T of the tile in stage s: one 64 x 64 x 16 wgmma per 16-wide
  // slice of the mode dim (the first with scale_d 0: sc = q k^T), started,
  // not waited for.
  float sc[NT][4] = {};
  auto start_s = [&](int s) {
    wgmma_fence();
    const uint32_t ks = smem_u32(smem + s * STAGE);
#pragma unroll
    for (int kd = 0; kd < MDP / 16; ++kd)
      wgmma_s(sc, qa[kd],
              gmma_desc(ks + 32 * kd, 16, KLayout<MDP>::SBO,
                        KLayout<MDP>::TYPE),
              kd);
    wgmma_commit();
  };

  mbar_wait(full0, 0);  // tile 0
  fence_async_smem();
  start_s(0);
  wgmma_wait0();
  if (wg == 1) bar_arrive<MTHREADS>(1);  // warpgroup 0 goes first

  // Per tile kt (stage s): the epilogue of S(kt) on its fragments, then
  // o += p v(kt) and S(kt + 1) started back to back, so the tensor cores run
  // both while the warps wait once.  The two warpgroups take turns to start
  // them (named barriers 1 and 2), so one's epilogue runs under the
  // other's products.
  for (int kt = 0, s = 0; kt < nk; ++kt, s = s == NST - 1 ? 0 : s + 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(sc[j][e]);
    unsigned char* st = smem + s * STAGE;

#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = fminf(fmaxf(sc[j][e] * scale, -clip), clip);
    bias.add(sc, kt, st + K_BYTES + V_BYTES, pos_w);
    const int key0 = kt * MKEYS;
    if (key0 + MKEYS > U2) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * t + (e & 1) >= U2) sc[j][e] = NEG_INF;
    }

    // Online softmax on the fragments: rows i = 0 (e < 2) and 1 (e >= 2),
    // each spread over the 4 lanes of a quad.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // The running max moves only when the tile's max passes it by more
      // than MAX_SLACK: below that p = exp(x - m) <= e^MAX_SLACK stays well
      // inside bf16 and fp32, o and l keep their scale, and the softmax is
      // the same; o is rescaled on few tiles.
      const bool move = mx > mrow[i] + MAX_SLACK;
      const float m_new = move ? mx : mrow[i];
      alpha[i] = move ? exp2_approx((mrow[i] - m_new) * LOG2E) : 1.f;
      mrow[i] = m_new;
      // exp(x - m) = 2^(x log2 e - m log2 e), one FFMA: m log2 e rounds by
      // at most 64 where m ~ -1e9 (a row that has met only masked keys), so
      // such a row sums finite values (< 2^64) that its first unmasked key
      // wipes with alpha = 0.
      const float ml = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_approx(fmaf(sc[j][2 * i + c], LOG2E, -ml));
          sc[j][2 * i + c] = p;
          sum += p;
        }
      lrow[i] = lrow[i] * alpha[i] + sum;  // this lane's share of the row
    }
    // Rescale only where a row max moved.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < F / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // o += bf16(p) v: the C fragments of n tiles 2 kk and 2 kk + 1 are the
    // A fragment of keys 16 kk .. + 15; one 64 x F x 16 wgmma each.
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    const uint32_t vs = smem_u32(st + K_BYTES);
    bar_sync<MTHREADS>(1 + wg);  // this warpgroup's turn
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_o<F>(o, pa[kk], gmma_desc(vs + kk * 16 * 128, VBLK, 1024, 1),
                 1);
    wgmma_commit();
    if (kt + 1 < nk) {
      const int s1 = s == NST - 1 ? 0 : s + 1;
      mbar_wait(full0 + 8 * s1, ((kt + 1) / NST) & 1);  // tile kt + 1
      fence_async_smem();
      start_s(s1);
    }
    if (wg == 0 || kt + 1 < nk) bar_arrive<MTHREADS>(2 - wg);  // the other's turn
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < F / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(o[n][e]);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(pa[kk][e]);
    mbar_arrive(empty0 + 8 * s);  // done with tile kt
    // Tile kt + NST - 1 into the stage of tile kt - 1, once both
    // warpgroups are done with that.
    if (kt + NST - 1 < nk) {
      const int sp = s == 0 ? NST - 1 : s - 1;
      if (kt > 0) mbar_wait(empty0 + 8 * sp, ((kt - 1) / NST) & 1);
      load_stage(kt + NST - 1, sp);
      mbar_arrive_copies(full0 + 8 * sp);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * i;
    if (row >= U1) continue;
    const float inv = 1.f / l;
    bf16* dst = out + ((size_t)bm * U1 + row) * F + 2 * t;
#pragma unroll
    for (int n = 0; n < F / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int MDP, int F, class Bias>
static int launch_wgmma_md(const void* q, const void* k, const void* v,
                           void* out, const BiasArgs& ba, const void* clip,
                           int BM, int U1, int U2, int md, float scale,
                           float pos_w, cudaStream_t s) {
  constexpr int STAGE = MKEYS * MDP * 2 + MKEYS * F * 2 + Bias::STAGE;
  // + 1024: the ring starts at the first 1024-byte boundary (the swizzle
  // atoms' alignment).
  const size_t smem =
      ring_depth<Bias>() * (STAGE + 16) + Bias::SMEM + 1024;  // + barriers
  auto kernel = flash_wgmma_kernel<MDP, F, Bias>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BM, (U1 + MROWS - 1) / MROWS);
  kernel<<<grid, MTHREADS, smem, s>>>((const bf16*)q, (const bf16*)k,
                                      (const bf16*)v, (bf16*)out, ba,
                                      (const float*)clip, U1, U2, md, scale,
                                      pos_w);
  return (int)cudaGetLastError();
}

// md a multiple of 16 up to 64, q, k, v and out 16-byte aligned.
template <int F, class Bias>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        void* out, const BiasArgs& ba, const void* clip,
                        int BM, int U1, int U2, int md, float scale,
                        float pos_w, cudaStream_t s) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)out;
  if (md <= 0 || md > MAXMD || md % 16 != 0 || (align & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (md <= 16)
    return launch_wgmma_md<16, F, Bias>(q, k, v, out, ba, clip, BM, U1, U2,
                                        md, scale, pos_w, s);
  if (md <= 32)
    return launch_wgmma_md<32, F, Bias>(q, k, v, out, ba, clip, BM, U1, U2,
                                        md, scale, pos_w, s);
  return launch_wgmma_md<64, F, Bias>(q, k, v, out, ba, clip, BM, U1, U2,
                                      md, scale, pos_w, s);
}

// ---------------------------------------------------------------------------
// The pipelined bf16 body: F = 128 up to md 128, F = 256 past md 64
// ---------------------------------------------------------------------------

#define PROWS 128        // query rows per block: 2 warpgroups x 64
#define PTHREADS 256     // the consumers; a producer warpgroup beside them
#define PPRODUCER 128    // the producer warpgroup, which copies k and v
#define PREG_PRODUCER 24   // registers a producer thread keeps (setmaxnreg)
#define PREG_CONSUMER 240  // registers a consumer thread takes
static_assert(PTHREADS * PREG_CONSUMER + PPRODUCER * PREG_PRODUCER <= 65536,
              "the consumers' and the producer's registers fit an SM's");
#define PMAX_STAGES 4    // the ring's most stages
#define PMAX_SPLITS 4    // the most key splits of a q tile (grid fill)
#define PSMEM 232448     // shared memory a block may take on an H100

// Keys a tile: 128 at F = 128 (S as 64 x 128 fp32 in the registers that
// F = 128 leaves free of o), 64 at F = 256.
template <int MDP, int F>
__host__ __device__ constexpr int pipe_keys() {
  return F == 128 ? 128 : 64;
}
// q in shared memory past md 64 (its fragments would take 64 registers a
// thread at md 256 beside o); in registers up to it.
template <int MDP>
__host__ __device__ constexpr int pipe_q_bytes() {
  return MDP > MAXMD ? PROWS * MDP * 2 : 0;
}
// A stage: the k tile (NK x MDP bf16) and the v tile (NK x F bf16).
template <int MDP, int F>
__host__ __device__ constexpr int pipe_stage_bytes() {
  return pipe_keys<MDP, F>() * (MDP + F) * 2;
}
// As many stages as fit beside q and the bias source (+ 1024: the first
// 1024-byte boundary; + 16 a stage: its two mbarriers), at most
// PMAX_STAGES: 2 at md 256 and F 256, 3 at md 128 and F 128, 4
// otherwise.
template <int MDP, int F, class Bias>
__host__ __device__ constexpr int pipe_stages() {
  return (PSMEM - 1024 - pipe_q_bytes<MDP>() - Bias::SMEM) /
                     (pipe_stage_bytes<MDP, F>() + 16) >
                 PMAX_STAGES
             ? PMAX_STAGES
             : (PSMEM - 1024 - pipe_q_bytes<MDP>() - Bias::SMEM) /
                   (pipe_stage_bytes<MDP, F>() + 16);
}
template <int MDP, int F, class Bias>
__host__ __device__ constexpr size_t pipe_smem() {
  return 1024 + pipe_q_bytes<MDP>() +
         pipe_stages<MDP, F, Bias>() * (pipe_stage_bytes<MDP, F>() + 16) +
         Bias::SMEM;
}
// The split partials (fp32): nsplit x BM x U1 x F unnormalised o, then
// nsplit x BM x U1 x (max in exp2 units, row sum); none for one split.
static inline long long pipe_partials(int BM, int U1, int F, int nsplit) {
  return nsplit > 1 ? (long long)nsplit * BM * U1 * (F + 2) : 0;
}

// A dense table read straight from global memory into the fragments (no
// stage: beside q and two k/v stages of md 256, a 32 KB table tile a stage
// does not fit).  A quad reads one 32-byte sector of a row per n tile (8
// bytes a thread where the rows are 8-byte aligned), so the reads are
// whole sectors; they are issued as the tile's scores are ready, their
// latency under the other warpgroup's products.
template <int ROWS, int KEYS>
struct MmaTableDirect {
  static constexpr int STAGE = 0, SMEM = 0;
  const float* table;
  int U1, U2, row;  // row: the thread's first row (g), + 8 the second
  bool pairs;       // 8-byte reads: the table 8-byte aligned, U2 even
  __device__ __forceinline__ void init(unsigned char*, const BiasArgs& a,
                                       int qt) {
    table = a.data;
    U1 = a.U1;
    U2 = a.U2;
    row = qt * ROWS + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
    pairs = ((uintptr_t)table & 7) == 0 && (U2 & 1) == 0;
  }
  __device__ __forceinline__ void load(unsigned char*, int) {}
  __device__ __forceinline__ void add(float (*sc)[4], int kt, unsigned char*,
                                      float pos_w) const {
    const int col0 = kt * KEYS + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r >= U1) continue;
      const float* tr = table + (size_t)r * U2;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const int col = col0 + 8 * j;
        float b0 = 0.f, b1 = 0.f;
        if (pairs) {
          if (col < U2) {
            const float2 b = __ldg(reinterpret_cast<const float2*>(tr + col));
            b0 = b.x;
            b1 = b.y;
          }
        } else {
          if (col < U2) b0 = __ldg(tr + col);
          if (col + 1 < U2) b1 = __ldg(tr + col + 1);
        }
        sc[j][2 * i] += pos_w * b0;
        sc[j][2 * i + 1] += pos_w * b1;
      }
    }
  }
};

// A box of a 2D tensor map (tensor coordinates c0 along the rows, c1 the
// row) into shared memory at dst, its bytes completed on the mbarrier at
// bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// Barrier inits made visible to the copy engine before its first copy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The bias sources of the pipelined body: the window at its key tile, none,
// the table from global memory.
template <int NK>
using PipeWindow = MmaWindowT<PROWS, NK, PTHREADS>;
template <int NK>
using PipeNoBias = MmaNoBias;
template <int NK>
using PipeTable = MmaTableDirect<PROWS, NK>;

// The pipelined body.  Bias<NK>: PipeWindow, PipeNoBias or PipeTable.
// Split blockIdx.z of gridDim.z takes key tiles [z nk / nsplit, (z + 1) nk /
// nsplit) and, past one split, writes its unnormalised o and its (max,
// sum) rows to `part` (pipe_partials) for flash_combine_kernel.  Threads
// 0 .. PTHREADS - 1 are the consumers, the PPRODUCER after them the
// producer.
template <int MDP, int F, template <int> class BiasT>
__global__ void __launch_bounds__(PTHREADS + PPRODUCER, 1)
    flash_pipe_kernel(const bf16* __restrict__ q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      bf16* __restrict__ out, float* __restrict__ part,
                      BiasArgs ba, const float* __restrict__ clip_ptr, int U1,
                      int U2, int md, float scale, float pos_w) {
  constexpr int NK = pipe_keys<MDP, F>();
  typedef BiasT<NK> Bias;
  constexpr int KW = MDP < 64 ? MDP : 64;  // a k (q) chunk's width
  constexpr int KCH = MDP / KW;            // chunks of the mode dim
  constexpr int KCB = NK * KW * 2;         // bytes of a k chunk
  constexpr int K_BYTES = NK * MDP * 2;
  constexpr int VBLK = NK * 128;  // v: F / 64 blocks of NK keys x 64
  constexpr int STAGE = pipe_stage_bytes<MDP, F>();
  constexpr int NST = pipe_stages<MDP, F, Bias>();
  constexpr int QB = pipe_q_bytes<MDP>();
  constexpr bool QS = QB > 0;
  constexpr int NT = NK / 8;  // n tiles of 8 keys in a key tile
  static_assert(STAGE % 1024 == 0 && QB % 1024 == 0,
                "stages and q keep the 1024-byte swizzle atoms");
  static_assert(NST >= 2, "a ring of at least two stages");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* ring = smem + QB;
  // q tiles fastest in the grid: the blocks on the card at once share one
  // (b, m)'s k and v in L2 (HD1K's four modes hold 56 MB, past the 50 MB
  // L2).
  const int qt = blockIdx.x, bm = blockIdx.y, BM = gridDim.y;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = tid >> 7;
  const bf16* qb = q + (size_t)bm * U1 * md;
  const int nk_all = (U2 + NK - 1) / NK;
  const int kt0 = split * nk_all / nsplit;
  const int n = (split + 1) * nk_all / nsplit - kt0;  // >= 1 tiles

  Bias bias;
  if (tid < PTHREADS) bias.init(ring + NST * STAGE, ba, qt);
  const uint32_t full0 = smem_u32(ring + NST * STAGE + Bias::SMEM);
  const uint32_t empty0 = full0 + 8 * NST;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, PTHREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers and the bias source's shared memory

  // k and v tiles by the tensor memory accelerator, which lays them out as
  // wgmma's descriptors name them: k as KCH chunks of KW columns (KW *
  // 2-byte rows, the 128-, 64- or 32-byte swizzle), v as F / 64 blocks of
  // 64 features (128-byte rows, the 128-byte swizzle of an MN-major
  // operand).  The producer's first thread copies a tile: its bytes
  // announced on the stage's full barrier, which the copies complete.
  // Rows past U2 are the next (b, m)'s keys or zeros past the tensor; their
  // scores are masked.
  const int row0 = bm * U2;  // this (b, m)'s first row of k and v
  auto load_stage = [&](int kt, int s) {
    unsigned char* st = ring + s * STAGE;
    const uint32_t sa = smem_u32(st), bar = full0 + 8 * s;
    const int r = row0 + kt * NK;
    mbar_arrive_expect_tx(bar, STAGE);
#pragma unroll
    for (int c = 0; c < KCH; ++c)
      tma_load_2d(sa + c * KCB, &tm_k, 64 * c, r, bar);
#pragma unroll
    for (int b = 0; b < F / 64; ++b)
      tma_load_2d(sa + K_BYTES + b * VBLK, &tm_v, 64 * b, r, bar);
  };
  if (tid >= PTHREADS) {  // the producer
    setmaxnreg_dec<PREG_PRODUCER>();
    if (tid == PTHREADS)
      for (int i = 0; i < n; ++i) {
        const int s = i % NST;
        if (i >= NST) mbar_wait(empty0 + 8 * s, ((i - NST) / NST) & 1);
        load_stage(kt0 + i, s);
      }
    return;
  }
  setmaxnreg_inc<PREG_CONSUMER>();
  if constexpr (QS) {  // q's 128 rows, as k's chunks, by cp.async
    constexpr int KRC = MDP / 8;           // 16-byte chunks of a row
    constexpr int QROWS = PTHREADS / KRC;  // rows a pass covers
    const int kr = tid / KRC, kc = tid % KRC;
    const uint32_t qa0 = smem_u32(smem) + (kc / 8) * (PROWS * 128) +
                         kr * 128 + 16 * ((kc & 7) ^ (kr & 7));
#pragma unroll
    for (int it = 0; it < PROWS / QROWS; ++it) {
      const int row = qt * PROWS + kr + QROWS * it;
      const bool ok = 8 * kc < md && row < U1;
      cp_async16(qa0 + it * QROWS * 128,
                 ok ? qb + (size_t)row * md + 8 * kc : qb, ok);
    }
    cp_async_wait_all();
    fence_async_smem();  // q, written by cp.async, to wgmma's reads
    bar_sync<PTHREADS>(1);  // the consumers alone
  }

  // q fragments in registers up to md 64 (the A layout of wgmma_s) for
  // rows r0 = qt * 128 + warp * 16 + g and r0 + 8.
  const int r0 = qt * PROWS + warp * 16 + g;
  uint32_t qa[QS ? 1 : MDP / 16][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kd = 0; kd < MDP / 16; ++kd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e & 1),
                  col = 16 * kd + 8 * (e >> 1) + 2 * t;
        qa[kd][e] = row < U1 && col < md
                        ? *reinterpret_cast<const uint32_t*>(
                              qb + (size_t)row * md + col)
                        : 0u;
      }
  }
  // The softmax in units of q.k: y = clamp(q.k, +-clip / scale) + pos_w /
  // scale * bias, p = 2^(y c - m c) with c = scale log2 e (one FFMA), the
  // running max m moving only when a tile's passes it by MAX_SLACK / scale.
  const float clip = clip_ptr[0];
  const bool clamp = clip < 1e29f;  // 1e30: no clamp (B1's predicate)
  const float cy = clip / scale, pos_y = pos_w / scale;
  const float c2 = scale * LOG2E, slack = MAX_SLACK / scale;

  float o[F / 8][4];
#pragma unroll
  for (int j = 0; j < F / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f}, alpha[2];
  float sc[NT][4];
  uint32_t pa[NT / 2][4];

  // S = q k^T of the tile in stage s, 64 keys a wgmma, not waited for.
  auto start_s = [&](int s) {
    const uint32_t ks = smem_u32(ring + s * STAGE);
    if constexpr (QS) {
      const uint32_t qs = smem_u32(smem) + wg * 64 * 128;
#pragma unroll
      for (int c = 0; c < KCH; ++c)
#pragma unroll
        for (int kd = 0; kd < 4; ++kd)
#pragma unroll
          for (int h = 0; h < NK / 64; ++h)
            wgmma_ss64(&sc[8 * h],
                       gmma_desc(qs + c * PROWS * 128 + 32 * kd, 16, 1024, 1),
                       gmma_desc(ks + c * KCB + h * 64 * 128 + 32 * kd, 16,
                                 1024, 1),
                       c + kd);
    } else {
#pragma unroll
      for (int kd = 0; kd < MDP / 16; ++kd)
#pragma unroll
        for (int h = 0; h < NK / 64; ++h)
          wgmma_s(&sc[8 * h], qa[kd],
                  gmma_desc(ks + h * 64 * MDP * 2 + 32 * kd, 16,
                            KLayout<MDP>::SBO, KLayout<MDP>::TYPE),
                  kd);
    }
  };
  // o += bf16(p) v of the tile in stage s: the C fragments of n tiles 2 kk
  // and 2 kk + 1 are the A fragment of keys 16 kk .. + 15.
  auto start_pv = [&](int s) {
    const uint32_t vs = smem_u32(ring + s * STAGE + K_BYTES);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      wgmma_o<F>(o, pa[kk], gmma_desc(vs + kk * 16 * 128, VBLK, 1024, 1), 1);
  };
  // The epilogue of S on its fragments (rows i = 0 and 1, each over the 4
  // lanes of a quad): p in sc, alpha the rescale of o, l this lane's share.
  auto softmax = [&](int kt, unsigned char* st) {
    if (clamp) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = fminf(fmaxf(sc[j][e], -cy), cy);
    }
    bias.add(sc, kt, st + STAGE, pos_y);
    const int key0 = kt * NK;
    if (key0 + NK > U2) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * t + (e & 1) >= U2) sc[j][e] = NEG_INF;
    }
    // Row maxima and sums in four partials a row (chains of NT / 4, not
    // 2 NT, dependent operations, which would keep the SFUs waiting).
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m2 = fmaxf(sc[j][2 * i], sc[j][2 * i + 1]);
        mx[i][j % 4] = j < 4 ? m2 : fmaxf(mx[i][j % 4], m2);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const bool move = m > mrow[i] + slack;
      const float m_new = move ? m : mrow[i];
      alpha[i] = move ? exp2_approx((mrow[i] - m_new) * c2) : 1.f;
      mrow[i] = m_new;
    }
    const float ml[2] = {mrow[0] * c2, mrow[1] * c2};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2_approx(fmaf(sc[j][2 * i], c2, -ml[i]));
        const float p1 = exp2_approx(fmaf(sc[j][2 * i + 1], c2, -ml[i]));
        sc[j][2 * i] = p0;
        sc[j][2 * i + 1] = p1;
        sum[i][j % 4] = j < 4 ? p0 + p1 : sum[i][j % 4] + (p0 + p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lrow[i] = lrow[i] * alpha[i] +
                ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
  };
  auto pin_o_pa = [&]() {
#pragma unroll
    for (int j = 0; j < F / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(o[j][e]);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(pa[kk][e]);
  };
  auto pin_s = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(sc[j][e]);
  };

  // Per tile i: S(i) and o += p(i - 1) v(i - 1) started back to back; the
  // epilogue of S(i) runs while the tensor cores take p v (and the other
  // warpgroup's products); then o is rescaled, p(i) packed.
  mbar_wait(full0, 0);
  wgmma_fence();
  start_s(0);
  wgmma_commit();
  wgmma_wait0();
  pin_s();
  softmax(kt0, ring);
  pack_p();
  for (int i = 1; i < n; ++i) {
    const int s = i % NST, sp = (i - 1) % NST;
    mbar_wait(full0 + 8 * s, (i / NST) & 1);  // tile i
    wgmma_fence();
    start_s(s);
    wgmma_commit();
    start_pv(sp);
    wgmma_commit();
    wgmma_wait1();  // S(i); p v still running
    pin_s();
    softmax(kt0 + i, ring + s * STAGE);
    wgmma_wait0();
    pin_o_pa();
    mbar_arrive(empty0 + 8 * sp);  // done with tile i - 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < F / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }
    pack_p();
  }
  wgmma_fence();
  start_pv((n - 1) % NST);
  wgmma_commit();
  wgmma_wait0();
  pin_o_pa();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * i;
    if (row >= U1) continue;
    if (nsplit == 1) {
      const float inv = 1.f / l;
      bf16* dst = out + ((size_t)bm * U1 + row) * F + 2 * t;
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    } else {
      const size_t prow = ((size_t)split * BM + bm) * U1 + row;
      float* dst = part + prow * F + 2 * t;
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[j][2 * i], o[j][2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(
            part + (size_t)nsplit * BM * U1 * F + 2 * prow) =
            make_float2(mrow[i] * c2, l);
    }
  }
}

// The splits of each row combined in split order (so two runs give the
// same bits): out = sum_s 2^(m_s - m) o_s / sum_s 2^(m_s - m) l_s.  A warp a
// row of `rows` (BM x U1), F / 32 features a lane.
template <int F>
__global__ void __launch_bounds__(256)
    flash_combine_kernel(const float* __restrict__ part,
                         bf16* __restrict__ out, int rows, int nsplit) {
  constexpr int FL = F / 32;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part + (size_t)nsplit * rows * F;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, ml[2 * ((size_t)s * rows + row)]);
  float l = 0.f, acc[FL] = {};
  for (int s = 0; s < nsplit; ++s) {
    const size_t r = (size_t)s * rows + row;
    const float w = exp2f(ml[2 * r] - mx);
    l += w * ml[2 * r + 1];
    const float4* src =
        reinterpret_cast<const float4*>(part + r * F + lane * FL);
#pragma unroll
    for (int f = 0; f < FL / 4; ++f) {
      const float4 x = src[f];
      acc[4 * f] += w * x.x;
      acc[4 * f + 1] += w * x.y;
      acc[4 * f + 2] += w * x.z;
      acc[4 * f + 3] += w * x.w;
    }
  }
  const float inv = 1.f / l;
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(out + (size_t)row * F + lane * FL);
#pragma unroll
  for (int f = 0; f < FL / 2; ++f)
    dst[f] = pack_bf16(acc[2 * f] * inv, acc[2 * f + 1] * inv);
}

// The tensor map of a row-major [rows, cols] bf16 tensor read in boxes of
// `box_rows` x `box_cols` (box_cols * 2 bytes: 32, 64 or 128, the swizzle
// of the same width, which swz<> and wgmma's descriptors name; columns
// past cols read as zeros).  cuTensorMapEncodeTiled is the driver's, found
// through the runtime, so the library needs no link to the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

static bool encode_rows(CUtensorMap* map, const void* base, int cols,
                        uint64_t rows, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MDP, int F, template <int> class BiasT>
static int launch_pipe_md(const void* q, const void* k, const void* v,
                          void* out, void* part, long long n_part,
                          int nsplit, const BiasArgs& ba, const void* clip,
                          int BM, int U1, int U2, int md, float scale,
                          float pos_w, cudaStream_t s) {
  constexpr int NK = pipe_keys<MDP, F>();
  const int nk = (U2 + NK - 1) / NK;
  if (nsplit < 1 || nsplit > PMAX_SPLITS || nsplit > nk ||
      n_part != pipe_partials(BM, U1, F, nsplit) ||
      (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int KW = MDP < 64 ? MDP : 64;
  CUtensorMap tm_k, tm_v;
  const uint64_t rows = (uint64_t)BM * U2;
  if (!encode_rows(&tm_k, k, md, rows, KW, NK) ||
      !encode_rows(&tm_v, v, F, rows, 64, NK))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pipe_smem<MDP, F, BiasT<NK>>();
  auto kernel = flash_pipe_kernel<MDP, F, BiasT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int nq = (U1 + PROWS - 1) / PROWS;
  const dim3 grid(nq, BM, nsplit);
  kernel<<<grid, PTHREADS + PPRODUCER, smem, s>>>(
      (const bf16*)q, tm_k, tm_v, (bf16*)out, (float*)part, ba,
      (const float*)clip, U1, U2, md, scale, pos_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  flash_combine_kernel<F><<<(BM * U1 + 7) / 8, 256, 0, s>>>(
      (const float*)part, (bf16*)out, BM * U1, nsplit);
  return (int)cudaGetLastError();
}

// md a multiple of 16, q, k, v and out 16-byte aligned; F 128 with md up
// to 128 (the intra site's width) or F 256 with md past 64 up to 256.
template <int F, template <int> class BiasT>
static int launch_pipe(const void* q, const void* k, const void* v,
                       void* out, void* part, long long n_part, int nsplit,
                       const BiasArgs& ba, const void* clip, int BM, int U1,
                       int U2, int md, float scale, float pos_w,
                       cudaStream_t s) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)out;
  if (md <= 0 || md > (F == 128 ? 128 : MAXMD_FMA) || md % 16 != 0 ||
      (align & 15) != 0 || (F == 256 && md <= MAXMD))
    return (int)cudaErrorInvalidValue;
#define PIPE(MDP_)                                                          \
  return launch_pipe_md<MDP_, F, BiasT>(q, k, v, out, part, n_part, nsplit, \
                                        ba, clip, BM, U1, U2, md, scale,    \
                                        pos_w, s)
  if constexpr (F == 128) {
    if (md <= 16) PIPE(16);
    if (md <= 32) PIPE(32);
    if (md <= 64) PIPE(64);
    PIPE(128);
  } else {
    if (md <= 128) PIPE(128);
    PIPE(256);
  }
#undef PIPE
}

// One launch of the body that in_bf16, md and F select: for bf16 the F =
// 256 body up to md 64 (MmaB; no split) and the pipelined one otherwise
// (PipeB), for fp32 the FMA body (FmaB); any F but 128 and 256 is refused.
template <class MmaB, template <int> class PipeB, class FmaB>
static int launch_f(const void* q, const void* k, const void* v, void* out,
                    void* part, long long n_part, int nsplit,
                    const BiasArgs& ba, const void* clip, int BM, int U1,
                    int U2, int md, int F, float scale, float pos_w,
                    int in_bf16, cudaStream_t s) {
  if (F != 128 && F != 256) return (int)cudaErrorInvalidValue;
  if (!flash_mma_body(md, in_bf16)) {
    if (in_bf16 || nsplit != 1 || n_part != 0)
      return (int)cudaErrorInvalidValue;
    return F == 128 ? launch_fma<128, FmaB>(q, k, v, out, ba, clip, BM, U1,
                                            U2, md, scale, pos_w, s)
                    : launch_fma<256, FmaB>(q, k, v, out, ba, clip, BM, U1,
                                            U2, md, scale, pos_w, s);
  }
  if (F == 256 && md <= MAXMD) {
    if (nsplit != 1 || n_part != 0) return (int)cudaErrorInvalidValue;
    return launch_wgmma<256, MmaB>(q, k, v, out, ba, clip, BM, U1, U2, md,
                                   scale, pos_w, s);
  }
  return F == 128 ? launch_pipe<128, PipeB>(q, k, v, out, part, n_part,
                                            nsplit, ba, clip, BM, U1, U2, md,
                                            scale, pos_w, s)
                  : launch_pipe<256, PipeB>(q, k, v, out, part, n_part,
                                            nsplit, ba, clip, BM, U1, U2, md,
                                            scale, pos_w, s);
}

// B2.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F]
// contiguous, all bf16 when in_bf16 else fp32; md <= 256 (bf16: a
// multiple of 16, the pointers 16-byte aligned, on wgmma; fp32 the FMA
// body), F 128 or 256; the queries are the grid's tokens q_tok0 .. q_tok0 +
// U1 - 1 (a row shard; 0 and U1 = U2 for the whole grid), the keys all U2
// = H8 * W8 tokens; biases: [(2R+1)^2] fp32; clip: [1] fp32 on the device;
// part: pipe_partials(BM, U1, F, nsplit) = n_part floats of scratch (null
// for one split), nsplit the key splits of the pipelined body (1 for the
// others).  Returns a cudaError_t code.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, const void* biases,
                                 const void* clip, void* part,
                                 long long n_part, int nsplit, int BM, int U1,
                                 int U2, int q_tok0, int md, int F, int W8,
                                 int R, float scale, float pos_w, int in_bf16,
                                 void* stream) {
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  return launch_f<MmaWindow, PipeWindow, WindowBias>(
      q, k, v, out, part, n_part, nsplit, ba, clip, BM, U1, U2, md, F, scale,
      pos_w, in_bf16, (cudaStream_t)stream);
}

// B8.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F];
// contiguous, bf16 when in_bf16 else fp32; md <= 256 (as B2), F 128 or
// 256; table: [U1, U2] fp32, or null for no bias; clip: [1] fp32 on the
// device; part, n_part, nsplit as B2.
extern "C" int flash_attn_dense_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       const void* table, const void* clip,
                                       void* part, long long n_part,
                                       int nsplit, int BM, int U1, int U2,
                                       int md, int F, float scale,
                                       float pos_w, int in_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
  if (table == nullptr)
    return launch_f<MmaNoBias, PipeNoBias, NoBias>(
        q, k, v, out, part, n_part, nsplit, ba, clip, BM, U1, U2, md, F,
        scale, pos_w, in_bf16, s);
  return launch_f<MmaTable, PipeTable, TableBias>(
      q, k, v, out, part, n_part, nsplit, ba, clip, BM, U1, U2, md, F, scale,
      pos_w, in_bf16, s);
}
