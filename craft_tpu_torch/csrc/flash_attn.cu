// B2 and B8: flash multi-mode attention of the f2 transformer site,
//   out[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias) @ v,
// keys past U2 masked; the [U1, U2] scores never leave the block.  B2 takes
// the sliding window as its bias, B8 a dense [U1, U2] fp32 table or none;
// one kernel body serves both (a template over the bias source).
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:flash_mode_attention_mt
// (body _flash_kernel_mt; B2, the window) and flash_mode_attention (body
// _flash_kernel; B8, the dense table: the f2 site under --intrapos lsinu,
// no table, and under --f2radius, the table pos_w * bias + the -1e9 mask).
// Two value widths F, each a template instance of both bodies: 256, the
// f2 site's, and 128, the intra aggregator's, where the lazy intra path
// (probs past 4e9 bytes: HD1K, 1080p frames, large batches; craft_tpu/nn/
// setrans.py:826-836) runs B2 once an iteration with md 32.
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64,
// F=256) it is 127 GFLOP, 80 % of it p.v, over 36 MB of inputs and outputs
// (B8 with a table adds 198 MB of fp32 table, 59 us, still under the 128 us
// of the bf16 peak); at HD1K's lazy aggregator (B=1, M=4, U=43520, md=32,
// F=128) 2.42 TFLOP, and the exponentials (7.6e9) take about as long.
// Offsets that reach U1 * U2 or a row times F are formed in size_t: at
// HD1K U * U is within 12 % of 2^31.  Two bodies:
//
// bf16 (flash_wgmma_kernel): the products on the tensor cores as wgmma
// (sm_90a), bf16 operands and fp32 sums.  A block is two warpgroups, each
// owning 64 query rows (a warp 16): its q fragments stay in registers for
// the whole key sweep (read once from global memory, so q takes no shared
// memory), as does its 64 x F fp32 output accumulator (128 registers a
// thread at F = 256, 64 at 128).  Per key tile of 64: S = q k^T as 64 x 64 x 16 wgmmas (A = the q
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
// tile, 40 KB a stage at F = 256 and md 64 (72 KB with a table; 20 KB at
// F = 128 and md 32), filled by 16-byte cp.async
// whose completion an mbarrier counts (full); a second mbarrier per stage
// (empty) frees it once both warpgroups are done, and tile kt + 3 (kt + 2)
// is copied while tile kt is multiplied.  Each thread copies fixed chunk
// columns, its offsets set once per block.  k rows and v's 64-feature
// blocks (F / 64 of them) are laid out with the 128-, 64- or 32-byte
// swizzle that wgmma's descriptors name (16-byte chunk index XOR row bits),
// conflict-free.
//   Sizes at F = 256: about 245 registers a thread, 160 (216) KB of shared
// memory, one block of 256 threads an SM.  F = 128 keeps the same tiles,
// ring and grid (half the accumulator registers left unused: wider row
// tiles or two blocks an SM are later speed work).  Serving (U=7040, 4 modes) launches 55 x 4 =
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
// the row coordinates once per block.  The wrapper raises unless md is a
// multiple of 16 (up to 64; md 48 runs the 64-wide tiles with zero
// columns) and q, k, v and out are 16-byte aligned; a table whose rows are
// not (U2 % 4 != 0) is staged by 4-byte copies.
//
// fp32 (flash_attn_kernel): plain fp32 FMA, kept for fp32 parity (--fullprec
// and the fp32 oracle; TF32 would not hold 1e-5).  The same body takes
// bf16 inputs whose mode dim passes 64 (one or two modes at the f2 site, md
// 256 or 128; p stays fp32 there), staged at a 256 stride: a simple kernel
// that is right, at the FMA rate.  Each block keeps a 64-row
// q tile and its 64 x F output accumulator resident (F / 4 floats a
// thread)
// and streams k and v tiles (and a table tile) through shared memory.  The
// running row max and sum are kept per thread for its four rows; the
// online-softmax rescale multiplies the thread's own accumulator rows.
//
// Both bodies: a row whose first key tiles are all masked by -1e9 runs at
// max ~ -1e9 until its unmasked keys arrive, and then alpha = exp(-1e9 -
// max) = 0 wipes what it summed: the diagonal is never masked, so every
// row ends finite.  Ragged U1 and U2 are masked in the kernel, so there is
// no padded copy (the TPU's [2R+1, W8, W8] Toeplitz table was a Mosaic
// workaround).
#include "common.cuh"
#include "wgmma.cuh"

// F: the value / output width, 256 (the f2 site's feat_dim) or 128 (the
// intra aggregator's feat_dim, the lazy intra path); the launches refuse
// any other.  T: the io type (fp32, or bf16 at a mode dim past 64); MDS:
// the staged tiles' mode dim stride (MAXMD, or MAXMD_FMA for md 128 and
// 256: 227 KB at F = 256 with a table).
template <typename T, int F, class Bias, int MDS>
__global__ void __launch_bounds__(NTHREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
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
      out[(qbase + row) * F + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

template <typename T, int F, class Bias, int MDS>
static int launch_fma_md(const void* q, const void* k, const void* v,
                         void* out, const BiasArgs& ba, const void* clip,
                         int BM, int U1, int U2, int md, float scale,
                         float pos_w, cudaStream_t s) {
  const size_t smem = (2 * MDS * SPAD + TILE * SPAD + TILE * F +
                       Bias::SMEM) * sizeof(float);
  cudaError_t err = allow_smem(flash_attn_kernel<T, F, Bias, MDS>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  flash_attn_kernel<T, F, Bias, MDS><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, ba,
      (const float*)clip, U1, U2, md, scale, pos_w);
  return (int)cudaGetLastError();
}

// The FMA body: md up to 256, at the stride of md.
template <typename T, int F, class Bias>
static int launch_fma(const void* q, const void* k, const void* v, void* out,
                      const BiasArgs& ba, const void* clip, int BM, int U1,
                      int U2, int md, float scale, float pos_w,
                      cudaStream_t s) {
  if (md <= 0 || md > MAXMD_FMA) return (int)cudaErrorInvalidValue;
  if (md <= MAXMD)
    return launch_fma_md<T, F, Bias, MAXMD>(q, k, v, out, ba, clip, BM, U1,
                                            U2, md, scale, pos_w, s);
  return launch_fma_md<T, F, Bias, MAXMD_FMA>(q, k, v, out, ba, clip, BM, U1,
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
// F: the value / output width, 256 or 128.
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

// One launch of the body that in_bf16 and md select (MmaB's wgmma for bf16
// up to md 64, FmaB's FMA otherwise) at F = 128 or 256; any other F is
// refused.
template <class MmaB, class FmaB>
static int launch_f(const void* q, const void* k, const void* v, void* out,
                    const BiasArgs& ba, const void* clip, int BM, int U1,
                    int U2, int md, int F, float scale, float pos_w,
                    int in_bf16, cudaStream_t s) {
  const bool mma = mma_body(md, in_bf16);
#define CASE(F_)                                                            \
  if (F == F_)                                                              \
    return mma ? launch_wgmma<F_, MmaB>(q, k, v, out, ba, clip, BM, U1, U2, \
                                        md, scale, pos_w, s)                \
           : in_bf16 ? launch_fma<bf16, F_, FmaB>(q, k, v, out, ba, clip,   \
                                                  BM, U1, U2, md, scale,    \
                                                  pos_w, s)                 \
                     : launch_fma<float, F_, FmaB>(q, k, v, out, ba, clip,  \
                                                   BM, U1, U2, md, scale,   \
                                                   pos_w, s);
  CASE(128)
  CASE(256)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// B2.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F]
// contiguous, all bf16 when in_bf16 else fp32; md <= 256 (bf16 up to 64:
// a multiple of 16, the pointers 16-byte aligned, on wgmma; past 64 and
// fp32 the FMA body), F 128 or 256; the queries are the
// grid's tokens q_tok0 .. q_tok0 + U1 - 1 (a row shard; 0 and U1 = U2 for
// the whole grid), the keys all U2 = H8 * W8 tokens; biases: [(2R+1)^2]
// fp32; clip: [1] fp32 on the device.  Returns a cudaError_t code.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, const void* biases,
                                 const void* clip, int BM, int U1, int U2,
                                 int q_tok0, int md, int F, int W8, int R,
                                 float scale, float pos_w, int in_bf16,
                                 void* stream) {
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  return launch_f<MmaWindow, WindowBias>(q, k, v, out, ba, clip, BM, U1, U2,
                                         md, F, scale, pos_w, in_bf16,
                                         (cudaStream_t)stream);
}

// B8.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F];
// contiguous, bf16 when in_bf16 else fp32; md <= 256 (as B2), F 128 or
// 256; table: [U1, U2] fp32, or null for no bias; clip: [1] fp32 on the
// device.
extern "C" int flash_attn_dense_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       const void* table, const void* clip,
                                       int BM, int U1, int U2, int md, int F,
                                       float scale, float pos_w, int in_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
  if (table == nullptr)
    return launch_f<MmaNoBias, NoBias>(q, k, v, out, ba, clip, BM, U1, U2,
                                       md, F, scale, pos_w, in_bf16, s);
  return launch_f<MmaTable, TableBias>(q, k, v, out, ba, clip, BM, U1, U2,
                                       md, F, scale, pos_w, in_bf16, s);
}
