// B2 and B8: flash multi-mode attention of the f2 transformer site,
//   out[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias) @ v,
// keys past U2 masked; the [U1, U2] scores never leave the block.  B2 takes
// the sliding window as its bias, B8 a dense [U1, U2] fp32 table or none;
// one kernel body serves both (a template over the bias source,
// common.cuh).
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:flash_mode_attention_mt
// (body _flash_kernel_mt; B2, the window) and flash_mode_attention (body
// _flash_kernel; B8, the dense table: the f2 site under --intrapos lsinu,
// no table, and under --f2radius, the table pos_w * bias + the -1e9 mask).
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64,
// F=256) it is 127 GFLOP over 36 MB of inputs and outputs (B8 with a table
// adds 198 MB of fp32 table, 59 us, still under the 128 us of the bf16
// peak).  Each block keeps a 64-row q tile and its 64 x F output
// accumulator resident (the accumulator in registers, 64 floats per thread)
// and streams k and v tiles (and a table tile) through shared memory, so v
// is read once per q tile and no score or probability tensor is written.
// The running row max and sum are kept per thread for its four rows; the
// online-softmax rescale multiplies the thread's own accumulator rows.  A
// row whose first key tiles are all masked by -1e9 runs at max ~ -1e9 until
// its unmasked keys arrive, and then alpha = exp(-1e9 - max) = 0 wipes what
// it summed: the diagonal is never masked, so every row ends finite.  The
// bias window sits in shared memory and is indexed directly (the TPU's
// [2R+1, W8, W8] Toeplitz table was a Mosaic workaround), and ragged U1 and
// U2 are masked in-kernel, so there is no padded copy.  The inner products
// are plain fp32 FMA; tensor cores are later work.
#include "common.cuh"

#define FEAT 256      // value / output width: the f2 site's feat_dim
#define FJ (FEAT / 16)  // output columns per thread

template <typename T, class Bias>
__global__ void __launch_bounds__(NTHREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      BiasArgs ba, const float* __restrict__ clip_ptr, int U1,
                      int U2, int md, float scale, float pos_w) {
  constexpr int F = FEAT;
  extern __shared__ float smem[];
  float* qs = smem;                    // [MAXMD][SPAD]
  float* ks = qs + MAXMD * SPAD;       // [MAXMD][SPAD]
  float* ps = ks + MAXMD * SPAD;       // [TILE][SPAD]: p[key][row]
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

template <typename T, class Bias>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const BiasArgs& ba, const void* clip, int BM, int U1,
                  int U2, int md, float scale, float pos_w, cudaStream_t s) {
  const size_t smem = (2 * MAXMD * SPAD + TILE * SPAD + TILE * FEAT +
                       Bias::SMEM) * sizeof(float);
  cudaError_t err = allow_smem(flash_attn_kernel<T, Bias>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  flash_attn_kernel<T, Bias><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, ba, (const float*)clip,
      U1, U2, md, scale, pos_w);
  return (int)cudaGetLastError();
}

// B2.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F]
// contiguous, all bf16 when in_bf16 else fp32; md <= 64, F == FEAT; the
// queries are the grid's tokens q_tok0 .. q_tok0 + U1 - 1 (a row shard; 0
// and U1 = U2 for the whole grid), the keys all U2 = H8 * W8 tokens;
// biases: [(2R+1)^2] fp32; clip: [1] fp32 on the device.  Returns a
// cudaError_t code.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, const void* biases,
                                 const void* clip, int BM, int U1, int U2,
                                 int q_tok0, int md, int F, int W8, int R,
                                 float scale, float pos_w, int in_bf16,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F != FEAT) return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
  return in_bf16 ? launch<__nv_bfloat16, WindowBias>(
                       q, k, v, out, ba, clip, BM, U1, U2, md, scale, pos_w, s)
                 : launch<float, WindowBias>(q, k, v, out, ba, clip, BM, U1,
                                             U2, md, scale, pos_w, s);
}

// B8.  q: [BM, U1, md]; k: [BM, U2, md]; v: [BM, U2, F]; out: [BM, U1, F];
// contiguous, bf16 when in_bf16 else fp32; md <= 64, F == FEAT; table:
// [U1, U2] fp32, or null for no bias; clip: [1] fp32 on the device.
extern "C" int flash_attn_dense_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       const void* table, const void* clip,
                                       int BM, int U1, int U2, int md, int F,
                                       float scale, float pos_w, int in_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F != FEAT) return (int)cudaErrorInvalidValue;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
  if (table == nullptr)
    return in_bf16 ? launch<__nv_bfloat16, NoBias>(q, k, v, out, ba, clip, BM,
                                                   U1, U2, md, scale, pos_w, s)
                   : launch<float, NoBias>(q, k, v, out, ba, clip, BM, U1, U2,
                                           md, scale, pos_w, s);
  return in_bf16 ? launch<__nv_bfloat16, TableBias>(
                       q, k, v, out, ba, clip, BM, U1, U2, md, scale, pos_w, s)
                 : launch<float, TableBias>(q, k, v, out, ba, clip, BM, U1,
                                            U2, md, scale, pos_w, s);
}
