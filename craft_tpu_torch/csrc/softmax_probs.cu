// B4: two-phase blockwise softmax probabilities with the sliding bias,
//   probs[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias),
// written once in the output type; fp32 scores never exist.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:mode_softmax_probs_mt
// (bodies _probs_kernel_mt_q, quantized, and _probs_kernel_mt, float), the
// intra-frame attention site.  Quantized output: int8 num =
// rint(exp(s - rowmax) * 127) (round half to even, so every row's max is
// exactly 127) and an fp32 per-row scale 1 / (127 * l), probs = num * scale.
//
// Bound on the H100: operations.  At the intra site (B=1, M=4, U=7040,
// md=32) the two sweeps are 25 GFLOP against a 198 MB int8 write (59 us of
// memory time).  A block owns 64 query rows of one (b, m): sweep 1 keeps
// the running row max and sum in registers, sweep 2 recomputes the scores
// and writes each probability once.  Recomputing q.k^T costs less than
// writing and re-reading fp32 scores.  Plain fp32 FMA inner products.
#include "common.cuh"

enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_INT8 = 2 };

template <typename T, int KIND>
__global__ void __launch_bounds__(NTHREADS)
    probs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ biases,
                 const float* __restrict__ clip_ptr, void* __restrict__ out,
                 float* __restrict__ row_scale, int U, int md, int W8, int R,
                 float scale, float pos_w) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  const int qt = blockIdx.x, bm = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)bm * U;
  load_tile_t(qs, q + base * md, qt * TILE, U, md);
  load_window(win, biases, R);
  const float clip = clip_ptr[0];
  int qh[4], qw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int u = qt * TILE + ty + 16 * i;
    qh[i] = u / W8;
    qw[i] = u - qh[i] * W8;
  }
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
  }
  const int nk = (U + TILE - 1) / TILE;
  for (int phase = 0; phase < 2; ++phase) {
    for (int kt = 0; kt < nk; ++kt) {
      __syncthreads();
      load_tile_t(ks, k + base * md, kt * TILE, U, md);
      __syncthreads();
      float s[4][4];
      score_tile(s, qs, ks, md);
      int kh[4], kw[4];
      bool kvalid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int u = kt * TILE + tx + 16 * j;
        kvalid[j] = u < U;
        kh[j] = u / W8;
        kw[j] = u - kh[j] * W8;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = fminf(fmaxf(s[i][j] * scale, -clip), clip);
          x += pos_w * window_bias(win, qh[i], qw[i], kh[j], kw[j], R);
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
        if (row >= U) continue;
        const size_t rbase = (base + row) * (size_t)U + kt * TILE + tx;
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
          row_scale[base + row] = 1.f / (127.f * lrow[i]);
      }
    }
  }
}

template <typename T, int KIND>
static int launch(const void* q, const void* k, const void* biases,
                  const void* clip, void* out, void* row_scale, int BM, int U,
                  int md, int W8, int R, float scale, float pos_w,
                  cudaStream_t s) {
  const size_t smem = (2 * MAXMD * SPAD + MAXWIN) * sizeof(float);
  cudaError_t err = allow_smem(probs_kernel<T, KIND>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + TILE - 1) / TILE, BM);
  probs_kernel<T, KIND><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const float*)biases, (const float*)clip,
      out, (float*)row_scale, U, md, W8, R, scale, pos_w);
  return (int)cudaGetLastError();
}

// q, k: [BM, U, md] contiguous (bf16 when in_bf16, else fp32), md <= 64;
// out: [BM, U, U] of out_kind (0 fp32, 1 bf16, 2 int8); row_scale: [BM, U]
// fp32 (written for int8 only); biases: [(2R+1)^2] fp32; clip: [1] fp32.
// bf16 inputs take every out_kind; fp32 inputs (the fp32 config) only fp32.
extern "C" int probs_launch(const void* q, const void* k, const void* biases,
                            const void* clip, void* out, void* row_scale,
                            int BM, int U, int md, int W8, int R, float scale,
                            float pos_w, int in_bf16, int out_kind,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CASE(T, KIND)                                                       \
  return launch<T, KIND>(q, k, biases, clip, out, row_scale, BM, U, md, W8, \
                         R, scale, pos_w, s);
  if (!in_bf16) {
    if (out_kind == OUT_F32) CASE(float, OUT_F32)
  } else if (out_kind == OUT_F32) {
    CASE(__nv_bfloat16, OUT_F32)
  } else if (out_kind == OUT_BF16) {
    CASE(__nv_bfloat16, OUT_BF16)
  } else if (out_kind == OUT_INT8) {
    CASE(__nv_bfloat16, OUT_INT8)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}
