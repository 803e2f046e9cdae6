// B4: two-phase blockwise softmax probabilities with a positional bias,
//   probs[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias),
// written once in the output type; fp32 scores never exist.  The bias is
// the sliding window (B4) or a dense [U1, U2] fp32 table or none (B4
// dense); one kernel body serves both (a template over the bias source,
// common.cuh).
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
// Bound on the H100: bytes.  At the intra site (B=1, M=4, U=7040, md=32)
// the scores are 12.7 GFLOP (13 us at the bf16 peak; the two sweeps do it
// twice) against a 198 MB int8 write (59 us of memory time); under lsinu
// the bf16 write is 396 MB (118 us).  A block owns 64 query rows of one
// (b, m): sweep 1 keeps the running row max and sum in registers, sweep 2
// recomputes the scores and writes each probability once.  Recomputing
// q.k^T costs less than writing and re-reading fp32 scores.  Plain fp32 FMA
// inner products.
#include "common.cuh"

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

template <typename T, int KIND, class Bias>
static int launch(const void* q, const void* k, const BiasArgs& ba,
                  const void* clip, void* out, void* row_scale, int BM,
                  int U1, int U2, int md, float scale, float pos_w,
                  cudaStream_t s) {
  const size_t smem = (2 * MAXMD * SPAD + Bias::SMEM) * sizeof(float);
  cudaError_t err = allow_smem(probs_kernel<T, KIND, Bias>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U1 + TILE - 1) / TILE, BM);
  probs_kernel<T, KIND, Bias><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, ba, (const float*)clip, out,
      (float*)row_scale, U1, U2, md, scale, pos_w);
  return (int)cudaGetLastError();
}

// B4.  q: [BM, U1, md], k: [BM, U2, md] contiguous (bf16 when in_bf16,
// else fp32), md <= 64; the queries are the grid's tokens q_tok0 .. q_tok0
// + U1 - 1 (a row shard; 0 and U1 = U2 for the whole grid), the keys all
// U2 = H8 * W8 tokens; out: [BM, U1, U2] of out_kind (0 fp32, 1 bf16, 2
// int8); row_scale: [BM, U1] fp32 (written for int8 only); biases:
// [(2R+1)^2] fp32; clip: [1] fp32.  bf16 inputs take every out_kind; fp32
// inputs (the fp32 config) only fp32.
extern "C" int probs_launch(const void* q, const void* k, const void* biases,
                            const void* clip, void* out, void* row_scale,
                            int BM, int U1, int U2, int q_tok0, int md,
                            int W8, int R, float scale, float pos_w,
                            int in_bf16, int out_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)biases, W8, R, U1, U2, q_tok0};
#define CASE(T, KIND)                                                        \
  return launch<T, KIND, WindowBias>(q, k, ba, clip, out, row_scale, BM, U1, \
                                     U2, md, scale, pos_w, s);
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

// B4 dense.  q: [BM, U1, md]; k: [BM, U2, md] contiguous (bf16 when
// in_bf16, else fp32), md <= 64; out: [BM, U1, U2] of out_kind (0 fp32, 1
// bf16); table: [U1, U2] fp32, or null for no bias; clip: [1] fp32.  bf16
// inputs take both out_kinds, fp32 inputs fp32 only.
extern "C" int probs_dense_launch(const void* q, const void* k,
                                  const void* table, const void* clip,
                                  void* out, int BM, int U1, int U2, int md,
                                  float scale, float pos_w, int in_bf16,
                                  int out_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BiasArgs ba{(const float*)table, 0, 0, U1, U2, 0};
#define CASE(T, KIND)                                                         \
  return table ? launch<T, KIND, TableBias>(q, k, ba, clip, out, nullptr, BM, \
                                            U1, U2, md, scale, pos_w, s)      \
               : launch<T, KIND, NoBias>(q, k, ba, clip, out, nullptr, BM,    \
                                         U1, U2, md, scale, pos_w, s);
  if (!in_bf16) {
    if (out_kind == OUT_F32) CASE(float, OUT_F32)
  } else if (out_kind == OUT_F32) {
    CASE(__nv_bfloat16, OUT_F32)
  } else if (out_kind == OUT_BF16) {
    CASE(__nv_bfloat16, OUT_BF16)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}
