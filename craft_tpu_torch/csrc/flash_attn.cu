// B2: flash multi-mode attention with the sliding positional bias,
//   out[b,m] = softmax(clamp(scale * q k^T, +-clip) + pos_w * bias) @ v,
// keys past U masked; the [U, U] scores never leave the block.
//
// Replaces craft_tpu/ops/pallas/mode_attention.py:flash_mode_attention_mt
// (body _flash_kernel_mt), the f2 transformer site.
//
// Bound on the H100: operations.  At the f2 site (B=1, M=4, U=7040, md=64,
// F=256) it is 127 GFLOP over 36 MB of inputs and outputs.  Each block
// keeps a 64-row q tile and its 64 x F output accumulator resident (the
// accumulator in registers, 64 floats per thread) and streams k and v
// tiles through shared memory, so v is read once per q tile and no score
// or probability tensor is written.  The running row max and sum are kept
// per thread for its four rows; the online-softmax rescale multiplies the
// thread's own accumulator rows.  The bias window sits in shared memory
// and is indexed directly (the TPU's [2R+1, W8, W8] Toeplitz table was a
// Mosaic workaround), and ragged U is masked in-kernel, so there is no
// padded copy.  The inner products are plain fp32 FMA; tensor cores are
// later work.
#include "common.cuh"

#define FEAT 256      // value / output width: the f2 site's feat_dim
#define FJ (FEAT / 16)  // output columns per thread

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const float* __restrict__ biases,
                      const float* __restrict__ clip_ptr, int U, int md,
                      int W8, int R, float scale, float pos_w) {
  constexpr int F = FEAT;
  extern __shared__ float smem[];
  float* qs = smem;                    // [MAXMD][SPAD]
  float* ks = qs + MAXMD * SPAD;       // [MAXMD][SPAD]
  float* ps = ks + MAXMD * SPAD;       // [TILE][SPAD]: p[key][row]
  float* vs = ps + TILE * SPAD;        // [TILE][F]
  float* win = vs + TILE * F;          // [(2R+1)^2]
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
  float o[4][FJ];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < FJ; ++j) o[i][j] = 0.f;
  }

  const int nk = (U + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile_t(ks, k + base * md, kt * TILE, U, md);
    for (int e = threadIdx.x; e < TILE * F; e += NTHREADS) {
      int r = e / F, f = e - r * F;
      int row = kt * TILE + r;
      vs[e] = row < U ? to_f(v[(base + row) * F + f]) : 0.f;
    }
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
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = fminf(fmaxf(s[i][j] * scale, -clip), clip);
        x += pos_w * window_bias(win, qh[i], qw[i], kh[j], kw[j], R);
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
    if (row >= U) continue;
    const float inv = 1.f / lrow[i];
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      out[(base + row) * F + tx + 16 * j] = from_f<T>(o[i][j] * inv);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const void* biases, const void* clip, int BM, int U, int md,
                  int W8, int R, float scale, float pos_w, cudaStream_t s) {
  const size_t smem =
      (2 * MAXMD * SPAD + TILE * SPAD + TILE * FEAT + MAXWIN) * sizeof(float);
  cudaError_t err = allow_smem(flash_attn_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + TILE - 1) / TILE, BM);
  flash_attn_kernel<T><<<grid, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (const float*)biases,
      (const float*)clip, U, md, W8, R, scale, pos_w);
  return (int)cudaGetLastError();
}

// q, k: [BM, U, md]; v, out: [BM, U, F] contiguous, all bf16 when in_bf16
// else fp32; md <= 64, F == FEAT; biases: [(2R+1)^2] fp32; clip: [1] fp32
// on the device.  Returns a cudaError_t code.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, const void* biases,
                                 const void* clip, int BM, int U, int md,
                                 int F, int W8, int R, float scale,
                                 float pos_w, int in_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F != FEAT) return (int)cudaErrorInvalidValue;
  return in_bf16 ? launch<__nv_bfloat16>(q, k, v, out, biases, clip, BM, U,
                                         md, W8, R, scale, pos_w, s)
                 : launch<float>(q, k, v, out, biases, clip, BM, U, md, W8,
                                 R, scale, pos_w, s);
}
