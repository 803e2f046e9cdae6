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
// Replaces craft_tpu/ops/pallas/mode_attention.py:fused_agg_corr_mt and
// fused_agg_corr (forward; one kernel takes the (2R+1)^2 window at any W8,
// so the dense-table variant the TPU needed at W8 % 128 != 0 has no
// counterpart) and craft_tpu/ops/pallas/corr_vjp.py:_pallas_agg_corr_bwd
// (backward).
//
// Bound on the H100: bytes.  At the chairs crops (B=8, M=4, U=46*62=2852,
// md=64) one q.k^T sweep is 33 GFLOP (34 us at the bf16 peak) while the
// forward writes a 260 MB fp32 volume (78 us) and the backward reads g and
// vol (520 MB) and writes a 1.04 GB dc (0.47 ms).  Each block recomputes
// the four mode scores of its tiles in registers (agg_modes.cuh) and
// touches each volume-sized element once.  The backward's da is a fp64
// per-block partial, summed by one block in a fixed order: no float
// atomics, deterministic.
#include "agg_modes.cuh"

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    agg_corr_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ biases,
                    const float* __restrict__ scal, float* __restrict__ out,
                    int U, int md, int W8, int R, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t off = (size_t)b * NMODES * U * md;
  int qh[4], qw[4];
  load_q_modes(q + off, biases, qs, win, qt, U, md, W8, R, qh, qw);
  const float clip = scal[0], pos_w = scal[1], agg_w = scal[2],
              agg_b = scal[3];
  const int nk = (U + TILE - 1) / TILE;
  for (int kt = g * KGROUP; kt < min(nk, (g + 1) * KGROUP); ++kt) {
    float vol[4][4];
    agg_tile(vol, k + off, qs, ks, win, kt, U, md, W8, R, scale, clip, pos_w,
             agg_w, agg_b, qh, qw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * TILE + ty + 16 * i;
      if (row >= U) continue;
      float* orow = out + ((size_t)b * U + row) * U;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * TILE + tx + 16 * j;
        if (col < U) orow[col] = vol[i][j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    agg_corr_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const float* __restrict__ g,
                        const float* __restrict__ vol,
                        const float* __restrict__ biases,
                        const float* __restrict__ scal,
                        float* __restrict__ dc, double* __restrict__ partial,
                        int U, int md, int W8, int R, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + NMODES * MAXMD * SPAD;
  float* win = ks + MAXMD * SPAD;
  __shared__ double red[NTHREADS / 32];
  const int qt = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t off = (size_t)b * NMODES * U * md;
  const size_t plane = (size_t)U * U;
  int qh[4], qw[4];
  load_q_modes(q + off, biases, qs, win, qt, U, md, W8, R, qh, qw);
  const float clip = scal[0], pos_w = scal[1], agg_w = scal[2];
  const int nk = (U + TILE - 1) / TILE;
  double da = 0.0;
  for (int kt = grp * KGROUP; kt < min(nk, (grp + 1) * KGROUP); ++kt) {
    float s[NMODES][4][4];
    mode_score_tiles(s, k + off, qs, ks, kt, U, md);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kt * TILE + tx + 16 * j;
      if (col >= U) continue;
      const int kh = col / W8, kw = col - (col / W8) * W8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qt * TILE + ty + 16 * i;
        if (row >= U) continue;
        const size_t e = (size_t)b * plane + (size_t)row * U + col;
        const float gv = g[e], vv = vol[e];
        const float bias = pos_w * window_bias(win, qh[i], qw[i], kh, kw, R);
        float c[NMODES], x[NMODES], p[NMODES];
#pragma unroll
        for (int m = 0; m < NMODES; ++m) {
          c[m] = s[m][i][j] * scale;
          x[m] = fminf(fmaxf(c[m], -clip), clip) + bias;
        }
        float mmax = agg_w * x[0];
#pragma unroll
        for (int m = 1; m < NMODES; ++m) mmax = fmaxf(mmax, agg_w * x[m]);
        float denom = 0.f;
#pragma unroll
        for (int m = 0; m < NMODES; ++m) {
          p[m] = expf(agg_w * x[m] - mmax);
          denom += p[m];
        }
        float dsum = 0.f;
#pragma unroll
        for (int m = 0; m < NMODES; ++m) {
          const float pm = p[m] / denom;
          const float sv = x[m] - vv;
          const float t = pm * (1.f + agg_w * sv);
          dc[((size_t)b * NMODES + m) * plane + (size_t)row * U + col] =
              fabsf(c[m]) < clip ? gv * t : 0.f;
          dsum += pm * x[m] * sv;
        }
        da += (double)(gv * dsum);
      }
    }
  }
  da = block_sum(da, red);
  if (threadIdx.x == 0)
    partial[((size_t)b * gridDim.y + grp) * gridDim.x + qt] = da;
}

static dim3 agg_grid(int B, int U) {
  const int nq = (U + TILE - 1) / TILE;
  return dim3(nq, (nq + KGROUP - 1) / KGROUP, B);
}

template <typename T>
static int launch_fwd(const void* q, const void* k, const void* biases,
                      const void* scal, void* out, int B, int U, int md,
                      int W8, int R, float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(agg_corr_kernel<T>, AGG_SMEM);
  if (err != cudaSuccess) return (int)err;
  agg_corr_kernel<T><<<agg_grid(B, U), NTHREADS, AGG_SMEM, s>>>(
      (const T*)q, (const T*)k, (const float*)biases, (const float*)scal,
      (float*)out, U, md, W8, R, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* q, const void* k, const void* g,
                      const void* vol, const void* biases, const void* scal,
                      void* dc, void* partial, void* da, int B, int U,
                      int md, int W8, int R, float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(agg_corr_bwd_kernel<T>, AGG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = agg_grid(B, U);
  agg_corr_bwd_kernel<T><<<grid, NTHREADS, AGG_SMEM, s>>>(
      (const T*)q, (const T*)k, (const float*)g, (const float*)vol,
      (const float*)biases, (const float*)scal, (float*)dc, (double*)partial,
      U, md, W8, R, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, NTHREADS, 0, s>>>(
      (const double*)partial, (int)(grid.x * grid.y * grid.z), (float*)da);
  return (int)cudaGetLastError();
}

// q, k: [B, 4, U, md] contiguous (bf16 when in_bf16, else fp32), md <= 64;
// biases: [(2R+1)^2] fp32; scal: [4] fp32 (clip, pos_w, agg_w, agg_b);
// out: [B, U, U] fp32.
extern "C" int agg_corr_launch(const void* q, const void* k,
                               const void* biases, const void* scal,
                               void* out, int B, int U, int md, int W8, int R,
                               float scale, int in_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return launch_fwd<__nv_bfloat16>(q, k, biases, scal, out, B, U, md, W8,
                                     R, scale, s);
  return launch_fwd<float>(q, k, biases, scal, out, B, U, md, W8, R, scale,
                           s);
}

// q, k, biases, scal as above (agg_b unread); g, vol: [B, U, U] fp32;
// dc: [B, 4, U, U] fp32; partial: [B * ceil(U/64) *
// ceil(ceil(U/64)/8)] fp64 scratch; da: [1] fp32.
extern "C" int agg_corr_bwd_launch(const void* q, const void* k,
                                   const void* g, const void* vol,
                                   const void* biases, const void* scal,
                                   void* dc, void* partial, void* da, int B,
                                   int U, int md, int W8, int R, float scale,
                                   int in_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, g, vol, biases, scal, dc, partial,
                                     da, B, U, md, W8, R, scale, s);
  return launch_bwd<float>(q, k, g, vol, biases, scal, dc, partial, da, B, U,
                           md, W8, R, scale, s);
}
