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
// 17 (md 32) GFLOP.  The TPU kernel held a full-width row stripe in VMEM;
// here a block owns RB rows and walks bm = 0..BM-1 in order, as the TPU
// grid did, so dlsum for its rows is summed in a fixed order with no
// atomics: at bm = 0 it is written, after that read and added to by the
// one thread that owns the element.  Per bm a first sweep over the row
// stripe takes the row sums (reduced across the block in a fixed order);
// a second sweep, 256 columns at a time with one column per thread and
// that k chunk staged in shared memory, recomputes c and writes dc.  The
// second sweep finds the stripe (RB x U x 4 bytes of p and g in bf16) in
// L2.
#include "common.cuh"

#define RB 8          // rows per block
#define CW NTHREADS   // columns per sweep-2 chunk, one per thread
#define CWP (CW + 1)  // padded row of the transposed k chunk

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    probs_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ p, const T* __restrict__ g,
                     const float* __restrict__ clip_ptr, T* __restrict__ dc,
                     float* __restrict__ dlsum, int BM, int U, int md,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // [md][CWP]: k chunk, transposed
  float* qs = ks + MAXMD * CWP;   // [RB][MAXMD]: this block's q rows
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
      qs[r * MAXMD + d] = r < nrows ? to_f(q[(base + r0 + r) * md + d]) : 0.f;
    }
    __syncthreads();
    float row[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) row[r] = rowsum[r];
    // Sweep 2: dl, the clamp mask, dc and dlsum, CW columns at a time.
    for (int c0 = 0; c0 < U; c0 += CW) {
      __syncthreads();  // the previous chunk's readers are done with ks
      for (int e = t; e < CW * md; e += NTHREADS) {
        const int col = e / md, d = e - col * md;
        const int j = c0 + col;
        ks[d * CWP + col] = j < U ? to_f(k[(base + j) * md + d]) : 0.f;
      }
      __syncthreads();
      const int j = c0 + t;
      if (j >= U) continue;
      float c[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) c[r] = 0.f;
      for (int d = 0; d < md; ++d) {
        const float kv = ks[d * CWP + t];
#pragma unroll
        for (int r = 0; r < RB; ++r) c[r] = fmaf(qs[r * MAXMD + d], kv, c[r]);
      }
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

template <typename T>
static int launch(const void* q, const void* k, const void* p, const void* g,
                  const void* clip, void* dc, void* dlsum, int BM, int U,
                  int md, float scale, cudaStream_t s) {
  const size_t smem = (MAXMD * CWP + RB * MAXMD) * sizeof(float);
  cudaError_t err = allow_smem(probs_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  probs_bwd_kernel<T><<<(U + RB - 1) / RB, NTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)p, (const T*)g, (const float*)clip,
      (T*)dc, (float*)dlsum, BM, U, md, scale);
  return (int)cudaGetLastError();
}

// q, k: [BM, U, md]; p, g, dc: [BM, U, U]; all contiguous, bf16 when
// io_bf16 else fp32; md <= 64; clip: [1] fp32; dlsum: [U, U] fp32.
extern "C" int probs_bwd_launch(const void* q, const void* k, const void* p,
                                const void* g, const void* clip, void* dc,
                                void* dlsum, int BM, int U, int md,
                                float scale, int io_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (io_bf16)
    return launch<__nv_bfloat16>(q, k, p, g, clip, dc, dlsum, BM, U, md,
                                 scale, s);
  return launch<float>(q, k, p, g, clip, dc, dlsum, BM, U, md, scale, s);
}
