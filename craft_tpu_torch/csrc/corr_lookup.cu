// B5: the multi-level windowed bilinear lookup of the correlation pyramid,
// and its backward.
//
// Replaces craft_tpu/ops/pallas/corr_lookup.py:corr_lookup_pallas (its
// pallas_call in _lookup_all_levels, body _lookup_kernel) and, for the
// backward, the XLA VJP of corr_lookup_mxu that corr_lookup_tpu's custom_vjp
// runs.
//
// Forward.  Query q has coords (x, y) at 1/8 resolution; level l is its own
// [h_l, w_l] slab of the pyramid.  Tap (i, j) of the (2r+1)^2 window samples
// (x / 2^l + i - r, y / 2^l + j - r) bilinearly, align_corners=True, zero
// outside the level.  Every tap of a query shares one fractional offset
// (fx, fy), so one warp per query loads the (2r+2)^2 integer corner grid
// around the window once into shared memory (zero outside the level), blends
// rows (y) then columns (x) in fp32 with the plain version's operations in
// its order (no fused multiply-add, so the two agree bit for bit), and
// writes out[q, l (2r+1)^2 + i (2r+1) + j], the reference channel order.
//
// Backward.  A query reads only its own slab, so queries never share a level
// element and a warp owns a query's whole gradient: it forms the (2r+2)^2
// corner cotangents in fp32 from the (2r+1)^2 output cotangents (each corner
// gathers its up to four taps, as autograd's product rule orders them: the x
// blend, then the y blend), and writes the query's dense slab once, the
// corner cotangent inside the window and zero elsewhere.  No atomics, so the
// result is deterministic.  Coords get no gradient (detached in the model).
//
// Bound on the H100: bytes.  The forward must read the windows,
// Q L (2r+2)^2 level values (not the whole pyramid), and write
// Q L (2r+1)^2 fp32; the backward must write the dense level gradients,
// Q sum_l h_l w_l values, which dominate.  The TPU kernel's block-diagonal
// MXU products and its padding of h to a multiple of 8 were Mosaic devices
// for a machine without a fast gather; a warp-level gather needs neither.
#include "common.cuh"

#define MAXL 4
#define MAXR 7
#define MAXC ((2 * MAXR + 2) * (2 * MAXR + 2))
#define MAXT ((2 * MAXR + 1) * (2 * MAXR + 1))
#define WARPS 8

struct Levels {
  void* ptr[MAXL];
  int h[MAXL], w[MAXL];
};

// The window's first corner (column x0, row y0) and fractional offset of
// level l.  A window wholly outside the level reads zero whatever its
// corner, so the float is clamped before the int conversion.
__device__ __forceinline__ void window_origin(float cx, float cy, int l,
                                              int h, int w, int r, int* x0,
                                              int* y0, float* fx, float* fy) {
  const float inv = 1.f / (float)(1 << l);  // exact: coords / 2^l
  const float bx = cx * inv, by = cy * inv;
  const float xf = floorf(bx), yf = floorf(by);
  *fx = bx - xf;
  *fy = by - yf;
  const float m = (float)(2 * r + 2);
  *x0 = (int)fminf(fmaxf(xf, -2.f * m), (float)w + m) - r;
  *y0 = (int)fminf(fmaxf(yf, -2.f * m), (float)h + m) - r;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(1.f - t, a), __fmul_rn(t, b));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    lookup_fwd_kernel(Levels lv, int L, const float* __restrict__ coords,
                      float* __restrict__ out, int Q, int r) {
  __shared__ float corners[WARPS][MAXC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= Q) return;  // a whole warp; the block never synchronises
  const int n = 2 * r + 1, m = n + 1;
  float* g = corners[warp];
  const float cx = coords[2 * (size_t)q], cy = coords[2 * (size_t)q + 1];
  float* o = out + (size_t)q * L * n * n;
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    int x0, y0;
    float fx, fy;
    window_origin(cx, cy, l, h, w, r, &x0, &y0, &fx, &fy);
    const T* slab = (const T*)lv.ptr[l] + (size_t)q * h * w;
    for (int e = lane; e < m * m; e += 32) {
      const int yy = y0 + e / m, xx = x0 + e % m;
      g[e] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                 ? to_f(slab[(size_t)yy * w + xx])
                 : 0.f;
    }
    __syncwarp();
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - i * n;  // i offsets x, j offsets y
      const float a = lerp_rn(g[j * m + i], g[(j + 1) * m + i], fy);
      const float b = lerp_rn(g[j * m + i + 1], g[(j + 1) * m + i + 1], fy);
      o[l * n * n + e] = lerp_rn(a, b, fx);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    lookup_bwd_kernel(Levels dlv, int L, const float* __restrict__ coords,
                      const float* __restrict__ gout, int Q, int r) {
  __shared__ float gtap[WARPS][MAXT];
  __shared__ float gcorner[WARPS][MAXC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= Q) return;
  const int n = 2 * r + 1, m = n + 1;
  float* gt = gtap[warp];
  float* gc = gcorner[warp];
  const float cx = coords[2 * (size_t)q], cy = coords[2 * (size_t)q + 1];
  const float* go = gout + (size_t)q * L * n * n;
  for (int l = 0; l < L; ++l) {
    const int h = dlv.h[l], w = dlv.w[l];
    int x0, y0;
    float fx, fy;
    window_origin(cx, cy, l, h, w, r, &x0, &y0, &fx, &fy);
    for (int e = lane; e < n * n; e += 32) gt[e] = go[l * n * n + e];
    __syncwarp();
    // Corner (y, x): the x blend hands row j = y (and j = y - 1) the
    // cotangent dgy(j, x) = (1 - fx) t(i = x, j) + fx t(i = x - 1, j); the
    // y blend hands the corner (1 - fy) dgy(y, x) + fy dgy(y - 1, x).
    for (int e = lane; e < m * m; e += 32) {
      const int y = e / m, x = e - y * m;
      float dgy[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = y - s;
        float v = 0.f;
        if (j >= 0 && j < n) {
          const float a = x < n ? __fmul_rn(1.f - fx, gt[x * n + j]) : 0.f;
          const float b = x > 0 ? __fmul_rn(fx, gt[(x - 1) * n + j]) : 0.f;
          v = __fadd_rn(a, b);
        }
        dgy[s] = v;
      }
      const float a = y < n ? __fmul_rn(1.f - fy, dgy[0]) : 0.f;
      const float b = y > 0 ? __fmul_rn(fy, dgy[1]) : 0.f;
      gc[e] = __fadd_rn(a, b);
    }
    __syncwarp();
    T* slab = (T*)dlv.ptr[l] + (size_t)q * h * w;
    for (int e = lane; e < h * w; e += 32) {
      const int yy = e / w, xx = e - yy * w;
      const int cy0 = yy - y0, cx0 = xx - x0;
      const float v = (cy0 >= 0 && cy0 < m && cx0 >= 0 && cx0 < m)
                          ? gc[cy0 * m + cx0]
                          : 0.f;
      slab[e] = from_f<T>(v);
    }
    __syncwarp();
  }
}

static inline cudaError_t fill_levels(Levels* lv, void* const* ptrs,
                                      const int* hw, int L, int r) {
  if (L < 1 || L > MAXL || r < 0 || r > MAXR) return cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    lv->ptr[l] = ptrs[l];
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
  }
  return cudaSuccess;
}

// levels: L host pointers to [Q, h_l, w_l] contiguous device arrays (bf16
// when in_bf16, else fp32); hw: 2L host ints (h_0, w_0, h_1, ...);
// coords: [Q, 2] fp32 (x, y); out: [Q, L (2r+1)^2] fp32.  L <= 4, r <= 7.
extern "C" int corr_lookup_launch(void* const* levels, const int* hw, int L,
                                  const void* coords, void* out, int Q, int r,
                                  int in_bf16, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, levels, hw, L, r);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (Q + WARPS - 1) / WARPS;
  if (in_bf16)
    lookup_fwd_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, s>>>(
        lv, L, (const float*)coords, (float*)out, Q, r);
  else
    lookup_fwd_kernel<float><<<blocks, WARPS * 32, 0, s>>>(
        lv, L, (const float*)coords, (float*)out, Q, r);
  return (int)cudaGetLastError();
}

// dlevels: L host pointers to [Q, h_l, w_l] device arrays that the kernel
// fills completely (bf16 when out_bf16, else fp32); gout: [Q, L (2r+1)^2]
// fp32, the cotangent of the forward's output.
extern "C" int corr_lookup_bwd_launch(void* const* dlevels, const int* hw,
                                      int L, const void* coords,
                                      const void* gout, int Q, int r,
                                      int out_bf16, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, dlevels, hw, L, r);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (Q + WARPS - 1) / WARPS;
  if (out_bf16)
    lookup_bwd_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, s>>>(
        lv, L, (const float*)coords, (const float*)gout, Q, r);
  else
    lookup_bwd_kernel<float><<<blocks, WARPS * 32, 0, s>>>(
        lv, L, (const float*)coords, (const float*)gout, Q, r);
  return (int)cudaGetLastError();
}
