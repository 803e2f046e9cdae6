// B5: the multi-level windowed bilinear lookup of the correlation pyramid,
// and its backward.
//
// Replaces craft_tpu/ops/pallas/corr_lookup.py:corr_lookup_pallas (its
// pallas_call in _lookup_all_levels, body _lookup_kernel) and, for the
// backward, the XLA VJP of corr_lookup_mxu that corr_lookup_tpu's custom_vjp
// runs.
//
// Planes.  The pyramid arrives as P = L D planes in (level, d) order: D = 1
// for the one-way volume, D = 2 for the two-way one (--f1), whose level l
// holds the planes p = l D + d, each its own [Q, h_l, w_l] array.  Plane p
// belongs to level p / D and is sampled at coords / 2^(p / D), and its
// (2r+1)^2 outputs are channel block p of the query's: the reference order
// (level, d, i, j).  The TPU kernel interleaved D into the lane axis
// ([Q, h, w D]), a tiling choice; separate planes keep each plane's rows the
// layout of a one-way level, so the loads and the backward's 16-byte units
// are those of D = 1.  Below, "level" means a plane.
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
// The radius is a template parameter (a kernel for each r <= MAXR), and all
// levels' corner loads are in flight together.  So is the most planes a
// kernel takes, NP = 4 or MAXP = 8 (two-way): its corner buffer holds NP
// planes a warp, and at NP = 8 and r >= 6 fewer warps a block keep it within
// the 48 KB of static shared memory (fwd_warps).
//
// Backward.  A query reads only its own slab, so queries never share a level
// element: each element of the dense gradient [Q, h_l, w_l] has one writer,
// and no atomics are needed (the result is deterministic).  Inside the
// query's (2r+2)^2 window it is the corner cotangent, gathered from the up to
// four taps of the (2r+1)^2 output cotangents as autograd's product rule
// orders them (the x blend, then the y blend, __fmul_rn/__fadd_rn); zero
// elsewhere.  Coords get no gradient (detached in the model).
//   The gradient is almost all zeros (at chairs 86 M elements a launch, 9 M
// of them in windows), so the kernel is a store stream: each level is one
// flat array of Q h_l w_l values cut into 16-byte units (8 bf16, 4 fp32),
// and a work item owns a run of whole units, so every unit has one writer
// and every store is 16 bytes wide (slabs of an odd size start anywhere, so a
// unit may straddle two queries and per-query stores could not be).  Per
// item: (1) one warp a query forms the corner cotangents of every query whose
// slab the run touches into shared memory and marks the units that its window
// span (the flat range from its window's first to its last element) covers;
// (2) the block writes the run: an unmarked unit is zeros with no index
// arithmetic, a marked one finds (q, y, x) of its first element once and
// steps it along its elements.  The items of all levels (level 0 first) form
// one launch, taken by a grid of whole waves that strides over them; a run is
// cut short where its slabs are so small that it would touch more queries
// than the shared memory holds.  The wrapper's tensors are 16-byte aligned.
//
// Bound on the H100: bytes.  The forward must read the windows,
// Q L (2r+2)^2 level values (not the whole pyramid), and write
// Q L (2r+1)^2 fp32; the backward must write the dense level gradients,
// Q sum_l h_l w_l values, which dominate.  The TPU kernel's block-diagonal
// MXU products and its padding of h to a multiple of 8 were Mosaic devices
// for a machine without a fast gather; a warp-level gather needs neither.
#include "common.cuh"

#define MAXP 8  // planes: L <= 4 levels of D = 1, or of D = 2
#define MAXR 7
#define WARPS 8
#define FWD_SMEM 49152  // static shared memory a block may declare

struct Levels {
  void* ptr[MAXP];
  int h[MAXP], w[MAXP];
};

// Warps a forward block of NP planes at radius R: WARPS, or as many as
// leave the corner buffer within FWD_SMEM.
__host__ __device__ constexpr int fwd_warps(int np, int r) {
  return FWD_SMEM / (np * (2 * r + 2) * (2 * r + 2) * 4) < WARPS
             ? FWD_SMEM / (np * (2 * r + 2) * (2 * r + 2) * 4)
             : WARPS;
}

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

// The forward for radius R: one warp a query.  Every corner load of all
// the query's levels is issued into registers before the first is used
// (the trip counts are compile-time: no division by a runtime m, no loop
// that waits level by level), so a warp waits on one round trip of loads,
// not one a level; the corners then go to shared memory (one __syncwarp),
// each lane blends its taps into registers, and the query's L (2r+1)^2
// outputs, staged in the same shared memory, leave in 16-byte stores when
// L (2r+1)^2 is a multiple of 4 (L = 4: 1296 bytes at r = 4).
template <typename T, int R, int NP>
__global__ void __launch_bounds__(fwd_warps(NP, R) * 32)
    lookup_fwd_kernel(Levels lv, int L, int D,
                      const float* __restrict__ coords,
                      float* __restrict__ out, int Q) {
  constexpr int n = 2 * R + 1, m = n + 1, MM = m * m, NN = n * n;
  constexpr int CIT = (MM + 31) / 32;  // corners a lane loads per level
  constexpr int OIT = (NN + 31) / 32;  // taps a lane blends per level
  constexpr int NW = fwd_warps(NP, R);
  __shared__ __align__(16) float buf[NW][NP * MM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * NW + warp;
  if (q >= Q) return;  // a whole warp; the block never synchronises
  float* g = buf[warp];
  const float cx = coords[2 * (size_t)q], cy = coords[2 * (size_t)q + 1];
  int x0[NP], y0[NP];
  float fx[NP], fy[NP];
  float v[NP][CIT];
#pragma unroll
  for (int l = 0; l < NP; ++l) {
    if (l >= L) continue;
    const int h = lv.h[l], w = lv.w[l];
    window_origin(cx, cy, l / D, h, w, R, &x0[l], &y0[l], &fx[l], &fy[l]);
    const T* slab = (const T*)lv.ptr[l] + (size_t)q * h * w;
#pragma unroll
    for (int it = 0; it < CIT; ++it) {
      const int e = lane + 32 * it;
      const int yy = y0[l] + e / m, xx = x0[l] + e % m;
      v[l][it] = (e < MM && yy >= 0 && yy < h && xx >= 0 && xx < w)
                     ? to_f(__ldg(slab + (size_t)yy * w + xx))
                     : 0.f;
    }
  }
#pragma unroll
  for (int l = 0; l < NP; ++l) {
    if (l >= L) continue;
#pragma unroll
    for (int it = 0; it < CIT; ++it) {
      const int e = lane + 32 * it;
      if (e < MM) g[l * MM + e] = v[l][it];
    }
  }
  __syncwarp();
  float o[NP][OIT];
#pragma unroll
  for (int l = 0; l < NP; ++l) {
    if (l >= L) continue;
    const float* gl = g + l * MM;
#pragma unroll
    for (int it = 0; it < OIT; ++it) {
      const int e = lane + 32 * it;
      if (e >= NN) continue;
      const int i = e / n, j = e - i * n;  // i offsets x, j offsets y
      const float a = lerp_rn(gl[j * m + i], gl[(j + 1) * m + i], fy[l]);
      const float b =
          lerp_rn(gl[j * m + i + 1], gl[(j + 1) * m + i + 1], fy[l]);
      o[l][it] = lerp_rn(a, b, fx[l]);
    }
  }
  __syncwarp();  // every corner is read: the buffer takes the outputs
#pragma unroll
  for (int l = 0; l < NP; ++l) {
    if (l >= L) continue;
#pragma unroll
    for (int it = 0; it < OIT; ++it) {
      const int e = lane + 32 * it;
      if (e < NN) g[l * NN + e] = o[l][it];
    }
  }
  __syncwarp();
  const int nout = L * NN;
  float* oq = out + (size_t)q * nout;
  if ((nout & 3) == 0) {  // oq is 16-byte aligned
    for (int e = lane; e < nout / 4; e += 32)
      reinterpret_cast<float4*>(oq)[e] = reinterpret_cast<const float4*>(g)[e];
  } else {
    for (int e = lane; e < nout; e += 32) oq[e] = g[e];
  }
}

// The backward's tiling: a work item writes at most B5B_RUN units of one
// level and touches at most qmax(R) queries, whose corner cotangents
// (B5B_CBUF floats at most) it holds in shared memory.
#define B5B_THREADS 256
#define B5B_RUN 4096
#define B5B_CBUF 8192
#define B5B_QMAX 256

__host__ __device__ constexpr int qmax(int r) {
  return B5B_CBUF / ((2 * r + 2) * (2 * r + 2)) < B5B_QMAX
             ? B5B_CBUF / ((2 * r + 2) * (2 * r + 2))
             : B5B_QMAX;
}

// The backward's work: per level its gradient, size, element count, the
// units an item takes, and its items [item0, item1) of the launch's.
struct BwdPlan {
  void* ptr[MAXP];
  int h[MAXP], w[MAXP], ub[MAXP], item0[MAXP], item1[MAXP];
  long long nel[MAXP], units[MAXP];
};

// Units an item of a level of hw values a query takes: at most B5B_RUN,
// and few enough that its ub * ue elements touch at most q queries
// (floor((ub ue - 1) / hw) + 2 <= q when ub ue <= (q - 1) hw).
static inline int item_units(int hw, int ue, int q) {
  const long long ub = (long long)(q - 1) * hw / ue;
  return (int)(ub < 1 ? 1 : ub > B5B_RUN ? B5B_RUN : ub);
}

// A unit's values in the level type, as one 16-byte word (the lower
// address in the lower bits).
__device__ __forceinline__ uint4 pack_unit(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}
__device__ __forceinline__ uint4 pack_unit(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

template <typename T, int R>
__global__ void __launch_bounds__(B5B_THREADS)
    lookup_bwd_kernel(BwdPlan pl, int L, int D, int nitems,
                      const float* __restrict__ coords,
                      const float* __restrict__ gout) {
  constexpr int n = 2 * R + 1, m = n + 1, MM = m * m, NN = n * n;
  constexpr int UE = 16 / sizeof(T);  // elements a unit
  constexpr int QM = qmax(R);
  constexpr int NW = B5B_THREADS / 32;
  __shared__ float gc[QM * MM];  // corner cotangents, per touched query
  __shared__ int org[QM][2];     // the window's first corner (x0, y0)
  __shared__ float frac[QM][2];  // and its fractional offset (fx, fy)
  __shared__ unsigned touched[B5B_RUN / 32];  // units in a window span
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    int l = 0;
    while (item < pl.item0[l] || item >= pl.item1[l]) ++l;
    const int h = pl.h[l], w = pl.w[l], hw = h * w, ub = pl.ub[l];
    const long long u0 = (long long)(item - pl.item0[l]) * ub;
    const int nu = (int)min((long long)ub, pl.units[l] - u0);
    const long long e0 = u0 * UE, e1 = min(e0 + (long long)nu * UE,
                                           pl.nel[l]);
    const int qa = (int)(e0 / hw), nq = (int)((e1 - 1) / hw) - qa + 1;
    const long long base = (long long)qa * hw;  // qa's first element

    // (1a) Each touched query's window origin; the span bits cleared.
    for (int i = threadIdx.x; i < B5B_RUN / 32; i += B5B_THREADS)
      touched[i] = 0u;
    for (int qi = threadIdx.x; qi < nq; qi += B5B_THREADS) {
      const int q = qa + qi;
      window_origin(coords[2 * (size_t)q], coords[2 * (size_t)q + 1], l / D,
                    h, w, R, &org[qi][0], &org[qi][1], &frac[qi][0],
                    &frac[qi][1]);
    }
    __syncthreads();

    // (1b) The corner cotangents, every (query, corner row) of the item
    // spread over the block; a corner row reads the query's output
    // cotangents of two window rows (j = y, y - 1) once.  Corner (y, x):
    // the x blend hands row j = y (and j = y - 1) the cotangent dgy(j, x) =
    // (1 - fx) t(i = x, j) + fx t(i = x - 1, j); the y blend hands the
    // corner (1 - fy) dgy(y, x) + fy dgy(y - 1, x).
    for (int cr = threadIdx.x; cr < nq * m; cr += B5B_THREADS) {
      const int qi = cr / m, y = cr - qi * m;
      const float fx = frac[qi][0], fy = frac[qi][1];
      const float* gt = gout + ((size_t)(qa + qi) * L + l) * NN;
      float t[2][n];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = y - s;
#pragma unroll
        for (int i = 0; i < n; ++i)
          t[s][i] = j >= 0 && j < n ? __ldg(gt + i * n + j) : 0.f;
      }
      float* row = gc + qi * MM + y * m;
#pragma unroll
      for (int x = 0; x < m; ++x) {
        float dgy[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = y - s;
          float v = 0.f;
          if (j >= 0 && j < n) {
            const float a = x < n ? __fmul_rn(1.f - fx, t[s][x]) : 0.f;
            const float b = x > 0 ? __fmul_rn(fx, t[s][x - 1]) : 0.f;
            v = __fadd_rn(a, b);
          }
          dgy[s] = v;
        }
        const float a = y < n ? __fmul_rn(1.f - fy, dgy[0]) : 0.f;
        const float b = y > 0 ? __fmul_rn(fy, dgy[1]) : 0.f;
        row[x] = __fadd_rn(a, b);
      }
    }
    // ... and, one warp a query, the units that its window's elements in
    // the level (rows ys..ye-1, columns xs..xe-1 of its slab) cover, from
    // the item's first element: each window row's run of elements marks
    // its one to three units.
    constexpr int RU = (m + UE - 2) / UE + 1;  // units a window row spans
    for (int qi = warp; qi < nq; qi += NW) {
      const int x0 = org[qi][0], y0 = org[qi][1];
      const int ys = max(y0, 0), ye = min(y0 + m, h);
      const int xs = max(x0, 0), xe = min(x0 + m, w);
      if (ys >= ye || xs >= xe) continue;
      const long long off = (long long)(qa + qi) * hw - e0 + xs;
      for (int k = lane; k < (ye - ys) * RU; k += 32) {
        const int yy = ys + k / RU;
        long long lo = off + (long long)yy * w;
        long long hi = lo + (xe - xs);
        lo = max(lo, 0LL);
        hi = min(hi, (long long)nu * UE);
        if (lo >= hi) continue;
        const int u = (int)(lo / UE) + k % RU;
        if (u <= (int)((hi - 1) / UE))
          atomicOr(&touched[u >> 5], 1u << (u & 31));
      }
    }
    __syncthreads();

    // (2) The run in 16-byte units, built in registers: units before
    // `whole` lie wholly inside the level.
    T* dl = (T*)pl.ptr[l];
    const float inv_hw = 1.f / (float)hw, inv_w = 1.f / (float)w;
    const int whole = (int)min((long long)nu, (pl.nel[l] - e0) / UE);
    for (int u = threadIdx.x; u < nu; u += B5B_THREADS) {
      const long long ue = e0 + (long long)u * UE;
      float v[UE];
#pragma unroll
      for (int k = 0; k < UE; ++k) v[k] = 0.f;
      if (touched[u >> 5] >> (u & 31) & 1u) {
        // (q, y, x) of the unit's first element: quotients from fp32
        // reciprocals (rel < 2^24, so off by one at most) set right.
        const int rel = (int)(ue - base);
        int qi = (int)((float)rel * inv_hw);
        qi -= qi * hw > rel;
        qi += (qi + 1) * hw <= rel;
        const int rem = rel - qi * hw;
        int y = (int)((float)rem * inv_w);
        y -= y * w > rem;
        y += (y + 1) * w <= rem;
        int x = rem - y * w;
        if (x + UE <= w) {  // one row of one query
          const int cy0 = y - org[qi][1], cx0 = x - org[qi][0];
          if ((unsigned)cy0 < (unsigned)m) {
            const float* grow = gc + qi * MM + cy0 * m;
#pragma unroll
            for (int k = 0; k < UE; ++k)
              if ((unsigned)(cx0 + k) < (unsigned)m) v[k] = grow[cx0 + k];
          }
        } else {  // across rows or queries: step (q, y, x) along it
          const int ne = (int)min((long long)UE, pl.nel[l] - ue);
#pragma unroll
          for (int k = 0; k < UE; ++k) {
            if (k < ne) {
              const int cy0 = y - org[qi][1], cx0 = x - org[qi][0];
              if ((unsigned)cy0 < (unsigned)m && (unsigned)cx0 < (unsigned)m)
                v[k] = gc[qi * MM + cy0 * m + cx0];
            }
            if (++x == w) {
              x = 0;
              if (++y == h) {
                y = 0;
                ++qi;
              }
            }
          }
        }
      }
      if (u < whole) {
        *reinterpret_cast<uint4*>(dl + ue) = pack_unit(v);
      } else {  // the level's last unit, cut short at its end
        const int ne = (int)(pl.nel[l] - ue);
#pragma unroll
        for (int k = 0; k < UE; ++k)
          if (k < ne) dl[ue + k] = from_f<T>(v[k]);
      }
    }
    __syncthreads();  // gc, org and touched are rewritten by the next item
  }
}

static inline cudaError_t fill_levels(Levels* lv, void* const* ptrs,
                                      const int* hw, int L, int D, int r) {
  if (L < 1 || L > MAXP || D < 1 || L % D || r < 0 || r > MAXR)
    return cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    lv->ptr[l] = ptrs[l];
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
  }
  return cudaSuccess;
}

// levels: L host pointers to [Q, h_l, w_l] contiguous device arrays (bf16
// when in_bf16, else fp32), the planes of L / D levels in (level, d) order;
// hw: 2L host ints (h_0, w_0, h_1, ...); coords: [Q, 2] fp32 (x, y); out:
// [Q, L (2r+1)^2] fp32.  L <= 8 planes, D divides L, r <= 7.
template <typename T, int R, int NP>
static void launch_fwd_np(const Levels& lv, int L, int D, const float* coords,
                       float* out, int Q, cudaStream_t s) {
  constexpr int nw = fwd_warps(NP, R);
  lookup_fwd_kernel<T, R, NP><<<(Q + nw - 1) / nw, nw * 32, 0, s>>>(
      lv, L, D, coords, out, Q);
}

template <typename T, int R>
static void launch_fwd(const Levels& lv, int L, int D, const float* coords,
                       float* out, int Q, cudaStream_t s) {
  if (L <= 4)
    launch_fwd_np<T, R, 4>(lv, L, D, coords, out, Q, s);
  else
    launch_fwd_np<T, R, MAXP>(lv, L, D, coords, out, Q, s);
}

extern "C" int corr_lookup_launch(void* const* levels, const int* hw, int L,
                                  int D, const void* coords, void* out,
                                  int Q, int r, int in_bf16, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, levels, hw, L, D, r);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)coords;
  float* o = (float*)out;
  switch (r) {
#define CASE(R)                                                \
  case R:                                                      \
    if (in_bf16)                                               \
      launch_fwd<__nv_bfloat16, R>(lv, L, D, c, o, Q, s);      \
    else                                                       \
      launch_fwd<float, R>(lv, L, D, c, o, Q, s);              \
    break;
    CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
#undef CASE
  }
  static_assert(MAXR == 7, "a case for every radius");
  return (int)cudaGetLastError();
}

// The backward's items at this radius and element size: each level's
// units in runs of item_units.  The smallest level's items come first:
// theirs touch the most queries a byte, and the grid takes them in its
// first round rather than as a tail.  Returns the item count.
static int plan_items(BwdPlan* pl, const Levels& lv, int L, int Q, int r,
                      int esz) {
  const int ue = 16 / esz;
  int items = 0;
  for (int l = L - 1; l >= 0; --l) {
    const long long hw = (long long)lv.h[l] * lv.w[l];
    pl->ptr[l] = lv.ptr[l];
    pl->h[l] = lv.h[l];
    pl->w[l] = lv.w[l];
    pl->nel[l] = (long long)Q * hw;
    pl->units[l] = (pl->nel[l] * esz + 15) / 16;
    pl->ub[l] = hw > 0 ? item_units((int)hw, ue, qmax(r)) : 1;
    pl->item0[l] = items;
    items += (int)((pl->units[l] + pl->ub[l] - 1) / pl->ub[l]);
    pl->item1[l] = items;
  }
  return items;
}

template <typename T, int R>
static int launch_bwd(const BwdPlan& pl, int L, int D, int items,
                      const float* coords, const float* gout,
                      cudaStream_t s) {
  auto kernel = lookup_bwd_kernel<T, R>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        B5B_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(items, max(1, sms * per_sm));  // whole waves
  kernel<<<grid, B5B_THREADS, 0, s>>>(pl, L, D, items, coords, gout);
  return (int)cudaGetLastError();
}

// dlevels: L host pointers to [Q, h_l, w_l] 16-byte aligned device arrays
// that the kernel fills completely (bf16 when out_bf16, else fp32), the
// planes of L / D levels in (level, d) order; gout: [Q, L (2r+1)^2] fp32,
// the cotangent of the forward's output.
extern "C" int corr_lookup_bwd_launch(void* const* dlevels, const int* hw,
                                      int L, int D, const void* coords,
                                      const void* gout, int Q, int r,
                                      int out_bf16, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, dlevels, hw, L, D, r);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l)
    if ((uintptr_t)dlevels[l] & 15) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  BwdPlan pl;
  const int items = plan_items(&pl, lv, L, Q, r, out_bf16 ? 2 : 4);
  if (items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *c = (const float*)coords, *g = (const float*)gout;
  switch (r) {
#define CASE(R)                                                             \
  case R:                                                                   \
    return out_bf16 ? launch_bwd<__nv_bfloat16, R>(pl, L, D, items, c, g, s) \
                    : launch_bwd<float, R>(pl, L, D, items, c, g, s);
    CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
