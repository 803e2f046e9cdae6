// Tensor-core pieces of the bf16 bodies (sm_90a), shared by B1
// (scores_max.cu), B2 and B8 (flash_attn.cu), B3, B9, B6 and B6 dense (the
// sweep of agg_modes.cuh), B4 (softmax_probs.cu), B6's backward
// (agg_corr.cu) and B7 (probs_bwd.cu):
// asynchronous copies, the wgmma wrappers and fences, mbarriers, matrix
// descriptors and the swizzles they name, staged 16-byte stores, and the
// bias sources on accumulator fragments (the sliding window, none, a dense
// table).
//
// Fragments.  A warpgroup (4 warps, 128 threads) owns a 64-row tile of a
// wgmma accumulator; warp w of it holds rows 16 w + g and 16 w + g + 8,
// d[j][0..1] and d[j][2..3] at columns 8 j + 2 t and 8 j + 2 t + 1, with
// g = lane / 4, t = lane % 4 (the mma.sync C layout, one n tile of 8
// columns per j).  Tiles in shared memory are bf16 rows of 16-byte chunks,
// K-major, swizzled as swz<> says, from 1024-byte aligned bases.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

#define LOG2E 1.4426950408889634f

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes (4 bytes) from global to shared memory, asynchronously; zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
// The first n (0..16) of 16 bytes, the rest zeros: a unit that runs past
// the end of a tensor (src is not read when n is 0).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
// Waits until this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// Two floats as bf16 in one register, lo in the low half (the lower column
// of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma (sm_90a): a warpgroup's 64 x N x 16 product, A (16 bf16 of each of
// the warpgroup's 64 rows) from registers in the m16n8k16 A layout per
// warp, B from shared memory through a matrix descriptor; d += a b (d = a b
// when scale_d is 0).  The accumulator of warp w holds rows 16 w + g and
// 16 w + g + 8, d[j][0..1] and d[j][2..3] at columns 8 j + 2 t, + 1: the
// mma.sync C layout, one n tile of 8 columns per j.
__device__ __forceinline__ void wgmma_s(float (*d)[4], const uint32_t a[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The m64n32k16 product with A from shared memory too (a K-major tile
// through its own descriptor, as B), so that the 64 rows of the
// warpgroup's A tile take no registers: a 32-column accumulator, d[j] for
// j < 4.
__device__ __forceinline__ void wgmma_ss32(float (*d)[4], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The m64n16k16 product with both operands from shared memory: a
// 16-column accumulator, d[j] for j < 2.
__device__ __forceinline__ void wgmma_ss16(float (*d)[4], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// B MN-major (v: keys x features, features contiguous): the 64 x N x 16
// product o += p v of the flash body at N = F, 256 or 128 features.
template <int N>
__device__ __forceinline__ void wgmma_o(float (*d)[4], const uint32_t a[4],
                                        uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_o<128>(float (*d)[4],
                                             const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_o<256>(float (*d)[4],
                                             const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one committed group of this warpgroup is in flight.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Shared memory written by cp.async (the generic proxy) made visible to
// wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Registers that an asynchronous wgmma reads or writes stay where they are
// until its wait: the compiler may not move their uses across this point.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// mbarriers (shared memory, 8 bytes): init with an arrival count; arrive;
// arrive when this thread's cp.async copies so far have landed (counted in
// the init count); wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_copies(uint32_t a) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   a)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}
// Named barrier `id` over N threads of the block: wait there, or arrive
// without waiting.
template <int N>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Staged stores (B6 backward, B7): a tile row staged in shared memory at
// the offset that its global start has within a 16-byte unit goes out in
// 16-byte units, so that a warp writes whole 32-byte sectors.  Bytes [lo,
// hi) of the unit staged at src (16-byte aligned) to dst (its 16-byte
// aligned place in global memory): one 16-byte store where the unit is
// whole, else pieces of 8, 4 and 2 bytes on their own alignment (lo, hi
// even: the row's first and last units).
__device__ __forceinline__ void put_unit(unsigned char* dst,
                                         const unsigned char* src, int lo,
                                         int hi) {
  if (lo == 0 && hi == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (int b = lo; b < hi;) {
    if ((b & 7) == 0 && b + 8 <= hi) {
      *reinterpret_cast<uint2*>(dst + b) =
          *reinterpret_cast<const uint2*>(src + b);
      b += 8;
    } else if ((b & 3) == 0 && b + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(dst + b) =
          *reinterpret_cast<const uint32_t*>(src + b);
      b += 4;
    } else {
      *reinterpret_cast<uint16_t*>(dst + b) =
          *reinterpret_cast<const uint16_t*>(src + b);
      b += 2;
    }
  }
}

// Unit u of a staged row whose nb bytes stand from byte m (< 16) of their
// staging row and go to global byte address a (a % 16 == m): unit u covers
// global [a - m + 16 u, + 16).  Nothing where the unit holds none of them.
__device__ __forceinline__ void put_row_unit(unsigned char* a_row,
                                             const unsigned char* srow,
                                             int m, int nb, int u) {
  const int lo = max(0, m - 16 * u), hi = min(16, m + nb - 16 * u);
  if (lo < hi) put_unit(a_row - m + 16 * u, srow + 16 * u, lo, hi);
}

// The wgmma matrix descriptor of a tile at shared address addr: leading and
// stride byte offsets, layout 1 (128-byte swizzle), 2 (64) or 3 (32).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// The physical 16-byte chunk of chunk c in row r of a bf16 tile with C
// chunks (16-byte units) a row, C = 8, 4 or 2: the 128-, 64- and 32-byte
// swizzles that wgmma reads (address bits 4.. XOR bits 7..), so that the 8
// rows of a core matrix at one chunk land in different bank groups.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (C >= 8)
    return c ^ (r & 7);
  else
    return c ^ ((r / (8 / C)) & (C - 1));
}

// The (2R+1)^2 window in shared memory, looked up only on key tiles that
// lie within +-R grid rows of the q tile.  A block of THREADS threads owns
// ROWS query rows from qt * ROWS, a warp 16 of them (warp w: rows 16 w' ..
// 16 w' + 15, w' = w % (ROWS / 16), so that several warpgroups may share
// the rows), and takes KEYS keys a tile.
template <int ROWS, int KEYS, int THREADS>
struct MmaWindowT {
  static constexpr int STAGE = 0, SMEM = (MAXWIN * 4 + 15) / 16 * 16;
  const float* win;
  int W8, R, U2;
  int qh[2], qw[2];  // token coordinates of the thread's two rows
  int qh_lo, qh_hi;  // grid rows of the warp's first and last token
  int qw_lo, qw_hi;  // ... and their columns
  __device__ __forceinline__ void init(unsigned char* sm, const BiasArgs& a,
                                       int qt) {
    float* w = reinterpret_cast<float*>(sm);
    W8 = a.W8;
    R = a.R;
    U2 = a.U2;
    for (int e = threadIdx.x; e < (2 * R + 1) * (2 * R + 1); e += THREADS)
      w[e] = a.data[e];
    win = w;
    const int tok0 =
        a.q_tok0 + qt * ROWS + ((threadIdx.x >> 5) % (ROWS / 16)) * 16;
    const int u = tok0 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qh[i] = (u + 8 * i) / W8;
      qw[i] = (u + 8 * i) - qh[i] * W8;
    }
    qh_lo = tok0 / W8;
    qh_hi = (tok0 + 15) / W8;
    qw_lo = tok0 - qh_lo * W8;
    qw_hi = tok0 + 15 - qh_hi * W8;
  }
  __device__ __forceinline__ void load(unsigned char*, int) {}
  // Whether a key of tile kt lies within +-R grid rows of a query of this
  // warp (warp-uniform).
  __device__ __forceinline__ bool in_band(int kt) const {
    const int key0 = kt * KEYS;
    const int kh_lo = key0 / W8;
    const int kh_hi = (min(key0 + KEYS, U2) - 1) / W8;
    return !(kh_lo > qh_hi + R || kh_hi < qh_lo - R);
  }
  // The same for keys key0 .. key0 + nkeys - 1, and where those keys and
  // the warp's queries each lie in one grid row, also within +-R columns
  // of a query (warp-uniform).
  __device__ __forceinline__ bool keys_in_window(int key0, int nkeys) const {
    const int k_hi = min(key0 + nkeys, U2) - 1;
    const int kh_lo = key0 / W8, kh_hi = k_hi / W8;
    if (kh_lo > qh_hi + R || kh_hi < qh_lo - R) return false;
    if (kh_lo != kh_hi || qh_lo != qh_hi) return true;
    const int kw_lo = key0 - kh_lo * W8, kw_hi = k_hi - kh_lo * W8;
    return !(kw_lo > qw_hi + R || kw_hi < qw_lo - R);
  }
  // Column by column, for callers that add one bias to several fragment
  // sets: (kh, kw) = the token coordinates of column key0 + 2 t ...
  __device__ __forceinline__ void first_col(int key0, int& kh,
                                            int& kw) const {
    const int u = key0 + 2 * (threadIdx.x & 3);
    kh = u / W8;
    kw = u - kh * W8;
  }
  // ... then, per n tile j in order, b[2 i + c] = pos_w * the window entry
  // of the thread's row i and column key0 + 8 j + 2 t + c (0 outside the
  // window), and (kh, kw) stepped to n tile j + 1.
  __device__ __forceinline__ void col_bias(int& kh, int& kw, float pos_w,
                                           float b[4]) const {
    const int side = 2 * R + 1;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int h = kh, w = kw + c;
      if (w == W8) {
        w = 0;
        ++h;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int dh = h - qh[i] + R, dw = w - qw[i] + R;
        b[2 * i + c] = (unsigned)dh <= (unsigned)(2 * R) &&
                               (unsigned)dw <= (unsigned)(2 * R)
                           ? pos_w * win[dh * side + dw]
                           : 0.f;
      }
    }
    kw += 8;
    while (kw >= W8) {
      kw -= W8;
      ++kh;
    }
  }
  __device__ __forceinline__ void add(float (*sc)[4], int kt, unsigned char*,
                                      float pos_w) const {
    if (!in_band(kt)) return;  // warp-uniform
    const int key0 = kt * KEYS;
    const int side = 2 * R + 1;
    const int t = threadIdx.x & 3;
    int kh = (key0 + 2 * t) / W8;
    int kw = (key0 + 2 * t) - kh * W8;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int h = kh, w = kw + c;
        if (w == W8) {
          w = 0;
          ++h;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int dh = h - qh[i] + R, dw = w - qw[i] + R;
          if ((unsigned)dh <= (unsigned)(2 * R) &&
              (unsigned)dw <= (unsigned)(2 * R))
            sc[j][2 * i + c] += pos_w * win[dh * side + dw];
        }
      }
      kw += 8;
      while (kw >= W8) {
        kw -= W8;
        ++kh;
      }
    }
  }
  // The sweep's form (agg_modes.cuh): pos_w * the bias of keys key0 ..
  // key0 + 8 NT - 1 added to NM accumulator sets of one fragment layout
  // (every mode's scores of the same elements).  The tile row and the
  // stage are the table's; the window takes its rows from init.
  template <int NM, int NT>
  __device__ __forceinline__ void add_modes(float (&acc)[NM][NT][4], int,
                                            int key0, const unsigned char*,
                                            float pos_w) const {
    if (!keys_in_window(key0, 8 * NT)) return;  // warp-uniform
    int kh, kw;
    first_col(key0, kh, kw);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float bj[4];
      col_bias(kh, kw, pos_w, bj);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[m][j][e] += bj[e];
    }
  }
};

// Bias sources of the bf16 bodies of B2/B8, B4 (B4 dense) and the sweep of
// B3/B9 and B6 (B6 dense), beside MmaWindowT.  STAGE: bytes a ring stage takes beside the keys (and
// values); SMEM: bytes after the ring.  init(smem, args, qt) once per block
// (published by the first barrier of the key loop); load(stage, kt) starts
// the asynchronous copies of key tile kt (committed with k and v);
// add(sc, kt, stage, pos_w) adds pos_w * bias to the thread's fragments
// sc[j][e] of key tile kt: rows warp * 16 + g (e < 2) and + 8 (e >= 2),
// columns 8 j + 2 t + (e & 1), with g = lane / 4, t = lane % 4;
// add_modes(acc, r, key0, stage, pos_w) the sweep's form (MmaWindowT).
struct MmaNoBias {
  static constexpr int STAGE = 0, SMEM = 0;
  __device__ __forceinline__ void init(unsigned char*, const BiasArgs&,
                                       int) {}
  __device__ __forceinline__ void load(unsigned char*, int) {}
  __device__ __forceinline__ void add(float (*)[4], int, unsigned char*,
                                      float) const {}
  template <int NM, int NT>
  __device__ __forceinline__ void add_modes(float (&)[NM][NT][4], int, int,
                                            const unsigned char*,
                                            float) const {}
};

// A ROWS x KEYS (64) fp32 tile of the table a stage, for blocks of THREADS
// threads (add: whose warp w owns rows 16 w .. 16 w + 15; add_modes: the
// sweep's warps, which share rows); its 16-byte chunks are swizzled by
// (row % 4) * 2: the 8-byte reads of a half-warp (rows g = 0..3 or 4..7,
// columns 8 j + 2 t) then fall in 16 different banks.
template <int ROWS, int KEYS, int THREADS>
struct MmaTableT {
  static constexpr int STAGE = ROWS * KEYS * 4, SMEM = 0;
  static_assert(KEYS == 64, "16 chunks of 4 keys a row");
  static_assert(ROWS * KEYS % (4 * THREADS) == 0, "whole copies");
  static constexpr int TROWS = THREADS / 16;  // rows a pass of copies covers
  const float* table;
  const float* src;  // 16-byte path: this thread's chunk of row r, key 0
  int U1, U2, row0, rows_left;
  uint32_t dst;      // ... and its place in a stage
  bool by16;  // 16-byte copies: rows 16-byte aligned, U2 % 4 == 0
  __device__ __forceinline__ void init(unsigned char*, const BiasArgs& a,
                                       int qt) {
    table = a.data;
    U1 = a.U1;
    U2 = a.U2;
    row0 = qt * ROWS;
    by16 = ((uintptr_t)table & 15) == 0 && (U2 & 3) == 0;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    rows_left = U1 - row0 - r;  // copies it with r + TROWS it < U1 - row0
    src = table + (size_t)(rows_left > 0 ? row0 + r : 0) * U2 + 4 * c;
    dst = (r * KEYS + ((c ^ ((r & 3) << 1)) << 2)) * 4;
  }
  __device__ __forceinline__ void load(unsigned char* st, int kt) {
    float* ts = reinterpret_cast<float*>(st);
    const int col0 = kt * KEYS;
    if (by16) {
      const uint32_t sa = smem_u32(st) + dst;
      const bool col_ok = col0 + 4 * (threadIdx.x & 15) < U2;
#pragma unroll
      for (int it = 0; it < ROWS / TROWS; ++it) {
        const bool ok = col_ok && TROWS * it < rows_left;
        cp_async16(sa + it * TROWS * KEYS * 4,
                   ok ? src + col0 + (size_t)it * TROWS * U2 : table, ok);
      }
    } else {
      for (int e = threadIdx.x; e < ROWS * KEYS; e += THREADS) {
        const int r = e >> 6, cl = e & 63;
        const int row = row0 + r, col = col0 + cl;
        const bool ok = row < U1 && col < U2;
        const int c = cl >> 2;
        cp_async4(smem_u32(ts + r * KEYS + ((c ^ ((r & 3) << 1)) << 2) +
                           (cl & 3)),
                  ok ? table + (size_t)row * U2 + col : table, ok);
      }
    }
  }
  __device__ __forceinline__ void add(float (*sc)[4], int,
                                      unsigned char* st, float pos_w) const {
    const float* ts = reinterpret_cast<const float*>(st);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r = (threadIdx.x >> 5) * 16 + g;  // r % 4 == (r + 8) % 4
    const int sw = (r & 3) << 1;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const int off = (((2 * j + (t >> 1)) ^ sw) << 2) + ((t & 1) << 1);
      const float2 b0 = *reinterpret_cast<const float2*>(ts + r * KEYS + off);
      const float2 b1 =
          *reinterpret_cast<const float2*>(ts + (r + 8) * KEYS + off);
      sc[j][0] += pos_w * b0.x;
      sc[j][1] += pos_w * b0.y;
      sc[j][2] += pos_w * b1.x;
      sc[j][3] += pos_w * b1.y;
    }
  }
  // The sweep's form (agg_modes.cuh), whose warps share rows and split the
  // keys: pos_w * the table at tile rows r, r + 8 and keys key0 .. key0 +
  // 8 NT - 1 (key0 % KEYS: where the warpgroup's keys start in the tile),
  // added to NM accumulator sets of one fragment layout.
  template <int NM, int NT>
  __device__ __forceinline__ void add_modes(float (&acc)[NM][NT][4], int r,
                                            int key0, const unsigned char* st,
                                            float pos_w) const {
    const float* ts = reinterpret_cast<const float*>(st);
    const int t = threadIdx.x & 3;
    const int sw = (r & 3) << 1;  // r % 4 == (r + 8) % 4
    const int c0 = (key0 & (KEYS - 1)) >> 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int off = (((c0 + 2 * j + (t >> 1)) ^ sw) << 2) + ((t & 1) << 1);
      const float2 b0 = *reinterpret_cast<const float2*>(ts + r * KEYS + off);
      const float2 b1 =
          *reinterpret_cast<const float2*>(ts + (r + 8) * KEYS + off);
      const float bj[4] = {pos_w * b0.x, pos_w * b0.y, pos_w * b1.x,
                           pos_w * b1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[m][j][e] += bj[e];
    }
  }
};

// The wgmma layout of a tile row of MDP bf16 (K-major: q or k): 128-, 64- or
// 32-byte rows, swizzled as swz<MDP / 8> does.
template <int MDP>
struct KLayout {
  static constexpr uint32_t TYPE = MDP == 64 ? 1 : MDP == 32 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * MDP * 2;  // between 8-row groups
};
