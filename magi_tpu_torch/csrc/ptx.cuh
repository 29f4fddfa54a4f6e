// PTX helpers shared by the port's kernels (sm_90a): warp reductions, and
// Hopper's mbarriers, TMA tile loads and stores, named barriers and
// warpgroup products (wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace magi {

// Per-phase clocks of the attention kernels, compiled in only with
// -DMAGI_PHASE_CLOCKS (scripts/time_k5.py --phases builds such a copy):
// lane 0 of a warp adds the clocks of phase i to the block's s_phase[i]
// (PHASE_END; PHASE_COUNT adds 1), which the block adds to this source's
// g_phase[i] as it ends (PHASE_FLUSH); each source's C entry reads and
// clears them.  The code around them names its lane `lane`.
#ifdef MAGI_PHASE_CLOCKS
static __device__ unsigned long long g_phase[9];
#define PHASE_SETUP                           \
  __shared__ unsigned long long s_phase[9]; \
  if (threadIdx.x < 9) s_phase[threadIdx.x] = 0
#define PHASE_START(t) long long t = clock64()
#define PHASE_END(i, t)                                                        \
  do {                                                                         \
    const long long now_ = clock64();                                          \
    if (lane == 0) atomicAdd(&s_phase[i], (unsigned long long)(now_ - (t))); \
    t = now_;                                                                  \
  } while (0)
#define PHASE_COUNT(i) \
  if (lane == 0) atomicAdd(&s_phase[i], 1ull)
#define PHASE_FLUSH \
  __syncthreads();  \
  if (threadIdx.x < 9) atomicAdd(&g_phase[threadIdx.x], s_phase[threadIdx.x])
#else
#define PHASE_SETUP
#define PHASE_START(t)
#define PHASE_END(i, t)
#define PHASE_COUNT(i)
#define PHASE_FLUSH
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned shared-memory address at or after p (the
// 128-byte swizzle repeats every 1024 bytes)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---- Hopper: mbarriers, TMA, wgmma ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the phase of the given parity has completed (a fresh barrier
// counts its phase before the first as completed: parity 1 passes at once);
// a phase that never completes traps after about 2**30 tries instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D tile of a tensor map (innermost coordinate first) into shared memory,
// completion counted in bytes on `bar`; elements outside the tensor arrive
// as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// 4-D tile (innermost coordinate first), as tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// 3-D tile (innermost coordinate first), as tma_load_2d
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// 4-D tile from shared memory to the tensor (innermost coordinate first),
// in this thread's current bulk group; elements outside the tensor are not
// written.  The writes to `src` must be fenced for the async proxy first.
__device__ __forceinline__ void tma_store_4d(const void* tmap, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tmap)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

__device__ __forceinline__ void bulk_commit_group() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// until at most N of this thread's bulk groups are pending: _read, until
// their sources may be overwritten; otherwise, until their writes are done
template <int N>
__device__ __forceinline__ void bulk_wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_group() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tmap)) : "memory");
}

// wgmma descriptor of a K-major tile whose rows are 128 bytes, written by
// TMA with the 128-byte swizzle: 8-row groups 1024 bytes apart (the tile
// 1024-byte aligned); a step of 32 bytes along k adds 2 to the address field
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of a K-major tile whose rows are 64 bytes, written with
// the 64-byte swizzle (16-byte chunk c of row r at c ^ (r / 2) % 4): 8-row
// groups 512 bytes apart (the tile 512-byte aligned); a step of 32 bytes
// along k adds 2 to the address field
__device__ __forceinline__ uint64_t wgmma_desc_sw64(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// wgmma descriptor of an MN-major tile (the B operand read transposed) of
// 16-bit elements written with the 128-byte swizzle: rows of 64 elements
// (128 bytes) along N, 8-row groups along K 1024 bytes apart, and the next
// 64 elements along N `atom_stride` bytes on
__device__ __forceinline__ uint64_t wgmma_desc_mn_sw128(const void* p, uint32_t atom_stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((atom_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the async proxy (TMA, wgmma) sees this thread's earlier shared-memory writes
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive on named barrier `id` (of `count` threads) without waiting for it
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void wgmma_hold(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void wgmma_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MAGI_WG8(C, d, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define MAGI_WG32(C, d, i) MAGI_WG8(C, d, i), MAGI_WG8(C, d, i + 8), MAGI_WG8(C, d, i + 16), MAGI_WG8(C, d, i + 24)
#define MAGI_WG128(C, d) MAGI_WG32(C, d, 0), MAGI_WG32(C, d, 32), MAGI_WG32(C, d, 64), MAGI_WG32(C, d, 96)
#define MAGI_RW(x) "+r"(x)
#define MAGI_FW(x) "+f"(x)
#define MAGI_RO(x) "=r"(x)
#define MAGI_FO(x) "=f"(x)
#define MAGI_D32                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MAGI_D64                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define MAGI_D128                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                   \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                   \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "       \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// D[64 x 256] (s32) += A[64 x 32] * B[256 x 32]^T, both int8 K-major in
// shared memory; thread t of the warpgroup holds rows 16 * (t / 32) +
// (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + c in d[4 j + 2 i + c]
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " MAGI_D128 ", %128, %129, p;\n}\n"
      : MAGI_WG128(MAGI_RW, d)
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] (f32) += A[64 x 16] * B[256 x 16]^T, both bf16 K-major in
// shared memory; d laid out as above
__device__ __forceinline__ void wgmma_bf16_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MAGI_D128 ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MAGI_WG128(MAGI_FW, d)
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] (f32) = A[64 x 16] * B[64 x 16]^T (+ D if ACC), both bf16
// K-major in shared memory; d laid out as above (j < 8).  Without ACC, d
// is written only: its old values are not an input the compiler must keep
template <bool ACC>
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MAGI_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MAGI_WG32(MAGI_FW, d, 0)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MAGI_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MAGI_WG32(MAGI_FO, d, 0)
        : "l"(da), "l"(db), "r"(0));
  }
}

// D[64 x 128] (f32) = A[64 x 16] * B[128 x 16]^T (+ D if ACC), both bf16
// K-major in shared memory; d laid out as above (j < 16)
template <bool ACC>
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAGI_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MAGI_WG32(MAGI_FW, d, 0), MAGI_WG32(MAGI_FW, d, 32)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAGI_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MAGI_WG32(MAGI_FO, d, 0), MAGI_WG32(MAGI_FO, d, 32)
        : "l"(da), "l"(db), "r"(0));
  }
}

// D[64 x 64] (s32) = A[64 x 32] * B[64 x 32]^T (+ D if ACC), both int8
// K-major in shared memory; d as above
template <bool ACC>
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MAGI_D32 ", %32, %33, p;\n}\n"
        : MAGI_WG32(MAGI_RW, d, 0)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MAGI_D32 ", %32, %33, p;\n}\n"
        : MAGI_WG32(MAGI_RO, d, 0)
        : "l"(da), "l"(db), "r"(0));
  }
}

// D[64 x 128] (f32) += A[64 x 16] * B[16 x 128], A bf16 from registers (the
// layout of mma.sync's m16n8k16 A fragment, warp w of the warpgroup holding
// rows 16 w ..), B bf16 MN-major in shared memory (transposed read)
__device__ __forceinline__ void wgmma_bf16_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MAGI_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MAGI_WG32(MAGI_FW, d, 0), MAGI_WG32(MAGI_FW, d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (f32) += A[64 x 16] * B[16 x 64], A bf16 from registers (as
// wgmma_bf16_m64n128k16_rs), B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_bf16_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MAGI_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MAGI_WG32(MAGI_FW, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (s32) = A[64 x 32] * B[64 x 32]^T (+ D if ACC), A int8 from
// registers (the layout of mma.sync's m16n8k32 A fragment, warp w of the
// warpgroup holding rows 16 w ..: register e holds row (lane / 4) + 8 (e %
// 2), k indices 16 (e / 2) + 4 (lane % 4) .. + 3, lowest byte first), B
// int8 K-major in shared memory; d as above
template <bool ACC>
__device__ __forceinline__ void wgmma_s8_m64n64k32_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MAGI_D32 ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : MAGI_WG32(MAGI_RW, d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MAGI_D32 ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : MAGI_WG32(MAGI_RO, d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  }
}

// the calling warpgroup's registers per thread, lowered to or raised to N
// (a multiple of 8); registers move within the block's own allocation
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two int8 (the low 16 bits of v, lower k first) -> bf16x2, exact: the
// biased byte becomes the low mantissa bits of 2**23 + byte in f32
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t v) {
  const uint32_t u = v ^ 0x8080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)), 8388736.f);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), 8388736.f);
  return pack_bf16(f0, f1);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// symmetric int8 of x * r (IEEE product, round half to even, clipped to
// [-127, 127]), as the plain versions' torch.round(...).clamp(-127, 127)
__device__ __forceinline__ int quant_mul(float x, float r) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(x, r)), -127.f), 127.f);
}

// the same with a true IEEE quotient x / s
__device__ __forceinline__ int quant_div(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

}  // namespace magi
