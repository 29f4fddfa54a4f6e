// Quantized execution kernels for Hopper (sm_90a): the int8 GEMM, the
// bf16 x int8 dequant GEMM, and the fused producer + per-row int8
// quantization of a GEMM's input.
//
// magi_qmm_i8 replaces magi_tpu/ops/quant.py quantized_matmul_i8
//   (_qmm_i8_kernel, K6):
//   out[m, n] = bf16(((float)(sum_k x_q[m, k] * w_q[k, n]) * row_scale[m])
//                    * col_scale[n]), or the same f32 product unrounded
//                    (out_f32: a row-parallel linear's partial sums),
//   x_q [M, K] int8 row-major, w_q logically [K, N] int8 as in the JAX
//   package but stored k-major ([N, K] in memory: ops/quant.py makes the
//   weights so), int32 accumulation (exact), the epilogue in the plain
//   version's f32 multiply order, so the kernel gives its bits.
// magi_qmm_deq replaces magi_tpu/ops/quant.py quantized_matmul
//   (_qmm_kernel, K7):
//   out[m, n] = bf16((sum_k x[m, k] * w_q[k, n]) * col_scale[n]), or the
//   same f32 product unrounded (out_f32: a row-parallel linear's partial
//   sums), x [M, K] bf16, w_q k-major int8 as for K6, f32 accumulation, the scale
//   applied after the sum as the Pallas kernel does (its plain version
//   applies it to the weight first; the two differ by about one bf16 step).
// magi_rowquant replaces magi_tpu/ops/act_quant.py rowquant_fused, modes
//   "plain" and "ln" (_rowquant_kernel, K8):
//   plain: q = round(x / s), s = amax == 0 ? 1 : amax / 127 per row;
//   ln:    the same over bf16(LayerNorm(x) * w + b).
//   round is half to even and the quotient a true division, as torch.round
//   and the plain version's x / scale compute them.  The LayerNorm's mean
//   and variance are taken in float64 (two passes): the row sum of bf16
//   inputs is then exact in any order, so the kernel and the plain version
//   give the same bits.
// magi_rowquant_swiglu replaces rowquant_fused(mode="swiglu")
//   (_swiglu_quant_kernel, K8s): the same quantization over
//   p = bf16(bf16(silu(gate)) * up) of a row [gate | up] of 2F bf16, with
//   silu(g) = g / (1 + expf(-g)) in f32 (IEEE division, no fast math: what
//   F.silu computes on CUDA), so the kernel gives its plain version's bits.
// Both take an optional smooth-quant vector as its reciprocal r = 1 / s
//   (a linear whose weight was quantized s·W; the wrapper takes the IEEE
//   reciprocal once a launch): the producer's bf16 value y becomes
//   bf16(y * r[c]) before the row's |max| is taken, one f32 product rounded
//   once, as the plain version (and the JAX package's f32(x) * (1 / s))
//   divides.  A reciprocal per element would make them issue-bound.
//   Without r the kernels are unchanged.
//
// What bounds them on the H100.  K6 at the DiT's shapes (M = 1536 to 9216
// tokens, K and N 1024 to 32768) does 2*M*N*K int8 operations on
// M*K + K*N input bytes: the int8 rate (1979 TOP/s) bounds it, and only
// wgmma reaches that rate.  K7 does the same count of bf16 operations on
// 2*M*K + K*N bytes: the bf16 rate (989 TFLOP/s) bounds it.  K8 and K8s
// read a bf16 row and write it (K8s half of it) in int8 with one f32
// scale: the bytes bound them (3.35 TB/s).
//
// Design of K6 and K7.  A persistent grid, one block per SM, each block
// walking output tiles blockIdx.x, + gridDim.x, ...  A block has three
// warpgroups: one producer thread keeps TMA tile loads
// (cp.async.bulk.tensor, completion on an mbarrier) in flight through a
// ring of shared-memory stages, and two consumer warpgroups, which take the
// registers (setmaxnreg), run wgmma.mma_async on each stage as it lands and
// hand it back on an "empty" mbarrier; while they run a tile's epilogue the
// producer already loads the next tile.  For 8-bit operands wgmma reads
// both from shared memory K-major only, which is why the weights are
// stored k-major: TMA then feeds them to the tensor cores as they are,
// where the mma.sync kernels this replaces transposed every weight tile
// byte by byte on every call.  TMA fills the edges past M, N and K with
// zeros, so no operand needs padding.  Tiles are walked in groups of 8
// along N so that the tiles in work at one time share operands in L2.
// K6: a 128 x 256 output tile (each consumer 64 rows x 256), k tiles of 128
// bytes (4 x wgmma m64n256k32 s8), 4 stages of 48 KB; both tiles with the
// 128-byte swizzle.  The epilogue scales the exact int32 sums as the plain
// version does.
// K7 swaps the operands, out^T = W x^T, as mixed-input GEMMs do: x's 256
// tokens are the B operand straight from the TMA-filled stage, and each
// consumer converts its 64 weight rows of the stage from int8 to bf16
// (exact for [-127, 127]; a byte permute and a subtraction, no I2F) into
// its own double-buffered bf16 tile in shared memory, the A operand of
// wgmma m64n256k16.  Only that 8 KB tile is written; the weight never has
// a bf16 copy in device memory.  (Converting into registers, wgmma's A
// from registers, lets ptxas serialize the products: the next stage's A
// registers are written while the previous stage's products run.)  A tile
// of 128 weight rows x 256 tokens, k tiles of 64 (x with the 128-byte
// swizzle, the int8 weight with the 64-byte one, which keeps the 16-byte
// reads of the conversion free of bank conflicts), 4 stages of 40 KB.  The
// epilogue scales each row of out^T by col_scale[n] and stores it
// transposed.
// K8: one block per row, the row staged in shared memory in f32, block
// reductions for the statistics and the row max, then one pass that
// writes int8 four bytes at a time.  K8s: one block per row, gate and up
// read once with 16-byte loads, the bf16 product kept in shared memory
// (32 KB at F = 16384) while the row max is reduced, then written in int8
// eight bytes at a time: one read of the input where the Pallas kernel
// made two passes over width chunks to fit the TPU's 16 MB VMEM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "ptx.cuh"
#include "tmap.cuh"

namespace {

using namespace magi;

// ---- K6 and K7 -----------------------------------------------------------

constexpr int kGemmThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kGroupN = 8;         // output tiles along N walked together

// K6: 128 x 256 output tiles, k tiles of 128 bytes
constexpr int kI8BM = 128, kI8BN = 256, kI8BK = 128, kI8Stages = 4;
constexpr int kI8ABytes = kI8BM * kI8BK, kI8BBytes = kI8BN * kI8BK;
constexpr int kI8Smem = 1024 + kI8Stages * (kI8ABytes + kI8BBytes) + 2 * kI8Stages * 8;

// K7: 128 weight rows (n) x 256 tokens (m), k tiles of 64; besides the
// ring, each consumer has two bf16 buffers of its 64 weight rows
constexpr int kDqBN = 128, kDqBM = 256, kDqBK = 64, kDqStages = 4;
constexpr int kDqWBytes = kDqBN * kDqBK, kDqXBytes = kDqBM * kDqBK * 2, kDqABytes = 64 * kDqBK * 2;
constexpr int kDqSmem = 1024 + kDqStages * (kDqWBytes + kDqXBytes) + 4 * kDqABytes + 2 * kDqStages * 8;

// output tile t: groups of kGroupN tiles along N, and within a group N
// fastest, so the blocks working at one time share x and weight tiles in L2
__device__ __forceinline__ void tile_of(int t, int num_m, int num_n, int& mt, int& nt) {
  const int per_group = kGroupN * num_m;
  const int first_n = (t / per_group) * kGroupN;
  const int gsize = min(num_n - first_n, kGroupN);
  const int r = t % per_group;
  nt = first_n + r % gsize;
  mt = r / gsize;
}

// the ring's barriers: full[s] completes when stage s has landed (the
// producer's expect_tx plus the bytes), empty[s] when the 8 consumer warps
// are done with it
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// a position in the ring: the stage and the parity of its current round
template <int S>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's loop, one thread: for each output tile of this block
// (a persistent grid walks tile blockIdx.x, + gridDim.x, ...) and each k
// tile, wait for the stage to be handed back and load both operand tiles
// into it.  `load(stage, bar, kt, m0, n0)` issues the TMA copies.
template <int S, typename Load>
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty, int tiles, int num_m, int num_n, int bm,
                                        int bn, int nk, uint32_t tx_bytes, Load load) {
  RingPos<S> pos;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int mt, nt;
    tile_of(t, num_m, num_n, mt, nt);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[pos.stage], pos.phase ^ 1);
      mbar_arrive_expect_tx(&full[pos.stage], tx_bytes);
      load(pos.stage, &full[pos.stage], kt, mt * bm, nt * bn);
      pos.next();
    }
  }
}

// OutT: __nv_bfloat16, or float for the f32 partial sums of a row-parallel
// (tensor-parallel) linear, which are summed across ranks before the cast
template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    qmm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                        const float* __restrict__ rs, const float* __restrict__ cs, OutT* __restrict__ out,
                        int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align1024(smem_raw);        // [stage][128 rows of x_q][128 B]
  uint8_t* sB = sA + kI8Stages * kI8ABytes;  // [stage][256 rows of w_q^T][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kI8Stages * kI8BBytes);
  uint64_t* empty = full + kI8Stages;
  const int wg = threadIdx.x / 128;
  const int num_m = (M + kI8BM - 1) / kI8BM, num_n = (N + kI8BN - 1) / kI8BN, tiles = num_m * num_n;
  const int nk = (K + kI8BK - 1) / kI8BK;
  init_ring(full, empty, kI8Stages);

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tx);
      tma_prefetch_desc(&tw);
      produce<kI8Stages>(full, empty, tiles, num_m, num_n, kI8BM, kI8BN, nk, kI8ABytes + kI8BBytes,
                         [&](int s, uint64_t* bar, int kt, int m0, int n0) {
                           tma_load_2d(sA + s * kI8ABytes, &tx, bar, kt * kI8BK, m0);
                           tma_load_2d(sB + s * kI8BBytes, &tw, bar, kt * kI8BK, n0);
                         });
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
    RingPos<kI8Stages> pos;
    int acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_of(t, num_m, num_n, mt, nt);
      const int m0 = mt * kI8BM, n0 = nt * kI8BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[pos.stage], pos.phase);
        const uint64_t da = wgmma_desc_sw128(sA + pos.stage * kI8ABytes + wg * 64 * kI8BK);
        const uint64_t db = wgmma_desc_sw128(sB + pos.stage * kI8BBytes);
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kI8BK / 32; ++kk) wgmma_s8_m64n256k32(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_hold(acc);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = pos.stage;
        pos.next();
      }
      wgmma_wait<0>();
      wgmma_hold(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);  // the producer loads the next tile meanwhile

      // epilogue: ((float)acc * row_scale) * col_scale -> OutT, two columns a store
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wg * 64 + warp * 16 + g + 8 * i;
        if (m >= M) continue;
        const float rsm = rs[m];
        OutT* orow = out + (long long)m * N;
#pragma unroll
        for (int j = 0; j < kI8BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n >= N) continue;
          const float2 c = *reinterpret_cast<const float2*>(cs + n);
          const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), rsm), c.x);
          const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), rsm), c.y);
          if constexpr (sizeof(OutT) == 4)
            *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// OutT: __nv_bfloat16, or float for a row-parallel linear's partial sums (as K6)
template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    qmm_deq_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const float* __restrict__ cs, OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sW = align1024(smem_raw);        // [stage][128 weight rows][64 B], 64-byte swizzle
  uint8_t* sX = sW + kDqStages * kDqWBytes;  // [stage][256 tokens][64 bf16], 128-byte swizzle
  uint8_t* sA = sX + kDqStages * kDqXBytes;  // [consumer][buffer][64 weight rows][64 bf16], 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(sA + 4 * kDqABytes);
  uint64_t* empty = full + kDqStages;
  const int wg = threadIdx.x / 128;
  const int num_m = (M + kDqBM - 1) / kDqBM, num_n = (N + kDqBN - 1) / kDqBN, tiles = num_m * num_n;
  const int nk = (K + kDqBK - 1) / kDqBK;
  init_ring(full, empty, kDqStages);

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tx);
      tma_prefetch_desc(&tw);
      produce<kDqStages>(full, empty, tiles, num_m, num_n, kDqBM, kDqBN, nk, kDqWBytes + kDqXBytes,
                         [&](int s, uint64_t* bar, int kt, int m0, int n0) {
                           tma_load_2d(sW + s * kDqWBytes, &tw, bar, kt * kDqBK, n0);
                           tma_load_2d(sX + s * kDqXBytes, &tx, bar, kt * kDqBK, m0);
                         });
    }
  } else {
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
    uint8_t* a_buf = sA + wg * 2 * kDqABytes;
    RingPos<kDqStages> pos;
    int buf = 0;
    float acc[128];

    // this consumer's 64 weight rows of stage s, int8 -> bf16 into a_buf[b]
    // (exact); thread tid converts 16-byte chunks tid and tid + 128: row
    // c / 4, k 16 (c % 4) .. + 15.  The int8 tile has the 64-byte swizzle
    // (16-byte chunk j of row r at j ^ (r / 2) % 4), the bf16 one the
    // 128-byte swizzle (chunk j at j ^ r % 8) that wgmma reads
    auto convert = [&](int s, int b) {
      const uint8_t* w = sW + s * kDqWBytes + wg * 64 * kDqBK;
      uint8_t* a = a_buf + b * kDqABytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tid + 128 * h, r = c >> 2, j = c & 3;
        const uint4 v = *reinterpret_cast<const uint4*>(w + r * kDqBK + ((j ^ ((r >> 1) & 3)) << 4));
        const uint4 lo = make_uint4(i8x2_to_bf16x2(v.x), i8x2_to_bf16x2(v.x >> 16), i8x2_to_bf16x2(v.y),
                                    i8x2_to_bf16x2(v.y >> 16));
        const uint4 hi = make_uint4(i8x2_to_bf16x2(v.z), i8x2_to_bf16x2(v.z >> 16), i8x2_to_bf16x2(v.w),
                                    i8x2_to_bf16x2(v.w >> 16));
        *reinterpret_cast<uint4*>(a + r * 128 + (((2 * j) ^ (r & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(a + r * 128 + (((2 * j + 1) ^ (r & 7)) << 4)) = hi;
      }
      // the generic-proxy writes, visible to wgmma's async proxy, from the
      // whole warpgroup, before any of its warps issues the products
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_of(t, num_m, num_n, mt, nt);
      const int m0 = mt * kDqBM, n0 = nt * kDqBN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[pos.stage], pos.phase);
        // a_buf[buf] was last read by the products of two stages ago,
        // retired by the previous stage's wait
        convert(pos.stage, buf);
        const uint64_t da = wgmma_desc_sw128(a_buf + buf * kDqABytes);
        const uint64_t db = wgmma_desc_sw128(sX + pos.stage * kDqXBytes);
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_bf16_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_hold(acc);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = pos.stage;
        pos.next();
        buf ^= 1;
      }
      wgmma_wait<0>();
      wgmma_hold(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);  // the producer loads the next tile meanwhile

      // epilogue: row n of out^T times col_scale[n] -> OutT, stored as out[m, n]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + wg * 64 + warp * 16 + g + 8 * i;
        if (n >= N) continue;
        const float c = cs[n];
#pragma unroll
        for (int j = 0; j < kDqBM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * q + e;
            if (m >= M) continue;
            const float v = __fmul_rn(acc[4 * j + 2 * i + e], c);
            if constexpr (sizeof(OutT) == 4)
              out[(long long)m * N + n] = v;
            else
              out[(long long)m * N + n] = __float2bfloat16_rn(v);
          }
      }
    }
  }
}

// ---- host side: tensor maps ----------------------------------------------

// The tensor map of a row-major [rows, cols] matrix cut in boxes of
// [box_rows, box_cols].  A map is a pure function of these arguments, so
// it is cached by them: a weight's map (and, with PyTorch's caching
// allocator, most activations') is encoded once, not on every launch.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt, int elem_bytes, long long rows,
                       long long cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  using Key = std::array<unsigned long long, 7>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key{(unsigned long long)ptr, (unsigned long long)rows, (unsigned long long)cols, (unsigned long long)dt,
                (unsigned long long)box_rows, (unsigned long long)box_cols, (unsigned long long)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// Before a kernel's first launch on a device: allow it `bytes` of dynamic
// shared memory.  Returns the device's SM count, the persistent grid's
// size, in `sms`.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes, int (&sm_count)[64], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sm_count[dev]) {
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) sm_count[dev] = *sms;
  return err;
}

// ---- K8 ------------------------------------------------------------------

constexpr int kRowThreads = 256;

template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T t = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = op(t, __shfl_xor_sync(0xffffffffu, t, o));
  __syncthreads();  // red is reused by the next reduction
  return t;
}

struct DAdd {
  __device__ double operator()(double a, double b) const { return __dadd_rn(a, b); }
};
struct FMax {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// bf16(y * r), r = 1 / s: a smooth-quant linear's input divided by its s
__device__ __forceinline__ float smooth_bf16(float y, float r) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(y, r)));
}

__device__ __forceinline__ float4 smooth_bf16(float4 y, float4 r) {
  return make_float4(smooth_bf16(y.x, r.x), smooth_bf16(y.y, r.y), smooth_bf16(y.z, r.z), smooth_bf16(y.w, r.w));
}

// one block per row of K (K % 4 == 0); LN: x -> bf16(LN(x) * w + b) first;
// SMOOTH: then -> bf16(y * inv_smooth[c])
template <bool LN, bool SMOOTH>
__global__ void __launch_bounds__(kRowThreads) rowquant_kernel(const __nv_bfloat16* __restrict__ x,
                                                               const float* __restrict__ w,
                                                               const float* __restrict__ b,
                                                               const float* __restrict__ inv_smooth,
                                                               int8_t* __restrict__ q, float* __restrict__ scale,
                                                               int K, float eps) {
  extern __shared__ float4 row4[];  // [K / 4] the row in f32 (LN: its bf16-rounded output)
  __shared__ double redd[32];
  __shared__ float redf[32];
  const long long r = blockIdx.x;
  const int nv = K / 4;
  const uint2* xr = reinterpret_cast<const uint2*>(x + r * K);

  double sum = 0.0;
  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += kRowThreads) {
    const uint2 raw = xr[i];
    const __nv_bfloat162 a0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 a1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    float4 t = make_float4(__low2float(a0), __high2float(a0), __low2float(a1), __high2float(a1));
    if (SMOOTH && !LN) t = smooth_bf16(t, reinterpret_cast<const float4*>(inv_smooth)[i]);
    row4[i] = t;
    if (LN) {
      sum = __dadd_rn(__dadd_rn(sum, (double)t.x), __dadd_rn((double)t.y, __dadd_rn((double)t.z, (double)t.w)));
    } else {
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)), fmaxf(fabsf(t.z), fabsf(t.w))));
    }
  }
  if (LN) {
    const double mean_d = block_reduce(sum, redd, DAdd()) / K;
    double var = 0.0;
    for (int i = threadIdx.x; i < nv; i += kRowThreads) {
      const float4 t = row4[i];
      const double d0 = (double)t.x - mean_d, d1 = (double)t.y - mean_d;
      const double d2 = (double)t.z - mean_d, d3 = (double)t.w - mean_d;
      var = __dadd_rn(var, __dadd_rn(__dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)),
                                     __dadd_rn(__dmul_rn(d2, d2), __dmul_rn(d3, d3))));
    }
    const double var_d = block_reduce(var, redd, DAdd()) / K;
    const float rstd = (float)(1.0 / sqrt(var_d + (double)eps));
    const float mean = (float)mean_d;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = threadIdx.x; i < nv; i += kRowThreads) {
      const float4 t = row4[i], ww = w4[i], bb = b4[i];
      auto ln = [&](float v, float wv, float bv) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), wv), bv);
        return __bfloat162float(__float2bfloat16_rn(y));
      };
      float4 y = make_float4(ln(t.x, ww.x, bb.x), ln(t.y, ww.y, bb.y), ln(t.z, ww.z, bb.z), ln(t.w, ww.w, bb.w));
      if (SMOOTH) y = smooth_bf16(y, reinterpret_cast<const float4*>(inv_smooth)[i]);
      row4[i] = y;
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w))));
    }
  }
  amax = block_reduce(amax, redf, FMax());
  const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + r * K);
  for (int i = threadIdx.x; i < nv; i += kRowThreads) {
    const float4 t = row4[i];
    const uint32_t b0 = (uint8_t)(int8_t)quant_div(t.x, s), b1 = (uint8_t)(int8_t)quant_div(t.y, s);
    const uint32_t b2 = (uint8_t)(int8_t)quant_div(t.z, s), b3 = (uint8_t)(int8_t)quant_div(t.w, s);
    qr[i] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  }
  if (threadIdx.x == 0) scale[r] = s;
}

// ---- K8s -----------------------------------------------------------------

// bf16(silu(g)) with silu(g) = g / (1 + expf(-g)) in f32, as F.silu
__device__ __forceinline__ float silu_bf16(float g) {
  return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g)))));
}

// one block per row of [gate | up], 2 * F bf16 (F % 8 == 0) -> F int8;
// SMOOTH: the product p -> bf16(p * inv_smooth[c])
template <bool SMOOTH>
__global__ void __launch_bounds__(kRowThreads) swiglu_rowquant_kernel(const __nv_bfloat16* __restrict__ x,
                                                                      const float* __restrict__ inv_smooth,
                                                                      int8_t* __restrict__ q,
                                                                      float* __restrict__ scale, int F) {
  extern __shared__ uint4 prow[];  // [F / 8] the bf16 product, eight to a chunk
  __shared__ float redf[32];
  const long long r = blockIdx.x;
  const int nv = F / 8;
  const uint4* g8 = reinterpret_cast<const uint4*>(x + r * 2 * F);
  const uint4* u8 = g8 + nv;

  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += kRowThreads) {
    const uint4 graw = g8[i], uraw = u8[i];
    const __nv_bfloat162* gg = reinterpret_cast<const __nv_bfloat162*>(&graw);
    const __nv_bfloat162* uu = reinterpret_cast<const __nv_bfloat162*>(&uraw);
    uint4 praw;
    __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&praw);
    float4 sv[2];
    if (SMOOTH) {
      sv[0] = reinterpret_cast<const float4*>(inv_smooth)[2 * i];
      sv[1] = reinterpret_cast<const float4*>(inv_smooth)[2 * i + 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(gg[j]);
      const float2 uf = __bfloat1622float2(uu[j]);
      // the product of two bf16 values is exact in f32: one rounding, to bf16
      pp[j] = __floats2bfloat162_rn(__fmul_rn(silu_bf16(gf.x), uf.x), __fmul_rn(silu_bf16(gf.y), uf.y));
      if (SMOOTH) {
        const float4 s4 = sv[j >> 1];
        const float2 pf = __bfloat1622float2(pp[j]);
        pp[j] = __floats2bfloat162_rn(smooth_bf16(pf.x, j & 1 ? s4.z : s4.x),
                                      smooth_bf16(pf.y, j & 1 ? s4.w : s4.y));
      }
      const float2 pf = __bfloat1622float2(pp[j]);
      amax = fmaxf(amax, fmaxf(fabsf(pf.x), fabsf(pf.y)));
    }
    prow[i] = praw;
  }
  amax = block_reduce(amax, redf, FMax());
  const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  uint2* qr = reinterpret_cast<uint2*>(q + r * F);
  for (int i = threadIdx.x; i < nv; i += kRowThreads) {
    const uint4 praw = prow[i];
    const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&praw);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 pf = __bfloat1622float2(pp[j]);
      const uint32_t b0 = (uint8_t)(int8_t)quant_div(pf.x, s), b1 = (uint8_t)(int8_t)quant_div(pf.y, s);
      w[j >> 1] |= (b0 | (b1 << 8)) << (16 * (j & 1));
    }
    qr[i] = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) scale[r] = s;
}

template <bool LN, bool SMOOTH>
cudaError_t launch_rowquant(const __nv_bfloat16* x, const float* ln_w, const float* ln_b, const float* inv_smooth,
                            int8_t* q, float* scale, long long S, int K, float eps, cudaStream_t st) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(rowquant_kernel<LN, SMOOTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rowquant_kernel<LN, SMOOTH><<<(unsigned)S, kRowThreads, smem, st>>>(x, ln_w, ln_b, inv_smooth, q, scale, K, eps);
  return cudaGetLastError();
}

template <bool SMOOTH>
cudaError_t launch_swiglu(const __nv_bfloat16* x, const float* inv_smooth, int8_t* q, float* scale, long long S,
                          int F, cudaStream_t st) {
  const size_t smem = (size_t)F * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(swiglu_rowquant_kernel<SMOOTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  swiglu_rowquant_kernel<SMOOTH><<<(unsigned)S, kRowThreads, smem, st>>>(x, inv_smooth, q, scale, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_q: [M, K] int8; row_scale: [M] f32; w_q: the weight [K, N] int8 stored
// k-major, [N, K] in memory; col_scale: [N] f32; out: [M, N] bf16, or f32
// when out_f32.  K and N multiples of 16, every pointer 16-byte aligned.
int magi_qmm_i8(const void* xq, const float* row_scale, const void* wq, const float* col_scale, void* out, int M,
                int N, int K, int out_f32, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  static int sm_bf16[64], sm_f32[64];
  int sms = 0;
  CUtensorMap tx, tw;
  cudaError_t err = tensor_map(&tx, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kI8BM, kI8BK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&tw, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kI8BN, kI8BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = out_f32 ? prepare(qmm_i8_wgmma_kernel<float>, kI8Smem, sm_f32, &sms)
                  : prepare(qmm_i8_wgmma_kernel<__nv_bfloat16>, kI8Smem, sm_bf16, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + kI8BM - 1) / kI8BM) * ((N + kI8BN - 1) / kI8BN);
  const int grid = std::min(tiles, sms);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    qmm_i8_wgmma_kernel<float><<<grid, kGemmThreads, kI8Smem, st>>>(tx, tw, row_scale, col_scale,
                                                                     static_cast<float*>(out), M, N, K);
  else
    qmm_i8_wgmma_kernel<__nv_bfloat16><<<grid, kGemmThreads, kI8Smem, st>>>(
        tx, tw, row_scale, col_scale, static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// x: [S, K] bf16; ln_w, ln_b: [K] f32 (ln mode) or null (plain mode);
// inv_smooth: [K] f32, 1 / s, or null; q: [S, K] int8; scale: [S] f32.  K a
// multiple of 4.
int magi_rowquant(const void* x, const float* ln_w, const float* ln_b, const float* inv_smooth, void* q,
                  float* scale, long long S, int K, float eps, void* stream) {
  if (S == 0) return 0;
  if (K % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* qq = static_cast<int8_t*>(q);
  cudaError_t err;
  if (ln_w)
    err = inv_smooth ? launch_rowquant<true, true>(xx, ln_w, ln_b, inv_smooth, qq, scale, S, K, eps, st)
                     : launch_rowquant<true, false>(xx, ln_w, ln_b, nullptr, qq, scale, S, K, eps, st);
  else
    err = inv_smooth ? launch_rowquant<false, true>(xx, nullptr, nullptr, inv_smooth, qq, scale, S, K, eps, st)
                     : launch_rowquant<false, false>(xx, nullptr, nullptr, nullptr, qq, scale, S, K, eps, st);
  return (int)err;
}

// x: [M, K] bf16; w_q: the weight [K, N] int8 stored k-major, [N, K] in
// memory; col_scale: [N] f32; out: [M, N] bf16, or f32 when out_f32.  K
// and N multiples of 16, every pointer 16-byte aligned.
int magi_qmm_deq(const void* x, const void* wq, const float* col_scale, void* out, int M, int N, int K, int out_f32,
                 void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  static int sm_bf16[64], sm_f32[64];
  int sms = 0;
  CUtensorMap tx, tw;
  cudaError_t err = tensor_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kDqBM, kDqBK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&tw, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kDqBN, kDqBK, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = out_f32 ? prepare(qmm_deq_wgmma_kernel<float>, kDqSmem, sm_f32, &sms)
                  : prepare(qmm_deq_wgmma_kernel<__nv_bfloat16>, kDqSmem, sm_bf16, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((M + kDqBM - 1) / kDqBM) * ((N + kDqBN - 1) / kDqBN);
  const int grid = std::min(tiles, sms);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    qmm_deq_wgmma_kernel<float><<<grid, kGemmThreads, kDqSmem, st>>>(tx, tw, col_scale, static_cast<float*>(out),
                                                                      M, N, K);
  else
    qmm_deq_wgmma_kernel<__nv_bfloat16><<<grid, kGemmThreads, kDqSmem, st>>>(
        tx, tw, col_scale, static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// x: [S, 2F] bf16 (gate | up); inv_smooth: [F] f32, 1 / s, or null; q:
// [S, F] int8; scale: [S] f32.  F a multiple of 8.
int magi_rowquant_swiglu(const void* x, const float* inv_smooth, void* q, float* scale, long long S, int F,
                         void* stream) {
  if (S == 0) return 0;
  if (F % 8) return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* qq = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(inv_smooth ? launch_swiglu<true>(xx, inv_smooth, qq, scale, S, F, st)
                          : launch_swiglu<false>(xx, nullptr, qq, scale, S, F, st));
}

}  // extern "C"
