// Quantized execution kernels for Hopper (sm_90a): the int8 GEMM, the
// bf16 x int8 dequant GEMM, and the fused producer + per-row int8
// quantization of a GEMM's input.
//
// magi_qmm_i8 replaces magi_tpu/ops/quant.py quantized_matmul_i8
//   (_qmm_i8_kernel, K6):
//   out[m, n] = bf16(((float)(sum_k x_q[m, k] * w_q[k, n]) * row_scale[m])
//                    * col_scale[n]),
//   x_q [M, K] int8 row-major, w_q [K, N] int8 row-major (the JAX package's
//   weight layout), int32 accumulation (exact), the epilogue in the plain
//   version's f32 multiply order.
// magi_qmm_deq replaces magi_tpu/ops/quant.py quantized_matmul
//   (_qmm_kernel, K7):
//   out[m, n] = bf16((sum_k x[m, k] * w_q[k, n]) * col_scale[n]),
//   x [M, K] bf16, w_q [K, N] int8, f32 accumulation, the scale applied
//   after the sum as the Pallas kernel does (its plain version applies it
//   to the weight first; the two differ by about one bf16 step).
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
//
// What bounds them on the H100.  K6 at the DiT's shapes (M = 1536 to 9216
// tokens, K and N 1024 to 32768) does 2*M*N*K int8 operations on
// M*K + K*N input bytes: the int8 rate (1979 TOP/s) bounds it.  K7 does
// the same count of bf16 operations on 2*M*K + K*N bytes: the bf16 rate
// (989 TFLOP/s) bounds it.  K8 and K8s read a bf16 row and write it (K8s
// half of it) in int8 with one f32 scale: the bytes bound them (3.35 TB/s).
//
// Design.  K6: one block of 8 warps per 128 x 128 output tile, k tiles of
// 64; each warp owns 64 x 32 outputs and runs mma.sync m16n8k32 s8.  The
// operand B of that instruction is k-contiguous while w_q is n-contiguous,
// so each w_q tile is read into registers (16 bytes a thread, a warp on 32
// consecutive k rows) and written to shared memory transposed, [n][k];
// x_q tiles arrive by cp.async.  Both are double-buffered: the next tile's
// loads are in flight while the current one is multiplied.  Rows past M are
// zero-filled and never stored, so M needs no padding.  K7: K6's tile and
// pipeline with k tiles of 32 and mma.sync m16n8k16 bf16.  x tiles arrive
// as bf16 by cp.async; each w_q tile is read into registers as int8 (a
// quarter of the bytes of a bf16 weight), converted to bf16 (exact for
// [-127, 127]) and stored [k][n], which ldmatrix.trans hands to the mma as
// its B operand without a transpose in memory.  K8: one block per row, the
// row staged in shared memory in f32, block reductions for the statistics
// and the row max, then one pass that writes int8 four bytes at a time.
// K8s: one block per row, gate and up read once with 16-byte loads, the
// bf16 product kept in shared memory (32 KB at F = 16384) while the row
// max is reduced, then written in int8 eight bytes at a time: one read of
// the input where the Pallas kernel made two passes over width chunks to
// fit the TPU's 16 MB VMEM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace magi;

// ---- K6 ------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLDS = kBK + 16;  // bytes per shared row: ldmatrix rows hit distinct banks
constexpr int kQmmThreads = 256;

__global__ void __launch_bounds__(kQmmThreads) qmm_i8_kernel(const int8_t* __restrict__ xq,
                                                             const float* __restrict__ rs,
                                                             const int8_t* __restrict__ wq,
                                                             const float* __restrict__ cs,
                                                             __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLDS];  // [m][k]
  __shared__ __align__(16) int8_t sB[2][kBN * kLDS];  // [n][k]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps, 64 x 32 outputs each
  const int wn = (warp & 3) * 32;
  const int nk = (K + kBK - 1) / kBK;

  auto load_a = [&](int kt, int buf) {
    for (int c = tid; c < kBM * (kBK / 16); c += kQmmThreads) {
      const int r = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      const int gm = m0 + r;
      const int gk = kt * kBK + col;
      const bool valid = gm < M && gk < K;
      cp_async16(&sA[buf][r * kLDS + col], xq + (valid ? (long long)gm * K + gk : 0), valid);
    }
    cp_async_commit();
  };

  // w_q tile [kBK][kBN]: chunk c is 16 bytes of row k = c % kBK at column
  // 16 * (c / kBK), so a warp reads 32 consecutive k rows of one column
  // chunk and its transposed byte stores fall in distinct banks
  constexpr int kBChunks = kBK * kBN / 16 / kQmmThreads;
  uint4 breg[kBChunks];
  auto fetch_b = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kQmmThreads;
      const int gk = kt * kBK + c % kBK;
      const int gn = n0 + (c / kBK) * 16;
      breg[i] = gk < K && gn < N ? *reinterpret_cast<const uint4*>(wq + (long long)gk * N + gn)
                                 : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_b = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kQmmThreads;
      const int kk = c % kBK;
      const int nc = (c / kBK) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&breg[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j) sB[buf][(nc + j) * kLDS + kk] = b[j];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  load_a(0, 0);
  fetch_b(0);
  store_b(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, buf ^ 1);
      fetch_b(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = sA[buf];
    const int8_t* B = sB[buf];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], A + (wm + mi * 16 + (lane & 15)) * kLDS + kk + (lane >> 4) * 16);
      uint32_t bf[4][2];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t r[4];
        ldsm_x4(r, B + (wn + n2 * 16 + i + (m >> 1) * 8) * kLDS + kk + (m & 1) * 16);
        bf[2 * n2][0] = r[0];
        bf[2 * n2][1] = r[1];
        bf[2 * n2 + 1][0] = r[2];
        bf[2 * n2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16832_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (kt + 1 < nk) store_b(buf ^ 1);  // its last readers finished before the previous barrier
    __syncthreads();
  }

  // epilogue: ((float)acc * row_scale) * col_scale -> bf16, two columns a store
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int m = m0 + wm + mi * 16 + g + 8 * r2;
      if (m >= M) continue;
      const float rsm = rs[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + t * 2;
        if (n >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * r2]), rsm), cs[n]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * r2 + 1]), rsm), cs[n + 1]);
        *reinterpret_cast<uint32_t*>(out + (long long)m * N + n) = pack_bf16(v0, v1);
      }
    }
  }
}

// ---- K7 ------------------------------------------------------------------

constexpr int kDBK = 32;           // k tile
constexpr int kDLA = kDBK + 8;     // bf16 per shared row of x: ldmatrix rows hit distinct banks
constexpr int kDLB = kBN + 8;      // bf16 per shared row of w

__global__ void __launch_bounds__(kQmmThreads) qmm_deq_kernel(const __nv_bfloat16* __restrict__ x,
                                                              const int8_t* __restrict__ wq,
                                                              const float* __restrict__ cs,
                                                              __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM * kDLA];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 sB[2][kDBK * kDLB];  // [k][n]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps, 64 x 32 outputs each
  const int wn = (warp & 3) * 32;
  const int nk = (K + kDBK - 1) / kDBK;

  auto load_a = [&](int kt, int buf) {
    for (int c = tid; c < kBM * (kDBK / 8); c += kQmmThreads) {
      const int r = c / (kDBK / 8);
      const int col = (c % (kDBK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = kt * kDBK + col;
      const bool valid = gm < M && gk < K;
      cp_async16(&sA[buf][r * kDLA + col], x + (valid ? (long long)gm * K + gk : 0), valid);
    }
    cp_async_commit();
  };

  // w_q tile [kDBK][kBN] int8: one 16-byte chunk a thread, row tid / 8,
  // columns 16 * (tid % 8) .. + 15; converted to bf16 on the way to
  // shared memory
  static_assert(kDBK * kBN / 16 == kQmmThreads, "one w_q chunk per thread");
  const int bk = tid / (kBN / 16);
  const int bn = (tid % (kBN / 16)) * 16;
  uint4 breg;
  auto fetch_b = [&](int kt) {
    const int gk = kt * kDBK + bk;
    breg = gk < K && n0 + bn < N ? *reinterpret_cast<const uint4*>(wq + (long long)gk * N + n0 + bn)
                                 : make_uint4(0, 0, 0, 0);
  };
  auto store_b = [&](int buf) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&breg);
    uint32_t p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = pack_bf16((float)b[2 * j], (float)b[2 * j + 1]);
    uint4* dst = reinterpret_cast<uint4*>(&sB[buf][bk * kDLB + bn]);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  load_a(0, 0);
  fetch_b(0);
  store_b(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, buf ^ 1);
      fetch_b(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* A = sA[buf];
    const __nv_bfloat16* B = sB[buf];
#pragma unroll
    for (int kk = 0; kk < kDBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], A + (wm + mi * 16 + (lane & 15)) * kDLA + kk + (lane >> 4) * 8);
      uint32_t bf[4][2];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t r[4];
        ldsm_x4_trans(r, B + (kk + i + (m & 1) * 8) * kDLB + wn + n2 * 16 + (m >> 1) * 8);
        bf[2 * n2][0] = r[0];
        bf[2 * n2][1] = r[1];
        bf[2 * n2 + 1][0] = r[2];
        bf[2 * n2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (kt + 1 < nk) store_b(buf ^ 1);  // its last readers finished before the previous barrier
    __syncthreads();
  }

  // epilogue: acc * col_scale -> bf16, two columns a store
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int m = m0 + wm + mi * 16 + g + 8 * r2;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + t * 2;
        if (n >= N) continue;
        const float v0 = __fmul_rn(acc[mi][ni][2 * r2], cs[n]);
        const float v1 = __fmul_rn(acc[mi][ni][2 * r2 + 1], cs[n + 1]);
        *reinterpret_cast<uint32_t*>(out + (long long)m * N + n) = pack_bf16(v0, v1);
      }
    }
  }
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

// one block per row of K (K % 4 == 0); LN: x -> bf16(LN(x) * w + b) first
template <bool LN>
__global__ void __launch_bounds__(kRowThreads) rowquant_kernel(const __nv_bfloat16* __restrict__ x,
                                                               const float* __restrict__ w,
                                                               const float* __restrict__ b, int8_t* __restrict__ q,
                                                               float* __restrict__ scale, int K, float eps) {
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
    const float4 t = make_float4(__low2float(a0), __high2float(a0), __low2float(a1), __high2float(a1));
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
      const float4 y = make_float4(ln(t.x, ww.x, bb.x), ln(t.y, ww.y, bb.y), ln(t.z, ww.z, bb.z), ln(t.w, ww.w, bb.w));
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

// one block per row of [gate | up], 2 * F bf16 (F % 8 == 0) -> F int8
__global__ void __launch_bounds__(kRowThreads) swiglu_rowquant_kernel(const __nv_bfloat16* __restrict__ x,
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(gg[j]);
      const float2 uf = __bfloat1622float2(uu[j]);
      // the product of two bf16 values is exact in f32: one rounding, to bf16
      pp[j] = __floats2bfloat162_rn(__fmul_rn(silu_bf16(gf.x), uf.x), __fmul_rn(silu_bf16(gf.y), uf.y));
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

}  // namespace

extern "C" {

// x_q: [M, K] int8; row_scale: [M] f32; w_q: [K, N] int8; col_scale: [N]
// f32; out: [M, N] bf16.  K and N multiples of 16.
int magi_qmm_i8(const void* xq, const float* row_scale, const void* wq, const float* col_scale, void* out, int M,
                int N, int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_i8_kernel<<<grid, kQmmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), row_scale, static_cast<const int8_t*>(wq), col_scale,
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// x: [S, K] bf16; ln_w, ln_b: [K] f32 (ln mode) or null (plain mode);
// q: [S, K] int8; scale: [S] f32.  K a multiple of 4.
int magi_rowquant(const void* x, const float* ln_w, const float* ln_b, void* q, float* scale, long long S, int K,
                  float eps, void* stream) {
  if (S == 0) return 0;
  if (K % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* qq = static_cast<int8_t*>(q);
  cudaError_t err;
  if (ln_w) {
    err = cudaFuncSetAttribute(rowquant_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rowquant_kernel<true><<<(unsigned)S, kRowThreads, smem, st>>>(xx, ln_w, ln_b, qq, scale, K, eps);
  } else {
    err = cudaFuncSetAttribute(rowquant_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rowquant_kernel<false><<<(unsigned)S, kRowThreads, smem, st>>>(xx, nullptr, nullptr, qq, scale, K, eps);
  }
  return (int)cudaGetLastError();
}

// x: [M, K] bf16; w_q: [K, N] int8; col_scale: [N] f32; out: [M, N] bf16.
// K and N multiples of 16.
int magi_qmm_deq(const void* x, const void* wq, const float* col_scale, void* out, int M, int N, int K,
                 void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_deq_kernel<<<grid, kQmmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq), col_scale,
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// x: [S, 2F] bf16 (gate | up); q: [S, F] int8; scale: [S] f32.  F a
// multiple of 8.
int magi_rowquant_swiglu(const void* x, void* q, float* scale, long long S, int F, void* stream) {
  if (S == 0) return 0;
  if (F % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)F * sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(swiglu_rowquant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  swiglu_rowquant_kernel<<<(unsigned)S, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), scale, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
