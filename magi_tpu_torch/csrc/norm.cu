// Row-wise normalisation kernels for Hopper (sm_90a).
//
// magi_kv_norm_rope_pack replaces magi_tpu/ops/attention.py
//   kv_norm_rope_pack (_kv_epilogue_kernel, the bf16 variant): per token
//   and kv head, fp32 LayerNorm of k with (w, b), GPT-NeoX rotary on the
//   first 2*rot dims, bf16 cast; v passes through.  Both are written into
//   the cache / attention layout [2, hk*rep, S, hd] (output head g reads
//   input head g / rep).
// magi_gate_norm_residual replaces magi_tpu/ops/fused_norm.py
//   gate_norm_residual (_kernel):
//   out = bf16(LN_fp32(gate[seg] * x) * (w (+1)) + b + residual).
//
// What bounds them on the H100.  Both are one-pass reductions with a few
// flops per element: the bytes bound them (3.35 TB/s).  Per DiT layer and
// forward, K3 moves 2*S*hk*hd bf16 in and out; K4 reads x and residual and
// writes one [S, 3072] bf16 row per token.
//
// Design.  Every input element is read once and every output element
// written once; the fp32 intermediates stay in registers or shared memory,
// never in device memory.  K3 gives one warp to each (token, head) row of
// hd elements: a warp-shuffle reduction, and a per-warp row in shared
// memory so each lane finds its rotary partner.  K4 gives one block to
// each row of D: the gated row is staged in shared memory in fp32, and the
// mean and variance are two block reductions over it (two-pass variance,
// as the Pallas kernel computes it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxHd = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp per (token, output head) row; EPT = hd / 32 elements per lane
template <int EPT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) kv_norm_rope_pack_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v, const float* __restrict__ kw,
    const float* __restrict__ kb, const float* __restrict__ sin, const float* __restrict__ cos,
    __nv_bfloat16* __restrict__ out, long long S, int hk, int rep, int rot, float eps) {
  constexpr int HD = 32 * EPT;
  __shared__ float rows[kWarpsPerBlock][HD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = hk * rep;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (r >= S * G) return;
  const long long s = r / G;
  const int og = (int)(r % G);
  const int ig = og / rep;

  const __nv_bfloat16* kr = k + (s * hk + ig) * HD;
  const __nv_bfloat16* vr = v + (s * hk + ig) * HD;
  __nv_bfloat16* ok = out + ((long long)og * S + s) * HD;
  __nv_bfloat16* ov = out + ((long long)(G + og) * S + s) * HD;

  float x[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) x[i] = __bfloat162float(kr[lane + 32 * i]);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc += x[i];
  const float mean = warp_sum(acc) / HD;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc += (x[i] - mean) * (x[i] - mean);
  const float rstd = rsqrtf(warp_sum(acc) / HD + eps);
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int d = lane + 32 * i;
    x[i] = (x[i] - mean) * rstd * kw[d] + kb[d];
  }
  if (rot) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) rows[warp][lane + 32 * i] = x[i];
    __syncwarp();
    const float* sn = sin + s * rot;
    const float* cs = cos + s * rot;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int d = lane + 32 * i;
      if (d < rot) {
        x[i] = rows[warp][d] * cs[d] - rows[warp][d + rot] * sn[d];
      } else if (d < 2 * rot) {
        const int e = d - rot;
        x[i] = rows[warp][e] * sn[e] + rows[warp][d] * cs[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    ok[lane + 32 * i] = __float2bfloat16(x[i]);
    ov[lane + 32 * i] = vr[lane + 32 * i];
  }
}

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float t = lane < nw ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();  // red is reused by the next reduction
  return t;
}

// one block per row; 4 elements per vector access (D % 4 == 0)
__global__ void __launch_bounds__(256) gate_norm_residual_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res, const float* __restrict__ gate,
    const float* __restrict__ w, const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int D, int seg_len,
    float eps, float w_offset) {
  extern __shared__ float g[];  // [D] gated row, fp32
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int seg = (int)(row / seg_len);
  const __nv_bfloat16* xr = x + row * D;
  const float* gr = gate + (long long)seg * D;
  const int nv = D / 4;

  float acc = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const uint2 raw = reinterpret_cast<const uint2*>(xr)[i];
    const __nv_bfloat162 a0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 a1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float4 gg = reinterpret_cast<const float4*>(gr)[i];
    const float4 t = make_float4(__low2float(a0) * gg.x, __high2float(a0) * gg.y, __low2float(a1) * gg.z,
                                 __high2float(a1) * gg.w);
    reinterpret_cast<float4*>(g)[i] = t;
    acc += (t.x + t.y) + (t.z + t.w);
  }
  const float mean = block_sum(acc, red) / D;
  acc = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 t = reinterpret_cast<const float4*>(g)[i];
    acc += (t.x - mean) * (t.x - mean) + (t.y - mean) * (t.y - mean) + (t.z - mean) * (t.z - mean) +
           (t.w - mean) * (t.w - mean);
  }
  const float rstd = rsqrtf(block_sum(acc, red) / D + eps);

  const __nv_bfloat16* rr = res + row * D;
  __nv_bfloat16* orow = out + row * D;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const float4 t = reinterpret_cast<const float4*>(g)[i];
    const float4 ww = reinterpret_cast<const float4*>(w)[i];
    const float4 bb = reinterpret_cast<const float4*>(b)[i];
    const uint2 raw = reinterpret_cast<const uint2*>(rr)[i];
    const __nv_bfloat162 r0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 r1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float y0 = (t.x - mean) * rstd * (ww.x + w_offset) + bb.x + __low2float(r0);
    const float y1 = (t.y - mean) * rstd * (ww.y + w_offset) + bb.y + __high2float(r0);
    const float y2 = (t.z - mean) * rstd * (ww.z + w_offset) + bb.z + __low2float(r1);
    const float y3 = (t.w - mean) * rstd * (ww.w + w_offset) + bb.w + __high2float(r1);
    __nv_bfloat162 o0 = __floats2bfloat162_rn(y0, y1);
    __nv_bfloat162 o1 = __floats2bfloat162_rn(y2, y3);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&o0);
    packed.y = *reinterpret_cast<uint32_t*>(&o1);
    reinterpret_cast<uint2*>(orow)[i] = packed;
  }
}

}  // namespace

extern "C" {

// k, v: [S, hk, hd] bf16; kw, kb: [hd] f32; sin, cos: [S, rot] f32 or null
// (rot 0); out: [2, hk*rep, S, hd] bf16
int magi_kv_norm_rope_pack(const void* k, const void* v, const float* kw, const float* kb, const float* sin,
                           const float* cos, void* out, long long S, int hk, int hd, int rep, int rot, float eps,
                           void* stream) {
  if (S == 0) return 0;
  if (hd % 32 || hd > kMaxHd || 2 * rot > hd) return (int)cudaErrorInvalidValue;
  const long long rows = S * hk * rep;
  const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd / 32) {
    case 2:
      kv_norm_rope_pack_kernel<2><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(kk, vv, kw, kb, sin, cos, oo, S, hk, rep,
                                                                        rot, eps);
      break;
    case 4:
      kv_norm_rope_pack_kernel<4><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(kk, vv, kw, kb, sin, cos, oo, S, hk, rep,
                                                                        rot, eps);
      break;
    case 8:
      kv_norm_rope_pack_kernel<8><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(kk, vv, kw, kb, sin, cos, oo, S, hk, rep,
                                                                        rot, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, residual, out: [S, D] bf16; gate: [n_seg, D] f32; w, b: [D] f32
int magi_gate_norm_residual(const void* x, const void* residual, const float* gate, const float* w, const float* b,
                            void* out, long long S, int D, int seg_len, float eps, int zero_centered, void* stream) {
  if (S == 0) return 0;
  if (D % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(gate_norm_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gate_norm_residual_kernel<<<(unsigned)S, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(residual), gate, w, b,
      static_cast<__nv_bfloat16*>(out), D, seg_len, eps, zero_centered ? 1.f : 0.f);
  return (int)cudaGetLastError();
}

}  // extern "C"
