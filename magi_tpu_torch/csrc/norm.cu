// Row-wise normalisation kernels for Hopper (sm_90a).
//
// magi_kv_norm_rope_pack replaces magi_tpu/ops/attention.py
//   kv_norm_rope_pack (_kv_epilogue_kernel, the bf16 variant, K3): per token
//   and kv head, fp32 LayerNorm of k with (w, b), GPT-NeoX rotary on the
//   first 2*rot dims, bf16 cast; v passes through.  Both are written into
//   the cache / attention layout [2, hk*rep, S, hd] (output head g reads
//   input head g / rep).
// magi_kv_norm_rope_pack_q8 replaces the int8 branch of the same kernel
//   (kv_norm_rope_pack(quantize=True), K3q): the same k row, then per-token
//   symmetric int8 of k from the fp32 normed, roped row (not its bf16
//   round) and of v, scale max(amax, 1e-8) * (1/127) and quotient x * (1 /
//   scale), as the Pallas kernel computes them.  Writes int8 [2, hk*rep,
//   S, hd] and f32 scales [2, hk*rep, S]: the int8-stored KV cache's layout.
// magi_gate_norm_residual replaces magi_tpu/ops/fused_norm.py
//   gate_norm_residual (_kernel):
//   out = bf16(LN_fp32(gate[seg] * x) * (w (+1)) + b + residual).
//
// What bounds them on the H100.  All are one-pass reductions with a few
// flops per element: the bytes bound them (3.35 TB/s).  Per DiT layer and
// forward, K3 reads k and v (2*S*hk*hd bf16) and sin, cos (2*S*rot f32)
// and writes 2*S*hk*rep*hd bf16; K3q writes that in int8 plus 2*S*hk*rep
// f32 scales.  K4 reads x and residual and writes one [S, 3072] bf16 row
// per token.  K3q does about twice K3's instructions a row (the int8
// maxima, two reciprocals, the rounding and packing), so it is as much
// bound by the SM's issue rate as by the bytes, unless loads stay in
// flight while it computes.
//
// Design of K3 and K3q (one template, kv_norm_rope_pack_kernel).  To
// stream at the memory's rate an SM needs some 30 KB of loads in flight,
// and every byte has to move in full 32-byte sectors.
// - A block of 256 threads owns a tile of T consecutive tokens x all hk
//   input heads: the tile's k and v rows are one contiguous run of memory
//   each, and each output head's part of the tile is one contiguous run of
//   T*hd values (and T consecutive scales).  The tile is 32 rows at hd
//   128: T = 4 tokens at hk 8, so phase 2's S = 7680 gives 1920 blocks for
//   the 4 to 6 an SM holds, and a short tail.
// - hd/8 lanes own a row, 8 consecutive values a lane: 16-byte loads of k
//   and v, one 16-byte bf16 (K3) or 8-byte int8 (K3q) store a lane and
//   output head.  The LayerNorm sums and the int8 maxima are xor shuffles
//   inside the lane group.  The rotary partner d -+ rot sits rot/8 lanes
//   away when rot % 8 == 0 (one shuffle a value); other widths go through
//   a row in shared memory.
// - Each lane issues the loads of a pass's rows, k and v, before the
//   first reduction: K3 two rows (64 bytes a lane in flight) at 64
//   registers, 4 blocks an SM; K3q one row at 40 registers and 6 blocks
//   an SM, so more warps hide its longer arithmetic.  sin and cos are read
//   once a token from device memory; the hk heads of the token read them
//   again from L1 / L2.  (A persistent grid with a 2-stage cp.async.bulk
//   ring of tiles measured slower at phase 2's shapes: PERF.md.)
// - Under GQA replication an input head is normed (and quantized) once and
//   stored rep times.  K3q's scales are staged in shared memory and
//   written at the end of the tile, T consecutive floats per output head.
// The arithmetic is the Pallas kernel's and the plain version's: the
// two-pass fp32 LayerNorm (the mean, then the mean of (x - mean)^2), the
// affine, the rotary, and for K3q the scale __fmul_rn(max(amax, 1e-8),
// 1/127) and quant_mul's quotient x * __fdiv_rn(1, scale) rounded half to
// even, without fast math.  K4 gives one block to each row of D: the gated
// row is staged in shared memory in fp32, and the mean and variance are
// two block reductions over it (two-pass variance, as the Pallas kernel
// computes it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace magi;

constexpr int kPackThreads = 256;

// Rows a lane group loads before its first reduction (a pass), and the
// blocks an SM must hold (the register budget ptxas schedules for; 0: its
// own choice).  K3 keeps two rows in flight a thread at the 64 registers
// ptxas picks (a budget of 4 blocks made it pick 56 and run 15% slower);
// K3q, with twice the arithmetic a row, one row, scheduled for 6 blocks
// an SM at 40 registers (the same 40 unbudgeted ran 17% slower at 720).
// Measured in scripts/time_k5.py A/B builds: PERF.md.
template <typename OutT>
__host__ __device__ constexpr int pack_rows_per_group() {
  return sizeof(OutT) == 1 ? 1 : 2;
}

template <typename OutT>
__host__ __device__ constexpr int pack_blocks_per_sm() {
  return sizeof(OutT) == 1 ? 6 : 0;
}

// sum (max) over the LPR lanes of an aligned lane group; every lane of the
// warp takes part
template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int LPR>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 of a 16-byte word to f32, and back
__device__ __forceinline__ void unpack_bf16(const uint4& r, float* x) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(h);
    x[2 * i + 1] = __high2float(h);
  }
}

__device__ __forceinline__ uint4 pack_bf16(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// symmetric int8 of 8 values x * r with r = 1 / scale, scale = max|x| *
// (1/127) (each IEEE-rounded), as quant_mul: |x * r| <= 127 (1 + 2**-21),
// so its clamp to [-127, 127] never acts, and adding 1.5 * 2**23 rounds
// x * r to an integer half to even in the adder (not the conversion unit),
// whose value is the low byte of the sum's bits; four bytes packed by
// three byte permutes
__device__ __forceinline__ uint2 pack_int8(const float* x, float r) {
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = __float_as_uint(__fadd_rn(__fmul_rn(x[i], r), 12582912.f));
  return make_uint2(__byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040), 0x5410));
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// A block owns tokens [s0, s0 + T) x all hk input heads; LPR = hd / 8
// lanes own a row, lane l its values [8l, 8l + 8).  Rows are taken in
// passes of NG * pack_rows_per_group (tile row r = token t * hk + head).
// OutT is __nv_bfloat16 (K3) or int8_t (K3q, which also writes `scale`);
// kRotSmem: rot % 8 != 0, the rotary partner comes through shared memory.
template <int LPR, typename OutT, bool kRotSmem>
__global__ void __launch_bounds__(kPackThreads, pack_blocks_per_sm<OutT>()) kv_norm_rope_pack_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v, const float* __restrict__ kw,
    const float* __restrict__ kb, const float* __restrict__ sin, const float* __restrict__ cos,
    OutT* __restrict__ out, float* __restrict__ scale, long long S, int hk, int rep, int rot, int T, float eps) {
  constexpr bool kQuant = sizeof(OutT) == 1;
  constexpr int HD = 8 * LPR;
  constexpr int NG = kPackThreads / LPR;
  constexpr int RPG = pack_rows_per_group<OutT>();
  const int G = hk * rep;
  // [2][G][T] scales of the tile (K3q), then [NG][HD] rows (kRotSmem)
  extern __shared__ float smem[];
  float* s_scale = smem;
  const int group = threadIdx.x / LPR;
  const int l = threadIdx.x % LPR;
  const int d0 = 8 * l;
  float* s_row = smem + (kQuant ? 2 * G * T : 0) + group * HD;
  const long long s0 = (long long)blockIdx.x * T;
  const int nt = (int)(S - s0 < T ? S - s0 : T);
  const int rows = nt * hk;
  const uint4* kt = reinterpret_cast<const uint4*>(k + s0 * hk * HD + d0);
  const uint4* vt = reinterpret_cast<const uint4*>(v + s0 * hk * HD + d0);

  for (int base = 0; base < rows; base += NG * RPG) {
    // every load of the pass first, k and v; rows past the tile read zeros
    uint4 kr[RPG], vr[RPG];
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      const int r = base + j * NG + group;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        kr[j] = __ldg(kt + r * LPR);
        vr[j] = __ldg(vt + r * LPR);
      }
    }
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      const int r = base + j * NG + group;
      const bool live = r < rows;
      const int t = r / hk, ig = r - t * hk;
      const long long s = s0 + t;
      float x[8];
      unpack_bf16(kr[j], x);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += x[i];
      const float mean = group_sum<LPR>(acc) / HD;
      acc = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] -= mean;
        acc += x[i] * x[i];
      }
      const float rstd = rsqrtf(group_sum<LPR>(acc) / HD + eps);
      {
        float w[8], b[8];
        load8(kw + d0, w);
        load8(kb + d0, b);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = x[i] * rstd * w[i] + b[i];
      }
      if (rot) {
        if constexpr (kRotSmem) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s_row[d0 + i] = x[i];
          __syncwarp();
          if (live) {
            const float* sn = sin + s * rot;
            const float* cs = cos + s * rot;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int d = d0 + i;
              if (d < rot) {
                x[i] = x[i] * cs[d] - s_row[d + rot] * sn[d];
              } else if (d < 2 * rot) {
                const int e = d - rot;
                x[i] = s_row[e] * sn[e] + x[i] * cs[e];
              }
            }
          }
          __syncwarp();  // the row is rewritten by the next one
        } else {
          const int q = rot / 8;  // lanes of the first rotary half
          const int src = l < q ? l + q : (l < 2 * q ? l - q : l);
          float p[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) p[i] = __shfl_sync(0xffffffffu, x[i], src, LPR);
          if (live && l < 2 * q) {
            // the first half takes x cos - x' sin, the second x' sin + x cos
            const bool first = l < q;
            float sn[8], cs[8];
            load8(sin + s * rot + (first ? d0 : d0 - rot), sn);
            load8(cos + s * rot + (first ? d0 : d0 - rot), cs);
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = x[i] * cs[i] + p[i] * (first ? -sn[i] : sn[i]);
          }
        }
      }
      OutT* ok = out + ((long long)ig * rep * S + s) * HD + d0;
      OutT* ov = ok + (long long)G * S * HD;
      if constexpr (kQuant) {
        float vf[8];
        unpack_bf16(vr[j], vf);
        float ak = 0.f, av = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ak = fmaxf(ak, fabsf(x[i]));
          av = fmaxf(av, fabsf(vf[i]));
        }
        const float sk = __fmul_rn(fmaxf(group_max<LPR>(ak), 1e-8f), 1.f / 127.f);
        const float sv = __fmul_rn(fmaxf(group_max<LPR>(av), 1e-8f), 1.f / 127.f);
        if (live) {
          const uint2 qk = pack_int8(x, __fdiv_rn(1.f, sk));
          const uint2 qv = pack_int8(vf, __fdiv_rn(1.f, sv));
          for (int c = 0; c < rep; ++c) {
            *reinterpret_cast<uint2*>(ok + (long long)c * S * HD) = qk;
            *reinterpret_cast<uint2*>(ov + (long long)c * S * HD) = qv;
          }
          if (l == 0) {
            for (int c = 0; c < rep; ++c) {
              s_scale[(ig * rep + c) * T + t] = sk;
              s_scale[(G + ig * rep + c) * T + t] = sv;
            }
          }
        }
      } else if (live) {
        const uint4 bk = pack_bf16(x);
        for (int c = 0; c < rep; ++c) {
          *reinterpret_cast<uint4*>(ok + (long long)c * S * HD) = bk;
          *reinterpret_cast<uint4*>(ov + (long long)c * S * HD) = vr[j];
        }
      }
    }
  }
  if constexpr (kQuant) {
    // T consecutive scales per output head, k's then v's
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * G * T; i += kPackThreads) {
      const int h = i / T, t = i - h * T;
      if (t < nt) scale[(long long)h * S + s0 + t] = s_scale[i];
    }
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
    int row0, float eps, float w_offset) {
  extern __shared__ float g[];  // [D] gated row, fp32
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int seg = (int)((row + row0) / seg_len);
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

template <int LPR, typename OutT>
cudaError_t launch_kv_pack_hd(const __nv_bfloat16* k, const __nv_bfloat16* v, const float* kw, const float* kb,
                              const float* sin, const float* cos, OutT* out, float* scale, long long S, int hk,
                              int rep, int rot, float eps, cudaStream_t st) {
  constexpr int rows = 2 * kPackThreads / LPR;  // a tile: 4 tokens at hd 128 and hk 8
  const int T = hk >= rows ? 1 : rows / hk;
  const bool rot_smem = rot % 8 != 0;
  const size_t smem = (sizeof(OutT) == 1 ? 2 * sizeof(float) * hk * rep * T : 0) +
                      (rot_smem ? sizeof(float) * kPackThreads * 8 : 0);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (S + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = rot_smem ? kv_norm_rope_pack_kernel<LPR, OutT, true> : kv_norm_rope_pack_kernel<LPR, OutT, false>;
  kernel<<<(unsigned)blocks, kPackThreads, smem, st>>>(k, v, kw, kb, sin, cos, out, scale, S, hk, rep, rot, T, eps);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_kv_pack(const void* k, const void* v, const float* kw, const float* kb, const float* sin,
                           const float* cos, OutT* out, float* scale, long long S, int hk, int hd, int rep, int rot,
                           float eps, cudaStream_t st) {
  if (S == 0) return cudaSuccess;
  if (hk <= 0 || rep <= 0 || rot < 0 || 2 * rot > hd) return cudaErrorInvalidValue;
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  switch (hd) {
    case 64:
      return launch_kv_pack_hd<8, OutT>(kk, vv, kw, kb, sin, cos, out, scale, S, hk, rep, rot, eps, st);
    case 128:
      return launch_kv_pack_hd<16, OutT>(kk, vv, kw, kb, sin, cos, out, scale, S, hk, rep, rot, eps, st);
    case 256:
      return launch_kv_pack_hd<32, OutT>(kk, vv, kw, kb, sin, cos, out, scale, S, hk, rep, rot, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// k, v: [S, hk, hd] bf16; kw, kb: [hd] f32; sin, cos: [S, rot] f32 or null
// (rot 0); out: [2, hk*rep, S, hd] bf16
int magi_kv_norm_rope_pack(const void* k, const void* v, const float* kw, const float* kb, const float* sin,
                           const float* cos, void* out, long long S, int hk, int hd, int rep, int rot, float eps,
                           void* stream) {
  return (int)launch_kv_pack(k, v, kw, kb, sin, cos, static_cast<__nv_bfloat16*>(out), nullptr, S, hk, hd, rep, rot,
                             eps, static_cast<cudaStream_t>(stream));
}

// as magi_kv_norm_rope_pack, but out: [2, hk*rep, S, hd] int8 and
// scale: [2, hk*rep, S] f32 (per-token symmetric int8)
int magi_kv_norm_rope_pack_q8(const void* k, const void* v, const float* kw, const float* kb, const float* sin,
                              const float* cos, void* out, float* scale, long long S, int hk, int hd, int rep,
                              int rot, float eps, void* stream) {
  return (int)launch_kv_pack(k, v, kw, kb, sin, cos, static_cast<int8_t*>(out), scale, S, hk, hd, rep, rot, eps,
                             static_cast<cudaStream_t>(stream));
}

// x, residual, out: [S, D] bf16; gate: [n_seg, D] f32; w, b: [D] f32.  Row r
// takes gate row (r + row0) / seg_len: a shard of the token axis that starts
// row0 tokens into its first segment (0 <= row0 < seg_len)
int magi_gate_norm_residual(const void* x, const void* residual, const float* gate, const float* w, const float* b,
                            void* out, long long S, int D, int seg_len, int row0, float eps, int zero_centered,
                            void* stream) {
  if (S == 0) return 0;
  if (D % 4 || row0 < 0 || row0 >= seg_len) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(gate_norm_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gate_norm_residual_kernel<<<(unsigned)S, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(residual), gate, w, b,
      static_cast<__nv_bfloat16*>(out), D, seg_len, row0, eps, zero_centered ? 1.f : 0.f);
  return (int)cudaGetLastError();
}

}  // extern "C"
