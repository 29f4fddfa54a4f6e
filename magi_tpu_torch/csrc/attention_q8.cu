// Two-source segmented flash attention over an int8 KV cache, scheme qk8,
// for Hopper (sm_90a).
//
// Replaces (magi_tpu/ops/attention_q8.py):
//   seg_attn_q8_kernel -> segmented_attention_two_source_q8 with scheme
//       "qk8" (_seg_attn_kernel_two_source_q8 + _q_prologue_q8), the DiT
//       self-attention over the int8-stored KV cache and the current
//       window's int8 kv, and (with an empty second source) the int8
//       caption cross-attention; C entry magi_seg_attn_two_source_q8.
//
// Semantics.  As K1 (csrc/attention.cu): q token-major [n_seg * seg_len,
// hq, hd] bf16; segment i attends tokens [r1s[i], r1e[i]) of source 1
// then [r2s[i], r2e[i]) of source 2, each clipped to its source; a segment
// with empty ranges outputs 0; q head h reads kv head h / (hq / hk).  Each
// source is int8 kv [2, hk, len, hd] with f32 per-token scales [2, hk,
// len] (k scales, then v scales).  The qk8 scheme:
//   * q (after the optional fp32 LayerNorm + GPT-NeoX rotary prologue) is
//     quantized per row (token, head) to int8: scale sq = max(amax, 1e-8)
//     / 127, value round(q * (1 / sq)); sq * sm_scale * log2(e) is kept
//     per row;
//   * logits s = (q8 . k8)_int32 * sq_row * sk_token (exp2 domain);
//   * online softmax in f32 with exp2;
//   * the per-token v scale folds into p, which is cast to bf16, and the
//     second product runs in bf16 against the int8 v cast to bf16 (ints in
//     [-127, 127] are exact in bf16).
//
// What bounds it on the H100.  At the main path's shapes (seg_len 1536,
// kv spans of 1 to 5 chunks) the q.k product runs at the int8 rate (1979
// TOP/s) and p.v at the bf16 rate (989 TFLOP/s): the operations bound it,
// with p.v the larger term; the kv bytes are half of K1's.  This first
// version uses mma.sync (m16n8k32 s8 and m16n8k16 bf16); wgmma and TMA are
// later work.
//
// Design.  K1's: one block per (64 q tokens, the q heads of one kv head,
// segment); each kv tile of 64 tokens (int8 k and v, and their 64 + 64
// scales) is loaded once for the block's heads with a two-stage cp.async
// pipeline.  q is quantized once in the prologue into shared memory.
// ldmatrix cannot transpose 8-bit data, so each v tile is converted to
// bf16 in shared memory after it lands and the p.v product reads it with
// ldmatrix.trans as K1 does; int8 k is read by ldmatrix as it is (the int8
// fragments have the bf16 ones' byte layout).  The scales are loaded with
// 4-byte cp.async beside their tile (a tile starts at the range start, so
// its scale row need not be 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace magi;

constexpr int kBK = 64;                  // kv tokens per tile
constexpr int kWarpsPerHead = 4;         // each warp owns 16 q rows of one head
constexpr int kBQ = 16 * kWarpsPerHead;  // q tokens per block
constexpr int kMaxHeadsPerBlock = 3;
constexpr int kMaxThreads = 32 * kWarpsPerHead * kMaxHeadsPerBlock;

struct Source {
  const int8_t* kv;   // [2, hk, len, hd]
  const float* sc;    // [2, hk, len]
  int len;            // tokens in the source; ranges are clipped to it
  const int* start;   // [n_seg]
  const int* end;
};

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  Source src[2];
  const float* qw;   // [hd] q LayerNorm weight, or nullptr (no prologue)
  const float* qb;
  const float* sin;  // [n_seg*seg_len, rot] or nullptr (no rotary)
  const float* cos;
  int seg_len, hq, hk, q_per_kv, heads_per_block, rot;
  float eps, scale;  // scale = sm_scale * log2(e)
};

template <int HD>
constexpr size_t smem_bytes(int rows, int nwarps) {
  return (size_t)rows * (HD + 16) + 2 * kBK * (HD + 16) + 2 * kBK * HD + (size_t)kBK * (HD + 8) * 2 +
         ((size_t)rows + 4 * kBK + (size_t)nwarps * HD) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_q8_kernel(const __grid_constant__ Args a) {
  constexpr int LDQ = HD + 16;  // padded int8 row: ldmatrix rows hit distinct banks
  constexpr int LDV = HD + 8;   // padded bf16 row
  constexpr int EPT = HD / 32;  // q elements per lane in the prologue
  constexpr int CPR = HD / 16;  // 16-byte chunks per int8 row
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x;
  const int hgroup = blockIdx.y;
  const int seg = blockIdx.z;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = kBQ * a.heads_per_block;
  const int head0 = hgroup * a.heads_per_block;
  const int kvh = head0 / a.q_per_kv;

  int8_t* sQ = reinterpret_cast<int8_t*>(smem);                      // [rows][LDQ]
  int8_t* sK = sQ + rows * LDQ;                                      // [2][kBK][LDQ]
  int8_t* sV8 = sK + 2 * kBK * LDQ;                                  // [2][kBK][HD]
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sV8 + 2 * kBK * HD);  // [kBK][LDV]
  float* sQs = reinterpret_cast<float*>(sV + kBK * LDV);             // [rows]
  float* sSk = sQs + rows;                                           // [2][kBK]
  float* sSv = sSk + 2 * kBK;                                        // [2][kBK]
  float* sRow = sSv + 2 * kBK;                                       // [nwarps][HD]

  const int lo0 = max(a.src[0].start[seg], 0);
  const int hi0 = min(a.src[0].end[seg], a.src[0].len);
  const int lo1 = max(a.src[1].start[seg], 0);
  const int hi1 = min(a.src[1].end[seg], a.src[1].len);
  const int n0 = hi0 > lo0 ? (hi0 - lo0 + kBK - 1) / kBK : 0;
  const int n1 = hi1 > lo1 ? (hi1 - lo1 + kBK - 1) / kBK : 0;
  const int total = n0 + n1;

  auto tile_range = [&](int j, int& t0, int& hi) {
    const bool first = j < n0;
    t0 = first ? lo0 + j * kBK : lo1 + (j - n0) * kBK;
    hi = first ? hi0 : hi1;
  };

  auto load_tile = [&](int j, int buf) {
    int t0, hi;
    tile_range(j, t0, hi);
    const bool first = j < n0;
    const int len = first ? a.src[0].len : a.src[1].len;
    const int8_t* kb = (first ? a.src[0].kv : a.src[1].kv) + (long long)kvh * len * HD;
    const int8_t* vb = kb + (long long)a.hk * len * HD;
    const float* skb = (first ? a.src[0].sc : a.src[1].sc) + (long long)kvh * len;
    const float* svb = skb + (long long)a.hk * len;
    for (int c = threadIdx.x; c < kBK * CPR; c += blockDim.x) {
      const int r = c / CPR;
      const int col = (c % CPR) * 16;
      const int tok = t0 + r;
      const bool valid = tok < hi;
      const long long off = (long long)(valid ? tok : t0) * HD + col;
      cp_async16(sK + (buf * kBK + r) * LDQ + col, kb + off, valid);
      cp_async16(sV8 + (buf * kBK + r) * HD + col, vb + off, valid);
    }
    for (int c = threadIdx.x; c < 2 * kBK; c += blockDim.x) {
      const int r = c % kBK;
      const int tok = t0 + r;
      const bool valid = tok < hi;
      const bool is_k = c < kBK;
      cp_async4((is_k ? sSk : sSv) + buf * kBK + r, (is_k ? skb : svb) + (valid ? tok : t0), valid);
    }
    cp_async_commit();
  };

  if (total > 0) load_tile(0, 0);  // first tile in flight during the prologue

  // ---- q prologue: LN (+ rotary), then per-row int8 into shared memory --
  for (int R = warp; R < rows; R += nwarps) {
    const int j = R / kBQ;
    const int tok_in_seg = qt * kBQ + (R % kBQ);
    int8_t* dst = sQ + R * LDQ;
    if (tok_in_seg >= a.seg_len) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) dst[lane * EPT + i] = 0;
      if (lane == 0) sQs[R] = 0.f;
      continue;
    }
    const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
    const __nv_bfloat16* src = a.q + (gtok * a.hq + head0 + j) * HD;
    float x[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) x[i] = __bfloat162float(src[lane * EPT + i]);
    if (a.qw) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) s += x[i];
      const float mean = warp_sum(s) / HD;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) v += (x[i] - mean) * (x[i] - mean);
      const float rstd = rsqrtf(warp_sum(v) / HD + a.eps);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int d = lane * EPT + i;
        x[i] = (x[i] - mean) * rstd * a.qw[d] + a.qb[d];
      }
      if (a.sin) {
        float* row = sRow + warp * HD;
#pragma unroll
        for (int i = 0; i < EPT; ++i) row[lane * EPT + i] = x[i];
        __syncwarp();
        const float* sn = a.sin + gtok * a.rot;
        const float* cs = a.cos + gtok * a.rot;
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const int d = lane * EPT + i;
          if (d < a.rot) {
            x[i] = row[d] * cs[d] - row[d + a.rot] * sn[d];
          } else if (d < 2 * a.rot) {
            const int e = d - a.rot;
            x[i] = row[e] * sn[e] + row[d] * cs[e];
          }
        }
        __syncwarp();
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) amax = fmaxf(amax, fabsf(x[i]));
    const float sq = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.f / 127.f);
    const float r = __fdiv_rn(1.f, sq);
#pragma unroll
    for (int i = 0; i < EPT; ++i) dst[lane * EPT + i] = (int8_t)quant_mul(x[i], r);
    if (lane == 0) sQs[R] = __fmul_rn(sq, a.scale);
  }
  __syncthreads();

  // ---- flash loop over kv tiles ----------------------------------------
  const int R0 = warp * 16;  // this warp's first q row in sQ
  const int g = lane >> 2, tig = lane & 3;
  const float sq_row[2] = {sQs[R0 + g], sQs[R0 + g + 8]};
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int jt = 0; jt < total; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < total) {
      load_tile(jt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* Kt = sK + buf * kBK * LDQ;
    const float* Skt = sSk + buf * kBK;
    const float* Svt = sSv + buf * kBK;

    // v tile: int8 -> bf16 (exact), for ldmatrix.trans in the p.v product
    for (int c = threadIdx.x; c < kBK * CPR; c += blockDim.x) {
      const int r = c / CPR;
      const int col = (c % CPR) * 16;
      const int4 raw = *reinterpret_cast<const int4*>(sV8 + (buf * kBK + r) * HD + col);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)b[2 * e], (float)b[2 * e + 1]);
      uint4* d = reinterpret_cast<uint4*>(sV + r * LDV + col);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }

    // S = q8 k8^T (int32, exact) for this warp's 16 rows x kBK columns
    int s32[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s32[i][0] = s32[i][1] = s32[i][2] = s32[i][3] = 0;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      uint32_t qa[4];
      ldsm_x4(qa, sQ + (R0 + (lane & 15)) * LDQ + kk + (lane >> 4) * 16);
#pragma unroll
      for (int n2 = 0; n2 < kBK / 16; ++n2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (n2 * 16 + i + (m >> 1) * 8) * LDQ + kk + (m & 1) * 16);
        mma16832_s8(s32[2 * n2], qa, kb[0], kb[1]);
        mma16832_s8(s32[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    // dequantize: s = (s32 * sq_row) * sk_token; mask past the range end
    int t0, hi;
    tile_range(jt, t0, hi);
    const int valid_cols = hi - t0;
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const int c = nt * 8 + tig * 2;
      const float sk0 = Skt[c], sk1 = Skt[c + 1];
      s[nt][0] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][0]), sq_row[0]), sk0);
      s[nt][1] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][1]), sq_row[0]), sk1);
      s[nt][2] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][2]), sq_row[1]), sk0);
      s[nt][3] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][3]), sq_row[1]), sk1);
      if (c >= valid_cols) s[nt][0] = s[nt][2] = -CUDART_INF_F;
      if (c + 1 >= valid_cols) s[nt][1] = s[nt][3] = -CUDART_INF_F;
    }

    // online softmax (exp2 domain: the row scales carry sm_scale*log2e)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];  // all-masked row: p = 0, not NaN
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base[0]);
      s[nt][1] = exp2f(s[nt][1] - base[0]);
      s[nt][2] = exp2f(s[nt][2] - base[1]);
      s[nt][3] = exp2f(s[nt][3] - base[1]);
      rsum[0] += s[nt][0] + s[nt][1];
      rsum[1] += s[nt][2] + s[nt][3];
    }
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    __syncthreads();  // the bf16 v tile is complete

    // O += bf16(P * sv) V: the S accumulators re-pack as the A operand
#pragma unroll
    for (int k2 = 0; k2 < kBK / 16; ++k2) {
      const int c = k2 * 16 + tig * 2;
      const float v0 = Svt[c], v1 = Svt[c + 1], v8 = Svt[c + 8], v9 = Svt[c + 9];
      uint32_t pa[4];
      pa[0] = pack_bf16(__fmul_rn(s[2 * k2][0], v0), __fmul_rn(s[2 * k2][1], v1));
      pa[1] = pack_bf16(__fmul_rn(s[2 * k2][2], v0), __fmul_rn(s[2 * k2][3], v1));
      pa[2] = pack_bf16(__fmul_rn(s[2 * k2 + 1][0], v8), __fmul_rn(s[2 * k2 + 1][1], v9));
      pa[3] = pack_bf16(__fmul_rn(s[2 * k2 + 1][2], v8), __fmul_rn(s[2 * k2 + 1][3], v9));
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t vb[4];
        ldsm_x4_trans(vb, sV + (k2 * 16 + i + (m & 1) * 8) * LDV + d2 * 16 + (m >> 1) * 8);
        mma16816(o[2 * d2], pa, vb[0], vb[1]);
        mma16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration overwrites this buffer and the bf16 v tile
  }

  // ---- epilogue: normalise and store token-major ------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int R = R0 + g + 8 * r;
    const int j = R / kBQ;
    const int tok_in_seg = qt * kBQ + (R % kBQ);
    if (tok_in_seg >= a.seg_len) continue;
    const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
    __nv_bfloat16* dst = a.out + (gtok * a.hq + head0 + j) * HD + tig * 2;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const Args& a, int n_seg, cudaStream_t stream) {
  const int rows = kBQ * a.heads_per_block;
  const int threads = 32 * kWarpsPerHead * a.heads_per_block;
  const size_t smem = smem_bytes<HD>(rows, threads / 32);
  cudaError_t err =
      cudaFuncSetAttribute(seg_attn_q8_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seg_len + kBQ - 1) / kBQ, a.hq / a.heads_per_block, n_seg);
  seg_attn_q8_kernel<HD><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [n_seg*seg_len, hq, hd] bf16; kv1, kv2: [2, hk, len, hd] int8;
// sc1, sc2: [2, hk, len] f32; qw, qb: [hd] f32 or null; sin, cos:
// [n_seg*seg_len, rot] f32 or null; scale = sm_scale * log2(e)
int magi_seg_attn_two_source_q8(const void* q, void* out, const void* kv1, const float* sc1, long long kv1_len,
                                const void* kv2, const float* sc2, long long kv2_len, const int* r1s, const int* r1e,
                                const int* r2s, const int* r2e, const float* qw, const float* qb, const float* sin,
                                const float* cos, int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps,
                                float scale, void* stream) {
  if (hk <= 0 || hq % hk) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.src[0] = {static_cast<const int8_t*>(kv1), sc1, (int)kv1_len, r1s, r1e};
  a.src[1] = {static_cast<const int8_t*>(kv2), sc2, (int)kv2_len, r2s, r2e};
  a.qw = qw;
  a.qb = qb;
  a.sin = sin;
  a.cos = cos;
  a.seg_len = seg_len;
  a.hq = hq;
  a.hk = hk;
  a.q_per_kv = hq / hk;
  a.rot = rot;
  a.eps = eps;
  a.scale = scale;
  // the largest divisor of q_per_kv that fits one block
  a.heads_per_block = 1;
  for (int d = kMaxHeadsPerBlock; d >= 1; --d) {
    if (a.q_per_kv % d == 0) {
      a.heads_per_block = d;
      break;
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return (int)launch<128>(a, n_seg, st);
  if (hd == 64) return (int)launch<64>(a, n_seg, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
