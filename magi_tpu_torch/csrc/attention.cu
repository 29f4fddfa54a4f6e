// Segmented flash attention for Hopper (sm_90a): one kernel body, three
// `__global__` kernels (one per Pallas kernel it replaces, so a trace
// names each), two C entry points.
//
// Replaces (magi_tpu/ops/attention.py):
//   seg_attn_two_source_kernel -> segmented_attention_two_source
//       (_seg_attn_kernel_two_source + _q_prologue + _o_epilogue), the DiT
//       self-attention over the read-only KV cache and the current kv;
//       C entry magi_seg_attn_two_source.
//   seg_attn_v2_kernel -> segmented_attention_v2 (_seg_attn_kernel_v2), the
//       DiT caption cross-attention (hd 128, norm-only q prologue);
//       C entry magi_seg_attn with kind 1.
//   seg_attn_grid_kernel -> segmented_attention (_seg_attn_kernel), the
//       VAE self-attention (hd 64, no prologue); magi_seg_attn with kind 2.
//
// Semantics.  q is token-major [n_seg * seg_len, hq, hd] bf16.  Segment i
// attends tokens [r1s[i], r1e[i]) of source 1, then [r2s[i], r2e[i]) of
// source 2, each range clipped to its source's length.  Each source is a
// (k, v) pair addressed by a token stride and a head stride, so the same
// body reads the cache layout [2, hk, tok, hd] and the token-major layout
// [tok, hk, hd].  A segment with empty ranges outputs 0.  GQA: q head h
// reads kv head h / q_per_kv.  The single-source kernels have source 1
// compiled out: their loop is that of a kernel written for one source.
//
// Optional q prologue, as the Pallas kernel's: fp32 LayerNorm of each q
// row with (w, b) already scaled by sm_scale*log2(e) in the wrapper, then
// GPT-NeoX rotary on the first 2*rot dims (rot = 48 on the DiT, not a
// power of two), then the bf16 cast.  Without it q is scaled by
// sm_scale*log2(e) before the cast.  The softmax runs in the exp2 domain.
//
// What bounds it on the H100.  At the main path's shapes (seg_len 12150
// tokens at 720p, kv spans of up to 5 chunks) attention does ~300 flops
// per byte of q/k/v it must read, at the ridge of the card's 989 TFLOP/s
// bf16 over 3.35 TB/s: the tensor-core rate bounds it.  This first
// version uses mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// ldmatrix from padded shared memory; wgmma and TMA, which the card needs
// for its full rate, are later work.
//
// Design.  One block per (q tile of 64 tokens, group of heads that share
// one kv head, segment).  The block stages its heads' q rows once
// (prologue fused), then walks 64-token kv tiles of both sources with a
// two-stage cp.async pipeline.  Folding the GQA heads into the block
// means each kv tile is read from memory once for all of them.  Each warp
// owns 16 q rows; online softmax (flash-attention 2) keeps the output in
// registers, normalised once at the end.  Only the last tile of a source
// is masked: tiles start at the range start, and rows past the range end
// are zero-filled by cp.async, so no read leaves the source.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;             // kv tokens per tile
constexpr int kWarpsPerHead = 4;    // each warp owns 16 q rows of one head
constexpr int kBQ = 16 * kWarpsPerHead;  // q tokens per block
constexpr int kMaxHeadsPerBlock = 3;
constexpr int kMaxThreads = 32 * kWarpsPerHead * kMaxHeadsPerBlock;

// kernel kinds of magi_seg_attn (ops/attention.py passes the same numbers)
enum Kind { kTwoSource = 0, kV2 = 1, kGrid = 2 };

struct Source {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long tok_stride;   // elements between consecutive tokens
  long long head_stride;  // elements between consecutive kv heads
  int len;                // tokens in the source; ranges are clipped to it
  const int* start;       // [n_seg]
  const int* end;
};

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  Source src[2];
  const float* qw;  // [hd] LN weight * sm_scale*log2e, or nullptr (no LN)
  const float* qb;
  const float* sin;  // [n_seg*seg_len, rot] or nullptr (no rotary)
  const float* cos;
  int seg_len, hq, q_per_kv, heads_per_block, rot;
  float eps, scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading src
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD, bool TWO_SOURCE>
__device__ __forceinline__ void seg_attn_body(const Args& a) {
  constexpr int LDS = HD + 8;  // padded row: ldmatrix rows hit distinct banks
  constexpr int EPT = HD / 32; // q elements per lane in the prologue
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x;
  const int hgroup = blockIdx.y;
  const int seg = blockIdx.z;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = kBQ * a.heads_per_block;
  const int head0 = hgroup * a.heads_per_block;  // first q head of the block
  const int kvh = head0 / a.q_per_kv;

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + rows * LDS;      // [2][kBK][LDS]
  __nv_bfloat16* sV = sK + 2 * kBK * LDS;   // [2][kBK][LDS]
  float* sRow = reinterpret_cast<float*>(sV + 2 * kBK * LDS);  // [nwarps][HD]

  // ranges of both sources, clipped to the sources (scalars, not arrays:
  // no dynamic indexing, so nothing spills to local memory).  Without a
  // first source n0 is the constant 0 and its branches fold away.
  const int lo0 = TWO_SOURCE ? max(a.src[0].start[seg], 0) : 0;
  const int hi0 = TWO_SOURCE ? min(a.src[0].end[seg], a.src[0].len) : 0;
  const int lo1 = max(a.src[1].start[seg], 0);
  const int hi1 = min(a.src[1].end[seg], a.src[1].len);
  const int n0 = TWO_SOURCE && hi0 > lo0 ? (hi0 - lo0 + kBK - 1) / kBK : 0;
  const int n1 = hi1 > lo1 ? (hi1 - lo1 + kBK - 1) / kBK : 0;
  const int total = n0 + n1;

  // tile j: first token t0 and end `hi` within its source
  auto tile_range = [&](int j, int& t0, int& hi) {
    const bool first = j < n0;
    t0 = first ? lo0 + j * kBK : lo1 + (j - n0) * kBK;
    hi = first ? hi0 : hi1;
  };

  auto load_tile = [&](int j, int buf) {
    int t0, hi;
    tile_range(j, t0, hi);
    const bool first = j < n0;
    const long long tok_stride = first ? a.src[0].tok_stride : a.src[1].tok_stride;
    const long long head_off = kvh * (first ? a.src[0].head_stride : a.src[1].head_stride);
    const __nv_bfloat16* kb = (first ? a.src[0].k : a.src[1].k) + head_off;
    const __nv_bfloat16* vb = (first ? a.src[0].v : a.src[1].v) + head_off;
    constexpr int CPR = HD / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kBK * CPR; c += blockDim.x) {
      const int r = c / CPR;
      const int col = (c % CPR) * 8;
      const int tok = t0 + r;
      const bool valid = tok < hi;
      const long long off = (long long)(valid ? tok : t0) * tok_stride + col;
      cp_async16(sK + (buf * kBK + r) * LDS + col, kb + off, valid);
      cp_async16(sV + (buf * kBK + r) * LDS + col, vb + off, valid);
    }
    cp_async_commit();
  };

  if (total > 0) load_tile(0, 0);  // first tile in flight during the prologue

  // ---- q prologue: [rows, HD] bf16 into shared memory -------------------
  for (int R = warp; R < rows; R += nwarps) {
    const int j = R / kBQ;
    const int tok_in_seg = qt * kBQ + (R % kBQ);
    __nv_bfloat16* dst = sQ + R * LDS;
    if (tok_in_seg >= a.seg_len) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) dst[lane * EPT + i] = __float2bfloat16(0.f);
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
    } else {
#pragma unroll
      for (int i = 0; i < EPT; ++i) x[i] *= a.scale;
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i) dst[lane * EPT + i] = __float2bfloat16(x[i]);
  }
  __syncthreads();

  // ---- flash loop over kv tiles ----------------------------------------
  const int R0 = warp * 16;  // this warp's first q row in sQ
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
    const __nv_bfloat16* Kt = sK + buf * kBK * LDS;
    const __nv_bfloat16* Vt = sV + buf * kBK * LDS;

    // S = Q K^T for this warp's 16 rows x kBK columns
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t qa[4];
      ldsm_x4(qa, sQ + (R0 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < kBK / 16; ++n2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (n2 * 16 + i + (m >> 1) * 8) * LDS + kk + (m & 1) * 8);
        mma16816(s[2 * n2], qa, kb[0], kb[1]);
        mma16816(s[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    // mask the columns past the range end (last tile of a source only)
    int t0, hi;
    tile_range(jt, t0, hi);
    const int valid_cols = hi - t0;
    if (valid_cols < kBK) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int c = nt * 8 + (lane & 3) * 2;
        if (c >= valid_cols) s[nt][0] = s[nt][2] = -CUDART_INF_F;
        if (c + 1 >= valid_cols) s[nt][1] = s[nt][3] = -CUDART_INF_F;
      }
    }

    // online softmax (exp2 domain: q already carries sm_scale*log2e)
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

    // O += P V: the S accumulators re-pack as the A operand
#pragma unroll
    for (int k2 = 0; k2 < kBK / 16; ++k2) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
      pa[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
      pa[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
      pa[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        const int m = lane >> 3, i = lane & 7;
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (k2 * 16 + i + (m & 1) * 8) * LDS + d2 * 16 + (m >> 1) * 8);
        mma16816(o[2 * d2], pa, vb[0], vb[1]);
        mma16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // ---- epilogue: normalise and store token-major ------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int R = R0 + (lane >> 2) + 8 * r;
    const int j = R / kBQ;
    const int tok_in_seg = qt * kBQ + (R % kBQ);
    if (tok_in_seg >= a.seg_len) continue;
    const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
    __nv_bfloat16* dst = a.out + (gtok * a.hq + head0 + j) * HD + (lane & 3) * 2;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_two_source_kernel(const __grid_constant__ Args a) {
  seg_attn_body<HD, true>(a);
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_v2_kernel(const __grid_constant__ Args a) {
  seg_attn_body<HD, false>(a);
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_grid_kernel(const __grid_constant__ Args a) {
  seg_attn_body<HD, false>(a);
}

template <int HD>
cudaError_t launch(void (*kernel)(Args), const Args& a, int n_seg, cudaStream_t stream) {
  const int rows = kBQ * a.heads_per_block;
  const int threads = 32 * kWarpsPerHead * a.heads_per_block;
  const size_t smem = (size_t)(rows + 4 * kBK) * (HD + 8) * sizeof(__nv_bfloat16) +
                      (size_t)(threads / 32) * HD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seg_len + kBQ - 1) / kBQ, a.hq / a.heads_per_block, n_seg);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_kind(int kind, const Args& a, int n_seg, cudaStream_t stream) {
  switch (kind) {
    case kTwoSource: return launch<HD>(seg_attn_two_source_kernel<HD>, a, n_seg, stream);
    case kV2: return launch<HD>(seg_attn_v2_kernel<HD>, a, n_seg, stream);
    case kGrid: return launch<HD>(seg_attn_grid_kernel<HD>, a, n_seg, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Args& a, int kind, int n_seg, int hd, int hk, cudaStream_t stream) {
  if (a.hq % hk) return cudaErrorInvalidValue;
  a.q_per_kv = a.hq / hk;
  // the largest divisor of q_per_kv that fits one block
  a.heads_per_block = 1;
  for (int d = kMaxHeadsPerBlock; d >= 1; --d) {
    if (a.q_per_kv % d == 0) {
      a.heads_per_block = d;
      break;
    }
  }
  if (hd == 128) return launch_kind<128>(kind, a, n_seg, stream);
  if (hd == 64) return launch_kind<64>(kind, a, n_seg, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: [n_seg*seg_len, hq, hd]; kv1, kv2: [2, hk, len, hd] (k then v)
int magi_seg_attn_two_source(const void* q, void* out, const void* kv1, long long kv1_len, const void* kv2,
                             long long kv2_len, const int* r1s, const int* r1e, const int* r2s, const int* r2e,
                             const float* qw, const float* qb, const float* sin, const float* cos, int n_seg,
                             int seg_len, int hq, int hk, int hd, int rot, float eps, float scale,
                             void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  const __nv_bfloat16* b1 = static_cast<const __nv_bfloat16*>(kv1);
  const __nv_bfloat16* b2 = static_cast<const __nv_bfloat16*>(kv2);
  a.src[0] = {b1, b1 + (long long)hk * kv1_len * hd, hd, kv1_len * hd, (int)kv1_len, r1s, r1e};
  a.src[1] = {b2, b2 + (long long)hk * kv2_len * hd, hd, kv2_len * hd, (int)kv2_len, r2s, r2e};
  a.qw = qw;
  a.qb = qb;
  a.sin = sin;
  a.cos = cos;
  a.seg_len = seg_len;
  a.hq = hq;
  a.rot = rot;
  a.eps = eps;
  a.scale = scale;
  return (int)dispatch(a, kTwoSource, n_seg, hd, hk, static_cast<cudaStream_t>(stream));
}

// q, out: [n_seg*seg_len, hq, hd]; k, v: [kv_len, hk, hd] (token-major);
// kind: 1 segmented_attention_v2, 2 segmented_attention
int magi_seg_attn(const void* q, void* out, const void* k, const void* v, long long kv_len, const int* kv_start,
                  const int* kv_end, const float* qw, const float* qb, const float* sin, const float* cos,
                  int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps, float scale, int kind,
                  void* stream) {
  if (kind != kV2 && kind != kGrid) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.src[0] = {nullptr, nullptr, 0, 0, 0, nullptr, nullptr};
  a.src[1] = {static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), (long long)hk * hd, hd,
              (int)kv_len, kv_start, kv_end};
  a.qw = qw;
  a.qb = qb;
  a.sin = sin;
  a.cos = cos;
  a.seg_len = seg_len;
  a.hq = hq;
  a.rot = rot;
  a.eps = eps;
  a.scale = scale;
  return (int)dispatch(a, kind, n_seg, hd, hk, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
