// Two-source segmented flash attention over an int8 KV cache, for Hopper
// (sm_90a), under K5's schemes sage and dq.  The default scheme, qk8, is
// a kernel of its own on TMA and wgmma in csrc/attention_tma.cu.
//
// Replaces (magi_tpu/ops/attention_q8.py):
//   seg_attn_q8_sage_kernel -> segmented_attention_two_source_q8 with
//       scheme "sage" (_seg_attn_kernel_two_source_q8 + _q_prologue_q8),
//       the DiT self-attention over the int8-stored KV cache and the
//       current window's int8 kv, and (with an empty second source) the
//       int8 caption cross-attention;
//   seg_attn_q8_dq_kernel -> the same with scheme "dq" (_q_prologue with
//       a bf16 q scratch).
//   C entry magi_seg_attn_two_source_q8, whose `scheme` argument picks one.
//
// Semantics.  As K1 (csrc/attention_tma.cu): q token-major [n_seg * seg_len,
// hq, hd] bf16; segment i attends tokens [r1s[i], r1e[i]) of source 1
// then [r2s[i], r2e[i]) of source 2, each clipped to its source; a segment
// with empty ranges outputs 0; q head h reads kv head h / (hq / hk).  Each
// source is int8 kv [2, hk, len, hd] with f32 per-token scales [2, hk,
// len] (k scales, then v scales).  Online softmax in f32 with exp2 (the
// logits carry sm_scale * log2(e)).  The schemes:
//   * sage: q (after the optional fp32 LayerNorm + GPT-NeoX rotary
//     prologue) is quantized per row (token, head) to int8: scale sq =
//     max(amax, 1e-8) / 127, value round(q * (1 / sq)); logits s =
//     (q8 . k8)_int32 * (sq * sm_scale * log2e) * sk_token, as qk8's; per
//     kv tile pv = p * sv is
//     requantized per row against the tile's row max, sp = max(rowmax(pv),
//     1e-20) * (1/127), p8 = round(pv * (1 / sp)) (half to even), and p.v
//     runs int8: o = o * alpha + (p8 . v8)_int32 * sp.  p8 depends on the
//     tile's columns and on the running max, so the tiles are aligned to
//     kBK within each source (the Pallas kernel's lo = start // block_k)
//     and the plain version walks the same tiles.
//   * dq: q stays bf16 (rounded after the prologue, no sm_scale folded);
//     k is converted int8 -> bf16 (exact) and the logits are (q . k) *
//     (sk_token * sm_scale * log2e); the per-token v scale folds into p,
//     which is cast to bf16, and p.v runs in bf16 against the int8 v cast
//     to bf16 (ints in [-127, 127] are exact in bf16), as in qk8.
//
// What bounds it on the H100.  At the main path's shapes (seg_len 1536,
// kv spans of 1 to 5 chunks) the operations: q.k runs at the int8 rate
// (1979 TOP/s) in sage and at the bf16 rate (989 TFLOP/s) in dq; p.v at
// the int8 rate in sage and the bf16 rate in dq.  The kv
// bytes are half of K1's in every scheme.  This first version uses
// mma.sync (m16n8k32 s8 and m16n8k16 bf16); wgmma and TMA are later work.
//
// Design.  That of K2 (csrc/attention.cu): one block per (64 q tokens,
// the q heads of one kv head, segment); each kv tile of 64 tokens (int8 k and v, and their 64 + 64
// scales) is loaded once for the block's heads with a two-stage cp.async
// pipeline.  q is staged once in the prologue into shared memory (int8 and
// its row scales, or bf16 for dq).  ldmatrix cannot transpose 8-bit data,
// so after each v tile lands it is rewritten in shared memory: to bf16 for
// dq (read by ldmatrix.trans, as K2 does), or, for sage, to the
// byte-transposed v8^T [hd][tokens] that the int8 B operand needs (read by
// ldmatrix as the int8 k is: the int8 fragments have the bf16 ones' byte
// layout).  sage's p.v reuses the q.k accumulator registers as its A
// operand: an m16n8k32 A fragment holds, per row, k indices 4t..4t+3 and
// 16+4t..16+4t+3, where the accumulator holds columns 2t, 2t+1 of each
// n8 tile, so the transposed v tile stores its tokens in the permuted
// order that makes the two agree (the contraction index may be permuted
// when both operands follow it).  dq converts each k tile to bf16 in
// shared memory and runs q.k on m16n8k16 with ldmatrix (non-trans).  The
// scales are loaded with 4-byte cp.async beside their tile (a tile need
// not start 16-byte aligned in its scale row).

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

enum Scheme : int { kSage = 1, kDQ = 2 };  // 0 is qk8, in csrc/attention_tma.cu

template <int HD>
struct Layout {
  static constexpr int LDQ = HD + 16;   // padded int8 row (q8, k8): ldmatrix rows hit distinct banks
  static constexpr int LDV = HD + 8;    // padded bf16 row (elements)
  static constexpr int LDVT = kBK + 16; // padded row of sage's transposed v8 tile (bytes)
};

// shared memory of the scheme S, region by region (each a multiple of 16 bytes)
template <int HD, int S>
__host__ __device__ constexpr size_t q_bytes(int rows) {
  return S == kDQ ? (size_t)rows * Layout<HD>::LDV * 2 : (size_t)rows * Layout<HD>::LDQ;
}

template <int HD, int S>
__host__ __device__ constexpr size_t aux_bytes() {
  // dq: the bf16 v and k tiles; sage: v8^T
  return S == kSage ? (size_t)HD * Layout<HD>::LDVT : (size_t)(S == kDQ ? 2 : 1) * kBK * Layout<HD>::LDV * 2;
}

template <int HD, int S>
constexpr size_t smem_bytes(int rows, int nwarps) {
  return q_bytes<HD, S>(rows) + 2 * kBK * Layout<HD>::LDQ + 2 * kBK * HD + aux_bytes<HD, S>() +
         ((size_t)rows + 4 * kBK + (size_t)nwarps * HD) * sizeof(float);
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

template <int HD, int S>
__device__ __forceinline__ void seg_attn_q8_body(const Args& a) {
  constexpr int LDQ = Layout<HD>::LDQ;
  constexpr int LDV = Layout<HD>::LDV;
  constexpr int LDVT = Layout<HD>::LDVT;
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

  unsigned char* p = smem;
  int8_t* sQ = reinterpret_cast<int8_t*>(p);                 // sage: [rows][LDQ]
  __nv_bfloat16* sQb = reinterpret_cast<__nv_bfloat16*>(p);  // dq: [rows][LDV]
  p += q_bytes<HD, S>(rows);
  int8_t* sK = reinterpret_cast<int8_t*>(p);  // [2][kBK][LDQ]
  p += 2 * kBK * LDQ;
  int8_t* sV8 = reinterpret_cast<int8_t*>(p);  // [2][kBK][HD]
  p += 2 * kBK * HD;
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(p);  // dq: [kBK][LDV]
  int8_t* sVt = reinterpret_cast<int8_t*>(p);               // sage: [HD][LDVT], tokens permuted
  __nv_bfloat16* sKb = sV + kBK * LDV;                      // dq: [kBK][LDV]
  p += aux_bytes<HD, S>();
  float* sQs = reinterpret_cast<float*>(p);  // [rows]
  float* sSk = sQs + rows;                   // [2][kBK]
  float* sSv = sSk + 2 * kBK;                // [2][kBK]
  float* sRow = sSv + 2 * kBK;               // [nwarps][HD]

  const int lo0 = max(a.src[0].start[seg], 0);
  const int hi0 = min(a.src[0].end[seg], a.src[0].len);
  const int lo1 = max(a.src[1].start[seg], 0);
  const int hi1 = min(a.src[1].end[seg], a.src[1].len);
  // tiles aligned to kBK within each source, as the plain versions walk them
  const int base0 = lo0 / kBK * kBK;  // first tile's first token
  const int base1 = lo1 / kBK * kBK;
  const int n0 = hi0 > lo0 ? (hi0 - base0 + kBK - 1) / kBK : 0;
  const int n1 = hi1 > lo1 ? (hi1 - base1 + kBK - 1) / kBK : 0;
  const int total = n0 + n1;

  // tile j: first token t0, attended tokens [lo, hi) of its source
  auto tile_range = [&](int j, int& t0, int& lo, int& hi) {
    const bool first = j < n0;
    t0 = first ? base0 + j * kBK : base1 + (j - n0) * kBK;
    lo = first ? lo0 : lo1;
    hi = first ? hi0 : hi1;
  };

  auto load_tile = [&](int j, int buf) {
    int t0, lo, hi;
    tile_range(j, t0, lo, hi);
    const bool first = j < n0;
    const int len = first ? a.src[0].len : a.src[1].len;
    const int8_t* kb = (first ? a.src[0].kv : a.src[1].kv) + (long long)kvh * len * HD;
    const int8_t* vb = kb + (long long)a.hk * len * HD;
    const float* skb = (first ? a.src[0].sc : a.src[1].sc) + (long long)kvh * len;
    const float* svb = skb + (long long)a.hk * len;
    // tokens past the range end are zero-filled, never read; those before
    // the range start (an aligned tile) lie in the source and are masked
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

  // ---- q prologue: LN (+ rotary), then per-row int8 (bf16 for dq) ------
  for (int R = warp; R < rows; R += nwarps) {
    const int j = R / kBQ;
    const int tok_in_seg = qt * kBQ + (R % kBQ);
    if (tok_in_seg >= a.seg_len) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        if (S == kDQ) {
          sQb[R * LDV + lane * EPT + i] = __float2bfloat16(0.f);
        } else {
          sQ[R * LDQ + lane * EPT + i] = 0;
        }
      }
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
    if (S == kDQ) {
#pragma unroll
      for (int i = 0; i < EPT; ++i) sQb[R * LDV + lane * EPT + i] = __float2bfloat16(x[i]);
      continue;
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) amax = fmaxf(amax, fabsf(x[i]));
    const float sq = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.f / 127.f);
    const float r = __fdiv_rn(1.f, sq);
#pragma unroll
    for (int i = 0; i < EPT; ++i) sQ[R * LDQ + lane * EPT + i] = (int8_t)quant_mul(x[i], r);
    if (lane == 0) sQs[R] = __fmul_rn(sq, a.scale);
  }
  __syncthreads();

  // ---- flash loop over kv tiles ----------------------------------------
  const int R0 = warp * 16;  // this warp's first q row in sQ
  const int g = lane >> 2, tig = lane & 3;
  const float sq_row[2] = {S == kDQ ? 0.f : sQs[R0 + g], S == kDQ ? 0.f : sQs[R0 + g + 8]};  // dq: unused
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

    if (S == kSage) {
      // v tile -> v8^T [d][kappa]: within each 32-token group, kappa = 16h +
      // 4t + 2b + j holds token tau = 16h + 8b + 2t + j (the column order
      // of the q.k accumulators, see the p.v product below)
      for (int c = threadIdx.x; c < HD * (kBK / 4); c += blockDim.x) {
        const int d = c % HD;
        const int k0 = (c / HD) * 4;
        const int grp = k0 & ~31, h = (k0 >> 4) & 1, t = (k0 >> 2) & 3;
        const int8_t* col = sV8 + buf * kBK * HD + d;
        int e[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) e[jj] = col[(grp + 16 * h + 8 * (jj >> 1) + 2 * t + (jj & 1)) * HD];
        *reinterpret_cast<uint32_t*>(sVt + d * LDVT + k0) = pack_s8x4(e[0], e[1], e[2], e[3]);
      }
    } else {
      // v tile (and dq's k tile): int8 -> bf16 (exact)
      for (int c = threadIdx.x; c < (S == kDQ ? 2 : 1) * kBK * CPR; c += blockDim.x) {
        const bool is_k = c >= kBK * CPR;
        const int cc = is_k ? c - kBK * CPR : c;
        const int r = cc / CPR;
        const int col = (cc % CPR) * 16;
        const int8_t* srcp = is_k ? Kt + r * LDQ + col : sV8 + (buf * kBK + r) * HD + col;
        const int4 raw = *reinterpret_cast<const int4*>(srcp);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = pack_bf16((float)b[2 * e], (float)b[2 * e + 1]);
        uint4* d = reinterpret_cast<uint4*>((is_k ? sKb : sV) + r * LDV + col);
        d[0] = make_uint4(w[0], w[1], w[2], w[3]);
        d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
    if (S == kDQ) __syncthreads();  // the bf16 k tile is complete

    int t0, lo, hi;
    tile_range(jt, t0, lo, hi);
    const int valid_lo = lo - t0, valid_hi = hi - t0;
    float s[kBK / 8][4];
    if (S == kDQ) {
      // S = q k^T in bf16, f32 accumulate; s = S * (sk_token * scale)
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t qa[4];
        ldsm_x4(qa, sQb + (R0 + (lane & 15)) * LDV + kk + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < kBK / 16; ++n2) {
          const int m = lane >> 3, i = lane & 7;
          uint32_t kb[4];
          ldsm_x4(kb, sKb + (n2 * 16 + i + (m >> 1) * 8) * LDV + kk + (m & 1) * 8);
          mma16816(s[2 * n2], qa, kb[0], kb[1]);
          mma16816(s[2 * n2 + 1], qa, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int c = nt * 8 + tig * 2;
        const float f0 = __fmul_rn(Skt[c], a.scale), f1 = __fmul_rn(Skt[c + 1], a.scale);
        s[nt][0] = __fmul_rn(s[nt][0], f0);
        s[nt][1] = __fmul_rn(s[nt][1], f1);
        s[nt][2] = __fmul_rn(s[nt][2], f0);
        s[nt][3] = __fmul_rn(s[nt][3], f1);
      }
    } else {
      // S = q8 k8^T (int32, exact); s = (S * sq_row) * sk_token
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
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int c = nt * 8 + tig * 2;
        const float sk0 = Skt[c], sk1 = Skt[c + 1];
        s[nt][0] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][0]), sq_row[0]), sk0);
        s[nt][1] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][1]), sq_row[0]), sk1);
        s[nt][2] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][2]), sq_row[1]), sk0);
        s[nt][3] = __fmul_rn(__fmul_rn(__int2float_rn(s32[nt][3]), sq_row[1]), sk1);
      }
    }
    // mask the columns outside [lo, hi)
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const int c = nt * 8 + tig * 2;
      if (c < valid_lo || c >= valid_hi) s[nt][0] = s[nt][2] = -CUDART_INF_F;
      if (c + 1 < valid_lo || c + 1 >= valid_hi) s[nt][1] = s[nt][3] = -CUDART_INF_F;
    }

    // online softmax (exp2 domain)
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
    if (S != kDQ) __syncthreads();  // the rewritten v tile is complete

    if (S == kSage) {
      // p requantized per row against the tile's row max of p * sv
      float pmax[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int c = nt * 8 + tig * 2;
        const float v0 = Svt[c], v1 = Svt[c + 1];
        s[nt][0] = __fmul_rn(s[nt][0], v0);
        s[nt][1] = __fmul_rn(s[nt][1], v1);
        s[nt][2] = __fmul_rn(s[nt][2], v0);
        s[nt][3] = __fmul_rn(s[nt][3], v1);
        pmax[0] = fmaxf(pmax[0], fmaxf(s[nt][0], s[nt][1]));
        pmax[1] = fmaxf(pmax[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float sp[2], rp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pmax[r] = fmaxf(pmax[r], __shfl_xor_sync(0xffffffffu, pmax[r], 1));
        pmax[r] = fmaxf(pmax[r], __shfl_xor_sync(0xffffffffu, pmax[r], 2));
        sp[r] = __fmul_rn(fmaxf(pmax[r], 1e-20f), 1.f / 127.f);
        rp[r] = __fdiv_rn(1.f, sp[r]);
      }
      // p8 as the A operand of m16n8k32: for each 32-token half kc, A's
      // k index 4t + 2b + j holds the accumulator column 8b + 2t + j of n8
      // tile 4kc (b = 0) or 4kc + 1 (b = 1), and 16 + 4t + 2b + j that of
      // tile 4kc + 2 + b; v8^T stores its tokens in the same order
      uint32_t pa[kBK / 32][4];
#pragma unroll
      for (int kc = 0; kc < kBK / 32; ++kc) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* s0 = s[4 * kc + 2 * hh];
          const float* s1 = s[4 * kc + 2 * hh + 1];
          pa[kc][2 * hh] = pack_s8x4(__float2int_rn(__fmul_rn(s0[0], rp[0])), __float2int_rn(__fmul_rn(s0[1], rp[0])),
                                     __float2int_rn(__fmul_rn(s1[0], rp[0])), __float2int_rn(__fmul_rn(s1[1], rp[0])));
          pa[kc][2 * hh + 1] =
              pack_s8x4(__float2int_rn(__fmul_rn(s0[2], rp[1])), __float2int_rn(__fmul_rn(s0[3], rp[1])),
                        __float2int_rn(__fmul_rn(s1[2], rp[1])), __float2int_rn(__fmul_rn(s1[3], rp[1])));
        }
      }
      // O = O * alpha + (P8 V8)_int32 * sp, each d pair of n8 tiles in turn
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kc = 0; kc < kBK / 32; ++kc) {
          const int m = lane >> 3, i = lane & 7;
          uint32_t vb[4];
          ldsm_x4(vb, sVt + (d2 * 16 + i + (m >> 1) * 8) * LDVT + kc * 32 + (m & 1) * 16);
          mma16832_s8(acc0, pa[kc], vb[0], vb[1]);
          mma16832_s8(acc1, pa[kc], vb[2], vb[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          o[2 * d2][e] = __fadd_rn(__fmul_rn(o[2 * d2][e], alpha[r]), __fmul_rn(__int2float_rn(acc0[e]), sp[r]));
          o[2 * d2 + 1][e] =
              __fadd_rn(__fmul_rn(o[2 * d2 + 1][e], alpha[r]), __fmul_rn(__int2float_rn(acc1[e]), sp[r]));
        }
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
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
    }
    __syncthreads();  // the next iteration overwrites this buffer and the rewritten tiles
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

// one symbol per scheme, so a trace reads them apart
template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_q8_sage_kernel(const __grid_constant__ Args a) {
  seg_attn_q8_body<HD, kSage>(a);
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads, 1) seg_attn_q8_dq_kernel(const __grid_constant__ Args a) {
  seg_attn_q8_body<HD, kDQ>(a);
}

template <int HD, int S, typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int n_seg, cudaStream_t stream) {
  const int rows = kBQ * a.heads_per_block;
  const int threads = 32 * kWarpsPerHead * a.heads_per_block;
  const size_t smem = smem_bytes<HD, S>(rows, threads / 32);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seg_len + kBQ - 1) / kBQ, a.hq / a.heads_per_block, n_seg);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_scheme(int scheme, const Args& a, int n_seg, cudaStream_t stream) {
  if (scheme == kSage) return launch<HD, kSage>(seg_attn_q8_sage_kernel<HD>, a, n_seg, stream);
  if (scheme == kDQ) return launch<HD, kDQ>(seg_attn_q8_dq_kernel<HD>, a, n_seg, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: [n_seg*seg_len, hq, hd] bf16; kv1, kv2: [2, hk, len, hd] int8;
// sc1, sc2: [2, hk, len] f32; qw, qb: [hd] f32 or null; sin, cos:
// [n_seg*seg_len, rot] f32 or null; scale = sm_scale * log2(e); scheme 0
// 1 sage, 2 dq
int magi_seg_attn_two_source_q8(const void* q, void* out, const void* kv1, const float* sc1, long long kv1_len,
                                const void* kv2, const float* sc2, long long kv2_len, const int* r1s, const int* r1e,
                                const int* r2s, const int* r2e, const float* qw, const float* qb, const float* sin,
                                const float* cos, int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps,
                                float scale, int scheme, void* stream) {
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
  if (hd == 128) return (int)launch_scheme<128>(scheme, a, n_seg, st);
  if (hd == 64) return (int)launch_scheme<64>(scheme, a, n_seg, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
