// Two-source segmented flash attention for Hopper (sm_90a) on TMA and
// wgmma: one kernel body, two `__global__` kernels (one per Pallas kernel
// it replaces, so a trace names each), two C entry points.
//
// Replaces:
//   seg_attn_two_source_kernel (K1) -> magi_tpu/ops/attention.py:1122
//       segmented_attention_two_source -> pallas_call :1241
//       (_seg_attn_kernel_two_source :850, _q_prologue :323, _o_epilogue
//       :371): the DiT self-attention over the read-only bf16 KV cache and
//       the current window's kv; C entry magi_seg_attn_two_source.
//   seg_attn_q8_kernel (K5, scheme qk8) -> magi_tpu/ops/attention_q8.py:494
//       segmented_attention_two_source_q8 -> pallas_call :631
//       (_seg_attn_kernel_two_source_q8 :125, _q_prologue_q8 :89): the same
//       over the int8-stored cache and the current window's int8 kv, and
//       (source 2 empty) the int8 caption cross-attention; C entry
//       magi_seg_attn_two_source_qk8.  K5's sage and dq schemes are in
//       csrc/attention_q8.cu.
//
// Semantics.  q is token-major [n_seg * seg_len, hq, 128] bf16.  Segment i
// attends tokens [r1s[i], r1e[i]) of source 1, then [r2s[i], r2e[i]) of
// source 2, each range clipped to its source's length.  A source is k and v
// [2, hk, len, 128], any strides with a contiguous last dimension (bf16
// for K1; int8 for qk8, with f32 per-token scales [2, hk, len], k scales
// then v scales).  A segment with empty ranges outputs 0.  GQA: q head h
// reads kv head h / (hq / hk).  The optional q prologue: fp32 LayerNorm of
// each q row (K1: (w, b) already scaled by sm_scale * log2(e) in the
// wrapper), then GPT-NeoX rotary on the first 2 * rot dims (rot = 48 on
// the DiT); without it K1 scales q by sm_scale * log2(e).  K1 casts q to
// bf16.  qk8 quantizes each q row (token, head) to int8: sq = max(amax,
// 1e-8) * (1 / 127), q8 = round(q * (1 / sq)); its logits are ((q8 .
// k8)_int32 * (sq * sm_scale * log2e)) * sk_token, in that order, as the
// plain version multiplies; p times the token's v scale is cast to bf16
// and multiplies the int8 v cast to bf16 (exact).  The softmax runs in the
// exp2 domain, online (flash attention), normalised once at the end.
// Values of a source outside the attended ranges must be finite, as the
// plain versions need them (a p of 0 times an infinite v is NaN); qk8's
// scales outside the ranges are never read.
//
// What bounds it on the H100.  At the main path's shapes (segments of
// 1536 tokens at 256x256 and 12150 at 720x720, kv spans of 1 to 5 chunks)
// the operations: K1's q.k and p.v at the bf16 rate (989 TFLOP/s); qk8's
// q.k at the int8 rate (1979 TOP/s) and p.v at the bf16 rate.  Besides
// the tensor cores, the softmax: one exp2 per logit on the SFU, which
// does a sixteenth of the bf16 tensor rate's logits per clock at
// head_dim 128 (half the products' time), and for qk8 about twice K1's
// f32 operations per logit (dequant, the v scale), which makes the issue
// slots its limit.
//
// Design (the producer/consumer shape of FlashAttention-3's forward
// kernel).  One block per (64 q tokens, the `heads` <= 3 q heads that
// share one kv head, segment), so each kv tile is loaded once for all of
// them; the blocks of the segments that attend the most tokens come first,
// so the last wave is not one long segment.  Warpgroups `heads`.. are the
// producers: one thread issues TMA loads of the 64-token k and v tiles of
// both sources into a ring of 4 stages (full and empty mbarriers); a 4-D
// tensor map per source over (dim, token, kv head, k|v) takes the view's
// strides and fills tokens past the source's end with zeros, so no read
// leaves the source.  Tiles start at the range start; the tokens of a
// tile past the range end are real tokens of the source (the cache beyond
// the clean chunks, or the next segment's span), and their logits are set
// to -inf, their p to exactly 0.  For qk8 a second producer warpgroup
// joins, and seven warps load each tile's k and v scales (4 bytes each: a
// scale row need not be 16-byte aligned, which TMA needs; 0 outside the
// range; the next tile's while this one is converted) and convert the
// int8 v tile to bf16 in shared memory (a byte permute and a subtraction,
// exact), fence the async proxy and arrive on a third mbarrier.  Each
// other warpgroup is a consumer that owns one q head: it stages its 64 q
// rows once (the prologue) in the 128-byte-swizzled K-major layout wgmma
// reads, then per tile runs S = Q K^T on wgmma (bf16 m64n64k16, or int8
// m64n64k32 with exact int32 sums: an int8 row of 128 is one swizzle
// atom), the online softmax in registers (exp2 on the SFU, tree
// reductions), and O += P V with P converted to bf16 in registers as
// wgmma's A operand and V read transposed (MN-major) from shared memory
// (bf16 m64n128k16).  In K1, P V of one tile runs on while the consumer
// waits for the next and issues its Q K^T.  The three consumers share the tensor
// cores and overlap one another's softmax.  setmaxnreg moves registers
// from the producers (K1 32, qk8 48) to the consumers (K1 160, qk8 128).
// Tried and dropped (slower at the main path's shapes): two consumers per
// block of one q head with the softmax of each tile overlapping the
// previous tile's P V (FlashAttention-3's intra-warpgroup pipelining; it
// needs registers for two tiles, and with two consumers each kv tile is
// read from L2 for 128 q rows instead of 192), 128-token kv tiles, and
// consumers taking turns at the tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "ptx.cuh"
#include "tmap.cuh"

namespace {

using namespace magi;

constexpr int kHD = 128;      // head_dim
constexpr int kBQ = 64;       // q tokens per block: one wgmma M
constexpr int kBK = 64;       // kv tokens per tile
constexpr int kMaxHeads = 3;  // consumer warpgroups, one q head each
constexpr int kStages = 4;

// Producer warpgroups: warp 0 issues the TMA loads; for qk8 the other
// warps (7 of them) convert the v tiles.  setmaxnreg moves registers
// within the block's own allocation (the launch's per-thread count, which
// ptxas sets from the thread bound), so the consumers' and producers'
// counts must fit in it.
template <bool Q8>
struct Cfg {
  static constexpr int kProducers = Q8 ? 2 : 1;
  static constexpr int kMaxThreads = 128 * (kMaxHeads + kProducers);
  static constexpr int kLaunchRegs = 65536 / kMaxThreads / 8 * 8;  // 128 (K1), 96 (qk8)
  static constexpr int kConverters = 4 * kProducers - 1;            // converter warps (qk8)
  static constexpr int kConsumerRegs = Q8 ? 128 : 160;
  static constexpr int kProducerRegs = Q8 ? 48 : 32;
  static_assert(kMaxHeads * kConsumerRegs + kProducers * kProducerRegs <= (kMaxHeads + kProducers) * kLaunchRegs,
                "the block's registers");
};

// shared memory, region by region (the tiles 1024-byte aligned)
template <bool Q8>
struct Smem {
  static constexpr int kQ = Q8 ? kBQ * kHD : kBQ * kHD * 2;  // one head's q tile
  static constexpr int kK = Q8 ? kBK * kHD : kBK * kHD * 2;  // a k tile, and a v tile, as loaded
  static constexpr int kVb = Q8 ? kBK * kHD * 2 : 0;         // qk8: the v tile in bf16
  static constexpr int kSc = Q8 ? 2 * kBK : 0;               // qk8: the tile's k and v scales (floats)
  static size_t bytes(int heads) {
    return 1024 + (size_t)heads * kQ + (size_t)kStages * (2 * kK + kVb + kSc * 4) + (size_t)heads * 4 * kHD * 4 +
           3 * kStages * 8;
  }
};

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  const int* start0;  // [n_seg] ranges of source 1, then source 2
  const int* end0;
  const int* start1;
  const int* end1;
  int len0, len1;
  const float* sc0;  // qk8: [2, hk, len] scales, token-contiguous
  const float* sc1;
  long long sc_head0, sc_kv0, sc_head1, sc_kv1;  // their head and k|v strides (elements)
  const float* qw;  // [hd] q LayerNorm weight (K1: times sm_scale*log2e), or nullptr (no prologue)
  const float* qb;
  const float* sin;  // [n_seg*seg_len, rot] or nullptr (no rotary)
  const float* cos;
  int n_seg, seg_len, hq, q_per_kv, heads, rot;
  float eps, scale;  // scale = sm_scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool Q8>
__device__ __forceinline__ void seg_attn_tma_body(const CUtensorMap* tm0, const CUtensorMap* tm1, const Args& a) {
  using L = Smem<Q8>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_seg;
  uint8_t* sQ = align1024(smem_raw);     // [heads][kQ]
  uint8_t* sK = sQ + a.heads * L::kQ;    // [stage][kK]
  uint8_t* sV = sK + kStages * L::kK;    // [stage][kK]
  uint8_t* sVb = sV + kStages * L::kK;   // qk8: [stage][kVb]
  float* sSc = reinterpret_cast<float*>(sVb + kStages * L::kVb);  // qk8: [stage][k | v][kBK]
  float* sRow = sSc + kStages * L::kSc;                           // [consumer warp][kHD]
  uint64_t* full = reinterpret_cast<uint64_t*>(sRow + a.heads * 4 * kHD);
  uint64_t* empty = full + kStages;
  uint64_t* vready = empty + kStages;

  // block -> (segment rank, head group, q tile): the q tiles of one head
  // group are neighbours, so the blocks in flight share their kv in L2
  const int n_qt = (a.seg_len + kBQ - 1) / kBQ;
  const int n_hg = a.hq / a.heads;
  const int rank = blockIdx.x / (n_qt * n_hg);
  const int rem = blockIdx.x - rank * n_qt * n_hg;
  const int hg = rem / n_qt, qt = rem - hg * n_qt;

  // the segment of that rank when segments are ordered by attended tokens,
  // most first (ties by index)
  auto work = [&](int i) {
    return max(min(a.end0[i], a.len0) - max(a.start0[i], 0), 0) + max(min(a.end1[i], a.len1) - max(a.start1[i], 0), 0);
  };
  for (int i = threadIdx.x; i < a.n_seg; i += blockDim.x) {
    const int wi = work(i);
    int r = 0;
    for (int j = 0; j < a.n_seg; ++j) {
      const int wj = work(j);
      r += wj > wi || (wj == wi && j < i);
    }
    if (r == rank) s_seg = i;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * a.heads);
      mbar_init(&vready[s], Cfg<Q8>::kConverters);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int seg = s_seg;

  const int lo0 = max(a.start0[seg], 0), hi0 = min(a.end0[seg], a.len0);
  const int lo1 = max(a.start1[seg], 0), hi1 = min(a.end1[seg], a.len1);
  const int n0 = hi0 > lo0 ? (hi0 - lo0 + kBK - 1) / kBK : 0;
  const int n1 = hi1 > lo1 ? (hi1 - lo1 + kBK - 1) / kBK : 0;
  const int total = n0 + n1;
  const int head0 = hg * a.heads;
  const int kvh = head0 / a.q_per_kv;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (wg >= a.heads) {
    // ---- producer warpgroup ----------------------------------------------
    setmaxnreg_dec<Cfg<Q8>::kProducerRegs>();
    if (threadIdx.x < 128 * a.heads + 32) {
      if (lane == 0 && total > 0) {
        if (n0) tma_prefetch_desc(tm0);
        if (n1) tma_prefetch_desc(tm1);
        int stage = 0;
        uint32_t phase = 0;
        for (int j = 0; j < total; ++j) {
          const bool first = j < n0;
          const int t0 = first ? lo0 + j * kBK : lo1 + (j - n0) * kBK;
          const CUtensorMap* tm = first ? tm0 : tm1;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * L::kK);
          uint8_t* k = sK + stage * L::kK;
          uint8_t* v = sV + stage * L::kK;
          if (Q8) {  // a row of 128 int8 is one 128-byte swizzle atom
            tma_load_4d(k, tm, &full[stage], 0, t0, kvh, 0);
            tma_load_4d(v, tm, &full[stage], 0, t0, kvh, 1);
          } else {  // two column blocks of 64 bf16
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              tma_load_4d(k + c * 8192, tm, &full[stage], 64 * c, t0, kvh, 0);
              tma_load_4d(v + c * 8192, tm, &full[stage], 64 * c, t0, kvh, 1);
            }
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if constexpr (Q8) {
      // the other warps: the tile's scales, and its v tile in bf16.  The
      // scales of the next tile are loaded (from L2, hundreds of cycles)
      // while this one is converted.
      constexpr int NC = 32 * Cfg<Q8>::kConverters;  // converter threads
      constexpr int kSU = (2 * kBK + NC - 1) / NC;    // scales per thread
      constexpr int kCU = (kBK * 8 + NC - 1) / NC;    // 16-byte v chunks per thread
      const int ct = threadIdx.x - 128 * a.heads - 32;  // 0 .. NC - 1
      auto load_scales = [&](int j, float (&val)[kSU]) {
        const bool first = j < n0;
        const int t0 = first ? lo0 + j * kBK : lo1 + (j - n0) * kBK;
        const int hi = first ? hi0 : hi1;
        const float* sc = first ? a.sc0 + kvh * a.sc_head0 : a.sc1 + kvh * a.sc_head1;
        const long long kv_stride = first ? a.sc_kv0 : a.sc_kv1;
#pragma unroll
        for (int u = 0; u < kSU; ++u) {  // entries ct, ct + NC, ... of [k | v][kBK]
          const int c = ct + NC * u;
          const int tok = t0 + (c & (kBK - 1));
          val[u] = c < 2 * kBK && tok < hi ? sc[(c >= kBK ? kv_stride : 0) + tok] : 0.f;
        }
      };
      float next[kSU];
      if (total > 0) load_scales(0, next);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < total; ++j) {
        float val[kSU];
#pragma unroll
        for (int u = 0; u < kSU; ++u) val[u] = next[u];
        if (j + 1 < total) load_scales(j + 1, next);
        mbar_wait(&full[stage], phase);  // the int8 tiles landed; the last users of this stage are done
#pragma unroll
        for (int u = 0; u < kSU; ++u)
          if (ct + NC * u < 2 * kBK) sSc[stage * L::kSc + ct + NC * u] = val[u];
        // v8 [token][128 B], 128-byte swizzle (16-byte chunk c of row r at
        // c ^ r % 8) -> bf16 [d / 64][token][128 B], the same swizzle; the
        // 16-byte chunks ct, ct + NC, ... (512 a tile), all loads in flight
        const uint8_t* v8 = sV + stage * L::kK;
        uint8_t* vb = sVb + stage * L::kVb;
        {
          uint4 w[kCU];
#pragma unroll
          for (int u = 0; u < kCU; ++u) {
            const int c = ct + NC * u, r = c >> 3, j8 = c & 7;
            if (c < kBK * 8) w[u] = *reinterpret_cast<const uint4*>(v8 + r * 128 + ((j8 ^ (r & 7)) << 4));
          }
#pragma unroll
          for (int u = 0; u < kCU; ++u) {
            const int c = ct + NC * u, r = c >> 3, j8 = c & 7;
            if (c >= kBK * 8) continue;
            uint8_t* dst = vb + (j8 >> 2) * 8192 + r * 128;
            const int cc = 2 * (j8 & 3);
            *reinterpret_cast<uint4*>(dst + ((cc ^ (r & 7)) << 4)) = make_uint4(
                i8x2_to_bf16x2(w[u].x), i8x2_to_bf16x2(w[u].x >> 16), i8x2_to_bf16x2(w[u].y), i8x2_to_bf16x2(w[u].y >> 16));
            *reinterpret_cast<uint4*>(dst + (((cc + 1) ^ (r & 7)) << 4)) = make_uint4(
                i8x2_to_bf16x2(w[u].z), i8x2_to_bf16x2(w[u].z >> 16), i8x2_to_bf16x2(w[u].w), i8x2_to_bf16x2(w[u].w >> 16));
          }
        }
        fence_proxy_async();  // the bf16 tile, visible to wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&vready[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup: q head head0 + wg -------------------------------
    setmaxnreg_inc<Cfg<Q8>::kConsumerRegs>();
    const int h = head0 + wg;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
    uint8_t* q_s = sQ + wg * L::kQ;
    float* row = sRow + (wg * 4 + warp) * kHD;

    // prologue: warp w stages rows 16 w .. 16 w + 15 (the rows it owns in
    // wgmma's accumulator layout); lane l holds dims 4 l .. 4 l + 3
    float sqr[2] = {0.f, 0.f};  // qk8: sq * scale of rows g and g + 8
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const int tok_in_seg = qt * kBQ + r;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (tok_in_seg < a.seg_len) {
        const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
        const uint2 raw = *reinterpret_cast<const uint2*>(a.q + (gtok * a.hq + h) * kHD + 4 * lane);
        const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        x[0] = x01.x, x[1] = x01.y, x[2] = x23.x, x[3] = x23.y;
        if (a.qw) {
          const float mean = warp_sum(x[0] + x[1] + x[2] + x[3]) / kHD;
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) v += (x[i] - mean) * (x[i] - mean);
          const float rstd = rsqrtf(warp_sum(v) / kHD + a.eps);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 4 * lane + i;
            x[i] = (x[i] - mean) * rstd * a.qw[d] + a.qb[d];
          }
          if (a.sin) {
#pragma unroll
            for (int i = 0; i < 4; ++i) row[4 * lane + i] = x[i];
            __syncwarp();
            const float* sn = a.sin + gtok * a.rot;
            const float* cs = a.cos + gtok * a.rot;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = 4 * lane + i;
              if (d < a.rot) {
                x[i] = row[d] * cs[d] - row[d + a.rot] * sn[d];
              } else if (d < 2 * a.rot) {
                const int e = d - a.rot;
                x[i] = row[e] * sn[e] + row[d] * cs[e];
              }
            }
            __syncwarp();
          }
        } else if (!Q8) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] *= a.scale;
        }
      }
      if (Q8) {
        const float amax = warp_max(fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3]))));
        const float sq = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
        const float rcp = __fdiv_rn(1.f, sq);
        const uint32_t b = (uint32_t)(quant_mul(x[0], rcp) & 0xff) | ((uint32_t)(quant_mul(x[1], rcp) & 0xff) << 8) |
                           ((uint32_t)(quant_mul(x[2], rcp) & 0xff) << 16) |
                           ((uint32_t)(quant_mul(x[3], rcp) & 0xff) << 24);
        // row r: 128 bytes, 16-byte chunk lane / 4 at (lane / 4) ^ r % 8
        *reinterpret_cast<uint32_t*>(q_s + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3)) = b;
        if (g == (rr & 7)) {
          if (rr < 8) {
            sqr[0] = __fmul_rn(sq, a.scale);
          } else {
            sqr[1] = __fmul_rn(sq, a.scale);
          }
        }
      } else {
        // dims 0-63 and 64-127 in two [64 rows][128 B] blocks; 16-byte chunk
        // (lane / 2) % 8 of row r at that ^ r % 8
        *reinterpret_cast<uint2*>(q_s + (lane >> 4) * 8192 + r * 128 + ((((lane >> 1) & 7) ^ (r & 7)) << 4) +
                                  8 * (lane & 1)) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
      }
    }
    fence_proxy_async();  // the q tile, visible to wgmma
    bar_sync(1 + wg, 128);

    // ---- flash loop over kv tiles -------------------------------------------
    // accumulators: thread (warp w, g, tq) holds rows 16 w + g + 8 i and
    // columns 8 j + 2 tq + c in [4 j + 2 i + c]
    using Acc = typename std::conditional<Q8, int, float>::type;
    Acc sacc[32];  // Q K^T of the current tile
    float s[32];   // its logits, then p
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    uint32_t pa[kBK / 16][4];  // P, wgmma's A operand
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
    float alpha[2] = {0.f, 0.f};  // rescale of O for the tile of pa (the first: O is 0)
    const uint64_t dq = wgmma_desc_sw128(q_s);

    // S = Q K^T of the tile in stage st: issued and committed, not waited
    auto issue_qk = [&](int st) {
      const uint64_t dk = wgmma_desc_sw128(sK + st * L::kK);
      wgmma_fence();
      if constexpr (Q8) {
        wgmma_s8_m64n64k32<false>(sacc, dq, dk);
#pragma unroll
        for (int kk = 1; kk < kHD / 32; ++kk) wgmma_s8_m64n64k32<true>(sacc, dq + 2 * kk, dk + 2 * kk);
      } else {
        wgmma_bf16_m64n64k16<false>(sacc, dq, dk);
#pragma unroll
        for (int kk = 1; kk < kHD / 16; ++kk) {
          const int off = (kk >> 2) * (8192 >> 4) + 2 * (kk & 3);
          wgmma_bf16_m64n64k16<true>(sacc, dq + off, dk + off);
        }
      }
      wgmma_commit();
      wgmma_hold(sacc);
    };

    // O = O * alpha + P V of the tile in stage st (V [token][dim] read
    // transposed: dims 0-63 and 64-127 in blocks 8 KB apart, 16 tokens or
    // 2 KB per k step): issued and committed, not waited
    auto issue_pv = [&](int st) {
      // qk8 skips it when no row of the warp has a new maximum (measured
      // faster for qk8, slower for K1)
      if (!Q8 || !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int jj = 0; jj < kHD / 8; ++jj) {
          o[4 * jj + 0] *= alpha[0];
          o[4 * jj + 1] *= alpha[0];
          o[4 * jj + 2] *= alpha[1];
          o[4 * jj + 3] *= alpha[1];
        }
      }
      const uint64_t dv = wgmma_desc_mn_sw128(Q8 ? sVb + st * L::kVb : sV + st * L::kK, 8192);
      wgmma_hold(o);
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < kBK / 16; ++k2) wgmma_bf16_m64n128k16_rs(o, pa[k2], dv + k2 * (2048 >> 4));
      wgmma_commit();
      wgmma_hold(o);
    };

    // the online softmax of the tile in stage st (its products waited),
    // whose first vc columns are attended: s = p, and the running max, sums
    // and alpha
    auto softmax = [&](int vc, int st, uint32_t ph) {
      if constexpr (Q8) {
        mbar_wait(&vready[st], ph);  // the scales and the bf16 v tile
        const float* sk = sSc + st * L::kSc;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * jj + 2 * tq);
          s[4 * jj + 0] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 0]), sqr[0]), k2.x);
          s[4 * jj + 1] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 1]), sqr[0]), k2.y);
          s[4 * jj + 2] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 2]), sqr[1]), k2.x);
          s[4 * jj + 3] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 3]), sqr[1]), k2.y);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = sacc[i];
      }
      // columns past the range end: -inf
      if (vc < kBK) {
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (8 * jj + 2 * tq + c >= vc) s[4 * jj + c] = s[4 * jj + 2 + c] = -CUDART_INF_F;
      }
      // exp2 domain: the logits carry sm_scale * log2e
      // row maxima and sums as trees (short dependency chains)
      float t[2][kBK / 8];
#pragma unroll
      for (int jj = 0; jj < kBK / 8; ++jj) {
        t[0][jj] = fmaxf(s[4 * jj], s[4 * jj + 1]);
        t[1][jj] = fmaxf(s[4 * jj + 2], s[4 * jj + 3]);
      }
#pragma unroll
      for (int w = kBK / 16; w >= 1; w >>= 1)
#pragma unroll
        for (int k = 0; k < w; ++k) {
          t[0][k] = fmaxf(t[0][k], t[0][k + w]);
          t[1][k] = fmaxf(t[1][k], t[1][k + w]);
        }
      float mx[2] = {fmaxf(m_run[0], t[0][0]), fmaxf(m_run[1], t[1][0])};
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        base[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];  // all-masked row: p = 0, not NaN
        alpha[i] = Q8 && mx[i] == m_run[i] ? 1.f : ex2(m_run[i] - base[i]);
        m_run[i] = mx[i];
      }
#pragma unroll
      for (int jj = 0; jj < kBK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * jj + e] = ex2(s[4 * jj + e] - base[e >> 1]);
        t[0][jj] = s[4 * jj] + s[4 * jj + 1];
        t[1][jj] = s[4 * jj + 2] + s[4 * jj + 3];
      }
#pragma unroll
      for (int w = kBK / 16; w >= 1; w >>= 1)
#pragma unroll
        for (int k = 0; k < w; ++k) {
          t[0][k] += t[0][k + w];
          t[1][k] += t[1][k + w];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + t[i][0];
    };

    // P of the tile in stage st as the A operand (qk8: p * sv, the v scale
    // folded in before the bf16 cast): k step k2 holds columns 16 k2 ..
    // 16 k2 + 15, the accumulators 8 k2 .. 8 k2 + 7 in pairs
    auto pack_p = [&](int st) {
      if constexpr (Q8) {
        const float* sv = sSc + st * L::kSc + kBK;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const float2 v2 = *reinterpret_cast<const float2*>(sv + 8 * jj + 2 * tq);
          s[4 * jj + 0] = __fmul_rn(s[4 * jj + 0], v2.x);
          s[4 * jj + 1] = __fmul_rn(s[4 * jj + 1], v2.y);
          s[4 * jj + 2] = __fmul_rn(s[4 * jj + 2], v2.x);
          s[4 * jj + 3] = __fmul_rn(s[4 * jj + 3], v2.y);
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < kBK / 16; ++k2)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[k2][e] = pack_bf16(s[8 * k2 + 2 * e], s[8 * k2 + 2 * e + 1]);
    };

    // K1 leaves P V of tile j running while the consumer waits for tile
    // j + 1 and issues its Q K^T: the two products run back to back on the
    // tensor cores, and one wait covers both.  qk8 waits for each product:
    // at its 128 registers a consumer cannot hold both in flight, and
    // ptxas would serialize them.  (Overlapping the softmax with P V as
    // well needs registers for two tiles, which three consumers do not
    // have.)
    constexpr bool kOverlap = !Q8;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int j = 0; j < total; ++j) {
      mbar_wait(&full[stage], phase);
      issue_qk(stage);
      wgmma_wait<0>();  // Q K^T of tile j (K1: and P V of tile j - 1)
      wgmma_hold(sacc);
      if (kOverlap) {
        wgmma_hold(o);
        if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
      }
      // attended columns (a tile starts at its range start or a whole tile
      // after it)
      softmax(j < n0 ? hi0 - lo0 - j * kBK : hi1 - lo1 - (j - n0) * kBK, stage, phase);
      pack_p(stage);
      issue_pv(stage);
      if (!kOverlap) {
        wgmma_wait<0>();
        wgmma_hold(o);
        if (lane == 0) mbar_arrive(&empty[stage]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (kOverlap) {
      wgmma_wait<0>();
      wgmma_hold(o);
      if (total > 0 && lane == 0) mbar_arrive(&empty[prev]);
    }

    // ---- epilogue: normalise and store token-major --------------------------
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 0.f : 1.f / l;
      const int tok_in_seg = qt * kBQ + 16 * warp + g + 8 * i;
      if (tok_in_seg >= a.seg_len) continue;
      const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
      __nv_bfloat16* dst = a.out + (gtok * a.hq + h) * kHD + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < kHD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
    }
  }
}

__global__ void __launch_bounds__(Cfg<false>::kMaxThreads, 1)
    seg_attn_two_source_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                               const __grid_constant__ Args a) {
  seg_attn_tma_body<false>(&tm0, &tm1, a);
}

__global__ void __launch_bounds__(Cfg<true>::kMaxThreads, 1)
    seg_attn_q8_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ Args a) {
  seg_attn_tma_body<true>(&tm0, &tm1, a);
}

// ---- host side -------------------------------------------------------------

// One source: k and v [2, hk, len, 128] at `base` with element strides
// (token, head, k|v) and a unit last stride.
struct Source {
  const void* base;
  long long len, tok_stride, head_stride, kv_stride;
};

// The 4-D tensor map (dim, token, kv head, k|v) of a source, cut in boxes of
// one 128-byte row (64 bf16 or 128 int8) by kBK tokens, 128-byte swizzle;
// tokens past `len` arrive as zeros.  Encoded on every launch: the current
// window's kv is a new tensor each forward, and a few microseconds of host
// time are nothing beside the kernel.
cudaError_t source_map(CUtensorMap* map, const Source& s, int hk, bool q8) {
  memset(map, 0, sizeof(*map));
  if (s.len <= 0) return cudaSuccess;  // never read
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int es = q8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)kHD, (cuuint64_t)s.len, (cuuint64_t)hk, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)(s.tok_stride * es), (cuuint64_t)(s.head_stride * es),
                                 (cuuint64_t)(s.kv_stride * es)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)kBK, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (fn(map, q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(s.base),
         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool Q8, typename Kernel>
cudaError_t launch(Kernel kernel, const Source& s0, const Source& s1, Args& a, int hk, int hd, cudaStream_t stream) {
  if (hd != kHD || hk <= 0 || a.hq % hk || a.seg_len <= 0) return cudaErrorInvalidValue;
  a.q_per_kv = a.hq / hk;
  a.heads = 1;  // the largest divisor of q_per_kv that fits one block
  for (int d = kMaxHeads; d >= 1; --d) {
    if (a.q_per_kv % d == 0) {
      a.heads = d;
      break;
    }
  }
  a.len0 = (int)s0.len;
  a.len1 = (int)s1.len;
  CUtensorMap tm0, tm1;
  cudaError_t err = source_map(&tm0, s0, hk, Q8);
  if (err == cudaSuccess) err = source_map(&tm1, s1, hk, Q8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<Q8>::bytes(kMaxHeads));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n_seg * ((a.seg_len + kBQ - 1) / kBQ) * (a.hq / a.heads);
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, 128 * (a.heads + Cfg<Q8>::kProducers), Smem<Q8>::bytes(a.heads), stream>>>(tm0, tm1, a);
  return cudaGetLastError();
}

void set_common(Args& a, const void* q, void* out, const int* r1s, const int* r1e, const int* r2s, const int* r2e,
                const float* qw, const float* qb, const float* sin, const float* cos, int n_seg, int seg_len, int hq,
                int rot, float eps, float scale) {
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.start0 = r1s;
  a.end0 = r1e;
  a.start1 = r2s;
  a.end1 = r2e;
  a.qw = qw;
  a.qb = qb;
  a.sin = sin;
  a.cos = cos;
  a.n_seg = n_seg;
  a.seg_len = seg_len;
  a.hq = hq;
  a.rot = rot;
  a.eps = eps;
  a.scale = scale;
}

}  // namespace

extern "C" {

// K1.  q, out: [n_seg*seg_len, hq, 128] bf16; kv1, kv2: [2, hk, len, 128]
// bf16 with element strides (token, head, k|v), 16-byte aligned; r*: [n_seg]
// int32; qw, qb: [128] f32 (times sm_scale*log2e) or null; sin, cos:
// [n_seg*seg_len, rot] f32 or null; scale = sm_scale * log2(e)
int magi_seg_attn_two_source(const void* q, void* out, const void* kv1, long long len1, long long ts1,
                             long long hs1, long long ks1, const void* kv2, long long len2, long long ts2,
                             long long hs2, long long ks2, const int* r1s, const int* r1e, const int* r2s,
                             const int* r2e, const float* qw, const float* qb, const float* sin, const float* cos,
                             int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps, float scale,
                             void* stream) {
  Args a = {};
  set_common(a, q, out, r1s, r1e, r2s, r2e, qw, qb, sin, cos, n_seg, seg_len, hq, rot, eps, scale);
  return (int)launch<false>(seg_attn_two_source_kernel, Source{kv1, len1, ts1, hs1, ks1},
                            Source{kv2, len2, ts2, hs2, ks2}, a, hk, hd, static_cast<cudaStream_t>(stream));
}

// K5 qk8.  As K1 with int8 kv1, kv2 and their f32 scales sc1, sc2 [2, hk,
// len], token-contiguous, with element strides (head, k|v); qw, qb: the
// plain LayerNorm affine
int magi_seg_attn_two_source_qk8(const void* q, void* out, const void* kv1, long long len1, long long ts1,
                                 long long hs1, long long ks1, const float* sc1, long long sch1, long long sck1,
                                 const void* kv2, long long len2, long long ts2, long long hs2, long long ks2,
                                 const float* sc2, long long sch2, long long sck2, const int* r1s, const int* r1e,
                                 const int* r2s, const int* r2e, const float* qw, const float* qb, const float* sin,
                                 const float* cos, int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps,
                                 float scale, void* stream) {
  Args a = {};
  set_common(a, q, out, r1s, r1e, r2s, r2e, qw, qb, sin, cos, n_seg, seg_len, hq, rot, eps, scale);
  a.sc0 = sc1;
  a.sc_head0 = sch1;
  a.sc_kv0 = sck1;
  a.sc1 = sc2;
  a.sc_head1 = sch2;
  a.sc_kv1 = sck2;
  return (int)launch<true>(seg_attn_q8_kernel, Source{kv1, len1, ts1, hs1, ks1}, Source{kv2, len2, ts2, hs2, ks2},
                           a, hk, hd, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
