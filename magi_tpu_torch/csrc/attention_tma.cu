// Two-source segmented flash attention for Hopper (sm_90a) on TMA and
// wgmma: one kernel body, four `__global__` kernels (one per Pallas kernel
// and scheme it replaces, so a trace names each), two C entry points.
//
// Replaces:
//   seg_attn_two_source_kernel (K1) -> magi_tpu/ops/attention.py:1122
//       segmented_attention_two_source -> pallas_call :1241
//       (_seg_attn_kernel_two_source :850, _q_prologue :323, _o_epilogue
//       :371): the DiT self-attention over the read-only bf16 KV cache and
//       the current window's kv; C entry magi_seg_attn_two_source.
//   seg_attn_q8_kernel, seg_attn_q8_sage_kernel, seg_attn_q8_dq_kernel
//       (K5, schemes qk8, sage, dq) -> magi_tpu/ops/attention_q8.py:494
//       segmented_attention_two_source_q8 -> pallas_call :631
//       (_seg_attn_kernel_two_source_q8 :125, _q_prologue_q8 :89; sage
//       :303-322, dq :217-245): the same over the int8-stored cache and the
//       current window's int8 kv, and (source 2 empty) the int8 caption
//       cross-attention; C entry magi_seg_attn_two_source_int8, whose
//       `scheme` argument picks the kernel.
//
// Semantics.  q is token-major [n_seg * seg_len, hq, 128] bf16.  Segment i
// attends tokens [r1s[i], r1e[i]) of source 1, then [r2s[i], r2e[i]) of
// source 2, each range clipped to its source's length.  A source is k and v
// [2, hk, len, 128], any strides with a contiguous last dimension (bf16
// for K1; int8 for K5, with f32 per-token scales [2, hk, len], k scales
// then v scales).  A segment with empty ranges outputs 0.  GQA: q head h
// reads kv head h / (hq / hk).  The optional q prologue: fp32 LayerNorm of
// each q row (K1: (w, b) scaled by sm_scale * log2(e) in f32 as the
// kernel reads them), then GPT-NeoX rotary on the first 2 * rot dims (rot = 48 on
// the DiT); without it K1 scales q by sm_scale * log2(e).  The softmax
// runs in the exp2 domain, online (flash attention), normalised once at
// the end.  The schemes:
//   * K1 casts q to bf16; bf16 q.k and p.v.
//   * qk8 quantizes each q row (token, head) to int8: sq = max(amax, 1e-8)
//     * (1 / 127), q8 = round(q * (1 / sq)); its logits are ((q8 .
//     k8)_int32 * (sq * sm_scale * log2e)) * sk_token, in that order, as
//     the plain version multiplies; p times the token's v scale is cast to
//     bf16 and multiplies the int8 v cast to bf16 (exact).
//   * sage (SageAttention): q and the logits as in qk8; per kv tile pv = p
//     * sv, requantized per row against the tile's row max: sp =
//     max(rowmax(pv), 1e-20) * (1 / 127), p8 = round(pv * (1 / sp)) (IEEE
//     reciprocal, half to even); p.v runs in int8: o = o * alpha +
//     f32((p8 . v8)_int32) * sp.
//   * dq: q stays bf16 after the prologue, without sm_scale * log2e; the
//     logits are (q . bf16(k8)) * (sk_token * sm_scale * log2e); p.v as in
//     qk8.
// p8 depends on the tile's columns and on the running max, so sage (and dq,
// whose plain version walks the same tiles) run tiles aligned to 64 tokens
// within each source, as the Pallas kernel's lo = start // block_k; K1 and
// qk8 start their tiles at the range start.  Values of a source outside
// the attended ranges must be finite, as the plain versions need them (a p
// of 0 times an infinite v is NaN); K5's scales outside the ranges are
// never read.
//
// What bounds it on the H100.  At the main path's shapes (segments of
// 1536 tokens at 256x256 and 12150 at 720x720, kv spans of 1 to 5 chunks)
// the operations: K1's q.k and p.v at the bf16 rate (989 TFLOP/s); qk8's
// q.k at the int8 rate (1979 TOP/s) and p.v at the bf16 rate; sage's both
// at the int8 rate (half K1's tensor time); dq's both at the bf16 rate, on
// half K1's kv bytes.  Besides the tensor cores, the softmax: one exp2 per
// logit on the SFU, which does a sixteenth of the bf16 tensor rate's
// logits per clock at head_dim 128 (half the products' time), and for K5
// about twice K1's f32 operations per logit (dequant, the v scale; sage's
// requantization adds three more), which makes the issue slots its limit.
//
// Design (the producer/consumer shape of FlashAttention-3's forward
// kernel).  One block per (64 q tokens, the `heads` <= 3 q heads that
// share one kv head, segment), so each kv tile is loaded once for all of
// them; the blocks of the segments that attend the most tokens come first,
// so the last wave is not one long segment.  Warpgroups `heads`.. are the
// producers: one thread issues TMA loads of the 64-token k and v tiles of
// both sources into a ring of stages (full and empty mbarriers); a 4-D
// tensor map per source over (dim, token, kv head, k|v) takes the view's
// strides and fills tokens past the source's end with zeros, so no read
// leaves the source.  The tokens of a tile outside the range (past its end;
// before its start in sage's and dq's first tile) are real tokens of the
// source (the cache beyond the clean chunks, or the next segment's span),
// and their logits are set to -inf, their p to exactly 0.  For K5 the
// producers' other warps (converters) load each tile's k and v scales (4
// bytes each: a scale row need not be 16-byte aligned, which TMA needs; 0
// outside the range; the next tile's while this one is converted), rewrite
// the int8 tiles in shared memory for the tensor cores, fence the async
// proxy and arrive on a third mbarrier:
//   * qk8: v to bf16 (byte permutes and f32 subtractions, exact);
//   * dq: k and v to bf16, k into the 128-byte-swizzled K-major layout that
//     K1's TMA writes, with two bitwise operations and a bf16x2
//     subtraction per pair of values (exact), which leaves each group of
//     4 dims in the order d0, d2, d1, d3: the q tile is written in that
//     order, and the epilogue swaps the output columns back with a shuffle;
//     dq multiplies its k scales by sm_scale * log2e;
//   * sage: v8 to the byte-transposed v8^T [dim][token] (8-bit wgmma
//     operands are K-major only, and ldmatrix cannot transpose bytes), 64
//     bytes a row in the 64-byte swizzle, as 4x4-byte blocks (four 4-byte
//     loads, a byte rotation and eight byte permutes, four 4-byte stores;
//     the rotation makes both loads and stores free of bank conflicts).
// Each other warpgroup is a consumer that owns one q head: it stages its 64
// q rows once (the prologue) in the 128-byte-swizzled K-major layout wgmma
// reads (int8 rows of 128 for qk8 and sage: one swizzle atom), then per
// tile runs S = Q K^T on wgmma (bf16 m64n64k16, or int8 m64n64k32 with
// exact int32 sums), the online softmax in registers (exp2 on the SFU,
// tree reductions) and the product with V:
//   * K1, qk8, dq: O += P V with P converted to bf16 in registers as
//     wgmma's A operand and V read transposed (MN-major) from shared memory
//     (bf16 m64n128k16).  In K1, P V of one tile runs on while the
//     consumer waits for the next and issues its Q K^T.
//   * sage: p8 packed from the softmax registers as the int8 A operand
//     (s8 m64n64k32, A from registers).  S's accumulator holds columns 2t,
//     2t + 1 of each 8-column group (t = lane % 4) where the A fragment
//     holds k indices 4t .. 4t + 3 and 16 + 4t .. of each 32, so v8^T
//     stores token 16h + 8b + 2t + j of each 32 at k index 16h + 4t + 2b +
//     j (the contraction index may be permuted when both operands follow
//     it) and p8 needs no shuffle.  P V runs as two n64 halves (dims 0-63,
//     64-127) into the int32 registers of S's accumulator (free once the
//     logits are in f32), each waited on and folded into O in f32: o =
//     fma(f32(pv32), sp, o * alpha).  64 tokens x 127^2 fits in int32 and
//     is exact in f32 below 2^24.
// The three consumers share the tensor cores and overlap one another's
// softmax.  setmaxnreg moves registers from the producers to the
// consumers: K1 160 / 32 and sage 152 / 40 with one producer warpgroup (3
// converter warps do sage's transposition, busy about half the time), qk8
// and dq 128 / 48 with two (7 converter warps: one kv tile's conversion to
// bf16 is 16 or 32 KB of stores).  The converters take one tile at a time,
// and sage's loop over its rounds is not unrolled, which keeps them inside
// their registers.  dq keeps 3 stages (4 stages of int8 and bf16 tiles and
// three bf16 q tiles pass 227 KB).
// Tried and dropped (slower at the main path's shapes): two consumers per
// block of one q head with the softmax of each tile overlapping the
// previous tile's P V (FlashAttention-3's intra-warpgroup pipelining; it
// needs registers for two tiles, and with two consumers each kv tile is
// read from L2 for 128 q rows instead of 192), 128-token kv tiles, and
// consumers taking turns at the tensor cores.  For sage: both P V halves
// in flight at once, consumers at 160 registers, integer-float
// conversions as f32 additions of 1.5 * 2^23; for dq: the f32 conversion
// of qk8, K1's overlap at 136 or 144 registers, and a third producer
// warpgroup (ptxas cannot fit the consumers' products into the 80
// registers of a 768-thread block).

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

// The phases of the per-phase clocks (ptx.cuh; magi_phase_clocks reads
// them), per kv tile, by lane 0 of every consumer and converter warp: 0
// the consumer's wait for the tile (for dq: converted), 1 Q K^T, 2 the
// wait for the converted tile (qk8, sage), 3 the softmax, 4 P V, 5 the
// converters' wait for the tile, 6 their scales and conversion; 7 counts
// the consumer warps' tiles, 8 the converter warps'.

constexpr int kHD = 128;      // head_dim
constexpr int kBQ = 64;       // q tokens per block: one wgmma M
constexpr int kBK = 64;       // kv tokens per tile
constexpr int kMaxHeads = 3;  // consumer warpgroups, one q head each

// the kernels; K5's values are the C entry's `scheme` argument
enum Scheme : int { kQK8 = 0, kSage = 1, kDQ = 2, kK1 = 3 };

// Producer warpgroups: warp 0 issues the TMA loads; for K5 the other
// warps convert the tiles.  setmaxnreg moves registers within the block's
// own allocation (the launch's per-thread count, which ptxas sets from the
// thread bound), so the consumers' and producers' counts must fit in it.
template <int S>
struct Cfg {
  static constexpr bool kInt8KV = S != kK1;                 // int8 k, v with per-token scales
  static constexpr bool kInt8Q = S == kQK8 || S == kSage;   // q quantized per row, int8 q.k
  static constexpr bool kAligned = S == kSage || S == kDQ;  // tiles aligned to kBK within each source
  static constexpr int kProducers = S == kQK8 || S == kDQ ? 2 : 1;
  static constexpr int kStages = S == kDQ ? 3 : 4;
  static constexpr int kMaxThreads = 128 * (kMaxHeads + kProducers);
  static constexpr int kLaunchRegs = 65536 / kMaxThreads / 8 * 8;  // 128 (one producer warpgroup), 96 (two)
  static constexpr int kConverters = 4 * kProducers - 1;            // converter warps (K5)
  static constexpr int kConsumerRegs = kProducers == 2 ? 128 : S == kSage ? 152 : 160;
  static constexpr int kProducerRegs = kProducers == 2 ? 48 : S == kSage ? 40 : 32;  // sage: the transposition's
  static_assert(kMaxHeads * kConsumerRegs + kProducers * kProducerRegs <= (kMaxHeads + kProducers) * kLaunchRegs,
                "the block's registers");
};

// shared memory, region by region (the tiles 1024-byte aligned)
template <int S>
struct Smem {
  static constexpr int kQ = Cfg<S>::kInt8Q ? kBQ * kHD : kBQ * kHD * 2;   // one head's q tile
  static constexpr int kK = Cfg<S>::kInt8KV ? kBK * kHD : kBK * kHD * 2;  // a k tile, and a v tile, as loaded
  static constexpr int kVc = S == kK1 ? 0 : S == kSage ? kBK * kHD : kBK * kHD * 2;  // v as converted: v8^T or bf16
  static constexpr int kKc = S == kDQ ? kBK * kHD * 2 : 0;                            // dq: k in bf16
  static constexpr int kSc = Cfg<S>::kInt8KV ? 2 * kBK : 0;  // K5: the tile's k and v scales (floats)
  static size_t bytes(int heads) {
    constexpr int st = Cfg<S>::kStages;
    return 1024 + (size_t)heads * kQ + (size_t)st * (2 * kK + kVc + kKc + kSc * 4) + (size_t)heads * 4 * kHD * 4 +
           3 * st * 8;
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
  const float* sc0;  // K5: [2, hk, len] scales, token-contiguous
  const float* sc1;
  long long sc_head0, sc_kv0, sc_head1, sc_kv1;  // their head and k|v strides (elements)
  const float* qw;  // [hd] q LayerNorm weight (K1 scales it by sm_scale*log2e), or nullptr (no prologue)
  const float* qb;
  const float* sin;  // [n_seg*seg_len, rot] or nullptr (no rotary)
  const float* cos;
  int n_seg, seg_len, hq, q_per_kv, heads, rot;
  float eps, scale;  // scale = sm_scale * log2(e)
};

// the int8 bytes at bits 0-7 and 16-23 of v -> bf16x2, exact: (128 + the
// low 7 bits) - (128, or 256 where the sign bit is set), all in bf16
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t v) {
  const uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (v & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(c));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int S>
__device__ __forceinline__ void seg_attn_tma_body(const CUtensorMap* tm0, const CUtensorMap* tm1, const Args& a) {
  using C = Cfg<S>;
  using L = Smem<S>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_seg;
  PHASE_SETUP;
  uint8_t* sQ = align1024(smem_raw);     // [heads][kQ]
  uint8_t* sK = sQ + a.heads * L::kQ;    // [stage][kK]
  uint8_t* sV = sK + kStages * L::kK;    // [stage][kK]
  uint8_t* sVc = sV + kStages * L::kK;   // K5: [stage][kVc]
  uint8_t* sKc = sVc + kStages * L::kVc;  // dq: [stage][kKc]
  float* sSc = reinterpret_cast<float*>(sKc + kStages * L::kKc);  // K5: [stage][k | v][kBK]
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
      mbar_init(&vready[s], C::kConverters);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int seg = s_seg;

  const int lo0 = max(a.start0[seg], 0), hi0 = min(a.end0[seg], a.len0);
  const int lo1 = max(a.start1[seg], 0), hi1 = min(a.end1[seg], a.len1);
  // each source's first tile starts at the range start, or (sage, dq) at
  // the kBK-aligned token at or before it
  const int b0 = C::kAligned ? lo0 / kBK * kBK : lo0;
  const int b1 = C::kAligned ? lo1 / kBK * kBK : lo1;
  const int n0 = hi0 > lo0 ? (hi0 - b0 + kBK - 1) / kBK : 0;
  const int n1 = hi1 > lo1 ? (hi1 - b1 + kBK - 1) / kBK : 0;
  const int total = n0 + n1;
  auto tile_start = [&](int j) { return j < n0 ? b0 + j * kBK : b1 + (j - n0) * kBK; };
  const int head0 = hg * a.heads;
  const int kvh = head0 / a.q_per_kv;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (wg >= a.heads) {
    // ---- producer warpgroup ----------------------------------------------
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x < 128 * a.heads + 32) {
      if (lane == 0 && total > 0) {
        if (n0) tma_prefetch_desc(tm0);
        if (n1) tma_prefetch_desc(tm1);
        int stage = 0;
        uint32_t phase = 0;
        for (int j = 0; j < total; ++j) {
          const int t0 = tile_start(j);
          const CUtensorMap* tm = j < n0 ? tm0 : tm1;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * L::kK);
          uint8_t* k = sK + stage * L::kK;
          uint8_t* v = sV + stage * L::kK;
          if (C::kInt8KV) {  // a row of 128 int8 is one 128-byte swizzle atom
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
    } else if constexpr (C::kInt8KV) {
      // the other warps: the tile's scales, and its tiles rewritten for the
      // tensor cores.  The scales of the next tile are loaded (from L2,
      // hundreds of cycles) while this one is converted.
      constexpr int NC = 32 * C::kConverters;        // converter threads
      constexpr int kSU = (2 * kBK + NC - 1) / NC;  // scales per thread
      const int ct = threadIdx.x - 128 * a.heads - 32;  // 0 .. NC - 1
      auto load_scales = [&](int j, float (&val)[kSU]) {
        const bool first = j < n0;
        const int t0 = tile_start(j);
        const int lo = first ? lo0 : lo1, hi = first ? hi0 : hi1;
        const float* sc = first ? a.sc0 + kvh * a.sc_head0 : a.sc1 + kvh * a.sc_head1;
        const long long kv_stride = first ? a.sc_kv0 : a.sc_kv1;
#pragma unroll
        for (int u = 0; u < kSU; ++u) {  // entries ct, ct + NC, ... of [k | v][kBK]
          const int c = ct + NC * u;
          const int tok = t0 + (c & (kBK - 1));
          val[u] = c < 2 * kBK && tok < hi && (!C::kAligned || tok >= lo) ? sc[(c >= kBK ? kv_stride : 0) + tok] : 0.f;
          if (S == kDQ && c < kBK) val[u] = __fmul_rn(val[u], a.scale);  // dq: sk * sm_scale * log2e
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
        PHASE_START(pt);
        if (j + 1 < total) load_scales(j + 1, next);
        mbar_wait(&full[stage], phase);  // the int8 tiles landed; the last users of this stage are done
        PHASE_END(5, pt);
#pragma unroll
        for (int u = 0; u < kSU; ++u)
          if (ct + NC * u < 2 * kBK) sSc[stage * L::kSc + ct + NC * u] = val[u];
        const uint8_t* v8 = sV + stage * L::kK;
        if constexpr (S == kSage) {
          // v8 [token][128 B], 128-byte swizzle (16-byte chunk c of row r at
          // c ^ r % 8) -> v8^T [d][64 B], 64-byte swizzle (16-byte chunk c of
          // row d at c ^ (d / 2) % 4, 8-row groups 512 bytes apart), token
          // 16h + 8b + 2t + j of each 32 at column 16h + 4t + 2b + j.  Unit c
          // (4 dims d0.., 4 columns 4t.. of chunk 2 kc + h): lanes take (t,
          // d0 % 32), and rotating the output rows by (d0 / 8) % 4 puts the
          // lanes' loads and stores in 32 different banks.
          constexpr int kTU = (kBK * kHD / 16 + NC - 1) / NC;
          uint8_t* vt = sVc + stage * L::kVc;
#pragma unroll 1
          for (int u = 0; u < kTU; ++u) {
            const int c = ct + NC * u;
            if (c >= kBK * kHD / 16) break;
            const int t = c & 3, dl = (c >> 2) & 7, wu = c >> 5;
            const int d0 = 32 * (wu & 3) + 4 * dl, h = (wu >> 2) & 1, kc = wu >> 3;
            const int tau = 32 * kc + 16 * h + 2 * t;  // tokens tau, tau + 1, tau + 8, tau + 9
            const int rot = (dl >> 1) & 3;
            auto ld = [&](int tok) {
              const uint32_t w =
                  *reinterpret_cast<const uint32_t*>(v8 + tok * 128 + ((((d0 >> 4) ^ (tok & 7)) << 4) | (d0 & 15)));
              return __funnelshift_r(w, w, 8 * rot);  // byte i: dim d0 + (i + rot) % 4
            };
            const uint32_t w0 = ld(tau), w1 = ld(tau + 1), w2 = ld(tau + 8), w3 = ld(tau + 9);
            const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
            const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
            const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
            const int ch = 2 * kc + h;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int d = d0 + ((s + rot) & 3);
              *reinterpret_cast<uint32_t*>(vt + (d >> 3) * 512 + (d & 7) * 64 + ((ch ^ ((d >> 1) & 3)) << 4) +
                                           4 * t) = out[s];
            }
          }
        } else {
          // int8 [token][128 B], 128-byte swizzle (16-byte chunk c of row r
          // at c ^ r % 8) -> bf16 [d / 64][token][128 B], the same swizzle:
          // qk8's v, and dq's k then v (a tile at a time, which keeps the
          // producers' registers few); the 16-byte chunks ct, ct + NC, ...
          // (512 a tile), all loads of a tile in flight.  dq stores each
          // group of 4 dims in the order d0, d2, d1, d3 (i8pair_to_bf16x2),
          // which its q tile follows and its epilogue undoes.
          constexpr int kCU = (kBK * 8 + NC - 1) / NC;  // 16-byte chunks per thread
#pragma unroll 1
          for (int tile = S == kDQ ? 0 : 1; tile < 2; ++tile) {  // 0: k (dq), 1: v
            const uint8_t* src = tile == 0 ? sK + stage * L::kK : v8;
            uint8_t* dst_tile = tile == 0 ? sKc + stage * L::kKc : sVc + stage * L::kVc;
            uint4 w[kCU];
#pragma unroll
            for (int u = 0; u < kCU; ++u) {
              const int c = ct + NC * u, r = c >> 3, j8 = c & 7;
              if (c < kBK * 8) w[u] = *reinterpret_cast<const uint4*>(src + r * 128 + ((j8 ^ (r & 7)) << 4));
            }
#pragma unroll
            for (int u = 0; u < kCU; ++u) {
              const int c = ct + NC * u, r = c >> 3, j8 = c & 7;
              if (c >= kBK * 8) continue;
              uint8_t* dst = dst_tile + (j8 >> 2) * 8192 + r * 128;
              const int c2 = 2 * (j8 & 3);
              if constexpr (S == kDQ) {
                *reinterpret_cast<uint4*>(dst + ((c2 ^ (r & 7)) << 4)) =
                    make_uint4(i8pair_to_bf16x2(w[u].x), i8pair_to_bf16x2(w[u].x >> 8), i8pair_to_bf16x2(w[u].y),
                               i8pair_to_bf16x2(w[u].y >> 8));
                *reinterpret_cast<uint4*>(dst + (((c2 + 1) ^ (r & 7)) << 4)) =
                    make_uint4(i8pair_to_bf16x2(w[u].z), i8pair_to_bf16x2(w[u].z >> 8), i8pair_to_bf16x2(w[u].w),
                               i8pair_to_bf16x2(w[u].w >> 8));
              } else {
                *reinterpret_cast<uint4*>(dst + ((c2 ^ (r & 7)) << 4)) =
                    make_uint4(i8x2_to_bf16x2(w[u].x), i8x2_to_bf16x2(w[u].x >> 16), i8x2_to_bf16x2(w[u].y),
                               i8x2_to_bf16x2(w[u].y >> 16));
                *reinterpret_cast<uint4*>(dst + (((c2 + 1) ^ (r & 7)) << 4)) =
                    make_uint4(i8x2_to_bf16x2(w[u].z), i8x2_to_bf16x2(w[u].z >> 16), i8x2_to_bf16x2(w[u].w),
                               i8x2_to_bf16x2(w[u].w >> 16));
              }
            }
          }
        }
        fence_proxy_async();  // the rewritten tiles, visible to wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&vready[stage]);
        PHASE_END(6, pt);
        PHASE_COUNT(8);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup: q head head0 + wg -------------------------------
    setmaxnreg_inc<C::kConsumerRegs>();
    const int h = head0 + wg;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
    uint8_t* q_s = sQ + wg * L::kQ;
    float* row = sRow + (wg * 4 + warp) * kHD;

    // prologue: warp w stages rows 16 w .. 16 w + 15 (the rows it owns in
    // wgmma's accumulator layout); lane l holds dims 4 l .. 4 l + 3
    float sqr[2] = {0.f, 0.f};  // qk8, sage: sq * scale of rows g and g + 8
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
          const float ws = S == kK1 ? a.scale : 1.f;  // K1: the affine times sm_scale*log2e, in f32
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 4 * lane + i;
            x[i] = (x[i] - mean) * rstd * __fmul_rn(a.qw[d], ws) + __fmul_rn(a.qb[d], ws);
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
        } else if (S == kK1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] *= a.scale;
        }
      }
      if (C::kInt8Q) {
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
        if (S == kDQ) {  // dims in the order of dq's converted k tile
          const float t1 = x[1];
          x[1] = x[2];
          x[2] = t1;
        }
        *reinterpret_cast<uint2*>(q_s + (lane >> 4) * 8192 + r * 128 + ((((lane >> 1) & 7) ^ (r & 7)) << 4) +
                                  8 * (lane & 1)) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
      }
    }
    fence_proxy_async();  // the q tile, visible to wgmma
    bar_sync(1 + wg, 128);

    // ---- flash loop over kv tiles -------------------------------------------
    // accumulators: thread (warp w, g, tq) holds rows 16 w + g + 8 i and
    // columns 8 j + 2 tq + c in [4 j + 2 i + c]
    using Acc = typename std::conditional<C::kInt8Q, int, float>::type;
    Acc sacc[32];  // Q K^T of the current tile (sage: then each half of P V)
    float s[32];   // its logits, then p
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    uint32_t pa[kBK / 16][4];  // P, wgmma's A operand (bf16)
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
    float alpha[2] = {0.f, 0.f};  // rescale of O for the tile of pa (the first: O is 0)
    const uint64_t dq = wgmma_desc_sw128(q_s);

    // S = Q K^T of the tile in stage st: issued and committed, not waited
    auto issue_qk = [&](int st) {
      wgmma_fence();
      if constexpr (C::kInt8Q) {
        const uint64_t dk = wgmma_desc_sw128(sK + st * L::kK);
        wgmma_s8_m64n64k32<false>(sacc, dq, dk);
#pragma unroll
        for (int kk = 1; kk < kHD / 32; ++kk) wgmma_s8_m64n64k32<true>(sacc, dq + 2 * kk, dk + 2 * kk);
      } else {
        const uint64_t dk = wgmma_desc_sw128(S == kDQ ? sKc + st * L::kKc : sK + st * L::kK);
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
    // 2 KB per k step): issued and committed, not waited (K1, qk8, dq)
    auto issue_pv = [&](int st) {
      // K5 skips it when no row of the warp has a new maximum (measured
      // faster for qk8, slower for K1)
      if (!C::kInt8KV || !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int jj = 0; jj < kHD / 8; ++jj) {
          o[4 * jj + 0] *= alpha[0];
          o[4 * jj + 1] *= alpha[0];
          o[4 * jj + 2] *= alpha[1];
          o[4 * jj + 3] *= alpha[1];
        }
      }
      const uint64_t dv = wgmma_desc_mn_sw128(C::kInt8KV ? sVc + st * L::kVc : sV + st * L::kK, 8192);
      wgmma_hold(o);
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < kBK / 16; ++k2) wgmma_bf16_m64n128k16_rs(o, pa[k2], dv + k2 * (2048 >> 4));
      wgmma_commit();
      wgmma_hold(o);
    };

    // the online softmax of the tile in stage st (its products waited; qk8,
    // sage: its scales and converted v tile arrived), whose columns [vlo,
    // vhi) are attended: s = p, and the running max, sums and alpha
    auto softmax = [&](int vlo, int vhi, int st) {
      if constexpr (C::kInt8Q) {
        const float* sk = sSc + st * L::kSc;
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * jj + 2 * tq);
          s[4 * jj + 0] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 0]), sqr[0]), k2.x);
          s[4 * jj + 1] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 1]), sqr[0]), k2.y);
          s[4 * jj + 2] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 2]), sqr[1]), k2.x);
          s[4 * jj + 3] = __fmul_rn(__fmul_rn(__int2float_rn(sacc[4 * jj + 3]), sqr[1]), k2.y);
        }
      } else if constexpr (S == kDQ) {
        const float* sk = sSc + st * L::kSc;  // sk * sm_scale * log2e
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const float2 k2 = *reinterpret_cast<const float2*>(sk + 8 * jj + 2 * tq);
          s[4 * jj + 0] = __fmul_rn(sacc[4 * jj + 0], k2.x);
          s[4 * jj + 1] = __fmul_rn(sacc[4 * jj + 1], k2.y);
          s[4 * jj + 2] = __fmul_rn(sacc[4 * jj + 2], k2.x);
          s[4 * jj + 3] = __fmul_rn(sacc[4 * jj + 3], k2.y);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = sacc[i];
      }
      // columns outside the range: -inf (before vlo only in sage's and
      // dq's first tile of a source)
      if (vhi < kBK || (C::kAligned && vlo > 0)) {
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jj + 2 * tq + c;
            if (col >= vhi || (C::kAligned && col < vlo)) s[4 * jj + c] = s[4 * jj + 2 + c] = -CUDART_INF_F;
          }
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
        alpha[i] = C::kInt8KV && mx[i] == m_run[i] ? 1.f : ex2(m_run[i] - base[i]);
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

    // P of the tile in stage st as the A operand (qk8, dq: p * sv, the v
    // scale folded in before the bf16 cast): k step k2 holds columns 16 k2
    // .. 16 k2 + 15, the accumulators 8 k2 .. 8 k2 + 7 in pairs
    auto pack_p = [&](int st) {
      if constexpr (C::kInt8KV) {
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

    // sage: pv = p * sv requantized per row against the tile's row max,
    // then O = O * alpha + f32(P8 V8) * sp, waited.  The A fragment of k
    // step kc (columns 32 kc ..): register e holds rows g + 8 (e % 2), k
    // indices 16 (e / 2) + 4 tq .. + 3, i.e. (see v8^T's column order) the
    // accumulator columns 2 tq, 2 tq + 1 of 8-column groups 4 kc + 2 (e / 2)
    // and 4 kc + 2 (e / 2) + 1.  P V in two n64 halves (dims 0-63, 64-127:
    // rows of v8^T 4 KB apart), each into S's accumulator registers; the
    // fold is one fma (the plain version rounds the product and the sum
    // apart: an f32 ulp).
    auto sage_pv = [&](int st) {
      if constexpr (S == kSage) {  // (sacc is f32 in the other schemes)
        const float* sv = sSc + st * L::kSc + kBK;
        float t[2][kBK / 8];  // the row maxima of pv, as trees
#pragma unroll
        for (int jj = 0; jj < kBK / 8; ++jj) {
          const float2 v2 = *reinterpret_cast<const float2*>(sv + 8 * jj + 2 * tq);
          s[4 * jj + 0] = __fmul_rn(s[4 * jj + 0], v2.x);
          s[4 * jj + 1] = __fmul_rn(s[4 * jj + 1], v2.y);
          s[4 * jj + 2] = __fmul_rn(s[4 * jj + 2], v2.x);
          s[4 * jj + 3] = __fmul_rn(s[4 * jj + 3], v2.y);
          t[0][jj] = fmaxf(s[4 * jj + 0], s[4 * jj + 1]);
          t[1][jj] = fmaxf(s[4 * jj + 2], s[4 * jj + 3]);
        }
#pragma unroll
        for (int w = kBK / 16; w >= 1; w >>= 1)
#pragma unroll
          for (int k = 0; k < w; ++k) {
            t[0][k] = fmaxf(t[0][k], t[0][k + w]);
            t[1][k] = fmaxf(t[1][k], t[1][k + w]);
          }
        float sp[2], rp[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pmax = fmaxf(t[i][0], __shfl_xor_sync(0xffffffffu, t[i][0], 1));
          pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 2));
          sp[i] = __fmul_rn(fmaxf(pmax, 1e-20f), 1.f / 127.f);
          rp[i] = __frcp_rn(sp[i]);  // IEEE 1 / sp
        }
        // p8 = round(pv * rp), half to even, in [0, 127]; cvt.pack puts two
        // int32 in bytes 0-1 and shifts its third operand above them
        uint32_t pa8[kBK / 32][4];
#pragma unroll
        for (int kc = 0; kc < kBK / 32; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = 16 * kc + 8 * (e >> 1) + 2 * (e & 1);  // s[b], s[b + 1], s[b + 4], s[b + 5]
            const float r = rp[e & 1];
            uint32_t hi;
            asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
                : "=r"(hi)
                : "r"(__float2int_rn(__fmul_rn(s[b + 5], r))), "r"(__float2int_rn(__fmul_rn(s[b + 4], r))), "r"(0));
            asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
                : "=r"(pa8[kc][e])
                : "r"(__float2int_rn(__fmul_rn(s[b + 1], r))), "r"(__float2int_rn(__fmul_rn(s[b], r))), "r"(hi));
          }
        const uint64_t dv = wgmma_desc_sw64(sVc + st * L::kVc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          wgmma_fence();
          wgmma_s8_m64n64k32_rs<false>(sacc, pa8[0], dv + hh * (4096 >> 4));
          wgmma_s8_m64n64k32_rs<true>(sacc, pa8[1], dv + hh * (4096 >> 4) + 2);
          wgmma_commit();
          // O's rescale (skipped when no row of the warp has a new maximum)
          // while the first half runs
          if (hh == 0 && !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
            for (int k = 0; k < 64; ++k) o[k] = __fmul_rn(o[k], alpha[(k >> 1) & 1]);
          }
          wgmma_wait<0>();
          wgmma_hold(sacc);
#pragma unroll
          for (int k = 0; k < 32; ++k)
            o[32 * hh + k] = __fmaf_rn(__int2float_rn(sacc[k]), sp[(k >> 1) & 1], o[32 * hh + k]);
        }
      }
    };

    // K1 leaves P V of tile j running while the consumer waits for tile
    // j + 1 and issues its Q K^T: the two products run back to back on the
    // tensor cores, and one wait covers both.  K5 waits for each product:
    // at 128 registers (qk8, dq) a consumer cannot hold both in flight, and
    // ptxas would serialize them; sage folds its P V into O in f32.
    // (Overlapping the softmax with P V as well needs registers for two
    // tiles, which three consumers do not have.)
    constexpr bool kOverlap = S == kK1;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int j = 0; j < total; ++j) {
      PHASE_START(pt);
      if constexpr (S == kDQ) {
        mbar_wait(&vready[stage], phase);  // the bf16 k and v tiles and the scales
      } else {
        mbar_wait(&full[stage], phase);
      }
      PHASE_END(0, pt);
      issue_qk(stage);
      wgmma_wait<0>();  // Q K^T of tile j (K1: and P V of tile j - 1)
      wgmma_hold(sacc);
      if (kOverlap) {
        wgmma_hold(o);
        if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
      }
      PHASE_END(1, pt);
      if constexpr (C::kInt8Q) mbar_wait(&vready[stage], phase);  // the scales and the converted v tile
      PHASE_END(2, pt);
      const int t0 = tile_start(j);
      softmax((j < n0 ? lo0 : lo1) - t0, (j < n0 ? hi0 : hi1) - t0, stage);
      PHASE_END(3, pt);
      if constexpr (S == kSage) {
        sage_pv(stage);
        if (lane == 0) mbar_arrive(&empty[stage]);
      } else {
        pack_p(stage);
        issue_pv(stage);
        if (!kOverlap) {
          wgmma_wait<0>();
          wgmma_hold(o);
          if (lane == 0) mbar_arrive(&empty[stage]);
        }
      }
      PHASE_END(4, pt);
      PHASE_COUNT(7);
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
      if (S == kDQ) {
        // dq's v tile holds dims d0, d2, d1, d3 of each 4, so columns 2 tq,
        // 2 tq + 1 are dims (0, 2) or (1, 3) of their group: swap with the
        // neighbour so each thread stores two consecutive dims
#pragma unroll
        for (int jj = 0; jj < kHD / 8; ++jj) {
          float& v0 = o[4 * jj + 2 * i];
          float& v1 = o[4 * jj + 2 * i + 1];
          const float got = __shfl_xor_sync(0xffffffffu, (tq & 1) ? v0 : v1, 1);
          if (tq & 1) {
            v0 = got;
          } else {
            v1 = got;
          }
        }
      }
      const int tok_in_seg = qt * kBQ + 16 * warp + g + 8 * i;
      if (tok_in_seg >= a.seg_len) continue;
      const long long gtok = (long long)seg * a.seg_len + tok_in_seg;
      __nv_bfloat16* dst = a.out + (gtok * a.hq + h) * kHD + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < kHD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
    }
  }
  PHASE_FLUSH;
}

__global__ void __launch_bounds__(Cfg<kK1>::kMaxThreads, 1)
    seg_attn_two_source_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                               const __grid_constant__ Args a) {
  seg_attn_tma_body<kK1>(&tm0, &tm1, a);
}

__global__ void __launch_bounds__(Cfg<kQK8>::kMaxThreads, 1)
    seg_attn_q8_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ Args a) {
  seg_attn_tma_body<kQK8>(&tm0, &tm1, a);
}

__global__ void __launch_bounds__(Cfg<kSage>::kMaxThreads, 1)
    seg_attn_q8_sage_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                            const __grid_constant__ Args a) {
  seg_attn_tma_body<kSage>(&tm0, &tm1, a);
}

__global__ void __launch_bounds__(Cfg<kDQ>::kMaxThreads, 1)
    seg_attn_q8_dq_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
                          const __grid_constant__ Args a) {
  seg_attn_tma_body<kDQ>(&tm0, &tm1, a);
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

template <int S, typename Kernel>
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
  cudaError_t err = source_map(&tm0, s0, hk, Cfg<S>::kInt8KV);
  if (err == cudaSuccess) err = source_map(&tm1, s1, hk, Cfg<S>::kInt8KV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<S>::bytes(kMaxHeads));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n_seg * ((a.seg_len + kBQ - 1) / kBQ) * (a.hq / a.heads);
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, 128 * (a.heads + Cfg<S>::kProducers), Smem<S>::bytes(a.heads), stream>>>(tm0, tm1, a);
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
// int32; qw, qb: [128] f32, the LayerNorm affine, or null; sin, cos:
// [n_seg*seg_len, rot] f32 or null; scale = sm_scale * log2(e)
int magi_seg_attn_two_source(const void* q, void* out, const void* kv1, long long len1, long long ts1,
                             long long hs1, long long ks1, const void* kv2, long long len2, long long ts2,
                             long long hs2, long long ks2, const int* r1s, const int* r1e, const int* r2s,
                             const int* r2e, const float* qw, const float* qb, const float* sin, const float* cos,
                             int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps, float scale,
                             void* stream) {
  Args a = {};
  set_common(a, q, out, r1s, r1e, r2s, r2e, qw, qb, sin, cos, n_seg, seg_len, hq, rot, eps, scale);
  return (int)launch<kK1>(seg_attn_two_source_kernel, Source{kv1, len1, ts1, hs1, ks1},
                          Source{kv2, len2, ts2, hs2, ks2}, a, hk, hd, static_cast<cudaStream_t>(stream));
}

// K5.  As K1 with int8 kv1, kv2 and their f32 scales sc1, sc2 [2, hk, len],
// token-contiguous, with element strides (head, k|v); qw, qb: the plain
// LayerNorm affine; scheme 0 qk8, 1 sage, 2 dq
int magi_seg_attn_two_source_int8(const void* q, void* out, const void* kv1, long long len1, long long ts1,
                                  long long hs1, long long ks1, const float* sc1, long long sch1, long long sck1,
                                  const void* kv2, long long len2, long long ts2, long long hs2, long long ks2,
                                  const float* sc2, long long sch2, long long sck2, const int* r1s, const int* r1e,
                                  const int* r2s, const int* r2e, const float* qw, const float* qb, const float* sin,
                                  const float* cos, int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps,
                                  float scale, int scheme, void* stream) {
  Args a = {};
  set_common(a, q, out, r1s, r1e, r2s, r2e, qw, qb, sin, cos, n_seg, seg_len, hq, rot, eps, scale);
  a.sc0 = sc1;
  a.sc_head0 = sch1;
  a.sc_kv0 = sck1;
  a.sc1 = sc2;
  a.sc_head1 = sch2;
  a.sc_kv1 = sck2;
  const Source s1{kv1, len1, ts1, hs1, ks1}, s2{kv2, len2, ts2, hs2, ks2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case kQK8:
      return (int)launch<kQK8>(seg_attn_q8_kernel, s1, s2, a, hk, hd, st);
    case kSage:
      return (int)launch<kSage>(seg_attn_q8_sage_kernel, s1, s2, a, hk, hd, st);
    case kDQ:
      return (int)launch<kDQ>(seg_attn_q8_dq_kernel, s1, s2, a, hk, hd, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef MAGI_PHASE_CLOCKS
// the phase clocks into out[9], then cleared
int magi_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[9] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, magi::g_phase, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(magi::g_phase, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // extern "C"
