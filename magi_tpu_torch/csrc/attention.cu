// Single-source segmented flash attention for Hopper (sm_90a) on TMA and
// wgmma: one persistent kernel body, two `__global__` kernels (one per
// Pallas kernel it replaces, so a trace names each), one C entry point.
// The two-source kernels (K1, K5) are in csrc/attention_tma.cu.
//
// Replaces (magi_tpu/ops/attention.py):
//   seg_attn_v2_kernel (K2) -> segmented_attention_v2 :560 -> pallas_call
//       :678 (_seg_attn_kernel_v2 :392, _q_prologue :323, _o_epilogue
//       :371): the DiT caption cross-attention (head_dim 128, norm-only q
//       prologue); C entry magi_seg_attn with kind 1.
//   seg_attn_grid_kernel (K2g) -> segmented_attention :226 -> pallas_call
//       :307 (_seg_attn_kernel :59): the VAE self-attention (head_dim 64,
//       no prologue, through segmented_attention_v2's fallback);
//       magi_seg_attn with kind 2.
//
// Semantics.  q is token-major [n_seg * seg_len, hq, hd] bf16, k and v
// token-major [kv_len, hk, hd]: any views with a contiguous last dimension
// whose base and other strides are multiples of 16 bytes (TMA loads them);
// out is contiguous.  Segment i attends kv tokens [kv_start[i], kv_end[i]),
// clipped to [0, kv_len).  A segment with an empty range outputs exactly
// 0.  GQA: q head h reads kv head h / (hq / hk).  The optional q prologue:
// fp32 LayerNorm of each q row with (w, b) scaled by sm_scale * log2(e)
// (in f32, as the block loads them), then GPT-NeoX rotary on the first
// 2 * rot dims, then the bf16 cast.  Without it the logits q.k are scaled
// by sm_scale * log2(e) in f32.  The softmax runs in the exp2 domain,
// online (flash attention), normalised once at the end.  kv tokens of a
// tile past the range end are real tokens of the source (or zeros past
// kv_len): their logits are -inf and their p exactly 0, so they must be
// finite.
//
// What bounds it on the H100.  K2: the captions' spans are short (the null
// caption 50 tokens, a prompt a few to 800) against segments of 1536 to
// 12150 queries, so q in and the output out are nearly all the bytes and
// the memory rate bounds it.  K2g: the VAE's segments of 3073 (256x256) to
// 24301 tokens (720x720) at head_dim 64 do ~1500 flops per byte, so the
// tensor-core rate bounds it; beside the products, one exp2 per logit on
// the SFU takes as long as both products at head_dim 64.
//
// Design.  A persistent grid, one block per SM, walks work items (segment,
// head group, q tile) with a static stride: block b takes items b, b + grid,
// b + 2 grid, .., in an order with the segments that attend the most tokens
// first, so the long items spread over the blocks and the short ones fill in
// behind them.  A K2 item is the heads <= 3 q heads that share one kv head x
// 64 q tokens; a K2g item one head x 192 q tokens (three row tiles of 64
// that share each kv tile: a third of the L2 reads per q row of 64-row
// items).  The producer warpgroup has two threads with rings of their own.
// The q loader loads each item's q tiles (one 64-dim x 64-token box per
// head, row tile and 64 dims, through a 4-D map over (dim, head, token in
// the segment, segment), so tokens past the segment end arrive as zeros and
// no read crosses into the next segment) into a 2-stage q ring, one item
// ahead.  The kv loader loads the kv tiles (64 tokens at hd 128, 128 at hd
// 64; a 3-D map per tensor over the view's strides, tokens past kv_len as
// zeros) into a 4-stage kv ring.  Each consumer warpgroup owns 64 q rows of
// one head.  With the prologue it normalises its q tile in place in shared
// memory (two threads a row; a pass for the mean, one for the variance as
// the mean of (x - mean)^2, one to apply), in the 128-byte-swizzled K-major
// layout that both TMA and wgmma use.  Per tile: S = Q K^T on wgmma
// (m64n64k16 or m64n128k16, B K-major), the online softmax in registers, O
// += P V with P from registers and V read transposed (m64n128k16 or
// m64n64k16).  P V of one tile runs on while the next tile's Q K^T is issued
// (one wait covers both, as K1).  K2g's consumers take turns at issuing
// their products (FlashAttention-3's ping-pong, a named barrier each, round
// robin), so one's softmax runs while another's products run; a consumer
// whose rows all lie past the segment end keeps its turns and computes
// nothing.  The epilogue writes O as bf16 over the consumer's own q tile, in
// the same swizzle (free of bank conflicts); the q loader drains it with a
// TMA store, clipped at the segment end, just before it loads that stage
// again, so no consumer waits for a store.  An item of an empty segment
// reads no q and stores zeros.  setmaxnreg gives the three consumers 160
// registers and the producers 32.  Tried and dropped (scripts/time_k5.py
// --csrc, same-call comparisons): K2g with two consumers of 232 registers
// (128 q rows an item), with or without FlashAttention-3's intra-warpgroup
// overlap of the softmax with P V, or without ping-pong; K2g with 64-token
// kv tiles, 5 stages, no ping-pong, or O's rescale skipped when no row
// maximum moved; K2 with 2 kv stages (3 were no faster).  Blocks taking
// items from an atomic counter ran 6-9% faster (a block that took two of
// the longest items took nothing more), but the counter is state that
// every launch on the device shares, so two streams would race on it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "ptx.cuh"
#include "tmap.cuh"

namespace {

using namespace magi;

// The phases of the per-phase clocks (ptx.cuh; magi_seg_attn_phase_clocks
// reads them), by lane 0 of every consumer warp: 0 the wait for a kv
// tile, 1 the wait for the consumer's turn (K2g), 2 the products (issue
// and wait), 3 the softmax and P's packing, 4 the wait for an item's q, 5
// the prologue, 6 the epilogue; 7 counts the warps' kv tiles, 8 their
// items.

// kernel kinds of magi_seg_attn (ops/attention.py passes the same numbers)
enum Kind { kV2 = 1, kGrid = 2 };

constexpr int kBQ = 64;          // q rows of a consumer: one wgmma M
constexpr int kTile = kBQ * 128;  // one 64-row x 128-byte swizzled tile (64 dims of 64 tokens)
constexpr int kMaxSorted = 128;  // segments ordered by span up to this many (else in index order)

// Per head_dim: kv tokens per tile, ring stages, q row tiles per head in an
// item, consumer warpgroups at most, whether the consumers take turns, and
// the registers setmaxnreg gives each side.  setmaxnreg moves registers
// within the block's launch allocation (65536 / threads, rounded down to
// 8, per thread), so both counts must fit in it.
template <int HD>
struct Cfg;
template <>
struct Cfg<128> {
  static constexpr int kBK = 64, kStages = 4, kRowTiles = 1, kMaxConsumers = 3;
  static constexpr bool kPingPong = false;
  static constexpr int kConsumerRegs = 160, kProducerRegs = 32;
};
template <>
struct Cfg<64> {
  static constexpr int kBK = 128, kStages = 4, kRowTiles = 3, kMaxConsumers = 3;
  static constexpr bool kPingPong = true;
  static constexpr int kConsumerRegs = 160, kProducerRegs = 32;
};
constexpr int kQStages = 2;

template <int HD>
struct Layout {
  using C = Cfg<HD>;
  static constexpr int kMaxThreads = 128 * (C::kMaxConsumers + 1);
  static constexpr int kLaunchRegs = 65536 / kMaxThreads / 8 * 8;
  static_assert(C::kMaxConsumers * C::kConsumerRegs + C::kProducerRegs <= (C::kMaxConsumers + 1) * kLaunchRegs,
                "the block's registers");
  static constexpr int kQC = HD / 64 * kTile;          // a consumer's q tile, then its O
  static constexpr int kKV = HD / 64 * C::kBK * 128;  // a k tile, and a v tile
  static size_t bytes(int consumers) {
    return 1024 + (size_t)kQStages * consumers * kQC + 2 * C::kStages * kKV + 2 * HD * 4 +
           2 * (C::kStages + kQStages) * 8;
  }
};

struct Args {
  const int* start;  // [n_seg] kv ranges
  const int* end;
  const float* qw;  // [hd] LN weight, or nullptr (no prologue)
  const float* qb;
  const float* sin;  // [n_seg*seg_len, rot] or nullptr (no rotary)
  const float* cos;
  int n_seg, seg_len, hq, q_per_kv, heads, kv_len, rot;
  int n_qt, n_hg, n_items;  // q tiles per (segment, head group), head groups, items
  float eps, scale;          // scale = sm_scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d = 0, as volatile asm: the compiler cannot hoist it above the asm before
// it (here, the prologue), where d's registers would sit idle
template <int N>
__device__ __forceinline__ void zero_after_asm(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(d[i]));
}

struct Item {
  int seg, hg, qt, lo, hi, total;
};

template <int HD>
__device__ __forceinline__ void seg_attn_body(const CUtensorMap* tmq, const CUtensorMap* tmk, const CUtensorMap* tmv,
                                              const CUtensorMap* tmo, const Args& a) {
  using C = Cfg<HD>;
  using L = Layout<HD>;
  constexpr int BK = C::kBK, R = C::kRowTiles, NCH = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_order[kMaxSorted];
  PHASE_SETUP;
  const int nc = a.heads * R;  // consumer warpgroups
  uint8_t* sQ = align1024(smem_raw);        // [q stage][consumer][kQC]: q, then O
  uint8_t* sK = sQ + kQStages * nc * L::kQC;  // [stage][kKV]
  uint8_t* sV = sK + C::kStages * L::kKV;   // [stage][kKV]
  float* sW = reinterpret_cast<float*>(sV + C::kStages * L::kKV);  // [HD] LN weight, [HD] bias
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + 2 * HD);
  uint64_t* empty = full + C::kStages;
  uint64_t* qfull = empty + C::kStages;
  uint64_t* qempty = qfull + kQStages;

  // rank of each segment by attended tokens, most first (ties by index)
  auto span = [&](int i) { return max(min(a.end[i], a.kv_len) - max(a.start[i], 0), 0); };
  if (a.n_seg <= kMaxSorted) {
    for (int i = threadIdx.x; i < a.n_seg; i += blockDim.x) {
      const int wi = span(i);
      int r = 0;
      for (int j = 0; j < a.n_seg; ++j) {
        const int wj = span(j);
        r += wj > wi || (wj == wi && j < i);
      }
      s_order[r] = i;
    }
  }
  if (a.qw)  // the LayerNorm's affine times sm_scale * log2(e)
    for (int i = threadIdx.x; i < 2 * HD; i += blockDim.x) sW[i] = __fmul_rn(i < HD ? a.qw[i] : a.qb[i - HD], a.scale);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nc);
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], nc);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the block's k-th item (-1: none left)
  auto next_item = [&](int k) {
    const long long idx = blockIdx.x + (long long)k * gridDim.x;
    return idx < a.n_items ? (int)idx : -1;
  };
  auto decode = [&](int idx) {
    Item it;
    const int per_rank = a.n_hg * a.n_qt;
    const int rank = idx / per_rank, rem = idx - rank * per_rank;
    it.hg = rem / a.n_qt;
    it.qt = rem - it.hg * a.n_qt;
    it.seg = a.n_seg <= kMaxSorted ? s_order[rank] : rank;
    it.lo = max(a.start[it.seg], 0);
    it.hi = min(a.end[it.seg], a.kv_len);
    it.total = it.hi > it.lo ? (it.hi - it.lo + BK - 1) / BK : 0;
    return it;
  };

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (wg >= nc) {
    // ---- producer warpgroup: thread 0 loads q, thread 32 the kv tiles -----
    setmaxnreg_dec<C::kProducerRegs>();
    const int pt = threadIdx.x - 128 * nc;
    if (pt == 0) {
      // the q loader: it also stores each item's O, staged by the consumers
      // over their q tiles, before it loads the next q into that stage
      tma_prefetch_desc(tmq);
      int qs = 0;
      uint32_t qph = 0;
      int staged[kQStages];  // the item whose O each stage holds (-1: none)
#pragma unroll
      for (int i = 0; i < kQStages; ++i) staged[i] = -1;
      auto store_staged = [&](int s) {
        const Item it = decode(staged[s]);
        const int t0 = it.qt * R * kBQ;
        const int nr = min(R, (a.seg_len - t0 + kBQ - 1) / kBQ);  // row tiles holding tokens of the segment
        for (int j = 0; j < a.heads; ++j)
          for (int r = 0; r < nr; ++r)
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              tma_store_4d(tmo, sQ + (s * nc + j * R + r) * L::kQC + ch * kTile, 64 * ch, it.hg * a.heads + j,
                           t0 + r * kBQ, it.seg);
        bulk_commit_group();
        staged[s] = -1;
      };
      for (int k = 0;; ++k) {
        const int idx = next_item(k);
        if (idx < 0) break;
        const Item it = decode(idx);
        mbar_wait(&qempty[qs], qph ^ 1);  // the stage's last item is done: its O is staged
        if (staged[qs] >= 0) {
          store_staged(qs);
          bulk_wait_group_read<0>();  // the store has read the stage
        }
        staged[qs] = idx;
        if (it.total == 0) {
          mbar_arrive(&qfull[qs]);  // its output is 0: the stage only stages it, q is not read
        } else {
          const int t0 = it.qt * R * kBQ;
          const int nr = min(R, (a.seg_len - t0 + kBQ - 1) / kBQ);
          mbar_arrive_expect_tx(&qfull[qs], a.heads * nr * L::kQC);
          for (int j = 0; j < a.heads; ++j)
            for (int r = 0; r < nr; ++r)
#pragma unroll
              for (int ch = 0; ch < NCH; ++ch)
                tma_load_4d(sQ + (qs * nc + j * R + r) * L::kQC + ch * kTile, tmq, &qfull[qs], 64 * ch,
                            it.hg * a.heads + j, t0 + r * kBQ, it.seg);
        }
        if (++qs == kQStages) {
          qs = 0;
          qph ^= 1;
        }
      }
      // the O of the block's last items, in the order they were loaded
      for (int i = 0; i < kQStages; ++i) {
        if (staged[qs] >= 0) {
          mbar_wait(&qempty[qs], qph ^ 1);
          store_staged(qs);
        }
        if (++qs == kQStages) {
          qs = 0;
          qph ^= 1;
        }
      }
      bulk_wait_group<0>();
    } else if (pt == 32) {
      if (a.kv_len > 0) {  // (no maps without kv)
        tma_prefetch_desc(tmk);
        tma_prefetch_desc(tmv);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int k = 0;; ++k) {
        const int idx = next_item(k);
        if (idx < 0) break;
        const Item it = decode(idx);
        const int kvh = it.hg * a.heads / a.q_per_kv;
        for (int jt = 0; jt < it.total; ++jt) {
          const int t0 = it.lo + jt * BK;
          mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * L::kKV);
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            tma_load_3d(sK + st * L::kKV + ch * BK * 128, tmk, &full[st], 64 * ch, kvh, t0);
            tma_load_3d(sV + st * L::kKV + ch * BK * 128, tmv, &full[st], 64 * ch, kvh, t0);
          }
          if (++st == C::kStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: q head (head group's j), row tile r ----------
    setmaxnreg_inc<C::kConsumerRegs>();
    const int c = wg, j = c / R, r = c - j * R;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
    const bool lead = (threadIdx.x & 127) == 0;
    const float sc = a.qw ? 1.f : a.scale;  // the logits' factor: the prologue already scaled q
    const bool pingpong = C::kPingPong && nc > 1;
    if (pingpong && c == nc - 1) bar_arrive(1, 256);  // consumer 0 takes the first turn

    int st = 0, qs = 0;
    uint32_t ph = 0, qph = 0;
    auto advance = [&] {
      if (++st == C::kStages) {
        st = 0;
        ph ^= 1;
      }
    };
    // K2g's consumers take turns at issuing their products (named barriers
    // 1 .. nc, round robin)
    auto turn_begin = [&] {
      if (pingpong) bar_sync(1 + c, 256);
    };
    auto turn_end = [&] {
      if (pingpong) bar_arrive(1 + (c + 1 == nc ? 0 : c + 1), 256);
    };
    for (int k = 0;; ++k) {
      const int idx = next_item(k);
      if (idx < 0) break;
      const Item it = decode(idx);
      const int tok0 = (it.qt * R + r) * kBQ;  // this consumer's first q token in the segment
      uint8_t* q_s = sQ + (qs * nc + c) * L::kQC;  // its q tile, then its O
      PHASE_START(pt);

      // accumulators: thread (warp w, g, tq) holds rows 16 w + g + 8 i and
      // columns 8 jj + 2 tq + e in [4 jj + 2 i + e] (zeroed after the
      // prologue, which then has their registers)
      float o[HD / 2];
      float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

      mbar_wait(&qfull[qs], qph);
      PHASE_END(4, pt);
      const bool idle = tok0 >= a.seg_len;  // no q row of this consumer is in the segment (K2g's last item)
      if (it.total > 0 && !idle) {
        if (a.qw) {
          // ---- prologue, in place: two threads a row, each half of it (U
          // 16-byte units), read again from the tile in each pass; rotary
          // reads the partner dims from the tile too, so every thread has
          // read before any writes
          constexpr int U = HD / 16;
          const int row = (threadIdx.x & 127) >> 1, half = threadIdx.x & 1;
          const int tok = tok0 + row;
          auto unit = [&](int v) { return q_s + (v >> 3) * kTile + row * 128 + (((v & 7) ^ (row & 7)) << 4); };
          auto load = [&](int u) { return *reinterpret_cast<const uint4*>(unit(half * U + u)); };
          auto elem = [](const uint4& w, int e) {  // element e (0-7) of a unit, as f32
            const uint32_t x = e < 2 ? w.x : e < 4 ? w.y : e < 6 ? w.z : w.w;
            return __uint_as_float(e & 1 ? x & 0xffff0000u : x << 16);
          };
          // two passes for the moments, as the plain version: the mean,
          // then the variance as the mean of (x - mean)^2
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint4 w = load(u);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e & 3] += elem(w, e);
          }
          float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          const float mean = s / HD;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint4 w = load(u);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float xc = elem(w, e) - mean;
              acc[e & 3] = fmaf(xc, xc, acc[e & 3]);
            }
          }
          float s2 = (acc[0] + acc[1]) + (acc[2] + acc[3]);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
          const float rstd = rsqrtf(s2 / HD + a.eps);
          const float nmr = -mean * rstd;  // y = (x rstd - mean rstd) w + b: two fmas
          const bool valid = tok < a.seg_len;  // rows past the segment: finite, never stored
          uint4 res[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint4 w = load(u);
            const int d0 = 8 * (half * U + u);
            float y[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] = valid ? fmaf(fmaf(elem(w, e), rstd, nmr), sW[d0 + e], sW[HD + d0 + e]) : 0.f;
            if (a.sin && valid) {
              // GPT-NeoX rotary on the first 2 * rot dims; the partner of a
              // dim, normalised again from the tile
              const long long gtok = (long long)it.seg * a.seg_len + tok;
              const float* sn = a.sin + gtok * a.rot;
              const float* cs = a.cos + gtok * a.rot;
              auto norm_at = [&](int d) {
                const __nv_bfloat16 x = *reinterpret_cast<const __nv_bfloat16*>(unit(d >> 3) + 2 * (d & 7));
                return fmaf(fmaf(__bfloat162float(x), rstd, nmr), sW[d], sW[HD + d]);
              };
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int d = d0 + e;
                if (d < a.rot) {
                  y[e] = y[e] * cs[d] - norm_at(d + a.rot) * sn[d];
                } else if (d < 2 * a.rot) {
                  const int f = d - a.rot;
                  y[e] = norm_at(f) * sn[f] + y[e] * cs[f];
                }
              }
            }
            res[u] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                                pack_bf16(y[6], y[7]));
          }
          __syncwarp();  // (rotary) the partner thread has read its dims
#pragma unroll
          for (int u = 0; u < U; ++u) *reinterpret_cast<uint4*>(unit(half * U + u)) = res[u];
          fence_proxy_async();  // the q tile, visible to wgmma
          bar_sync(4 + c, 128);
          PHASE_END(5, pt);
        }
        zero_after_asm(o);

        // ---- flash loop over kv tiles -----------------------------------------
        float sacc[BK / 2];       // Q K^T of the current tile, then p
        uint32_t pa[BK / 16][4];  // P, wgmma's A operand (bf16)
        float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // row maxima of the raw logits
        float alpha[2] = {0.f, 0.f};  // rescale of O for the tile of pa
        const uint64_t dq = wgmma_desc_sw128(q_s);

        // S = Q K^T of the tile in stage s: issued and committed, not waited
        auto issue_qk = [&](int s) {
          const uint64_t dk = wgmma_desc_sw128(sK + s * L::kKV);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint64_t oq = (kk >> 2) * (kTile >> 4) + 2 * (kk & 3);
            const uint64_t ok = (kk >> 2) * (BK * 128 >> 4) + 2 * (kk & 3);
            if constexpr (BK == 64) {
              if (kk == 0) {
                wgmma_bf16_m64n64k16<false>(sacc, dq + oq, dk + ok);
              } else {
                wgmma_bf16_m64n64k16<true>(sacc, dq + oq, dk + ok);
              }
            } else {
              if (kk == 0) {
                wgmma_bf16_m64n128k16<false>(sacc, dq + oq, dk + ok);
              } else {
                wgmma_bf16_m64n128k16<true>(sacc, dq + oq, dk + ok);
              }
            }
          }
          wgmma_commit();
          wgmma_hold(sacc);
        };
        // O = O * alpha + P V of the tile in stage s (V [token][dim] read
        // transposed: 64-dim blocks BK * 128 bytes apart, 16 tokens or 2 KB a
        // k step): issued and committed, not waited
        auto issue_pv = [&](int s) {
#pragma unroll
          for (int jj = 0; jj < HD / 8; ++jj) {
            o[4 * jj + 0] *= alpha[0];
            o[4 * jj + 1] *= alpha[0];
            o[4 * jj + 2] *= alpha[1];
            o[4 * jj + 3] *= alpha[1];
          }
          const uint64_t dv = wgmma_desc_mn_sw128(sV + s * L::kKV, BK * 128);
          wgmma_hold(o);
          wgmma_fence();
#pragma unroll
          for (int k2 = 0; k2 < BK / 16; ++k2) {
            if constexpr (HD == 128) {
              wgmma_bf16_m64n128k16_rs(o, pa[k2], dv + k2 * (2048 >> 4));
            } else {
              wgmma_bf16_m64n64k16_rs(o, pa[k2], dv + k2 * (2048 >> 4));
            }
          }
          wgmma_commit();
          wgmma_hold(o);
        };
        // the online softmax of S, whose columns [0, vhi) are attended: the
        // running max, sums and alpha, and P packed as the A operand (k step
        // k2: columns 16 k2 ..)
        auto softmax = [&](int vhi) {
          if (vhi < BK) {
#pragma unroll
            for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * jj + 2 * tq + e >= vhi) sacc[4 * jj + e] = sacc[4 * jj + 2 + e] = -CUDART_INF_F;
          }
          // row maxima and sums as trees (short dependency chains)
          float t[2][BK / 8];
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj) {
            t[0][jj] = fmaxf(sacc[4 * jj], sacc[4 * jj + 1]);
            t[1][jj] = fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]);
          }
#pragma unroll
          for (int w = BK / 16; w >= 1; w >>= 1)
#pragma unroll
            for (int kq = 0; kq < BK / 16; ++kq)
              if (kq < w) {  // (a constant bound, so the tree unrolls fully and t stays in registers)
                t[0][kq] = fmaxf(t[0][kq], t[0][kq + w]);
                t[1][kq] = fmaxf(t[1][kq], t[1][kq + w]);
              }
          float base[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float mx = fmaxf(m_run[i], t[i][0]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            base[i] = mx == -CUDART_INF_F ? 0.f : mx * sc;  // all-masked row: p = 0, not NaN
            alpha[i] = ex2(fmaf(m_run[i], sc, -base[i]));
            m_run[i] = mx;
          }
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[4 * jj + e] = ex2(fmaf(sacc[4 * jj + e], sc, -base[e >> 1]));
            t[0][jj] = sacc[4 * jj] + sacc[4 * jj + 1];
            t[1][jj] = sacc[4 * jj + 2] + sacc[4 * jj + 3];
          }
#pragma unroll
          for (int w = BK / 16; w >= 1; w >>= 1)
#pragma unroll
            for (int kq = 0; kq < BK / 16; ++kq)
              if (kq < w) {
                t[0][kq] += t[0][kq + w];
                t[1][kq] += t[1][kq + w];
              }
#pragma unroll
          for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + t[i][0];
#pragma unroll
          for (int k2 = 0; k2 < BK / 16; ++k2)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[k2][e] = pack_bf16(sacc[8 * k2 + 2 * e], sacc[8 * k2 + 2 * e + 1]);
        };
        auto vhi_of = [&](int jt) { return min(it.hi - (it.lo + jt * BK), BK); };

        // turn jt issues P V of tile jt - 1 and Q K^T of tile jt; one wait
        // covers both (as K1)
        int prev = 0;
        for (int jt = 0; jt <= it.total; ++jt) {
          if (jt < it.total) mbar_wait(&full[st], ph);
          PHASE_END(0, pt);
          turn_begin();
          PHASE_END(1, pt);
          if (jt > 0) issue_pv(prev);
          if (jt < it.total) issue_qk(st);
          turn_end();
          wgmma_wait<0>();
          wgmma_hold(sacc);
          wgmma_hold(o);
          if (jt > 0 && lane == 0) mbar_arrive(&empty[prev]);
          PHASE_END(2, pt);
          if (jt == it.total) break;
          softmax(vhi_of(jt));
          PHASE_END(3, pt);
          PHASE_COUNT(7);
          prev = st;
          advance();
        }
      } else {
        // an idle consumer keeps its turns and releases the tiles
        for (int jt = 0; jt < it.total; ++jt) {
          mbar_wait(&full[st], ph);
          turn_begin();
          turn_end();
          if (lane == 0) mbar_arrive(&empty[st]);
          advance();
        }
        if (it.total > 0) {
          turn_begin();
          turn_end();
        }
        zero_after_asm(o);
      }

      // ---- epilogue: normalise, stage as bf16 in the q tile (swizzled), TMA
      // store, then free the q stage once the store has read it ----------------
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = l == 0.f ? 0.f : 1.f / l;
      }
      bar_sync(4 + c, 128);  // every warp's products have read the q tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + g + 8 * i;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<uint32_t*>(q_s + (jj >> 3) * kTile + row * 128 + (((jj & 7) ^ (row & 7)) << 4) + 4 * tq) =
              pack_bf16(o[4 * jj + 2 * i] * inv[i], o[4 * jj + 2 * i + 1] * inv[i]);
      }
      fence_proxy_async();  // the staged O, visible to the TMA store
      bar_sync(4 + c, 128);
      if (lead) mbar_arrive(&qempty[qs]);  // the q loader stores it
      if (++qs == kQStages) {
        qs = 0;
        qph ^= 1;
      }
      PHASE_END(6, pt);
      PHASE_COUNT(8);
    }
  }
  PHASE_FLUSH;
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kMaxThreads, 1)
    seg_attn_v2_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmo,
                       const __grid_constant__ Args a) {
  seg_attn_body<HD>(&tmq, &tmk, &tmv, &tmo, a);
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kMaxThreads, 1)
    seg_attn_grid_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmo,
                         const __grid_constant__ Args a) {
  seg_attn_body<HD>(&tmq, &tmk, &tmv, &tmo, a);
}

// ---- host side -------------------------------------------------------------

// A bf16 tensor map of `rank` dims (innermost first) with byte strides of
// the outer dims, cut in boxes of one 128-byte row (64 elements) by `box1`
// .. along the rest, 128-byte swizzle; elements outside arrive as zeros
// (loads) or are not written (stores).  Encoded on every launch: the
// tensors are new each forward, and a few microseconds of host time are
// nothing beside the kernel.
cudaError_t encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct View {  // a token-major bf16 tensor [tokens, heads, hd] with element strides
  const void* base;
  long long tok_stride, head_stride;
};

int num_sms() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int HD, typename Kernel>
cudaError_t launch(Kernel kernel, const View& q, void* out, const View& k, const View& v, Args& a, int hk,
                   cudaStream_t stream) {
  using C = Cfg<HD>;
  a.q_per_kv = a.hq / hk;
  a.heads = 1;  // K2: the largest divisor of q_per_kv that fits the block's consumers
  for (int d = C::kMaxConsumers / C::kRowTiles; d >= 1; --d) {
    if (a.q_per_kv % d == 0) {
      a.heads = d;
      break;
    }
  }
  const int nc = a.heads * C::kRowTiles;
  a.n_qt = (a.seg_len + C::kRowTiles * kBQ - 1) / (C::kRowTiles * kBQ);
  a.n_hg = a.hq / a.heads;
  const long long items = (long long)a.n_seg * a.n_hg * a.n_qt;
  if (items == 0) return cudaSuccess;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  a.n_items = (int)items;

  CUtensorMap tmq, tmk, tmv, tmo;
  memset(&tmk, 0, sizeof(tmk));
  memset(&tmv, 0, sizeof(tmv));
  const cuuint32_t box4[4] = {64, 1, (cuuint32_t)kBQ, 1};
  const cuuint64_t qdims[4] = {(cuuint64_t)HD, (cuuint64_t)a.hq, (cuuint64_t)a.seg_len, (cuuint64_t)a.n_seg};
  const cuuint64_t qstr[3] = {(cuuint64_t)q.head_stride * 2, (cuuint64_t)q.tok_stride * 2,
                              (cuuint64_t)q.tok_stride * 2 * a.seg_len};
  const cuuint64_t ostr[3] = {(cuuint64_t)HD * 2, (cuuint64_t)a.hq * HD * 2, (cuuint64_t)a.hq * HD * 2 * a.seg_len};
  cudaError_t err = encode(&tmq, q.base, 4, qdims, qstr, box4);
  if (err == cudaSuccess) err = encode(&tmo, out, 4, qdims, ostr, box4);
  if (err == cudaSuccess && a.kv_len > 0) {  // no kv: every range is empty and nothing is read
    const cuuint32_t box3[3] = {64, 1, (cuuint32_t)C::kBK};
    const cuuint64_t kvdims[3] = {(cuuint64_t)HD, (cuuint64_t)hk, (cuuint64_t)a.kv_len};
    const cuuint64_t kstr[2] = {(cuuint64_t)k.head_stride * 2, (cuuint64_t)k.tok_stride * 2};
    const cuuint64_t vstr[2] = {(cuuint64_t)v.head_stride * 2, (cuuint64_t)v.tok_stride * 2};
    err = encode(&tmk, k.base, 3, kvdims, kstr, box3);
    if (err == cudaSuccess) err = encode(&tmv, v.base, 3, kvdims, vstr, box3);
  }
  const size_t smem = Layout<HD>::bytes(nc);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (int)(items < num_sms() ? items : num_sms());
  kernel<<<grid, 128 * (nc + 1), smem, stream>>>(tmq, tmk, tmv, tmo, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [n_seg*seg_len, hq, hd] bf16 with element strides (token, head); out:
// the same shape, contiguous; k, v: [kv_len, hk, hd] with element strides
// (token, head); every base and byte stride a multiple of 16, last dims
// contiguous; kv_start, kv_end: [n_seg] int32; qw, qb: [hd] f32 (the
// LayerNorm's affine) or null; sin, cos: [n_seg*seg_len, rot] f32 or null;
// scale = sm_scale*log2e; kind: 1 segmented_attention_v2, 2
// segmented_attention
int magi_seg_attn(const void* q, long long q_tok, long long q_head, void* out, const void* k, long long k_tok,
                  long long k_head, const void* v, long long v_tok, long long v_head, long long kv_len,
                  const int* kv_start, const int* kv_end, const float* qw, const float* qb, const float* sin,
                  const float* cos, int n_seg, int seg_len, int hq, int hk, int hd, int rot, float eps, float scale,
                  int kind, void* stream) {
  if ((kind != kV2 && kind != kGrid) || hk <= 0 || hq % hk || seg_len <= 0 || n_seg < 0 || kv_len < 0 ||
      kv_len > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.start = kv_start;
  a.end = kv_end;
  a.qw = qw;
  a.qb = qb;
  a.sin = sin;
  a.cos = cos;
  a.n_seg = n_seg;
  a.seg_len = seg_len;
  a.hq = hq;
  a.kv_len = (int)kv_len;
  a.rot = rot;
  a.eps = eps;
  a.scale = scale;
  const View vq{q, q_tok, q_head}, vk{k, k_tok, k_head}, vv{v, v_tok, v_head};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return (int)(kind == kV2 ? launch<128>(seg_attn_v2_kernel<128>, vq, out, vk, vv, a, hk, st)
                             : launch<128>(seg_attn_grid_kernel<128>, vq, out, vk, vv, a, hk, st));
  if (hd == 64)
    return (int)(kind == kV2 ? launch<64>(seg_attn_v2_kernel<64>, vq, out, vk, vv, a, hk, st)
                             : launch<64>(seg_attn_grid_kernel<64>, vq, out, vk, vv, a, hk, st));
  return (int)cudaErrorInvalidValue;
}

#ifdef MAGI_PHASE_CLOCKS
// the phase clocks into out[9], then cleared
int magi_seg_attn_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[9] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, magi::g_phase, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(magi::g_phase, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // extern "C"
