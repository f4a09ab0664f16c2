// prefill: flash (online-softmax) causal GQA attention of T queries at
// positions q_start[b] + t against S cache slots (slot j holds position j),
// over a bf16 or int8 (per-slot f32 scales) heads-major KV cache, as a
// TMA-fed, warp-specialised wgmma kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_prefill.py:
// attention_prefill_pallas (_prefill_call, pallas_call :168, body
// _prefill_kernel :37), with its numerics: QK^T on bf16 operands with f32
// sums, then * scale, then * k_scale[col] for int8 KV; masked logits (kv >
// q_pos, or kv <= q_pos - window with a window) take no part in the max and
// get p = 0; the row sum l is taken before p * v_scale[col]; P is rounded
// to bf16 for PV; l is floored at 1e-20; the output is bf16 (the wrapper
// casts an f32 q, which qwen2's biases give prefill, and widens the
// output). The softmax runs in the base-2 domain (ex2 of the logits times
// scale * log2 e), which moves p by float rounding only. No [T, S] logit
// ever reaches device memory.
//
// Bound on the H100: operations. At TinyLlama's longest prompt (T = S =
// 2048, 32 query heads of 64) the causal pairs need 4 * (T * S / 2) * H *
// D = 17.2 GFLOP, 17.4 us at 989 TFLOP/s bf16, against 18.9 MB of q, k, v
// and output (5.6 us at 3.35 TB/s); at head_dim 64 the exponentials (one
// per pair and head, 16 a clock per SM) take about as long as the MMA.
// The 1024-request burst (B = 1024, T = S = 64) is bound by bytes: q and
// the output are 537 MB. What the design does about it:
// - wgmma (m64nNk16, bf16 in, f32 sums in registers). S = Q K^T reads Q
//   (K-major, 128-byte swizzle) and the K tile (K-major) from shared
//   memory; O += P V takes P from registers (the S accumulators rounded to
//   bf16 pairs are the A fragment) and the V tile as it lies in the cache,
//   [slots][D] with D contiguous: MN-major B with the transposed-B bit, so
//   V is never transposed.
// - TMA, warp-specialised: one thread of a producer warpgroup (setmaxnreg
//   40) issues every copy: a work item's Q block through a 4-D map over [B,
//   T, H, D] (box {64, hw heads, nq queries}, zero fill past T) into one of
//   NQ buffers (4 at head_dim 64, 2 at 128), then its K and V tiles through
//   4-D maps over the cache's strided views [B, Hkv, S, D] (box {64, BN
//   slots}, zero fill past S) into a ring of stages with full / empty
//   mbarriers. Several items' loads are in flight while one is computed.
// - Two consumer warpgroups (setmaxnreg 232) of 64 rows each. A row is a
//   (query, head) pair of the item's KV head: nq = 64 / hw queries of hw
//   heads, query-major (the reference stacks [G * TQ] rows the same way),
//   so a K/V tile is staged once for all 128 rows it serves. Warpgroup 1
//   takes the nq queries after warpgroup 0's; both walk the item's live
//   tiles, the reference's lo_tile .. hi_tile of the item's 2 nq queries,
//   and mask by each row's own position only where a tile crosses an edge.
// - Overlap inside a warpgroup at head_dim 64 (FA3's intra-warpgroup
//   pipelining): tile j's Q K^T and tile j - 1's P V are issued together,
//   tile j's softmax runs while P V is in flight, and O is rescaled once it
//   lands. At head_dim 128 each tile's P V, Q K^T and softmax run in turn
//   (faster there, below). bf16 KV takes the row max of the raw logits
//   and one FFMA per element into ex2.
// - The output: each warpgroup rounds O / l to bf16 into a staging buffer
//   in Q's layout and stores its rows with one TMA store (clipped at T).
// - A persistent grid: min(items, SMs) blocks walk the items, heaviest query
//   blocks first, in snake order (block c takes items c, 2P - 1 - c, 2P + c,
//   ...), so long and short causal items pair up on each SM and an item's
//   loads overlap the previous item's epilogue. The host plans the items
//   (ops/prefill.py:prefill_plan); tests check that they cover every (b,
//   head, query) once and that each item's tiles are the reference's.
// - Int8 KV: a first launch (kv_bf16_kernel) converts the codes once per
//   call into bf16 copies (exact: through the f32 magic number 2^23 + 128)
//   that the bf16 path reads; bulk copies bring each tile's f32 scales into
//   its stage, and the scales apply where the reference applies them.
// Measured choices (NVIDIA H100 80GB HBM3 at 700 W, tools/prefill_sweep.py
// and tools/tile_ab.py; PERF.md §6):
// - Rows: all G heads of the KV head per warpgroup (hw = G) against one
//   head of 64 queries (hw = 1) and the divisors between: equal within 2%
//   at every T >= 40 case, and at the burst (T = 64) hw = 1 leaves
//   warpgroup 1 idle (0.605 against 0.287 ms).
// - Int8: converting in the kernel (the producer's other three warps, into
//   the stage while the consumers ran the previous tile) took 0.125-0.142 ms
//   at T = S = 2048 against 0.058 for bf16, because every item converts
//   every tile it reads (each tile about 64 times at T = S = 2048); the
//   pre-pass converts each code once: 0.077 ms.
// - Overlap (TKQ_PF_ABLATE=4 swaps the order): at T = S = 2048 overlapping
//   is faster at head_dim 64 (bf16 KV 0.0568 against 0.0634 ms serial; int8
//   0.0776 / 0.0813) and slower at 128 (0.0426 against 0.0370 serial), so
//   each takes its faster order. Ping-pong between the two consumer
//   warpgroups (named barriers, each issuing in turn) moved T = S = 2048 by
//   under 1% and slowed the burst by 11% (0.326 against 0.293 ms): not kept.
// - Tiles of 128 slots (64 for int8 KV at head_dim 128 and at head_dim
//   256, shared memory).
// - Head dim 256 (the gemma family, PfCfg): one Q buffer and one stage, so
//   loads and compute take turns; its 64 x 256 f32 accumulator (128
//   registers a thread) does not fit the 168 registers that 384 threads
//   leave a thread when ptxas compiles the kernel, so part of it lives in
//   local memory. Right first: a faster head-256 design is later work.
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

#ifndef TKQ_PF_ABLATE
// measurement builds: 1 no softmax (P = S), 2 no P V, 3 loads and barriers
// only, 4 the other tile order (pf_overlap)
#define TKQ_PF_ABLATE 0
#endif

namespace tkq {

// Tile j's softmax overlapped with tile j - 1's P V (head_dim 64), or each
// tile's P V, Q K^T and softmax in turn (128; 256, whose one stage cannot
// hold two tiles); TKQ_PF_ABLATE 4 swaps them at 64 and 128
__host__ __device__ constexpr bool pf_overlap(int D) {
  return D <= 128 && ((D == 64) != (TKQ_PF_ABLATE == 4));
}
constexpr int PF_CONSUMERS = 256;                // two warpgroups
constexpr int PF_THREADS = PF_CONSUMERS + 128;   // + the producer warpgroup
constexpr float PF_LOG2E = 1.4426950408889634f;
constexpr float PF_NEG = -1e30f;

// The kernel's tile geometry for head_dim D and the KV cache's type.
// Head dim 256 (the gemma family): Q and the output staging take 128 KB, so
// one Q buffer, tiles of 64 slots and one K/V stage (64 KB) fit; the
// producer loads tile j + 1 only once tile j is consumed.
template <int D, bool I8>
struct PfCfg {
  static constexpr int BN = (D == 256 || (D == 128 && I8)) ? 64 : 128;  // cache slots per tile
  static constexpr int NP = D / 64;                         // 128-byte panels of a row
  static constexpr int Q_HALF = 64 * D * 2;                 // one warpgroup's Q (or O) rows
  static constexpr int Q_BUF = 2 * Q_HALF;
  static constexpr int NQ = D == 64 ? 4 : D == 128 ? 2 : 1;  // Q buffers: items in flight
  static constexpr int KV_TILE = BN * D * 2;                // one bf16 K (or V) tile
  // a stage: K, V (int8 KV: then K and V scales), 1024-byte aligned
  static constexpr int STAGE = (2 * KV_TILE + (I8 ? 2 * BN * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int NS = D == 64 ? 4 : D == 128 ? (I8 ? 3 : 2) : 1;  // stages
  static constexpr int NBAR = 2 * NQ + 2 * NS;
  static constexpr int SMEM = 1024 + (NQ + 1) * Q_BUF + NS * STAGE + NBAR * 8;
};

struct PrefillArgs {
  const int* q_start;  // [B]
  const float* ks;     // [B, Hkv, S] f32 (int8 only), S dense, 16-byte aligned planes
  long long sksb, sksh;
  const float* vs;
  long long svsb, svsh;
  int B, T, H, Hkv, S;
  float scale_log2;  // scale * log2(e)
  int window;        // 0: full causal attention
  int hw, nq;        // heads and queries of a warpgroup's rows (hw * nq <= 64)
  int hg, nqb;       // head groups per KV head (G / hw), query blocks (of 2 nq)
  int n_items;
};

struct PrefillMaps {
  CUtensorMap q;    // bf16 [B][T][H][D], box {64, hw, nq, 1}, 128-byte swizzle
  CUtensorMap out;  // bf16 [B][T][H][D] (contiguous), as q
  CUtensorMap k;    // bf16 [B][Hkv][S][D] (int8: the converted copy), box {64, BN, 1, 1},
  CUtensorMap v;    // 128-byte swizzle
};

// Work item i: (b, KV head hk, first query head h0, first query t0), query
// blocks in descending order (the latest queries, the heaviest, first).
struct Item {
  int b, hk, h0, t0, lo, hi;
};
template <int BN>
__device__ __forceinline__ Item item_of(int i, const PrefillArgs& a) {
  Item it;
  const int per = a.B * a.Hkv * a.hg;
  const int qb = a.nqb - 1 - i / per;
  int r = i % per;
  const int g = r % a.hg;
  r /= a.hg;
  it.hk = r % a.Hkv;
  it.b = r / a.Hkv;
  it.h0 = it.hk * (a.H / a.Hkv) + g * a.hw;
  it.t0 = qb * 2 * a.nq;
  // the reference's hi_tile / lo_tile over the item's queries
  const int qs = a.q_start[it.b];
  const int blk_lo = qs + it.t0, blk_hi = qs + min(it.t0 + 2 * a.nq, a.T) - 1;
  it.hi = min(blk_hi / BN, (a.S + BN - 1) / BN - 1);
  it.lo = a.window > 0 ? max((blk_lo - (a.window - 1)) / BN, 0) : 0;
  return it;
}
// the k-th item of block c of P, in snake order; -1 past the last
__device__ __forceinline__ int item_index(int k, int c, int P, int n) {
  const int i = k * P + ((k & 1) ? P - 1 - c : c);
  return k * P < n && i < n ? i : -1;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 int8 codes (one uint4) -> 16 bf16 (two uint4), exactly
__device__ __forceinline__ void codes_bf16(uint4 c, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                         c.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = pack_bf16(ubyte_f<0>(w[j], 8388736.0f), ubyte_f<1>(w[j], 8388736.0f));
    o[2 * j + 1] = pack_bf16(ubyte_f<2>(w[j], 8388736.0f), ubyte_f<3>(w[j], 8388736.0f));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// a 16-byte piece of row r, 8-element chunk c, of a [rows][64] panel in the
// 128-byte swizzle (TMA's SWIZZLE_128B layout)
__device__ __forceinline__ uint32_t sw128(int r, int c) { return r * 128 + ((c ^ (r % 8)) * 16); }

// Int8 KV: the codes of K (blockIdx.y 0) and V (1) [B, Hkv, S, D] (strided
// views, rows dense) to bf16 copies [B, Hkv, S, D], once per call; 16 codes
// a thread.
__global__ void kv_bf16_kernel(const int8_t* k, long long skb, long long skh, const int8_t* v,
                               long long svb, long long svh, __nv_bfloat16* kd,
                               __nv_bfloat16* vd, int Hkv, int S, int D, long long n16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n16) return;
  const bool isv = blockIdx.y == 1;
  const long long e = i * 16, row = e / D;  // row = (b * Hkv + h) * S + slot
  const long long slot = row % S, bh = row / S, h = bh % Hkv, b = bh / Hkv;
  const int8_t* src = (isv ? v + b * svb + h * svh : k + b * skb + h * skh) + slot * D + e % D;
  uint4 lo, hi;
  codes_bf16(*reinterpret_cast<const uint4*>(src), lo, hi);
  uint4* dst = reinterpret_cast<uint4*>((isv ? vd : kd) + e);
  dst[0] = lo;
  dst[1] = hi;
}

template <int D, bool I8>
__global__ void __launch_bounds__(PF_THREADS, 1)
    prefill_kernel(const __grid_constant__ PrefillMaps maps, const PrefillArgs a) {
  using C = PfCfg<D, I8>;
  constexpr int BN = C::BN, NS = C::NS, NQ = C::NQ, NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qbuf = base;                     // [NQ][Q_BUF]
  unsigned char* obuf = qbuf + NQ * C::Q_BUF;     // [Q_BUF]: the output's staging
  unsigned char* ring = obuf + C::Q_BUF;          // [NS][K tile, V tile (, K, V scales)]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + NS * C::STAGE);
  const uint32_t qfull0 = smem_u32(bars), qempty0 = qfull0 + 8 * NQ;
  const uint32_t full0 = qempty0 + 8 * NQ, empty0 = full0 + 8 * NS;

  const int tid = threadIdx.x;
  const int P = gridDim.x, c = blockIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NQ; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(qempty0 + 8 * i, PF_CONSUMERS / 32);
    }
    for (int i = 0; i < NS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, PF_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (I8) {  // the scales past S are never loaded: keep them finite
    for (int e = tid; e < NS * 2 * BN; e += PF_THREADS)
      reinterpret_cast<float*>(ring + (e / (2 * BN)) * C::STAGE + 2 * C::KV_TILE)[e % (2 * BN)] =
          0.f;
    fence_async_smem();
  }
  __syncthreads();

  if (tid >= PF_CONSUMERS) {
    // the producer: one thread issues every copy, each item's Q block, then
    // its K/V tiles (and int8 KV's scales) into the stage ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid != PF_CONSUMERS) return;
    int st = 0;
    for (int k = 0;; ++k) {
      const int i = item_index(k, c, P, a.n_items);
      if (i < 0) break;
      const Item it = item_of<BN>(i, a);
      const int qslot = k % NQ;
      const uint32_t qb = smem_u32(qbuf + qslot * C::Q_BUF);
      if (k >= NQ) mbar_wait(qempty0 + 8 * qslot, ((k / NQ) - 1) & 1);
      const bool second = it.t0 + a.nq < a.T;  // warpgroup 1 has queries
      mbar_expect_tx(qfull0 + 8 * qslot, (second ? 2 : 1) * a.hw * a.nq * D * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 1 && !second) break;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_4d(qb + w * C::Q_HALF + p * 8192, &maps.q, 64 * p, it.h0, it.t0 + w * a.nq, it.b,
                 qfull0 + 8 * qslot);
      }
      for (int j = it.lo; j <= it.hi; ++j, ++st) {
        const int s = st % NS;
        if (st >= NS) mbar_wait(empty0 + 8 * s, ((st / NS) - 1) & 1);
        const uint32_t sd = smem_u32(ring + s * C::STAGE), bar = full0 + 8 * s;
        const int nsc = min(BN, a.S - j * BN);  // scales below S (S % 64 == 0)
        mbar_expect_tx(bar, 2 * C::KV_TILE + (I8 ? 2 * nsc * 4 : 0));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_4d(sd + p * BN * 128, &maps.k, 64 * p, j * BN, it.hk, it.b, bar);
          tma_4d(sd + C::KV_TILE + p * BN * 128, &maps.v, 64 * p, j * BN, it.hk, it.b, bar);
        }
        if constexpr (I8) {
          bulk_load(sd + 2 * C::KV_TILE, a.ks + it.b * a.sksb + it.hk * a.sksh + j * BN,
                    nsc * 4, bar);
          bulk_load(sd + 2 * C::KV_TILE + BN * 4, a.vs + it.b * a.svsb + it.hk * a.svsh + j * BN,
                    nsc * 4, bar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumers: warpgroup wg, warp w of it, rows 16 w + g and 16 w + g + 8
  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const bool leader = tid % 128 == 0;  // issues the warpgroup's output stores
  unsigned char* ob = obuf + wg * C::Q_HALF;
  int st = 0;
  for (int k = 0;; ++k) {
    const int i = item_index(k, c, P, a.n_items);
    if (i < 0) break;
    const Item it = item_of<BN>(i, a);
    const int qslot = k % NQ;
    const int qs = a.q_start[it.b], t0w = it.t0 + wg * a.nq;
    int pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) pos[r] = qs + t0w + (16 * w + g + 8 * r) / a.hw;
    const int wg_lo = qs + t0w, wg_hi = qs + t0w + a.nq - 1;
    const uint32_t qa = smem_u32(qbuf + qslot * C::Q_BUF + wg * C::Q_HALF);

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    // the row max (bf16 KV: of the raw logits; int8: of logits * scale *
    // log2 e * k_scale) and the row sum
    float m[2] = {PF_NEG, PF_NEG}, l[2] = {0.f, 0.f};
    float sacc[BN / 2];
    uint32_t pf[BN / 16][4];

    mbar_wait(qfull0 + 8 * qslot, (k / NQ) & 1);

    // S = Q K^T of stage s into sacc
    auto qk = [&](int s) {
      const uint32_t kb = smem_u32(ring + s * C::STAGE);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * BN * 128 + (kk % 4) * 32;
        Wgmma<BN, 0>::ss(sacc, gmma_desc(qa + off, 16, 1024, 1), gmma_desc(kb + koff, 16, 1024, 1),
                         kk > 0);
      }
    };
    // O += P V of stage s; at head_dim 256 as two products of N = 128 over
    // the two halves of V's columns (panels 0-1 and 2-3), whose
    // accumulators are o's two halves in the same fragment order
    auto pv = [&](int s) {
      const uint32_t vb = smem_u32(ring + s * C::STAGE + C::KV_TILE);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if constexpr (D <= 128) {
          Wgmma<D, 1>::rs(o, pf[kk], gmma_desc(vb + kk * 16 * 128, BN * 128, 1024, 1), 1);
        } else {
#pragma unroll
          for (int h = 0; h < D / 128; ++h)
            Wgmma<128, 1>::rs(*reinterpret_cast<float(*)[64]>(o + 64 * h), pf[kk],
                              gmma_desc(vb + h * 2 * BN * 128 + kk * 16 * 128, BN * 128, 1024, 1),
                              1);
        }
      }
    };
    // the online softmax of tile j (stage s) on sacc, leaving p (times the
    // V scales) in sacc; returns the rescale of the rows' earlier sums
    auto softmax = [&](int j, int s, float (&alpha)[2]) {
      const int s0 = j * BN;
      const bool edge = s0 + BN - 1 > wg_lo || (a.window > 0 && s0 <= wg_hi - a.window) ||
                        s0 + BN > a.S;
      // int8 KV: the stage's K scales, then its V scales (past S: masked
      // columns whose p is 0, so only finite values matter)
      const float* ksc = reinterpret_cast<const float*>(ring + s * C::STAGE + 2 * C::KV_TILE);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t4 + (e & 1), r = e >> 1;
          float x = sacc[4 * n + e];
          if constexpr (I8) x = x * a.scale_log2 * ksc[col];
          if (edge) {
            const int kv = s0 + col;
            if (kv > pos[r] || (a.window > 0 && kv <= pos[r] - a.window) || kv >= a.S)
              x = -INFINITY;
          }
          sacc[4 * n + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      float nm[2];  // -max in the base-2 domain
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if constexpr (I8) {
          alpha[r] = ex2(m[r] - mx[r]);
          nm[r] = -mx[r];
        } else {
          alpha[r] = ex2((m[r] - mx[r]) * a.scale_log2);
          nm[r] = -mx[r] * a.scale_log2;
        }
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p;  // masked: ex2(-inf) = 0
          if constexpr (I8) p = ex2(sacc[4 * n + e] + nm[r]);
          else p = ex2(fmaf(sacc[4 * n + e], a.scale_log2, nm[r]));
          rs[r] += p;  // the sum before the V scales
          if constexpr (I8) p *= ksc[BN + 8 * n + 2 * t4 + (e & 1)];
          sacc[4 * n + e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    };

    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    };

    if (it.lo <= it.hi) {
      int s = st % NS;
      mbar_wait(full0 + 8 * s, (st / NS) & 1);
      float alpha[2];
      if constexpr (TKQ_PF_ABLATE != 3) {
        wgmma_fence();
        qk(s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        if constexpr (TKQ_PF_ABLATE != 1) softmax(it.lo, s, alpha);
        pack_p();
      }
      int prev = s;
      ++st;
      for (int j = it.lo + 1; j <= it.hi; ++j, ++st) {
        s = st % NS;
        // tile j may land in tile j - 1's stage (one stage at head_dim 256):
        // where P V of tile j - 1 comes first, that stage is released first
        const auto wait_full = [&] { mbar_wait(full0 + 8 * s, (st / NS) & 1); };
        if constexpr (TKQ_PF_ABLATE == 3) {
          release(prev);
          wait_full();
        } else if constexpr (!pf_overlap(D)) {  // P V, then Q K^T, then the softmax
          if constexpr (TKQ_PF_ABLATE != 2) {
            wgmma_fence();
            pv(prev);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pf);
          }
          release(prev);
          wait_full();
          wgmma_fence();
          qk(s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          if constexpr (TKQ_PF_ABLATE != 1) {
            softmax(j, s, alpha);
            rescale(alpha);
          }
          pack_p();
        } else {
          // tile j's Q K^T with tile j - 1's P V; tile j's softmax while P V runs
          static_assert(NS > 1 || !pf_overlap(D), "the overlap needs two stages");
          wait_full();
          wgmma_fence();
          qk(s);
          wgmma_commit();
          if constexpr (TKQ_PF_ABLATE != 2) pv(prev);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sacc);
          if constexpr (TKQ_PF_ABLATE != 1) softmax(j, s, alpha);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pf);
          release(prev);
          if constexpr (TKQ_PF_ABLATE != 1) rescale(alpha);
          pack_p();
        }
        prev = s;
      }
      if constexpr (TKQ_PF_ABLATE != 3 && TKQ_PF_ABLATE != 2) {
        wgmma_fence();
        pv(prev);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pf);
      }
      release(prev);
    }
    if (lane == 0) mbar_arrive(qempty0 + 8 * qslot);  // this item's Q is consumed

    // epilogue: O / l in bf16 into the warpgroup's staging rows (the layout
    // TMA loaded Q in), then one TMA store of its queries (clipped at T)
    if (leader) bulk_wait<true>();  // the previous item's store has read the staging
    named_sync(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-20f);  // rows with no live slot divide safely
      const int row = 16 * w + g + 8 * r;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + (n / 8) * 8192 + sw128(row, n % 8) + 4 * t4) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (leader && t0w < a.T) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_store_4d(&maps.out, smem_u32(ob + p * 8192), 64 * p, it.h0, t0w, it.b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait<false>();
}

template <int D, bool I8>
cudaError_t launch_prefill(const void* q, const long long (&sq)[3], const void* k,
                           const long long (&sk)[2], const void* v, const long long (&sv)[2],
                           void* kd, void* vd, void* out, const PrefillArgs& a, int grid,
                           cudaStream_t st) {
  using C = PfCfg<D, I8>;
  if (I8) {  // the int8 codes to bf16 copies, read by the kernel's K/V maps
    const long long n16 = (long long)a.B * a.Hkv * a.S * D / 16;
    kv_bf16_kernel<<<dim3((unsigned)((n16 + 255) / 256), 2), 256, 0, st>>>(
        static_cast<const int8_t*>(k), sk[0], sk[1], static_cast<const int8_t*>(v), sv[0], sv[1],
        static_cast<__nv_bfloat16*>(kd), static_cast<__nv_bfloat16*>(vd), a.Hkv, a.S, D, n16);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  PrefillMaps maps;
  memset(&maps, 0, sizeof(maps));
  const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)a.H, (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t qst[3] = {(cuuint64_t)sq[2] * 2, (cuuint64_t)sq[1] * 2, (cuuint64_t)sq[0] * 2};
  const cuuint64_t ost[3] = {(cuuint64_t)D * 2, (cuuint64_t)a.H * D * 2,
                             (cuuint64_t)a.T * a.H * D * 2};
  const cuuint32_t qbox[4] = {64, (cuuint32_t)a.hw, (cuuint32_t)a.nq, 1};
  bool ok = encode_map(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, qd, qst, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && encode_map(&maps.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, qd, ost, qbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t kvd[4] = {(cuuint64_t)D, (cuuint64_t)a.S, (cuuint64_t)a.Hkv, (cuuint64_t)a.B};
  const cuuint32_t kvbox[4] = {64, (cuuint32_t)C::BN, 1, 1};
  // the cache's strided views; int8: the contiguous copies
  const cuuint64_t kst[3] = {(cuuint64_t)D * 2, (cuuint64_t)(I8 ? a.S * D : sk[1]) * 2,
                             (cuuint64_t)(I8 ? (long long)a.Hkv * a.S * D : sk[0]) * 2};
  const cuuint64_t vst[3] = {(cuuint64_t)D * 2, (cuuint64_t)(I8 ? a.S * D : sv[1]) * 2,
                             (cuuint64_t)(I8 ? (long long)a.Hkv * a.S * D : sv[0]) * 2};
  ok = ok && encode_map(&maps.k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, I8 ? kd : k, kvd, kst, kvbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && encode_map(&maps.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, I8 ? vd : v, kvd, vst, kvbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(prefill_kernel<D, I8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  prefill_kernel<D, I8><<<grid, PF_THREADS, C::SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace tkq

using namespace tkq;

// Requires bf16 q and out, D in {64, 128, 256}, S % 64 == 0, H % Hkv == 0, the
// plan's hw (a divisor of H / Hkv, at most 64), nq = 64 / hw, hg = H / Hkv
// / hw, nqb = ceil(T / (2 nq)), n_items = B * Hkv * hg * nqb and grid <=
// n_items blocks; q, out and K/V 16-byte aligned with 16-byte-multiple
// strides (TMA; out contiguous), K/V rows of D dense, q_start[b] >= 0; int8
// KV: 16-byte aligned scale planes and bf16 scratch kd, vd [B, Hkv, S, D].
// Strides are in elements. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int tkq_prefill(int kv_i8, int D, const void* q, long long sqb, long long sqt,
                           long long sqh, const void* k, long long skb, long long skh,
                           const void* v, long long svb, long long svh, const float* ks,
                           long long sksb, long long sksh, const float* vs, long long svsb,
                           long long svsh, void* kd, void* vd, const int* q_start, void* out,
                           int B, int T, int H, int Hkv, int S, float scale, int window, int hw,
                           int nq, int hg, int nqb, int n_items, int grid, void* stream) {
  PrefillArgs a{q_start, ks, sksb, sksh, vs, svsb, svsh, B, T, H, Hkv, S,
                scale * PF_LOG2E, window, hw, nq, hg, nqb, n_items};
  const long long sq[3] = {sqb, sqt, sqh}, sk[2] = {skb, skh}, sv[2] = {svb, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hw < 1 || hw * nq > 64 || grid < 1 || grid > n_items) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)(kv_i8 ? launch_prefill<64, true>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st)
                       : launch_prefill<64, false>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st));
  if (D == 128)
    return (int)(kv_i8
                     ? launch_prefill<128, true>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st)
                     : launch_prefill<128, false>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st));
  if (D == 256)
    return (int)(kv_i8
                     ? launch_prefill<256, true>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st)
                     : launch_prefill<256, false>(q, sq, k, sk, v, sv, kd, vd, out, a, grid, st));
  return (int)cudaErrorInvalidValue;
}
