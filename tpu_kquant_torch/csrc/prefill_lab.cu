// prefill_lab: the prefill-attention lab's three variants of causal GQA
// attention of T queries at positions q_start[b] + t against S bf16 cache
// slots (slot j holds position j), q grouped as [B, Hkv, G, T, D].
//
// Replaces the TPU kernels of the reference's lab scripts:
//   #17 tools_prefill_lab2.py:call_a (kernel _kernel_a): one-shot;
//   #18 tools_prefill_lab2.py:call_b (kernel _kernel_b): S-tiled online;
//   #19 tools_prefill_lab3.py:call_g (kernel _kernel_g): two-phase causal skip.
// Their numerics, common to all three: QK^T on bf16 operands with f32 sums,
// times scale; masked logits (kv > q_pos) are -1e30, so their p is
// exp(-1e30 - m) = 0; the row sum l is taken in f32 before P is rounded to
// bf16 for P V, which sums in f32; the output is bf16(acc / l).
//   A: every (query, slot) pair; the final row max m before any exp.
//   B: ts-slot tiles in order; dead tiles (tile start after the block's last
//      query) skipped, interior tiles (tile end <= the block's first query)
//      unmasked, diagonal tiles masked; per tile m_new = max(m, tile max),
//      alpha = exp(m - m_new), l = l alpha + sum p, acc = acc alpha + P V;
//      l floored at 1e-20. Slots >= S are masked and their V rows zeroed
//      (the reference reads past S there: its fault 1).
//   G: phase 1 puts the live ts-slot tiles' logits into an S-wide f32
//      scratch and takes the row max; phase 2 runs exp(s - m), l and P V
//      over the same tiles; slots >= S masked, V rows zeroed; l floored.
//
// Bound: bytes at TinyLlama's pp512 layer (T 512, S 704, 32 / 4 heads of
// 64): 4.72 MB of q, k, v and output (1.41 us at 3.35 TB/s) against 1.08
// GFLOP of causal pairs (1.09 us at 989 TFLOP/s bf16); operations at T = S =
// 2048: 17.2 GFLOP (17.4 us) against 18.9 MB (5.6 us).
//
// Design (simple first: mma.sync m16n8k16, no wgmma, TMA or cp.async):
// - GQA sharing: a block holds 16 queries [t0, t0 + 16) of W of its KV
//   head's G query heads, one warp each (W divides G, at most 8), so one
//   K/V sub-tile staged in shared memory serves W heads. The TPU's block of
//   tq queries x G heads is tq / 16 x G / W blocks here; a block drops only
//   tiles that are dead for all its rows, which never changes the result,
//   so tq changes neither the work nor the result on this card. The grid's
//   x axis runs the latest (heaviest) query tiles first.
// - K and V stream through shared memory in 64-slot sub-tiles (K row-major,
//   V transposed, both bf16, so the products read 32-bit fragment pairs);
//   slots past S are staged as zeros. Each warp keeps its Q rows as A
//   fragments in registers; m, l and acc are f32 registers of the
//   accumulator layout, reduced over the 4 lanes that share a row.
// - A holds no logits: it computes QK twice (pass 1 the row max, pass 2
//   exp and P V), because G is the variant that stores them. B stores one
//   ts tile's logits, G every live tile's, in a per-warp f32 scratch in
//   dynamic shared memory (lane-major: each lane reads back what it wrote).
//   G's scratch is 16 rows x S x 4 bytes a warp (131 KB at S = 2048), so
//   the launch picks W from S: the most heads whose scratch fits the 227 KB
//   beside the K/V sub-tiles (tkq_prefill_lab_heads).
// - B and G skip at the granularity of their ts tile, as the reference
//   does: a live tile is computed whole (its dead sub-tiles masked), so the
//   ts sweep measures what the tile size costs on the diagonal.
#include "common.cuh"

namespace tkq {
namespace plab {

constexpr int KT = 64;        // cache slots per staged sub-tile
constexpr int QB = 16;        // queries per block: one mma row block per warp
constexpr int MAX_WARPS = 8;  // query heads per block at most
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int SUB_FLOATS = (KT / 8) * 4 * 32;  // a warp's scratch per sub-tile
constexpr float NEG = -1e30f;

enum Variant { VA = 0, VB = 1, VG = 2 };

struct LabArgs {
  const __nv_bfloat16* q;  // [B, Hkv, G, T, D] contiguous
  const __nv_bfloat16* k;  // [B, Hkv, S, D] contiguous
  const __nv_bfloat16* v;
  const int* q_start;  // [B]
  __nv_bfloat16* out;  // [B, Hkv, G, T, D] contiguous
  int B, Hkv, G, T, S;
  float scale;
  int ts;     // B, G: slots per S tile (min(ts, S); a multiple of 64 unless S <= ts)
  int heads;  // warps a block, one query head each; divides G
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// c += A (16x16, row) * B (16x8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage slots [0, KT) of kb (n of them exist; the rest are zeros) as
// kt[slot][d], lane i taking slot i % KT so that neighbours write neighbours.
template <int D>
__device__ __forceinline__ void stage_k(__nv_bfloat16* kt, const __nv_bfloat16* kb, int n) {
  for (int i = threadIdx.x; i < KT * D / 8; i += blockDim.x) {
    const int slot = i % KT, c = (i / KT) * 8;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (slot < n) r = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)slot * D + c));
    *reinterpret_cast<uint4*>(kt + slot * (D + 8) + c) = r;
  }
}

// The same for V, transposed: vt[d][slot]; rows past the n that exist are zeros
template <int D>
__device__ __forceinline__ void stage_v(__nv_bfloat16* vt, const __nv_bfloat16* vb, int n) {
  for (int i = threadIdx.x; i < KT * D / 8; i += blockDim.x) {
    const int slot = i % KT, c = (i / KT) * 8;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (slot < n) r = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)slot * D + c));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c + j) * (KT + 8) + slot] = e[j];
  }
}

// The lanes' view of one warp: fragment row group g (rows g and g + 8),
// lane t4 in the group (columns t4 * 2, + 1 of each 8-wide n-tile).
struct Lane {
  int g, t4;
};

template <int D>
__device__ __forceinline__ void qk(float (&s)[KT / 8][4], const uint32_t (&qa)[D / 16][4],
                                   const __nv_bfloat16* kt, Lane ln) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kr = kt + (nt * 8 + ln.g) * (D + 8) + kk * 16 + ln.t4 * 2;
      mma(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
    }
  }
}

// s = s * scale, then -1e30 where `masked` and the slot s0 + col lies after
// the row's position (qp0 for rows g, qp0 + 8 for rows g + 8) or past S
__device__ __forceinline__ void scale_mask(float (&s)[KT / 8][4], float scale, bool masked, int s0,
                                           int qp0, int S, Lane ln) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale;
      if (masked) {
        const int kv = s0 + nt * 8 + ln.t4 * 2 + (e & 1), qp = qp0 + (e >> 1) * 8;
        if (kv > qp || kv >= S) x = NEG;
      }
      s[nt][e] = x;
    }
}

__device__ __forceinline__ void row_max(float (&m)[2], const float (&s)[KT / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
}

__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

// p = exp(s - m) in place; l += p (f32, before the bf16 rounding of P V)
__device__ __forceinline__ void exp_sum(float (&s)[KT / 8][4], const float (&m)[2],
                                        float (&l)[2]) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - m[e >> 1]);
      l[e >> 1] += s[nt][e];
    }
}

// o += bf16(P) V: the accumulators of slots 16kk.. and 16kk + 8.. are the A
// fragment of k-step kk
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[KT / 8][4],
                                   const __nv_bfloat16* vt, Lane ln) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint32_t pa[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                            pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* vr = vt + (dt * 8 + ln.g) * (KT + 8) + kk * 16 + ln.t4 * 2;
      mma(o[dt], pa, ld32(vr), ld32(vr + 8));
    }
  }
}

// A warp's logits of one sub-tile in its scratch, lane-major (conflict-free)
__device__ __forceinline__ void put(float* sc, const float (&s)[KT / 8][4], int lane) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[(nt * 4 + e) * 32 + lane] = s[nt][e];
}

__device__ __forceinline__ void get(float (&s)[KT / 8][4], const float* sc, int lane) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = sc[(nt * 4 + e) * 32 + lane];
}

// Where a block and its warp stand: block (query tile, KV head and group of
// W heads, batch row), warp w the group's head w.
template <int D>
struct Block {
  Lane ln;
  int lane, rows, qp0, blk_lo, blk_hi;
  const __nv_bfloat16 *kb, *vb;
  __nv_bfloat16* orow;  // the warp's first output row
  uint32_t qa[D / 16][4];

  __device__ __forceinline__ explicit Block(const LabArgs& a) {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    ln = Lane{lane / 4, lane % 4};
    const int t0 = (gridDim.x - 1 - blockIdx.x) * QB;  // heaviest query tiles first
    const int groups = a.G / a.heads;
    const int hk = blockIdx.y / groups, head = (blockIdx.y % groups) * a.heads + warp;
    const int b = blockIdx.z, qs = a.q_start[b];
    rows = min(QB, a.T - t0);
    qp0 = qs + t0 + ln.g;
    blk_lo = qs + t0;
    blk_hi = qs + t0 + rows - 1;
    const size_t kvoff = ((size_t)b * a.Hkv + hk) * a.S * D;
    kb = a.k + kvoff;
    vb = a.v + kvoff;
    const size_t qoff = ((((size_t)b * a.Hkv + hk) * a.G + head) * a.T + t0) * D;
    orow = a.out + qoff;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ln.g + (r & 1) * 8, col = kk * 16 + ln.t4 * 2 + (r >= 2 ? 8 : 0);
        qa[kk][r] = row < rows ? ld32(a.q + qoff + (size_t)row * D + col) : 0u;
      }
  }

  // out = bf16(o / l), l summed over the row's 4 lanes and floored at `floor`
  __device__ __forceinline__ void store(const float (&o)[D / 8][4], float (&l)[2], float floor) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], floor);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ln.g + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + (size_t)row * D + dt * 8 + ln.t4 * 2) =
            pack2(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
    }
  }
};

template <int D>
__device__ __forceinline__ void zero(float (&o)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
}

// #17, variant A: every sub-tile of S, masked; pass 1 the row max, pass 2
// exp, l and P V on the same logits computed again
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) lab_a_kernel(LabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vt = kt + KT * (D + 8);
  Block<D> bk(a);
  const int nsub = (a.S + KT - 1) / KT;
  float s[KT / 8][4], m[2] = {NEG, NEG};
  for (int c = 0; c < nsub; ++c) {
    const int s0 = c * KT;
    __syncthreads();  // the previous sub-tile is consumed
    stage_k<D>(kt, bk.kb + (size_t)s0 * D, min(KT, a.S - s0));
    __syncthreads();
    qk<D>(s, bk.qa, kt, bk.ln);
    scale_mask(s, a.scale, true, s0, bk.qp0, a.S, bk.ln);
    row_max(m, s);
  }
  quad_max(m);
  float o[D / 8][4], l[2] = {0.f, 0.f};
  zero<D>(o);
  for (int c = 0; c < nsub; ++c) {
    const int s0 = c * KT, n = min(KT, a.S - s0);
    __syncthreads();
    stage_k<D>(kt, bk.kb + (size_t)s0 * D, n);
    stage_v<D>(vt, bk.vb + (size_t)s0 * D, n);
    __syncthreads();
    qk<D>(s, bk.qa, kt, bk.ln);
    scale_mask(s, a.scale, true, s0, bk.qp0, a.S, bk.ln);
    exp_sum(s, m, l);
    pv<D>(o, s, vt, bk.ln);
  }
  bk.store(o, l, 0.f);
}

// #18, variant B: online softmax over the live ts tiles; a tile's logits go
// to the warp's scratch so that its max is known before any exp
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) lab_b_kernel(LabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vt = kt + KT * (D + 8);
  const int nsub = (a.ts + KT - 1) / KT;  // sub-tiles a tile
  float* sc = reinterpret_cast<float*>(vt + D * (KT + 8)) + (threadIdx.x / 32) * nsub * SUB_FLOATS;
  Block<D> bk(a);
  const int nS = (a.S + a.ts - 1) / a.ts;
  float s[KT / 8][4], o[D / 8][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  zero<D>(o);
  for (int j = 0; j < nS; ++j) {
    const int ts0 = j * a.ts;
    if (ts0 > bk.blk_hi) break;  // dead for every row of the block, as are the later tiles
    const bool interior = ts0 + a.ts - 1 <= bk.blk_lo;
    float mt[2] = {m[0], m[1]};
    for (int u = 0; u < nsub; ++u) {
      const int s0 = ts0 + u * KT;
      if (s0 >= a.S) break;  // slots past S: masked, never read
      __syncthreads();
      stage_k<D>(kt, bk.kb + (size_t)s0 * D, min(KT, a.S - s0));
      __syncthreads();
      qk<D>(s, bk.qa, kt, bk.ln);
      scale_mask(s, a.scale, !interior || s0 + KT > a.S, s0, bk.qp0, a.S, bk.ln);
      row_max(mt, s);
      put(sc + u * SUB_FLOATS, s, bk.lane);
    }
    quad_max(mt);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    for (int u = 0; u < nsub; ++u) {
      const int s0 = ts0 + u * KT;
      if (s0 >= a.S) break;
      __syncthreads();
      stage_v<D>(vt, bk.vb + (size_t)s0 * D, min(KT, a.S - s0));
      __syncthreads();
      get(s, sc + u * SUB_FLOATS, bk.lane);
      exp_sum(s, m, l);
      pv<D>(o, s, vt, bk.ln);
    }
  }
  bk.store(o, l, 1e-20f);
}

// #19, variant G: phase 1 the live ts tiles' logits into the warp's S-wide
// scratch and the row max; phase 2 exp, l and P V over the same sub-tiles
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) lab_g_kernel(LabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vt = kt + KT * (D + 8);
  const int nsub_s = (a.S + KT - 1) / KT;  // sub-tiles of S: the scratch's width
  float* sc =
      reinterpret_cast<float*>(vt + D * (KT + 8)) + (threadIdx.x / 32) * nsub_s * SUB_FLOATS;
  Block<D> bk(a);
  const int nsub = (a.ts + KT - 1) / KT, nS = (a.S + a.ts - 1) / a.ts;
  float s[KT / 8][4], m[2] = {NEG, NEG};
  int live = 0;  // sub-tiles of S that phase 1 wrote
  for (int j = 0; j < nS; ++j) {
    const int ts0 = j * a.ts;
    if (ts0 > bk.blk_hi) break;
    const bool interior = ts0 + a.ts - 1 <= bk.blk_lo;
    for (int u = 0; u < nsub; ++u) {
      const int s0 = ts0 + u * KT;
      if (s0 >= a.S) break;
      __syncthreads();
      stage_k<D>(kt, bk.kb + (size_t)s0 * D, min(KT, a.S - s0));
      __syncthreads();
      qk<D>(s, bk.qa, kt, bk.ln);
      scale_mask(s, a.scale, !interior || s0 + KT > a.S, s0, bk.qp0, a.S, bk.ln);
      row_max(m, s);
      put(sc + (s0 / KT) * SUB_FLOATS, s, bk.lane);
      live = s0 / KT + 1;
    }
  }
  quad_max(m);
  float o[D / 8][4], l[2] = {0.f, 0.f};
  zero<D>(o);
  for (int c = 0; c < live; ++c) {  // the live tiles are a prefix of S
    const int s0 = c * KT;
    __syncthreads();
    stage_v<D>(vt, bk.vb + (size_t)s0 * D, min(KT, a.S - s0));
    __syncthreads();
    get(s, sc + c * SUB_FLOATS, bk.lane);
    exp_sum(s, m, l);
    pv<D>(o, s, vt, bk.ln);
  }
  bk.store(o, l, 1e-20f);
}

constexpr int kv_smem(int D) { return (KT * (D + 8) + D * (KT + 8)) * 2; }

// scratch bytes a warp: none for A, one ts tile for B, the sub-tiles of S for G
inline int warp_smem(int variant, int S, int ts) {
  const int nsub = variant == VA ? 0 : variant == VB ? (ts + KT - 1) / KT : (S + KT - 1) / KT;
  return nsub * SUB_FLOATS * 4;
}

inline int heads_for(int variant, int D, int G, int S, int ts) {
  for (int w = G < MAX_WARPS ? G : MAX_WARPS; w >= 1; --w)
    if (G % w == 0 && kv_smem(D) + w * warp_smem(variant, S, ts) <= SMEM_MAX) return w;
  return 0;
}

template <int D>
cudaError_t launch(int variant, LabArgs a, cudaStream_t st) {
  void (*kern)(LabArgs) =
      variant == VA ? &lab_a_kernel<D> : variant == VB ? &lab_b_kernel<D> : &lab_g_kernel<D>;
  const int smem = kv_smem(D) + a.heads * warp_smem(variant, a.S, a.ts);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + QB - 1) / QB, a.Hkv * (a.G / a.heads), a.B);
  kern<<<grid, a.heads * 32, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace plab
}  // namespace tkq

using namespace tkq::plab;

// Query heads a block of `variant` (0 A, 1 B, 2 G) holds at these shapes:
// the largest divisor of G up to 8 whose scratch fits the block's shared
// memory; 0 if not even one head's does.
extern "C" int tkq_prefill_lab_heads(int variant, int D, int G, int S, int ts) {
  return heads_for(variant, D, G, S, ts);
}

// Requires bf16 q, k, v and out, contiguous, D in {64, 128}, q_start[b] >= 0;
// ts (B, G) in (0, S], a multiple of 64 unless it equals S. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int tkq_prefill_lab(int variant, int D, const void* q, const void* k, const void* v,
                               const int* q_start, void* out, int B, int Hkv, int G, int T,
                               int S, float scale, int ts, void* stream) {
  const int heads = heads_for(variant, D, G, S, ts);
  if (heads == 0 || variant < VA || variant > VG) return (int)cudaErrorInvalidValue;
  LabArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), q_start, static_cast<__nv_bfloat16*>(out),
            B, Hkv, G, T, S, scale, variant == VA ? S : ts, heads};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64>(variant, a, st);
  if (D == 128) return (int)launch<128>(variant, a, st);
  return (int)cudaErrorInvalidValue;
}
