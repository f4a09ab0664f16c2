// The tensor-core core of flash (online-softmax) decode attention, one query
// token per batch row, and the few-row kernel built on it.
//
// The core (tile geometry, cp.async ring loads, ldmatrix / mma.sync
// fragments, int8 codes turned into bf16 in registers, the softmax on the
// accumulator fragments) serves two kernels:
// - decode_attn.cu's flash decode (#7): a persistent grid over the live
//   (row, split) pairs of many rows;
// - fused_attn_kernel below: the attention phase of attn_out.cu (#10) and
//   of layer.cu (#11), at a few rows (B <= 16 and B <= 4).
//
// Numerics of tpu_kquant/ops/pallas_attention.py:_attn_kernel: logits s =
// (bf16 q . bf16 k) * scale in f32, times the K scale of their slot for int8
// KV; masked slots are -1e30; running max m and sum l in f32, l accumulating
// p before the V scale; p * v_scale rounded to bf16 and multiplied by bf16 v
// into an f32 accumulator; out = acc / l. Those rounding points are what
// mma.sync.m16n8k16 bf16 with f32 accumulation computes (int8 codes are
// exact in bf16), so the tensor cores change only the order of the f32
// sums. Tiles wholly past the last live slot are never read.
//
// The core's layout: a tile is 64 cache slots; warp w of a block's four
// takes slots [16 w, 16 w + 16) of each tile. QK^T: A = the G query rows of
// the KV head, padded to 16 (registers, loaded once), B = 16 K slots (two
// n-tiles). P is re-packed from the C fragment into the A fragment of P V
// in registers; V's B fragments come from ldmatrix.trans (bf16) or from
// 4-byte loads of four slots' codes (int8). Staged rows are padded (bf16:
// 2 D + 16 bytes; int8: D + 16) so that ldmatrix's eight 16-byte rows, the
// int8 K words of eight slots and the int8 V words of four slots fall on
// distinct banks. int8 K fragments take the K axis in the order 16 ks + 4 t
// + (0..3) (one 4-byte word a lane), and q's A fragment the same order; a
// dot product does not depend on it. wgmma is not used: it needs a 64-row
// M, which would waste 4-8x at G <= 16 query rows.
//
// The few-row kernel (fused_attn_kernel). Masks: slot j is live while j <=
// q_pos[b] (#10: the cache already holds the current token), or, with
// SELF (#11), while j < q_pos[b]: the cache holds only earlier tokens, and
// the current token's roped k and its v are read from the QKV phase's
// outputs (kn, vn) and folded in after the splits are combined, in f32 (its
// logit the f32 product of the bf16 q and k, its p f32 against the f32 v:
// tpu_kquant/ops/pallas_layer.py:_layer_kernel, phase ATT). Row b with
// q_pos 0 then attends only the current token. Each head's output is
// rounded to bf16 (the TPU kernels' bf16 scratch).
// - A split over S free of B (ops/decode_attention.py:fused_attn_plan):
//   split z of a row walks tiles [z tps, (z + 1) tps) up to the row's last
//   live tile, at most FA_MAX_SPLITS splits. Grid (splits, Hkv, B); the
//   splits of one (KV head, row) are one thread-block cluster (splits, 1,
//   1), launched with cudaLaunchKernelEx.
// - Each block runs the core over its tiles with a FD_STAGES ring (all of a
//   1-2 tile split's loads in flight at once). Its four warps' states are
//   rescaled to their common max in warp order through the drained ring
//   into the block's m, l and unnormalised accumulator [G, D]. A block
//   past its row's last live tile loads nothing and has m = -1e30, l = 0:
//   weight 0 in the combine.
// - After a cluster barrier the ranks share out the (query row, column)
//   outputs; each reads every rank's m, l and accumulator of its outputs
//   over distributed shared memory, all in flight at once, adds them in
//   rank order rescaled to their common max, folds in the current token
//   (SELF), and writes acc / l as bf16. A second barrier keeps every rank's
//   state alive until its readers are done. One launch, no workspace; each
//   sum's order is fixed by the plan, so row b's result is the same bits at
//   any B. (Pushing the states instead, to rank 0 alone or to each
//   output's owner, with one barrier, measured slower: PERF.md §6.)
// - Programmatic dependent launch at both of its boundaries in #10 / #11:
//   the o_proj GEMV after it may start at once (it loads its first weight
//   chunk, then waits for this grid before it reads the head outputs), and
//   in layer.cu it starts while attn_in ends, its cache tiles in flight
//   before it waits for q, kn and vn.
// - Rows past S in the last tile (SELF with S % 64 != 0) are staged as
//   zeros and masked: no slot past S is loaded.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

// Ablation builds (tools/decode_sweep.py; never a library's own build):
// TKQ_FD_ABLATE 1 = no mma (its operands folded into the accumulator by
// integer ops), 2 = no ring (#7 only: each tile loaded and waited for
// before it is computed), 3 = the loads alone (the tiles land; nothing is
// computed). TKQ_FA_ABLATE 1 = the few-row kernel without its cluster (a
// plain launch; each block reads only its own state).
#ifndef TKQ_FD_ABLATE
#define TKQ_FD_ABLATE 0
#endif
#ifndef TKQ_FA_ABLATE
#define TKQ_FA_ABLATE 0
#endif

namespace tkq {

constexpr int FD_TS = 64;  // cache slots a tile
constexpr int FD_WARPS = 4;
constexpr int FD_THREADS = FD_WARPS * 32;
constexpr int FD_STAGES = 3;
constexpr float FD_NEG = -1e30f;
constexpr int FA_MAX_SPLITS = 8;  // a portable cluster

template <int D, bool I8>
struct FdGeom {
  static constexpr int ROW = D * (I8 ? 1 : 2);    // bytes of a cache row
  static constexpr int PITCH = ROW + 16;          // bytes of a staged row
  static constexpr int KV = FD_TS * PITCH;        // K (or V) of one tile
  static constexpr int STAGE = 2 * KV + (I8 ? 2 * FD_TS * 4 : 0);
  // #7's combine: m, l and a 32-column chunk of the four warps' accumulators
  static constexpr int COMBINE = FD_WARPS * 16 * (2 + 33) * 4;
  static_assert(COMBINE <= STAGE, "the combine takes one ring stage");
  static constexpr int SMEM = FD_STAGES * STAGE;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void fd_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (TKQ_FD_ABLATE == 1) {
    d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ b0);
    d[1] = __uint_as_float(__float_as_uint(d[1]) ^ a[1] ^ b1);
    d[2] = __uint_as_float(__float_as_uint(d[2]) ^ a[2]);
    d[3] = __uint_as_float(__float_as_uint(d[3]) ^ a[3]);
    return;
  }
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the signed bytes J0 (low half) and J1 of u ^ 0x80808080 (the codes + 128)
// as a bf16x2, exactly: each byte is placed in the mantissa of 2^23 and the
// offset subtracted in f32
template <int J0, int J1>
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t u) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, J0 | 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, J1 | 0x7440)) - 8388736.f;
  return pack_bf16(f0, f1);
}

// Copy tile t (slots 64 t ...) of a row's K and V (and their scales) into a
// ring stage: 16 bytes a copy, every thread. Rows >= `rows` (past the
// cache's end) are staged as zeros.
template <int D, bool I8>
__device__ __forceinline__ void fd_load(uint32_t st, const uint8_t* kg, const uint8_t* vg,
                                        const float* ksg, const float* vsg, int t,
                                        int rows = FD_TS) {
  using Gm = FdGeom<D, I8>;
  constexpr int CPR = Gm::ROW / 16;
  const size_t off = (size_t)t * FD_TS * Gm::ROW;
#pragma unroll 4
  for (int i = threadIdx.x; i < FD_TS * CPR; i += FD_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    if (r < rows) {
      cp_async16(st + r * Gm::PITCH + c, kg + off + (size_t)r * Gm::ROW + c);
      cp_async16(st + Gm::KV + r * Gm::PITCH + c, vg + off + (size_t)r * Gm::ROW + c);
    } else {
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(st + r * Gm::PITCH + c),
                   "r"(0u));
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(st + Gm::KV + r * Gm::PITCH +
                                                                   c),
                   "r"(0u));
    }
  }
  if constexpr (I8) {
    if (threadIdx.x < 16)
      cp_async16(st + 2 * Gm::KV + threadIdx.x * 16, ksg + t * FD_TS + threadIdx.x * 4);
    else if (threadIdx.x < 32)
      cp_async16(st + 2 * Gm::KV + FD_TS * 4 + (threadIdx.x - 16) * 16,
                 vsg + t * FD_TS + (threadIdx.x - 16) * 4);
  }
}

// q's A fragments: rows g and g + 8 of the KV head's G query rows at q0
// (zero past G); K axis 16 ks + (2t, 2t+1, 2t+8, 2t+9), int8: 16 ks + 4t +
// 0..3
template <int D, bool I8>
__device__ __forceinline__ void fd_q_frags(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* q0,
                                           int G) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int d0 = I8 ? 16 * ks + 4 * t : 16 * ks + 2 * t, d1 = I8 ? d0 + 2 : d0 + 8;
    qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(q0 + g * D + d0) : 0u;
    qa[ks][1] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * D + d0) : 0u;
    qa[ks][2] = g < G ? *reinterpret_cast<const uint32_t*>(q0 + g * D + d1) : 0u;
    qa[ks][3] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(q0 + (g + 8) * D + d1) : 0u;
  }
}

// The output column that accumulator element e of n-tile n holds for lane
// quad t: n-tiles 4c .. 4c + 3 hold columns 32c .. 32c + 31 in both layouts
// (int8: n-tile 4h + c serves column 32h + 4j + c to fragment column j).
template <bool I8>
__device__ __forceinline__ int fd_out_col(int n, int t, int e) {
  return 32 * (n / 4) + (I8 ? 8 * t + 4 * (e & 1) + n % 4 : 8 * (n % 4) + 2 * t + (e & 1));
}

// One tile (slots s0 .. s0 + 63) in ring stage st (stp: its generic
// address) for the warp's 16 slots, slots < lim live: the logits, the
// online softmax on the fragments, and P V into o.
template <int D, bool I8>
__device__ __forceinline__ void fd_tile(uint32_t st, const uint8_t* stp, float scale, int s0,
                                        int lim, const uint32_t (&qa)[D / 16][4], float (&m)[2],
                                        float (&l)[2], float (&o)[D / 8][4]) {
  using Gm = FdGeom<D, I8>;
  constexpr int KS = D / 16, NT = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* kss = reinterpret_cast<const float*>(stp + 2 * Gm::KV);
  const float* vss = kss + FD_TS;
  if constexpr (TKQ_FD_ABLATE == 3) {  // the loads alone: keep the tile's words live
    o[0][0] += __uint_as_float(*reinterpret_cast<const uint32_t*>(stp + 4 * threadIdx.x) &
                               0x007FFFFFu);
    return;
  }

  // logits of the warp's 16 slots: s[j] = n-tile j (slots 16w + 8j ...)
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (I8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
                               stp + (16 * warp + 8 * j + g) * Gm::PITCH + 16 * ks + 4 * t) ^
                           0x80808080u;
        fd_mma(s[j], qa[ks], i8_bf16x2<0, 1>(w), i8_bf16x2<2, 3>(w));
      }
    } else {
      const int mi = lane / 8;
      uint32_t kb[4];
      ldsm_x4(kb, st + (16 * warp + (mi / 2) * 8 + lane % 8) * Gm::PITCH +
                      (16 * ks + (mi % 2) * 8) * 2);
      fd_mma(s[0], qa[ks], kb[0], kb[1]);
      fd_mma(s[1], qa[ks], kb[2], kb[3]);
    }
  }
  // online softmax on the fragments: e = 0, 1 row g, e = 2, 3 row g + 8
  float mx[2] = {FD_NEG, FD_NEG};
  bool live[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = 16 * warp + 8 * j + 2 * t + (e & 1);
      float x = s[j][e] * scale;
      if constexpr (I8) x *= kss[slot];
      live[j][e] = s0 + slot < lim;
      s[j][e] = live[j][e] ? x : FD_NEG;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = expf(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = live[j][e] ? expf(s[j][e] - m[e / 2]) : 0.f;
      rs[e / 2] += p;
      s[j][e] = I8 ? p * vss[16 * warp + 8 * j + 2 * t + (e & 1)] : p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    l[h] = l[h] * alpha[h] + rs[h];  // the sum before the V scales
  }
  // P (bf16) as the A fragment of P V: k-slots 2t, 2t+1 (n-tile 0) and
  // 2t+8, 2t+9 (n-tile 1) of rows g and g + 8
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= alpha[0], o[n][1] *= alpha[0];
    o[n][2] *= alpha[1], o[n][3] *= alpha[1];
  }
  if constexpr (I8) {
    // rows 2t, 2t+1, 2t+8, 2t+9 of the warp's slots, columns 32h + 4g ..
    // + 3: n-tile 4h + c serves column 32h + 4g + c to lane group g
#pragma unroll
    for (int h = 0; h < D / 32; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const uint32_t*>(
                   stp + Gm::KV + (16 * warp + 2 * t + (e & 1) + 8 * (e / 2)) * Gm::PITCH +
                   32 * h + 4 * g) ^
               0x80808080u;
      const uint32_t lo0 = __byte_perm(w[0], w[1], 0x5140), hi0 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo1 = __byte_perm(w[2], w[3], 0x5140), hi1 = __byte_perm(w[2], w[3], 0x7362);
      fd_mma(o[4 * h + 0], pa, i8_bf16x2<0, 1>(lo0), i8_bf16x2<0, 1>(lo1));
      fd_mma(o[4 * h + 1], pa, i8_bf16x2<2, 3>(lo0), i8_bf16x2<2, 3>(lo1));
      fd_mma(o[4 * h + 2], pa, i8_bf16x2<0, 1>(hi0), i8_bf16x2<0, 1>(hi1));
      fd_mma(o[4 * h + 3], pa, i8_bf16x2<2, 3>(hi0), i8_bf16x2<2, 3>(hi1));
    }
  } else {
    const int mi = lane / 8;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, st + Gm::KV + (16 * warp + (mi % 2) * 8 + lane % 8) * Gm::PITCH +
                        8 * (n + mi / 2) * 2);
      fd_mma(o[n], pa, vb[0], vb[1]);
      fd_mma(o[n + 1], pa, vb[2], vb[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// the few-row kernel (#10, #11)
// ---------------------------------------------------------------------------

struct FusedAttnArgs {
  const __nv_bfloat16* q;  // [B, H, D]: row b at b * sqb, heads dense (stride D)
  long long sqb;
  const void* k;  // [B, Hkv, S, D] bf16 or int8, rows of D dense
  long long skb, skh;
  const void* v;
  long long svb, svh;
  const float* ks;  // [B, Hkv, S] f32 (int8 only), S dense
  long long sksb, sksh;
  const float* vs;
  long long svsb, svsh;
  const long long* q_pos;  // [B], the caller's int64 positions
  // SELF only: the current token's roped k [B, Hkv, D] (row b at b * sknb,
  // heads dense) and v (row b at b * svnb), bf16
  const __nv_bfloat16* kn;
  long long sknb;
  const __nv_bfloat16* vn;
  long long svnb;
  __nv_bfloat16* out;  // [B, H * D]
  int B, H, Hkv, S;
  float scale;
  int tps, splits;  // tiles a split; splits = ceil(ceil(S / 64) / tps) <= FA_MAX_SPLITS
};

// Shared memory of the few-row kernel: the ring, the current token's
// logits [16] (SELF), then the block's state: m [16], l [16] and the
// unnormalised accumulator [16][D]. The four warps' states (m, l [4][16],
// accumulators [4][16][D + 1]) meet in the drained ring.
template <int D, bool I8>
struct FaGeom {
  static constexpr int WCP = D + 1;  // floats a row of a warp's accumulator
  static constexpr int WARPS = FD_WARPS * 16 * (2 + WCP) * 4;
  static_assert(WARPS <= FdGeom<D, I8>::SMEM, "the warps' states take the ring");
  static constexpr int STATE = FdGeom<D, I8>::SMEM + 16 * 4;  // byte offset of the state
  static constexpr int SMEM = STATE + (32 + 16 * D) * 4;
};

// grid (splits, Hkv, B), cluster (splits, 1, 1), FD_THREADS threads, dynamic
// smem FaGeom::SMEM; G = H / Hkv <= 16. Every rank reaches both cluster
// barriers, whatever its tiles.
template <int D, bool I8, bool SELF>
__global__ void __launch_bounds__(FD_THREADS) fused_attn_kernel(const FusedAttnArgs a) {
  static_assert(!(SELF && I8), "the current-token variant reads a bf16 cache");
  namespace cg = cooperative_groups;
  using Gm = FdGeom<D, I8>;
  using Fa = FaGeom<D, I8>;
  constexpr int NT = D / 8, WCP = Fa::WCP, AHEAD = FD_STAGES - 1;
  extern __shared__ __align__(128) uint8_t fa_smem[];
  const auto csync = [] {
    if constexpr (TKQ_FA_ABLATE == 1) __syncthreads();
    else cg::this_cluster().sync();
  };
  const auto peer = [](float* p, int r) {
    if constexpr (TKQ_FA_ABLATE == 1) return p + 0 * r;
    else return cg::this_cluster().map_shared_rank(p, r);
  };
  // the o_proj GEMV after this kernel may start now (GemvArgs.pdl)
  asm volatile("griddepcontrol.launch_dependents;");
  const int z = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, G = a.H / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qp = (int)a.q_pos[b];
  const int lim = SELF ? qp : qp + 1;  // slots < lim are live
  const int n_tiles = (a.S + FD_TS - 1) / FD_TS;
  const int t0 = z * a.tps;
  const int nt = max(0, min(t0 + a.tps, min((lim + FD_TS - 1) / FD_TS, n_tiles)) - t0);
  const uint32_t ring = smem_u32(fa_smem);
  const auto stage = [](int i) { return i % FD_STAGES * Gm::STAGE; };
  constexpr int ESZ = I8 ? 1 : 2;
  const uint8_t* kg =
      static_cast<const uint8_t*>(a.k) + ((size_t)b * a.skb + (size_t)hk * a.skh) * ESZ;
  const uint8_t* vg =
      static_cast<const uint8_t*>(a.v) + ((size_t)b * a.svb + (size_t)hk * a.svh) * ESZ;
  const float* ksg = I8 ? a.ks + (size_t)b * a.sksb + (size_t)hk * a.sksh : nullptr;
  const float* vsg = I8 ? a.vs + (size_t)b * a.svsb + (size_t)hk * a.svsh : nullptr;
  const auto load = [&](int i) {
    fd_load<D, I8>(ring + stage(i), kg, vg, ksg, vsg, t0 + i, min(FD_TS, a.S - (t0 + i) * FD_TS));
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < nt) load(i);
    cp_commit();
  }
  // launched as a programmatic dependent of the kernel that writes q (and
  // kn / vn): the cache tiles above are in flight while it ends
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const __nv_bfloat16* q0 = a.q + (size_t)b * a.sqb + (size_t)hk * G * D;
  float* sl = reinterpret_cast<float*>(fa_smem + Gm::SMEM);  // SELF: current logits [16]
  float* rm = reinterpret_cast<float*>(fa_smem + Fa::STATE);  // the block's m [16], l [16]
  float* ro = rm + 32;                                          // its accumulator [16][D]
  if constexpr (SELF) {  // the current token's logit of each query row, in f32
    const __nv_bfloat16* kn = a.kn + (size_t)b * a.sknb + (size_t)hk * D;
    for (int r = warp; r < G; r += FD_WARPS) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot = fmaf(__bfloat162float(q0[r * D + d]), __bfloat162float(kn[d]), dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) sl[r] = dot * a.scale;
    }
  }
  uint32_t qa[D / 16][4];
  fd_q_frags<D, I8>(qa, q0, G);
  float m[2] = {FD_NEG, FD_NEG}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    cp_wait<FD_STAGES - 2>();
    __syncthreads();  // tile i in every thread's view; tile i - 1 consumed
    if (i + AHEAD < nt) load(i + AHEAD);
    cp_commit();
    fd_tile<D, I8>(ring + stage(i), fa_smem + stage(i), a.scale, (t0 + i) * FD_TS, lim, qa, m, l,
                   o);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is drained: it takes the warps' states

  float* wm = reinterpret_cast<float*>(fa_smem);  // m [4][16]
  float* wl = wm + FD_WARPS * 16;                 // l [4][16]
  float* wo = wl + FD_WARPS * 16;                 // acc [4][16][WCP]
  if (t == 0) {
    wm[warp * 16 + g] = m[0], wm[warp * 16 + g + 8] = m[1];
    wl[warp * 16 + g] = l[0], wl[warp * 16 + g + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(warp * 16 + g + 8 * (e / 2)) * WCP + fd_out_col<I8>(n, t, e)] = o[n][e];
  __syncthreads();
  // the block's state: the four warps rescaled to their common max, in warp
  // order
  for (int i = threadIdx.x; i < G * D; i += FD_THREADS) {
    const int r = i / D, col = i % D;
    float M = FD_NEG;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) M = fmaxf(M, wm[w * 16 + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float wt = expf(wm[w * 16 + r] - M);
      L += wl[w * 16 + r] * wt;
      O += wo[(w * 16 + r) * WCP + col] * wt;
    }
    ro[r * D + col] = O;
    if (col == 0) rm[r] = M, rm[16 + r] = L;
  }
  csync();  // every rank's state is complete

  // the outputs (query row r, column col) of this rank: every rank's state
  // in rank order, rescaled to their common max, then the current token
  // (SELF), in f32
  for (int i = z * FD_THREADS + threadIdx.x; i < G * D; i += a.splits * FD_THREADS) {
    const int r = i / D, col = i % D;
    float pm[FA_MAX_SPLITS], pl[FA_MAX_SPLITS], po[FA_MAX_SPLITS];  // all in flight first
#pragma unroll
    for (int q = 0; q < FA_MAX_SPLITS; ++q) {
      if (q < a.splits) {
        const float* p = peer(rm, q);
        pm[q] = p[r], pl[q] = p[16 + r], po[q] = p[32 + r * D + col];
      }
    }
    float M = FD_NEG;
#pragma unroll
    for (int q = 0; q < FA_MAX_SPLITS; ++q)
      if (q < a.splits) M = fmaxf(M, pm[q]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int q = 0; q < FA_MAX_SPLITS; ++q) {
      if (q < a.splits) {
        const float w = expf(pm[q] - M);
        L += pl[q] * w;
        O += po[q] * w;
      }
    }
    if constexpr (SELF) {
      const float s = sl[r], mn = fmaxf(M, s);
      const float al = expf(M - mn), p = expf(s - mn);
      L = L * al + p;
      O = O * al + p * __bfloat162float(a.vn[(size_t)b * a.svnb + (size_t)hk * D + col]);
    }
    a.out[((size_t)b * a.H + hk * G + r) * D + col] = __float2bfloat16_rn(O / L);
  }
  csync();  // no rank leaves while another reads its state
}

template <int D, bool I8, bool SELF>
cudaError_t launch_fused_attn_d(const FusedAttnArgs& a, cudaStream_t st, int pdl) {
  constexpr int smem = FaGeom<D, I8>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(fused_attn_kernel<D, I8, SELF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv, a.B);
  cfg.blockDim = dim3(FD_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (TKQ_FA_ABLATE != 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = a.splits;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  e = cudaLaunchKernelEx(&cfg, fused_attn_kernel<D, I8, SELF>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The few-row attention: D 64 or 128; bf16 or (kv_i8, not with SELF) int8
// KV; SELF reads a.kn / a.vn. Requires H % Hkv == 0 with H / Hkv <= 16, 1 <=
// splits <= FA_MAX_SPLITS with splits == ceil(ceil(S / 64) / tps), S % 64
// == 0 without SELF, 16-byte aligned K/V rows and (int8) scale rows, 0 <=
// q_pos[b] < S. pdl: a programmatic dependent of the kernel before it on
// the stream, which writes q (and kn / vn) and lets it start early (layer's
// attn_in): its cache tiles load while that kernel ends.
template <bool SELF>
cudaError_t launch_fused_attn(const FusedAttnArgs& a, int D, int kv_i8, cudaStream_t st,
                              int pdl = 0) {
  const int n_tiles = (a.S + FD_TS - 1) / FD_TS;
  if (a.Hkv < 1 || a.H % a.Hkv != 0 || a.H / a.Hkv > 16 || a.tps < 1 || a.splits < 1 ||
      a.splits > FA_MAX_SPLITS || a.splits != (n_tiles + a.tps - 1) / a.tps || a.B < 1 ||
      (SELF ? kv_i8 || a.kn == nullptr || a.vn == nullptr : a.S % FD_TS != 0))
    return cudaErrorInvalidValue;
  if constexpr (SELF) {
    if (D == 64) return launch_fused_attn_d<64, false, true>(a, st, pdl);
    if (D == 128) return launch_fused_attn_d<128, false, true>(a, st, pdl);
  } else {
    if (D == 64)
      return kv_i8 ? launch_fused_attn_d<64, true, false>(a, st, pdl)
                   : launch_fused_attn_d<64, false, false>(a, st, pdl);
    if (D == 128)
      return kv_i8 ? launch_fused_attn_d<128, true, false>(a, st, pdl)
                   : launch_fused_attn_d<128, false, false>(a, st, pdl);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tkq
