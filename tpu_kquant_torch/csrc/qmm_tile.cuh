// qmm's tile path (R > 32 rows: every prefill projection, every serving
// tick of more than 32 slots): y[R, N] = x[R, K] @ dequant(W)^T for every
// packed kind, as a pipelined wgmma kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_qmm.py:qmm_pallas
// (_qmm_call :185, pallas_call :287): a grid of (M, N, K) tiles whose
// packed-weight tiles are dequantized in VMEM and fed to the MXU, with the
// f32 sum carried in scratch along the sequential K axis.
//
// Bound on the H100: operations at R >= 512 and N >= 1024 (2 R K N flops
// over 989 TFLOP/s bf16: TinyLlama's gate/up at R = 512 takes at least
// 23.9 us); bytes where N is small (the MoE router, N = 8: x's 4 MB at
// 3.35 TB/s). What the design does about it:
// - Asynchronous copies, a ring of 4 steps (3 at BM = 256). A producer
//   warpgroup (its registers cut to 40 by setmaxnreg; one thread issues)
//   loads each step with TMA (cp.async.bulk.tensor, __grid_constant__
//   tensor maps built per call), completing on an mbarrier (expect_tx); the
//   consumers release the slot on a second one. x (bf16) comes as two boxes
//   of 32 columns (a q4 step's two pieces are K/2 apart, a bit-plane step's
//   K / NP), each [BM][64 bytes] in the 64-byte swizzle; the packed code
//   rows, the qh rows and the scale / min rows through 2-D maps. Code rows
//   whose stride is not a multiple of 16 bytes (N % 16 != 0: the MoE
//   router's N = 8), which TMA does not take, are copied by the producer
//   warp with 4-byte cp.async instead, arriving on the same mbarrier. (A
//   first version issued every copy from one warp with cp.async: its loads
//   alone took 0.19 of gate/up's 0.23 ms at R = 512. One 3-D box putting
//   both 64-byte pieces of a row side by side under the 128-byte swizzle
//   faulted on the card.)
// - wgmma (m64n128k16, bf16 in, f32 sums in registers): two consumer
//   warpgroups of 64 * MW rows each (BM = 128 * MW, MW = 1 or 2; 232
//   registers a thread), BN = 128 output columns. A is x from shared memory
//   (K-major, 64-byte swizzle, as TMA leaves it): copied once, read by the
//   MW row blocks' wgmma with no registers spent on it, where ldmatrix into
//   registers would cost the consumers' issue slots and registers the
//   accumulators need. B is the dequantized weight tile [64 k rows][128 n],
//   N contiguous (MN-major, 128-byte swizzle, transposed-B bit set), in a
//   ring of 3 buffers, so that one block barrier a step suffices.
// - Dequantization once per block and step, overlapped with the MMA: step
//   s + 1's codes are dequantized while step s's wgmma runs, then step
//   s + 1's wgmma is queued before step s's is waited for, so the tensor
//   cores always hold the next group. 256 consumer threads each take 8
//   columns of 2 packed rows (q4, bit-plane kinds: 4 output rows) or of 4
//   code rows (q6w, q8) and decode their scale / min once for the step.
//   The bf16-pair kinds with codes under 128 (q4, q6w, q5, q6, q3, q2 on sm
//   / sp) convert two codes at once into a bf16x2 with one byte permute
//   (0x43cc = 128 + code) and compute w = s q - m in bf16x2 (sub, fma: one
//   rounding of the exact value); q8 and the f32-scale kinds convert
//   through the f32 magic number (0x4B0000cc, common.cuh:ubyte_f) and round
//   fma(s, q, -m) to bf16. A thread's 8 weights of a row go to the
//   swizzled tile in one 16-byte store; a proxy fence makes them visible to
//   wgmma.
// - A grid that fills the card: (ceil(N / 128), ceil(R / BM), splits). The
//   wrapper's ops/qmm.py:tile_plan picks MW and, where the output tiles
//   alone leave SMs idle, a split over K, from a cost model fitted on the
//   card; splits write f32 partials to ws and common.cuh's reduce_kernel
//   sums them in a fixed order (no atomics: a call is bit-for-bit
//   repeatable).
//
// Steps. A step is 64 rows of the logical K axis, in the order that lets a
// step read each packed byte once (csrc/common.cuh's legend):
// - q6w, q8: rows 64 s .. 64 s + 63 (masked past K: K % 64 may be 32);
// - q4: packed chunk s: rows 32 s + i (low nibbles) and K/2 + 32 s + i
//   (high nibbles), i < 32;
// - bit-plane kinds (S = K / NSEG rows per segment; NP fields per qs byte,
//   NT qs row groups): chunk c = s / NPAIR, pair j = s % NPAIR, NPAIR =
//   NSEG / 2; the pair's qs row group t = j / (NP / 2) and fields p0 =
//   2 (j % (NP / 2)), p1 = p0 + 1 are segments a = t + NT p0 and b = t + NT
//   p1: rows a S + 32 c + i and b S + 32 c + i, from qs rows t S + 32 c + i
//   and qh rows 32 c + i.
// Step rows 0-31 and 32-63 are the two halves of both the x tile (its
// columns) and the W tile (its rows), so the product is x @ W over them.
#pragma once

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace tkq {

constexpr int TILE_BN = 128;  // output columns per block
constexpr int TILE_BK = 64;   // logical K rows per step
constexpr int TILE_CONSUMERS = 256;                  // two warpgroups
constexpr int TILE_THREADS = TILE_CONSUMERS + 128;   // + the producer warpgroup
constexpr int W_TILE_BYTES = TILE_BK * TILE_BN * 2;  // one bf16 W buffer
constexpr int W_BUFS = 3;
__host__ __device__ constexpr int tile_stages(int mw) { return mw == 1 ? 4 : 3; }

// bf16x2 ops with one rounding (sm_90)
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bfma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <int MW>
__device__ __forceinline__ void fence_acc(float (&acc)[MW][64]) {
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[m][i])::"memory");
}

// ---------------------------------------------------------------------------
// a kind's step geometry
// ---------------------------------------------------------------------------

// bf16x2 dequantization (the bf16-pair kinds whose codes fit in 7 bits)
__host__ __device__ constexpr bool tile_bf16(int kind) {
  return !f32_side(kind) && kind != KQ8 && kind != KQ8F;
}
__host__ __device__ constexpr bool has_mins(int kind) { return !is_flat(kind); }
// packed code rows a step reads (flat kinds: one per K row)
__host__ __device__ constexpr int step_code_rows(int kind) { return is_flat(kind) ? 64 : 32; }
// scale rows a step reads (sm / sp words or f32 scales, and as many mins)
__host__ __device__ constexpr int step_scale_rows(int kind) {
  return kind == KQ8 ? 1 : kind == KQ6WF ? 4 : is_plane(kind) && group_rows(kind) == 16 ? 4 : 2;
}
// bytes of one ring slot past the x tile: codes, qh rows, scales, mins
__host__ __device__ constexpr int slot_tail_bytes(int kind) {
  return step_code_rows(kind) * TILE_BN +
         (is_plane(kind) && plane_hb(kind) > 0 ? 32 * TILE_BN : 0) +
         step_scale_rows(kind) * TILE_BN * 4 * (f32_side(kind) && has_mins(kind) ? 2 : 1);
}
__host__ __device__ constexpr int slot_bytes(int kind, int mw) {
  return (128 * mw * 128 + slot_tail_bytes(kind) + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int tile_smem_bytes(int kind, int mw) {
  return 1024 + W_BUFS * W_TILE_BYTES + tile_stages(mw) * slot_bytes(kind, mw) +
         2 * tile_stages(mw) * 8;
}
// rows of a kind's arrays: packed codes, qh, scale (sm / sp / f32) rows
__host__ __device__ constexpr int qs_rows(int kind, int K) {
  return is_flat(kind) ? K : is_plane(kind) && plane_w(kind) == 2 ? K / 4 : K / 2;
}
__host__ __device__ constexpr int qh_rows(int kind, int K) {
  return !is_plane(kind) || plane_hb(kind) == 0 ? 0 : plane_hb(kind) == 2 ? K / 4 : K / 8;
}
__host__ __device__ constexpr int side_rows(int kind, int K) {
  return (kind == KQ6W || kind == KQ8) ? K / group_rows(kind) / 2 : K / group_rows(kind);
}

__host__ __device__ constexpr int tile_steps(int K) { return (K + TILE_BK - 1) / TILE_BK; }

// The step's two halves: the logical K row of its row 0 and of its row 32,
// and (bit-plane kinds) the qs row group and the two fields / segments.
struct StepMap {
  int ka, kb;      // logical K of step rows 0 and 32
  int qrow;        // first packed qs row the step reads
  int hrow;        // first qh row (bit-plane kinds)
  int pa, pb;      // fields of the two halves (bit-plane kinds)
  int sa, sb;      // segments of the two halves (bit-plane kinds)
};
template <int KIND>
__device__ __forceinline__ StepMap step_map(int s, int K) {
  StepMap m{};
  if constexpr (is_flat(KIND)) {
    m.ka = s * 64, m.kb = s * 64 + 32, m.qrow = s * 64;
  } else if constexpr (is_q4(KIND)) {
    m.ka = s * 32, m.kb = K / 2 + s * 32, m.qrow = s * 32;
  } else {
    constexpr int NT = plane_nt(KIND), NP = plane_np(KIND), NPAIR = segments(KIND) / 2;
    const int S = K / segments(KIND);
    const int c = s / NPAIR, j = s % NPAIR;
    const int t = j / (NP / 2);
    m.pa = 2 * (j % (NP / 2)), m.pb = m.pa + 1;
    m.sa = t + NT * m.pa, m.sb = t + NT * m.pb;
    m.ka = m.sa * S + 32 * c, m.kb = m.sb * S + 32 * c;
    m.qrow = t * S + 32 * c, m.hrow = 32 * c;
  }
  return m;
}
// global row of the step's scale row r (< step_scale_rows); a flat kind's
// rows past K (a half step) read the last row, whose scales then multiply
// the zero codes TMA fills in past K
template <int KIND>
__device__ __forceinline__ int scale_row(const StepMap& m, int r, int K) {
  if constexpr (KIND == KQ8) return m.ka / 64;  // sp: groups 2j, 2j + 1 of 32 rows
  if constexpr (is_flat(KIND)) {  // q6w sp: two 16-row groups a word; q6w f32: 16; q8 f32: 32
    constexpr int PER = KIND == KQ6WF ? 16 : 32;
    return min(m.ka / PER + r, K / PER - 1);
  }
  constexpr int G = group_rows(KIND), PER = 32 / G;  // groups per half
  return ((r < PER) ? m.ka : m.kb) / G + r % PER;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct TileArgs {
  const uint8_t* qs;  // read by cp.async where N % 16 != 0
  const uint8_t* qh;
  void* out;  // [R, N] (splits == 1)
  int out_f32;
  float* ws;  // [splits, R, N] partials (splits > 1)
  int R, N, K;
  int sps;  // steps per split (grid.z splits)
};

// The call's tensor maps (cuTensorMapEncodeTiled, built by launch_tile).
struct TileMaps {
  CUtensorMap x;     // bf16 [R][K], box {32, BM}, 64-byte swizzle
  CUtensorMap qs;    // u8 [qs rows][N], box {128, code rows} (N % 16 == 0)
  CUtensorMap qh;    // u8 [qh rows][N], box {128, 32} (N % 16 == 0, kinds with qh)
  CUtensorMap scl;   // u32 [side rows][N], box {128, 1}
  CUtensorMap mins;  // the f32 kinds' mins, as scl
};

// TMA bytes a step brings (code and qh rows only where N % 16 == 0)
template <int KIND, int MW>
__host__ __device__ constexpr int step_tx_bytes(bool tma_codes) {
  return 128 * MW * 128 +
         (tma_codes ? step_code_rows(KIND) * TILE_BN +
                          (is_plane(KIND) && plane_hb(KIND) > 0 ? 32 * TILE_BN : 0)
                    : 0) +
         step_scale_rows(KIND) * TILE_BN * 4 * (f32_side(KIND) && has_mins(KIND) ? 2 : 1);
}

// Producer warp: load step s into a ring slot (lane 0 issues the TMA
// copies; where N % 16 != 0 every lane copies code words with cp.async and
// arrives on `full` when they land).
template <int KIND, int MW>
__device__ __forceinline__ void load_step(const TileMaps& maps, const TileArgs& a,
                                          unsigned char* slot_p, uint32_t full, int s, int m0,
                                          int n0, int lane) {
  constexpr int BM = 128 * MW, QR = step_code_rows(KIND), SR = step_scale_rows(KIND);
  constexpr bool HAS_QH = is_plane(KIND) && plane_hb(KIND) > 0;
  constexpr bool MINS = f32_side(KIND) && has_mins(KIND);
  const StepMap m = step_map<KIND>(s, a.K);
  const bool tma_codes = a.N % 16 == 0;
  const uint32_t xs = smem_u32(slot_p), qd = xs + BM * 128, hd = qd + QR * TILE_BN;
  const uint32_t sd = hd + (HAS_QH ? 32 * TILE_BN : 0);
  if (lane == 0) {
    mbar_expect_tx(full, step_tx_bytes<KIND, MW>(tma_codes));
    // a flat kind's half step past K reads the last 32 columns again, which
    // meet W rows of zero codes
    tma_2d(xs, &maps.x, m.ka, m0, full);
    tma_2d(xs + BM * 64, &maps.x, min(m.kb, a.K - 32), m0, full);
    if (tma_codes) {
      tma_2d(qd, &maps.qs, n0, m.qrow, full);
      if constexpr (HAS_QH) tma_2d(hd, &maps.qh, n0, m.hrow, full);
    }
#pragma unroll
    for (int r = 0; r < SR; ++r) {  // rows past the arrays (-1, or K / G) arrive as zeros
      const int g = scale_row<KIND>(m, r, a.K);
      tma_2d(sd + r * TILE_BN * 4, &maps.scl, n0, g, full);
      if constexpr (MINS) tma_2d(sd + (SR + r) * TILE_BN * 4, &maps.mins, n0, g, full);
    }
  }
  if (!tma_codes) {  // 4-byte words; flat kinds mask rows past K
    const int rows_ok = is_flat(KIND) ? min(QR, a.K - m.qrow) : QR;
    for (int i = lane; i < QR * 32; i += 32) {
      const int r = i / 32, col = n0 + (i % 32) * 4;
      const bool ok = r < rows_ok && col < a.N;
      cp4(qd + i * 4, ok ? a.qs + (size_t)(m.qrow + r) * a.N + col : a.qs, ok);
    }
    if constexpr (HAS_QH) {
      for (int i = lane; i < 32 * 32; i += 32) {
        const int r = i / 32, col = n0 + (i % 32) * 4;
        const bool ok = col < a.N;
        cp4(hd + i * 4, ok ? a.qh + (size_t)(m.hrow + r) * a.N + col : a.qh, ok);
      }
    }
    mbar_arrive_cp_async(full);
  }
}

// The 8 weights (bf16, one uint4) of one row of the thread's 8 columns.
// codes: 8 code bytes (cols 0-3, 4-7), already offset to 0..127 for the
// bf16x2 path. s2 / nm2: bf16x2 scales and negated mins of column pairs;
// sf / mf: f32 scales and mins of the 8 columns.
template <int KIND>
__device__ __forceinline__ uint4 dq_row_bf16(uint32_t c0, uint32_t c1, const uint32_t (&s2)[4],
                                             const uint32_t (&nm2)[4], uint32_t sub) {
  constexpr uint32_t MAGIC = 0x43434343u;  // bf16 0x43cc = 128 + cc
  const uint32_t q[4] = {__byte_perm(c0, MAGIC, 0x4140), __byte_perm(c0, MAGIC, 0x4342),
                         __byte_perm(c1, MAGIC, 0x4140), __byte_perm(c1, MAGIC, 0x4342)};
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t qv = bsub2(q[j], sub);
    w[j] = has_mins(KIND) ? bfma2(qv, s2[j], nm2[j]) : bmul2(qv, s2[j]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <int KIND>
__device__ __forceinline__ uint4 dq_row_f32(uint32_t c0, uint32_t c1, const float (&sf)[8],
                                            const float (&mf)[8]) {
  float v[8];
  if constexpr (is_flat(KIND)) {  // signed codes: flip to unsigned + 128
    const uint32_t u0 = c0 ^ 0x80808080u, u1 = c1 ^ 0x80808080u;
    const float q[8] = {ubyte_f<0>(u0, 8388736.0f), ubyte_f<1>(u0, 8388736.0f),
                        ubyte_f<2>(u0, 8388736.0f), ubyte_f<3>(u0, 8388736.0f),
                        ubyte_f<0>(u1, 8388736.0f), ubyte_f<1>(u1, 8388736.0f),
                        ubyte_f<2>(u1, 8388736.0f), ubyte_f<3>(u1, 8388736.0f)};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = sf[j] * q[j];
  } else {
    const float q[8] = {ubyte_f<0>(c0), ubyte_f<1>(c0), ubyte_f<2>(c0), ubyte_f<3>(c0),
                        ubyte_f<0>(c1), ubyte_f<1>(c1), ubyte_f<2>(c1), ubyte_f<3>(c1)};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaf(sf[j], q[j], -mf[j]);
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Scales of the thread's 8 columns from scale row r of the slot (and, for
// q6w-sp / q8-sp, the half `hi` of each word).
template <int KIND>
struct Scales8 {
  uint32_t s2[4], nm2[4];
  float sf[8], mf[8];
  __device__ __forceinline__ void load(const unsigned char* s_p, int r, int g, bool hi) {
    constexpr int SR = step_scale_rows(KIND);
    const uint4* sr = reinterpret_cast<const uint4*>(s_p + (r * TILE_BN + g * 8) * 4);
    const uint4 a = sr[0], b = sr[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if constexpr (tile_bf16(KIND)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (has_mins(KIND)) {  // sm: (scale, min) pairs
          s2[j] = __byte_perm(w[2 * j], w[2 * j + 1], 0x5410);
          nm2[j] = __byte_perm(w[2 * j], w[2 * j + 1], 0x7632) ^ 0x80008000u;
        } else {  // q6w sp: (even group, odd group) scale pairs
          s2[j] = __byte_perm(w[2 * j], w[2 * j + 1], hi ? 0x7632 : 0x5410);
          nm2[j] = 0u;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sf[j] = KIND == KQ8 ? (hi ? bf16_hi(w[j]) : bf16_lo(w[j])) : __uint_as_float(w[j]);
        mf[j] = 0.f;
      }
      if constexpr (has_mins(KIND)) {
        const uint4* mr = reinterpret_cast<const uint4*>(s_p + ((SR + r) * TILE_BN + g * 8) * 4);
        const uint4 c = mr[0], d = mr[1];
        const uint32_t m[8] = {c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) mf[j] = __uint_as_float(m[j]);
      }
    }
  }
  __device__ __forceinline__ uint4 row(uint32_t c0, uint32_t c1, uint32_t sub) const {
    if constexpr (tile_bf16(KIND)) return dq_row_bf16<KIND>(c0, c1, s2, nm2, sub);
    else return dq_row_f32<KIND>(c0, c1, sf, mf);
  }
};

// W tile store: row i (0..63), 8-column group g (0..15), swizzled
__device__ __forceinline__ void st_w(unsigned char* w_p, int i, int g, uint4 v) {
  *reinterpret_cast<uint4*>(w_p + (g / 8) * (TILE_BK * 128) + i * 128 +
                            (((g % 8) ^ (i % 8)) * 16)) = v;
}

// Consumer thread ct (0..255): dequantize the slot's step into W buffer w_p.
template <int KIND, int MW>
__device__ __forceinline__ void dequant_step(const unsigned char* slot_p, unsigned char* w_p,
                                             int s, int K, int ct) {
  constexpr int BM = 128 * MW;
  const unsigned char* q_p = slot_p + BM * 128;
  constexpr int QR = step_code_rows(KIND);
  const int g = ct % 16, rq = ct / 16;
  if constexpr (is_flat(KIND)) {
    // rows 4 rq .. 4 rq + 3: one 16-row group
    const int i0 = rq * 4;
    const unsigned char* s_p = q_p + QR * TILE_BN;
    Scales8<KIND> sc;
    const int r = KIND == KQ6W ? i0 / 32 : KIND == KQ6WF ? i0 / 16 : KIND == KQ8 ? 0 : i0 / 32;
    const bool hi = KIND == KQ6W ? (i0 / 16) % 2 : (i0 / 32) % 2;
    sc.load(s_p, r, g, hi);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint2 c = *reinterpret_cast<const uint2*>(q_p + (i0 + u) * TILE_BN + g * 8);
      uint32_t c0 = c.x, c1 = c.y;
      if constexpr (tile_bf16(KIND)) {  // q6w: q + 64 in 7 bits
        c0 = (c0 & 0x7F7F7F7Fu) ^ 0x40404040u;
        c1 = (c1 & 0x7F7F7F7Fu) ^ 0x40404040u;
      }
      st_w(w_p, i0 + u, g, sc.row(c0, c1, 0x43404340u));  // bf16 192 = 128 + 64
    }
  } else {
    // packed rows 2 rq, 2 rq + 1: step rows r (half a) and 32 + r (half b)
    const int r0 = rq * 2;
    const unsigned char* h_p = q_p + QR * TILE_BN;
    const unsigned char* s_p = h_p + (is_plane(KIND) && plane_hb(KIND) > 0 ? 32 * TILE_BN : 0);
    constexpr int PER = is_q4(KIND) ? 1 : 32 / group_rows(KIND);  // scale rows per half
    Scales8<KIND> sa, sb;
    sa.load(s_p, (r0 * PER) / 32, g, false);
    sb.load(s_p, PER + (r0 * PER) / 32, g, false);
    int pa = 0, pb = 0, ga = 0, gb = 0;
    if constexpr (is_plane(KIND)) {
      const StepMap m = step_map<KIND>(s, K);
      pa = m.pa, pb = m.pb, ga = m.sa, gb = m.sb;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u;
      const uint2 c = *reinterpret_cast<const uint2*>(q_p + r * TILE_BN + g * 8);
      uint32_t a0, a1, b0, b1;
      if constexpr (is_q4(KIND)) {
        a0 = c.x & 0x0F0F0F0Fu, a1 = c.y & 0x0F0F0F0Fu;
        b0 = (c.x >> 4) & 0x0F0F0F0Fu, b1 = (c.y >> 4) & 0x0F0F0F0Fu;
      } else {
        uint2 h = make_uint2(0u, 0u);
        if constexpr (plane_hb(KIND) > 0)
          h = *reinterpret_cast<const uint2*>(h_p + r * TILE_BN + g * 8);
        a0 = plane_codes<KIND>(c.x, h.x, pa, ga), a1 = plane_codes<KIND>(c.y, h.y, pa, ga);
        b0 = plane_codes<KIND>(c.x, h.x, pb, gb), b1 = plane_codes<KIND>(c.y, h.y, pb, gb);
      }
      st_w(w_p, r, g, sa.row(a0, a1, 0x43004300u));  // bf16 128
      st_w(w_p, 32 + r, g, sb.row(b0, b1, 0x43004300u));
    }
  }
}

// The consumers' wgmma for one step: A, the warpgroup's x rows, from the
// slot's two [BM][64-byte] halves (xa: the warpgroup's first row in half 0;
// half 1 is hb bytes on); B from W buffer wb.
template <int MW>
__device__ __forceinline__ void mma_step(float (&acc)[MW][64], uint32_t xa, uint32_t hb,
                                         uint32_t wb) {
  fence_acc<MW>(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < TILE_BK / 16; ++kk) {
    const uint64_t db = gmma_desc(wb + kk * 16 * 128, TILE_BK * 128, 1024, 1);
    const uint32_t ak = xa + (kk / 2) * hb + (kk % 2) * 32;
#pragma unroll
    for (int m = 0; m < MW; ++m)
      Wgmma<128, 1>::ss(acc[m], gmma_desc(ak + m * 64 * 64, 16, 512, 2), db, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// grid (ceil(N / 128), ceil(R / BM), splits); TILE_THREADS threads;
// dynamic smem tile_smem_bytes(KIND, MW)
template <int KIND, int MW>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    tile_kernel(const __grid_constant__ TileMaps maps, const TileArgs a) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BM = 128 * MW, ST = tile_stages(MW);
  constexpr int SLOT = slot_bytes(KIND, MW);
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* w_buf = base;  // [W_BUFS][W_TILE_BYTES]
  unsigned char* ring = base + W_BUFS * W_TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + ST * SLOT);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + ST);

  const int n0 = blockIdx.x * TILE_BN, m0 = blockIdx.y * BM;
  const int n_steps = tile_steps(a.K);
  const int s0 = blockIdx.z * a.sps, s1 = min(n_steps, s0 + a.sps);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full0 + 8 * i, a.N % 16 == 0 ? 1 : 33);  // + 32 cp.async arrivals
      mbar_init(empty0 + 8 * i, TILE_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= TILE_CONSUMERS) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid >= TILE_CONSUMERS + 32) return;
    const int lane = tid - TILE_CONSUMERS;
    for (int s = s0; s < s1; ++s) {
      const int it = s - s0, slot = it % ST;
      if (it >= ST) mbar_wait(empty0 + 8 * slot, ((it / ST) - 1) & 1);
      load_step<KIND, MW>(maps, a, ring + slot * SLOT, full0 + 8 * slot, s, m0, n0, lane);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumers: warpgroup wg takes rows m0 + wg * 64 * MW ...
  const int ct = tid, wg = ct / 128;
  float acc[MW][64];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
  const uint32_t x_off = wg * MW * 64 * 64;

  if (s0 < s1) {
    mbar_wait(full0, 0);
    dequant_step<KIND, MW>(ring, w_buf, s0, a.K, ct);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, TILE_CONSUMERS);
    mma_step<MW>(acc, smem_u32(ring) + x_off, BM * 64, smem_u32(w_buf));
  }
  for (int s = s0; s < s1; ++s) {
    const int it = s - s0;
    if (s + 1 < s1) {
      // step s + 1: dequantize while step s's wgmma runs (its W buffer was
      // last read by step s - 2's, which every warpgroup has waited for
      // before the previous barrier), then queue its wgmma and wait for s's
      const int nslot = (it + 1) % ST;
      unsigned char* w_next = w_buf + ((it + 1) % W_BUFS) * W_TILE_BYTES;
      mbar_wait(full0 + 8 * nslot, ((it + 1) / ST) & 1);
      dequant_step<KIND, MW>(ring + nslot * SLOT, w_next, s + 1, a.K, ct);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, TILE_CONSUMERS);
      mma_step<MW>(acc, smem_u32(ring + nslot * SLOT) + x_off, BM * 64, smem_u32(w_next));
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    }
    fence_acc<MW>(acc);
    if (ct % 32 == 0) mbar_arrive(empty0 + 8 * (it % ST));  // step s's slot is free
  }

  // epilogue: each warpgroup stages its rows in f32 (reusing the ring), then
  // writes them with 16-byte stores, masked at the ragged edges
  named_sync(1, TILE_CONSUMERS);
  constexpr int LDO = TILE_BN + 4;
  float* stage = reinterpret_cast<float*>(base) + wg * (MW * 64 * LDO);
  const int t = ct % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = m * 64 + warp * 16 + lane / 4, c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(stage + r * LDO + c) =
          make_float2(acc[m][4 * j], acc[m][4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (r + 8) * LDO + c) =
          make_float2(acc[m][4 * j + 2], acc[m][4 * j + 3]);
    }
  named_sync(2 + wg, 128);
  const int rbase = m0 + wg * MW * 64;
  const bool split = gridDim.z > 1;
  float* dst_f = split ? a.ws + (size_t)blockIdx.z * a.R * a.N
                       : (a.out_f32 ? static_cast<float*>(a.out) : nullptr);
  if (dst_f != nullptr) {  // f32: 4 columns a thread, 32 a row
    for (int i = t; i < MW * 64 * 32; i += 128) {
      const int r = i / 32, c = (i % 32) * 4, row = rbase + r, col = n0 + c;
      if (row >= a.R || col >= a.N) continue;
      const float4 v = *reinterpret_cast<const float4*>(stage + r * LDO + c);
      *reinterpret_cast<float4*>(dst_f + (size_t)row * a.N + col) = v;  // N % 4 == 0
    }
  } else {  // bf16: 8 columns a thread, 16 a row
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out);
    for (int i = t; i < MW * 64 * 16; i += 128) {
      const int r = i / 16, c = (i % 16) * 8, row = rbase + r, col = n0 + c;
      if (row >= a.R || col >= a.N) continue;
      const float* v = stage + r * LDO + c;
      if (a.N % 8 == 0) {
        *reinterpret_cast<uint4*>(dst + (size_t)row * a.N + col) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      } else {
        for (int e = 0; e < 8 && col + e < a.N; ++e)
          dst[(size_t)row * a.N + col + e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
}

// Launch the tile path: BM = 128 * MW, `splits` splits of a.sps steps.
template <int KIND, int MW>
cudaError_t launch_tile_mw(const __nv_bfloat16* x, const uint32_t* scl, const uint32_t* mins,
                           const TileArgs& a, int splits, cudaStream_t st) {
  TileMaps maps;
  memset(&maps, 0, sizeof(maps));
  const int K = a.K, N = a.N;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)a.R};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {32, (cuuint32_t)(128 * MW)};
  bool ok = encode_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                       CU_TENSOR_MAP_SWIZZLE_64B);
  const cuuint64_t sdim[2] = {(cuuint64_t)N, (cuuint64_t)side_rows(KIND, K)};
  const cuuint64_t sstr[1] = {(cuuint64_t)N * 4};
  const cuuint32_t sbox[2] = {TILE_BN, 1};
  ok = ok && encode_map(&maps.scl, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, scl, sdim, sstr, sbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (f32_side(KIND) && has_mins(KIND))
    ok = ok && encode_map(&maps.mins, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, mins, sdim, sstr, sbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (N % 16 == 0) {
    const cuuint64_t qd[2] = {(cuuint64_t)N, (cuuint64_t)qs_rows(KIND, K)};
    const cuuint64_t qstr[1] = {(cuuint64_t)N};
    const cuuint32_t qb[2] = {TILE_BN, (cuuint32_t)step_code_rows(KIND)};
    ok = ok && encode_map(&maps.qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.qs, qd, qstr, qb,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
    if (qh_rows(KIND, K) > 0) {
      const cuuint64_t hd[2] = {(cuuint64_t)N, (cuuint64_t)qh_rows(KIND, K)};
      const cuuint32_t hb[2] = {TILE_BN, 32};
      ok = ok && encode_map(&maps.qh, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.qh, hd, qstr, hb,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = tile_smem_bytes(KIND, MW);
  cudaError_t e = cudaFuncSetAttribute(tile_kernel<KIND, MW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TILE_BN - 1) / TILE_BN, (a.R + 128 * MW - 1) / (128 * MW), splits);
  tile_kernel<KIND, MW><<<grid, TILE_THREADS, smem, st>>>(maps, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int RN = a.R * N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, splits, RN, a.out, a.out_f32, nullptr,
                                                  0);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_tile(const __nv_bfloat16* x, const uint32_t* scl, const uint32_t* mins,
                        const TileArgs& a, int mw, int splits, cudaStream_t st) {
  if (mw == 2) return launch_tile_mw<KIND, 2>(x, scl, mins, a, splits, st);
  if (mw == 1) return launch_tile_mw<KIND, 1>(x, scl, mins, a, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace tkq
