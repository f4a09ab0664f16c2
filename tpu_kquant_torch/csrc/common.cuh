// Shared device code of the port's kernels (sm_90a): the packed-weight
// layouts and the CUDA-core GEMV core of the in-block GEMVs (attn_in.cuh,
// gate_up.cuh). The decode GEMV that qmm and the fused kernels' o_proj /
// down steps launch is gemv.cuh's tensor-core kernel.
//
// Packed layouts (tpu_kquant_torch/quant/repack.py), weights W of logical
// shape (N, K) stored K-major with N contiguous. Kind codes (the `kind` of
// every entry point; ops/qmm.py:KINDS is the same table):
//   KQ4   0: qs u8 [K/2, N], byte (k, n) = code(k) | code(k + K/2) << 4;
//            sm f32-container [K/32, N]: low 16 bits bf16 scale, high 16
//            bits bf16 min; w = s * q - m.
//   KQ6W  1: qs i8 [K, N] signed codes (q - 32, in [-32, 31]); sp
//            f32-container [K/32, N]: low 16 bits bf16 scale of group 2j
//            (rows 32j..32j+15), high 16 bits the scale of group 2j+1;
//            w = s * q.
//   KQ4F  2: KQ4's codes, f32 scales and mins [K/32, N] (scale_dtype='f32').
//   KQ6WF 3: KQ6W's codes, f32 scales [K/16, N].
//   KQ8   4: qs i8 [K, N] (Q8_0, group 32); sp [K/64, N]: groups 2j, 2j+1.
//   KQ8F  5: KQ8's codes, f32 scales [K/32, N].
//   KQ5   6 / KQ5F 7: Q5_K..Q5_0 (group 32): qs as KQ4 plus qh u8 [K/8, N],
//            bit j of byte (k, n) the 5th bit of element k + j*K/8.
//   KQ6   8 / KQ6F 9: unwidened Q6_K (group 16): qs as KQ4 plus qh u8
//            [K/4, N], bits [2j, 2j+1] of byte (k, n) the top bits of
//            element k + j*K/4; the -32 offset is folded into the mins.
//   KQ3  10 / KQ3F 11: Q3_K (group 16): qs u8 [K/4, N], bits [2j, 2j+1] of
//            byte (k, n) element k + j*K/4; qh u8 [K/8, N] the 3rd bits.
//   KQ2  12 / KQ2F 13: Q2_K (group 16): KQ3's qs, no qh.
// The even codes of KQ5..KQ2 carry sm pairs [K/g, N] (bf16 scale, min), the
// odd ones f32 scales and mins [K/g, N]; w = s * q - m with q unsigned.
// N must be a multiple of 4 (a lane reads 4 columns as one word).
//
// The K axis of a kind splits into NSEG segments of K / NSEG rows (q4: 2
// nibble folds; q6w / q8: 1; q6, q2: 4; q5, q3: 8): packed row r of a
// segment-local offset holds, in its bits, element r of every segment
// (qs rows t * K/NSEG + r for t < NT, qh row r). A "chunk" is 32 such rows
// and so covers 32 elements of each segment; a GEMV stages the x values
// of all its segments and reads every packed byte of the chunk once.
// In-block GEMV core (gemv_warp; attn_in's and gate/up's blocks read all of
// K): a block owns TN = 128 output columns, each lane 4 neighbouring
// columns, so a warp reads 128 contiguous bytes of every packed row. The
// block's 8 warps split K into 32-row chunks; per chunk a lane loads all 32
// words first, then accumulates code * x per scale group and applies the
// group's scale and min once: sum_k x (s q - m) = s sum x q - m sum x.
// Codes become floats with a byte permute into the mantissa of 2^23 and one
// subtract. The activation rows are staged in shared memory in f32; warps
// are reduced in shared memory in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tkq {

constexpr int KQ4 = 0;
constexpr int KQ6W = 1;
constexpr int KQ4F = 2;
constexpr int KQ6WF = 3;
constexpr int KQ8 = 4;
constexpr int KQ8F = 5;
constexpr int KQ5 = 6;
constexpr int KQ5F = 7;
constexpr int KQ6 = 8;
constexpr int KQ6F = 9;
constexpr int KQ3 = 10;
constexpr int KQ3F = 11;
constexpr int KQ2 = 12;
constexpr int KQ2F = 13;
// the kinds whose codes are folded nibbles (two K groups per packed row)
__host__ __device__ constexpr bool is_q4(int kind) { return kind == KQ4 || kind == KQ4F; }
// signed int8 codes, one per packed row (no folds)
__host__ __device__ constexpr bool is_flat(int kind) {
  return kind == KQ6W || kind == KQ6WF || kind == KQ8 || kind == KQ8F;
}
// the K-quant bit-plane kinds q5, q6, q3, q2 (gemv_warp_planes)
__host__ __device__ constexpr bool is_plane(int kind) { return kind >= KQ5; }
__host__ __device__ constexpr bool f32_side(int kind) {
  return kind == KQ4F || kind == KQ6WF || kind == KQ8F || (kind >= KQ5 && kind % 2 == 1);
}
// bit-plane geometry: low code bits per qs byte field (W), high bits per
// element in qh (HB), qs row groups per chunk (NT), fields per qs byte (NP)
__host__ __device__ constexpr int plane_w(int kind) { return kind < KQ3 ? 4 : 2; }
__host__ __device__ constexpr int plane_hb(int kind) {
  return kind <= KQ5F ? 1 : kind <= KQ6F ? 2 : kind <= KQ3F ? 1 : 0;
}
__host__ __device__ constexpr int plane_nt(int kind) {
  return kind <= KQ5F ? 4 : kind <= KQ3F ? 2 : 1;
}
__host__ __device__ constexpr int plane_np(int kind) { return 8 / plane_w(kind); }
// K segments of a kind (see the legend)
__host__ __device__ constexpr int segments(int kind) {
  return is_q4(kind) ? 2 : is_flat(kind) ? 1 : plane_nt(kind) * plane_np(kind);
}
// rows per scale group
__host__ __device__ constexpr int group_rows(int kind) {
  return (is_q4(kind) || kind == KQ8 || kind == KQ8F || kind == KQ5 || kind == KQ5F) ? 32 : 16;
}
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TN = 128;  // output columns per block
constexpr int CH = 32;   // packed rows per chunk (one q4 group per fold,
                         // one sp row = two q6w groups)

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// byte J of w, minus `off`, as a float: the permute builds 0x4B0000bb,
// which is the float 2^23 + bb exactly; off = 2^23 (+ 128 for a signed byte
// flipped to unsigned) recovers the code.
template <int J>
__device__ __forceinline__ float ubyte_f(uint32_t w, float off = 8388608.0f) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, J | (4 << 4) | (4 << 8) | (7 << 12))) - off;
}

__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  return x_f32 ? static_cast<const float*>(x)[i]
               : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// Number of activation values a block stages per row for chunks [c0, c1).
template <int KIND>
__host__ __device__ __forceinline__ int x_span(int n_chunks) {
  return segments(KIND) * n_chunks * CH;
}

// Chunks of 32 packed rows along K.
template <int KIND>
__host__ __device__ __forceinline__ int n_chunks_of(int K) {
  return K / (segments(KIND) * CH);
}

// 1 / rms of rows [r0, r0 + RT) of x [R, K] (bf16), into rstd[RT]; rows
// beyond R get 0. Uses the whole block.
template <int RT>
__device__ void block_rstd(float* rstd, const __nv_bfloat16* x, int R, int K, int r0,
                           float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < RT; r += WARPS) {
    float ss = 0.f;
    if (r0 + r < R) {
      const __nv_bfloat16* row = x + (size_t)(r0 + r) * K;
      for (int k = lane; k < K; k += 32) {
        float v = __bfloat162float(row[k]);
        ss += v * v;
      }
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rstd[r] = (r0 + r < R) ? rsqrtf(ss / (float)K + eps) : 0.f;
  }
  __syncthreads();
}

// Stage rows [r0, r0 + RT) of x [R, K] for chunks [c0, c1) into xs
// [RT][span] f32: segment s of the kind at offset s * L (L = 32 (c1 - c0)),
// elements s * K/NSEG + 32 c0 ... (q4: the low fold, then the high fold at
// + K/2; q6w / q8: elements 32 c0...). With nw != nullptr each value is
// normalised: x * rstd[r] * nw[k].
template <int KIND, int RT>
__device__ void stage_x(float* xs, const void* x, int x_f32, int R, int K, int r0, int c0,
                        int c1, const float* nw, const float* rstd) {
  const int L = (c1 - c0) * CH;
  const int span = x_span<KIND>(c1 - c0);
  for (int i = threadIdx.x; i < RT * span; i += THREADS) {
    const int r = i / span, j = i % span;
    const int k = (j / L) * (K / segments(KIND)) + c0 * CH + j % L;
    float v = 0.f;
    if (r0 + r < R) {
      v = load_x(x, x_f32, (size_t)(r0 + r) * K + k);
      if (nw != nullptr) v = v * rstd[r] * nw[k];
    }
    xs[i] = v;
  }
  __syncthreads();
}

// The scales of packed chunk c (32 packed rows) for the 4 columns n..n+3,
// for the q4 and flat kinds. load() issues the loads; decode() returns them
// as f32: q4 kinds give the low fold's group c (s0, m0) and the high fold's
// group K/64 + c (s1, m1); q6w kinds the chunk's two 16-row groups 2c (s0)
// and 2c + 1 (s1); q8 kinds the chunk's one 32-row group c (s0 = s1); flat
// kinds have m0 = m1 = 0. The bf16 kinds keep only their packed words (8 or
// 4 registers) until decode(). `mins` is read by KQ4F only.
template <int KIND>
struct ChunkScales {
  static constexpr bool kTwo = is_q4(KIND) || KIND == KQ6WF;  // a second scale row (b)
  static constexpr bool kMins = KIND == KQ4F;
  uint4 a, b, ma, mb;
  bool odd;  // KQ8: the chunk's group is the high half of its sp word

  __device__ __forceinline__ void load(const uint32_t* scl, const uint32_t* mins, int N, int K,
                                       int c, int n, bool ok) {
    a = b = ma = mb = make_uint4(0, 0, 0, 0);
    odd = c & 1;
    if (!ok) return;
    size_t ra, rb;
    if constexpr (is_q4(KIND)) {
      ra = (size_t)c * N + n, rb = ((size_t)(K / 64) + c) * N + n;
    } else {  // KQ6W / KQ8F: one row per chunk; KQ6WF: two; KQ8: half an sp row
      const int row = KIND == KQ6WF ? 2 * c : KIND == KQ8 ? c / 2 : c;
      ra = (size_t)row * N + n, rb = ra + N;
    }
    a = __ldg(reinterpret_cast<const uint4*>(scl + ra));
    if constexpr (kTwo) b = __ldg(reinterpret_cast<const uint4*>(scl + rb));
    if constexpr (kMins) {
      ma = __ldg(reinterpret_cast<const uint4*>(mins + ra));
      mb = __ldg(reinterpret_cast<const uint4*>(mins + rb));
    }
  }

  __device__ __forceinline__ void decode(float (&s0)[4], float (&m0)[4], float (&s1)[4],
                                         float (&m1)[4]) const {
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
    const uint32_t wma[4] = {ma.x, ma.y, ma.z, ma.w}, wmb[4] = {mb.x, mb.y, mb.z, mb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (KIND == KQ4) {  // bf16 (scale, min) pairs per group
        s0[j] = bf16_lo(wa[j]), m0[j] = bf16_hi(wa[j]);
        s1[j] = bf16_lo(wb[j]), m1[j] = bf16_hi(wb[j]);
      } else if constexpr (KIND == KQ6W) {  // bf16 (even, odd) group scale pairs
        s0[j] = bf16_lo(wa[j]), s1[j] = bf16_hi(wa[j]);
        m0[j] = m1[j] = 0.f;
      } else if constexpr (KIND == KQ8) {  // one group: one half of an sp word
        s0[j] = s1[j] = odd ? bf16_hi(wa[j]) : bf16_lo(wa[j]);
        m0[j] = m1[j] = 0.f;
      } else if constexpr (KIND == KQ8F) {
        s0[j] = s1[j] = __uint_as_float(wa[j]);
        m0[j] = m1[j] = 0.f;
      } else {
        s0[j] = __uint_as_float(wa[j]), s1[j] = __uint_as_float(wb[j]);
        m0[j] = kMins ? __uint_as_float(wma[j]) : 0.f;
        m1[j] = kMins ? __uint_as_float(wmb[j]) : 0.f;
      }
    }
  }
};

// Scale and min of group row `row` for the 4 columns n..n+3 of a bit-plane
// kind: sm pairs (bf16 scale, bf16 min) or f32 scales and mins.
template <int KIND>
__device__ __forceinline__ void group_scales(const uint32_t* scl, const uint32_t* mins, int N,
                                             int row, int n, bool ok, float (&s)[4],
                                             float (&m)[4]) {
  uint4 a = make_uint4(0, 0, 0, 0), b = a;
  if (ok) {
    a = __ldg(reinterpret_cast<const uint4*>(scl + (size_t)row * N + n));
    if constexpr (f32_side(KIND))
      b = __ldg(reinterpret_cast<const uint4*>(mins + (size_t)row * N + n));
  }
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (f32_side(KIND)) {
      s[j] = __uint_as_float(wa[j]), m[j] = __uint_as_float(wb[j]);
    } else {
      s[j] = bf16_lo(wa[j]), m[j] = bf16_hi(wa[j]);
    }
  }
}

// The 4 codes (one byte per column) of field p of qs word w, with the high
// bits of segment `seg` from qh word h, for a bit-plane kind.
template <int KIND>
__device__ __forceinline__ uint32_t plane_codes(uint32_t w, uint32_t h, int p, int seg) {
  constexpr int W = plane_w(KIND), HB = plane_hb(KIND);
  constexpr uint32_t LO = W == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  uint32_t q = (w >> (W * p)) & LO;
  if constexpr (HB == 1) q |= ((h >> seg) & 0x01010101u) << W;
  if constexpr (HB == 2) q |= ((h >> (2 * seg)) & 0x03030303u) << W;
  return q;
}

// gemv_warp for a bit-plane kind (q5, q6, q3, q2). Per chunk a lane loads
// its 32 qh words (the high bits of every segment) once, then per qs row
// group t its 32 qs words, and walks the NP fields of those words: field p
// is segment t + NT * p. Each segment's code * x products are summed per
// scale group (16 or 32 rows) and the group's scale and min applied once:
// sum_k x (s q - m) = s sum x q - m sum x.
template <int KIND, int RT>
__device__ __forceinline__ void gemv_warp_planes(float (&acc)[RT][4], const uint8_t* qs,
                                                 const uint8_t* qh, const uint32_t* scl,
                                                 const uint32_t* mins, int N, int K, int n,
                                                 bool col_ok, int c0, int c1, const float* xs,
                                                 int span) {
  constexpr int NT = plane_nt(KIND), NP = plane_np(KIND), G = group_rows(KIND);
  const int warp = threadIdx.x / 32;
  const int L = (c1 - c0) * CH;
  const int S = K / segments(KIND);  // rows per segment
  for (int c = c0 + warp; c < c1; c += WARPS) {
    const int li = (c - c0) * CH;
    const size_t row0 = (size_t)c * CH;
    uint32_t h[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      h[i] = (plane_hb(KIND) > 0 && col_ok)
                 ? __ldg(reinterpret_cast<const uint32_t*>(qh + (row0 + i) * N + n))
                 : 0u;
    // not unrolled: NT bodies of 32 x NP unrolled rows each multiply the
    // build time (a build of all libraries took 95-113 s unrolled, 60 s not,
    // on the H100's 8-core host); the R = 1 GEMVs of q5 / q6 / q3 take 8-19%
    // longer this way (chip_smoke.py phase 3)
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      uint32_t w[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(
                            qs + ((size_t)t * S + row0 + i) * N + n))
                      : 0u;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int seg = t + NT * p;
        const float* xseg = xs + seg * L + li;
        float d[RT][4] = {}, xsum[RT] = {};
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const uint32_t q = plane_codes<KIND>(w[i], h[i], p, seg);
          const float qf[4] = {ubyte_f<0>(q), ubyte_f<1>(q), ubyte_f<2>(q), ubyte_f<3>(q)};
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = xseg[r * span + i];
            xsum[r] += a;
#pragma unroll
            for (int j = 0; j < 4; ++j) d[r][j] = fmaf(a, qf[j], d[r][j]);
          }
          if (i % G == G - 1) {  // the end of a scale group: apply it, start the next
            float sc[4], mn[4];
            group_scales<KIND>(scl, mins, N, (seg * S + (int)row0 + i) / G, n, col_ok, sc, mn);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc[r][j] += sc[j] * d[r][j] - mn[j] * xsum[r];
                d[r][j] = 0.f;
              }
              xsum[r] = 0.f;
            }
          }
        }
      }
    }
  }
}

// One warp's share of a block's GEMV: chunks c0 + warp, c0 + warp + 8, ...
// below c1, for the lane's 4 columns starting at n. acc is accumulated.
// `mins`: f32 mins (KQ4F and the f32 bit-plane kinds); `qh`: the high bit
// planes of q5, q6 and q3.
template <int KIND, int RT>
__device__ __forceinline__ void gemv_warp(float (&acc)[RT][4], const uint8_t* qs,
                                          const uint32_t* scl, int N, int K, int n, bool col_ok,
                                          int c0, int c1, const float* xs, int span,
                                          const uint32_t* mins = nullptr,
                                          const uint8_t* qh = nullptr) {
  if constexpr (is_plane(KIND)) {
    gemv_warp_planes<KIND, RT>(acc, qs, qh, scl, mins, N, K, n, col_ok, c0, c1, xs, span);
  } else {
    const int warp = threadIdx.x / 32;
    const int L = (c1 - c0) * CH;
    for (int c = c0 + warp; c < c1; c += WARPS) {
      const int li = (c - c0) * CH;
      const size_t row0 = (size_t)c * CH;
      uint32_t w[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(qs + (row0 + i) * N + n)) : 0u;
      ChunkScales<KIND> cs;
      cs.load(scl, mins, N, K, c, n, col_ok);
      float s0[4], m0[4], s1[4], m1[4];
      if constexpr (is_q4(KIND)) {
        float dlo[RT][4] = {}, dhi[RT][4] = {}, xlo[RT] = {}, xhi[RT] = {};
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const uint32_t wl = w[i] & 0x0F0F0F0Fu, wh = (w[i] >> 4) & 0x0F0F0F0Fu;
          const float ql[4] = {ubyte_f<0>(wl), ubyte_f<1>(wl), ubyte_f<2>(wl), ubyte_f<3>(wl)};
          const float qh[4] = {ubyte_f<0>(wh), ubyte_f<1>(wh), ubyte_f<2>(wh), ubyte_f<3>(wh)};
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = xs[r * span + li + i], b = xs[r * span + L + li + i];
            xlo[r] += a;
            xhi[r] += b;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dlo[r][j] = fmaf(a, ql[j], dlo[r][j]);
              dhi[r][j] = fmaf(b, qh[j], dhi[r][j]);
            }
          }
        }
        cs.decode(s0, m0, s1, m1);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[r][j] += s0[j] * dlo[r][j] - m0[j] * xlo[r] + s1[j] * dhi[r][j] - m1[j] * xhi[r];
      } else if constexpr (is_flat(KIND)) {
        float de[RT][4] = {}, dodd[RT][4] = {};
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const uint32_t wu = w[i] ^ 0x80808080u;  // signed -> unsigned + 128
          const float q[4] = {ubyte_f<0>(wu, 8388736.0f), ubyte_f<1>(wu, 8388736.0f),
                              ubyte_f<2>(wu, 8388736.0f), ubyte_f<3>(wu, 8388736.0f)};
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = xs[r * span + li + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (i < CH / 2)
                de[r][j] = fmaf(a, q[j], de[r][j]);
              else
                dodd[r][j] = fmaf(a, q[j], dodd[r][j]);
            }
          }
        }
        cs.decode(s0, m0, s1, m1);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] += s0[j] * de[r][j] + s1[j] * dodd[r][j];
      }
    }
  }
}

// Sum the 8 warps' acc into red[0 .. RT*TN) (row-major [RT][TN]); red holds
// WARPS * RT * TN floats. Ends with a barrier.
template <int RT>
__device__ void block_reduce(float* red, const float (&acc)[RT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    *reinterpret_cast<float4*>(red + (warp * RT + r) * TN + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * RT * TN + i];
    red[i] = s;
  }
  __syncthreads();
}

// Output epilogue: y = acc (+ residual, then rounded to bf16), stored as
// bf16 or f32. round_first: acc is rounded to bf16 before the residual is
// added (the o_proj epilogue of the reference's attn_out and layer kernels,
// where the unfused path adds a bf16 qmatmul output).
__device__ __forceinline__ void store_out(void* out, int out_f32, size_t i, float v,
                                          const __nv_bfloat16* res, int round_first) {
  if (res != nullptr) v = round_bf16(__bfloat162float(res[i]) + (round_first ? round_bf16(v) : v));
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// out[r, n] = sum over splits s of ws[s, r, n] (in order s = 0, 1, ...),
// then the store_out epilogue.
__global__ void __launch_bounds__(256) reduce_kernel(const float* ws, int S, int RN, void* out,
                                                     int out_f32, const __nv_bfloat16* res,
                                                     int round_first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RN) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += ws[(size_t)s * RN + i];
  store_out(out, out_f32, i, v, res, round_first);
}

// rows per block for R rows (R <= 32): the next power of two up to 8
__host__ __forceinline__ int pick_rt(int R) { return R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8; }

}  // namespace tkq

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
