// The decode GEMV: y[R, N] = x[R, K] @ dequant(W)^T for R <= 32 rows and
// every packed kind of common.cuh's legend, on tensor cores. qmm's R <= 32
// path (qmm.cuh) and the o_proj / down step of the fused kernels (ffn.cu's
// oproj_ffn and ffn, attn_out.cu, layer.cu, rot.cu through
// gate_up.cuh:launch_oproj_ffn) launch it via launch_gemv / launch_gemv_kind.
//
// Replaces the R <= 32 tiles of the TPU kernel tpu_kquant/ops/pallas_qmm.py:
// qmm_pallas (_qmm_call, body _qmm_kernel): there one grid step streams a
// K tile of the packed weight into VMEM, dequantizes it and feeds the MXU.
//
// Bound: memory. Every packed byte is read once per call, whatever R is:
// Mixtral-8x7B's expert down [4096, 14336] q6w-sp (66.1 MB) takes at least
// 19.7 us at 3.35 TB/s at R = 1 and at R = 32 alike (its 3.8 GFLOP at R =
// 32 are 3.8 us of the bf16 tensor-core peak).
//
// Design (one block = 256 output columns x all R rows x a K range):
// - grid (ceil(N / 256), splits): the split plan (ops/qmm.py:gemv_plan)
//   depends on the kind, N and K only, and the splits' f32 partials are
//   summed by reduce_kernel in a fixed order, so a row's result does not
//   depend on the other rows of the call.
// - 8 warps: 4 across the block's columns (64 each), 2 across its chunks
//   (interleaved; their sums are added in a fixed order at the end).
// - The x rows of the block's K range are staged once in shared memory as
//   bf16 (f32 x rounded on the way in), with each scale group's x sum.
// - Group dots on tensor cores, swap-AB: mma.sync.m16n8k16 bf16, A = the
//   codes (M = 16 output columns), B = x (N = 8 rows; R is padded to 8, 16,
//   24 or 32, one n-tile each). Each scale group (16 or 32 k) starts a fresh
//   f32 accumulator; its result d[col, row] is applied once per group:
//   acc += s * d - m * sum(x) (explicit fmaf, no contraction freedom).
// - Codes to bf16 exactly: a code field is moved into the mantissa of 128.0
//   (bf16 0x4300 | field, exact for fields < 128) with one lop3 per two
//   codes; the mma then sees field + 128, and -OFF * sum(x) is the
//   accumulator's initial value. q4: the nibble (OFF 128); q6w: (q ^ 0x20) &
//   63 = q + 32 (OFF 160); the bit-plane kinds: their 2..6-bit codes (OFF
//   128); q8's signed byte as two nibbles of q + 128, the high one against
//   16 x (bf16-exact), two mmas a step (OFF 2304). The offset costs
//   ~log2(OFF / mean|q|) bits of the f32 group sum, well inside the 2e-2
//   the kernel is held to.
// - Fragment mapping (the packed layout holds 4 columns of one k per word;
//   a fragment register wants 2 k of one column): lane (g, t) loads its 8
//   columns 8g..8g+7 of rows 16s + 4t + e (s = 0, 1 the chunk's two
//   16-row steps, e = 0..3) as 8-byte words; k-slots (2t, 2t+1, 2t+8,
//   2t+9) of step s are rows 16s + 4t + (0, 1, 2, 3), so x's B fragment is
//   4 consecutive staged k (one 8-byte load) and a group's dot ignores the
//   order. Column pair p (columns 2p, 2p+1 as m-slots g, g+8): one prmt
//   per two rows gathers [row0.c0, row0.c1, row1.c0, row1.c1], one lop3
//   makes the c0 register, a shift and a lop3 the c1 register: 1 integer
//   instruction per code (q4: per code of either fold; q8: 2), one mma per
//   256 codes a warp and n-tile, 1-2 f32 FMA per (column, row, group).
// - Scales: lane (g, t) loads the scale words of columns 8g + 2t, + 1 and
//   column pair p's are shuffled from lane (g, p).
// - Loads in flight: the first chunk's code and scale words are loaded
//   before x is staged, and each next chunk's before the current one is
//   computed; a bit-plane chunk (qh, every qs row group, every segment's
//   side rows) is brought into L2 one chunk ahead instead. At R = 1 the
//   loads alone take 80-95% of the kernel's time (tools/gemv_sweep.py
//   --ablate), so the plan fills two blocks a SM. The result goes through
//   a shared tile so that the stores (or the split partials) are
//   coalesced; store_out's epilogue (residual, round_first, bf16 or f32)
//   applies where K is not split, else in reduce_kernel.
#pragma once

#include "common.cuh"

// Ablation builds (tools/gemv_sweep.py --ablate; never the library's own
// build): 1 = no mma (its operands folded into the accumulator by integer
// ops), 2 = no per-group scale and min (acc += d), 3 = the code and scale
// loads alone (folded into the accumulator).
#ifndef TKQ_GV_ABLATE
#define TKQ_GV_ABLATE 0
#endif

namespace tkq {

constexpr int GV_TN = 256;                    // output columns a block
constexpr int GV_WN = 4;                      // warps across them (64 columns each)
constexpr int GV_WK = 2;                      // warps across the block's chunks
constexpr int GV_THREADS = 32 * GV_WN * GV_WK;
constexpr int GV_TP = GV_TN + 8;              // floats a row of the output tile

struct GemvArgs {
  const void* x;  // [R, K] activations, bf16 or f32 (x_f32)
  int x_f32;
  const uint8_t* qs;
  const uint32_t* scl;  // sm, sp, or f32 scales (see the legend)
  int R, N, K;
  int cps;                   // chunks per K split (grid.y splits)
  float* ws;                 // [grid.y, R, N] partials when grid.y > 1
  void* out;                 // [R, N] when grid.y == 1
  int out_f32;
  const __nv_bfloat16* res;  // optional [R, N] residual
  const uint32_t* mins;      // f32 mins [K/g, N] (KQ4F and the f32 bit-plane kinds)
  const uint8_t* qh = nullptr;  // high bit planes (q5, q6, q3)
  int round_first = 0;          // store_out: round acc to bf16 before adding res
  // launched as a programmatic dependent of the kernel before it on the
  // stream: its blocks may start (and load their first chunk) while that
  // kernel runs, and wait for it to end before reading x
  int pdl = 0;
};

// bf16 elements a staged x row takes for `span` elements: a multiple of 64
// plus 16, so that the 4 rows of a half-warp's 8-byte B loads fall on
// different banks
__host__ __device__ constexpr int gv_xstride(int span) { return (span + 63) / 64 * 64 + 16; }

// scale groups of a chunk-segment
template <int KIND>
__host__ __device__ constexpr int gv_gpc() { return CH / group_rows(KIND); }

// Dynamic shared memory of gemv_kernel<KIND, NT> at `cps` chunks a split:
// the staged x [8 NT][xstride] bf16 (`copies` of it: gate_up.cuh stages a
// high and a low bf16 half) and the group sums [groups][8 NT] f32, or the
// output tile [8 NT][GV_TP] f32 that reuses them, whichever is larger.
template <int KIND>
__host__ __device__ inline size_t gemv_smem_bytes(int NT, int cps, int copies = 1) {
  const size_t rows = 8 * NT;
  const size_t x = copies * rows * gv_xstride(segments(KIND) * cps * CH) * 2;
  const size_t sums = (size_t)segments(KIND) * cps * gv_gpc<KIND>() * rows * 4;
  const size_t tile = rows * GV_TP * 4;
  return x + sums > tile ? x + sums : tile;
}

template <uint32_t LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

// Bytes 0 and 2 of v (one column's codes at two k) as a bf16x2 of 128 +
// field; FIELD 1 takes the high nibble (q4's high fold, q8's high half).
template <int KIND, int FIELD>
__device__ __forceinline__ uint32_t gv_conv(uint32_t v) {
  if constexpr (FIELD == 1) v >>= 4;
  // lop3 0x6A: b ? a ^ c : c; 0xE2: b ? a : c (b the field mask, c the magic)
  if constexpr (KIND == KQ6W || KIND == KQ6WF)
    return lop3<0x6A>(v, 0x003F003Fu, 0x43204320u);  // (q ^ 0x20) & 63 = q + 32
  else if constexpr ((KIND == KQ8 || KIND == KQ8F) && FIELD == 1)
    return lop3<0x6A>(v, 0x000F000Fu, 0x43084308u);  // the high nibble of q + 128
  else if constexpr (is_plane(KIND))
    return lop3<0xE2>(v, 0x007F007Fu, 0x43004300u);
  else
    return lop3<0xE2>(v, 0x000F000Fu, 0x43004300u);
}

// The mma's A fragment of column pair p (columns 2p, 2p+1 of the lane's 8)
// at step rows w[0..3] (rows 4t + e of a 16-row step).
template <int KIND, int FIELD>
__device__ __forceinline__ void gv_frag(uint32_t (&a)[4], const uint2* w, int p) {
  const uint32_t sel = (p & 1) ? 0x7632u : 0x5410u;
  const uint32_t u01 = __byte_perm(p < 2 ? w[0].x : w[0].y, p < 2 ? w[1].x : w[1].y, sel);
  const uint32_t u23 = __byte_perm(p < 2 ? w[2].x : w[2].y, p < 2 ? w[3].x : w[3].y, sel);
  a[0] = gv_conv<KIND, FIELD>(u01);
  a[1] = gv_conv<KIND, FIELD>(u01 >> 8);
  a[2] = gv_conv<KIND, FIELD>(u23);
  a[3] = gv_conv<KIND, FIELD>(u23 >> 8);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 x, exact in bf16
__device__ __forceinline__ uint32_t bf16x2_times16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmul2(h, __floats2bfloat162_rn(16.f, 16.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int KIND>
__host__ __device__ constexpr float gv_offset() {
  return (KIND == KQ8 || KIND == KQ8F) ? 2304.f : (KIND == KQ6W || KIND == KQ6WF) ? 160.f : 128.f;
}

template <int KIND>
__host__ __device__ constexpr bool has_mins() {
  return is_q4(KIND) || is_plane(KIND);
}

// The lane's share of one segment of one chunk: w[4s + e] holds the codes of
// its 8 columns at the segment's rows 16s + 4t + e; xb points at row g of
// n-tile 0 of the staged x at this chunk-segment (+ 4t), sb at its first
// group's x sums at rows 2t, 2t+1; scale(gg, p, s0, m0, s1, m1) gives the
// scale and min of columns 2p, 2p+1 at group gg of the chunk-segment. HL:
// x is staged as two bf16 halves, the low one `loff` elements past the high
// one, and each group dot takes both (an f32 x to about 16 bits).
template <int KIND, int NT, int FIELD, class Scale, bool HL = false>
__device__ __forceinline__ void gv_segment(float (&acc)[NT][4][4], const uint2 (&w)[8],
                                           const __nv_bfloat16* xb, int XS, const float* sb,
                                           Scale scale, int loff = 0) {
  constexpr int G = group_rows(KIND), STEPS = G / 16, GPC = CH / G, ROWS = 8 * NT;
  constexpr bool Q8 = KIND == KQ8 || KIND == KQ8F;
  constexpr float OFF = gv_offset<KIND>();
#pragma unroll
  for (int gg = 0; gg < GPC; ++gg) {
    uint2 b[NT][STEPS], bl[HL ? NT : 1][STEPS];
    float2 xsum[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        b[j][st] = *reinterpret_cast<const uint2*>(xb + j * 8 * XS + (gg * STEPS + st) * 16);
        if constexpr (HL)
          bl[j][st] = *reinterpret_cast<const uint2*>(xb + loff + j * 8 * XS +
                                                      (gg * STEPS + st) * 16);
      }
      xsum[j] = *reinterpret_cast<const float2*>(sb + gg * ROWS + 8 * j);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float s0, m0, s1, m1;
      scale(gg, p, s0, m0, s1, m1);
      uint32_t a[STEPS][4], ah[STEPS][4];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        gv_frag<KIND, FIELD>(a[st], w + 4 * (gg * STEPS + st), p);
        if constexpr (Q8) gv_frag<KIND, 1>(ah[st], w + 4 * (gg * STEPS + st), p);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float c0 = __fmul_rn(-OFF, xsum[j].x), c1 = __fmul_rn(-OFF, xsum[j].y);
        float d[4] = {c0, c1, c0, c1};
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          if constexpr (TKQ_GV_ABLATE == 1) {
            d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[st][0] ^ b[j][st].x);
            d[1] = __uint_as_float(__float_as_uint(d[1]) ^ a[st][1] ^ b[j][st].y);
            d[2] = __uint_as_float(__float_as_uint(d[2]) ^ a[st][2] ^ (Q8 ? ah[st][0] : 0u));
            d[3] = __uint_as_float(__float_as_uint(d[3]) ^ a[st][3] ^ (Q8 ? ah[st][3] : 0u));
            continue;
          }
          mma_bf16(d, a[st], b[j][st].x, b[j][st].y);
          if constexpr (HL) mma_bf16(d, a[st], bl[j][st].x, bl[j][st].y);
          if constexpr (Q8) {
            mma_bf16(d, ah[st], bf16x2_times16(b[j][st].x), bf16x2_times16(b[j][st].y));
            if constexpr (HL)
              mma_bf16(d, ah[st], bf16x2_times16(bl[j][st].x), bf16x2_times16(bl[j][st].y));
          }
        }
        float* c = acc[j][p];
        if constexpr (TKQ_GV_ABLATE == 2) {
          c[0] += d[0], c[1] += d[1], c[2] += d[2], c[3] += d[3];
          continue;
        }
        c[0] = __fmaf_rn(s0, d[0], c[0]);
        c[1] = __fmaf_rn(s0, d[1], c[1]);
        c[2] = __fmaf_rn(s1, d[2], c[2]);
        c[3] = __fmaf_rn(s1, d[3], c[3]);
        if constexpr (has_mins<KIND>()) {
          c[0] = __fmaf_rn(-m0, xsum[j].x, c[0]);
          c[1] = __fmaf_rn(-m0, xsum[j].y, c[1]);
          c[2] = __fmaf_rn(-m1, xsum[j].x, c[2]);
          c[3] = __fmaf_rn(-m1, xsum[j].y, c[3]);
        }
      }
    }
  }
}

// 8 bytes of columns n..n+7 of a byte-per-column row (zero past N, N % 4 ==
// 0); al8: the row and n are 8-byte aligned
__device__ __forceinline__ uint2 gv_ld8(const uint8_t* row, int n, int N, bool al8) {
  uint2 v = make_uint2(0u, 0u);
  if (al8) {
    if (n < N) v = __ldg(reinterpret_cast<const uint2*>(row + n));
  } else {
    if (n < N) v.x = __ldg(reinterpret_cast<const uint32_t*>(row + n));
    if (n + 4 < N) v.y = __ldg(reinterpret_cast<const uint32_t*>(row + n + 4));
  }
  return v;
}

// the scale words of columns ns, ns + 1 at side-array row `row`
__device__ __forceinline__ uint2 gv_ld_side(const uint32_t* base, size_t row, int N, int ns) {
  return ns < N ? __ldg(reinterpret_cast<const uint2*>(base + row * N + ns)) : make_uint2(0u, 0u);
}

// packed row of the lane's i-th row of chunk c (i = 4s + e: 16s + 4t + e)
__device__ __forceinline__ size_t gv_row(int c, int i, int t) {
  return (size_t)c * CH + 16 * (i / 4) + 4 * t + i % 4;
}

// The code words and the scale words of chunk c (q4 and flat kinds).
template <int KIND>
__device__ __forceinline__ void gv_load(uint2 (&w)[8], uint2 (&sc)[4], const GemvArgs& a, int c,
                                        int n, int ns, int t, bool al8) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = gv_ld8(a.qs + gv_row(c, i, t) * a.N, n, a.N, al8);
  sc[0] = sc[1] = sc[2] = sc[3] = make_uint2(0u, 0u);
  if constexpr (is_q4(KIND)) {  // the low fold's group c, the high fold's K/64 + c
    sc[0] = gv_ld_side(a.scl, c, a.N, ns);
    sc[1] = gv_ld_side(a.scl, (size_t)a.K / 64 + c, a.N, ns);
    if constexpr (KIND == KQ4F) {
      sc[2] = gv_ld_side(a.mins, c, a.N, ns);
      sc[3] = gv_ld_side(a.mins, (size_t)a.K / 64 + c, a.N, ns);
    }
  } else if constexpr (KIND == KQ6WF) {  // groups 2c, 2c + 1
    sc[0] = gv_ld_side(a.scl, 2 * c, a.N, ns);
    sc[1] = gv_ld_side(a.scl, 2 * c + 1, a.N, ns);
  } else {  // KQ6W: sp row c (groups 2c, 2c + 1); KQ8: sp row c / 2; KQ8F: row c
    sc[0] = gv_ld_side(a.scl, KIND == KQ8 ? c / 2 : c, a.N, ns);
  }
}

__device__ __forceinline__ void l2_prefetch(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A bit-plane kind's chunk c into L2 (its loads later in the loop then wait
// for L2, not device memory, and hold no registers meanwhile): the qh rows
// and the qs rows of every row group of the lane's columns, and every
// segment's scale (and min) rows. (The q4 and flat kinds' next chunk is in
// registers; bringing the one after it into L2 as well measured no faster
// on the H100, PERF.md §6.)
template <int KIND>
__device__ __forceinline__ void gv_prefetch_planes(const GemvArgs& a, int c, int n, int t) {
  if (n >= a.N) return;
  const int S = a.K / segments(KIND);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t r = gv_row(c, i, t);
#pragma unroll
    for (int tt = 0; tt < plane_nt(KIND); ++tt)
      l2_prefetch(a.qs + ((size_t)tt * S + r) * a.N + n);
    if constexpr (plane_hb(KIND) > 0) l2_prefetch(a.qh + r * a.N + n);
  }
  if (t != 0) return;  // one lane of the 4 that share a group's scale words
#pragma unroll 1
  for (int seg = 0; seg < segments(KIND); ++seg)
#pragma unroll
    for (int gg = 0; gg < CH / group_rows(KIND); ++gg) {
      const size_t row = ((size_t)seg * S + (size_t)c * CH) / group_rows(KIND) + gg;
      l2_prefetch(a.scl + row * a.N + n);
      if constexpr (f32_side(KIND)) l2_prefetch(a.mins + row * a.N + n);
    }
}

__device__ __forceinline__ uint32_t quad_shfl(uint32_t v, int lane, int p) {
  return __shfl_sync(0xffffffffu, v, (lane & ~3) | p);
}

// The scale and min of a q4 fold F's group for columns 2p, 2p+1 (sc: the
// lane's words of the low and high fold's group rows, then their f32 mins).
template <int KIND, int F>
struct Q4Scale {
  const uint2 (&sc)[4];
  int lane;
  __device__ __forceinline__ void operator()(int, int p, float& s0, float& m0, float& s1,
                                             float& m1) const {
    const uint32_t w0 = quad_shfl(sc[F].x, lane, p), w1 = quad_shfl(sc[F].y, lane, p);
    if constexpr (KIND == KQ4) {
      s0 = bf16_lo(w0), m0 = bf16_hi(w0), s1 = bf16_lo(w1), m1 = bf16_hi(w1);
    } else {
      s0 = __uint_as_float(w0), s1 = __uint_as_float(w1);
      m0 = __uint_as_float(quad_shfl(sc[2 + F].x, lane, p));
      m1 = __uint_as_float(quad_shfl(sc[2 + F].y, lane, p));
    }
  }
};

// One chunk (32 packed rows) of a q4 or flat kind (HL, loff: gv_segment's).
template <int KIND, int NT, bool HL = false>
__device__ __forceinline__ void gv_chunk(float (&acc)[NT][4][4], const uint2 (&w)[8],
                                         const uint2 (&sc)[4], const __nv_bfloat16* xb, int XS,
                                         const float* sb, int seg_stride_x,
                                         int seg_stride_s, int lane, bool odd, int loff = 0) {
  if constexpr (is_q4(KIND)) {  // the low fold is segment 0, the high fold segment 1
    gv_segment<KIND, NT, 0, Q4Scale<KIND, 0>, HL>(acc, w, xb, XS, sb, Q4Scale<KIND, 0>{sc, lane},
                                                  loff);
    gv_segment<KIND, NT, 1, Q4Scale<KIND, 1>, HL>(acc, w, xb + seg_stride_x, XS,
                                                  sb + seg_stride_s, Q4Scale<KIND, 1>{sc, lane},
                                                  loff);
  } else {
    auto scale = [&](int gg, int p, float& s0, float& m0, float& s1, float& m1) {
      m0 = m1 = 0.f;
      if constexpr (KIND == KQ6W) {
        const uint32_t w0 = quad_shfl(sc[0].x, lane, p), w1 = quad_shfl(sc[0].y, lane, p);
        s0 = gg ? bf16_hi(w0) : bf16_lo(w0), s1 = gg ? bf16_hi(w1) : bf16_lo(w1);
      } else if constexpr (KIND == KQ6WF) {
        s0 = __uint_as_float(quad_shfl(gg ? sc[1].x : sc[0].x, lane, p));
        s1 = __uint_as_float(quad_shfl(gg ? sc[1].y : sc[0].y, lane, p));
      } else if constexpr (KIND == KQ8) {
        const uint32_t w0 = quad_shfl(sc[0].x, lane, p), w1 = quad_shfl(sc[0].y, lane, p);
        s0 = odd ? bf16_hi(w0) : bf16_lo(w0), s1 = odd ? bf16_hi(w1) : bf16_lo(w1);
      } else {  // KQ8F
        s0 = __uint_as_float(quad_shfl(sc[0].x, lane, p));
        s1 = __uint_as_float(quad_shfl(sc[0].y, lane, p));
      }
    };
    gv_segment<KIND, NT, 0, decltype(scale), HL>(acc, w, xb, XS, sb, scale, loff);
  }
}

// One chunk of a bit-plane kind (q5, q6, q3, q2): the lane's qh words of the
// chunk once, then per qs row group tt its qs words, and per field p the
// codes of segment tt + NT * p (plane_codes), each segment's scales loaded
// where it starts.
template <int KIND, int NT>
__device__ __forceinline__ void gv_chunk_planes(float (&acc)[NT][4][4], const GemvArgs& a, int c,
                                                const __nv_bfloat16* xb, int XS, const float* sb,
                                                int L, int n, int ns, int t, int lane,
                                                bool al8) {
  constexpr int NTP = plane_nt(KIND), NP = plane_np(KIND), G = group_rows(KIND);
  constexpr int GPC = CH / G, ROWS = 8 * NT;
  const int S = a.K / segments(KIND);
  const int cps = L / CH;
  uint2 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = plane_hb(KIND) > 0 ? gv_ld8(a.qh + gv_row(c, i, t) * a.N, n, a.N, al8)
                              : make_uint2(0u, 0u);
  // not unrolled: the bodies are large and build time counts (a build of
  // every library took 95-113 s unrolled, 60 s not, on the H100's host)
#pragma unroll 1
  for (int tt = 0; tt < NTP; ++tt) {
    uint2 w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = gv_ld8(a.qs + ((size_t)tt * S + gv_row(c, i, t)) * a.N, n, a.N, al8);
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      const int seg = tt + NTP * p;
      uint2 cw[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cw[i] = make_uint2(plane_codes<KIND>(w[i].x, h[i].x, p, seg),
                           plane_codes<KIND>(w[i].y, h[i].y, p, seg));
      uint2 sc[GPC], mn[GPC];
#pragma unroll
      for (int gg = 0; gg < GPC; ++gg) {
        const size_t row = ((size_t)seg * S + (size_t)c * CH) / G + gg;
        sc[gg] = gv_ld_side(a.scl, row, a.N, ns);
        mn[gg] = f32_side(KIND) ? gv_ld_side(a.mins, row, a.N, ns) : make_uint2(0u, 0u);
      }
      auto scale = [&](int gg, int q, float& s0, float& m0, float& s1, float& m1) {
        const uint32_t w0 = quad_shfl(sc[gg].x, lane, q), w1 = quad_shfl(sc[gg].y, lane, q);
        if constexpr (f32_side(KIND)) {
          s0 = __uint_as_float(w0), s1 = __uint_as_float(w1);
          m0 = __uint_as_float(quad_shfl(mn[gg].x, lane, q));
          m1 = __uint_as_float(quad_shfl(mn[gg].y, lane, q));
        } else {
          s0 = bf16_lo(w0), m0 = bf16_hi(w0), s1 = bf16_lo(w1), m1 = bf16_hi(w1);
        }
      };
      gv_segment<KIND, NT, 0>(acc, cw, xb + seg * L, XS, sb + (size_t)seg * cps * GPC * ROWS,
                              scale);
    }
  }
}

// Stage rows [0, 8 NT) of x (rows >= R zero) for chunks [c0, c0 + nch) of
// every segment into xs [row][segment * L + local] as bf16 (L = cps * 32),
// then each scale group's sum of the staged values into sums [group][row]
// (groups segment-major, then chunk, then group in the chunk).
template <int KIND, int NT>
__device__ void gv_stage_x(__nv_bfloat16* xs, float* sums, const void* x, int x_f32, int R, int K,
                           int c0, int nch, int cps, int XS) {
  constexpr int NSEG = segments(KIND), G = group_rows(KIND), ROWS = 8 * NT;
  const int L = cps * CH, S = K / NSEG, vpr = NSEG * L / 8;  // 8-element vectors a row
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int i = threadIdx.x; i < ROWS * vpr; i += GV_THREADS) {
    const int r = i / vpr, j = i % vpr, seg = j / (L / 8), v = j % (L / 8);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && v * 8 < nch * CH) {
      const size_t k = (size_t)r * K + (size_t)seg * S + (size_t)c0 * CH + v * 8;
      if (x_f32) {
        const float* xf = static_cast<const float*>(x) + k;
        float f[8];
        if (vec) {
          const float4 lo = *reinterpret_cast<const float4*>(xf);
          const float4 hi = *reinterpret_cast<const float4*>(xf + 4);
          f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
          f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = xf[e];
        }
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
          u[e] = *reinterpret_cast<const uint32_t*>(&h);
        }
        o = make_uint4(u[0], u[1], u[2], u[3]);
      } else {
        const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x) + k;
        if (vec) {
          o = *reinterpret_cast<const uint4*>(xb);
        } else {
          uint16_t u[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) u[e] = reinterpret_cast<const uint16_t*>(xb)[e];
          o = make_uint4(u[0] | (uint32_t)u[1] << 16, u[2] | (uint32_t)u[3] << 16,
                         u[4] | (uint32_t)u[5] << 16, u[6] | (uint32_t)u[7] << 16);
        }
      }
    }
    *reinterpret_cast<uint4*>(xs + (size_t)r * XS + seg * L + v * 8) = o;
  }
  __syncthreads();
  const int NG = NSEG * cps * (CH / G);
  for (int i = threadIdx.x; i < ROWS * NG; i += GV_THREADS) {
    const int r = i / NG, gi = i % NG;
    const int seg = gi / (cps * (CH / G)), lg = gi % (cps * (CH / G));
    const uint4* p = reinterpret_cast<const uint4*>(xs + (size_t)r * XS + seg * L + lg * G);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G / 8; ++q) {
      const uint4 v = p[q];
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s = __fadd_rn(s, bf16_lo(u[e]));
        s = __fadd_rn(s, bf16_hi(u[e]));
      }
    }
    sums[gi * ROWS + r] = s;
  }
  __syncthreads();
}

// Sums of squares of rows [0, 8 NT) of x [R, K] bf16 (0 past R) into
// ss[8 NT], over the elements a block stages: of each of NSEG segments of K
// / NSEG elements, elements [base, base + L) (the whole row: NSEG 1, base
// 0, L K). Thread i sums the squares of its 8-element vectors i, i +
// GV_THREADS, ... of each row (16-byte loads, all in flight together),
// then the lanes by a butterfly and the warps in warp order, so a row's
// order of sums is the same at any R. Shared by gate_up.cuh (the row's
// rms) and attn_in.cuh (one K split's share of it). Ends with a barrier;
// red: 8 NT * (GV_THREADS / 32) floats of shared memory. x's rows 16-byte
// aligned.
template <int NT>
__device__ void gv_sumsq(float* ss, float* red, const __nv_bfloat16* x, int R, int K, int nseg,
                         int base, int L) {
  constexpr int ROWS = 8 * NT, NW = GV_THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, vps = L / 8, nv = nseg * vps;
  const int S = K / nseg;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r] = 0.f;
    if (r < R) {
      for (int v = threadIdx.x; v < nv; v += GV_THREADS) {
        const int k = (v / vps) * S + base + (v % vps) * 8;
        const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r] = __fmaf_rn(bf16_lo(w[e]), bf16_lo(w[e]), acc[r]);
          acc[r] = __fmaf_rn(bf16_hi(w[e]), bf16_hi(w[e]), acc[r]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    if (lane == 0) red[r * NW + warp] = acc[r];
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += red[threadIdx.x * NW + w];
    ss[threadIdx.x] = t;
  }
  __syncthreads();
}

// Stage rows [0, 8 NT) of the normalised rows x * rstd * nw (f32, as the
// reference's kernels keep them; rows >= R zero) for chunks [c0, c0 + nch)
// of every segment as gv_stage_x lays x out (L = cps * 32 elements a
// segment), as two bf16 halves: hi = bf16(v) at xs, lo = bf16(v - hi) 8 NT
// * XS elements on, so a group dot of both sees v to about 16 bits; then
// each scale group's sum of hi + lo. 16-byte loads of x and of the norm
// weight (both 16-byte aligned). Shared by gate_up.cuh and attn_in.cuh.
template <int KIND, int NT>
__device__ void gv_stage_xn(__nv_bfloat16* xs, float* sums, const __nv_bfloat16* x,
                            const float* nw, int R, int K, int cps, const float* rstd, int c0,
                            int nch, int XS) {
  constexpr int NSEG = segments(KIND), G = group_rows(KIND), ROWS = 8 * NT;
  const int L = cps * CH, S = K / NSEG, vpr = NSEG * L / 8;
  __nv_bfloat16* lo = xs + (size_t)ROWS * XS;
  for (int i = threadIdx.x; i < ROWS * vpr; i += GV_THREADS) {
    const int r = i / vpr, j = i % vpr, seg = j / (L / 8), v = j % (L / 8);
    uint32_t hw[4] = {0u, 0u, 0u, 0u}, lw[4] = {0u, 0u, 0u, 0u};
    if (r < R && v * 8 < nch * CH) {
      const int k = seg * S + c0 * CH + v * 8;
      const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
      const float4 n0 = *reinterpret_cast<const float4*>(nw + k);
      const float4 n1 = *reinterpret_cast<const float4*>(nw + k + 4);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v0 = bf16_lo(w[e]) * rstd[r] * nv[2 * e];
        const float v1 = bf16_hi(w[e]) * rstd[r] * nv[2 * e + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
        hw[e] = *reinterpret_cast<const uint32_t*>(&h);
        lw[e] = *reinterpret_cast<const uint32_t*>(&l);
      }
    }
    const size_t o = (size_t)r * XS + seg * L + v * 8;
    *reinterpret_cast<uint4*>(xs + o) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
  }
  __syncthreads();
  const int NG = NSEG * cps * (CH / G);
  for (int i = threadIdx.x; i < ROWS * NG; i += GV_THREADS) {
    const int r = i / NG, gi = i % NG;
    const int seg = gi / (cps * (CH / G)), lg = gi % (cps * (CH / G));
    const size_t o = (size_t)r * XS + seg * L + lg * G;
    float s = 0.f;
#pragma unroll 4
    for (int q = 0; q < G; q += 2) {
      const uint32_t h = *reinterpret_cast<const uint32_t*>(xs + o + q);
      const uint32_t l = *reinterpret_cast<const uint32_t*>(lo + o + q);
      s = __fadd_rn(s, __fadd_rn(bf16_lo(h), bf16_lo(l)));
      s = __fadd_rn(s, __fadd_rn(bf16_hi(h), bf16_hi(l)));
    }
    sums[gi * ROWS + r] = s;
  }
  __syncthreads();
}

// The block's result: the two K warps' sums added (warp row 0 + warp row 1)
// in the shared tile [8 NT][GV_TP] (row r, block column c). Ends with a
// barrier.
template <int NT>
__device__ void gv_combine(const float (&acc)[NT][4][4], float* tile, int wn, int wk, int g,
                           int t) {
  __syncthreads();  // the tile reuses the staged x
  for (int pass = 1; pass >= 0; --pass) {
    if (wk == pass) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int row = 8 * j + 2 * t, col = wn * 64 + 8 * g + 2 * p;
          float2* t0 = reinterpret_cast<float2*>(tile + row * GV_TP + col);
          float2* t1 = reinterpret_cast<float2*>(tile + (row + 1) * GV_TP + col);
          const float* c = acc[j][p];
          if (pass == 1) {
            *t0 = make_float2(c[0], c[2]);
            *t1 = make_float2(c[1], c[3]);
          } else {
            const float2 u0 = *t0, u1 = *t1;
            *t0 = make_float2(__fadd_rn(c[0], u0.x), __fadd_rn(c[2], u0.y));
            *t1 = make_float2(__fadd_rn(c[1], u1.x), __fadd_rn(c[3], u1.y));
          }
        }
    }
    __syncthreads();
  }
}

// gv_combine, then the tile stored coalesced: the epilogue of store_out into
// out, or the split's f32 partials into ws. (Args: GemvArgs, or any struct
// with its R, N, ws, out, out_f32, res and round_first.)
template <int NT, class Args>
__device__ void gv_finish(const float (&acc)[NT][4][4], const Args& a, float* tile, int wn,
                          int wk, int g, int t) {
  constexpr int ROWS = 8 * NT;
  gv_combine<NT>(acc, tile, wn, wk, g, t);
  for (int i = threadIdx.x; i < ROWS * GV_TN / 4; i += GV_THREADS) {
    const int r = i / (GV_TN / 4), c4 = (i % (GV_TN / 4)) * 4;
    const int col = blockIdx.x * GV_TN + c4;
    if (r >= a.R || col >= a.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * GV_TP + c4);
    const size_t o = (size_t)r * a.N + col;
    if (gridDim.y > 1) {
      *reinterpret_cast<float4*>(a.ws + (size_t)blockIdx.y * a.R * a.N + o) = v;
    } else {
      store_out(a.out, a.out_f32, o, v.x, a.res, a.round_first);
      store_out(a.out, a.out_f32, o + 1, v.y, a.res, a.round_first);
      store_out(a.out, a.out_f32, o + 2, v.z, a.res, a.round_first);
      store_out(a.out, a.out_f32, o + 3, v.w, a.res, a.round_first);
    }
  }
}

// grid (ceil(N / GV_TN), splits); GV_THREADS threads; dynamic smem
// gemv_smem_bytes<KIND>(NT, cps). R <= 8 NT.
template <int KIND, int NT>
__global__ void __launch_bounds__(GV_THREADS, NT <= 2 ? 2 : 1) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) uint8_t gv_smem[];
  constexpr int NSEG = segments(KIND), GPC = gv_gpc<KIND>(), ROWS = 8 * NT;
  const int n_chunks = n_chunks_of<KIND>(a.K);
  const int c0 = blockIdx.y * a.cps;
  const int nch = max(min(n_chunks, c0 + a.cps) - c0, 0);
  const int L = a.cps * CH, XS = gv_xstride(NSEG * L);
  auto* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem);
  float* sums = reinterpret_cast<float*>(gv_smem + (size_t)ROWS * XS * 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wn = warp % GV_WN, wk = warp / GV_WN;
  const int n = blockIdx.x * GV_TN + wn * 64 + 8 * g;  // the lane's 8 code columns
  const int ns = n + 2 * t;                             // the 2 columns whose scales it loads
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.qs) | reinterpret_cast<uintptr_t>(a.qh);
  const bool al8 = a.N % 8 == 0 && (ptrs & 7) == 0;
  // the first chunk's words are in flight while x is staged
  uint2 w[8], sc[4];
  if constexpr (!is_plane(KIND)) {
    if (wk < nch) gv_load<KIND>(w, sc, a, c0 + wk, n, ns, t, al8);
  } else if (wk < nch) {
    gv_prefetch_planes<KIND>(a, c0 + wk, n, t);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // x is written (GemvArgs.pdl)
  gv_stage_x<KIND, NT>(xs, sums, a.x, a.x_f32, a.R, a.K, c0, nch, a.cps, XS);
  float acc[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p][0] = acc[j][p][1] = acc[j][p][2] = acc[j][p][3] = 0.f;
  const __nv_bfloat16* xb = xs + g * XS + 4 * t;
  const float* sb = sums + 2 * t;
  const int chunk_sums = GPC * ROWS;  // sums a chunk-segment
  if constexpr (is_plane(KIND)) {
    for (int lc = wk; lc < nch; lc += GV_WK) {
      if (lc + GV_WK < nch) gv_prefetch_planes<KIND>(a, c0 + lc + GV_WK, n, t);
      gv_chunk_planes<KIND, NT>(acc, a, c0 + lc, xb + lc * CH, XS, sb + lc * chunk_sums, L, n, ns,
                                t, lane, al8);
    }
  } else {
    for (int lc = wk; lc < nch; lc += GV_WK) {
      // the next chunk's words (the last one again at the end) before this one's math
      uint2 wn2[8], sn[4];
      gv_load<KIND>(wn2, sn, a, c0 + min(lc + GV_WK, nch - 1), n, ns, t, al8);
      if constexpr (TKQ_GV_ABLATE == 3) {
        uint32_t v = sc[0].x ^ sc[1].y ^ sc[2].x ^ sc[3].y;
#pragma unroll
        for (int i = 0; i < 8; ++i) v ^= w[i].x ^ w[i].y;
        acc[0][0][0] += __uint_as_float(v & 0x007FFFFFu);
      } else {
        gv_chunk<KIND, NT>(acc, w, sc, xb + lc * CH, XS, sb + lc * chunk_sums, L,
                           a.cps * chunk_sums, lane, (c0 + lc) & 1);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = wn2[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = sn[i];
    }
  }
  gv_finish<NT>(acc, a, reinterpret_cast<float*>(gv_smem), wn, wk, g, t);
}

template <int KIND, int NT>
cudaError_t launch_gemv_nt(const GemvArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = gemv_smem_bytes<KIND>(NT, a.cps);
  cudaError_t e = cudaFuncSetAttribute(gemv_kernel<KIND, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + GV_TN - 1) / GV_TN, splits);
  cfg.blockDim = dim3(GV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gemv_kernel<KIND, NT>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, stream>>>(a.ws, splits, RN, a.out, a.out_f32, a.res,
                                                      a.round_first);
  return cudaGetLastError();
}

// The GEMV for R <= 32 rows: one n-tile of 8 rows per 8 rows of R; `splits`
// K splits of a.cps chunks each (ops/qmm.py:gemv_plan).
template <int KIND>
cudaError_t launch_gemv(const GemvArgs& a, int splits, cudaStream_t stream) {
  switch ((a.R + 7) / 8) {
    case 1: return launch_gemv_nt<KIND, 1>(a, splits, stream);
    case 2: return launch_gemv_nt<KIND, 2>(a, splits, stream);
    case 3: return launch_gemv_nt<KIND, 3>(a, splits, stream);
    case 4: return launch_gemv_nt<KIND, 4>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

// launch_gemv for a kind code chosen at run time among the kinds the fused
// kernels take (q4, q6w, q8, each in either scale layout). A template, so
// that only the libraries that call it instantiate (and compile) its 24
// kernels.
template <int = 0>
cudaError_t launch_gemv_kind(int kind, const GemvArgs& a, int splits, cudaStream_t stream) {
  switch (kind) {
    case KQ4: return launch_gemv<KQ4>(a, splits, stream);
    case KQ6W: return launch_gemv<KQ6W>(a, splits, stream);
    case KQ4F: return launch_gemv<KQ4F>(a, splits, stream);
    case KQ6WF: return launch_gemv<KQ6WF>(a, splits, stream);
    case KQ8: return launch_gemv<KQ8>(a, splits, stream);
    case KQ8F: return launch_gemv<KQ8F>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tkq
