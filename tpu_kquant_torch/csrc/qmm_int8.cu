// qmm_int8: y[R, N] = x[R, K] @ dequant(W)^T for a q4 or an unwidened q6
// weight with f32 scales and mins, through Q8 activations: the activations
// are quantized per weight group (32 for q4, 16 for q6) to int8, each
// group's products with the codes (4-bit, or 6-bit 0..63) are summed as
// exact int32, and the sums are rescaled in f32.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_qmm_int8.py:qmm_int8
// (_qmm_int8_call, kernel body _int8_kernel) with the activation
// quantization it calls (tpu_kquant/ops/act_quant.py:quantize_activations),
// kinds q4 and q6: the TPU form of ggml's ggml_vec_dot_q4_K_q8_K and
// ggml_vec_dot_q6_K_q8_K. Two launches:
//
// 1. quantize_kernel, one warp per 32-group of a row (two 16-groups for q6):
//    scale = amax / 127,
//    q = round-half-even(x / safe) clamped to +-127 (safe = scale, or 1 for
//    an all-zero group), gsum = scale * sum(q). x is divided by the scale,
//    not multiplied by its reciprocal, so codes at .5 match the reference's.
// 2. gemv_int8_kernel, gemv.cuh's block and lane layout on int8 tensor
//    cores. Memory bound: at Mixtral-8x7B's expert gate/up [14336, 4096] it
//    reads 29.4 MB of codes and 14.7 MB of f32 scales and mins, 13.1 us at
//    3.35 TB/s (the int8 operations, 2 R K N over 1979 TOP/s, are 0.06 us
//    at R = 1). A block owns 256 columns and all R <= 32 rows (so the packed
//    bytes are read once whatever R is), over a K split that depends on the
//    kind, N and K only (ops/qmm.py:gemv_plan); xq of the block's K range
//    and the groups' activation scales and gsums are staged in shared
//    memory. The codes enter the mma as they are (q4 0..15, q6 0..63: both
//    fit a signed byte), against xq: mma.sync.m16n8k32.s8 for q4's
//    32-groups, m16n8k16.s8 for q6's 16-groups, a fresh int32 accumulator
//    per group. A lane's 8 code words of a 16-row step are transposed four
//    rows at a time with __byte_perm (6 per 16 bytes) into the k-major
//    registers the mma wants. The group sums z are exact (|z| <= 32 * 127 *
//    15 and 16 * 127 * 63); per group and (column, row) the f32 epilogue
//    adds z * (xs * s) - gsum * m: the min term, which the reference leaves
//    to XLA outside its kernel (gsums @ mins), is folded into the same pass
//    over the weights. Splits of K write f32 partials that reduce_kernel
//    sums in a fixed order, so a row's result does not depend on the other
//    rows of the call.
//    q6 (the reference's q6 branch, pallas_qmm_int8.py:_int8_kernel with
//    qh): a chunk is 32 rows of qh and covers 4 segments of K/4 (common.cuh's
//    bit-plane geometry); per qs row group the lane forms the unsigned
//    6-bit codes a byte at a time (nibble | 2 high bits << 4). The -32
//    offset is in the mins (repack folds it as 32 * scale), so it is the
//    same min term. At TinyLlama's lm head [32000, 2048] q6 with f32 scales
//    and mins (10 bits a weight: 81.9 MB) the bound is 24.4 us.
#include "gemv.cuh"

namespace tkq {

// grid (ceil(R * K / 32 / WARPS)), THREADS threads: warp w of block b
// quantizes the 32 elements (b * WARPS + w) * 32 .. + 31 of x, as one
// 32-group or two 16-groups (QG), with the row-major [R, K / QG] groups.
template <int QG>
__global__ void __launch_bounds__(THREADS) quantize_kernel(const void* x, int x_f32, int8_t* xq,
                                                           float* xs, float* gsums,
                                                           size_t n_elems) {
  const int lane = threadIdx.x % 32;
  const size_t i = ((size_t)blockIdx.x * WARPS + threadIdx.x / 32) * 32 + lane;
  if (i - lane >= n_elems) return;  // whole warps only (n_elems % 32 == 0)
  const float v = load_x(x, x_f32, i);
  float amax = fabsf(v);
  for (int o = QG / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax / 127.0f;
  const float safe = scale > 0.f ? scale : 1.0f;
  const float q = fminf(fmaxf(rintf(v / safe), -127.f), 127.f);
  xq[i] = (int8_t)q;
  int sum = (int)q;
  for (int o = QG / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane % QG == 0) {
    xs[i / QG] = scale;
    gsums[i / QG] = scale * (float)sum;
  }
}

struct Int8Args {
  const int8_t* xq;      // [R, K]
  const float* xs;       // [R, K/g] per-group activation scales
  const float* gsums;    // [R, K/g] scale * sum of the group's codes
  const uint8_t* qs;     // folded nibbles [K/2, N]
  const uint8_t* qh;     // q6: the 2-bit high plane [K/4, N]; q4: null
  const uint32_t* scl;   // f32 scales [K/g, N] (as bits)
  const uint32_t* mins;  // f32 mins [K/g, N] (as bits)
  int R, N, K;
  int cps;    // chunks per K split (grid.y splits)
  float* ws;  // [grid.y, R, N] partials when grid.y > 1
  void* out;  // [R, N] when grid.y == 1
  int out_f32;
  const __nv_bfloat16* res = nullptr;  // (gv_finish's epilogue: no residual here)
  int round_first = 0;
};

// bytes a staged xq row takes for `span` codes: a multiple of 128 plus 16,
// so that the 8 rows of a warp's 4-byte B loads fall on different banks
__host__ __device__ constexpr int i8_xqstride(int span) { return (span + 127) / 128 * 128 + 16; }

// Dynamic shared memory of gemv_int8_kernel<KIND, NT> at `cps` chunks a
// split: xq [8 NT][xqstride] int8, the groups' activation scales and gsums
// [groups][8 NT] f32 each, or the output tile [8 NT][GV_TP] f32 that reuses
// them.
template <int KIND>
__host__ __device__ inline size_t int8_smem_bytes(int NT, int cps) {
  const size_t rows = 8 * NT;
  const size_t xq = rows * i8_xqstride(segments(KIND) * cps * CH);
  const size_t side = 2 * (size_t)segments(KIND) * cps * gv_gpc<KIND>() * rows * 4;
  const size_t tile = rows * GV_TP * 4;
  return xq + side > tile ? xq + side : tile;
}

// The 4 x 4 byte square w[0..3] (row i holds columns 0..3) transposed:
// col[j] holds column j of rows 0..3, row 0 in the low byte.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t (&col)[4]) {
  const uint32_t t01 = __byte_perm(w0, w1, 0x5140), t23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t u01 = __byte_perm(w0, w1, 0x7362), u23 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(t01, t23, 0x5410);
  col[1] = __byte_perm(t01, t23, 0x7632);
  col[2] = __byte_perm(u01, u23, 0x5410);
  col[3] = __byte_perm(u01, u23, 0x7632);
}

__device__ __forceinline__ void mma_s8_k32(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The int32 accumulator starts at the bits of 1.5 * 2^23, so that its bits
// read as a float are 1.5 * 2^23 + z exactly (|z| < 2^22): the group sum z
// as a float with one subtract.
constexpr int I8_MAGIC = 0x4B400000;
constexpr float I8_MAGIC_F = 12582912.0f;

// acc += z * (xs * s) - gsum * m for the mma's C fragment d of column pair
// (s0 / m0: column 2p; s1 / m1: column 2p + 1) at rows 2t (x of xs2 / gs2)
// and 2t + 1 (y).
__device__ __forceinline__ void i8_epilogue(float* c, const int (&d)[4], float2 xs2, float2 gs2,
                                            float s0, float m0, float s1, float m1) {
  const float z[4] = {__fsub_rn(__int_as_float(d[0]), I8_MAGIC_F),
                      __fsub_rn(__int_as_float(d[1]), I8_MAGIC_F),
                      __fsub_rn(__int_as_float(d[2]), I8_MAGIC_F),
                      __fsub_rn(__int_as_float(d[3]), I8_MAGIC_F)};
  c[0] = __fmaf_rn(z[0], __fmul_rn(xs2.x, s0), c[0]);
  c[1] = __fmaf_rn(z[1], __fmul_rn(xs2.y, s0), c[1]);
  c[2] = __fmaf_rn(z[2], __fmul_rn(xs2.x, s1), c[2]);
  c[3] = __fmaf_rn(z[3], __fmul_rn(xs2.y, s1), c[3]);
  c[0] = __fmaf_rn(-gs2.x, m0, c[0]);
  c[1] = __fmaf_rn(-gs2.y, m0, c[1]);
  c[2] = __fmaf_rn(-gs2.x, m1, c[2]);
  c[3] = __fmaf_rn(-gs2.y, m1, c[3]);
}

// Stage rows [0, 8 NT) of xq (rows >= R zero) for chunks [c0, c0 + nch) of
// every segment into xqs [row][segment * L + local] (L = 32 cps), and the
// groups' activation scales and gsums into sx / sg [group][row].
template <int KIND, int NT>
__device__ void i8_stage(int8_t* xqs, float* sx, float* sg, const Int8Args& a, int c0, int nch,
                         int XQS) {
  constexpr int NSEG = segments(KIND), G = group_rows(KIND), GPC = CH / G, ROWS = 8 * NT;
  const int L = a.cps * CH, S = a.K / NSEG, vpr = NSEG * L / 16;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < ROWS * vpr; i += GV_THREADS) {
    const int r = i / vpr, j = i % vpr, seg = j / (L / 16), v = j % (L / 16);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < a.R && v * 16 < nch * CH)
      o = *reinterpret_cast<const uint4*>(a.xq + (size_t)r * a.K + (size_t)seg * S +
                                          (size_t)c0 * CH + v * 16);
    *reinterpret_cast<uint4*>(xqs + (size_t)r * XQS + seg * L + v * 16) = o;
  }
  const int NG = NSEG * a.cps * GPC, KG = a.K / G;
  for (int i = threadIdx.x; i < NG * ROWS; i += GV_THREADS) {
    const int gi = i / ROWS, r = i % ROWS;
    const int seg = gi / (a.cps * GPC), lg = gi % (a.cps * GPC);
    const bool ok = r < a.R && lg < nch * GPC;
    const size_t k = (size_t)r * KG + ((size_t)seg * S + (size_t)c0 * CH) / G + lg;
    sx[i] = ok ? a.xs[k] : 0.f;
    sg[i] = ok ? a.gsums[k] : 0.f;
  }
  __syncthreads();
}

// The code words a lane holds for one chunk: q4, its 8 rows (and the
// lo / hi fold's scale and min words); q6, its 8 qh rows and its 8 rows of
// both qs row groups (the side words are loaded per segment).
template <int KIND>
struct I8Words {
  uint2 w[KIND == KQ4F ? 8 : 16], h[KIND == KQ4F ? 1 : 8], sc[2], mn[2];

  __device__ __forceinline__ void load(const Int8Args& a, int c, int n, int ns, int t, bool al8) {
    if constexpr (KIND == KQ4F) {
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = gv_ld8(a.qs + gv_row(c, i, t) * a.N, n, a.N, al8);
      sc[0] = gv_ld_side(a.scl, c, a.N, ns);
      sc[1] = gv_ld_side(a.scl, (size_t)a.K / 64 + c, a.N, ns);
      mn[0] = gv_ld_side(a.mins, c, a.N, ns);
      mn[1] = gv_ld_side(a.mins, (size_t)a.K / 64 + c, a.N, ns);
      h[0] = make_uint2(0u, 0u);
    } else {
      sc[0] = sc[1] = mn[0] = mn[1] = make_uint2(0u, 0u);
      const size_t S = a.K / 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = gv_ld8(a.qh + gv_row(c, i, t) * a.N, n, a.N, al8);
        w[i] = gv_ld8(a.qs + gv_row(c, i, t) * a.N, n, a.N, al8);
        w[8 + i] = gv_ld8(a.qs + (S + gv_row(c, i, t)) * a.N, n, a.N, al8);
      }
    }
  }
};

// One chunk (32 packed rows) of the lane's share, from its words `q`.
template <int KIND, int NT>
__device__ __forceinline__ void i8_chunk(float (&acc)[NT][4][4], const I8Words<KIND>& q,
                                         const Int8Args& a, int c, int lc, const int8_t* xb,
                                         int XQS, const float* sx, const float* sg, int ns,
                                         int t, int lane) {
  constexpr int ROWS = 8 * NT;
  const int L = a.cps * CH, S = a.K / segments(KIND);
  if constexpr (KIND == KQ4F) {
    uint32_t col[2][2][4];  // [step][word][column]: 4 rows of one column
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      transpose4(q.w[4 * s].x, q.w[4 * s + 1].x, q.w[4 * s + 2].x, q.w[4 * s + 3].x, col[s][0]);
      transpose4(q.w[4 * s].y, q.w[4 * s + 1].y, q.w[4 * s + 2].y, q.w[4 * s + 3].y, col[s][1]);
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {  // the low fold (segment 0), the high fold (segment 1)
      uint32_t b0[NT], b1[NT];
      float2 xs2[NT], gs2[NT];
      const int gi = f * a.cps + lc;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* xp = xb + j * 8 * XQS + f * L + lc * CH;
        b0[j] = *reinterpret_cast<const uint32_t*>(xp);
        b1[j] = *reinterpret_cast<const uint32_t*>(xp + 16);
        xs2[j] = *reinterpret_cast<const float2*>(sx + gi * ROWS + 8 * j + 2 * t);
        gs2[j] = *reinterpret_cast<const float2*>(sg + gi * ROWS + 8 * j + 2 * t);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float s0 = __uint_as_float(quad_shfl(q.sc[f].x, lane, p));
        const float s1 = __uint_as_float(quad_shfl(q.sc[f].y, lane, p));
        const float m0 = __uint_as_float(quad_shfl(q.mn[f].x, lane, p));
        const float m1 = __uint_as_float(quad_shfl(q.mn[f].y, lane, p));
        uint32_t r[4] = {col[0][p / 2][2 * (p % 2)], col[0][p / 2][2 * (p % 2) + 1],
                         col[1][p / 2][2 * (p % 2)], col[1][p / 2][2 * (p % 2) + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = (f ? r[e] >> 4 : r[e]) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          int d[4] = {I8_MAGIC, I8_MAGIC, I8_MAGIC, I8_MAGIC};
          mma_s8_k32(d, r[0], r[1], r[2], r[3], b0[j], b1[j]);
          i8_epilogue(acc[j][p], d, xs2[j], gs2[j], s0, m0, s1, m1);
        }
      }
    }
  } else {  // KQ6F: per qs row group tt, fields fl: segment tt + 2 fl, 16-row groups
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int fl = 0; fl < 2; ++fl) {
        const int seg = tt + 2 * fl;
        uint32_t cw[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cw[i][0] = plane_codes<KQ6F>(q.w[8 * tt + i].x, q.h[i].x, fl, seg);
          cw[i][1] = plane_codes<KQ6F>(q.w[8 * tt + i].y, q.h[i].y, fl, seg);
        }
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {  // group gg of the segment: step gg's 16 rows
          const size_t grow = ((size_t)seg * S + (size_t)c * CH) / 16 + gg;
          const uint2 sc = gv_ld_side(a.scl, grow, a.N, ns);
          const uint2 mn = gv_ld_side(a.mins, grow, a.N, ns);
          uint32_t col[2][4];
          transpose4(cw[4 * gg][0], cw[4 * gg + 1][0], cw[4 * gg + 2][0], cw[4 * gg + 3][0],
                     col[0]);
          transpose4(cw[4 * gg][1], cw[4 * gg + 1][1], cw[4 * gg + 2][1], cw[4 * gg + 3][1],
                     col[1]);
          uint32_t b0[NT];
          float2 xs2[NT], gs2[NT];
          const int gi = (seg * a.cps + lc) * 2 + gg;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            b0[j] = *reinterpret_cast<const uint32_t*>(xb + j * 8 * XQS + seg * L + lc * CH +
                                                       16 * gg);
            xs2[j] = *reinterpret_cast<const float2*>(sx + gi * ROWS + 8 * j + 2 * t);
            gs2[j] = *reinterpret_cast<const float2*>(sg + gi * ROWS + 8 * j + 2 * t);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float s0 = __uint_as_float(quad_shfl(sc.x, lane, p));
            const float s1 = __uint_as_float(quad_shfl(sc.y, lane, p));
            const float m0 = __uint_as_float(quad_shfl(mn.x, lane, p));
            const float m1 = __uint_as_float(quad_shfl(mn.y, lane, p));
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              int d[4] = {I8_MAGIC, I8_MAGIC, I8_MAGIC, I8_MAGIC};
              mma_s8_k16(d, col[p / 2][2 * (p % 2)], col[p / 2][2 * (p % 2) + 1], b0[j]);
              i8_epilogue(acc[j][p], d, xs2[j], gs2[j], s0, m0, s1, m1);
            }
          }
        }
      }
    }
  }
}

// grid (ceil(N / GV_TN), splits), GV_THREADS threads, dynamic smem
// int8_smem_bytes<KIND>(NT, cps). KIND: KQ4F or KQ6F; R <= 8 NT. The
// layout of lanes, columns and rows is gemv.cuh's; a lane's rows 16s + 4t +
// e of a chunk are the k-slots 4t + e (+ 16 s) of the int8 mma, so each
// 4 x 4 byte square of its loaded words, transposed, is one A register.
// q4: the next chunk's words are loaded before the current one is computed
// (q6's 48 words a chunk, twice, would not fit the registers of two blocks
// a SM).
template <int KIND, int NT>
__global__ void __launch_bounds__(GV_THREADS, NT <= 2 ? 2 : 1) gemv_int8_kernel(Int8Args a) {
  extern __shared__ __align__(16) uint8_t i8_smem[];
  constexpr int NSEG = segments(KIND), GPC = gv_gpc<KIND>(), ROWS = 8 * NT;
  constexpr bool PREFETCH = KIND == KQ4F;
  const int n_chunks = n_chunks_of<KIND>(a.K);
  const int c0 = blockIdx.y * a.cps;
  const int nch = max(min(n_chunks, c0 + a.cps) - c0, 0);
  const int L = a.cps * CH, XQS = i8_xqstride(NSEG * L);
  int8_t* xqs = reinterpret_cast<int8_t*>(i8_smem);
  float* sx = reinterpret_cast<float*>(i8_smem + (size_t)ROWS * XQS);
  float* sg = sx + (size_t)NSEG * a.cps * GPC * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wn = warp % GV_WN, wk = warp / GV_WN;
  const int n = blockIdx.x * GV_TN + wn * 64 + 8 * g, ns = n + 2 * t;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.qs) | reinterpret_cast<uintptr_t>(a.qh);
  const bool al8 = a.N % 8 == 0 && (ptrs & 7) == 0;
  I8Words<KIND> q;  // the first chunk's words are in flight while xq is staged
  if (wk < nch) q.load(a, c0 + wk, n, ns, t, al8);
  i8_stage<KIND, NT>(xqs, sx, sg, a, c0, nch, XQS);
  float acc[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p][0] = acc[j][p][1] = acc[j][p][2] = acc[j][p][3] = 0.f;
  const int8_t* xb = xqs + g * XQS + 4 * t;  // B: row g of n-tile 0, k-slots 4t..4t+3
  for (int lc = wk; lc < nch; lc += GV_WK) {
    if constexpr (PREFETCH) {
      I8Words<KIND> next;
      next.load(a, c0 + min(lc + GV_WK, nch - 1), n, ns, t, al8);
      i8_chunk<KIND, NT>(acc, q, a, c0 + lc, lc, xb, XQS, sx, sg, ns, t, lane);
      q = next;
    } else {
      if (lc != wk) q.load(a, c0 + lc, n, ns, t, al8);
      i8_chunk<KIND, NT>(acc, q, a, c0 + lc, lc, xb, XQS, sx, sg, ns, t, lane);
    }
  }
  gv_finish<NT>(acc, a, reinterpret_cast<float*>(i8_smem), wn, wk, g, t);
}

template <int KIND, int NT>
cudaError_t launch_int8_nt(const Int8Args& a, int splits, cudaStream_t st) {
  const size_t smem = int8_smem_bytes<KIND>(NT, a.cps);
  cudaError_t e = cudaFuncSetAttribute(gemv_int8_kernel<KIND, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + GV_TN - 1) / GV_TN, splits);
  gemv_int8_kernel<KIND, NT><<<grid, GV_THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, splits, RN, a.out, a.out_f32, nullptr, 0);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_int8(const Int8Args& a, int splits, cudaStream_t st) {
  switch ((a.R + 7) / 8) {
    case 1: return launch_int8_nt<KIND, 1>(a, splits, st);
    case 2: return launch_int8_nt<KIND, 2>(a, splits, st);
    case 3: return launch_int8_nt<KIND, 3>(a, splits, st);
    case 4: return launch_int8_nt<KIND, 4>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tkq

using namespace tkq;

// x [R, K] bf16 (or f32 with x_f32) -> xq int8 [R, K], xs and gsums f32
// [R, K/group], group 32 (q4) or 16 (q6). K % 32 == 0.
extern "C" int tkq_quantize_q8(const void* x, int x_f32, void* xq, float* xs, float* gsums, int R,
                               int K, int group, void* stream) {
  const size_t n = (size_t)R * K;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n / 32 + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 32)
    quantize_kernel<32><<<blocks, THREADS, 0, st>>>(x, x_f32, static_cast<int8_t*>(xq), xs,
                                                    gsums, n);
  else if (group == 16)
    quantize_kernel<16><<<blocks, THREADS, 0, st>>>(x, x_f32, static_cast<int8_t*>(xq), xs,
                                                    gsums, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// y [R, N] (f32, or bf16 with out_f32 = 0) from tkq_quantize_q8's outputs and
// a weight of kind KQ4F (folded codes qs [K/2, N], qh null, f32 scales and
// mins [K/32, N]; K % 64 == 0) or KQ6F (qs [K/2, N], qh [K/4, N], f32
// scales and mins [K/16, N]; K % 128 == 0). R <= 32, N % 4 == 0; `splits` K
// splits of `cps` chunks (ws holds splits * R * N floats when splits > 1).
// Returns the CUDA error code.
extern "C" int tkq_qmm_int8(int kind, const void* xq, const float* xs, const float* gsums,
                            const void* qs, const void* qh, const void* scales, const void* mins,
                            void* out, int out_f32, float* ws, int R, int N, int K, int cps,
                            int splits, void* stream) {
  Int8Args a{static_cast<const int8_t*>(xq), xs, gsums, static_cast<const uint8_t*>(qs),
             static_cast<const uint8_t*>(qh), static_cast<const uint32_t*>(scales),
             static_cast<const uint32_t*>(mins), R, N, K, cps, ws, out, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KQ4F) return (int)launch_int8<KQ4F>(a, splits, st);
  if (kind == KQ6F) return (int)launch_int8<KQ6F>(a, splits, st);
  return (int)cudaErrorInvalidValue;
}
