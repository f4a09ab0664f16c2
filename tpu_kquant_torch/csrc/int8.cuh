// The int8 decode GEMV core: Q8 activations (int8 per weight group, with
// each group's scale and scale-weighted sum, as ops/act_quant.py computes
// them) against packed codes on int8 tensor cores, exact int32 group sums
// rescaled per group in f32. qmm_int8.cu's kernel (q4 with f32 scales and
// mins, and unwidened q6) and, for both q4 layouts (bf16 pairs or f32),
// the int8 folds of the fused kernels: attn_in.cuh's and gate_up.cuh's q4
// slots (i8_stage_xn: the normalised rows quantized in shared memory, then
// i8_q4_chunk), and oproj_ffn's folded o_proj (quantize_kernel on the
// attention output, then gemv_int8_kernel with the residual epilogue).
// Replaces, beside qmm_int8.cu's TPU kernel, the fold of the reference's
// grid kernels: tpu_kquant/ops/pallas_dequant.py:act_quant_to_scratch and
// int8_group_fold. See qmm_int8.cu for the layout, the bound and the
// design.
#pragma once

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
  const uint32_t* scl;   // q4-sm pairs, or f32 scales [K/g, N] (as bits)
  const uint32_t* mins;  // f32 mins [K/g, N] (as bits); null for q4-sm
  int R, N, K;
  int cps;    // chunks per K split (grid.y splits)
  float* ws;  // [grid.y, R, N] partials when grid.y > 1
  void* out;  // [R, N] when grid.y == 1
  int out_f32;
  const __nv_bfloat16* res = nullptr;  // optional [R, N] residual (store_out's epilogue)
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

// The code words a lane holds for one q6 chunk: its 8 qh rows and its 8
// rows of both qs row groups (the side words are loaded per segment). (A
// q4 chunk's words are gv_load's.)
struct I8Q6Words {
  uint2 w[16], h[8];

  __device__ __forceinline__ void load(const Int8Args& a, int c, int n, int t, bool al8) {
    const size_t S = a.K / 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = gv_ld8(a.qh + gv_row(c, i, t) * a.N, n, a.N, al8);
      w[i] = gv_ld8(a.qs + gv_row(c, i, t) * a.N, n, a.N, al8);
      w[8 + i] = gv_ld8(a.qs + (S + gv_row(c, i, t)) * a.N, n, a.N, al8);
    }
  }
};

// One fold F of a q4 chunk against the staged int8 rows: the lane's codes
// as transposed 4 x 4 byte squares (col[step][word][column pair]), the
// fold's nibble of each, one m16n8k32 int8 mma per (column pair, n-tile)
// with a fresh accumulator (the group's exact sum z), then i8_epilogue
// with the group's scale and min of either layout (Q4Scale: bf16 pairs or
// f32 scales and mins). xb: row g of n-tile 0 at this chunk-segment (+
// 4t); sx / sg: the group's activation scales and gsums at rows 2t, 2t+1.
template <int KIND, int NT, int F>
__device__ __forceinline__ void i8_q4_half(float (&acc)[NT][4][4], const uint32_t (&col)[2][2][4],
                                           const Q4Scale<KIND, F>& scale, const int8_t* xb,
                                           int XQS, const float* sx, const float* sg) {
  uint32_t b0[NT], b1[NT];
  float2 xs2[NT], gs2[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int8_t* xp = xb + j * 8 * XQS;
    b0[j] = *reinterpret_cast<const uint32_t*>(xp);
    b1[j] = *reinterpret_cast<const uint32_t*>(xp + 16);
    xs2[j] = *reinterpret_cast<const float2*>(sx + 8 * j);
    gs2[j] = *reinterpret_cast<const float2*>(sg + 8 * j);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float s0, m0, s1, m1;
    scale(0, p, s0, m0, s1, m1);
    uint32_t r[4] = {col[0][p / 2][2 * (p % 2)], col[0][p / 2][2 * (p % 2) + 1],
                     col[1][p / 2][2 * (p % 2)], col[1][p / 2][2 * (p % 2) + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = (F ? r[e] >> 4 : r[e]) & 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int d[4] = {I8_MAGIC, I8_MAGIC, I8_MAGIC, I8_MAGIC};
      mma_s8_k32(d, r[0], r[1], r[2], r[3], b0[j], b1[j]);
      i8_epilogue(acc[j][p], d, xs2[j], gs2[j], s0, m0, s1, m1);
    }
  }
}

// One q4 chunk (both folds: the low fold is segment 0, the high fold
// segment 1, L bytes on in the staged rows and fstride floats on in sx /
// sg) from gv_load's words w and scale words sc, against int8 rows staged
// as i8_stage / i8_stage_xn lay them out. Shared by qmm_int8 and the
// folded slots of attn_in, gate/up and oproj_ffn's o_proj.
template <int KIND, int NT>
__device__ __forceinline__ void i8_q4_chunk(float (&acc)[NT][4][4], const uint2 (&w)[8],
                                            const uint2 (&sc)[4], const int8_t* xb, int XQS,
                                            int L, const float* sx, const float* sg,
                                            int fstride, int lane) {
  uint32_t col[2][2][4];  // [step][word][column]: 4 rows of one column
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    transpose4(w[4 * s].x, w[4 * s + 1].x, w[4 * s + 2].x, w[4 * s + 3].x, col[s][0]);
    transpose4(w[4 * s].y, w[4 * s + 1].y, w[4 * s + 2].y, w[4 * s + 3].y, col[s][1]);
  }
  i8_q4_half<KIND, NT, 0>(acc, col, Q4Scale<KIND, 0>{sc, lane}, xb, XQS, sx, sg);
  i8_q4_half<KIND, NT, 1>(acc, col, Q4Scale<KIND, 1>{sc, lane}, xb + L, XQS, sx + fstride,
                          sg + fstride);
}

// One q6 chunk (32 packed rows) of the lane's share, from its words `q`:
// per qs row group tt, fields fl: segment tt + 2 fl, 16-row groups.
template <int NT>
__device__ __forceinline__ void i8_q6_chunk(float (&acc)[NT][4][4], const I8Q6Words& q,
                                            const Int8Args& a, int c, int lc, const int8_t* xb,
                                            int XQS, const float* sx, const float* sg, int ns,
                                            int t, int lane) {
  constexpr int KIND = KQ6F, ROWS = 8 * NT;
  const int L = a.cps * CH, S = a.K / segments(KIND);
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

// grid (ceil(N / GV_TN), splits), GV_THREADS threads, dynamic smem
// int8_smem_bytes<KIND>(NT, cps). KIND: KQ4, KQ4F or KQ6F; R <= 8 NT. The
// layout of lanes, columns and rows is gemv.cuh's; a lane's rows 16s + 4t +
// e of a chunk are the k-slots 4t + e (+ 16 s) of the int8 mma, so each
// 4 x 4 byte square of its loaded words, transposed, is one A register.
template <int KIND, int NT>
__global__ void __launch_bounds__(GV_THREADS, NT <= 2 ? 2 : 1) gemv_int8_kernel(Int8Args a) {
  extern __shared__ __align__(16) uint8_t i8_smem[];
  constexpr int NSEG = segments(KIND), GPC = gv_gpc<KIND>(), ROWS = 8 * NT;
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
  float acc[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p][0] = acc[j][p][1] = acc[j][p][2] = acc[j][p][3] = 0.f;
  const int8_t* xb = xqs + g * XQS + 4 * t;  // B: row g of n-tile 0, k-slots 4t..4t+3
  if constexpr (is_q4(KIND)) {
    // the first chunk's words are in flight while xq is staged; the next
    // chunk's are loaded before the current one is computed
    const GemvArgs ga{nullptr, 0, a.qs, a.scl, a.R, a.N, a.K, a.cps, nullptr, nullptr, 0,
                      nullptr, a.mins};
    uint2 w[8], sc[4];
    if (wk < nch) gv_load<KIND>(w, sc, ga, c0 + wk, n, ns, t, al8);
    i8_stage<KIND, NT>(xqs, sx, sg, a, c0, nch, XQS);
    for (int lc = wk; lc < nch; lc += GV_WK) {
      uint2 wn2[8], sn[4];
      gv_load<KIND>(wn2, sn, ga, c0 + min(lc + GV_WK, nch - 1), n, ns, t, al8);
      i8_q4_chunk<KIND, NT>(acc, w, sc, xb + lc * CH, XQS, L, sx + lc * ROWS + 2 * t,
                            sg + lc * ROWS + 2 * t, a.cps * ROWS, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = wn2[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = sn[i];
    }
  } else {
    // q6's 48 words a chunk, twice, would not fit the registers of two
    // blocks a SM: no prefetch
    I8Q6Words q;
    if (wk < nch) q.load(a, c0 + wk, n, t, al8);
    i8_stage<KIND, NT>(xqs, sx, sg, a, c0, nch, XQS);
    for (int lc = wk; lc < nch; lc += GV_WK) {
      if (lc != wk) q.load(a, c0 + lc, n, t, al8);
      i8_q6_chunk<NT>(acc, q, a, c0 + lc, lc, xb, XQS, sx, sg, ns, t, lane);
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
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, splits, RN, a.out, a.out_f32, a.res,
                                                  a.round_first);
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

// Stage rows [0, 8 NT) of the normalised rows v = x * rstd * nw (f32, the
// order of gv_stage_xn and of the reference's act_quant_to_scratch input)
// for chunks [c0, c0 + nch) of both q4 segments of K as int8 codes per
// 32-group, act_quant's rule (scale = amax / 127, q = round-half-even(v /
// safe) clamped to +-127, gsum = scale * sum q): xq [row][segment * L +
// local] (L = 32 cps bytes a segment, XQS a row), sx / sg [group][row]
// (group = segment * cps + local chunk), as i8_stage lays out qmm_int8's
// rows; rows >= R and chunks >= nch zero. One thread a (group, row): a
// first pass takes the group's amax, a second quantizes, 8 elements at a
// time (16-byte loads of x, of the norm weight and 8-byte stores; the
// second pass reads them again from L1), so every unit of a block is in
// flight at once. Ends with a barrier. x's rows and nw 16-byte aligned.
template <int NT>
__device__ void i8_stage_xn(int8_t* xq, float* sx, float* sg, const __nv_bfloat16* x,
                            const float* nw, int R, int K, int cps, const float* rstd, int c0,
                            int nch, int XQS) {
  constexpr int ROWS = 8 * NT;
  const int L = cps * CH, S = K / 2, NG = 2 * cps;
  for (int u = threadIdx.x; u < NG * ROWS; u += GV_THREADS) {
    const int gi = u / ROWS, r = u % ROWS, seg = gi / cps, lc = gi % cps;
    uint2* dst = reinterpret_cast<uint2*>(xq + (size_t)r * XQS + seg * L + lc * CH);
    if (r >= R || lc >= nch) {
#pragma unroll
      for (int e = 0; e < CH / 8; ++e) dst[e] = make_uint2(0u, 0u);
      sx[u] = 0.f;
      sg[u] = 0.f;
      continue;
    }
    const int k = seg * S + (c0 + lc) * CH;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
    const float4* nr = reinterpret_cast<const float4*>(nw + k);
    const float rs = rstd[r];
    const auto eight = [&](int e, float (&v)[8]) {
      const uint4 w = xr[e];
      const float4 n0 = nr[2 * e], n1 = nr[2 * e + 1];
      const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
      const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[2 * h] = bf16_lo(ww[h]) * rs * nv[2 * h];
        v[2 * h + 1] = bf16_hi(ww[h]) * rs * nv[2 * h + 1];
      }
    };
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < CH / 8; ++e) {
      float v[8];
      eight(e, v);
#pragma unroll
      for (int h = 0; h < 8; ++h) amax = fmaxf(amax, fabsf(v[h]));
    }
    const float scale = amax / 127.0f;
    const float safe = scale > 0.f ? scale : 1.0f;
    int sum = 0;
#pragma unroll
    for (int e = 0; e < CH / 8; ++e) {
      float v[8];
      eight(e, v);
      uint32_t b[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int q = (int)fminf(fmaxf(rintf(v[h] / safe), -127.f), 127.f);
        sum += q;
        b[h / 4] |= (uint32_t)(q & 0xff) << (8 * (h % 4));
      }
      dst[e] = make_uint2(b[0], b[1]);
    }
    sx[u] = scale;
    sg[u] = scale * (float)sum;
  }
  __syncthreads();
}

// launch_int8 for a kind code chosen at run time: KQ4 or KQ4F (a folded
// o_proj). A template, so that only its callers compile its kernels.
template <int = 0>
cudaError_t launch_int8_q4(int kind, const Int8Args& a, int splits, cudaStream_t st) {
  if (kind == KQ4) return launch_int8<KQ4>(a, splits, st);
  if (kind == KQ4F) return launch_int8<KQ4F>(a, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace tkq
