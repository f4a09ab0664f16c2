// The qmm kernel lab (tpu_kquant_torch/utils/kernel_lab.py): the mutation
// ladder of the quantized GEMV, y[R, N] = x[R, K] @ W for a kmajor packed
// weight, in two geometries, and a manual double-buffered pipeline.
//
// Replaces the TPU kernels of tpu_kquant/utils/kernel_lab.py: lab_qmm's
// N-tiled grid (_ngrid_kernel, kernel #14) and K-chunked grid
// (_kgrid_kernel, #15), and lab_qmm_manual (_manual_kernel, #16). They are
// an instrument, not a path of the engine: each rung keeps the production
// GEMV's conventions (common.cuh: a lane reads a 32-bit word of 4
// neighbouring columns of a packed row, a warp 128 contiguous bytes; codes
// become floats by a byte permute into 2^23; bf16 pairs decode by shifts)
// and adds one stage of its pipeline:
//   dma      every packed byte summed per column as signed int8: 4 rows'
//            words transposed by __byte_perm, then __dp4a with ones
//   extract  + the codes masked / shifted out of their bytes (q4 nibbles)
//   convert  + codes to f32, FMA with x (no scales)
//   bf16c    + the scale chain in bf16: __hmul_rn / __hsub_rn (q4), the f32
//            product rounded to bf16 (sp pairs), __hmul (flat f32 scales)
//   full     + the f32 chain, w = bf16(q s - m), FMA with x
//   gdot     per group: s (x_g . q_g) - m sum(x_g), the production form
// The reference's MXU tricks (an int8 matmul with a ones operand, the
// masked block-diagonal dot) are matched in result, not in method.
//
// Bound: bytes. At R = 1 a rung reads the packed codes (and, for the scaled
// rungs, the scale planes) once: TinyLlama's gate/up [11264, 2048] q4-sm is
// 11.5 MB of codes + 2.9 MB of pairs, 4.3 us at 3.35 TB/s. The rungs differ
// only in the work per byte, which is what the ladder measures.
//
// Geometry "k" (#15): grid (ceil(N / 128), K/2 / TK2, row blocks); block =
// 8 warps over one 128-column tile and one chunk of TK2 packed rows of each
// fold (flat kinds: K rows split into two halves of K/2, as the reference's
// k grid splits them); warp w takes the 32-row sub-chunks w, w + 8, ...;
// the warps are reduced in shared memory and each chunk writes f32
// partials that a second launch sums in a fixed order (common.cuh's
// reduce_kernel): the production GEMV's split-K shape.
// Geometry "n" (#14): a block per TN-column tile (TN a multiple of 128 up
// to 1024: TN / 128 column warps, the other factor of 8 splitting K),
// walking the whole K with its accumulators in registers; one launch.
// Manual (#16, q4 only): the k geometry's blocks, each walking its chunk in
// stages of up to 256 packed rows through a two-slot ring in shared memory:
// stage i + 1's codes (and, past dma, its scale and min rows) are requested
// with cp.async before stage i's dequant runs; then the f32 combo chain
// w = q s, sum x w - m sum x. Unlike the reference's kernel, each stage
// reads its own x columns and each fold its own scale rows (and the mins
// on f32 scales), so it computes x @ W and streams what lab_bytes counts.
// Tile and chunk sizes change the blocking only; results change by f32
// summation order (dma and extract: integer sums, exact). Rows: a block row
// (grid.z) per activation row; the lab's case is R = 1, and each further
// row re-reads the weights. dma and extract compute their per-column sums
// once and write them to every row.
#include "common.cuh"

namespace tkq {
namespace lab {

enum { DMA = 0, EXTRACT = 1, CONVERT = 2, BF16C = 3, FULL = 4, GDOT = 5 };
// scale layouts: q4 bf16 (scale, min) pairs; q4 f32 scales + mins; flat
// (q6w, q8) bf16 pairs of adjacent groups; flat f32 scales
enum { FMT_SM = 0, FMT_Q4F = 1, FMT_SP = 2, FMT_F32 = 3 };
constexpr int SUB = 32;             // packed rows of a warp's sub-chunk
constexpr int MSTAGE = WARPS * SUB;  // packed rows of a manual ring stage
constexpr uint32_t ONES = 0x01010101u;

struct LabArgs {
  const __nv_bfloat16* x;  // [R, K]
  const uint8_t* qs;       // q4: u8 [K/2, N]; flat: i8 [K, N]
  const uint32_t* scl;     // sm / sp pairs or f32 scales
  const uint32_t* mins;    // f32 mins (FMT_Q4F) or null
  float* out;              // [R, N]
  float* ws;               // [chunks, R, N] partials (k geometry, chunks > 1)
  int R, N, K;
  int fmt, g;              // scale layout, rows per scale group
  int tile;                // k / manual: packed rows per chunk; n: columns per block
};

// s[c] += the signed bytes of column c over the 4 rows' words a..d.
__device__ __forceinline__ void dp4a_cols(int (&s)[4], uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  s[0] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x5410), (int)ONES, s[0]);
  s[1] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x7632), (int)ONES, s[1]);
  s[2] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x5410), (int)ONES, s[2]);
  s[3] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x7632), (int)ONES, s[3]);
}

// The codes of fold f of a packed word: q4 nibbles, or the flat kinds'
// signed bytes (whose fold is their half of K, a word of its own).
template <bool Q4>
__device__ __forceinline__ uint32_t fold_word(uint32_t w0, uint32_t w1, int f) {
  if constexpr (Q4) return f == 0 ? (w0 & 0x0F0F0F0Fu) : ((w0 >> 4) & 0x0F0F0F0Fu);
  return f == 0 ? w0 : w1;
}

template <bool Q4>
__device__ __forceinline__ void codes_f(uint32_t c, float (&q)[4]) {
  if constexpr (Q4) {
    q[0] = ubyte_f<0>(c), q[1] = ubyte_f<1>(c), q[2] = ubyte_f<2>(c), q[3] = ubyte_f<3>(c);
  } else {  // signed -> unsigned + 128, then minus 2^23 + 128
    const uint32_t u = c ^ 0x80808080u;
    q[0] = ubyte_f<0>(u, 8388736.0f), q[1] = ubyte_f<1>(u, 8388736.0f);
    q[2] = ubyte_f<2>(u, 8388736.0f), q[3] = ubyte_f<3>(u, 8388736.0f);
  }
}

// Warp-private staging of x for the sub-chunk at fold-local packed row p0:
// xs[f * SUB + i] = x[row, f * K/2 + p0 + i].
__device__ __forceinline__ void stage_x_warp(float* xs, const LabArgs& a, int row, int p0) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
#pragma unroll
  for (int f = 0; f < 2; ++f)
    xs[f * SUB + lane] = __bfloat162float(a.x[(size_t)row * a.K + f * (a.K / 2) + p0 + lane]);
  __syncwarp();
}

// Scales of the sub-chunk at fold-local packed row p0 for the lane's 4
// columns: s[f][h] for fold f and row half h (rows 0-15, 16-31; equal for
// 32-row groups), m[f] (0 for the flat kinds).
__device__ __forceinline__ void sub_scales(const LabArgs& a, int p0, int n, bool ok,
                                           float (&s)[2][2][4], float (&m)[2][4]) {
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int k0 = f * (a.K / 2) + p0;  // the sub-chunk's first element row of fold f
    uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
    const bool pairs = a.fmt == FMT_SM || a.fmt == FMT_SP;
    int row0, row1;
    if (a.fmt == FMT_SP) {
      row0 = row1 = a.g == 16 ? k0 / 32 : k0 / 64;  // q6w: both groups; q8: one half
    } else if (a.fmt == FMT_F32 && a.g == 16) {
      row0 = k0 / 16, row1 = row0 + 1;
    } else {
      row0 = row1 = k0 / 32;
    }
    if (ok) {
      w0 = __ldg(reinterpret_cast<const uint4*>(a.scl + (size_t)row0 * a.N + n));
      if (a.fmt == FMT_Q4F)
        w1 = __ldg(reinterpret_cast<const uint4*>(a.mins + (size_t)row0 * a.N + n));
      else if (row1 != row0)
        w1 = __ldg(reinterpret_cast<const uint4*>(a.scl + (size_t)row1 * a.N + n));
    }
    const uint32_t v0[4] = {w0.x, w0.y, w0.z, w0.w}, v1[4] = {w1.x, w1.y, w1.z, w1.w};
    const bool q8_odd = a.fmt == FMT_SP && a.g == 32 && ((k0 / 32) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s0, s1, mm = 0.f;
      if (a.fmt == FMT_SM) {
        s0 = s1 = bf16_lo(v0[j]), mm = bf16_hi(v0[j]);
      } else if (a.fmt == FMT_Q4F) {
        s0 = s1 = __uint_as_float(v0[j]), mm = __uint_as_float(v1[j]);
      } else if (pairs) {  // FMT_SP
        if (a.g == 16)
          s0 = bf16_lo(v0[j]), s1 = bf16_hi(v0[j]);
        else
          s0 = s1 = q8_odd ? bf16_hi(v0[j]) : bf16_lo(v0[j]);
      } else {  // FMT_F32, flat
        s0 = __uint_as_float(v0[j]);
        s1 = row1 != row0 ? __uint_as_float(v1[j]) : s0;
      }
      s[f][0][j] = s0, s[f][1][j] = s1, m[f][j] = mm;
    }
  }
}

// One warp's 32-row sub-chunk at fold-local packed row p0 of the rung MODE.
// dma / extract add per-column integer sums into iacc; the other rungs add
// f32 partials of activation row `row` into acc.
template <int MODE, bool Q4>
__device__ __forceinline__ void sub_chunk(const LabArgs& a, int p0, int n, bool ok, int row,
                                          float* xs, float (&acc)[4], int (&iacc)[4]) {
  uint32_t w0[SUB], w1[SUB];
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    w0[i] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.qs + (size_t)(p0 + i) * a.N + n)) : 0u;
    if constexpr (!Q4)
      w1[i] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.qs + (size_t)(a.K / 2 + p0 + i) *
                                                                   a.N + n))
                 : 0u;
  }
  if constexpr (MODE == DMA || MODE == EXTRACT) {
#pragma unroll
    for (int i = 0; i < SUB; i += 4) {
      if constexpr (MODE == DMA || !Q4) {  // flat codes are their bytes
        dp4a_cols(iacc, w0[i], w0[i + 1], w0[i + 2], w0[i + 3]);
        if constexpr (!Q4) dp4a_cols(iacc, w1[i], w1[i + 1], w1[i + 2], w1[i + 3]);
      } else {
#pragma unroll
        for (int f = 0; f < 2; ++f)
          dp4a_cols(iacc, fold_word<true>(w0[i], 0, f), fold_word<true>(w0[i + 1], 0, f),
                    fold_word<true>(w0[i + 2], 0, f), fold_word<true>(w0[i + 3], 0, f));
      }
    }
  } else {
    stage_x_warp(xs, a, row, p0);
    float s[2][2][4], m[2][4];
    if constexpr (MODE != CONVERT) sub_scales(a, p0, n, ok, s, m);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      __nv_bfloat16 sb[2][4], mb[4];
      if constexpr (MODE == BF16C) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sb[0][j] = __float2bfloat16_rn(s[f][0][j]), sb[1][j] = __float2bfloat16_rn(s[f][1][j]);
          mb[j] = __float2bfloat16_rn(m[f][j]);
        }
      }
      float gd[4] = {}, xsum = 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int h = i / 16;
        float q[4], w[4];
        codes_f<Q4>(fold_word<Q4>(w0[i], Q4 ? 0u : w1[i], f), q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == CONVERT || MODE == GDOT) {
            w[j] = q[j];
          } else if constexpr (MODE == FULL) {
            w[j] = round_bf16(__fsub_rn(__fmul_rn(q[j], s[f][h][j]), m[f][j]));
          } else {  // BF16C
            if (a.fmt == FMT_SP) {
              w[j] = round_bf16(q[j] * s[f][h][j]);
            } else {
              // _rn: two roundings, never contracted into one bf16 fma
              __nv_bfloat16 p = __hmul_rn(__float2bfloat16_rn(q[j]), sb[h][j]);
              if (a.fmt != FMT_F32) p = __hsub_rn(p, mb[j]);
              w[j] = __bfloat162float(p);
            }
          }
        }
        const float xv = xs[f * SUB + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == GDOT)
            gd[j] = fmaf(xv, w[j], gd[j]);
          else
            acc[j] = fmaf(xv, w[j], acc[j]);
        }
        if constexpr (MODE == GDOT && Q4) xsum += xv;  // the flat kinds have no mins
        if constexpr (MODE == GDOT) {
          // a scale group ends (16-row groups at i = 15, every group at 31;
          // i is a constant of the unrolled loop): apply it once
          if (i == SUB - 1 || (i == 15 && a.g == 16)) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j] += s[f][h][j] * gd[j] - m[f][j] * xsum;
              gd[j] = 0.f;
            }
            xsum = 0.f;
          }
        }
      }
    }
  }
}

// Sum the warps' per-lane accumulators over the K warps and store row
// `row`: red holds WARPS * TN floats laid out [kw][tnb]; the block's TNB
// columns start at col0. dma / extract (CONST_ROWS) hold the same sums for
// every row, computed once and written to all R rows. dest: out, or the
// chunk's partials in ws.
template <bool CONST_ROWS>
__device__ __forceinline__ void reduce_store(float* red, const float (&acc)[4], int kw, int nkw,
                                             int tnb, int lcol, int col0, int row,
                                             const LabArgs& a, float* dest) {
  __syncthreads();
  *reinterpret_cast<float4*>(red + kw * tnb + lcol) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  for (int c = threadIdx.x; c < tnb; c += THREADS) {
    const int col = col0 + c;
    if (col >= a.N) continue;
    float v = 0.f;
    for (int w = 0; w < nkw; ++w) v += red[w * tnb + c];
    if constexpr (CONST_ROWS) {
      for (int r = 0; r < a.R; ++r) dest[(size_t)r * a.N + col] = v;
    } else {
      dest[(size_t)row * a.N + col] = v;
    }
  }
}

template <int MODE>
__host__ __device__ constexpr bool const_rows() { return MODE == DMA || MODE == EXTRACT; }

// GEOM 0: the k geometry, 1: the n geometry (see the header).
// xs_all: WARPS * 2 * SUB floats (stage_x_warp); red: WARPS * TN.
template <int MODE, int GEOM, bool Q4>
__device__ __forceinline__ void lab_body(const LabArgs& a, float* xs_all, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.z;
  int n, j0, jstep, jend, kw, nkw, tnb, lcol, col0;
  if constexpr (GEOM == 0) {
    const int base = blockIdx.y * (a.tile / SUB);
    j0 = base + warp, jstep = WARPS, jend = base + a.tile / SUB;
    kw = warp, nkw = WARPS, tnb = TN, lcol = lane * 4, col0 = blockIdx.x * TN;
  } else {
    const int ncw = a.tile / TN, cw = warp % ncw;
    kw = warp / ncw, nkw = WARPS / ncw, tnb = a.tile;
    j0 = kw, jstep = nkw, jend = (a.K / 2) / SUB;
    lcol = cw * TN + lane * 4, col0 = blockIdx.x * a.tile;
  }
  n = col0 + lcol;
  const bool ok = n < a.N;
  float acc[4] = {};
  int iacc[4] = {0, 0, 0, 0};
  for (int j = j0; j < jend; j += jstep)
    sub_chunk<MODE, Q4>(a, j * SUB, n, ok, row, xs_all + warp * 2 * SUB, acc, iacc);
  if constexpr (const_rows<MODE>()) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = (float)iacc[c];
  }
  float* dest = (GEOM == 0 && gridDim.y > 1) ? a.ws + (size_t)blockIdx.y * a.R * a.N : a.out;
  reduce_store<const_rows<MODE>()>(red, acc, kw, nkw, tnb, lcol, col0, row, a, dest);
}

template <int MODE, int GEOM>
__global__ void __launch_bounds__(THREADS) lab_kernel(LabArgs a, int q4) {
  __shared__ __align__(16) float xs_all[WARPS * 2 * SUB];
  __shared__ __align__(16) float red[WARPS * TN];
  if (q4)
    lab_body<MODE, GEOM, true>(a, xs_all, red);
  else
    lab_body<MODE, GEOM, false>(a, xs_all, red);
}

template <int MODE, int GEOM>
cudaError_t launch(const LabArgs& a, int q4, cudaStream_t st) {
  const int row_blocks = const_rows<MODE>() ? 1 : a.R;
  const int chunks = GEOM == 0 ? (a.K / 2) / a.tile : 1;
  const dim3 grid(GEOM == 0 ? (a.N + TN - 1) / TN : (a.N + a.tile - 1) / a.tile, chunks,
                  row_blocks);
  lab_kernel<MODE, GEOM><<<grid, THREADS, 0, st>>>(a, q4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, chunks, RN, a.out, 1, nullptr, 0);
  return cudaGetLastError();
}

template <int GEOM>
cudaError_t launch_mode(int mode, const LabArgs& a, int q4, cudaStream_t st) {
  switch (mode) {
    case DMA: return launch<DMA, GEOM>(a, q4, st);
    case EXTRACT: return launch<EXTRACT, GEOM>(a, q4, st);
    case CONVERT: return launch<CONVERT, GEOM>(a, q4, st);
    case BF16C: return launch<BF16C, GEOM>(a, q4, st);
    case FULL: return launch<FULL, GEOM>(a, q4, st);
    case GDOT: return launch<GDOT, GEOM>(a, q4, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// #16: the manual ring (q4 only)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Bytes of one ring slot for stages of sr packed rows: the codes [sr][TN]
// u8, then (past dma) the scale rows [arrays][2 folds][sr / 32][TN] u32.
__host__ __device__ __forceinline__ int slot_bytes(bool dma, int fmt, int sr) {
  return sr * TN + (dma ? 0 : (fmt == FMT_Q4F ? 2 : 1) * 2 * (sr / SUB) * TN * 4);
}

template <bool IS_DMA>
__global__ void __launch_bounds__(THREADS) manual_kernel(LabArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float xs_all[WARPS][2 * SUB];
  __shared__ __align__(16) float red[WARPS * TN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sr = min(a.tile, MSTAGE), ns = a.tile / sr, G = sr / SUB;
  const int n_arr = a.fmt == FMT_Q4F ? 2 : 1;
  const int sbytes = slot_bytes(IS_DMA, a.fmt, sr);
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * a.tile, row = blockIdx.z;

  auto request = [&](int s, int slot) {
    unsigned char* base = ring + (size_t)slot * sbytes;
    const int prow = row0 + s * sr;
    for (int i = threadIdx.x; i < sr * (TN / 16); i += THREADS) {
      const int r = i / (TN / 16), c = (i % (TN / 16)) * 16;
      cp_async16(base + r * TN + c, a.qs + (size_t)(prow + r) * a.N + col0 + c);
    }
    if constexpr (!IS_DMA) {
      uint32_t* sb = reinterpret_cast<uint32_t*>(base + sr * TN);
      for (int i = threadIdx.x; i < n_arr * 2 * G * (TN / 4); i += THREADS) {
        const int piece = i % (TN / 4), rr = (i / (TN / 4)) % G;
        const int f = (i / (TN / 4) / G) % 2, arr = i / (TN / 4) / G / 2;
        const uint32_t* src = arr == 0 ? a.scl : a.mins;
        const int grow = (f * (a.K / 2) + prow) / SUB + rr;
        cp_async16(sb + ((arr * 2 + f) * G + rr) * TN + piece * 4,
                   src + (size_t)grow * a.N + col0 + piece * 4);
      }
    }
    cp_async_commit();
  };

  float acc[4] = {};
  int iacc[4] = {0, 0, 0, 0};
  request(0, 0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      request(s + 1, (s + 1) & 1);  // the next stage's copy is in flight during this one's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < G) {
      const unsigned char* base = ring + (size_t)(s & 1) * sbytes;
      const unsigned char* qrow = base + warp * SUB * TN + lane * 4;
      if constexpr (IS_DMA) {
#pragma unroll
        for (int i = 0; i < SUB; i += 4)
          dp4a_cols(iacc, *reinterpret_cast<const uint32_t*>(qrow + i * TN),
                    *reinterpret_cast<const uint32_t*>(qrow + (i + 1) * TN),
                    *reinterpret_cast<const uint32_t*>(qrow + (i + 2) * TN),
                    *reinterpret_cast<const uint32_t*>(qrow + (i + 3) * TN));
      } else {
        float* xs = xs_all[warp];
        stage_x_warp(xs, a, row, row0 + s * sr + warp * SUB);
        const uint32_t* sb = reinterpret_cast<const uint32_t*>(base + sr * TN);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const uint4 sw = *reinterpret_cast<const uint4*>(sb + (f * G + warp) * TN + lane * 4);
          uint4 mw = make_uint4(0, 0, 0, 0);
          if (a.fmt == FMT_Q4F)
            mw = *reinterpret_cast<const uint4*>(sb + ((2 + f) * G + warp) * TN + lane * 4);
          const uint32_t sv[4] = {sw.x, sw.y, sw.z, sw.w}, mv[4] = {mw.x, mw.y, mw.z, mw.w};
          float sc[4], mn[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[j] = a.fmt == FMT_SM ? bf16_lo(sv[j]) : __uint_as_float(sv[j]);
            mn[j] = a.fmt == FMT_SM ? bf16_hi(sv[j]) : __uint_as_float(mv[j]);
          }
          float d[4] = {}, xsum = 0.f;
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
            float q[4];
            codes_f<true>(fold_word<true>(*reinterpret_cast<const uint32_t*>(qrow + i * TN), 0, f),
                          q);
            const float xv = xs[f * SUB + i];
            xsum += xv;
#pragma unroll
            for (int j = 0; j < 4; ++j) d[j] = fmaf(xv, __fmul_rn(q[j], sc[j]), d[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += d[j] - mn[j] * xsum;
        }
      }
    }
    __syncthreads();  // the slot is consumed before the next request overwrites it
  }
  if constexpr (IS_DMA) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = (float)iacc[c];
  }
  float* dest = gridDim.y > 1 ? a.ws + (size_t)blockIdx.y * a.R * a.N : a.out;
  reduce_store<IS_DMA>(red, acc, warp, WARPS, TN, lane * 4, col0, row, a, dest);
}

template <bool IS_DMA>
cudaError_t launch_manual(const LabArgs& a, cudaStream_t st) {
  const int sr = a.tile < MSTAGE ? a.tile : MSTAGE;
  const int smem = 2 * slot_bytes(IS_DMA, a.fmt, sr);
  cudaError_t e = cudaFuncSetAttribute(manual_kernel<IS_DMA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (a.K / 2) / a.tile;
  const dim3 grid(a.N / TN, chunks, IS_DMA ? 1 : a.R);
  manual_kernel<IS_DMA><<<grid, THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, chunks, RN, a.out, 1, nullptr, 0);
  return cudaGetLastError();
}

}  // namespace lab
}  // namespace tkq

using namespace tkq;
using namespace tkq::lab;

static LabArgs lab_args(int fmt, int g, const void* x, const void* qs, const void* scl,
                        const void* mins, void* out, void* ws, int R, int N, int K, int tile) {
  LabArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.qs = static_cast<const uint8_t*>(qs);
  a.scl = static_cast<const uint32_t*>(scl);
  a.mins = static_cast<const uint32_t*>(mins);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.R = R, a.N = N, a.K = K, a.fmt = fmt, a.g = g, a.tile = tile;
  return a;
}

// One rung of the ladder (#14 geometry = 1, #15 geometry = 0). mode: the
// index in kernel_lab.py's MODES; q4: 1 for q4 codes, 0 for the flat int8
// kinds; fmt: FMT_*; g: rows per scale group; tile: packed rows per K chunk
// (k; a multiple of 32 dividing K/2) or columns per block (n; a multiple of
// 128 up to 1024). ws holds (K/2 / tile) * R * N floats when the k geometry
// has more than one chunk. Returns the CUDA error code of the launches.
extern "C" int tkq_lab_qmm(int mode, int geometry, int q4, int fmt, int g, const void* x,
                           const void* qs, const void* scl, const void* mins, void* out,
                           void* ws, int R, int N, int K, int tile, void* stream) {
  const bool bad_tile = geometry == 0 ? (tile % SUB != 0 || (K / 2) % tile != 0)
                                      : (tile % TN != 0 || tile > WARPS * TN);
  if (R < 1 || N % 4 || K % 64 || tile <= 0 || bad_tile || (fmt == FMT_Q4F && !mins))
    return (int)cudaErrorInvalidValue;
  const LabArgs a = lab_args(fmt, g, x, qs, scl, mins, out, ws, R, N, K, tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(geometry == 0 ? launch_mode<0>(mode, a, q4, st) : launch_mode<1>(mode, a, q4, st));
}

// #16: dma = 1 sums the bytes, else the f32 combo chain; q4 with fmt
// FMT_SM or FMT_Q4F; N % 128 == 0; tk2 packed rows per chunk (a multiple of
// 32 dividing K/2); ws as tkq_lab_qmm's k geometry.
extern "C" int tkq_lab_qmm_manual(int dma, int fmt, const void* x, const void* qs,
                                  const void* scl, const void* mins, void* out, void* ws, int R,
                                  int N, int K, int tk2, void* stream) {
  if (R < 1 || N % TN || K % 64 || tk2 <= 0 || tk2 % SUB || (K / 2) % tk2 ||
      (fmt != FMT_SM && fmt != FMT_Q4F) || (fmt == FMT_Q4F && !mins) ||
      (tk2 > MSTAGE && tk2 % MSTAGE))
    return (int)cudaErrorInvalidValue;
  const LabArgs a = lab_args(fmt, 32, x, qs, scl, mins, out, ws, R, N, K, tk2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dma ? launch_manual<true>(a, st) : launch_manual<false>(a, st));
}
