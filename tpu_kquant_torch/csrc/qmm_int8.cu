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
// 2. gemv_int8_kernel, the split-K GEMV of common.cuh with int8 arithmetic.
//    Memory bound: at Mixtral-8x7B's expert gate/up [14336, 4096] it reads
//    29.4 MB of codes and 14.7 MB of f32 scales and mins, 13.1 us at
//    3.35 TB/s (the int8 operations, 2 R K N over 1979 TOP/s, are 0.06 us).
//    A block owns 128 columns, a lane 4 neighbouring columns, as in qmm; the
//    block's rows of xq (both folds of its K range) and their per-group
//    scales and gsums are staged in shared memory. Per chunk a lane loads
//    its 32 code words (4 columns each), transposes each 4 x 4 byte square
//    with __byte_perm so that a word holds 4 consecutive k of one column,
//    and takes both nibble folds with one __dp4a each against the staged
//    xq words: the group sums z are exact (|z| <= 32 * 127 * 15). Per
//    group it adds z * (xs * s) - gsum * m in f32: the min term, which the
//    reference leaves to XLA outside its kernel (gsums @ mins), is folded
//    into the same pass over the weights. Splits of K write f32 partials
//    that common.cuh's reduce launch sums in a fixed order.
//    q6 (the reference's q6 branch, pallas_qmm_int8.py:_int8_kernel with
//    qh): a chunk is 32 rows of qh and covers 4 segments of K/4 (common.cuh's
//    bit-plane geometry); per qs row group t a lane loads its 32 qs and 32
//    qh words, forms the unsigned 6-bit codes a byte at a time (nibble |
//    2 high bits << 4: 0..63, so __dp4a's signed operand is safe), and sums
//    each 16-group exactly (|z| <= 16 * 127 * 63). The -32 offset is in the
//    mins (repack folds it as 32 * scale), so it is the same min term.
//    At TinyLlama's lm head [32000, 2048] q6 with f32 scales and mins
//    (10 bits a weight: 81.9 MB) the bound is 24.4 us.
#include "common.cuh"

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
};

// The 4 x 4 byte square w[0..3] (row i holds columns 0..3) transposed:
// col[j] holds column j of rows 0..3, row 0 in the low byte.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t (&col)[4]) {
  const uint32_t t01 = __byte_perm(w[0], w[1], 0x5140), t23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u01 = __byte_perm(w[0], w[1], 0x7362), u23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t01, t23, 0x5410);
  col[1] = __byte_perm(t01, t23, 0x7632);
  col[2] = __byte_perm(u01, u23, 0x5410);
  col[3] = __byte_perm(u01, u23, 0x7632);
}

// Segments and 16- or 32-groups per segment of a chunk: q4 2 and 1, q6 4
// and 2.
template <int KIND>
__host__ __device__ constexpr int int8_groups() { return CH / group_rows(KIND); }

// Shared memory, in floats: red [WARPS * RT * TN], gs and gq [RT][NSEG * cps
// * GPC] (segment-major, then chunk, then group), then the xq words
// [RT][NSEG * cps * 8] (32 bytes per chunk and segment).
template <int KIND>
__host__ __device__ __forceinline__ size_t int8_smem_floats(int RT, int cps) {
  return (size_t)WARPS * RT * TN + 2 * (size_t)RT * segments(KIND) * cps * int8_groups<KIND>() +
         (size_t)RT * segments(KIND) * cps * 8;
}

// grid (ceil(N / TN), splits, ceil(R / RT)). KIND: KQ4F or KQ6F.
template <int KIND, int RT>
__global__ void __launch_bounds__(THREADS) gemv_int8_kernel(Int8Args a) {
  constexpr int NSEG = segments(KIND), GPC = int8_groups<KIND>(), G = group_rows(KIND);
  extern __shared__ __align__(16) float smem[];
  const int n_chunks = n_chunks_of<KIND>(a.K);
  const int c0 = blockIdx.y * a.cps;
  const int c1 = min(n_chunks, c0 + a.cps);
  const int nch = max(c1 - c0, 0);
  const int r0 = blockIdx.z * RT;
  const int S = a.K / NSEG;  // rows per segment
  const int NG = a.K / G, gspan = NSEG * a.cps * GPC, span = NSEG * a.cps * 8;
  float* red = smem;
  float* gs = red + WARPS * RT * TN;
  float* gq = gs + RT * gspan;
  int* xw = reinterpret_cast<int*>(gq + RT * gspan);

  const int* xq_w = reinterpret_cast<const int*>(a.xq);
  for (int i = threadIdx.x; i < RT * NSEG * nch * 8; i += THREADS) {
    const int r = i / (NSEG * nch * 8), j = i % (NSEG * nch * 8);
    const int sg = j / (nch * 8), wi = j % (nch * 8);
    const size_t k4 = ((size_t)sg * S + (size_t)c0 * CH) / 4 + wi;  // word index in the row
    const size_t row = (size_t)(r0 + r) * (a.K / 4);
    xw[r * span + sg * a.cps * 8 + wi] = r0 + r < a.R ? xq_w[row + k4] : 0;
  }
  for (int i = threadIdx.x; i < RT * NSEG * nch * GPC; i += THREADS) {
    const int r = i / (NSEG * nch * GPC), j = i % (NSEG * nch * GPC);
    const int sg = j / (nch * GPC), gi = j % (nch * GPC);
    const size_t g = (size_t)(r0 + r) * NG + ((size_t)sg * S + (size_t)c0 * CH) / G + gi;
    const bool ok = r0 + r < a.R;
    gs[r * gspan + sg * a.cps * GPC + gi] = ok ? a.xs[g] : 0.f;
    gq[r * gspan + sg * a.cps * GPC + gi] = ok ? a.gsums[g] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * TN + lane * 4;
  const bool col_ok = n < a.N;
  float acc[RT][4] = {};
  for (int c = c0 + warp; c < c1; c += WARPS) {
    const int lc = c - c0;
    const size_t row0 = (size_t)c * CH;
    if constexpr (KIND == KQ4F) {
      uint32_t w[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(a.qs + (row0 + i) * a.N + n)) : 0u;
      ChunkScales<KQ4F> cs;
      cs.load(a.scl, a.mins, a.N, a.K, c, n, col_ok);
      int zlo[RT][4] = {}, zhi[RT][4] = {};
#pragma unroll
      for (int g4 = 0; g4 < CH / 4; ++g4) {
        uint32_t col[4];
        transpose4(w + 4 * g4, col);
        int lo[4], hi[4];  // 4 consecutive k of one column, low / high fold
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = (int)(col[j] & 0x0F0F0F0Fu);
          hi[j] = (int)((col[j] >> 4) & 0x0F0F0F0Fu);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int xl = xw[r * span + lc * 8 + g4];
          const int xh = xw[r * span + a.cps * 8 + lc * 8 + g4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            zlo[r][j] = __dp4a(lo[j], xl, zlo[r][j]);
            zhi[r][j] = __dp4a(hi[j], xh, zhi[r][j]);
          }
        }
      }
      float s0[4], m0[4], s1[4], m1[4];
      cs.decode(s0, m0, s1, m1);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xl = gs[r * gspan + lc], xh = gs[r * gspan + a.cps + lc];
        const float ql = gq[r * gspan + lc], qh = gq[r * gspan + a.cps + lc];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] += (float)zlo[r][j] * (xl * s0[j]) + (float)zhi[r][j] * (xh * s1[j]) -
                       ql * m0[j] - qh * m1[j];
      }
    } else {  // KQ6F: segments t (low nibbles) and t + 2 (high nibbles) per qs row group t
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t w[CH], h[CH];
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(
                              a.qs + ((size_t)t * S + row0 + i) * a.N + n))
                        : 0u;
          h[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(a.qh + (row0 + i) * a.N + n))
                        : 0u;
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int sg = t + 2 * p;
#pragma unroll
          for (int gg = 0; gg < GPC; ++gg) {  // 16-row groups: 4 words of 4 rows
            int z[RT][4] = {};
#pragma unroll
            for (int g4 = gg * 4; g4 < gg * 4 + 4; ++g4) {
              uint32_t cw[4], col[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                cw[i] = plane_codes<KQ6F>(w[4 * g4 + i], h[4 * g4 + i], p, sg);
              transpose4(cw, col);
#pragma unroll
              for (int r = 0; r < RT; ++r) {
                const int xv = xw[r * span + sg * a.cps * 8 + lc * 8 + g4];
#pragma unroll
                for (int j = 0; j < 4; ++j) z[r][j] = __dp4a((int)col[j], xv, z[r][j]);
              }
            }
            float sc[4], mn[4];
            group_scales<KQ6F>(a.scl, a.mins, a.N, (sg * S + (int)row0) / G + gg, n, col_ok, sc,
                               mn);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const int gi = sg * a.cps * GPC + lc * GPC + gg;
              const float xsg = gs[r * gspan + gi], gsum = gq[r * gspan + gi];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[r][j] += (float)z[r][j] * (xsg * sc[j]) - gsum * mn[j];
            }
          }
        }
      }
    }
  }
  block_reduce<RT>(red, acc);
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    const int r = r0 + i / TN, col = blockIdx.x * TN + i % TN;
    if (r >= a.R || col >= a.N) continue;
    const size_t o = (size_t)r * a.N + col;
    if (gridDim.y > 1)
      a.ws[(size_t)blockIdx.y * a.R * a.N + o] = red[i];
    else
      store_out(a.out, a.out_f32, o, red[i], nullptr, 0);
  }
}

template <int KIND, int RT>
cudaError_t launch_int8_rt(const Int8Args& a, int splits, cudaStream_t st) {
  const size_t smem = sizeof(float) * int8_smem_floats<KIND>(RT, a.cps);
  cudaError_t e = cudaFuncSetAttribute(gemv_int8_kernel<KIND, RT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + TN - 1) / TN, splits, (a.R + RT - 1) / RT);
  gemv_int8_kernel<KIND, RT><<<grid, THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, st>>>(a.ws, splits, RN, a.out, a.out_f32, nullptr, 0);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_int8(const Int8Args& a, int splits, cudaStream_t st) {
  switch (pick_rt(a.R)) {
    case 1: return launch_int8_rt<KIND, 1>(a, splits, st);
    case 2: return launch_int8_rt<KIND, 2>(a, splits, st);
    case 4: return launch_int8_rt<KIND, 4>(a, splits, st);
    default: return launch_int8_rt<KIND, 8>(a, splits, st);
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
