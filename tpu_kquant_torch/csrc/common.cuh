// Shared device code of the port's kernels (sm_90a): the packed-weight
// layouts, the split-K GEMV core used at decode rows, and its reduce step.
//
// Packed layouts (tpu_kquant_torch/quant/repack.py), weights W of logical
// shape (N, K) stored K-major with N contiguous:
//   KQ4  : qs u8 [K/2, N], byte (k, n) = code(k) | code(k + K/2) << 4;
//          sm f32-container [K/32, N]: low 16 bits bf16 scale, high 16 bits
//          bf16 min; w = s * q - m.
//   KQ6W : qs i8 [K, N] signed codes; sp f32-container [K/32, N]: low 16
//          bits bf16 scale of group 2j (rows 32j..32j+15), high 16 bits the
//          scale of group 2j+1; w = s * q.
//   KQ4F : KQ4's codes with f32 scales [K/32, N] and f32 mins [K/32, N]
//          (scale_dtype='f32'); w = s * q - m.
//   KQ6WF: KQ6W's codes with f32 scales [K/16, N]; w = s * q.
// N must be a multiple of 4 (a lane reads 4 columns as one word).
//
// GEMV core (rows <= 32, memory bound): a block owns TN = 128 output
// columns, each lane 4 neighbouring columns, so a warp reads 128 contiguous
// bytes of every packed row. The block's 8 warps split its K range into
// 32-row chunks; per chunk a lane loads all 32 words first (32 loads in
// flight per warp), then accumulates code * x per scale group and applies
// the group's scale and min once: sum_k x (s q - m) = s sum x q - m sum x.
// Codes become floats with a byte permute into the mantissa of 2^23 and one
// subtract (integer-to-float conversion has a fraction of the FMA rate). The
// activation rows are staged in shared memory in f32. Warps are reduced in
// shared memory; blocks split along K (grid.y) write f32 partials that a
// second launch sums in a fixed order, so results are deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tkq {

constexpr int KQ4 = 0;
constexpr int KQ6W = 1;
constexpr int KQ4F = 2;
constexpr int KQ6WF = 3;
// the kinds whose codes are folded nibbles (two K groups per packed row)
__host__ __device__ constexpr bool is_q4(int kind) { return kind == KQ4 || kind == KQ4F; }
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
  return (is_q4(KIND) ? 2 : 1) * n_chunks * CH;
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
// [RT][span] f32. q4: the first half holds elements 32*c0.. of the low fold,
// the second half the same offsets + K/2 (the high fold); q6w: elements
// 32*c0... With nw != nullptr each value is normalised: x * rstd[r] * nw[k].
template <int KIND, int RT>
__device__ void stage_x(float* xs, const void* x, int x_f32, int R, int K, int r0, int c0,
                        int c1, const float* nw, const float* rstd) {
  const int L = (c1 - c0) * CH;
  const int span = x_span<KIND>(c1 - c0);
  for (int i = threadIdx.x; i < RT * span; i += THREADS) {
    const int r = i / span, j = i % span;
    const int k = (is_q4(KIND) && j >= L) ? K / 2 + c0 * CH + (j - L) : c0 * CH + j;
    float v = 0.f;
    if (r0 + r < R) {
      v = load_x(x, x_f32, (size_t)(r0 + r) * K + k);
      if (nw != nullptr) v = v * rstd[r] * nw[k];
    }
    xs[i] = v;
  }
  __syncthreads();
}

// The scales of packed chunk c (32 packed rows) for the 4 columns n..n+3.
// load() issues the loads; decode() returns them as f32: q4 kinds give the
// low fold's group c (s0, m0) and the high fold's group K/64 + c (s1, m1);
// q6w kinds the chunk's two 16-row groups 2c (s0) and 2c + 1 (s1), with
// m0 = m1 = 0. The bf16 kinds keep only their packed words (8 or 4
// registers) until decode(). `mins` is read by KQ4F only.
template <int KIND>
struct ChunkScales {
  static constexpr bool kTwo = KIND != KQ6W;  // a second scale row (b)
  static constexpr bool kMins = KIND == KQ4F;
  uint4 a, b, ma, mb;

  __device__ __forceinline__ void load(const uint32_t* scl, const uint32_t* mins, int N, int K,
                                       int c, int n, bool ok) {
    a = b = ma = mb = make_uint4(0, 0, 0, 0);
    if (!ok) return;
    size_t ra, rb;
    if constexpr (is_q4(KIND)) {
      ra = (size_t)c * N + n, rb = ((size_t)(K / 64) + c) * N + n;
    } else {  // KQ6W: one sp row per chunk; KQ6WF: two scale rows
      ra = (size_t)(KIND == KQ6W ? c : 2 * c) * N + n, rb = ra + N;
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
      } else {
        s0[j] = __uint_as_float(wa[j]), s1[j] = __uint_as_float(wb[j]);
        m0[j] = kMins ? __uint_as_float(wma[j]) : 0.f;
        m1[j] = kMins ? __uint_as_float(wmb[j]) : 0.f;
      }
    }
  }
};

// One warp's share of a block's GEMV: chunks c0 + warp, c0 + warp + 8, ...
// below c1, for the lane's 4 columns starting at n. acc is accumulated.
template <int KIND, int RT>
__device__ __forceinline__ void gemv_warp(float (&acc)[RT][4], const uint8_t* qs,
                                          const uint32_t* scl, int N, int K, int n, bool col_ok,
                                          int c0, int c1, const float* xs, int span,
                                          const uint32_t* mins = nullptr) {
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
    } else {
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
// bf16 or f32.
__device__ __forceinline__ void store_out(void* out, int out_f32, size_t i, float v,
                                          const __nv_bfloat16* res) {
  if (res != nullptr) v = round_bf16(__bfloat162float(res[i]) + v);
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

struct GemvArgs {
  const void* x;  // [R, K] activations, bf16 or f32 (x_f32)
  int x_f32;
  const uint8_t* qs;
  const uint32_t* scl;  // sm (q4), sp (q6w), or f32 scales (KQ4F, KQ6WF)
  int R, N, K;
  int cps;                   // chunks per K split (grid.y splits)
  float* ws;                 // [grid.y, R, N] partials when grid.y > 1
  void* out;                 // [R, N] when grid.y == 1
  int out_f32;
  const __nv_bfloat16* res;  // optional [R, N] residual (grid.y == 1)
  const uint32_t* mins;      // f32 mins [K/32, N] (KQ4F only)
};

// grid (ceil(N / TN), splits, ceil(R / RT)); dynamic smem:
// RT * (x_span(cps) + WARPS * TN) floats.
template <int KIND, int RT>
__global__ void __launch_bounds__(THREADS) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_chunks = (is_q4(KIND) ? a.K / 2 : a.K) / CH;
  const int c0 = blockIdx.y * a.cps;
  const int c1 = min(n_chunks, c0 + a.cps);
  const int r0 = blockIdx.z * RT;
  const int span = x_span<KIND>(a.cps);
  float* xs = smem;
  float* red = smem + RT * span;
  if (c0 < c1) stage_x<KIND, RT>(xs, a.x, a.x_f32, a.R, a.K, r0, c0, c1, nullptr, nullptr);
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * TN + lane * 4;
  float acc[RT][4] = {};
  if (c0 < c1)
    gemv_warp<KIND, RT>(acc, a.qs, a.scl, a.N, a.K, n, n < a.N, c0, c1, xs,
                        x_span<KIND>(c1 - c0), a.mins);
  block_reduce<RT>(red, acc);
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    const int r = r0 + i / TN, col = blockIdx.x * TN + i % TN;
    if (r >= a.R || col >= a.N) continue;
    const size_t o = (size_t)r * a.N + col;
    if (gridDim.y > 1)
      a.ws[(size_t)blockIdx.y * a.R * a.N + o] = red[i];
    else
      store_out(a.out, a.out_f32, o, red[i], a.res);
  }
}

// out[r, n] = sum over splits s of ws[s, r, n] (in order s = 0, 1, ...),
// then the store_out epilogue.
__global__ void __launch_bounds__(256) reduce_kernel(const float* ws, int S, int RN, void* out,
                                                     int out_f32, const __nv_bfloat16* res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RN) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += ws[(size_t)s * RN + i];
  store_out(out, out_f32, i, v, res);
}

template <int KIND, int RT>
cudaError_t launch_gemv_rt(const GemvArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * RT * (x_span<KIND>(a.cps) + WARPS * TN);
  cudaError_t e = cudaFuncSetAttribute(gemv_kernel<KIND, RT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + TN - 1) / TN, splits, (a.R + RT - 1) / RT);
  gemv_kernel<KIND, RT><<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int RN = a.R * a.N;
  reduce_kernel<<<(RN + 255) / 256, 256, 0, stream>>>(a.ws, splits, RN, a.out, a.out_f32, a.res);
  return cudaGetLastError();
}

// rows per block for R rows (R <= 32): the next power of two up to 8
__host__ __forceinline__ int pick_rt(int R) { return R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8; }

template <int KIND>
cudaError_t launch_gemv(const GemvArgs& a, int splits, cudaStream_t stream) {
  switch (pick_rt(a.R)) {
    case 1: return launch_gemv_rt<KIND, 1>(a, splits, stream);
    case 2: return launch_gemv_rt<KIND, 2>(a, splits, stream);
    case 4: return launch_gemv_rt<KIND, 4>(a, splits, stream);
    default: return launch_gemv_rt<KIND, 8>(a, splits, stream);
  }
}

// launch_gemv for a kind code chosen at run time (the fused kernels take
// each weight in either scale layout)
inline cudaError_t launch_gemv_kind(int kind, const GemvArgs& a, int splits,
                                    cudaStream_t stream) {
  switch (kind) {
    case KQ4: return launch_gemv<KQ4>(a, splits, stream);
    case KQ6W: return launch_gemv<KQ6W>(a, splits, stream);
    case KQ4F: return launch_gemv<KQ4F>(a, splits, stream);
    case KQ6WF: return launch_gemv<KQ6WF>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tkq

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
