// Shared device code of the port's kernels (sm_90a): the packed-weight
// layouts, their kind codes and the small helpers every kernel uses. The
// decode GEMV core (qmm's R <= 32 path and the fused kernels' projections)
// is gemv.cuh's.
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
// the K-quant bit-plane kinds q5, q6, q3, q2
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
constexpr int WARPS = 8;           // the kernel lab's block (kernel_lab.cu)
constexpr int THREADS = WARPS * 32;
constexpr int TN = 128;            // the kernel lab's output columns per block
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

// Chunks of 32 packed rows along K.
template <int KIND>
__host__ __device__ __forceinline__ int n_chunks_of(int K) {
  return K / (segments(KIND) * CH);
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

}  // namespace tkq

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
