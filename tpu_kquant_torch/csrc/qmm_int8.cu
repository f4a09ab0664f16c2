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
// The device code is int8.cuh's, which the int8 folds of attn_in, gate/up
// and oproj_ffn's o_proj share (q4 on bf16 pairs too).
#include "int8.cuh"


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
