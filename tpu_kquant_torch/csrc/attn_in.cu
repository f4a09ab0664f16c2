// attn_in: rms_norm -> [wqk | wv] -> bf16 round -> (+ f32 bias) -> NEOX
// rope on the qk columns, in one launch, for decode rows (R <= 32).
//
// Replaces the TPU kernels tpu_kquant/ops/pallas_attn_in.py:fused_attn_in,
// manual variant _attn_in_manual_call (kernel _attn_in_manual_kernel) and
// Mosaic-grid variant _attn_in_call (_attn_in_kernel), for the kinds the
// reference's attn_in_supported takes in either slot: q4, q6w or q8
// (wqk q4 + wv q6w at Q4_K_M, both q8 at Q8_0, both q6w at Q6_K, both q4 at
// Q4_K_S), each with bf16 scale pairs (sm / sp) or f32 scales
// (scale_dtype='f32'; the grid variant reads these), chosen per slot at run
// time; optional f32 biases (qwen2's q/k/v biases:
// bqk [n0] = [bq | bk], bv [n1]; the epilogue order of _attn_in_kernel,
// pallas_attn_in.py:237-254: round the sum to bf16, add the bias, rope in
// f32, cast).
//
// Bound: memory. At TinyLlama width it reads wqk [2304, 2048] q4-sm (2.95 MB)
// and wv [256, 2048] q6w-sp (0.59 MB): 3.5 MB, 1.1 us at 3.35 TB/s; at
// Qwen2.5-1.5B width wqk [1792, 1536] q4-sm (1.72 MB) and wv [256, 1536]
// q6w-sp (0.44 MB): 2.2 MB, 0.65 us; at Mixtral-8x7B width with f32 scales
// wqk [5120, 4096] q4 (15.7 MB) and wv [1024, 4096] q6w (5.2 MB): 20.9 MB,
// 6.3 us; TinyLlama at Q8_0 (both q8-sp, 8.5 bits a weight) 5.4 MB, 1.6 us.
//
// Design (attn_in.cuh): gemv.cuh's tensor-core GEMV core with the norm in
// front (gate_up.cuh's staging: hi + lo bf16 rows), 128-column blocks of
// whole heads, a K split from attn_in_plan (kinds and widths, never R)
// whose splits form a thread-block cluster: every block takes the rows'
// rms over the whole row, the GEMV's partial tiles are read over
// distributed shared memory and added in rank order, and the ranks share
// the epilogue (bf16 round, bias, rope). One launch, no workspace. Where
// head_dim does not divide 128 (256, the gemma family; 96, phi3) a block's
// 128 columns are 64 columns of its heads' first halves, in runs of 8, and
// their 64 rope partners, so each epilogue still holds whole rope pairs.
// phi3's pre-fused wqkv (one tensor, ops/attn_in.py:qkv_slots) runs as two
// slots over its bytes: qk its first (H + Hkv) hd columns, v the rest,
// each with the full row stride (ld0, ld1), as the reference's one-slot
// call ropes output 0's first (H + Hkv) hd columns and pads the v columns
// with cos 1, sin 0 (pallas_attn_in.py:rope_tables_full, n_pad). At
// Phi-3-mini-4k width it reads wqkv [9216, 3072] q4-sm once: 17.7 MB, 5.3
// us at 3.35 TB/s. The earlier CUDA-core kernel (20 blocks over the whole
// of K at TinyLlama width, 8 rows a block) took 0.0146 ms at TinyLlama R =
// 1 on an H100 80GB HBM3 (chip_smoke.py phase 3).
#include "attn_in.cuh"

using namespace tkq;

// Requires D % 512 == 0, n0 and n1 multiples of 128 and of hd, 128 % hd ==
// 0 (a column block holds whole heads) or hd % 16 == 0 (a block holds 64
// columns of its heads' first halves and their rope partners), 1 <= R <=
// 32, x and nw 16-byte aligned. qk_kind / v_kind: KQ4, KQ4F, KQ6W, KQ6WF, KQ8 or KQ8F
// (common.cuh); *_mins: the f32 mins of a KQ4F weight, else null. bqk /
// bv: f32 biases or both null. ld0 / ld1: the row strides (columns, a
// multiple of 4) of wqk's and wv's packed arrays, 0 where they are n0 /
// n1 (a slot that is a column range of a wider weight). fold: the int8
// folds of the q4 slots (the grid variant's branch; attn_in.cuh).
extern "C" int tkq_attn_in(const void* x, const float* nw, float eps, int qk_kind,
                           const void* qk_qs, const void* qk_scl, const void* qk_mins,
                           int v_kind, const void* v_qs, const void* v_scl, const void* v_mins,
                           const float* cosv, const float* sinv, const float* bqk,
                           const float* bv, void* out0, void* out1, int R, int D, int n0, int n1,
                           int hd, int ld0, int ld1, int fold, void* stream) {
  const auto fused_kind = [](int k) { return is_q4(k) || is_flat(k); };
  if (!fused_kind(qk_kind) || !fused_kind(v_kind)) return (int)cudaErrorInvalidValue;
  AttnInArgs a{static_cast<const __nv_bfloat16*>(x),
               nw,
               eps,
               qk_kind,
               static_cast<const uint8_t*>(qk_qs),
               static_cast<const uint32_t*>(qk_scl),
               static_cast<const uint32_t*>(qk_mins),
               v_kind,
               static_cast<const uint8_t*>(v_qs),
               static_cast<const uint32_t*>(v_scl),
               static_cast<const uint32_t*>(v_mins),
               cosv,
               sinv,
               bqk,
               bv,
               static_cast<__nv_bfloat16*>(out0),
               static_cast<__nv_bfloat16*>(out1),
               R, D, n0, n1, hd, ld0, ld1, fold};
  return (int)launch_attn_in(a, static_cast<cudaStream_t>(stream));
}

// attn_in_plan's split count for the given kinds and widths (0: none fits),
// for the wrapper's and the card tests' check of ops/attn_in.py's mirror.
extern "C" int tkq_attn_in_plan(int qk_kind, int v_kind, int n0, int n1, int D) {
  return attn_in_plan(qk_kind, v_kind, n0, n1, D);
}
