// oproj_ffn: x2 = bf16(x + attn @ Wo^T); y = x2 + down(silu(gate(n(x2))) *
// up(n(x2))) for decode rows (R <= 32), n = rms_norm, gate and up rounded
// to bf16, their product rounded to bf16.
//
// Replaces the TPU kernels tpu_kquant/ops/pallas_ffn.py:fused_oproj_ffn,
// manual variant _oproj_ffn_manual_call (kernel _oproj_ffn_manual_kernel)
// and Mosaic-grid variant _oproj_ffn_call (_oproj_ffn_kernel), for the
// Q4_K_M layouts: wo q4-sm or q6w-sp (the fixture recipe stores
// attn_output as Q6_K), fused w_gateup q4-sm, w_down q6w-sp.
//
// Bound: memory. At TinyLlama width it reads wo [2048, 2048] (q6w-sp:
// 4.7 MB), w_gateup [11264, 2048] q4-sm (14.4 MB) and w_down [2048, 5632]
// q6w-sp (13.0 MB): 32.1 MB, 9.6 us at 3.35 TB/s.
//
// Design: the norm needs the whole x2 row and down needs the whole
// activation row, and a TPU kernel's sequential grid does not exist here, so
// one source issues the phases as separate launches on the stream:
//   (A) o_proj: split-K GEMV over Wo; its reduce adds the residual x and
//       rounds to bf16 -> x2 [R, dim];
//   (B) gate/up (gate_up.cuh, shared with ffn.cu): a block recomputes
//       rms(x2) per row, stages the normalised row, computes its 128 columns
//       j of gate and F + j of up with the GEMV core, rounds both to bf16,
//       writes bf16(silu(gate) * up) -> act [R, F];
//   (C) down: split-K GEMV over Wd on act; its reduce adds x2 -> y.
// A and C are a GEMV launch plus a reduce launch each (five launches in
// all); a persistent single launch with a grid barrier is later work.
#include "gate_up.cuh"

using namespace tkq;

// x, attn, x2 (scratch), act (scratch), out: bf16; ws: f32 scratch of
// max(splits_o * R * dim, splits_d * R * dim) floats. *_kind: common.cuh's
// kind codes (wo: any; gu: KQ4 or KQ4F; dn: KQ6W or KQ6WF); *_scl the sm /
// sp pairs or f32 scales, *_mins the f32 mins of a KQ4F weight (else null).
// cps_* / splits_*: the K split of phases A and C. Requires K % 64 == 0,
// dim % 64 == 0, F % 32 == 0, dim and F multiples of 4, R <= 32.
extern "C" int tkq_oproj_ffn(const void* x, const void* attn, const float* nw, float eps,
                             int wo_kind, const void* wo_qs, const void* wo_scl,
                             const void* wo_mins, int gu_kind, const void* gu_qs,
                             const void* gu_scl, const void* gu_mins, int dn_kind,
                             const void* dn_qs, const void* dn_scl, void* x2, void* act, float* ws,
                             void* out, int R, int dim, int K, int F, int cps_o, int splits_o,
                             int cps_d, int splits_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  GemvArgs ao{attn, 0, static_cast<const uint8_t*>(wo_qs), static_cast<const uint32_t*>(wo_scl),
              R, dim, K, cps_o, ws, x2, 0, xb, static_cast<const uint32_t*>(wo_mins)};
  cudaError_t e = launch_gemv_kind(wo_kind, ao, splits_o, st);
  if (e != cudaSuccess) return (int)e;
  GateUpArgs ag{static_cast<const __nv_bfloat16*>(x2), nw, eps,
                static_cast<const uint8_t*>(gu_qs), static_cast<const uint32_t*>(gu_scl),
                static_cast<const uint32_t*>(gu_mins), static_cast<__nv_bfloat16*>(act), R, dim,
                F};
  e = launch_gate_up(gu_kind, ag, st);
  if (e != cudaSuccess) return (int)e;
  GemvArgs ad{act, 0, static_cast<const uint8_t*>(dn_qs), static_cast<const uint32_t*>(dn_scl),
              R, dim, F, cps_d, ws, out, 0, static_cast<const __nv_bfloat16*>(x2), nullptr};
  return (int)launch_gemv_kind(dn_kind, ad, splits_d, st);
}
