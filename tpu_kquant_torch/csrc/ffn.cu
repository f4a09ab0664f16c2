// The FFN block for decode rows, with o_proj in front (oproj_ffn) and
// without (ffn): one library, since both instantiate the same gate/up and
// GEMV kernels for every kind they take.
//
// oproj_ffn: x2 = bf16(x + attn @ Wo^T); y = x2 + down(a(gate(n(x2))) *
// up(n(x2))) for decode rows (R <= 32), n = rms_norm, a = silu or the exact
// gelu (the gemma family; the `gelu` flag), gate and up rounded to bf16,
// their product rounded to bf16.
//
// Replaces the TPU kernels tpu_kquant/ops/pallas_ffn.py:fused_oproj_ffn,
// manual variant _oproj_ffn_manual_call (kernel _oproj_ffn_manual_kernel)
// and Mosaic-grid variant _oproj_ffn_call (_oproj_ffn_kernel), for the kinds
// its gate takes: wo and w_gateup q4, q6w or q8, w_down q6w or q8, each with
// bf16 pairs or f32 scales (Q4_K_M: wo q6w-sp (the recipe stores
// attn_output as Q6_K), w_gateup q4-sm, w_down q6w-sp; Q8_0: q8 in every
// slot; Q6_K: q6w in every slot).
//
// Bound: memory. At TinyLlama width it reads wo [2048, 2048] (q6w-sp:
// 4.7 MB), w_gateup [11264, 2048] q4-sm (14.4 MB) and w_down [2048, 5632]
// q6w-sp (13.0 MB): 32.1 MB, 9.6 us at 3.35 TB/s; at Q8_0 (q8-sp, 8.5 bits
// a weight) 52.9 MB, 15.8 us.
//
// Design: the norm needs the whole x2 row and down needs the whole
// activation row, and a TPU kernel's sequential grid does not exist here, so
// one source issues the phases as separate launches on the stream:
//   (A) o_proj: split-K GEMV over Wo; its reduce adds the residual x and
//       rounds to bf16 -> x2 [R, dim];
//   (B) gate/up (gate_up.cuh, shared with ffn): a block recomputes
//       rms(x2) per row, stages its K range of the normalised rows,
//       computes its 128 columns j of gate and F + j of up with gemv.cuh's
//       tensor-core core, rounds both to bf16, writes bf16(a(gate) * up)
//       -> act [R, F] (where K is split, its fixed-order reduce does);
//   (C) down: split-K GEMV over Wd on act; its reduce adds x2 -> y.
// Each phase is a launch plus a reduce launch where its K is split (up to
// six launches in all); a persistent single launch with a grid barrier is
// later work. The sequence is gate_up.cuh:launch_oproj_ffn, shared with
// layer.cu and rot.cu.
//
// ffn: y = x + down(bf16(a(bf16(gate(n(x)))) * bf16(up(n(x))))) for
// decode rows (R <= 32), n = rms_norm: the FFN block without o_proj, run
// where the attention width fails oproj_ffn's K % 1024 gate (qwen2: 12 x 128
// = 1536).
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_ffn.py:fused_ffn (_ffn_call,
// kernel body _ffn_kernel), for the kinds its gate takes, on bf16 scale
// pairs or f32 scales: fused w_gateup q4, q6w or q8, w_down q6w or q8 (kind
// codes of common.cuh).
//
// Bound: memory. At Qwen2.5-1.5B width it reads w_gateup [17920, 1536]
// q4-sm (15.8 MB) and w_down [1536, 8960] q6w-sp (15.5 MB): 31.3 MB, 9.3 us
// at 3.35 TB/s; the activations are a few KB.
//
// Design: the TPU kernel walks F in tiles on its sequential grid and carries
// the down sum in VMEM; blocks here run in no order, so the two phases are
// separate launches on the stream, as in oproj_ffn's phases B and C:
//   (B) gate/up (gate_up.cuh): each block owns 128 columns of gate and the
//       matching 128 of up, so a(gate) * up is formed in the block (or
//       in the fixed-order reduce of a K split) and only the bf16
//       activation [R, F] is written;
//   (C) down: gemv.cuh's tensor-core GEMV over w_down on that
//       activation; its fixed-order reduce adds the residual x and rounds to
//       bf16 (deterministic, no atomics).
// Two to four launches in all (B and C add a reduce launch each where
// they split K).
#include "gate_up.cuh"

using namespace tkq;

// x, attn, x2 (scratch), act (scratch), out: bf16; ws: f32 scratch of
// max(splits_o * R * dim, splits_g * R * 2F, splits_d * R * dim) floats.
// *_kind: common.cuh's kind codes (wo and gu: KQ4, KQ6W or KQ8; dn: KQ6W or
// KQ8; each or its F variant); *_scl the sm / sp pairs or f32 scales,
// *_mins the f32 mins of a KQ4F weight (else null).
// cps_* / splits_*: the K split of phases A, B and C. gelu: the
// activation, 0 silu, 1 gelu. round_first: 1 rounds the o_proj result to
// bf16 before adding x (layer.cu's TPU kernel's order), 0 adds in f32 then
// rounds. pdl: programmatic dependent launch of the o_proj GEMV. fold_wo /
// fold_gu: the int8 folds of a q4 wo / w_gateup (launch_oproj_ffn; ws then
// also holds the quantized attention output: ops/ffn.py:fused_ws_floats).
// Requires
// K % 64 == 0, dim % 64 == 0, F % 32 == 0, R <= 32. layer.cu and rot.cu
// call it through the address their wrappers pass, so that they compile
// none of these kernels again.
extern "C" int tkq_oproj_ffn(const void* x, const void* attn, const float* nw, float eps,
                             int wo_kind, const void* wo_qs, const void* wo_scl,
                             const void* wo_mins, int gu_kind, const void* gu_qs,
                             const void* gu_scl, const void* gu_mins, int dn_kind,
                             const void* dn_qs, const void* dn_scl, void* x2, void* act, float* ws,
                             void* out, int R, int dim, int K, int F, int cps_o, int splits_o,
                             int cps_g, int splits_g, int cps_d, int splits_d, int gelu,
                             int round_first, int pdl, int fold_wo, int fold_gu, void* stream) {
  return (int)launch_oproj_ffn(x, attn, nw, eps, wo_kind, wo_qs, wo_scl, wo_mins, gu_kind, gu_qs,
                               gu_scl, gu_mins, dn_kind, dn_qs, dn_scl, x2, act, ws, out, R, dim,
                               K, F, cps_o, splits_o, cps_g, splits_g, cps_d, splits_d,
                               round_first, gelu, static_cast<cudaStream_t>(stream), pdl, fold_wo,
                               fold_gu);
}

// x, act (scratch), out: bf16; ws: f32 scratch of max(splits_g * R * 2F,
// splits_d * R * dim) floats. gu_kind: KQ4, KQ6W or KQ8, or its F variant
// (gu_mins: the f32 mins of a KQ4F weight, else null); dn_kind: KQ6W,
// KQ6WF, KQ8 or KQ8F. cps_g / splits_g, cps_d / splits_d: the K split of
// phases B and C; gelu: the activation, 0 silu, 1 gelu; fold: the int8
// folds of a q4 w_gateup. Requires dim % 64 == 0, F % 32 == 0, R <= 32.
extern "C" int tkq_ffn(const void* x, const float* nw, float eps, int gu_kind, const void* gu_qs,
                       const void* gu_scl, const void* gu_mins, int dn_kind, const void* dn_qs,
                       const void* dn_scl, void* act, float* ws, void* out, int R, int dim, int F,
                       int cps_g, int splits_g, int cps_d, int splits_d, int gelu, int fold,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  GateUpArgs ag{xb, nw, eps, static_cast<const uint8_t*>(gu_qs),
                static_cast<const uint32_t*>(gu_scl), static_cast<const uint32_t*>(gu_mins),
                static_cast<__nv_bfloat16*>(act), R, dim, F, cps_g, ws, gelu, fold};
  cudaError_t e = launch_gate_up(gu_kind, ag, splits_g, st);
  if (e != cudaSuccess) return (int)e;
  GemvArgs ad{act, 0, static_cast<const uint8_t*>(dn_qs), static_cast<const uint32_t*>(dn_scl),
              R, dim, F, cps_d, ws, out, 0, xb, nullptr};
  return (int)launch_gemv_kind(dn_kind, ad, splits_d, st);
}

// The gate/up phase alone (phase B of both entry points): act [R, F] bf16
// from x [R, dim] bf16; ws: f32 scratch of splits_g * R * 2F floats (unused
// with one split); fold: its int8 folds (q4). Timed on its own by
// tools/tile_ab.py; the main path runs it inside tkq_oproj_ffn and tkq_ffn.
extern "C" int tkq_gate_up(const void* x, const float* nw, float eps, int gu_kind,
                           const void* gu_qs, const void* gu_scl, const void* gu_mins, void* act,
                           float* ws, int R, int dim, int F, int cps_g, int splits_g, int gelu,
                           int fold, void* stream) {
  GateUpArgs ag{static_cast<const __nv_bfloat16*>(x), nw, eps, static_cast<const uint8_t*>(gu_qs),
                static_cast<const uint32_t*>(gu_scl), static_cast<const uint32_t*>(gu_mins),
                static_cast<__nv_bfloat16*>(act), R, dim, F, cps_g, ws, gelu, fold};
  return (int)launch_gate_up(gu_kind, ag, splits_g, static_cast<cudaStream_t>(stream));
}
