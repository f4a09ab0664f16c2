// ffn: y = x + down(bf16(silu(bf16(gate(n(x)))) * bf16(up(n(x))))) for
// decode rows (R <= 32), n = rms_norm: the FFN block without o_proj, run
// where the attention width fails oproj_ffn's K % 1024 gate (qwen2: 12 x 128
// = 1536).
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_ffn.py:fused_ffn (_ffn_call,
// kernel body _ffn_kernel), for the Q4_K_M layouts on bf16 scale pairs or
// f32 scales: fused w_gateup q4, w_down q6w (kind codes of common.cuh).
//
// Bound: memory. At Qwen2.5-1.5B width it reads w_gateup [17920, 1536]
// q4-sm (15.8 MB) and w_down [1536, 8960] q6w-sp (15.5 MB): 31.3 MB, 9.3 us
// at 3.35 TB/s; the activations are a few KB.
//
// Design: the TPU kernel walks F in tiles on its sequential grid and carries
// the down sum in VMEM; blocks here run in no order, so the two phases are
// separate launches on the stream, as in oproj_ffn.cu's phases B and C:
//   (B) gate/up (gate_up.cuh): each block owns 128 columns of gate and the
//       matching 128 of up, so silu(gate) * up is formed in the block and
//       only the bf16 activation [R, F] is written;
//   (C) down: the split-K GEMV of common.cuh over w_down on that
//       activation; its fixed-order reduce adds the residual x and rounds to
//       bf16 (deterministic, no atomics).
// Three or four launches in all (C adds a reduce launch when it splits K).
#include "gate_up.cuh"

using namespace tkq;

// x, act (scratch), out: bf16; ws: f32 scratch of splits_d * R * dim floats.
// gu_kind: KQ4 or KQ4F (gu_mins: its f32 mins, else null); dn_kind: KQ6W or
// KQ6WF. cps_d / splits_d: the K split of phase C. Requires dim % 64 == 0,
// F % 32 == 0, R <= 32.
extern "C" int tkq_ffn(const void* x, const float* nw, float eps, int gu_kind, const void* gu_qs,
                       const void* gu_scl, const void* gu_mins, int dn_kind, const void* dn_qs,
                       const void* dn_scl, void* act, float* ws, void* out, int R, int dim, int F,
                       int cps_d, int splits_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  GateUpArgs ag{xb, nw, eps, static_cast<const uint8_t*>(gu_qs),
                static_cast<const uint32_t*>(gu_scl), static_cast<const uint32_t*>(gu_mins),
                static_cast<__nv_bfloat16*>(act), R, dim, F};
  cudaError_t e = launch_gate_up(gu_kind, ag, st);
  if (e != cudaSuccess) return (int)e;
  GemvArgs ad{act, 0, static_cast<const uint8_t*>(dn_qs), static_cast<const uint32_t*>(dn_scl),
              R, dim, F, cps_d, ws, out, 0, xb, nullptr};
  return (int)launch_gemv_kind(dn_kind, ad, splits_d, st);
}
