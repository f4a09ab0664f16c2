// rot: the rotated layer boundary for decode rows (R <= 32): layer i's
// o_proj, residual and FFN block (oproj_ffn's function), then layer i + 1's
// rms_norm, wqk / wv projections, bf16 round and NEOX rope on that output
// (attn_in's function), from one entry point. Returns y and the next layer's
// roped qk and its v.
//
// Replaces the TPU kernel tpu_kquant/ops/attic/pallas_rot.py:
// fused_oproj_ffn_attn_in (_rot_call, kernel _rot_kernel), for the kinds
// its gate takes (oproj_ffn's and attn_in's: q4, q6w or q8 in each slot,
// down q6w or q8), with bf16 pairs (sm / sp) or f32 scales per slot.
//
// Bound: memory. At TinyLlama width on bf16 pairs it reads wo q6w-sp
// (4.7 MB), w_gateup q4-sm (14.4 MB), w_down q6w-sp (13.0 MB) and the next
// layer's wqk q4-sm (2.9 MB) and wv q6w-sp (0.6 MB): 35.6 MB, 10.6 us at
// 3.35 TB/s.
//
// Design: the TPU kernel runs the three parts as phases of one sequential
// grid, so the next layer's projection weights stream behind the FFN's.
// CUDA blocks run in no order, so the phases are launches in order on the
// stream: oproj_ffn's sequence (gate_up.cuh:launch_oproj_ffn: the o_proj
// GEMV whose epilogue adds x -> x2; gate/up on x2 -> act; the down GEMV
// whose epilogue adds x2 -> y), then attn_in's kernel on y with the
// next layer's weights. Four launches, seven where the three split K, from
// one C call: what is saved against the unfused pair is one host call per
// layer. Both parts are ffn.cu's and attn_in.cu's entry points
// (tkq_oproj_ffn, tkq_attn_in), called through the addresses the wrapper
// passes (entries.cuh): their kernels are compiled once, in those libraries.
#include <cuda_runtime.h>

#include "entries.cuh"

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// oproj_ffn / attn_in: the addresses of tkq_oproj_ffn and tkq_attn_in.
// As tkq_oproj_ffn (ffn.cu) for x, attn, the ffn norm nw, wo, w_gateup,
// w_down, the scratch x2, act, ws and the output y [R, dim]; then as
// tkq_attn_in (attn_in.cu) on y with the next layer's norm nw2, wqk2 (kind
// qk_kind) and wv2 (v_kind), cos / sin [R, hd / 2] f32, writing qk2 [R, n0]
// (roped) and v2 [R, n1], bf16; ld0 / ld1 as tkq_attn_in's (phi3's wqkv as
// two slots). gelu: the FFN's activation, 0 silu, 1 gelu.
extern "C" int tkq_rot(OprojFfnEntry oproj_ffn, AttnInEntry attn_in, const void* x,
                       const void* attn, const float* nw, float eps, int wo_kind,
                       const void* wo_qs, const void* wo_scl, const void* wo_mins, int gu_kind,
                       const void* gu_qs, const void* gu_scl, const void* gu_mins, int dn_kind,
                       const void* dn_qs, const void* dn_scl, void* x2, void* act, float* ws,
                       void* y, const float* nw2, int qk_kind, const void* qk_qs,
                       const void* qk_scl, const void* qk_mins, int v_kind, const void* v_qs,
                       const void* v_scl, const void* v_mins, const float* cosv,
                       const float* sinv, void* qk2, void* v2, int R, int dim, int K, int F,
                       int n0, int n1, int hd, int ld0, int ld1, int cps_o, int splits_o,
                       int cps_g, int splits_g, int cps_d, int splits_d, int gelu,
                       void* stream) {
  const int rc = oproj_ffn(x, attn, nw, eps, wo_kind, wo_qs, wo_scl, wo_mins, gu_kind, gu_qs,
                           gu_scl, gu_mins, dn_kind, dn_qs, dn_scl, x2, act, ws, y, R, dim, K, F,
                           cps_o, splits_o, cps_g, splits_g, cps_d, splits_d, gelu, 0, 0, 0, 0,
                           stream);
  if (rc != 0) return rc;
  return attn_in(y, nw2, eps, qk_kind, qk_qs, qk_scl, qk_mins, v_kind, v_qs, v_scl, v_mins, cosv,
                 sinv, nullptr, nullptr, qk2, v2, R, dim, n0, n1, hd, ld0, ld1, 0, stream);
}
