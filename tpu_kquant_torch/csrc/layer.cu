// layer: one whole transformer decode layer for rows <= 4, from one entry
// point: QKV (rms_norm, wqk / wv, bf16 round, NEOX rope), attention over the
// PRE-append bf16 cache (slots < q_pos[b]) plus the current token, o_proj
// with its residual, then the FFN block with its residual. Returns y and the
// current token's roped k and its v, which the caller appends to the cache.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_layer.py:fused_layer
// (_layer_call, kernel _layer_kernel), for its kinds: every weight kmajor
// q4, q6w or q8 (down q6w or q8), with sm pairs (q4) or f32 scales (the
// reference's gate refuses k-pair "sp" scales), chosen per slot at run time.
// Numerics as the TPU kernel's phases: the roped qk and v rounded to bf16
// (k_new / v_new), attention with bf16 p against bf16 cache rows and the
// current token's f32 p against its f32 v, each head's output rounded to
// bf16; x2 = bf16(x + bf16(att @ Wo^T)); gate and up rounded to bf16, their
// silu product rounded to bf16; y = bf16(x2 + act @ Wd^T). The normalised
// rows stay f32 here (the port's attn_in and gate/up phases), where the TPU
// kernel rounds them to bf16 before its matmuls.
//
// Bound: memory. At TinyLlama width on f32 scales a layer reads wqk q4
// (3.5 MB), wv q6w (0.7 MB), wo q6w (5.2 MB), w_gateup q4 (17.3 MB) and
// w_down q6w (14.4 MB): 41.1 MB, 12.3 us at 3.35 TB/s, plus each row's live
// cache slots (4 KV heads x 256 bytes a slot: 0.72 MB at position 700).
//
// Design: the TPU kernel's single sequential grid carries every
// intermediate in VMEM from phase to phase. CUDA blocks run in no order, so
// the phases are launches in order on the stream, each reusing a port
// kernel, with the intermediates in small device buffers (a few KB, in L2):
//   (QKV)   attn_in.cu's entry point -> qk [R, (H + Hkv) hd] roped, v [R, Hkv hd];
//   (ATT)   decode_attn.cuh's few-row attention on #7's tensor-core core,
//           its current-token variant: the cache tiles below q_pos, split
//           by fused_attn_plan (S alone), the splits of a (KV head, row) one
//           thread-block cluster that combines them over distributed shared
//           memory in rank order and then folds in the current k / v read
//           from qk / v -> att [R, H hd] bf16;
//   (OPROJ, FFN) oproj_ffn's phases (ffn.cu's tkq_oproj_ffn): the
//           split-K GEMV over wo on att, whose epilogue rounds to bf16 and
//           adds x (round_first) -> x2; gate/up on x2 -> act [R, F]; the
//           split-K GEMV over w_down on act, whose epilogue adds x2 -> y.
// Five launches (up to seven where both GEMVs split K): one C call per
// layer is what removes the host's per-kernel cost; a persistent single
// launch with grid barriers is later work. The QKV and the o_proj / FFN
// phases are attn_in.cu's and ffn.cu's entry points (tkq_attn_in,
// tkq_oproj_ffn), called through the addresses the wrapper passes
// (entries.cuh): their kernels are compiled once, in those libraries.
#include "decode_attn.cuh"
#include "entries.cuh"

using namespace tkq;

// attn_in / oproj_ffn: the addresses of tkq_attn_in and tkq_oproj_ffn.
// x, y, x2 (scratch), qk, v (outputs), att, act (scratch): bf16. R <= 4,
// D % 512 == 0, hd 64 or 128, H % Hkv == 0 with H / Hkv <= 16, n0 = (H +
// Hkv) hd, n1 = Hkv hd. *_kind: common.cuh's kind codes (KQ4, KQ4F, KQ6WF,
// KQ8F; down KQ6WF or KQ8F), *_mins the f32 mins of a KQ4F weight (else
// null). kc / vc: the layer's bf16 cache [R, Hkv, S, hd] with dense rows
// (strides in elements), q_pos: int64 [R], slot q_pos[b] not yet written.
// ws: f32 scratch of max(splits_o * R * D, splits_g * R * 2F, splits_d * R *
// D) floats; the attention split: fa_splits of tps tiles
// (fused_attn_plan); gelu: the FFN's activation, 0 silu, 1 gelu.
extern "C" int tkq_layer(AttnInEntry attn_in, OprojFfnEntry oproj_ffn, const void* x,
                         const float* anw, const float* fnw, float eps,
                         int qk_kind, const void* qk_qs, const void* qk_scl, const void* qk_mins,
                         int v_kind, const void* v_qs, const void* v_scl, const void* v_mins,
                         int wo_kind, const void* wo_qs, const void* wo_scl, const void* wo_mins,
                         int gu_kind, const void* gu_qs, const void* gu_scl, const void* gu_mins,
                         int dn_kind, const void* dn_qs, const void* dn_scl, const float* cosv,
                         const float* sinv, const void* kc, long long skb, long long skh,
                         const void* vc, long long svb, long long svh, const long long* q_pos,
                         void* qk, void* v, void* att, void* x2, void* act, float* ws, void* y,
                         int R, int D, int H, int Hkv, int hd, int S, int F, float scale,
                         int tps, int fa_splits, int cps_o, int splits_o,
                         int cps_g, int splits_g, int cps_d, int splits_d, int gelu,
                         void* stream) {
  const int n0 = (H + Hkv) * hd, n1 = Hkv * hd;
  int rc = attn_in(x, anw, eps, qk_kind, qk_qs, qk_scl, qk_mins, v_kind, v_qs, v_scl, v_mins,
                   cosv, sinv, nullptr, nullptr, qk, v, R, D, n0, n1, hd, 0, 0, 0, stream);
  if (rc != 0) return rc;

  const auto* qkb = static_cast<const __nv_bfloat16*>(qk);
  const FusedAttnArgs da{qkb, n0, kc, skb, skh, vc, svb, svh, nullptr, 0, 0, nullptr, 0, 0,
                         q_pos, qkb + (size_t)H * hd, n0, static_cast<const __nv_bfloat16*>(v),
                         n1, static_cast<__nv_bfloat16*>(att), R, H, Hkv, S, scale, tps,
                         fa_splits};
  const cudaError_t e = launch_fused_attn<true>(da, hd, 0, static_cast<cudaStream_t>(stream), 1);
  if (e != cudaSuccess) return (int)e;

  return oproj_ffn(x, att, fnw, eps, wo_kind, wo_qs, wo_scl, wo_mins, gu_kind, gu_qs, gu_scl,
                   gu_mins, dn_kind, dn_qs, dn_scl, x2, act, ws, y, R, D, H * hd, F, cps_o,
                   splits_o, cps_g, splits_g, cps_d, splits_d, gelu, 1, 1, 0, 0, stream);
}
