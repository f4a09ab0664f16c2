// attn_out: y = x + bf16(o_proj(flash_attention(q, K/V))) for one decode
// token per batch row (rows <= 16): attention over a bf16 or int8 (f32
// per-token scales) heads-major cache whose slot j is live while j <=
// q_pos[b], each head's normalised output rounded to bf16, then the o_proj
// GEMV over wo [dim, H * D] (q4, q6w or q8 with sm pairs or f32 scales),
// rounded to bf16 and added to the residual x.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_attn_out.py:fused_attn_out
// (_attn_out_call, kernel _attn_out_kernel). That kernel pairs KV heads hp
// and hp + Hkv/2 so that a folded q4 wo streams once through VMEM, parks
// the heads' outputs in a bf16 scratch (:325) and contracts each pair's
// chunk of wo at the pair's end. Here the GEMV core reads every packed byte
// of wo exactly once by itself, so no head pairing is needed, and the bf16
// scratch is a [B, H * D] tensor in device memory (2 B H D bytes, in L2).
//
// Bound: memory. At TinyLlama width (32 / 4 heads of 64, dim 2048) it reads
// wo (q6w with f32 scales: 5.2 MB; q4-sm: 2.6 MB) and every live K/V row
// once (256 bytes a slot and KV head in bf16): at B = 1 and position 700
// 0.72 MB of cache, so wo dominates: about 1.8 us at 3.35 TB/s.
//
// Design: two phases, launched in order on the stream from this one entry
// point (CUDA blocks run in no order, so the TPU kernel's in-grid handoff
// becomes a launch boundary):
//   (A) decode_attn.cuh's few-row attention on #7's tensor-core core, its
//       cache-only variant (with its int8 branch): the splits of each (KV
//       head, row) one thread-block cluster that combines them over
//       distributed shared memory in rank order and writes the bf16 head
//       outputs att [B, H * D]; the split from ops/decode_attention.py:
//       fused_attn_plan (S alone, never B or the positions);
//   (B) gemv.cuh's tensor-core GEMV over wo on att, whose epilogue rounds
//       the o_proj sum to bf16 and adds x (GemvArgs.res, round_first); a
//       fixed-order reduce launch follows where K is split.
#include "decode_attn.cuh"
#include "gemv.cuh"

using namespace tkq;

// Attention (phase A): as tkq_fused_attn (decode_attn.cu) without kn / vn:
// bf16 q (dense heads, row stride sqb), D 64 or 128, S % 64 == 0, H / Hkv <=
// 16; att: bf16 scratch [B, H * D]; splits of tps tiles (fused_attn_plan).
// o_proj (phase B): x, out bf16 [B, dim]; wo_kind a common.cuh kind code
// (KQ4, KQ4F, KQ6WF, KQ8F; the gate refuses the k-pair layouts), wo_mins the
// f32 mins of a KQ4F weight (else null); ws: f32 scratch of splits * B *
// dim floats; cps / splits: the K split.
extern "C" int tkq_attn_out(int kv_i8, int D, const void* q, long long sqb, const void* k,
                            long long skb, long long skh, const void* v, long long svb,
                            long long svh, const float* ks, long long sksb, long long sksh,
                            const float* vs, long long svsb, long long svsh,
                            const long long* q_pos, void* att, int B, int H, int Hkv, int S, float scale, int tps,
                            int fa_splits, const void* x, int wo_kind, const void* wo_qs,
                            const void* wo_scl, const void* wo_mins, float* ws, void* out,
                            int dim, int cps, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FusedAttnArgs a{static_cast<const __nv_bfloat16*>(q), sqb, k, skb, skh, v, svb, svh,
                        ks, sksb, sksh, vs, svsb, svsh, q_pos, nullptr, 0, nullptr, 0,
                        static_cast<__nv_bfloat16*>(att), B, H, Hkv, S, scale, tps,
                        fa_splits};
  cudaError_t e = launch_fused_attn<false>(a, D, kv_i8, st);
  if (e != cudaSuccess) return (int)e;
  GemvArgs g{att, 0, static_cast<const uint8_t*>(wo_qs), static_cast<const uint32_t*>(wo_scl),
             B, dim, H * D, cps, ws, out, 0, static_cast<const __nv_bfloat16*>(x),
             static_cast<const uint32_t*>(wo_mins)};
  g.round_first = 1;
  g.pdl = 1;  // its first chunk loads while phase A runs
  return (int)launch_gemv_kind(wo_kind, g, splits, st);
}
