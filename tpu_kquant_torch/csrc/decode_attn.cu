// decode_attn: flash (online-softmax) decode attention, one query token per
// batch row at position q_pos[b], GQA over a bf16 or int8 (per-token f32
// scales) heads-major KV cache; slot j holds position j and is live while
// j <= q_pos[b].
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_attention.py:
// attention_decode_pallas (_attn_call, kernel body _attn_kernel), with its
// numerics: logits s = (bf16 q . bf16 k) * scale in f32, times the K scale
// of their slot for int8 KV; slots past q_pos are -1e30; running max m and
// sum l in f32, l accumulating p before the V scale; p * v_scale rounded to
// bf16 and multiplied by bf16 v into an f32 accumulator; out = acc / l in
// the output's type (bf16, or f32 for an f32 q, as the reference returns q's
// dtype). Tiles wholly past q_pos are never read.
//
// Bound: memory. At the 1024-slot serving cell (TinyLlama: 4 KV heads of 64
// over 32 query heads) a layer reads every live K/V row once: 256 bytes a
// slot and KV head in bf16, 136 in int8 with its two scales; the work is 4 G D
// flops a slot (G = 8 query heads per KV head: 8 flops a byte of bf16),
// below the card's 20 f32 flops a byte of device memory, so plain f32 FMA
// on the CUDA cores keeps up with the memory and no tensor core is needed.
//
// Design: decode_attn.cuh, whose device code this file shares with
// attn_out.cu and layer.cu. One block per (KV head, batch row) and no split
// over S: the kernel is reached only past the plain attention's logits
// budget, i.e. at large B, where the B * Hkv blocks (4096 at the serving
// cell) fill the card.
#include "decode_attn.cuh"

using namespace tkq;

// Requires bf16 q with dense heads (row stride sqb in elements), D in {64,
// 128}, S % 64 == 0, H % Hkv == 0 with H / Hkv <= 16, 16-byte aligned K/V
// rows, 0 <= q_pos[b] < S. Strides are in elements. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int tkq_decode_attn(int kv_i8, int D, const void* q, long long sqb, const void* k,
                               long long skb, long long skh, const void* v, long long svb,
                               long long svh, const float* ks, long long sksb, long long sksh,
                               const float* vs, long long svsb, long long svsh, const int* q_pos,
                               void* out, int out_f32, int B, int H, int Hkv, int S, float scale,
                               void* stream) {
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), sqb, k, skb, skh, v, svb, svh, ks, sksb,
               sksh, vs, svsb, svsh, q_pos, out, out_f32, B, H, Hkv, S, scale};
  return (int)launch_decode_attn(a, D, kv_i8, static_cast<cudaStream_t>(stream));
}
