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
// Design (simple first: no wgmma, TMA or double buffering): one block per
// (KV head, batch row), 4 warps. The grid has B * Hkv blocks (4096 at the
// serving cell), so rows give the parallelism and there is NO split over S:
// the kernel is reached only past the plain attention's logits budget,
// i.e. at large B. The block walks 64-slot K/V tiles up to the row's last
// live tile; each tile is staged in shared memory as bf16 (int8 codes
// convert exactly) from the strided cache view, with no copy of the cache.
// The G query rows that share the KV head are staged once as f32 and read
// as broadcasts. Warp w owns query rows w, w + 4, ... and keeps their m, l
// and accumulator (D / 32 values a lane) in registers. For a row, lane i
// computes the logits of slots i and i + 32 (K rows have an odd pitch in
// 32-bit words, so the lanes' reads hit distinct banks), the warp reduces
// max and sum with shuffles, and each lane accumulates its D / 32 output
// columns over the tile's 64 slots from the warp's bf16 p.
#include "common.cuh"

namespace tkq {

constexpr int DK = 64;  // cache slots per K/V tile
constexpr int DWARPS = 4;
constexpr int DTHREADS = DWARPS * 32;
constexpr float DNEG = -1e30f;

struct DecodeArgs {
  const __nv_bfloat16* q;  // [B, H, D]: row b at b * sqb, heads dense (stride D)
  long long sqb;
  const void* k;  // [B, Hkv, S, D] bf16 or int8, rows of D dense
  long long skb, skh;
  const void* v;
  long long svb, svh;
  const float* ks;  // [B, Hkv, S] f32 (int8 only), S dense
  long long sksb, sksh;
  const float* vs;
  long long svsb, svsh;
  const int* q_pos;  // [B]
  void* out;         // [B, H, D] contiguous, bf16 or f32 (out_f32)
  int out_f32;
  int B, H, Hkv, S;
  float scale;
};

// R: query rows per warp (G <= 4 R)
template <int D, bool I8, int R>
__global__ void __launch_bounds__(DTHREADS) decode_attn_kernel(DecodeArgs a) {
  constexpr int KP = D + 2;  // bf16 pitch of a staged K row: D / 2 + 1 words, odd
  constexpr int NC = D / 32;  // output columns per lane
  __shared__ __align__(16) __nv_bfloat16 kt[DK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[DK * D];
  __shared__ float ksc[DK], vsc[DK];
  __shared__ float pw[DWARPS][DK];  // each warp's bf16-rounded p of the tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int qp = a.q_pos[b];
  const int last_tile = min(qp / DK, a.S / DK - 1);

  // the block's G query rows as f32 (bf16 values), read as broadcasts
  __shared__ __align__(16) float qsm[DWARPS * R * D];
  for (int i = threadIdx.x; i < G * D; i += DTHREADS)
    qsm[i] = __bfloat162float(a.q[b * a.sqb + (long long)hk * G * D + i]);
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = DNEG, l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const size_t kbase = (size_t)b * a.skb + (size_t)hk * a.skh;
  const size_t vbase = (size_t)b * a.svb + (size_t)hk * a.svh;
  for (int t = 0; t <= last_tile; ++t) {
    const int s0 = t * DK;
    __syncthreads();  // the previous tile is consumed
    // stage K (odd word pitch) and V (dense) as bf16: 16 bytes of the cache
    // per thread and step, neighbouring threads on neighbouring bytes
    constexpr int E = I8 ? 16 : 8;  // elements per 16-byte load
    for (int i = threadIdx.x; i < DK * D / E; i += DTHREADS) {
      const int slot = i / (D / E), c = (i % (D / E)) * E;
      const size_t off = (size_t)(s0 + slot) * D + c;
      uint32_t kw[E / 2], vw[E / 2];
      if (I8) {
        const int4 kr = __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(a.k) + kbase + off));
        const int4 vr = __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(a.v) + vbase + off));
        const int8_t* ke = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* ve = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          __nv_bfloat162 kp = __floats2bfloat162_rn((float)ke[2 * j], (float)ke[2 * j + 1]);
          __nv_bfloat162 vp = __floats2bfloat162_rn((float)ve[2 * j], (float)ve[2 * j + 1]);
          kw[j] = *reinterpret_cast<uint32_t*>(&kp);
          vw[j] = *reinterpret_cast<uint32_t*>(&vp);
        }
      } else {
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.k) + kbase + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.v) + vbase + off));
        kw[0] = kr.x, kw[1] = kr.y, kw[2] = kr.z, kw[3] = kr.w;
        vw[0] = vr.x, vw[1] = vr.y, vw[2] = vr.z, vw[3] = vr.w;
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(kt + slot * KP + c);
#pragma unroll
      for (int j = 0; j < E / 2; ++j) kd[j] = kw[j];
      uint4* vd = reinterpret_cast<uint4*>(vt + slot * D + c);
#pragma unroll
      for (int j = 0; j < E / 8; ++j)
        vd[j] = make_uint4(vw[4 * j], vw[4 * j + 1], vw[4 * j + 2], vw[4 * j + 3]);
    }
    if (I8 && threadIdx.x < DK) {
      ksc[threadIdx.x] = a.ks[b * a.sksb + hk * a.sksh + s0 + threadIdx.x];
      vsc[threadIdx.x] = a.vs[b * a.svsb + hk * a.svsh + s0 + threadIdx.x];
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = warp + DWARPS * r;
      if (g >= G) break;  // warp-uniform
      // logits of slots lane and lane + 32
      const float2* qr = reinterpret_cast<const float2*>(qsm + g * D);
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = lane + 32 * h;
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(kt + slot * KP);
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < D / 2; ++w) {
          uint32_t kw = kr[w];
          const float2 kf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&kw));
          const float2 qf = qr[w];
          dot = fmaf(qf.x, kf.x, dot);
          dot = fmaf(qf.y, kf.y, dot);
        }
        float x = dot * a.scale;
        if (I8) x *= ksc[slot];
        s[h] = s0 + slot <= qp ? x : DNEG;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;  // the sum before the V scales
      m[r] = m_new;
      if (I8) p0 *= vsc[lane], p1 *= vsc[lane + 32];
      pw[warp][lane] = round_bf16(p0);
      pw[warp][lane + 32] = round_bf16(p1);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < DK; ++j) {
        const float p = pw[warp][j];
        const uint32_t* vr = reinterpret_cast<const uint32_t*>(vt + j * D);
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          uint32_t w = vr[c * 16 + lane];
          const float2 vf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
          acc[r][c] = fmaf(p, vf.x, acc[r][c]);
          acc[r][c + 1] = fmaf(p, vf.y, acc[r][c + 1]);
        }
      }
      __syncwarp();  // pw is rewritten by the warp's next row
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = warp + DWARPS * r;
    if (g >= G) break;
    const size_t base = ((size_t)b * a.H + hk * G + g) * D;
#pragma unroll
    for (int c = 0; c < NC; c += 2) {
      const int col = c * 32 + lane * 2;
      const float v0 = acc[r][c] / l[r], v1 = acc[r][c + 1] / l[r];
      if (a.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + col) = make_float2(v0, v1);
      } else {
        __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + col) = o;
      }
    }
  }
}

template <int D, bool I8>
cudaError_t launch_decode_attn(const DecodeArgs& a, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  dim3 grid(a.Hkv, a.B);
  if (G <= DWARPS)
    decode_attn_kernel<D, I8, 1><<<grid, DTHREADS, 0, st>>>(a);
  else if (G <= 2 * DWARPS)
    decode_attn_kernel<D, I8, 2><<<grid, DTHREADS, 0, st>>>(a);
  else if (G <= 4 * DWARPS)
    decode_attn_kernel<D, I8, 4><<<grid, DTHREADS, 0, st>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace tkq

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(kv_i8 ? launch_decode_attn<64, true>(a, st) : launch_decode_attn<64, false>(a, st));
  if (D == 128)
    return (int)(kv_i8 ? launch_decode_attn<128, true>(a, st)
                       : launch_decode_attn<128, false>(a, st));
  return (int)cudaErrorInvalidValue;
}
