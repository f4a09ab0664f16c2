// Flash (online-softmax) decode attention on CUDA cores, one query token per
// batch row: the attention phase of attn_out.cu (#10), which runs it before
// its o_proj, and of layer.cu (#11), which runs its current-token variant
// (SELF) between the layer's QKV and o_proj phases. (The standalone flash
// decode, #7, is decode_attn.cu's tensor-core kernel; these two
// keep this one, with its few-row splits from attn_splits.)
//
// Numerics of tpu_kquant/ops/pallas_attention.py:_attn_kernel: logits s =
// (bf16 q . bf16 k) * scale in f32, times the K scale of their slot for int8
// KV; masked slots are -1e30; running max m and sum l in f32, l accumulating
// p before the V scale; p * v_scale rounded to bf16 and multiplied by bf16 v
// into an f32 accumulator; out = acc / l in the output's type (bf16, or f32
// for an f32 q, as the reference returns q's dtype). Tiles wholly past the
// last live slot are never read.
//
// Masks: slot j is live while j <= q_pos[b] (the cache already holds the
// current token: #7 and #10), or, with SELF, while j < q_pos[b]: the cache
// holds only earlier tokens, slot q_pos has not been written, and the
// current token's roped k and its v are read from the QKV phase's outputs
// (kn, vn) and folded into the online softmax after the last tile, never from
// the cache (tpu_kquant/ops/pallas_layer.py:_layer_kernel, phase ATT: its
// logit is the f32 product of the bf16 q and k, its p stays f32 against
// the f32 v). Row b with q_pos 0 attends only the current token.
//
// Design (simple first: no wgmma, TMA or double buffering): one block per
// (KV head, batch row, split), 4 warps. Without a split a block walks the
// 64-slot K/V tiles up to its row's last live tile. With splits (#10 and
// #11 at a few rows, where Hkv = 4 blocks a row would walk the cache
// alone) split z walks tiles [z tps,
// (z + 1) tps) of them and writes its running max, sum and unnormalised
// accumulator to a partial buffer, and a combine launch rescales the
// partials to their common max and divides; split 0 folds the current token
// in. Each tile is staged in shared memory as bf16 (int8 codes convert
// exactly) from the strided cache view, with no copy of the cache, and
// slots past S (a cache whose S is not a multiple of 64, SELF only) are
// staged as zeros. The G query rows that share the KV head are staged once
// as f32 and read as broadcasts. Warp w owns query rows w, w + 4, ... and
// keeps their m, l and accumulator (D / 32 values a lane) in registers. For
// a row, lane i computes the logits of slots i and i + 32 (K rows have an
// odd pitch in 32-bit words, so the lanes' reads hit distinct banks), the
// warp reduces max and sum with shuffles, and each lane accumulates its
// D / 32 output columns over the tile's 64 slots from the warp's bf16 p.
// Lane i's output columns are 64 j + 2 i and 64 j + 2 i + 1.
#pragma once

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
  // SELF only: the current token's roped k [B, Hkv, D] (row b at b * snb,
  // heads dense) and v (row b at b * svnb), bf16
  const __nv_bfloat16* kn = nullptr;
  long long sknb = 0;
  const __nv_bfloat16* vn = nullptr;
  long long svnb = 0;
  // splits over S (gridDim.z > 1): tiles per split, and the partials
  // [B, H, splits, D + 2] f32 (m, l, then the unnormalised accumulator)
  int tps = 0;
  float* part = nullptr;
};

// R: query rows per warp (G <= 4 R). SELF: live slots j < q_pos plus the
// current token (header comment); int8 KV is not taken with SELF.
template <int D, bool I8, int R, bool SELF>
__global__ void __launch_bounds__(DTHREADS) decode_attn_kernel(DecodeArgs a) {
  static_assert(!(SELF && I8), "the current-token variant reads a bf16 cache");
  constexpr int KP = D + 2;  // bf16 pitch of a staged K row: D / 2 + 1 words, odd
  constexpr int NC = D / 32;  // output columns per lane
  __shared__ __align__(16) __nv_bfloat16 kt[DK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[DK * D];
  __shared__ float ksc[DK], vsc[DK];
  __shared__ float pw[DWARPS][DK];  // each warp's bf16-rounded p of the tile
  __shared__ float kself[SELF ? D : 1], vself[SELF ? D : 1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const bool split = gridDim.z > 1;
  const int G = a.H / a.Hkv;
  const int qp = a.q_pos[b];
  const int n_tiles = (a.S + DK - 1) / DK;
  // the last tile holding a live slot (-1: none), then this split's range
  const int last_live = SELF ? (qp > 0 ? min((qp - 1) / DK, n_tiles - 1) : -1)
                             : min(qp / DK, n_tiles - 1);
  const int first_tile = split ? z * a.tps : 0;
  const int last_tile = split ? min(last_live, first_tile + a.tps - 1) : last_live;

  // the block's G query rows as f32 (bf16 values), read as broadcasts
  __shared__ __align__(16) float qsm[DWARPS * R * D];
  for (int i = threadIdx.x; i < G * D; i += DTHREADS)
    qsm[i] = __bfloat162float(a.q[b * a.sqb + (long long)hk * G * D + i]);
  if constexpr (SELF) {
    for (int i = threadIdx.x; i < D; i += DTHREADS) {
      kself[i] = __bfloat162float(a.kn[b * a.sknb + (long long)hk * D + i]);
      vself[i] = __bfloat162float(a.vn[b * a.svnb + (long long)hk * D + i]);
    }
  }
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = DNEG, l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const size_t kbase = (size_t)b * a.skb + (size_t)hk * a.skh;
  const size_t vbase = (size_t)b * a.svb + (size_t)hk * a.svh;
  for (int t = first_tile; t <= last_tile; ++t) {
    const int s0 = t * DK;
    __syncthreads();  // the previous tile is consumed
    // stage K (odd word pitch) and V (dense) as bf16: 16 bytes of the cache
    // per thread and step, neighbouring threads on neighbouring bytes
    constexpr int E = I8 ? 16 : 8;  // elements per 16-byte load
    for (int i = threadIdx.x; i < DK * D / E; i += DTHREADS) {
      const int slot = i / (D / E), c = (i % (D / E)) * E;
      const size_t off = (size_t)(s0 + slot) * D + c;
      uint32_t kw[E / 2], vw[E / 2];
      if (s0 + slot >= a.S) {  // past the cache (SELF with S % 64 != 0): zeros
#pragma unroll
        for (int j = 0; j < E / 2; ++j) kw[j] = vw[j] = 0u;
      } else if (I8) {
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
        const bool live = SELF ? s0 + slot < qp : s0 + slot <= qp;
        s[h] = live ? x : DNEG;
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

  if (SELF && z == 0) {
    __syncthreads();  // kself / vself staged (also when no tile was walked)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = warp + DWARPS * r;
      if (g >= G) break;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(qsm[g * D + d], kself[d], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float s = dot * a.scale;
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[r][c] = acc[r][c] * alpha + p * vself[(c & ~1) * 32 + 2 * lane + (c & 1)];
    }
  }

  if (split) {  // this split's m, l and unnormalised accumulator
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = warp + DWARPS * r;
      if (g >= G) break;
      float* pp = a.part + (((size_t)b * a.H + hk * G + g) * gridDim.z + z) * (D + 2);
      if (lane == 0) pp[0] = m[r], pp[1] = l[r];
#pragma unroll
      for (int c = 0; c < NC; c += 2)
        *reinterpret_cast<float2*>(pp + 2 + c * 32 + lane * 2) = make_float2(acc[r][c],
                                                                              acc[r][c + 1]);
    }
    return;
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

// The combine launch after a split: one block of D threads per (row, query
// head) rescales its splits' partials to their common max M (a split with
// no live slot has m = -1e30 and l = 0: its weight exp(m - M) is 0) and
// writes acc / l in the output's type.
template <int D>
__global__ void __launch_bounds__(D) decode_attn_combine(DecodeArgs a, int splits) {
  const size_t bh = blockIdx.x;
  const float* pp = a.part + bh * splits * (D + 2);
  float M = DNEG;
  for (int z = 0; z < splits; ++z) M = fmaxf(M, pp[z * (D + 2)]);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float w = expf(pp[z * (D + 2)] - M);
    l += pp[z * (D + 2) + 1] * w;
    acc += pp[z * (D + 2) + 2 + threadIdx.x] * w;
  }
  const size_t o = bh * D + threadIdx.x;
  if (a.out_f32)
    static_cast<float*>(a.out)[o] = acc / l;
  else
    static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(acc / l);
}

// splits: 1 (one pass), or the number of splits of a.tps tiles each, whose
// partials go to a.part [B, H, splits, D + 2] before the combine launch.
template <int D, bool I8, bool SELF>
cudaError_t launch_decode_attn_d(const DecodeArgs& a, int splits, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  if (splits > 1 && (a.tps < 1 || a.part == nullptr)) return cudaErrorInvalidValue;
  dim3 grid(a.Hkv, a.B, splits);
  if (G <= DWARPS)
    decode_attn_kernel<D, I8, 1, SELF><<<grid, DTHREADS, 0, st>>>(a);
  else if (G <= 2 * DWARPS)
    decode_attn_kernel<D, I8, 2, SELF><<<grid, DTHREADS, 0, st>>>(a);
  else if (G <= 4 * DWARPS)
    decode_attn_kernel<D, I8, 4, SELF><<<grid, DTHREADS, 0, st>>>(a);
  else
    return cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  decode_attn_combine<D><<<a.B * a.H, D, 0, st>>>(a, splits);
  return cudaGetLastError();
}

// The cache-only kernel (#7, #10): D 64 or 128, bf16 or int8 KV.
inline cudaError_t launch_decode_attn(const DecodeArgs& a, int D, int kv_i8, cudaStream_t st,
                                     int splits = 1) {
  if (D == 64)
    return kv_i8 ? launch_decode_attn_d<64, true, false>(a, splits, st)
                 : launch_decode_attn_d<64, false, false>(a, splits, st);
  if (D == 128)
    return kv_i8 ? launch_decode_attn_d<128, true, false>(a, splits, st)
                 : launch_decode_attn_d<128, false, false>(a, splits, st);
  return cudaErrorInvalidValue;
}

// The current-token kernel (#11): D 64 or 128, bf16 KV.
inline cudaError_t launch_decode_attn_self(const DecodeArgs& a, int D, int splits,
                                          cudaStream_t st) {
  if (D == 64) return launch_decode_attn_d<64, false, true>(a, splits, st);
  if (D == 128) return launch_decode_attn_d<128, false, true>(a, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace tkq
