// prefill: flash (online-softmax) causal GQA attention of T queries at
// positions q_start[b] + t against S cache slots (slot j holds position j),
// over a bf16 or int8 (per-token f32 scales) heads-major KV cache.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_prefill.py:
// attention_prefill_pallas (_prefill_call, kernel body _prefill_kernel),
// with its numerics: QK^T on bf16 operands with f32 accumulation, then
// * scale, then * k_scale[col] for int8 KV; masked logits (kv > q_pos, or
// kv <= q_pos - window with a window) are -1e30 and their p is forced to 0;
// the row sum l is taken before p * v_scale[col]; P is rounded to bf16 for
// PV; l is floored at 1e-20; the output is in q's dtype. No [T, S] logit
// ever reaches device memory. q and the output are bf16 (the wrapper casts
// an f32 q, which qwen2's biases give prefill, and widens the output).
//
// Bound: operations. At TinyLlama's longest prompt (T = S = 2048, 32 query
// heads of 64) the causal pairs need 4 * (T * S / 2) * H * D = 17.2 GFLOP,
// 17.4 us at 989 TFLOP/s bf16, against 18.9 MB of q, k, v and output
// (5.6 us at 3.35 TB/s).
//
// Design (simple first; GQA sharing of K/V tiles, wgmma, TMA and double
// buffering are later work): one block per (query head, 64-query tile,
// batch row), four warps of 16 query rows; the grid's x axis is the head,
// so the heaviest (latest) query tiles of all heads are scheduled first. Each
// warp keeps its Q rows as mma.sync m16n8k16 A fragments in registers. The
// block walks the 64-slot K/V tiles from the window's first tile to the tile
// holding its last query (causal tile skipping); a tile is staged in shared
// memory as bf16 (int8 codes convert exactly), K row-major and V transposed,
// so both products read 32-bit fragment pairs without bank conflicts. A
// warp skips tiles that lie wholly outside its rows' range and masks only
// the edge tiles. S = Q K^T stays in registers; the online max and sum are
// f32 registers reduced across the 4 lanes that share a row, and the S
// accumulators become the A fragments of P V directly.
#include "common.cuh"

namespace tkq {

constexpr int PQ = 64;  // queries per block: 4 warps x 16 rows
constexpr int PK = 64;  // cache slots per K/V tile
constexpr int PTHREADS = 128;
constexpr float NEG_BIG = -1e30f;

struct PrefillArgs {
  const __nv_bfloat16* q;  // [B, T, H, D], strides in elements (d dense)
  long long sqb, sqt, sqh;
  const void* k;  // [B, Hkv, S, D] bf16 or int8, rows of D dense
  long long skb, skh;
  const void* v;
  long long svb, svh;
  const float* ks;  // [B, Hkv, S] f32 (int8 only), S dense
  long long sksb, sksh;
  const float* vs;
  long long svsb, svsh;
  const int* q_start;  // [B]
  __nv_bfloat16* out;  // [B, T, H, D] contiguous
  int B, T, H, Hkv, S;
  float scale;
  int window;  // 0: full causal attention
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// c += A (16x16, row) * B (16x8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage cache slots [s0, s0 + PK) of one (b, kv head): K as kt[slot][d],
// V transposed as vt[d][slot], both bf16. Lane i takes slot i % PK, so
// neighbouring lanes write neighbouring shared-memory words.
template <int D, bool I8>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* kt, __nv_bfloat16* vt, const void* kb,
                                         const void* vb) {
  constexpr int LDK = D + 8, LDV = PK + 8;
  constexpr int E = I8 ? 16 : 8;  // elements per 16-byte load
  for (int i = threadIdx.x; i < PK * D / E; i += PTHREADS) {
    const int slot = i % PK, c = (i / PK) * E;
    const size_t off = (size_t)slot * D + c;
    if (I8) {
      const int4 kr = __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(kb) + off));
      const int4 vr = __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(vb) + off));
      const int8_t* ke = reinterpret_cast<const int8_t*>(&kr);
      const int8_t* ve = reinterpret_cast<const int8_t*>(&vr);
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = pack_bf16((float)ke[2 * j], (float)ke[2 * j + 1]);
      uint4* dst = reinterpret_cast<uint4*>(kt + slot * LDK + c);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
#pragma unroll
      for (int j = 0; j < 16; ++j) vt[(c + j) * LDV + slot] = __float2bfloat16_rn((float)ve[j]);
    } else {
      const uint4 kr =
          __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(kb) + off));
      const uint4 vr =
          __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(vb) + off));
      *reinterpret_cast<uint4*>(kt + slot * LDK + c) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * LDV + slot] = ve[j];
    }
  }
}

template <int D, bool I8>
__global__ void __launch_bounds__(PTHREADS) prefill_kernel(PrefillArgs a) {
  constexpr int LDK = D + 8;  // bf16 pitch of a staged K row
  constexpr int LDV = PK + 8;  // bf16 pitch of a staged, transposed V row
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int ND = D / 8;    // n-tiles of P V
  constexpr int NS = PK / 8;   // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 kt[PK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[D * LDV];
  __shared__ float ksc[PK], vsc[PK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group, lane in group
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * PQ;  // heaviest query tiles first
  const int qs = a.q_start[b];

  // live tiles of the block: from the window's first to the last query's
  const int blk_lo = qs + t0, blk_hi = qs + min(t0 + PQ, a.T) - 1;
  const int hi_tile = min(blk_hi / PK, a.S / PK - 1);
  const int lo_tile = a.window > 0 ? max((blk_lo - (a.window - 1)) / PK, 0) : 0;

  // this warp's 16 rows: positions [w_lo, w_hi] of its rows below T
  const int r0 = t0 + warp * 16;
  const bool live = r0 < a.T;
  const int w_lo = qs + r0, w_hi = qs + min(r0 + 16, a.T) - 1;
  const int qp0 = qs + r0 + g, qp1 = qp0 + 8;  // positions of the lane's two rows

  uint32_t qa[KD][4];
  {
    const long long base = (long long)b * a.sqb + (long long)h * a.sqh;
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (r & 1) ? rb : ra;
        const int col = kk * 16 + t4 * 2 + (r >= 2 ? 8 : 0);
        qa[kk][r] = row < a.T ? *reinterpret_cast<const uint32_t*>(
                                    a.q + base + (long long)row * a.sqt + col)
                              : 0u;
      }
  }

  float o[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  for (int st = lo_tile; st <= hi_tile; ++st) {
    const int s0 = st * PK;
    __syncthreads();  // the previous tile is consumed
    if (I8) {
      stage_kv<D, true>(kt, vt, static_cast<const int8_t*>(a.k) + b * a.skb + hk * a.skh + (size_t)s0 * D,
                        static_cast<const int8_t*>(a.v) + b * a.svb + hk * a.svh + (size_t)s0 * D);
      if (threadIdx.x < PK) {
        ksc[threadIdx.x] = a.ks[b * a.sksb + hk * a.sksh + s0 + threadIdx.x];
        vsc[threadIdx.x] = a.vs[b * a.svsb + hk * a.svsh + s0 + threadIdx.x];
      }
    } else {
      stage_kv<D, false>(
          kt, vt, static_cast<const __nv_bfloat16*>(a.k) + b * a.skb + hk * a.skh + (size_t)s0 * D,
          static_cast<const __nv_bfloat16*>(a.v) + b * a.svb + hk * a.svh + (size_t)s0 * D);
    }
    __syncthreads();

    // warp-uniform: skip a tile wholly after the warp's last query or wholly
    // below every row's window; mask only where the tile crosses an edge
    if (!live || s0 > w_hi) continue;
    if (a.window > 0 && s0 + PK - 1 <= w_lo - a.window) continue;
    const bool edge = s0 + PK - 1 > w_lo || (a.window > 0 && s0 <= w_hi - a.window);

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kr = kt + (nt * 8 + g) * LDK + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, K scales, mask; bit nt*4+e of `dead` marks a masked logit
    uint32_t dead = 0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * a.scale;
        if (I8) x *= ksc[col];
        if (edge) {
          const int qp = e < 2 ? qp0 : qp1, kv = s0 + col;
          if (kv > qp || (a.window > 0 && kv <= qp - a.window)) {
            x = NEG_BIG;
            dead |= 1u << (nt * 4 + e);
          }
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = (dead >> (nt * 4 + e)) & 1u ? 0.f : expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += p;  // the sum before the V scales
        if (I8) p *= vsc[nt * 8 + t4 * 2 + (e & 1)];
        s[nt][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of slots 16kk.. and 16kk+8.. are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        const __nv_bfloat16* vr = vt + (dt * 8 + g) * LDV + kk * 16 + t4 * 2;
        mma_bf16(o[dt], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);  // rows with no live slot divide safely
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= a.T) continue;
    const size_t base = (((size_t)b * a.T + row) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int col = dt * 8 + t4 * 2;
      const float v0 = o[dt][2 * r] / l[r], v1 = o[dt][2 * r + 1] / l[r];
      *reinterpret_cast<uint32_t*>(a.out + base + col) = pack_bf16(v0, v1);
    }
  }
}

template <int D, bool I8>
cudaError_t launch_prefill(const PrefillArgs& a, cudaStream_t st) {
  dim3 grid(a.H, (a.T + PQ - 1) / PQ, a.B);
  prefill_kernel<D, I8><<<grid, PTHREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_prefill_d(int kv_i8, const PrefillArgs& a, cudaStream_t st) {
  return kv_i8 ? launch_prefill<D, true>(a, st) : launch_prefill<D, false>(a, st);
}

}  // namespace tkq

using namespace tkq;

// Requires bf16 q and out, D in {64, 128}, S % 64 == 0, H % Hkv == 0,
// 16-byte aligned K/V rows, q_start[b] >= 0. Strides are in elements. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int tkq_prefill(int kv_i8, int D, const void* q, long long sqb,
                           long long sqt, long long sqh, const void* k, long long skb,
                           long long skh, const void* v, long long svb, long long svh,
                           const float* ks, long long sksb, long long sksh, const float* vs,
                           long long svsb, long long svsh, const int* q_start, void* out, int B,
                           int T, int H, int Hkv, int S, float scale, int window, void* stream) {
  PrefillArgs a{static_cast<const __nv_bfloat16*>(q), sqb, sqt, sqh, k, skb, skh, v, svb, svh,
                ks, sksb, sksh, vs, svsb, svsh, q_start, static_cast<__nv_bfloat16*>(out),
                B, T, H, Hkv, S, scale, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_prefill_d<64>(kv_i8, a, st);
  if (D == 128) return (int)launch_prefill_d<128>(kv_i8, a, st);
  return (int)cudaErrorInvalidValue;
}
