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
// dtype). Those rounding points are what mma.sync.m16n8k16 bf16 with f32
// accumulation computes (int8 codes are exact in bf16), so the tensor cores
// change only the order of the f32 sums. Tiles wholly past q_pos are never
// read.
//
// Bound: memory. A row reads its live K/V slots once: 256 bytes a slot and
// KV head in bf16 at head_dim 64, 136 in int8 with its two scales; the work
// is 4 G D flops a slot (G query heads per KV head: 8 flops a byte of bf16),
// far below the tensor cores' rate.
//
// Head dims 64, 128 and 256 (the gemma family) are instances of one
// template. At 256 a bf16 stage is 66 KB, so the three-stage ring takes
// 198 KB (one block a SM), and a lane keeps a 16 x 256 f32 accumulator
// fragment (128 registers) beside q's fragments; it is the same code.
//
// Design (one block = 4 warps = one (KV head, row, split)):
// - A split over S that does not depend on B: split z of a row walks tiles
//   [z tps, (z + 1) tps) of 64 slots up to the row's last live tile, tps
//   from the shapes and the KV dtype alone (ops/decode_attention.py:
//   decode_plan: about 128 KB of cache a split). A split past its row's
//   last live tile is never run: decode_plan_items lists the live (row,
//   split) pairs on the device from the positions, and a persistent grid
//   (as many blocks as the card holds at once) takes (pair, KV head)
//   units from it through an atomic counter, so a short context costs no
//   blocks for its dead splits and long and short units balance. A row with one live
//   split writes its output directly; a row with more writes each live
//   split's (m, l, unnormalised acc) and decode_combine rescales the live
//   splits, in split order, to their common max. Row b's result is the
//   same bits at any B and whichever block runs it.
// - Loads in flight: a ring of FD_STAGES tiles in shared memory, filled
//   with 16-byte cp.async by every thread; tile t + 1 and t + 2 are in
//   flight while tile t is computed. int8 codes and their scales come in
//   raw and are turned into bf16 in registers as the fragments are built.
// - Tensor cores: decode_attn.cuh's core (mma.sync.m16n8k16 bf16, the
//   softmax on the accumulator fragments). Each warp keeps its own m, l
//   and accumulator over its slots; at the end of the split the four are
//   rescaled to their common max, in warp order, through shared memory.
// - Units overlap: the next unit's first two tiles are loaded while the
//   current unit's last tile is computed, and the ring's stages roll on
//   from unit to unit, so a short context (the serving cell's 1-2 tiles a
//   row) keeps loads in flight across its units.
// decode_attn.cuh also holds the few-row kernel of attn_out.cu (#10) and
// layer.cu (#11) on the same core; tkq_fused_attn below runs it alone.
#include "decode_attn.cuh"

namespace tkq {

struct FlashDecodeArgs {
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
  int tps;      // tiles per split
  int splits;   // splits a row at most: ceil(S / 64 / tps)
  float* part;  // [B, H, splits, D + 2] f32: m, l, then the unnormalised acc
  int* items;   // [B * splits] the work list (decode_plan_items), then its
  int* n_items; // length and the next (item, KV head) unit to hand out
};

// The work list: every live (row, split) pair, rows in order, splits in
// order, as b * splits + z, and their count; a row's live splits are the
// runs of tps tiles up to its last live tile. One block of 1024 threads.
__global__ void __launch_bounds__(1024) decode_plan_items(const FlashDecodeArgs a) {
  __shared__ int wsum[32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) base = 0;
  __syncthreads();
  for (int b0 = 0; b0 < a.B; b0 += 1024) {
    const int b = b0 + tid;
    const int n = b < a.B ? min(a.q_pos[b] / FD_TS, a.S / FD_TS - 1) / a.tps + 1 : 0;
    int x = n;  // inclusive scan within the warp, then across the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int off = base + x - n + (warp > 0 ? wsum[warp - 1] : 0);
    for (int z = 0; z < n; ++z) a.items[off + z] = b * a.splits + z;
    __syncthreads();
    if (tid == 0) base += wsum[31];
    __syncthreads();
  }
  if (tid == 0) a.n_items[0] = base, a.n_items[1] = 0;
}

// One unit of work: KV head hk of work-list item unit / Hkv (row b, split
// z), its tiles [t0, t0 + nt) and its row's cache rows.
struct FdUnit {
  int b, z, hk, qp, t0, nt, n_live;
  const uint8_t *kg, *vg;
  const float *ksg, *vsg;
};

template <bool I8>
__device__ __forceinline__ FdUnit fd_unit(const FlashDecodeArgs& a, int unit) {
  FdUnit u;
  const int item = a.items[unit / a.Hkv];
  u.hk = unit % a.Hkv, u.b = item / a.splits, u.z = item % a.splits;
  u.qp = a.q_pos[u.b];
  const int last_live = min(u.qp / FD_TS, a.S / FD_TS - 1);
  u.t0 = u.z * a.tps;
  u.nt = min(u.t0 + a.tps, last_live + 1) - u.t0;
  u.n_live = last_live / a.tps + 1;
  constexpr int ESZ = I8 ? 1 : 2;
  u.kg = static_cast<const uint8_t*>(a.k) + ((size_t)u.b * a.skb + (size_t)u.hk * a.skh) * ESZ;
  u.vg = static_cast<const uint8_t*>(a.v) + ((size_t)u.b * a.svb + (size_t)u.hk * a.svh) * ESZ;
  u.ksg = I8 ? a.ks + (size_t)u.b * a.sksb + (size_t)u.hk * a.sksh : nullptr;
  u.vsg = I8 ? a.vs + (size_t)u.b * a.svsb + (size_t)u.hk * a.svsh : nullptr;
  return u;
}

// A persistent grid (as many blocks as the card holds at once, so that no
// block is spent on a dead split): each block takes the next unit from an
// atomic counter until the list is done, and loads the next unit's first
// tiles into the ring while it computes the current unit's last. Which
// block runs a unit changes nothing in its result. The ring's stages roll
// on from unit to unit (stage (sb + i) % FD_STAGES holds tile i); the four
// warps' states meet in the stage of the unit's last tile, 32 columns at a
// time. FD_THREADS threads; dynamic smem FdGeom::SMEM. G = H / Hkv <= 16.
template <int D, bool I8>
__global__ void __launch_bounds__(FD_THREADS) decode_attn_mma(const FlashDecodeArgs a) {
  using Gm = FdGeom<D, I8>;
  constexpr int KS = D / 16, NT = D / 8;
  constexpr int AHEAD = TKQ_FD_ABLATE == 2 ? 1 : FD_STAGES - 1;  // tiles a unit starts with
  constexpr int CP = 33;  // floats a row of the combine's 32-column chunk
  extern __shared__ __align__(128) uint8_t fd_smem[];
  __shared__ int unit_s[2];
  const int G = a.H / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t ring = smem_u32(fd_smem);
  const int n_units = a.n_items[0] * a.Hkv;
  auto stage = [&](int i) { return i % FD_STAGES * Gm::STAGE; };
  if (threadIdx.x == 0) unit_s[0] = atomicAdd(a.n_items + 1, 1);
  __syncthreads();
  int unit = unit_s[0], sb = 0;
  bool ahead = false;  // this unit's first tiles are in flight already
  while (unit < n_units) {
    const FdUnit u = fd_unit<I8>(a, unit);
    if (threadIdx.x == 0) unit_s[1] = atomicAdd(a.n_items + 1, 1);  // read after a barrier
    if (!ahead) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (i < u.nt) fd_load<D, I8>(ring + stage(sb + i), u.kg, u.vg, u.ksg, u.vsg, u.t0 + i);
        cp_commit();
      }
    }

    uint32_t qa[KS][4];
    fd_q_frags<D, I8>(qa, a.q + (size_t)u.b * a.sqb + (size_t)u.hk * G * D, G);
    float m[2] = {FD_NEG, FD_NEG}, l[2] = {0.f, 0.f};  // rows g, g + 8
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    int next = n_units;
    FdUnit v{};  // the next unit, decoded while this one runs
    ahead = false;
    for (int i = 0; i < u.nt; ++i) {
      if constexpr (TKQ_FD_ABLATE == 2) {  // no ring: tile i alone in flight, then computed
        if (i > 0) {
          __syncthreads();
          fd_load<D, I8>(ring + stage(sb + i), u.kg, u.vg, u.ksg, u.vsg, u.t0 + i);
          cp_commit();
        }
        cp_wait<0>();
        __syncthreads();
        next = unit_s[1];
      } else {
        cp_wait<FD_STAGES - 2>();
        __syncthreads();  // tile i in every thread's view; tile i - 1 consumed
        if (i == 0) {
          next = unit_s[1];
          if (next < n_units) v = fd_unit<I8>(a, next);
        }
        if (i + AHEAD < u.nt) {
          fd_load<D, I8>(ring + stage(sb + i + AHEAD), u.kg, u.vg, u.ksg, u.vsg,
                         u.t0 + i + AHEAD);
          cp_commit();
        } else if (i == u.nt - 1 && next < n_units) {
          // the next unit's first tiles, into the stages after this unit's
          // last (tiles nt - 3 and nt - 2 of this unit are consumed)
#pragma unroll
          for (int j = 0; j < AHEAD; ++j) {
            if (j < v.nt)
              fd_load<D, I8>(ring + stage(sb + u.nt + j), v.kg, v.vg, v.ksg, v.vsg, v.t0 + j);
            cp_commit();
          }
          ahead = true;
        } else {
          cp_commit();
        }
      }
      fd_tile<D, I8>(ring + stage(sb + i), fd_smem + stage(sb + i), a.scale,
                     (u.t0 + i) * FD_TS, u.qp + 1, qa, m, l, o);
    }
    __syncthreads();  // the last tile is consumed: its stage takes the warps' states

    float* cm = reinterpret_cast<float*>(fd_smem + stage(sb + u.nt - 1));  // m [4][16]
    float* cl = cm + FD_WARPS * 16;                                        // l [4][16]
    float* co = cl + FD_WARPS * 16;  // acc [4][16][CP]: 32 columns at a time
    if (t == 0) {
      cm[warp * 16 + g] = m[0], cm[warp * 16 + g + 8] = m[1];
      cl[warp * 16 + g] = l[0], cl[warp * 16 + g + 8] = l[1];
    }
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
#pragma unroll
      for (int n = 4 * c; n < 4 * c + 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          co[(warp * 16 + g + 8 * (e / 2)) * CP + fd_out_col<I8>(n, t, e) - 32 * c] = o[n][e];
      __syncthreads();
      for (int i = threadIdx.x; i < G * 32; i += FD_THREADS) {
        const int r = i / 32, col = 32 * c + i % 32;
        float M = FD_NEG;
#pragma unroll
        for (int w = 0; w < FD_WARPS; ++w) M = fmaxf(M, cm[w * 16 + r]);
        float L = 0.f, O = 0.f;
#pragma unroll
        for (int w = 0; w < FD_WARPS; ++w) {
          const float wt = expf(cm[w * 16 + r] - M);
          L += cl[w * 16 + r] * wt;
          O += co[(w * 16 + r) * CP + i % 32] * wt;
        }
        const size_t row = (size_t)u.b * a.H + u.hk * G + r;
        if (u.n_live == 1) {
          if (a.out_f32)
            static_cast<float*>(a.out)[row * D + col] = O / L;
          else
            static_cast<__nv_bfloat16*>(a.out)[row * D + col] = __float2bfloat16_rn(O / L);
        } else {
          float* pp = a.part + (row * a.splits + u.z) * (D + 2);
          if (col == 0) pp[0] = M, pp[1] = L;
          pp[2 + col] = O;
        }
      }
      __syncthreads();  // the chunk is read before the next is written (and unit_s[1])
    }
    sb = (sb + u.nt) % FD_STAGES;
    unit = next;
  }
  cp_wait<0>();
}

// The rows with more than one live split: block b takes row b's (query head,
// column) outputs, rescales the live splits' partials to their common max,
// in split order, and writes acc / l in the output's type.
template <int D>
__global__ void __launch_bounds__(256) decode_combine(const FlashDecodeArgs a) {
  const int b = blockIdx.x;
  const int n_live = min(a.q_pos[b] / FD_TS, a.S / FD_TS - 1) / a.tps + 1;
  if (n_live == 1) return;  // written by its split
  for (int i = threadIdx.x; i < a.H * D; i += 256) {
    const size_t bh = (size_t)b * a.H + i / D;
    const int col = i % D;
    const float* pp = a.part + bh * a.splits * (D + 2);
    float M = FD_NEG;
    for (int z = 0; z < n_live; ++z) M = fmaxf(M, pp[z * (D + 2)]);
    float l = 0.f, acc = 0.f;
    for (int z = 0; z < n_live; ++z) {
      const float w = expf(pp[z * (D + 2)] - M);
      l += pp[z * (D + 2) + 1] * w;
      acc += pp[z * (D + 2) + 2 + col] * w;
    }
    const size_t o = bh * D + col;
    if (a.out_f32)
      static_cast<float*>(a.out)[o] = acc / l;
    else
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(acc / l);
  }
}

// The work list, then a persistent grid of as many blocks as the card holds
// at once (occupancy of decode_attn_mma, over the KV heads), then the
// combine where a row may have more than one split.
template <int D, bool I8>
cudaError_t launch_flash_decode(const FlashDecodeArgs& a, cudaStream_t st) {
  constexpr int smem = FdGeom<D, I8>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(decode_attn_mma<D, I8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_attn_mma<D, I8>,
                                                      FD_THREADS, smem);
  if (e != cudaSuccess) return e;
  const int P = max(1, min(a.B * a.splits * a.Hkv, per_sm * sms));
  decode_plan_items<<<1, 1024, 0, st>>>(a);
  decode_attn_mma<D, I8><<<P, FD_THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  decode_combine<D><<<a.B, 256, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tkq

using namespace tkq;

// Requires bf16 q with dense heads (row stride sqb in elements), D in {64,
// 128, 256}, S % 64 == 0, H % Hkv == 0 with H / Hkv <= 16, 16-byte aligned K/V
// rows and (int8) scale rows, 0 <= q_pos[b] < S; tps tiles a split, splits
// = ceil(S / 64 / tps), part: f32 scratch of B * H * splits * (D + 2) floats
// (unused with one split), items: int32 scratch of B * splits + 2 (the work
// list, its length and the counter of handed-out units). Strides are in
// elements. Returns the CUDA error code of the launch (0 on success).
extern "C" int tkq_decode_attn(int kv_i8, int D, const void* q, long long sqb, const void* k,
                               long long skb, long long skh, const void* v, long long svb,
                               long long svh, const float* ks, long long sksb, long long sksh,
                               const float* vs, long long svsb, long long svsh, const int* q_pos,
                               void* out, int out_f32, int B, int H, int Hkv, int S, float scale,
                               int tps, int splits, float* part, int* items, void* stream) {
  const FlashDecodeArgs a{static_cast<const __nv_bfloat16*>(q), sqb, k, skb, skh, v, svb, svh, ks,
                          sksb, sksh, vs, svsb, svsh, q_pos, out, out_f32, B, H, Hkv, S, scale,
                          tps, splits, part, items, items + (size_t)B * splits};
  if (H % Hkv != 0 || H / Hkv > 16 || S % FD_TS != 0 || tps < 1 ||
      splits != (S / FD_TS + tps - 1) / tps || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)(kv_i8 ? launch_flash_decode<64, true>(a, st)
                                  : launch_flash_decode<64, false>(a, st));
  if (D == 128) return (int)(kv_i8 ? launch_flash_decode<128, true>(a, st)
                                   : launch_flash_decode<128, false>(a, st));
  if (D == 256) return (int)(kv_i8 ? launch_flash_decode<256, true>(a, st)
                                   : launch_flash_decode<256, false>(a, st));
  return (int)cudaErrorInvalidValue;
}

// The few-row attention of attn_out (#10) and layer (#11) alone
// (decode_attn.cuh:fused_attn_kernel), for timing and checks: as
// tkq_decode_attn for q and the cache, q_pos int64 [B]; with kn / vn (bf16, row
// strides sknb / svnb, heads dense) it is layer's variant (slots < q_pos
// plus the current token, bf16 KV), else attn_out's (slots <= q_pos); out:
// bf16 [B, H * D]; tps tiles a split, splits = ceil(ceil(S / 64) / tps) <= 8
// (ops/decode_attention.py:fused_attn_plan). Returns the CUDA error code.
extern "C" int tkq_fused_attn(int kv_i8, int D, const void* q, long long sqb, const void* k,
                              long long skb, long long skh, const void* v, long long svb,
                              long long svh, const float* ks, long long sksb, long long sksh,
                              const float* vs, long long svsb, long long svsh,
                              const long long* q_pos,
                              const void* kn, long long sknb, const void* vn, long long svnb,
                              void* out, int B, int H, int Hkv, int S, float scale, int tps,
                              int splits, void* stream) {
  const FusedAttnArgs a{static_cast<const __nv_bfloat16*>(q), sqb, k, skb, skh, v, svb, svh,
                        ks, sksb, sksh, vs, svsb, svsh, q_pos,
                        static_cast<const __nv_bfloat16*>(kn), sknb,
                        static_cast<const __nv_bfloat16*>(vn), svnb,
                        static_cast<__nv_bfloat16*>(out), B, H, Hkv, S, scale, tps, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kn != nullptr ? launch_fused_attn<true>(a, D, kv_i8, st)
                             : launch_fused_attn<false>(a, D, kv_i8, st));
}
