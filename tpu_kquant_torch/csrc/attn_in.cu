// attn_in: rms_norm -> [wqk | wv] -> bf16 round -> (+ f32 bias) -> NEOX
// rope on the qk columns, in one launch, for decode rows (R <= 32).
//
// Replaces the TPU kernels tpu_kquant/ops/pallas_attn_in.py:fused_attn_in,
// manual variant _attn_in_manual_call (kernel _attn_in_manual_kernel) and
// Mosaic-grid variant _attn_in_call (_attn_in_kernel), for the kinds the
// reference's attn_in_supported takes in either slot: q4, q6w or q8
// (wqk q4 + wv q6w at Q4_K_M, both q8 at Q8_0, both q6w at Q6_K, both q4 at
// Q4_K_S), each with bf16 scale pairs (sm / sp) or f32 scales
// (scale_dtype='f32'; the grid variant reads these), chosen per slot at run
// time; optional f32 biases (qwen2's q/k/v biases:
// bqk [n0] = [bq | bk], bv [n1]; the epilogue order of _attn_in_kernel,
// pallas_attn_in.py:237-254: round the sum to bf16, add the bias, rope in
// f32, cast).
//
// Bound: memory. At TinyLlama width it reads wqk [2304, 2048] q4-sm (2.95 MB)
// and wv [256, 2048] q6w-sp (0.59 MB): 3.5 MB, 1.1 us at 3.35 TB/s; at
// Qwen2.5-1.5B width wqk [1792, 1536] q4-sm (1.72 MB) and wv [256, 1536]
// q6w-sp (0.44 MB): 2.2 MB, 0.65 us; at Mixtral-8x7B width with f32 scales
// wqk [5120, 4096] q4 (15.7 MB) and wv [1024, 4096] q6w (5.2 MB): 20.9 MB,
// 6.3 us; TinyLlama at Q8_0 (both q8-sp, 8.5 bits a weight) 5.4 MB, 1.6 us.
//
// Design: the norm needs the whole row and the rope pairs columns i and
// i + head_dim/2, so nothing is split along K here. Every block recomputes
// rstd over the full row (4 KB of bf16 per row, from L2), stages the
// normalised row in shared memory in f32 (the norm weight is applied
// without bf16 rounding, as the reference kernel does), and owns 128 output
// columns, a whole number of heads: after the GEMV core and the warp
// reduction the block rounds to bf16 and applies the half rotation in
// shared memory. Blocks past the qk tiles compute wv's columns, unroped.
// Grid: (ceil(n0/128) + ceil(n1/128), 1, ceil(R / RT)).
#include "common.cuh"

namespace tkq {

struct AttnInArgs {
  const __nv_bfloat16* x;  // [R, D]
  const float* nw;         // [D]
  float eps;
  int qk_kind;             // common.cuh kind code of wqk: KQ4, KQ6W, KQ8 or an F variant
  const uint8_t* qk_qs;    // codes of wqk [.., n0]
  const uint32_t* qk_scl;  // sm / sp pairs, or f32 scales
  const uint32_t* qk_mins; // f32 mins (KQ4F only), else null
  int v_kind;              // the same for wv [.., n1]
  const uint8_t* v_qs;
  const uint32_t* v_scl;
  const uint32_t* v_mins;
  const float* cosv;       // [R, hd/2]
  const float* sinv;       // [R, hd/2]
  const float* bqk;        // [n0] f32 bias of the qk columns, or null
  const float* bv;         // [n1] f32 bias of the v columns, or null
  __nv_bfloat16* out0;     // [R, n0] roped qk
  __nv_bfloat16* out1;     // [R, n1] v
  int R, D, n0, n1, hd;
};

// Stage the normalised rows for a weight of kind KIND and run the block's
// share of its GEMV over the whole of D.
template <int KIND, int RT>
__device__ __forceinline__ void attn_in_gemv(float (&acc)[RT][4], float* xs, const AttnInArgs& a,
                                             const uint8_t* qs, const uint32_t* scl,
                                             const uint32_t* mins, int N, int n, int r0,
                                             const float* rstd) {
  const int nc = n_chunks_of<KIND>(a.D);
  stage_x<KIND, RT>(xs, a.x, 0, a.R, a.D, r0, 0, nc, a.nw, rstd);
  gemv_warp<KIND, RT>(acc, qs, scl, N, a.D, n, n < N, 0, nc, xs, a.D, mins);
}

// The grid has a few dozen blocks, so one block per SM is enough: the
// minimum of 1 lets ptxas give the GEMV core the registers it needs.
// Without it the bias epilogue changed the R = 1 kernel's register
// allocation and made it 1.6x slower (TinyLlama R=1 on an H100: 22.8
// against 14.5 us, chip_smoke.py phase 3). The slot's kind is uniform over a
// block, so the switch does not diverge.
template <int RT>
__global__ void __launch_bounds__(THREADS, 1) attn_in_kernel(AttnInArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float rstd[RT];
  const int tiles0 = (a.n0 + TN - 1) / TN;
  const bool is_qk = blockIdx.x < tiles0;
  const int tile = is_qk ? blockIdx.x : blockIdx.x - tiles0;
  const int N = is_qk ? a.n0 : a.n1;
  const int r0 = blockIdx.z * RT;
  float* xs = smem;
  float* red = smem + RT * a.D;  // the staged row spans D for every kind

  block_rstd<RT>(rstd, a.x, a.R, a.D, r0, a.eps);
  const int lane = threadIdx.x % 32;
  const int n = tile * TN + lane * 4;
  const uint8_t* qs = is_qk ? a.qk_qs : a.v_qs;
  const uint32_t* scl = is_qk ? a.qk_scl : a.v_scl;
  const uint32_t* mins = is_qk ? a.qk_mins : a.v_mins;
  float acc[RT][4] = {};
  switch (is_qk ? a.qk_kind : a.v_kind) {
    case KQ4: attn_in_gemv<KQ4, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
    case KQ4F: attn_in_gemv<KQ4F, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
    case KQ6W: attn_in_gemv<KQ6W, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
    case KQ6WF: attn_in_gemv<KQ6WF, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
    case KQ8: attn_in_gemv<KQ8, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
    default: attn_in_gemv<KQ8F, RT>(acc, xs, a, qs, scl, mins, N, n, r0, rstd); break;
  }
  block_reduce<RT>(red, acc);
  // red[0 .. RT*TN) holds the f32 sums; round to bf16 as the unfused path
  // does before rope, then add the bias in f32
  const float* bias = is_qk ? a.bqk : a.bv;
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    const int col = tile * TN + i % TN;
    red[RT * TN + i] = round_bf16(red[i]) + (bias != nullptr && col < N ? bias[col] : 0.f);
  }
  __syncthreads();
  const float* y = red + RT * TN;
  const int half = a.hd / 2;
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    const int r = r0 + i / TN, tc = i % TN, col = tile * TN + tc;
    if (r >= a.R || col >= N) continue;
    if (!is_qk) {
      a.out1[(size_t)r * N + col] = __float2bfloat16_rn(y[i]);
      continue;
    }
    const int d = col % a.hd;  // position inside the head
    const int f = d < half ? d : d - half;
    const float c = a.cosv[(size_t)r * half + f], s = a.sinv[(size_t)r * half + f];
    const float v = d < half ? y[i] * c - y[i + half] * s : y[i] * c + y[i - half] * s;
    a.out0[(size_t)r * N + col] = __float2bfloat16_rn(v);
  }
}

template <int RT>
cudaError_t launch_attn_in_rt(const AttnInArgs& a, cudaStream_t st) {
  // staged row + warp partials + rounded copy
  const size_t smem = sizeof(float) * (RT * a.D + WARPS * RT * TN + RT * TN);
  cudaError_t e = cudaFuncSetAttribute(attn_in_kernel<RT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.n0 + TN - 1) / TN + (a.n1 + TN - 1) / TN, 1, (a.R + RT - 1) / RT);
  attn_in_kernel<RT><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tkq

using namespace tkq;

// Requires D % 64 == 0, n0 and n1 multiples of 4, 128 % hd == 0 (a column
// tile holds whole heads), R <= 32. qk_kind / v_kind: KQ4, KQ4F, KQ6W,
// KQ6WF, KQ8 or KQ8F (common.cuh); *_mins: the f32 mins of a KQ4F weight,
// else null. bqk / bv: f32 biases or both null.
extern "C" int tkq_attn_in(const void* x, const float* nw, float eps, int qk_kind,
                           const void* qk_qs, const void* qk_scl, const void* qk_mins,
                           int v_kind, const void* v_qs, const void* v_scl, const void* v_mins,
                           const float* cosv, const float* sinv, const float* bqk,
                           const float* bv, void* out0, void* out1, int R, int D, int n0, int n1,
                           int hd, void* stream) {
  const auto fused_kind = [](int k) { return is_q4(k) || is_flat(k); };
  if (!fused_kind(qk_kind) || !fused_kind(v_kind)) return (int)cudaErrorInvalidValue;
  AttnInArgs a{static_cast<const __nv_bfloat16*>(x),
               nw,
               eps,
               qk_kind,
               static_cast<const uint8_t*>(qk_qs),
               static_cast<const uint32_t*>(qk_scl),
               static_cast<const uint32_t*>(qk_mins),
               v_kind,
               static_cast<const uint8_t*>(v_qs),
               static_cast<const uint32_t*>(v_scl),
               static_cast<const uint32_t*>(v_mins),
               cosv,
               sinv,
               bqk,
               bv,
               static_cast<__nv_bfloat16*>(out0),
               static_cast<__nv_bfloat16*>(out1),
               R, D, n0, n1, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_rt(R)) {
    case 1: return (int)launch_attn_in_rt<1>(a, st);
    case 2: return (int)launch_attn_in_rt<2>(a, st);
    case 4: return (int)launch_attn_in_rt<4>(a, st);
    default: return (int)launch_attn_in_rt<8>(a, st);
  }
}
