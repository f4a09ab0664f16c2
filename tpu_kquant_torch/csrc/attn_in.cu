// attn_in: rms_norm -> [wqk | wv] -> bf16 round -> (+ f32 bias) -> NEOX
// rope on the qk columns, in one launch, for decode rows (R <= 32).
//
// Replaces the TPU kernels tpu_kquant/ops/pallas_attn_in.py:fused_attn_in,
// manual variant _attn_in_manual_call (kernel _attn_in_manual_kernel) and
// Mosaic-grid variant _attn_in_call (_attn_in_kernel), for the Q4_K_M
// layout: wqk q4, wv q6w, both with bf16 scale pairs (sm / sp) or both with
// f32 scales (scale_dtype='f32': wqk scales + mins, wv scales; the grid
// variant reads these), optional f32 biases (qwen2's q/k/v biases:
// bqk [n0] = [bq | bk], bv [n1]; the epilogue order of _attn_in_kernel,
// pallas_attn_in.py:237-254: round the sum to bf16, add the bias, rope in
// f32, cast).
//
// Bound: memory. At TinyLlama width it reads wqk [2304, 2048] q4-sm (2.95 MB)
// and wv [256, 2048] q6w-sp (0.59 MB): 3.5 MB, 1.1 us at 3.35 TB/s; at
// Qwen2.5-1.5B width wqk [1792, 1536] q4-sm (1.72 MB) and wv [256, 1536]
// q6w-sp (0.44 MB): 2.2 MB, 0.65 us; at Mixtral-8x7B width with f32 scales
// wqk [5120, 4096] q4 (15.7 MB) and wv [1024, 4096] q6w (5.2 MB): 20.9 MB,
// 6.3 us.
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
  const uint8_t* qk_qs;    // q4 [D/2, n0]
  const uint32_t* qk_sm;   // [D/32, n0] sm pairs, or f32 scales
  const uint32_t* qk_mins; // [D/32, n0] f32 mins (f32 layout only)
  const uint8_t* v_qs;     // q6w [D, n1]
  const uint32_t* v_sp;    // [D/32, n1] sp pairs, or [D/16, n1] f32 scales
  const float* cosv;       // [R, hd/2]
  const float* sinv;       // [R, hd/2]
  const float* bqk;        // [n0] f32 bias of the qk columns, or null
  const float* bv;         // [n1] f32 bias of the v columns, or null
  __nv_bfloat16* out0;     // [R, n0] roped qk
  __nv_bfloat16* out1;     // [R, n1] v
  int R, D, n0, n1, hd;
};

// The grid has a few dozen blocks, so one block per SM is enough: the
// minimum of 1 lets ptxas give the GEMV core the registers it needs.
// Without it the bias epilogue changed the R = 1 kernel's register
// allocation and made it 1.6x slower (TinyLlama R=1 on an H100: 22.8
// against 14.5 us, chip_smoke.py phase 3).
// F32: the f32-scale layouts (KQ4F / KQ6WF) instead of the pairs.
template <int RT, bool F32>
__global__ void __launch_bounds__(THREADS, 1) attn_in_kernel(AttnInArgs a) {
  constexpr int QK = F32 ? KQ4F : KQ4, V = F32 ? KQ6WF : KQ6W;
  extern __shared__ __align__(16) float smem[];
  __shared__ float rstd[RT];
  const int tiles0 = (a.n0 + TN - 1) / TN;
  const bool is_qk = blockIdx.x < tiles0;
  const int tile = is_qk ? blockIdx.x : blockIdx.x - tiles0;
  const int N = is_qk ? a.n0 : a.n1;
  const int r0 = blockIdx.z * RT;
  float* xs = smem;
  float* red = smem + RT * a.D;  // the staged row spans D for both kinds

  block_rstd<RT>(rstd, a.x, a.R, a.D, r0, a.eps);
  const int lane = threadIdx.x % 32;
  const int n = tile * TN + lane * 4;
  float acc[RT][4] = {};
  if (is_qk) {
    const int nc = a.D / 2 / CH;
    stage_x<QK, RT>(xs, a.x, 0, a.R, a.D, r0, 0, nc, a.nw, rstd);
    gemv_warp<QK, RT>(acc, a.qk_qs, a.qk_sm, N, a.D, n, n < N, 0, nc, xs, a.D, a.qk_mins);
  } else {
    const int nc = a.D / CH;
    stage_x<V, RT>(xs, a.x, 0, a.R, a.D, r0, 0, nc, a.nw, rstd);
    gemv_warp<V, RT>(acc, a.v_qs, a.v_sp, N, a.D, n, n < N, 0, nc, xs, a.D);
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

template <int RT, bool F32>
cudaError_t launch_attn_in_rt(const AttnInArgs& a, cudaStream_t st) {
  // staged row + warp partials + rounded copy
  const size_t smem = sizeof(float) * (RT * a.D + WARPS * RT * TN + RT * TN);
  cudaError_t e = cudaFuncSetAttribute(attn_in_kernel<RT, F32>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.n0 + TN - 1) / TN + (a.n1 + TN - 1) / TN, 1, (a.R + RT - 1) / RT);
  attn_in_kernel<RT, F32><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool F32>
cudaError_t launch_attn_in(const AttnInArgs& a, cudaStream_t st) {
  switch (pick_rt(a.R)) {
    case 1: return launch_attn_in_rt<1, F32>(a, st);
    case 2: return launch_attn_in_rt<2, F32>(a, st);
    case 4: return launch_attn_in_rt<4, F32>(a, st);
    default: return launch_attn_in_rt<8, F32>(a, st);
  }
}

}  // namespace tkq

using namespace tkq;

// Requires D % 64 == 0, n0 and n1 multiples of 4, 128 % hd == 0 (a column
// tile holds whole heads), R <= 32. bqk / bv: f32 biases or both null.
// qk_mins null: wqk / wv carry bf16 pairs (sm, sp); else f32 scales and
// wqk's f32 mins.
extern "C" int tkq_attn_in(const void* x, const float* nw, float eps, const void* qk_qs,
                           const void* qk_sm, const void* qk_mins, const void* v_qs,
                           const void* v_sp, const float* cosv, const float* sinv,
                           const float* bqk, const float* bv, void* out0, void* out1, int R,
                           int D, int n0, int n1, int hd, void* stream) {
  AttnInArgs a{static_cast<const __nv_bfloat16*>(x),
               nw,
               eps,
               static_cast<const uint8_t*>(qk_qs),
               static_cast<const uint32_t*>(qk_sm),
               static_cast<const uint32_t*>(qk_mins),
               static_cast<const uint8_t*>(v_qs),
               static_cast<const uint32_t*>(v_sp),
               cosv,
               sinv,
               bqk,
               bv,
               static_cast<__nv_bfloat16*>(out0),
               static_cast<__nv_bfloat16*>(out1),
               R, D, n0, n1, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(qk_mins == nullptr ? launch_attn_in<false>(a, st) : launch_attn_in<true>(a, st));
}
