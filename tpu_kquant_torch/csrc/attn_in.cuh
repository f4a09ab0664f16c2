// attn_in's device code (TPU kernels #2 / #3; see attn_in.cu for what it
// replaces, its bound and its design), shared with layer.cu (#11: the
// layer's QKV phase) and rot.cu (#12: the next layer's QKV phase).
#pragma once

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

// Picks the rows per block for R rows (R <= 32) and launches.
inline cudaError_t launch_attn_in(const AttnInArgs& a, cudaStream_t st) {
  switch (pick_rt(a.R)) {
    case 1: return launch_attn_in_rt<1>(a, st);
    case 2: return launch_attn_in_rt<2>(a, st);
    case 4: return launch_attn_in_rt<4>(a, st);
    default: return launch_attn_in_rt<8>(a, st);
  }
}

}  // namespace tkq
