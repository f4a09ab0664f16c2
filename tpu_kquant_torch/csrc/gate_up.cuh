// gate/up phase shared by the FFN kernels (ffn.cu: oproj_ffn and ffn):
// act = bf16(silu(bf16(gate(n(x)))) * bf16(up(n(x)))), n = rms_norm, for
// decode rows (R <= 32), over the fused w_gateup [2F, dim] (gate columns
// 0..F-1, up columns F..2F-1) of kind q4, q6w or q8, each with bf16 pairs or
// f32 scales (KQ4, KQ4F, KQ6W, KQ6WF, KQ8, KQ8F of common.cuh).
//
// A block recomputes rms(x) for its rows, stages the normalised rows in
// shared memory in f32 (the norm weight applied without bf16 rounding, as
// the reference kernels do), and computes its 128 columns j of gate and
// F + j of up with the GEMV core of common.cuh, so the two outputs that the
// activation pairs meet in one block and never reach device memory.
// Grid: (ceil(F / 128), 1, ceil(R / RT)).
#pragma once

#include "common.cuh"
#include "gemv.cuh"

namespace tkq {

struct GateUpArgs {
  const __nv_bfloat16* x;   // [R, dim] the rows to normalise
  const float* nw;          // [dim]
  float eps;
  const uint8_t* qs;        // codes [dim/2, 2F] (q4) or [dim, 2F] (q6w, q8)
  const uint32_t* scl;      // sm / sp pairs or f32 scales
  const uint32_t* mins;     // f32 mins (KQ4F only)
  __nv_bfloat16* act;       // [R, F]
  int R, dim, F;
};

template <int KIND, int RT>
__global__ void __launch_bounds__(THREADS) gate_up_kernel(GateUpArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float rstd[RT];
  const int r0 = blockIdx.z * RT;
  float* xs = smem;
  float* red_g = smem + RT * a.dim;
  float* red_u = red_g + WARPS * RT * TN;
  const int N = 2 * a.F;
  const int nc = n_chunks_of<KIND>(a.dim);
  block_rstd<RT>(rstd, a.x, a.R, a.dim, r0, a.eps);
  stage_x<KIND, RT>(xs, a.x, 0, a.R, a.dim, r0, 0, nc, a.nw, rstd);
  const int lane = threadIdx.x % 32;
  const int ng = blockIdx.x * TN + lane * 4;  // gate columns; up = F + gate
  {
    float acc[RT][4] = {};
    gemv_warp<KIND, RT>(acc, a.qs, a.scl, N, a.dim, ng, ng < a.F, 0, nc, xs, a.dim, a.mins);
    block_reduce<RT>(red_g, acc);
  }
  {
    float acc[RT][4] = {};
    gemv_warp<KIND, RT>(acc, a.qs, a.scl, N, a.dim, a.F + ng, ng < a.F, 0, nc, xs, a.dim,
                        a.mins);
    block_reduce<RT>(red_u, acc);
  }
  for (int i = threadIdx.x; i < RT * TN; i += THREADS) {
    const int r = r0 + i / TN, col = blockIdx.x * TN + i % TN;
    if (r >= a.R || col >= a.F) continue;
    const float g = round_bf16(red_g[i]), u = round_bf16(red_u[i]);
    const float silu = g / (1.f + expf(-g));
    a.act[(size_t)r * a.F + col] = __float2bfloat16_rn(silu * u);
  }
}

template <int KIND, int RT>
cudaError_t launch_gate_up_rt(const GateUpArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * (RT * a.dim + 2 * WARPS * RT * TN);
  cudaError_t e = cudaFuncSetAttribute(gate_up_kernel<KIND, RT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.F + TN - 1) / TN, 1, (a.R + RT - 1) / RT);
  gate_up_kernel<KIND, RT><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_gate_up_k(const GateUpArgs& a, cudaStream_t st) {
  switch (pick_rt(a.R)) {
    case 1: return launch_gate_up_rt<KIND, 1>(a, st);
    case 2: return launch_gate_up_rt<KIND, 2>(a, st);
    case 4: return launch_gate_up_rt<KIND, 4>(a, st);
    default: return launch_gate_up_rt<KIND, 8>(a, st);
  }
}

// kind: the kind code of w_gateup (KQ4, KQ4F, KQ6W, KQ6WF, KQ8 or KQ8F)
inline cudaError_t launch_gate_up(int kind, const GateUpArgs& a, cudaStream_t st) {
  switch (kind) {
    case KQ4: return launch_gate_up_k<KQ4>(a, st);
    case KQ4F: return launch_gate_up_k<KQ4F>(a, st);
    case KQ6W: return launch_gate_up_k<KQ6W>(a, st);
    case KQ6WF: return launch_gate_up_k<KQ6WF>(a, st);
    case KQ8: return launch_gate_up_k<KQ8>(a, st);
    case KQ8F: return launch_gate_up_k<KQ8F>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// oproj_ffn's three phases (ffn.cu), shared with layer.cu and rot.cu: (A)
// the o_proj GEMV over wo on attn [R, K], whose epilogue adds the residual x
// (rounding the o_proj sum to bf16 first where round_first, as the
// reference's attn_out and layer kernels do) -> x2; (B) gate/up on x2 ->
// act; (C) the down GEMV on act, whose epilogue adds x2 -> out [R, dim].
// ws: f32 scratch of max(splits_o, splits_d) * R * dim floats.
inline cudaError_t launch_oproj_ffn(const void* x, const void* attn, const float* nw, float eps,
                                    int wo_kind, const void* wo_qs, const void* wo_scl,
                                    const void* wo_mins, int gu_kind, const void* gu_qs,
                                    const void* gu_scl, const void* gu_mins, int dn_kind,
                                    const void* dn_qs, const void* dn_scl, void* x2, void* act,
                                    float* ws, void* out, int R, int dim, int K, int F,
                                    int cps_o, int splits_o, int cps_d, int splits_d,
                                    int round_first, cudaStream_t st) {
  GemvArgs ao{attn, 0, static_cast<const uint8_t*>(wo_qs), static_cast<const uint32_t*>(wo_scl),
              R, dim, K, cps_o, ws, x2, 0, static_cast<const __nv_bfloat16*>(x),
              static_cast<const uint32_t*>(wo_mins)};
  ao.round_first = round_first;
  cudaError_t e = launch_gemv_kind(wo_kind, ao, splits_o, st);
  if (e != cudaSuccess) return e;
  const auto* x2b = static_cast<const __nv_bfloat16*>(x2);
  GateUpArgs ag{x2b, nw, eps, static_cast<const uint8_t*>(gu_qs),
                static_cast<const uint32_t*>(gu_scl), static_cast<const uint32_t*>(gu_mins),
                static_cast<__nv_bfloat16*>(act), R, dim, F};
  e = launch_gate_up(gu_kind, ag, st);
  if (e != cudaSuccess) return e;
  GemvArgs ad{act, 0, static_cast<const uint8_t*>(dn_qs), static_cast<const uint32_t*>(dn_scl),
              R, dim, F, cps_d, ws, out, 0, x2b, nullptr};
  return launch_gemv_kind(dn_kind, ad, splits_d, st);
}

}  // namespace tkq
