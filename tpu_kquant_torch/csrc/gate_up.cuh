// gate/up phase shared by the FFN kernels (ffn.cu: oproj_ffn and ffn;
// layer.cu, rot.cu through launch_oproj_ffn):
// act = bf16(a(bf16(gate(n(x)))) * bf16(up(n(x)))), n = rms_norm, a = silu
// or, for the gemma family, the exact (erf) gelu (GateUpArgs.gelu), for
// decode rows (R <= 32), over the fused w_gateup [2F, dim] (gate columns
// 0..F-1, up columns F..2F-1) of kind q4, q6w or q8, each with bf16 pairs or
// f32 scales (KQ4, KQ4F, KQ6W, KQ6WF, KQ8, KQ8F of common.cuh).
//
// Replaces the gate/up part of the TPU kernels tpu_kquant/ops/pallas_ffn.py:
// fused_ffn (_ffn_call, body _ffn_kernel) and fused_oproj_ffn
// (_oproj_ffn_manual_call, _oproj_ffn_call), which dequantize an F tile of
// w_gateup in VMEM and feed the normalised rows to the MXU.
//
// Bound: memory. At TinyLlama width w_gateup [11264, 2048] q4-sm is 14.4 MB
// (4.3 us at 3.35 TB/s), at Qwen2.5-1.5B's [17920, 1536] 15.8 MB.
//
// Design: gemv.cuh's core (mma.sync bf16 group dots on codes moved exactly
// into bf16, the scale and min applied once per group, its fragment mapping
// and load scheme), with one block = 256 columns: gate columns [j, j + 128)
// (warps 0, 1 of each K row) and up columns [F + j, F + j + 128) (warps 2,
// 3), so the two outputs that the activation pairs meet in one block.
// - The K split comes from the phase's own plan (ops/ffn.py:gate_up_plan,
//   gemv_plan over (kind, 2F, dim)), never from R: grid (ceil(F / 128),
//   splits). Unsplit, the block forms the activation in its epilogue;
//   split, its f32 partials go to ws [splits, R, 2F] and gate_up_reduce
//   adds them in a fixed order and forms it. Only bf16 act [R, F] reaches
//   device memory beside them.
// - The norm: every block computes rms(x) of its rows (gemv.cuh's
//   gv_sumsq over the whole row: 16-byte loads of every row at once, a
//   fixed order of sums) and stages its K range of the normalised rows x *
//   rstd * nw (f32, as the reference's kernels and the plain version keep
//   them) as two bf16 halves, hi = bf16(v) and lo = bf16(v - hi)
//   (gv_stage_xn), so each group dot takes two mmas (q8: four) and sees v
//   to about 16 bits: the phase is bound by its loads, not by the tensor
//   cores. Requires dim % 8 == 0 and 16-byte aligned rows of x and of the
//   norm weight.
// - The int8 folds (GateUpArgs.fold, a run-time flag; q4 only: the grid
//   kernels' branch, tpu_kquant/ops/pallas_ffn.py:154-162, :201-204): the
//   block quantizes its K range of the normalised rows to int8 per
//   32-group in shared memory (int8.cuh:i8_stage_xn, in place of the bf16
//   halves) and runs the codes against them on int8 tensor cores
//   (i8_q4_chunk, qmm_int8's core): each group's exact integer sum takes
//   its scale and min once. A row is quantized alone, so it stays
//   batch-invariant.
#pragma once

#include "common.cuh"
#include "gemv.cuh"
#include "int8.cuh"

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
  int cps;                  // chunks per K split (grid.y splits)
  float* ws;                // [splits, R, 2F] f32 partials where grid.y > 1
  int gelu;                 // 0: silu, 1: gelu (exact, erf)
  int fold = 0;             // q4 only: the int8 folds (int8.cuh)
};

// The activated product of one (gate, up) pair, in f32 on their bf16
// roundings, as the TPU kernels form it (pallas_ffn.py:226-231: silu, or
// jax.nn.gelu(approximate=False) = g (1 + erf(g / sqrt 2)) / 2), rounded to
// bf16. The activation is a run-time flag, uniform over the launch: it
// costs one branch a pair in the epilogue and no kernel instance of its
// own (a template parameter would double every gate/up instance, and with
// them the build time of ffn, layer and rot).
__device__ __forceinline__ __nv_bfloat16 gu_act(float g, float u, int gelu) {
  g = round_bf16(g), u = round_bf16(u);
  const float a = gelu ? g * (erff(g * 0.70710678118654752f) + 1.f) * 0.5f : g / (1.f + expf(-g));
  return __float2bfloat16_rn(a * u);
}

// grid (ceil(F / 128), splits); GV_THREADS threads; dynamic smem
// gemv_smem_bytes<KIND>(NT, cps, 2). R <= 8 NT.
template <int KIND, int NT>
__global__ void __launch_bounds__(GV_THREADS, NT <= 2 ? 2 : 1) gate_up_kernel(GateUpArgs a) {
  extern __shared__ __align__(16) uint8_t gu_smem[];
  __shared__ float rstd[8 * NT], red[8 * NT * (GV_THREADS / 32)];
  constexpr int NSEG = segments(KIND), GPC = gv_gpc<KIND>(), ROWS = 8 * NT;
  const int N = 2 * a.F;
  const int n_chunks = n_chunks_of<KIND>(a.dim);
  const int c0 = blockIdx.y * a.cps;
  const int nch = max(min(n_chunks, c0 + a.cps) - c0, 0);
  const int L = a.cps * CH, XS = gv_xstride(NSEG * L);
  auto* xs = reinterpret_cast<__nv_bfloat16*>(gu_smem);
  float* sums = reinterpret_cast<float*>(gu_smem + (size_t)2 * ROWS * XS * 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wn = warp % GV_WN, wk = warp / GV_WN;
  const int j0 = blockIdx.x * (GV_TN / 2);
  // the lane's 8 code columns: gate j0 + 64 wn + 8g (wn 0, 1), up F + j0 +
  // 64 (wn - 2) + 8g (wn 2, 3); gv_ld8 zeroes columns past 2F
  const int n = (wn < 2 ? j0 : a.F + j0 - GV_TN / 2) + wn * 64 + 8 * g;
  const int ns = n + 2 * t;
  const bool al8 = N % 8 == 0 && (reinterpret_cast<uintptr_t>(a.qs) & 7) == 0;
  const GemvArgs ga{nullptr, 0, a.qs, a.scl, a.R, N, a.dim, a.cps, nullptr, nullptr, 0,
                    nullptr, a.mins};
  uint2 w[8], sc[4];
  if (wk < nch) gv_load<KIND>(w, sc, ga, c0 + wk, n, ns, t, al8);
  gv_sumsq<NT>(rstd, red, a.x, a.R, a.dim, 1, 0, a.dim);
  if (threadIdx.x < ROWS)
    rstd[threadIdx.x] = threadIdx.x < a.R ? rsqrtf(rstd[threadIdx.x] / (float)a.dim + a.eps) : 0.f;
  __syncthreads();
  // the folds' staging: int8 rows [ROWS][XQS], then the groups' scales
  // and gsums [2 cps][ROWS] each (less than the bf16 halves take)
  const bool fold = is_q4(KIND) && a.fold;
  const int XQS = i8_xqstride(NSEG * L);
  auto* xq = reinterpret_cast<int8_t*>(gu_smem);
  float* sx = reinterpret_cast<float*>(gu_smem + (size_t)ROWS * XQS);
  float* sg = sx + (size_t)NSEG * a.cps * ROWS;
  if (fold)
    i8_stage_xn<NT>(xq, sx, sg, a.x, a.nw, a.R, a.dim, a.cps, rstd, c0, nch, XQS);
  else
    gv_stage_xn<KIND, NT>(xs, sums, a.x, a.nw, a.R, a.dim, a.cps, rstd, c0, nch, XS);
  float acc[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p][0] = acc[j][p][1] = acc[j][p][2] = acc[j][p][3] = 0.f;
  const __nv_bfloat16* xb = xs + g * XS + 4 * t;
  const float* sb = sums + 2 * t;
  const int chunk_sums = GPC * ROWS;
  for (int lc = wk; lc < nch; lc += GV_WK) {
    uint2 wn2[8], sn[4];
    gv_load<KIND>(wn2, sn, ga, c0 + min(lc + GV_WK, nch - 1), n, ns, t, al8);
    if constexpr (is_q4(KIND)) {
      if (fold)
        i8_q4_chunk<KIND, NT>(acc, w, sc, xq + g * XQS + 4 * t + lc * CH, XQS, L,
                              sx + lc * ROWS + 2 * t, sg + lc * ROWS + 2 * t, a.cps * ROWS,
                              lane);
      else
        gv_chunk<KIND, NT, true>(acc, w, sc, xb + lc * CH, XS, sb + lc * chunk_sums, L,
                                 a.cps * chunk_sums, lane, (c0 + lc) & 1, ROWS * XS);
    } else {
      gv_chunk<KIND, NT, true>(acc, w, sc, xb + lc * CH, XS, sb + lc * chunk_sums, L,
                               a.cps * chunk_sums, lane, (c0 + lc) & 1, ROWS * XS);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = wn2[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = sn[i];
  }
  float* tile = reinterpret_cast<float*>(gu_smem);
  gv_combine<NT>(acc, tile, wn, wk, g, t);
  if (gridDim.y > 1) {  // the split's partials, gate and up columns
    for (int i = threadIdx.x; i < ROWS * GV_TN / 4; i += GV_THREADS) {
      const int r = i / (GV_TN / 4), c4 = (i % (GV_TN / 4)) * 4, j = j0 + c4 % (GV_TN / 2);
      if (r >= a.R || j >= a.F) continue;
      const size_t o = ((size_t)blockIdx.y * a.R + r) * N + (c4 < GV_TN / 2 ? j : a.F + j);
      *reinterpret_cast<float4*>(a.ws + o) =
          *reinterpret_cast<const float4*>(tile + r * GV_TP + c4);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * GV_TN / 2; i += GV_THREADS) {
      const int r = i / (GV_TN / 2), c = i % (GV_TN / 2), j = j0 + c;
      if (r >= a.R || j >= a.F) continue;
      a.act[(size_t)r * a.F + j] =
          gu_act(tile[r * GV_TP + c], tile[r * GV_TP + GV_TN / 2 + c], a.gelu);
    }
  }
}

// act[r, j] from the splits' partials, each sum taken in split order 0, 1, ...
__global__ void __launch_bounds__(256) gate_up_reduce(const float* ws, int S, int R, int F,
                                                      int gelu, __nv_bfloat16* act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * F) return;
  const int r = i / F, j = i % F;
  float gs = 0.f, us = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* p = ws + ((size_t)s * R + r) * 2 * F;
    gs += p[j], us += p[F + j];
  }
  act[i] = gu_act(gs, us, gelu);
}

template <int KIND, int NT>
cudaError_t launch_gate_up_nt(const GateUpArgs& a, int splits, cudaStream_t st) {
  const size_t smem = gemv_smem_bytes<KIND>(NT, a.cps, 2);
  cudaError_t e = cudaFuncSetAttribute(gate_up_kernel<KIND, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.F + GV_TN / 2 - 1) / (GV_TN / 2), splits);
  gate_up_kernel<KIND, NT><<<grid, GV_THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  gate_up_reduce<<<(a.R * a.F + 255) / 256, 256, 0, st>>>(a.ws, splits, a.R, a.F, a.gelu,
                                                          a.act);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_gate_up_k(const GateUpArgs& a, int splits, cudaStream_t st) {
  switch ((a.R + 7) / 8) {
    case 1: return launch_gate_up_nt<KIND, 1>(a, splits, st);
    case 2: return launch_gate_up_nt<KIND, 2>(a, splits, st);
    case 3: return launch_gate_up_nt<KIND, 3>(a, splits, st);
    case 4: return launch_gate_up_nt<KIND, 4>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// kind: the kind code of w_gateup (KQ4, KQ4F, KQ6W, KQ6WF, KQ8 or KQ8F);
// `splits` K splits of a.cps chunks (ops/ffn.py:gate_up_plan)
inline cudaError_t launch_gate_up(int kind, const GateUpArgs& a, int splits, cudaStream_t st) {
  if (splits > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  if (a.fold && !is_q4(kind)) return cudaErrorInvalidValue;
  switch (kind) {
    case KQ4: return launch_gate_up_k<KQ4>(a, splits, st);
    case KQ4F: return launch_gate_up_k<KQ4F>(a, splits, st);
    case KQ6W: return launch_gate_up_k<KQ6W>(a, splits, st);
    case KQ6WF: return launch_gate_up_k<KQ6WF>(a, splits, st);
    case KQ8: return launch_gate_up_k<KQ8>(a, splits, st);
    case KQ8F: return launch_gate_up_k<KQ8F>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// oproj_ffn's three phases (ffn.cu), shared with layer.cu and rot.cu: (A)
// the o_proj GEMV over wo on attn [R, K], whose epilogue adds the residual x
// (rounding the o_proj sum to bf16 first where round_first, as the
// reference's attn_out and layer kernels do) -> x2; (B) gate/up on x2 ->
// act; (C) the down GEMV on act, whose epilogue adds x2 -> out [R, dim].
// ws: f32 scratch of max(splits_o * R * dim, splits_g * R * 2F, splits_d *
// R * dim) floats, used by one phase at a time. gelu: phase B's activation
// (0 silu, 1 gelu). pdl: the o_proj GEMV is a programmatic dependent of the
// kernel that writes attn (GemvArgs.pdl). fold_wo (a q4 wo): phase A
// quantizes attn per 32-group (quantize_kernel) into ws after its split
// partials (int8 [R, K], then its scales and gsums [R, K / 32] f32 each)
// and runs int8.cuh's GEMV with the same epilogue; fold_gu: phase B's int8
// folds (GateUpArgs.fold). Where wo folds, ws holds those too.
inline cudaError_t launch_oproj_ffn(const void* x, const void* attn, const float* nw, float eps,
                                    int wo_kind, const void* wo_qs, const void* wo_scl,
                                    const void* wo_mins, int gu_kind, const void* gu_qs,
                                    const void* gu_scl, const void* gu_mins, int dn_kind,
                                    const void* dn_qs, const void* dn_scl, void* x2, void* act,
                                    float* ws, void* out, int R, int dim, int K, int F,
                                    int cps_o, int splits_o, int cps_g, int splits_g, int cps_d,
                                    int splits_d, int round_first, int gelu, cudaStream_t st,
                                    int pdl = 0, int fold_wo = 0, int fold_gu = 0) {
  cudaError_t e;
  if (fold_wo) {
    if (!is_q4(wo_kind) || K % 64 != 0) return cudaErrorInvalidValue;
    float* qa = ws + (splits_o > 1 ? (size_t)splits_o * R * dim : 0);
    auto* xq = reinterpret_cast<int8_t*>(qa);
    float* xs = qa + (size_t)R * K / 4;
    float* gs = xs + (size_t)R * K / 32;
    const size_t n = (size_t)R * K;
    quantize_kernel<32><<<(unsigned)((n / 32 + WARPS - 1) / WARPS), THREADS, 0, st>>>(
        attn, 0, xq, xs, gs, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    Int8Args ai{xq, xs, gs, static_cast<const uint8_t*>(wo_qs), nullptr,
                static_cast<const uint32_t*>(wo_scl), static_cast<const uint32_t*>(wo_mins),
                R, dim, K, cps_o, ws, x2, 0, static_cast<const __nv_bfloat16*>(x),
                round_first};
    e = launch_int8_q4(wo_kind, ai, splits_o, st);
  } else {
    GemvArgs ao{attn, 0, static_cast<const uint8_t*>(wo_qs),
                static_cast<const uint32_t*>(wo_scl), R, dim, K, cps_o, ws, x2, 0,
                static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wo_mins)};
    ao.round_first = round_first;
    ao.pdl = pdl;
    e = launch_gemv_kind(wo_kind, ao, splits_o, st);
  }
  if (e != cudaSuccess) return e;
  const auto* x2b = static_cast<const __nv_bfloat16*>(x2);
  GateUpArgs ag{x2b, nw, eps, static_cast<const uint8_t*>(gu_qs),
                static_cast<const uint32_t*>(gu_scl), static_cast<const uint32_t*>(gu_mins),
                static_cast<__nv_bfloat16*>(act), R, dim, F, cps_g, ws, gelu, fold_gu};
  e = launch_gate_up(gu_kind, ag, splits_g, st);
  if (e != cudaSuccess) return e;
  GemvArgs ad{act, 0, static_cast<const uint8_t*>(dn_qs), static_cast<const uint32_t*>(dn_scl),
              R, dim, F, cps_d, ws, out, 0, x2b, nullptr};
  return launch_gemv_kind(dn_kind, ad, splits_d, st);
}

}  // namespace tkq
