// The qmm kernels (y[R, N] = x[R, K] @ dequant(W)^T) for every packed kind,
// shared by the three libraries that instantiate them: qmm.cu (q4, q6w, q8),
// qmm_q56.cu (the bit-plane kinds q5, q6) and qmm_q23.cu (q3, q2), built in
// parallel.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_qmm.py:qmm_pallas
// (_qmm_call, kernel body _qmm_kernel, codes unpacked as _codes_for_fold
// does), which streams the packed bytes once and dequantizes them in VMEM
// tiles for the MXU.
//
// Two paths, chosen by the row count like the reference's tiles:
// - R <= 32 (decode; the lm head on the main path): memory bound. At
//   3.35 TB/s the lm head [32000, 2048] q6w-sp (73.7 MB) takes at least
//   22 us; q8-sp (69.6 MB) 20.8 us. gemv.cuh's tensor-core GEMV reads every
//   packed byte once whatever R is (one block holds all the rows), a q4
//   byte's two nibble folds from one load, a bit-plane chunk's qh words
//   once for all its segments; its K split (ops/qmm.py:gemv_plan) does not
//   depend on R.
// - R > 32 (prefill; every projection; serving ticks past 32 slots):
//   compute bound at R = 512 (2 R K N flops over 989 TFLOP/s bf16). The
//   pipelined wgmma tile of qmm_tile.cuh: bf16 x only (the wrapper rounds
//   f32 activations to bf16 once), its tile and K split chosen by the
//   wrapper (ops/qmm.py:tile_plan).
// The f32-scale layouts (scale_dtype='f32', as the int8 path loads them) have
// twice the side-array bytes of the pairs: 0.75 bytes per q4 weight instead
// of 0.625, 1.25 per q6w weight instead of 1.125. Mixtral-8x7B's expert down
// [4096, 14336] q6w-f32 (73.4 MB) bounds the R = 1 GEMV at 21.9 us. N needs
// only be a multiple of 4 (the router's N = 8): both paths mask the ragged
// column edge.
#pragma once

#include "common.cuh"
#include "gemv.cuh"
#include "qmm_tile.cuh"

namespace tkq {

struct QmmArgs {
  const void* x;
  int x_f32;
  const uint8_t* qs;
  const uint8_t* qh;     // high bit planes (q5, q6, q3), else null
  const uint32_t* scl;   // sm / sp pairs or f32 scales
  const uint32_t* mins;  // f32 mins (f32 layouts of the kinds with mins), else null
  void* out;
  int out_f32;
  float* ws;
  int R, N, K, cps, splits;
  int mw;  // tile path: BM / 128 (cps: steps per split)
};

template <int KIND>
cudaError_t launch_qmm(const QmmArgs& q, cudaStream_t st) {
  if (q.R <= 32) {
    GemvArgs a{q.x, q.x_f32, q.qs, q.scl, q.R, q.N, q.K, q.cps, q.ws, q.out, q.out_f32, nullptr,
               q.mins, q.qh};
    return launch_gemv<KIND>(a, q.splits, st);
  }
  if (q.x_f32) return cudaErrorInvalidValue;  // the tile reads bf16 x
  const TileArgs t{q.qs, q.qh, q.out, q.out_f32, q.ws, q.R, q.N, q.K, q.cps};
  return launch_tile<KIND>(static_cast<const __nv_bfloat16*>(q.x), q.scl, q.mins, t, q.mw,
                           q.splits, st);
}

// the C entry point's arguments, as QmmArgs
inline QmmArgs qmm_args(const void* x, int x_f32, const void* qs, const void* qh,
                        const void* scl, const void* mins, void* out, int out_f32, float* ws,
                        int R, int N, int K, int cps, int splits, int mw) {
  return QmmArgs{x, x_f32, static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const uint32_t*>(scl), static_cast<const uint32_t*>(mins), out,
                 out_f32, ws, R, N, K, cps, splits, mw};
}

}  // namespace tkq
