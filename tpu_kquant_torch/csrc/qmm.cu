// qmm for the q4, q6w and q8 kinds (codes 0-5 of common.cuh); the kernels
// are in qmm.cuh.
#include "common.cuh"
#include "qmm.cuh"

using namespace tkq;

// kind: 0 = q4 with sm pairs, 1 = q6w with sp pairs, 2 = q4 with f32 scales
// and mins, 3 = q6w with f32 scales, 4 = q8 with sp pairs, 5 = q8 with f32
// scales (mins: null except for kind 2; qh unused). R <= 32 takes the GEMV
// path with `splits` K splits of `cps` chunks each (ws holds splits * R * N
// floats when splits > 1); R > 32 takes the wgmma tile of qmm_tile.cuh
// (bf16 x only) with BM = 128 mw rows a block and `splits` K splits of `cps`
// 64-row steps each (ops/qmm.py:tile_plan). N % 4 == 0.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int tkq_qmm(int kind, const void* x, int x_f32, const void* qs, const void* qh,
                       const void* scl, const void* mins, void* out, int out_f32, float* ws,
                       int R, int N, int K, int cps, int splits, int mw,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QmmArgs q = qmm_args(x, x_f32, qs, qh, scl, mins, out, out_f32, ws, R, N, K, cps, splits,
                               mw);
  switch (kind) {
    case KQ4: return (int)launch_qmm<KQ4>(q, st);
    case KQ6W: return (int)launch_qmm<KQ6W>(q, st);
    case KQ4F: return (int)launch_qmm<KQ4F>(q, st);
    case KQ6WF: return (int)launch_qmm<KQ6WF>(q, st);
    case KQ8: return (int)launch_qmm<KQ8>(q, st);
    case KQ8F: return (int)launch_qmm<KQ8F>(q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
