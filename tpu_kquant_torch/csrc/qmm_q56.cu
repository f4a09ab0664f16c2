// qmm for the K-quant bit-plane kinds q5 and q6 (unwidened) (codes 6-9 of
// common.cuh: sm pairs, or f32 scales and mins); the kernels are in qmm.cuh.
// A library of its own so that nvcc builds it beside qmm.cu and qmm_q23.cu.
#include "common.cuh"
#include "qmm.cuh"

using namespace tkq;

// kind: 6 / 7 = q5, 8 / 9 = q6, the even code with sm pairs, the odd one with
// f32 scales and mins. qh: the high bit plane. The rest as tkq_qmm in
// qmm.cu; K % 256 == 0.
extern "C" int tkq_qmm(int kind, const void* x, int x_f32, const void* qs, const void* qh,
                       const void* scl, const void* mins, void* out, int out_f32, float* ws,
                       int R, int N, int K, int cps, int splits, int mw,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QmmArgs q = qmm_args(x, x_f32, qs, qh, scl, mins, out, out_f32, ws, R, N, K, cps, splits,
                               mw);
  switch (kind) {
    case KQ5: return (int)launch_qmm<KQ5>(q, st);
    case KQ5F: return (int)launch_qmm<KQ5F>(q, st);
    case KQ6: return (int)launch_qmm<KQ6>(q, st);
    case KQ6F: return (int)launch_qmm<KQ6F>(q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
