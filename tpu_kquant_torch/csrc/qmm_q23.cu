// qmm for the K-quant bit-plane kinds q3 and q2 (codes 10-13 of common.cuh:
// sm pairs, or f32 scales and mins); the kernels are in qmm.cuh. A library
// of its own so that nvcc builds it beside qmm.cu and qmm_q56.cu.
#include "common.cuh"
#include "qmm.cuh"

using namespace tkq;

// kind: 10 / 11 = q3, 12 / 13 = q2, the even code with sm pairs, the odd one
// with f32 scales and mins. qh: q3's high bit plane (null for q2). The rest
// as tkq_qmm in qmm.cu; K % 256 == 0.
extern "C" int tkq_qmm(int kind, const void* x, int x_f32, const void* qs, const void* qh,
                       const void* scl, const void* mins, void* out, int out_f32, float* ws,
                       int R, int N, int K, int cps, int splits, int mw,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QmmArgs q = qmm_args(x, x_f32, qs, qh, scl, mins, out, out_f32, ws, R, N, K, cps, splits,
                               mw);
  switch (kind) {
    case KQ3: return (int)launch_qmm<KQ3>(q, st);
    case KQ3F: return (int)launch_qmm<KQ3F>(q, st);
    case KQ2: return (int)launch_qmm<KQ2>(q, st);
    case KQ2F: return (int)launch_qmm<KQ2F>(q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
