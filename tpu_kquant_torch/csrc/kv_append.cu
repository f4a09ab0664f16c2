// kv_append: write one decode step's new K and V rows into a layer of the
// bf16 heads-major KV cache, in place: cache[layer, b, h, start[b], :] =
// new[b, 0, h, :] for every batch row b and KV head h, K and V in one launch.
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_kv_append.py:
// kv_append_pallas (kernel _append_kernel), which fetches the aligned
// 16-slot window that holds each row's slot and merges the row in, because a
// Mosaic DMA cannot address a single slot of a tiled buffer. Nothing here
// needs a window: a thread writes its element where it belongs.
//
// Bound: memory, and far below the launch cost: at TinyLlama width a step
// writes 2 x 4 heads x 64 values of 2 bytes per row (1 KB at B = 1) and
// reads as much. The kernel exists to replace the two indexed writes of the
// unfused append (each an index computation and a scatter launch) by one
// launch.
//
// Design: one thread per (b, head, d) element, grid.y = 0 for K, 1 for V.
// start is read on the device (never on the host), so the launch needs no
// synchronisation and can be captured in a CUDA graph. A start outside
// [0, S) writes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tkq {

struct KvAppendArgs {
  __nv_bfloat16* k;  // the layer's cache [B, Hkv, S, D]: row b at b * scb, head at h * sch
  __nv_bfloat16* v;
  long long scb, sch;
  const __nv_bfloat16* kn;  // new rows [B, 1, Hkv, D]: row b at b * snb, head at h * snh
  const __nv_bfloat16* vn;
  long long snb, snh, svnb, svnh;
  const long long* start;  // [B] at b * spos: the slot of row b
  long long spos;
  int B, Hkv, S, D;
};

__global__ void __launch_bounds__(256) kv_append_kernel(KvAppendArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.Hkv * a.D) return;
  const int d = i % a.D, h = (i / a.D) % a.Hkv, b = i / ((long long)a.D * a.Hkv);
  const long long slot = a.start[b * a.spos];
  if (slot < 0 || slot >= a.S) return;
  const bool is_v = blockIdx.y == 1;
  const __nv_bfloat16* src = is_v ? a.vn + b * a.svnb + h * a.svnh : a.kn + b * a.snb + h * a.snh;
  __nv_bfloat16* dst = (is_v ? a.v : a.k) + b * a.scb + h * a.sch + slot * a.D;
  dst[d] = src[d];
}

}  // namespace tkq

using namespace tkq;

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// k, v: the layer's cache [B, Hkv, S, D] bf16 with dense rows of D (strides
// scb, sch in elements); kn, vn: bf16 new rows with dense D (strides in
// elements); start: int64 slots [B] with stride spos. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int tkq_kv_append(void* k, void* v, long long scb, long long sch, const void* kn,
                             long long snb, long long snh, const void* vn, long long svnb,
                             long long svnh, const long long* start, long long spos, int B,
                             int Hkv, int S, int D, void* stream) {
  KvAppendArgs a{static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v), scb, sch,
                 static_cast<const __nv_bfloat16*>(kn), static_cast<const __nv_bfloat16*>(vn),
                 snb, snh, svnb, svnh, start, spos, B, Hkv, S, D};
  const long long n = (long long)B * Hkv * D;
  if (n == 0) return 0;
  dim3 grid((unsigned)((n + 255) / 256), 2);
  kv_append_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
