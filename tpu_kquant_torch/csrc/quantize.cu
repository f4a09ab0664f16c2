// quantize: float32 values -> GGML block bytes, Q4_K (144 bytes a block of
// 256), Q6_K (210 bytes a block of 256) and Q8_0 (34 bytes a block of 32).
//
// Replaces no TPU kernel: the reference quantizes on the host, with NumPy
// (tpu_kquant/quant/numpy_codecs.py: _q_q4_k, _q_q6_k, _q_q8_0) or its
// multithreaded C++ library (csrc/tkq.cpp: tkq_quantize_q4k, _q6k, _q80).
// These kernels are the port's counterpart of that library, and give the
// NumPy code's bytes, bit for bit (tpu_kquant_torch/quant/numpy_codecs.py is
// the port's copy of it; ops/quantize.py holds the plain PyTorch versions):
//   - every operation of the searches is the NumPy code's, in its order and
//     type: f32 elementwise, f64 accumulation. This source alone is built
//     with -fmad=false (ops/_build.py), so no multiply and add contract into
//     an FMA, which would round once where NumPy rounds twice;
//   - NumPy sums a row of 16 or 32 pairwise: eight accumulators r_j = x_j +
//     x_{j+8} (+ x_{j+16} + x_{j+24}, in turn), then
//     ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then adds the sum to the
//     reduction's initial 0.0 (which turns a -0.0 sum into +0.0). psum16 and
//     psum32 take the same steps with shuffles;
//   - rounding is half to even (rintf / rint), ties of argmax go to the
//     lower index, and the super-scales round f64 -> f32 -> f16 in two steps.
//
// Bound: FP64 arithmetic. A Q4_K element takes its part in 22 candidate
// fits of about 13 f64 operations each; the bytes (4 in, 0.5625 out an
// element) would take a tenth of that time at 3.35 TB/s
// (ops/quantize.py:work counts both). Q8_0 is bound by its bytes.
//
// Design: Q4_K, one block of 8 warps per super-block, warp j fitting
// sub-block j (a lane an element) through make_qkx2_quants' 21 candidates
// with the best kept in registers; thread 0 then forms d, dmin and the
// 6-bit scales and mins, and the block packs the codes. Q6_K, one block of
// 16 half-warps per super-block, half-warp g running make_qx_quants' 19
// candidates for group g. Q8_0, a warp per block, 8 blocks a CTA. A block
// builds its output in shared memory and writes it out whole.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tkq {

constexpr unsigned FULL = 0xffffffffu;

// The sum of a warp's 32 values (one a lane) in NumPy's pairwise order,
// plus 0.0; every lane gets it.
__device__ __forceinline__ double psum32(double v) {
  const int lane = threadIdx.x & 31;
  double a = v + __shfl_sync(FULL, v, (lane + 8) & 31);
  a = a + __shfl_sync(FULL, v, (lane + 16) & 31);
  a = a + __shfl_sync(FULL, v, (lane + 24) & 31);
  a = a + __shfl_xor_sync(FULL, a, 1);
  a = a + __shfl_xor_sync(FULL, a, 2);
  a = a + __shfl_xor_sync(FULL, a, 4);
  return __dadd_rn(0.0, __shfl_sync(FULL, a, 0));
}

// The same over each half-warp's 16 values (lanes 0-15 and 16-31 apart).
__device__ __forceinline__ double psum16(double v) {
  const int lane = threadIdx.x & 31, base = lane & 16;
  double a = v + __shfl_sync(FULL, v, base | ((lane + 8) & 15));
  a = a + __shfl_xor_sync(FULL, a, 1);
  a = a + __shfl_xor_sync(FULL, a, 2);
  a = a + __shfl_xor_sync(FULL, a, 4);
  return __dadd_rn(0.0, __shfl_sync(FULL, a, base));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The fp16 bits of v in a 32-bit register. Stored straight from the 16-bit
// register that cvt.rn.f16.f32 writes, the low byte came out 0 on the card
// (st.global.u8 of that register, as CUDA 12.9's ptxas built it for sm_90a); the
// widening move here keeps the bits whole.
__device__ __forceinline__ unsigned f16_bits(float v) {
  unsigned bits = __half_as_ushort(__float2half_rn(v));
  asm volatile("" : "+r"(bits));
  return bits;
}

// f64 -> f32 -> f16 -> f32, as NumPy's _f16(_to_f16_bytes(v.astype(f32))).
__device__ __forceinline__ float f16_round(double v) {
  return __half2float(__float2half_rn(__double2float_rn(v)));
}

// make_qkx2_quants(x, 15, av_x + |x|, -1.0, 0.1, 20, use_mad=False) over one
// warp's 32 values (numpy_codecs.py:_make_qkx2_quants with
// _kquant_search_scales' weights): the group's scale and min (min >= 0).
__device__ void qkx2_q4k(float x, double& scale_out, double& min_out) {
  const double xd = (double)x;
  const double s2 = psum32(xd * xd);
  const float av_x = __double2float_rn(sqrt(s2 / 32.0));
  const double wd = (double)(av_x + fabsf(x));
  const double sum_w = psum32(wd);
  const double sum_x = psum32(wd * xd);
  float mn = x, mx = x;
  for (int o = 16; o; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  }
  mn = mn < 0.0f ? mn : 0.0f;  // np.minimum(min, 0.0f): +0.0 unless negative
  const bool degen = mx == mn;
  const float span = degen ? 1.0f : mx - mn;
  const float xm = x - mn;
  const float isc0 = 15.0f / span;
  double scale = (double)(1.0f / isc0);
  double minv = (double)mn;
  double l = (double)clampf(rintf(isc0 * xm), 0.0f, 15.0f);
  double diff = scale * l + minv - xd;
  double best_mad = psum32(wd * (diff * diff));
  for (int step = 0; step <= 20; step++) {
    const float isc = (-1.0f + 0.1f * (float)step + 15.0f) / span;
    l = (double)clampf(rintf(isc * xm), 0.0f, 15.0f);
    const double wl = wd * l;
    const double sum_l = psum32(wl);
    const double sum_l2 = psum32(wl * l);
    const double sum_xl = psum32(wl * xd);
    const double D = sum_w * sum_l2 - sum_l * sum_l;
    const bool ok = D > 0.0;
    const double Ds = ok ? D : 1.0;
    double ts = (sum_w * sum_xl - sum_x * sum_l) / Ds;
    double tm = (sum_l2 * sum_x - sum_l * sum_xl) / Ds;
    if (tm > 0.0) {
      ts = sum_xl / (sum_l2 > 0.0 ? sum_l2 : 1.0);
      tm = 0.0;
    }
    diff = ts * l + tm - xd;
    const double mad = psum32(wd * (diff * diff));
    if (ok && mad < best_mad) {
      scale = ts;
      minv = tm;
      best_mad = mad;
    }
  }
  if (degen) {
    scale = 0.0;
    minv = (double)mn;
  }
  scale_out = scale;
  min_out = -minv;
}

__global__ void __launch_bounds__(256) q4k_kernel(const float* __restrict__ x,
                                                  uint8_t* __restrict__ out) {
  __shared__ double s_scale[8], s_min[8];
  __shared__ float s_se[8], s_me[8];
  __shared__ uint8_t s_q[256];
  __shared__ __align__(16) uint8_t s_out[144];
  const long long b = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5;
  const float xv = x[b * 256 + t];
  double scale, the_min;
  qkx2_q4k(xv, scale, the_min);
  if ((t & 31) == 0) {
    s_scale[w] = scale;
    s_min[w] = the_min;
  }
  __syncthreads();
  if (t == 0) {
    double max_scale = s_scale[0], max_min = s_min[0];
    for (int j = 1; j < 8; j++) {
      max_scale = s_scale[j] > max_scale ? s_scale[j] : max_scale;
      max_min = s_min[j] > max_min ? s_min[j] : max_min;
    }
    max_scale = max_scale > 0.0 ? max_scale : 0.0;  // np.maximum(., 0.0)
    max_min = max_min > 0.0 ? max_min : 0.0;
    const double inv_scale = max_scale > 0.0 ? 63.0 / max_scale : 0.0;
    const double inv_min = max_min > 0.0 ? 63.0 / max_min : 0.0;
    const float d = f16_round(max_scale / 63.0), dmin = f16_round(max_min / 63.0);
    uint8_t sc[8], m[8];
    for (int j = 0; j < 8; j++) {
      sc[j] = (uint8_t)fmin(fmax(rint(inv_scale * s_scale[j]), 0.0), 63.0);
      m[j] = (uint8_t)fmin(fmax(rint(inv_min * s_min[j]), 0.0), 63.0);
      s_se[j] = d * (float)sc[j];
      s_me[j] = dmin * (float)m[j];
    }
    const unsigned hd = f16_bits(d), hm = f16_bits(dmin);
    s_out[0] = hd & 0xff;
    s_out[1] = hd >> 8;
    s_out[2] = hm & 0xff;
    s_out[3] = hm >> 8;
    for (int j = 0; j < 4; j++) {
      s_out[4 + j] = (sc[j] & 63) | ((sc[j + 4] >> 4) << 6);
      s_out[8 + j] = (m[j] & 63) | ((m[j + 4] >> 4) << 6);
      s_out[12 + j] = (sc[j + 4] & 0xF) | ((m[j + 4] & 0xF) << 4);
    }
  }
  __syncthreads();
  const float se = s_se[w], me = s_me[w];
  s_q[t] = (uint8_t)(se > 0.0f ? clampf(rintf((xv + me) / se), 0.0f, 15.0f) : 0.0f);
  __syncthreads();
  if (t < 128) {  // chunk c = t / 32: low nibbles elements 64c + l, high 64c + 32 + l
    const int c = t >> 5, l = t & 31;
    s_out[16 + t] = s_q[64 * c + l] | (s_q[64 * c + 32 + l] << 4);
  }
  __syncthreads();
  if (t < 36)
    reinterpret_cast<uint32_t*>(out + b * 144)[t] = reinterpret_cast<const uint32_t*>(s_out)[t];
}

// make_qx_quants(x, 32) over one half-warp's 16 values
// (numpy_codecs.py:_make_qx_quants): the group's signed scale.
__device__ double qx_q6k(float x) {
  const int lane = threadIdx.x & 31, base = lane & 16;
  const double xd = (double)x;
  const double w = xd * xd;
  const double wx = w * xd;
  float amax = fabsf(x);
  int idx = lane & 15;
  for (int o = 8; o; o >>= 1) {  // argmax |x|, the lower index on ties
    const float ov = __shfl_xor_sync(FULL, amax, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    if (ov > amax || (ov == amax && oi < idx)) {
      amax = ov;
      idx = oi;
    }
  }
  const float maxv = __shfl_sync(FULL, x, base | idx);
  const bool dead = fabsf(maxv) < 1e-15f;
  const float safe = dead ? 1.0f : maxv;
  double scale = 0.0, best = 0.0;
  for (int k = 0; k < 19; k++) {
    const int step = k == 0 ? 0 : (k <= 9 ? k - 10 : k - 9);  // 0, -9..-1, 1..9
    const float isc = -(32.0f + 0.1f * (float)step) / safe;
    const double l = (double)clampf(rintf(isc * x), -32.0f, 31.0f);
    const double slx = psum16(wx * l);
    const double sl2 = psum16((w * l) * l);
    if (k == 0) {
      scale = sl2 > 0.0 ? slx / sl2 : 0.0;
      best = scale * slx;
    } else if (sl2 > 0.0 && slx * slx > best * sl2) {
      scale = slx / sl2;
      best = scale * slx;
    }
  }
  return dead ? 0.0 : scale;
}

__global__ void __launch_bounds__(256) q6k_kernel(const float* __restrict__ x,
                                                  uint8_t* __restrict__ out) {
  __shared__ double s_scale[16];
  __shared__ float s_eff[16];
  __shared__ int s_dead;
  __shared__ uint8_t s_q[256];
  __shared__ uint8_t s_out[210];
  const long long b = blockIdx.x;
  const int t = threadIdx.x, g = t >> 4;
  const float xv = x[b * 256 + t];
  const double scale = qx_q6k(xv);
  if ((t & 15) == 0) s_scale[g] = scale;
  __syncthreads();
  if (t == 0) {
    double max_scale = s_scale[0], amax = fabs(s_scale[0]);
    for (int j = 1; j < 16; j++) {  // argmax |scale|, the first on ties
      if (fabs(s_scale[j]) > amax) {
        amax = fabs(s_scale[j]);
        max_scale = s_scale[j];
      }
    }
    const bool dead = fabs(max_scale) < 1e-15;
    const double iscale = -128.0 / (dead ? 1.0 : max_scale);
    const float d = dead ? 0.0f : f16_round(1.0 / iscale);
    for (int j = 0; j < 16; j++) {
      const int8_t sc = dead ? 0 : (int8_t)fmin(fmax(fmin(127.0, rint(iscale * s_scale[j])),
                                                     -128.0), 127.0);
      s_out[192 + j] = (uint8_t)sc;
      s_eff[j] = d * (float)sc;
    }
    const unsigned hd = f16_bits(d);
    s_out[208] = hd & 0xff;
    s_out[209] = hd >> 8;
    s_dead = dead;
  }
  __syncthreads();
  const float eff = s_eff[g];
  const float q = eff != 0.0f ? clampf(rintf(xv / eff), -32.0f, 31.0f) : 0.0f;
  s_q[t] = s_dead ? 0 : (uint8_t)((int)q + 32);  // 6-bit biased; a dead block is all zero
  __syncthreads();
  if (t < 64) {  // half n = t / 32, l = t % 32 (csrc/tkq.cpp's packing)
    const uint8_t* y = s_q + 128 * (t >> 5);
    const int l = t & 31, n = t >> 5;
    s_out[64 * n + l] = (y[l] & 0xF) | ((y[l + 64] & 0xF) << 4);
    s_out[64 * n + l + 32] = (y[l + 32] & 0xF) | ((y[l + 96] & 0xF) << 4);
    s_out[128 + 32 * n + l] = (y[l] >> 4) | ((y[l + 32] >> 4) << 2) | ((y[l + 64] >> 4) << 4) |
                              ((y[l + 96] >> 4) << 6);
  }
  __syncthreads();
  if (t < 210) out[b * 210 + t] = s_out[t];
}

// _q_q8_0: d = max|x| / 127 (f32), q = round(x / d) (f32, half to even, not
// the C++ library's lround), clipped to [-127, 127].
__global__ void __launch_bounds__(256) q80_kernel(const float* __restrict__ x,
                                                  uint8_t* __restrict__ out, long long nb) {
  const long long b = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (b >= nb) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const float v = x[b * 32 + lane];
  float amax = fabsf(v);
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  const float d = amax / 127.0f;
  const float q = d != 0.0f ? clampf(rintf(v / d), -127.0f, 127.0f) : 0.0f;
  uint8_t* o = out + b * 34;
  o[2 + lane] = (uint8_t)(int8_t)(int)q;
  if (lane == 0) {
    const unsigned hd = f16_bits(d);
    o[0] = hd & 0xff;
    o[1] = hd >> 8;
  }
}

}  // namespace tkq

using namespace tkq;

extern "C" const char* tkq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: f32 [nb * 256] on the device; out: u8 [nb * 144]. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int tkq_quantize_q4k(const float* x, void* out, long long nb, void* stream) {
  if (nb == 0) return 0;
  q4k_kernel<<<(unsigned)nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// x: f32 [nb * 256]; out: u8 [nb * 210].
extern "C" int tkq_quantize_q6k(const float* x, void* out, long long nb, void* stream) {
  if (nb == 0) return 0;
  q6k_kernel<<<(unsigned)nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// x: f32 [nb * 32]; out: u8 [nb * 34].
extern "C" int tkq_quantize_q80(const float* x, void* out, long long nb, void* stream) {
  if (nb == 0) return 0;
  q80_kernel<<<(unsigned)((nb + 7) / 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint8_t*>(out), nb);
  return (int)cudaGetLastError();
}
