// qmm: y[R, N] = x[R, K] @ dequant(W)^T for packed q4 and q6w weights, with
// bf16 scale pairs (sm / sp) or f32 scales (q4: scales + mins; q6w: scales).
//
// Replaces the TPU kernel tpu_kquant/ops/pallas_qmm.py:qmm_pallas
// (_qmm_call, kernel body _qmm_kernel), which streams the packed bytes once
// and dequantizes them in VMEM tiles for the MXU.
//
// Two paths, chosen by the row count like the reference's tiles:
// - R <= 32 (decode; the lm head on the main path): memory bound. At
//   3.35 TB/s the lm head [32000, 2048] q6w-sp (73.7 MB) takes at least
//   22 us. The split-K GEMV core of common.cuh reads every packed byte once,
//   coalesced, and unpacks both nibble folds of a q4 byte from one load.
// - R > 32 (prefill; every projection): compute bound at R = 512
//   (2 R K N flops over 989 TFLOP/s bf16). A 128 x 128 output tile per
//   block: each 32-row chunk of packed W is dequantized into shared memory as
//   bf16 (both folds of a q4 chunk at once, so a packed byte is read once per
//   tile), the matching x columns are staged as bf16, and eight warps
//   multiply them with bf16 WMMA (mma.sync) into f32 accumulators.
//   Single-buffered: TMA / wgmma pipelines are later work.
// The f32-scale layouts (scale_dtype='f32', as the int8 path loads them) have
// twice the side-array bytes of the pairs: 0.75 bytes per q4 weight instead
// of 0.625, 1.25 per q6w weight instead of 1.125. Mixtral-8x7B's expert down
// [4096, 14336] q6w-f32 (73.4 MB) bounds the R = 1 GEMV at 21.9 us. N needs
// only be a multiple of 4 (the router's N = 8): the tile masks its ragged
// column edge.
#include <mma.h>

#include "common.cuh"

namespace tkq {

constexpr int BM = 128, BN = 128, BK = CH;
constexpr int LDX = BK + 8;  // bf16 row pitch of the x tile (16-byte multiple)
constexpr int LDW = BN + 8;  // bf16 row pitch of the weight tile

template <int KIND>
__global__ void __launch_bounds__(THREADS) mma_kernel(const void* x, int x_f32, const uint8_t* qs,
                                                      const uint32_t* scl, const uint32_t* mins,
                                                      void* out, int out_f32, int R, int N,
                                                      int K) {
  using namespace nvcuda;
  constexpr int NF = is_q4(KIND) ? 2 : 1;  // folds per packed chunk
  __shared__ __align__(32) __nv_bfloat16 xt[NF][BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 wt[NF][BK * LDW];
  __shared__ __align__(32) float ct[WARPS][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // warp's 32 x 64 sub-tile
  const int n_chunks = (is_q4(KIND) ? K / 2 : K) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // x tile: thread -> row tid / 2, 16 columns at (tid % 2) * 16
  const int xr = tid / 2, xc = (tid % 2) * 16;
  // weight tile: thread -> packed row tid / 8, 16 columns at (tid % 8) * 16;
  // past the N edge a 4-column word is zero (N % 4 == 0), and with N % 16 != 0
  // rows are not 16-byte aligned, so the codes are read a word at a time
  const int wr = tid / 8, wc = (tid % 8) * 16;
  const bool w_vec = N % 16 == 0 && n0 + wc + 16 <= N;

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // previous chunk's tiles are consumed
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int kb = (f == 0 ? 0 : K / 2) + c * BK + xc;
      __nv_bfloat16* dst = &xt[f][xr * LDX + xc];
      if (m0 + xr < R) {
        const size_t o = (size_t)(m0 + xr) * K + kb;
        if (x_f32) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            dst[e] = __float2bfloat16_rn(static_cast<const float*>(x)[o + e]);
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + o);
          reinterpret_cast<uint4*>(dst)[0] = __ldg(src);
          reinterpret_cast<uint4*>(dst)[1] = __ldg(src + 1);
        }
      } else {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
      }
    }
    // dequantize 16 columns of packed row c * BK + wr
    const uint8_t* wrow = qs + ((size_t)c * BK + wr) * N + n0 + wc;
    uint32_t bw[4] = {0u, 0u, 0u, 0u};
    if (w_vec) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(wrow));
      bw[0] = b.x, bw[1] = b.y, bw[2] = b.z, bw[3] = b.w;
    } else {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        if (n0 + wc + q4 * 4 < N) bw[q4] = __ldg(reinterpret_cast<const uint32_t*>(wrow) + q4);
    }
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {  // 4 columns per scale load
      const int col = n0 + wc + q4 * 4;
      ChunkScales<KIND> cs;
      cs.load(scl, mins, N, K, c, col, col < N);
      float s0[4], m0[4], s1[4], m1[4];
      cs.decode(s0, m0, s1, m1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (bw[q4] >> (8 * j)) & 0xFFu;
        const int cj = wc + q4 * 4 + j;
        if constexpr (is_q4(KIND)) {
          const float lo = (float)(byte & 0xFu), hi = (float)(byte >> 4);
          wt[0][wr * LDW + cj] = __float2bfloat16_rn(s0[j] * lo - m0[j]);
          wt[1][wr * LDW + cj] = __float2bfloat16_rn(s1[j] * hi - m1[j]);
        } else {
          const float q = (float)(int8_t)byte;
          wt[0][wr * LDW + cj] = __float2bfloat16_rn((wr < BK / 2 ? s0[j] : s1[j]) * q);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &xt[f][(wm + i * 16) * LDX + kk], LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], &wt[f][kk * LDW + wn + j * 16], LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }

  // epilogue: each 16 x 16 accumulator through the warp's staging tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(ct[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + wm + i * 16 + e / 16, col = n0 + wn + j * 16 + e % 16;
        if (r < R && col < N) store_out(out, out_f32, (size_t)r * N + col, ct[warp][e], nullptr);
      }
      __syncwarp();
    }
}

template <int KIND>
cudaError_t launch_qmm(const void* x, int x_f32, const uint8_t* qs, const uint32_t* scl,
                       const uint32_t* mins, void* out, int out_f32, float* ws, int R, int N,
                       int K, int cps, int splits, cudaStream_t st) {
  if (R <= 32) {
    GemvArgs a{x, x_f32, qs, scl, R, N, K, cps, ws, out, out_f32, nullptr, mins};
    return launch_gemv<KIND>(a, splits, st);
  }
  dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  mma_kernel<KIND><<<grid, THREADS, 0, st>>>(x, x_f32, qs, scl, mins, out, out_f32, R, N, K);
  return cudaGetLastError();
}

}  // namespace tkq

using namespace tkq;

// kind: 0 = q4 with sm pairs, 1 = q6w with sp pairs, 2 = q4 with f32 scales
// and mins, 3 = q6w with f32 scales (mins: null except for kind 2). R <= 32
// takes the GEMV path with `splits` K splits of `cps` chunks each (ws holds
// splits * R * N floats when splits > 1); R > 32 takes the tiled WMMA path.
// N % 4 == 0. Returns the CUDA error code of the launches (0 on success).
extern "C" int tkq_qmm(int kind, const void* x, int x_f32, const void* qs, const void* scl,
                       const void* mins, void* out, int out_f32, float* ws, int R, int N, int K,
                       int cps, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const uint32_t* s = static_cast<const uint32_t*>(scl);
  const uint32_t* m = static_cast<const uint32_t*>(mins);
  switch (kind) {
    case KQ4:
      return (int)launch_qmm<KQ4>(x, x_f32, q, s, m, out, out_f32, ws, R, N, K, cps, splits, st);
    case KQ6W:
      return (int)launch_qmm<KQ6W>(x, x_f32, q, s, m, out, out_f32, ws, R, N, K, cps, splits, st);
    case KQ4F:
      return (int)launch_qmm<KQ4F>(x, x_f32, q, s, m, out, out_f32, ws, R, N, K, cps, splits, st);
    case KQ6WF:
      return (int)launch_qmm<KQ6WF>(x, x_f32, q, s, m, out, out_f32, ws, R, N, K, cps, splits,
                                    st);
    default: return (int)cudaErrorInvalidValue;
  }
}
