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
//   22 us; q8-sp (69.6 MB) 20.8 us. The split-K GEMV core of common.cuh
//   reads every packed byte once, coalesced: a q4 byte's two nibble folds
//   from one load, a bit-plane chunk's qh words once for all its segments.
// - R > 32 (prefill; every projection): compute bound at R = 512
//   (2 R K N flops over 989 TFLOP/s bf16). A 128 x 128 output tile per
//   block: each 32-row chunk of packed W is dequantized into shared memory as
//   bf16 (both folds of a q4 chunk at once, so a packed byte is read once per
//   tile; a bit-plane kind one natural-order 32-row slice at a time, its
//   qs / qh bytes read once per segment they hold), the matching x columns
//   are staged as bf16, and eight warps multiply them with bf16 WMMA
//   (mma.sync) into f32 accumulators. Single-buffered: TMA / wgmma pipelines
//   are later work.
// The f32-scale layouts (scale_dtype='f32', as the int8 path loads them) have
// twice the side-array bytes of the pairs: 0.75 bytes per q4 weight instead
// of 0.625, 1.25 per q6w weight instead of 1.125. Mixtral-8x7B's expert down
// [4096, 14336] q6w-f32 (73.4 MB) bounds the R = 1 GEMV at 21.9 us. N needs
// only be a multiple of 4 (the router's N = 8): the tile masks its ragged
// column edge.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace tkq {

constexpr int BM = 128, BN = 128, BK = CH;
constexpr int LDX = BK + 8;  // bf16 row pitch of the x tile (16-byte multiple)
constexpr int LDW = BN + 8;  // bf16 row pitch of the weight tile

template <int KIND>
__global__ void __launch_bounds__(THREADS) mma_kernel(const void* x, int x_f32, const uint8_t* qs,
                                                      const uint8_t* qh, const uint32_t* scl,
                                                      const uint32_t* mins, void* out,
                                                      int out_f32, int R, int N, int K) {
  using namespace nvcuda;
  constexpr int NF = is_q4(KIND) ? 2 : 1;  // folds per packed chunk
  __shared__ __align__(32) __nv_bfloat16 xt[NF][BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 wt[NF][BK * LDW];
  __shared__ __align__(32) float ct[WARPS][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // warp's 32 x 64 sub-tile
  // the bit-plane kinds walk K in natural order, one 32-row tile at a time
  const int n_chunks = is_plane(KIND) ? K / BK : n_chunks_of<KIND>(K);

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
    if constexpr (is_plane(KIND)) {
      // dequantize 16 columns of row k = c * BK + wr: segment seg = k / S at
      // segment-local row rr lives in qs row t * S + rr (field p) and qh row rr
      constexpr int NT = plane_nt(KIND);
      const int S = K / segments(KIND);
      const int k = c * BK + wr, seg = k / S, rr = k % S;
      const int t = seg % NT, p = seg / NT;
      uint32_t bw[4] = {0u, 0u, 0u, 0u}, bh[4] = {0u, 0u, 0u, 0u};
      const uint8_t* wrow = qs + ((size_t)t * S + rr) * N + n0 + wc;
      const uint8_t* hrow = qh + (size_t)rr * N + n0 + wc;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        if (n0 + wc + q4 * 4 < N) {
          bw[q4] = __ldg(reinterpret_cast<const uint32_t*>(wrow) + q4);
          if constexpr (plane_hb(KIND) > 0)
            bh[q4] = __ldg(reinterpret_cast<const uint32_t*>(hrow) + q4);
        }
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int col = n0 + wc + q4 * 4;
        float sc[4], mn[4];
        group_scales<KIND>(scl, mins, N, k / group_rows(KIND), col, col < N, sc, mn);
        const uint32_t codes = plane_codes<KIND>(bw[q4], bh[q4], p, seg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = (float)((codes >> (8 * j)) & 0xFFu);
          wt[0][wr * LDW + wc + q4 * 4 + j] = __float2bfloat16_rn(sc[j] * q - mn[j]);
        }
      }
    } else {
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
        if (r < R && col < N) store_out(out, out_f32, (size_t)r * N + col, ct[warp][e], nullptr, 0);
      }
      __syncwarp();
    }
}

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
};

template <int KIND>
cudaError_t launch_qmm(const QmmArgs& q, cudaStream_t st) {
  if (q.R <= 32) {
    GemvArgs a{q.x, q.x_f32, q.qs, q.scl, q.R, q.N, q.K, q.cps, q.ws, q.out, q.out_f32, nullptr,
               q.mins, q.qh};
    return launch_gemv<KIND>(a, q.splits, st);
  }
  dim3 grid((q.N + BN - 1) / BN, (q.R + BM - 1) / BM);
  mma_kernel<KIND><<<grid, THREADS, 0, st>>>(q.x, q.x_f32, q.qs, q.qh, q.scl, q.mins, q.out,
                                             q.out_f32, q.R, q.N, q.K);
  return cudaGetLastError();
}

// the C entry point's arguments, as QmmArgs
inline QmmArgs qmm_args(const void* x, int x_f32, const void* qs, const void* qh,
                        const void* scl, const void* mins, void* out, int out_f32, float* ws,
                        int R, int N, int K, int cps, int splits) {
  return QmmArgs{x, x_f32, static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                 static_cast<const uint32_t*>(scl), static_cast<const uint32_t*>(mins), out,
                 out_f32, ws, R, N, K, cps, splits};
}

}  // namespace tkq
