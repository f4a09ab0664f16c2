// attn_in's device code (TPU kernels #2 / #3; see attn_in.cu for what it
// replaces and its bound), shared with layer.cu (#11: the layer's QKV
// phase) and rot.cu (#12: the next layer's QKV phase).
//
// Design: gemv.cuh's tensor-core core (mma.sync bf16 group dots on codes
// moved exactly into bf16, each group's scale and min applied once, all R
// <= 32 rows of the call in one block padded to 8, 16, 24 or 32, the next
// chunk's words loaded before the current one is computed), with the norm
// in front of it as in gate_up.cuh (gv_sumsq, gv_stage_xn: the normalised
// rows staged as bf16 hi + lo).
// - Grid (ceil(n0 / 128) + ceil(n1 / 128), splits): a column block holds
//   128 columns of one slot, so that its epilogue holds every neox rope
//   pair (c, c + head_dim / 2) it ropes: whole heads where head_dim
//   divides 128 (64, 128); otherwise (head_dim a multiple of 16: 96, phi3;
//   256, the gemma family) its first 64 columns are 8 runs of 8 columns
//   from the first halves of the slot's heads, taken in order, and its
//   last 64 their partners head_dim / 2 further on (ai_col): a lane's 8
//   code columns are one contiguous run of the weight either way. At 256
//   block h (head_dim / 128) + q takes columns [64 q, 64 q + 64) of head
//   h's first half and their partners; at 96 a block's 8 runs span two
//   heads and a third of another. The blocks past the qk columns compute
//   wv's columns, unroped.
// - A slot's packed arrays may be a column range of a wider weight: ld0 /
//   ld1 are their row strides in columns (0: the slot's width). So
//   phi3's one fused wqkv [(H + 2 Hkv) hd, D] runs as two slots over the
//   same bytes, qk its first (H + Hkv) hd columns (roped), v the rest.
//   Its 8 warps are 2 across the columns (gemv.cuh's 64 a warp) by 4
//   across the block's chunks, so a warp walks at most a few chunks in
//   turn: at R = 1 each chunk step waits for its loads (about 1 us on the
//   H100), and 256-column blocks of 2 K warps took twice the steps
//   (tools/gemv_sweep.py --attn-in). The K split comes from attn_in_plan
//   (mirrored by ops/attn_in.py:attn_in_plan): kinds and widths only,
//   never R.
// - The splits of one column block form a thread-block cluster along K
//   (cudaLaunchKernelEx, cluster (1, splits, 1), at most 8: portable).
//   Every block takes rms(x) of its rows over the whole row (gv_sumsq in
//   gate_up.cuh's order: the same bits in every block and at any R; a
//   first version exchanged each split's share over distributed shared
//   memory, and its extra cluster barrier cost more than re-reading the
//   row from L2 at decode rows). After the GEMV each block leaves its f32
//   partial tile [rows, 128] in shared memory; after a cluster barrier
//   the ranks share out the block's (row, head) units, and each reads
//   every rank's partials of its units in rank order, adds them, rounds
//   to bf16, adds the f32 bias, ropes in f32 and stores (each thread's
//   first unit's rope and bias values loaded at the start). A second
//   barrier keeps every tile alive until its readers are done. One
//   launch, no workspace, and each sum in an order fixed by the plan, so a
//   row at R rows equals the row alone bit for bit.
// - The int8 folds of the grid variant (#3; AttnInArgs.fold, a run-time
//   flag that applies to the q4 slots: tpu_kquant/ops/pallas_attn_in.py:
//   171-179): a q4 block quantizes its K range of the normalised rows to
//   int8 per 32-group in shared memory (int8.cuh:i8_stage_xn, in place of
//   the bf16 halves) and runs its codes on int8 tensor cores
//   (i8_q4_chunk); the epilogue is the same. Each row is quantized alone.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "gemv.cuh"
#include "int8.cuh"

// Sweep builds (tools/gemv_sweep.py --attn-in; never the library's own
// build): TKQ_AI_SPLITS=s launches s K splits in place of attn_in_plan's.
// gemv.cuh's TKQ_GV_ABLATE applies to the GEMV core here too (3: the code
// and scale loads alone). TKQ_AI_ABLATE (wrong results, for timing): 1 =
// no cluster (a plain launch, each block reads only its own shared
// memory), 2 = no chunk loop (no weight loads), 3 = the launch alone.
#ifndef TKQ_AI_SPLITS
#define TKQ_AI_SPLITS 0
#endif
#ifndef TKQ_AI_ABLATE
#define TKQ_AI_ABLATE 0
#endif

namespace tkq {

struct AttnInArgs {
  const __nv_bfloat16* x;  // [R, D]
  const float* nw;         // [D]
  float eps;
  int qk_kind;             // common.cuh kind code of wqk: KQ4, KQ6W, KQ8 or an F variant
  const uint8_t* qk_qs;    // codes of wqk [.., n0]
  const uint32_t* qk_scl;  // sm / sp pairs, or f32 scales
  const uint32_t* qk_mins; // f32 mins (KQ4F only), else null
  int v_kind;              // the same for wv [.., n1]
  const uint8_t* v_qs;
  const uint32_t* v_scl;
  const uint32_t* v_mins;
  const float* cosv;       // [R, hd/2]
  const float* sinv;       // [R, hd/2]
  const float* bqk;        // [n0] f32 bias of the qk columns, or null
  const float* bv;         // [n1] f32 bias of the v columns, or null
  __nv_bfloat16* out0;     // [R, n0] roped qk
  __nv_bfloat16* out1;     // [R, n1] v
  int R, D, n0, n1, hd;
  int ld0 = 0, ld1 = 0;    // row strides (columns) of wqk's / wv's packed arrays; 0: n0 / n1
  int fold = 0;            // the int8 folds of the q4 slots (int8.cuh)
};

// A block's output columns, its warps across them (64 columns each) and
// across its chunks, and a row of its partial tile in floats
constexpr int AI_TN = 128;
constexpr int AI_WN = 2;
constexpr int AI_WK = 4;
constexpr int AI_TP = AI_TN + 8;
static_assert(AI_WN * AI_WK * 32 == GV_THREADS, "8 warps a block");

// attn_in_plan's constants (ops/attn_in.py mirrors them): the most splits
// (a portable cluster), blocks a wave (two a SM of the H100's 132: the
// kernel's occupancy at up to 16 rows), a block's fixed cost in chunk
// steps (staging, the reduction, the epilogue), the shared memory a block
// may take at 32 rows
constexpr int AI_MAX_SPLITS = 8;
constexpr int AI_WAVE = 2 * 132;
constexpr int AI_BLOCK_CHUNKS = 4;
constexpr size_t AI_SMEM_CAP = 200 * 1024;

// Dynamic shared memory of a block of kind `kind` at NT n-tiles and `cps`
// chunks a split: gemv.cuh's, with the rows staged as two bf16 halves (its
// output tile of 256 columns is more than the partial tile needs).
__host__ inline size_t attn_in_smem(int kind, int NT, int cps) {
  switch (kind) {
    case KQ4: return gemv_smem_bytes<KQ4>(NT, cps, 2);
    case KQ4F: return gemv_smem_bytes<KQ4F>(NT, cps, 2);
    case KQ6W: return gemv_smem_bytes<KQ6W>(NT, cps, 2);
    case KQ6WF: return gemv_smem_bytes<KQ6WF>(NT, cps, 2);
    case KQ8: return gemv_smem_bytes<KQ8>(NT, cps, 2);
    default: return gemv_smem_bytes<KQ8F>(NT, cps, 2);
  }
}

// The K split of attn_in: of the split counts s <= AI_MAX_SPLITS that
// divide both slots' chunks of D, give each of a block's AI_WK K warps a
// chunk and fit shared memory at 32 rows, the one of least cost: waves of
// blocks (AI_WAVE a wave) times the larger slot's chunk steps a warp plus
// AI_BLOCK_CHUNKS (ties: the fewer splits). Kinds and widths only, never
// R. 0 where no split fits.
__host__ inline int attn_in_plan(int qk_kind, int v_kind, int n0, int n1, int D) {
  const int cols = (n0 + AI_TN - 1) / AI_TN + (n1 + AI_TN - 1) / AI_TN;
  const int nq = D / (segments(qk_kind) * CH), nv = D / (segments(v_kind) * CH);
  int best = 0;
  long best_cost = 0;
  for (int s = 1; s <= AI_MAX_SPLITS; ++s) {
    if (nq % s != 0 || nv % s != 0) continue;
    const int cq = nq / s, cv = nv / s;
    if (cq < AI_WK || cv < AI_WK) continue;
    const size_t smem = attn_in_smem(qk_kind, 4, cq) > attn_in_smem(v_kind, 4, cv)
                            ? attn_in_smem(qk_kind, 4, cq)
                            : attn_in_smem(v_kind, 4, cv);
    if (smem > AI_SMEM_CAP) continue;
    const int steps = ((cq > cv ? cq : cv) + AI_WK - 1) / AI_WK;
    const long cost = (long)((cols * s + AI_WAVE - 1) / AI_WAVE) * (steps + AI_BLOCK_CHUNKS);
    if (best == 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// The block's result: its K warps' sums added in warp order 3, 2, 1, 0 in
// the shared tile [8 NT][AI_TP] (row r, block column c). Ends with a
// barrier.
template <int NT>
__device__ void ai_combine(const float (&acc)[NT][4][4], float* tile, int wn, int wk, int g,
                           int t) {
  __syncthreads();  // the tile reuses the staged x
  for (int pass = AI_WK - 1; pass >= 0; --pass) {
    if (wk == pass) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int row = 8 * j + 2 * t, col = wn * 64 + 8 * g + 2 * p;
          float2* t0 = reinterpret_cast<float2*>(tile + row * AI_TP + col);
          float2* t1 = reinterpret_cast<float2*>(tile + (row + 1) * AI_TP + col);
          const float* c = acc[j][p];
          if (pass == AI_WK - 1) {
            *t0 = make_float2(c[0], c[2]);
            *t1 = make_float2(c[1], c[3]);
          } else {
            const float2 u0 = *t0, u1 = *t1;
            *t0 = make_float2(__fadd_rn(c[0], u0.x), __fadd_rn(c[2], u0.y));
            *t1 = make_float2(__fadd_rn(c[1], u1.x), __fadd_rn(c[3], u1.y));
          }
        }
    }
    __syncthreads();
  }
}

// The slot column of block column c (0 .. 127) of column block `tile` at
// head dim hd (see the grid above): whole heads where hd divides AI_TN;
// else run p = 8 tile + (c % 64) / 8 of the slot's first-half runs (hd / 16
// a head) for c < 64, and its partner half a head on for c >= 64.
__device__ __forceinline__ int ai_col(int tile, int c, int hd) {
  if (AI_TN % hd == 0) return tile * AI_TN + c;
  const int runs = hd / 16, p = tile * (AI_TN / 16) + (c % (AI_TN / 2)) / 8;
  return (p / runs) * hd + (c >= AI_TN / 2 ? hd / 2 : 0) + (p % runs) * 8 + c % 8;
}

// One block of the grid: column block `tile` of slot qk (is_qk) or v, K
// split blockIdx.y of the cluster's gridDim.y, for a weight of kind KIND.
template <int KIND, int NT>
__device__ __forceinline__ void attn_in_block(const AttnInArgs& a, bool is_qk, int tile,
                                              uint8_t* smem, float* rstd, float* red) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const auto csync = [&] {
    if constexpr (TKQ_AI_ABLATE == 1) __syncthreads();
    else cluster.sync();
  };
  const auto peer = [&](float* p, int q) {
    if constexpr (TKQ_AI_ABLATE == 1) return p + 0 * q;
    else return cluster.map_shared_rank(p, q);
  };
  constexpr int NSEG = segments(KIND), GPC = gv_gpc<KIND>(), ROWS = 8 * NT;
  const int splits = gridDim.y, rank = blockIdx.y;
  const int N = is_qk ? a.n0 : a.n1, ld = is_qk ? a.ld0 : a.ld1;
  const int cps = n_chunks_of<KIND>(a.D) / splits, c0 = rank * cps;
  const int L = cps * CH, XS = gv_xstride(NSEG * L);
  const uint8_t* qs = is_qk ? a.qk_qs : a.v_qs;
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sums = reinterpret_cast<float*>(smem + (size_t)2 * ROWS * XS * 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wn = warp % AI_WN, wk = warp / AI_WN;
  const int n = ai_col(tile, wn * 64 + 8 * g, a.hd);  // the lane's 8 code columns
  const int ns = n + 2 * t;                       // the 2 columns whose scales it loads
  // the packed arrays' row stride stands in for N in the loads (their
  // bound tests pass: the block's columns lie within the slot)
  const bool al8 = ld % 8 == 0 && (reinterpret_cast<uintptr_t>(qs) & 7) == 0;
  const GemvArgs ga{nullptr, 0, qs, is_qk ? a.qk_scl : a.v_scl, a.R, ld, a.D, cps, nullptr,
                    nullptr, 0, nullptr, is_qk ? a.qk_mins : a.v_mins};
  // the epilogue's units u = rank, rank + splits, ... of the block's R x
  // heads (whole heads; else one unit a row), a pair of block columns (c, c
  // + bh) an item (bh = hd / 2 with whole heads, else 64): slot columns
  // (col = ai_col(c), col + hd / 2), rope frequency col % hd; the thread's
  // first item's rope and bias values load now
  const bool whole = AI_TN % a.hd == 0;
  const int half = a.hd / 2, bh = whole ? half : AI_TN / 2;
  const int heads = whole ? min(AI_TN, N - tile * AI_TN) / a.hd : 1;
  const int units = (a.R * heads - rank + splits - 1) / splits;
  const float* bias = is_qk ? a.bqk : a.bv;
  const auto item = [&](int i, int& r, int& c) {
    const int u = rank + (i / bh) * splits;
    r = u / heads, c = (u % heads) * a.hd + i % bh;  // block column of the first half
  };
  float pre[4] = {0.f, 0.f, 1.f, 0.f};  // bias of the pair's two columns, cos, sin
  if (threadIdx.x < units * bh) {
    int r, c;
    item(threadIdx.x, r, c);
    const int col = ai_col(tile, c, a.hd), f = col % a.hd;
    if (bias != nullptr) pre[0] = bias[col], pre[1] = bias[col + half];
    if (is_qk) pre[2] = a.cosv[(size_t)r * half + f], pre[3] = a.sinv[(size_t)r * half + f];
  }
  // the first chunk's words are in flight while the rows are normalised
  uint2 w[8], sc[4];
  if (TKQ_AI_ABLATE != 2 && wk < cps) gv_load<KIND>(w, sc, ga, c0 + wk, n, ns, t, al8);
  gv_sumsq<NT>(rstd, red, a.x, a.R, a.D, 1, 0, a.D);
  if (threadIdx.x < ROWS)
    rstd[threadIdx.x] = threadIdx.x < a.R ? rsqrtf(rstd[threadIdx.x] / (float)a.D + a.eps) : 0.f;
  __syncthreads();
  // the folds' staging: int8 rows [ROWS][XQS], then the groups' scales
  // and gsums [2 cps][ROWS] each (less than the bf16 halves take)
  const bool fold = is_q4(KIND) && a.fold;
  const int XQS = i8_xqstride(NSEG * L);
  auto* xq = reinterpret_cast<int8_t*>(smem);
  float* sx = reinterpret_cast<float*>(smem + (size_t)ROWS * XQS);
  float* sg = sx + (size_t)NSEG * cps * ROWS;
  if (fold)
    i8_stage_xn<NT>(xq, sx, sg, a.x, a.nw, a.R, a.D, cps, rstd, c0, cps, XQS);
  else
    gv_stage_xn<KIND, NT>(xs, sums, a.x, a.nw, a.R, a.D, cps, rstd, c0, cps, XS);
  float acc[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p][0] = acc[j][p][1] = acc[j][p][2] = acc[j][p][3] = 0.f;
  const __nv_bfloat16* xb = xs + g * XS + 4 * t;
  const float* sb = sums + 2 * t;
  const int chunk_sums = GPC * ROWS;
  for (int lc = wk; lc < (TKQ_AI_ABLATE == 2 ? 0 : cps); lc += AI_WK) {
    uint2 wn2[8], sn[4];
    gv_load<KIND>(wn2, sn, ga, c0 + min(lc + AI_WK, cps - 1), n, ns, t, al8);
    if constexpr (TKQ_GV_ABLATE == 3) {
      uint32_t v = sc[0].x ^ sc[1].y ^ sc[2].x ^ sc[3].y;
#pragma unroll
      for (int i = 0; i < 8; ++i) v ^= w[i].x ^ w[i].y;
      acc[0][0][0] += __uint_as_float(v & 0x007FFFFFu);
    } else if (fold) {
      if constexpr (is_q4(KIND))
        i8_q4_chunk<KIND, NT>(acc, w, sc, xq + g * XQS + 4 * t + lc * CH, XQS, L,
                              sx + lc * ROWS + 2 * t, sg + lc * ROWS + 2 * t, cps * ROWS, lane);
    } else {
      gv_chunk<KIND, NT, true>(acc, w, sc, xb + lc * CH, XS, sb + lc * chunk_sums, L,
                               cps * chunk_sums, lane, (c0 + lc) & 1, ROWS * XS);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = wn2[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = sn[i];
  }
  float* part = reinterpret_cast<float*>(smem);  // [ROWS][AI_TP]: this split's sums
  ai_combine<NT>(acc, part, wn, wk, g, t);
  csync();  // every rank's partial tile is complete

  // the epilogue: each column's sum over the ranks in rank order, bf16, +
  // bias, the half rotation (qk) in f32, bf16
  __nv_bfloat16* out = is_qk ? a.out0 : a.out1;
  for (int i = threadIdx.x; i < units * bh; i += GV_THREADS) {
    int r, c;
    item(i, r, c);
    float p0[AI_MAX_SPLITS], p1[AI_MAX_SPLITS];  // all in flight, then added in rank order
#pragma unroll
    for (int q = 0; q < AI_MAX_SPLITS; ++q) {
      if (q < splits) {
        const float* pq = peer(part, q) + r * AI_TP;
        p0[q] = pq[c], p1[q] = pq[c + bh];
      }
    }
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int q = 0; q < AI_MAX_SPLITS; ++q)
      if (q < splits) y0 += p0[q], y1 += p1[q];
    const int col = ai_col(tile, c, a.hd), f = col % a.hd;
    const bool first = i == threadIdx.x;
    const float b0 = bias == nullptr ? 0.f : first ? pre[0] : bias[col];
    const float b1 = bias == nullptr ? 0.f : first ? pre[1] : bias[col + half];
    y0 = round_bf16(y0) + b0;
    y1 = round_bf16(y1) + b1;
    if (is_qk) {
      const float cs = first ? pre[2] : a.cosv[(size_t)r * half + f];
      const float sn = first ? pre[3] : a.sinv[(size_t)r * half + f];
      const float o0 = __fsub_rn(__fmul_rn(y0, cs), __fmul_rn(y1, sn));
      const float o1 = __fadd_rn(__fmul_rn(y1, cs), __fmul_rn(y0, sn));
      y0 = o0, y1 = o1;
    }
    out[(size_t)r * N + col] = __float2bfloat16_rn(y0);
    out[(size_t)r * N + col + half] = __float2bfloat16_rn(y1);
  }
  csync();  // no rank leaves while another reads its tile
}

// grid (ceil(n0 / 128) + ceil(n1 / 128), splits), cluster (1, splits, 1);
// GV_THREADS threads; dynamic smem: the larger slot's attn_in_smem. R <= 8
// NT. The slot's kind is uniform over a cluster, so the switch does not
// diverge and every rank reaches the same barriers.
template <int NT>
__global__ void __launch_bounds__(GV_THREADS, NT <= 2 ? 2 : 1) attn_in_kernel(AttnInArgs a) {
  // a programmatic dependent (layer.cu's attention) may start now: it waits
  // for this grid's end before it reads qk / v
  asm volatile("griddepcontrol.launch_dependents;");
  if constexpr (TKQ_AI_ABLATE == 3) return;
  extern __shared__ __align__(16) uint8_t ai_smem[];
  __shared__ float rstd[8 * NT], red[8 * NT * (GV_THREADS / 32)];
  const int tiles0 = (a.n0 + AI_TN - 1) / AI_TN;
  const bool is_qk = blockIdx.x < tiles0;
  const int tile = is_qk ? blockIdx.x : blockIdx.x - tiles0;
  switch (is_qk ? a.qk_kind : a.v_kind) {
    case KQ4: attn_in_block<KQ4, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
    case KQ4F: attn_in_block<KQ4F, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
    case KQ6W: attn_in_block<KQ6W, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
    case KQ6WF: attn_in_block<KQ6WF, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
    case KQ8: attn_in_block<KQ8, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
    default: attn_in_block<KQ8F, NT>(a, is_qk, tile, ai_smem, rstd, red); break;
  }
}

template <int NT>
cudaError_t launch_attn_in_nt(const AttnInArgs& a, int splits, cudaStream_t st) {
  const int cq = a.D / (segments(a.qk_kind) * CH) / splits;
  const int cv = a.D / (segments(a.v_kind) * CH) / splits;
  const size_t sq = attn_in_smem(a.qk_kind, NT, cq), sv = attn_in_smem(a.v_kind, NT, cv);
  const size_t smem = sq > sv ? sq : sv;
  cudaError_t e = cudaFuncSetAttribute(attn_in_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n0 + AI_TN - 1) / AI_TN + (a.n1 + AI_TN - 1) / AI_TN, splits, 1);
  cfg.blockDim = dim3(GV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = TKQ_AI_ABLATE == 1 ? 0 : 1;
  e = cudaLaunchKernelEx(&cfg, attn_in_kernel<NT>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launches attn_in for R <= 32 rows (one n-tile of 8 rows per 8 rows of R)
// at the split of attn_in_plan. Requires D % 512 == 0, n0 and n1 multiples
// of 128 and of hd, 128 % hd == 0 or hd % 16 == 0, row strides ld0 >= n0
// and ld1 >= n1 (0: n0, n1) that keep the code and scale loads aligned
// (multiples of 4), 16-byte aligned rows of x and the norm weight.
inline cudaError_t launch_attn_in(const AttnInArgs& args, cudaStream_t st) {
  AttnInArgs a = args;
  if (a.ld0 == 0) a.ld0 = a.n0;
  if (a.ld1 == 0) a.ld1 = a.n1;
  if (a.ld0 < a.n0 || a.ld1 < a.n1 || a.ld0 % 4 != 0 || a.ld1 % 4 != 0)
    return cudaErrorInvalidValue;
  const int splits = TKQ_AI_SPLITS > 0 ? TKQ_AI_SPLITS
                                       : attn_in_plan(a.qk_kind, a.v_kind, a.n0, a.n1, a.D);
  const int nq = a.D / (segments(a.qk_kind) * CH), nv = a.D / (segments(a.v_kind) * CH);
  if (splits < 1 || splits > AI_MAX_SPLITS || nq % splits != 0 || nv % splits != 0 ||
      nq / splits < AI_WK || nv / splits < AI_WK || a.R < 1)
    return cudaErrorInvalidValue;
  if (a.hd < 2 || a.hd % 2 != 0 || (AI_TN % a.hd != 0 && a.hd % 16 != 0) ||
      a.n0 % a.hd != 0 || a.n1 % a.hd != 0 || a.n0 % AI_TN != 0 || a.n1 % AI_TN != 0)
    return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.nw)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  switch ((a.R + 7) / 8) {
    case 1: return launch_attn_in_nt<1>(a, splits, st);
    case 2: return launch_attn_in_nt<2>(a, splits, st);
    case 3: return launch_attn_in_nt<3>(a, splits, st);
    case 4: return launch_attn_in_nt<4>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tkq
