"""qmm: y = x @ dequant(W)^T over packed weights of every kind the loader
makes: q4, q6w and q8, and the bit-plane kinds q5, q6 (unwidened), q3 and
q2, each with bf16 scale pairs (``sm`` for the kinds with mins, ``sp`` for
q6w and q8: ``scale_dtype='bf16'``) or f32 scales (``scales``, and ``mins``
for the kinds with mins: ``scale_dtype='f32'``).

Kernels: ``csrc/qmm.cuh``, built as ``csrc/qmm.cu`` (q4, q6w, q8),
``csrc/qmm_q56.cu`` (q5, q6) and ``csrc/qmm_q23.cu`` (q3, q2) (replaces
``tpu_kquant/ops/pallas_qmm.py:qmm_pallas``). Rows <= 32 take the
tensor-core GEMV of ``csrc/gemv.cuh`` (memory bound: every packed byte read
once, whatever the row count; f32 activations rounded to bf16 on the way
into shared memory; its K split from ``gemv_plan``, which never looks at
the row count, so a row's result is the same bits at any R <= 32); more
rows take the
pipelined wgmma tile of ``csrc/qmm_tile.cuh`` (compute bound at prefill),
on bf16 activations (f32 ones are rounded to bf16 first, as the reference's
kernel rounds them for its MXU), with the tile and K split of
``tile_plan``. N must be a multiple of 4 (a MoE router has N = n_experts). K
must be a multiple of 256 for the bit-plane kinds (their high planes switch
every K/8 or K/4 packed rows, and the reference's ``pallas_supported`` asks
the same), of 64 for q4 and for q8 on bf16 pairs, of 32 for q6w and for q8
on f32 scales; any other K raises on the card.

``qmm_plain`` is the same function in plain PyTorch: dequantize, then one
matmul in f32. Its compute dtype follows the activations, like the
reference's XLA path: bf16 activations meet bf16-rounded weights, f32
activations f32 weights. The kernel instead rounds f32 activations (qwen2's
prefill past the bias add) and the weights to bf16, as the reference's
kernel does for its MXU (``pallas_qmm.py:_qmm_kernel``). The plain version
does not follow it there, because it is the CPU path the tests hold against
the reference's XLA engine; the two differ by one bf16 rounding of each
factor (about 2^-8 of a term, summed with random signs), well inside the
2e-2 of max|ref| that the kernel is held to. ``qmm`` runs the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

counter = _build.LaunchCounter("qmm")

# kind code -> (kind, side arrays): csrc/common.cuh's legend. "sm": bf16
# (scale, min) pairs; "sp": bf16 scale pairs of adjacent groups; "f32": f32
# scales (and mins for the kinds with mins).
KINDS = (("q4", "sm"), ("q6w", "sp"), ("q4", "f32"), ("q6w", "f32"), ("q8", "sp"), ("q8", "f32"),
         ("q5", "sm"), ("q5", "f32"), ("q6", "sm"), ("q6", "f32"), ("q3", "sm"), ("q3", "f32"),
         ("q2", "sm"), ("q2", "f32"))
KIND_CODE = {kl: code for code, kl in enumerate(KINDS)}
# K segments of each kind (common.cuh:segments): a chunk of 32 packed rows
# covers 32 elements of every segment
SEGMENTS = {"q4": 2, "q6w": 1, "q8": 1, "q5": 8, "q6": 4, "q3": 8, "q2": 4}
_MINS = ("q4", "q5", "q6", "q3", "q2")  # the kinds whose dequant subtracts a min
# the bit-plane kinds and their libraries (the other kinds: csrc/qmm.cu)
_PLANE_LIBRARY = {"q5": "qmm_q56", "q6": "qmm_q56", "q3": "qmm_q23", "q2": "qmm_q23"}
GEMV_MAX_ROWS = 32
_SMEM_CAP = 200 * 1024
# the wgmma tile (csrc/qmm_tile.cuh): output columns a block, logical K rows
# a pipeline step, the H100's SMs; tile_plan's cost model, fitted to a sweep
# of block heights and splits on the H100 (PERF.md §6, PR 11): a step's time
# (us) at each block height, a block's fill and epilogue in steps, the rate
# (bytes / us) at which split partials make their round trip (refitted to
# the tile A/B of PERF.md §6: at R = 1024 and 2048 the partials of wo and
# down moved at ~2.5 TB/s, most of them through device memory), the least
# steps a split takes, the most bytes of partials a call writes
TILE_BN = 128
TILE_BK = 64
SMS = 132
STEP_US = {128: 1.0, 256: 1.35}
FILL_STEPS = 2
PARTIAL_BYTES_PER_US = 2.5e6
MIN_SPLIT_STEPS = 2
WS_CAP = 64 << 20
# the GEMV (csrc/gemv.cuh): output columns a block, floats a row of its
# output tile; gemv_plan's blocks a wave (two a SM: the kernel's occupancy
# at up to 16 rows), a block's fixed cost in chunks (staging x, the
# reduction, the store) and a split's cost per output column, fitted to
# tools/gemv_sweep.py --plan on the H100 (PERF.md §6): a wave of 264
# blocks x one chunk moves ~2.4 MB of packed bytes, a split's partials at
# 32 rows 256 N bytes
GEMV_TN = 256
GEMV_TP = GEMV_TN + 8
GEMV_WAVE = 2 * SMS
GEMV_BLOCK_CHUNKS = 4
GEMV_SPLIT_COST = 1 / 4096
_P = ctypes.c_void_p
_I = ctypes.c_int
#           kind x  x_f32 qs  qh  scl mins out out_f32 ws R   N   K   cps splits mw stream
_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P]


def qmm_plain(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: dequantize W^T [K, N], multiply in f32."""
    out_dtype = out_dtype or x.dtype
    cdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    w = dequant_kmajor(qt, dtype=cdt).float()
    return (x.to(cdt).float() @ w).to(out_dtype)


def kernel_kind(qt: QTensor) -> int | None:
    """The kernel's kind code for ``qt``, or None if it reads another layout."""
    if qt.layout != "kmajor" or qt.fold != 1 or len(qt.shape) != 2 or qt.kind not in SEGMENTS:
        return None
    a = qt.arrays
    if "sm" in a and qt.kind in _MINS:
        side = "sm"
    elif "sp" in a and qt.kind in ("q6w", "q8"):
        side = "sp"
    elif "scales" in a and ("mins" in a) == (qt.kind in _MINS):
        side = "f32"
    else:
        return None
    return KIND_CODE[(qt.kind, side)]


def k_ok(code: int, K: int) -> bool:
    """Whether the kernels take depth K for kind ``code`` (module docstring)."""
    kind, side = KINDS[code]
    if kind in _PLANE_LIBRARY:
        return K % 256 == 0
    return K % (64 if kind == "q4" or (kind == "q8" and side == "sp") else 32) == 0


def packed_arrays(qt: QTensor, what: str, strided: bool = False) -> tuple[int, list]:
    """(kind code, [qs, qh, scales, mins]) of a kmajor weight the kernels
    read (qh / mins None where the kind has none), after checking every
    array's dtype, shape and contiguity; raises NotImplementedError for a
    kind or layout the kernels do not read and ValueError for a K they do
    not take. ``strided``: the arrays may instead be column ranges of a
    wider weight's (attn_in's slots of phi3's wqkv, attn_in.qkv_slots):
    contiguous rows, one row stride (``row_stride``) for all of them."""
    code = kernel_kind(qt)
    if code is None:
        raise NotImplementedError(
            f"{what}: the kernels read kmajor {sorted(SEGMENTS)} weights (bf16 pairs or f32 "
            f"scales), not {qt.kind} {qt.layout} with {sorted(qt.arrays)}")
    kind, side = KINDS[code]
    N, K = (int(d) for d in qt.shape)
    req = _build.require
    req(k_ok(code, K) and N % 4 == 0, f"{what}: shape (N={N}, K={K}) of kind {kind}-{side}")
    a = qt.arrays
    qs_rows = K if kind in ("q6w", "q8") else K // 2 if kind in ("q4", "q5", "q6") else K // 4
    qh_rows = {"q5": K // 8, "q3": K // 8, "q6": K // 4}.get(kind)
    groups = K // GROUP_SIZE[kind]
    scl = a[{"sm": "sm", "sp": "sp", "f32": "scales"}[side]]
    mins = a["mins"] if side == "f32" and kind in _MINS else None
    qh = a["qh"] if qh_rows else None
    req(a["qs"].dtype == (torch.int8 if kind in ("q6w", "q8") else torch.uint8)
        and a["qs"].shape == (qs_rows, N), f"{what}: codes of {kind}")
    req(qh is None or (qh.dtype == torch.uint8 and qh.shape == (qh_rows, N)),
        f"{what}: high bit plane of {kind}")
    side_rows = groups // 2 if side == "sp" else groups
    req(all(t.dtype == torch.float32 and t.shape == (side_rows, N)
            for t in (scl, mins) if t is not None), f"{what}: side arrays of {kind}-{side}")
    arrs = [a["qs"], qh, scl, mins]
    ld = row_stride(arrs[0]) if strided else N
    req(all(t.device == arrs[0].device and row_stride(t) == ld and ld % 4 == 0
            for t in arrs if t is not None),
        f"{what}: packed arrays must be contiguous on one device")
    return code, arrs


def row_stride(t: torch.Tensor) -> int:
    """The row stride, in elements, of a 2-D array whose rows are
    contiguous; -1 for any other layout."""
    if t.dim() != 2 or (t.stride(1) != 1 and t.shape[1] > 1) or t.stride(0) < t.shape[1]:
        return -1
    return t.stride(0)


def gemv_smem_bytes(code: int, cps: int, R: int, int8: bool = False, halves: int = 1) -> int:
    """Dynamic shared memory of the GEMV kernel at ``cps`` chunks a split and
    R rows (csrc/gemv.cuh gemv_smem_bytes; int8: csrc/int8.cuh
    int8_smem_bytes): the staged activations of 8 ceil(R / 8) rows (bf16
    rows of a multiple of 64 plus 16 elements, ``halves`` copies of them:
    csrc/gate_up.cuh stages two; int8: of 128 plus 16 bytes) and each scale
    group's sums (int8: its scales and gsums), or the block's f32 output
    tile, whichever is larger."""
    kind = KINDS[code][0]
    seg, gpc = SEGMENTS[kind], 32 // GROUP_SIZE[kind]
    rows = 8 * -(-R // 8)
    span = seg * cps * 32
    if int8:
        staged = rows * (-(-span // 128) * 128 + 16) + 2 * seg * cps * gpc * rows * 4
    else:
        staged = halves * rows * (-(-span // 64) * 64 + 16) * 2 + seg * cps * gpc * rows * 4
    return max(staged, rows * GEMV_TP * 4)


@functools.lru_cache(maxsize=None)
def gemv_plan(code: int, N: int, K: int, int8: bool = False, halves: int = 1,
              split_cost: float = GEMV_SPLIT_COST) -> tuple[int, int]:
    """(chunks per split, splits) of the GEMV's K range (csrc/gemv.cuh; int8:
    qmm_int8's kernel), from the kind, N and K alone: never from the row
    count, so that a row's sums are taken in the same order whatever the
    other rows of the call (a served stream's tokens do not depend on the
    batch). A block covers GEMV_TN columns and a K range of ``cps`` 32-row
    chunks; of the splits whose blocks fit shared memory at 32 rows and give
    each of the block's two K warps a chunk, the one with the fewest chunks
    a block over the card's waves (GEMV_WAVE blocks: two a SM, so that at
    up to 16 rows twice the loads are in flight; at 32 rows, one block a
    SM, such a plan runs two waves of half the chunks), counting
    GEMV_BLOCK_CHUNKS of fixed cost a block and GEMV_SPLIT_COST N chunks a
    split for the partials' round trip. ``halves``: gemv_smem_bytes's;
    ``split_cost``: that round trip's cost (both set by the gate/up phase's
    plan, ops/ffn.py:gate_up_plan)."""
    kind = KINDS[code][0]
    n_chunks = K // (32 * SEGMENTS[kind])
    tiles = -(-N // GEMV_TN)
    best = None
    for s in range(1, n_chunks + 1):
        cps = -(-n_chunks // s)
        if -(-n_chunks // cps) != s or (s > 1 and cps < 2):
            continue  # another s gives this cps; or a K warp without a chunk
        if gemv_smem_bytes(code, cps, GEMV_MAX_ROWS, int8, halves) > _SMEM_CAP:
            continue
        cost = -(-tiles * s // GEMV_WAVE) * (cps + GEMV_BLOCK_CHUNKS) + split_cost * N * s
        if best is None or cost < best[0]:
            best = (cost, cps, s)
    _build.require(best is not None, f"gemv_plan: no split of K={K} fits ({KINDS[code]})")
    return best[1], best[2]


def plan_cost(bm: int, tiles: int, n_steps: int, sps: int, R: int, N: int) -> float:
    """tile_plan's model of a call's time (us): waves of blocks (a wave: one
    block per SM) times a block's steps of ``sps`` (at most ``n_steps``)
    plus its fill, at bm's step time, plus the f32 partials' round trip
    where K is split."""
    splits = -(-n_steps // sps)
    waves = -(-tiles * splits // SMS)
    partials = splits * R * N * 8 / PARTIAL_BYTES_PER_US if splits > 1 else 0.0
    return waves * (min(sps, n_steps) + FILL_STEPS) * STEP_US[bm] + partials


# the row counts tile_split weighs a K split at: a lone 64-token prompt,
# pp512, the 16 x 64 burst and the 1024-slot tick, pp2048
TILE_REF_ROWS = (64, 512, 1024, 2048)


def _tile_best(R: int, N: int, n_steps: int, sps: int) -> tuple[float, int]:
    """(cost, bm) of the cheaper block height at R rows and ``sps`` steps a
    split (the taller block on a tie)."""
    cols = -(-N // TILE_BN)
    return min((plan_cost(bm, cols * -(-R // bm), n_steps, sps, R, N), -bm)
               for bm in (256, 128))


@functools.lru_cache(maxsize=None)
def tile_split(N: int, K: int, code: int) -> int:
    """Steps per split of the wgmma tile's K range, from the kind, N and K
    alone: never from the row count, so that a row's sums are taken in the
    same order whatever the other rows of the call (rows [64 i, 64 i + 64)
    of a burst of k 64-token prompts equal the 64-row call of the same rows,
    bit for bit). Of the runs of at least MIN_SPLIT_STEPS steps (for the
    bit-plane kinds whole packed chunks: SEGMENTS / 2 steps) and the whole
    K, the one whose plan_cost summed over the row counts of TILE_REF_ROWS
    (one call at each, at its faster block height) is least: the least
    time over a lone prompt, pp512, the burst and pp2048 (fewer splits on a
    tie)."""
    kind = KINDS[code][0]
    n_steps = -(-K // TILE_BK)
    unit = SEGMENTS[kind] // 2 if kind in _PLANE_LIBRARY else 1
    runs = {n_steps} | {r for r in (-(-(-(-n_steps // s)) // unit) * unit
                                    for s in range(2, n_steps + 1)) if r >= MIN_SPLIT_STEPS}
    return min(runs, key=lambda r: (sum(_tile_best(R, N, n_steps, r)[0] for R in TILE_REF_ROWS),
                                    -r))


def tile_plan(R: int, N: int, K: int, code: int) -> tuple[int, int, int, int]:
    """(bm, bn, splits, steps per split) of the wgmma tile at R > 32 rows.

    A block computes bm x 128 outputs (bm = 128, or 256: two warpgroups of
    128 rows, each dequantized weight serving twice the rows at 1.35x the
    step time) over a K range of 64-row steps (csrc/qmm_tile.cuh: ceil(K /
    64) steps). The K split is tile_split's, the same at every R; the block
    height, which only changes which rows share a block, is the one
    plan_cost ranks faster at R (the taller on a tie)."""
    sps = tile_split(N, K, code)
    n_steps = -(-K // TILE_BK)
    bm = -_tile_best(R, N, n_steps, sps)[1]
    return bm, TILE_BN, -(-n_steps // sps), sps


def tile_chunks(R: int, N: int, splits: int) -> list[tuple[int, int]]:
    """(first row, rows) of each tile launch of an R-row call: one launch,
    or, where the f32 partials of ``splits`` K splits would pass WS_CAP
    bytes, turns of at most that many rows (a multiple of 256, at least
    256), the last two evened out where the last would hold 32 rows or
    fewer (the GEMV's). A row's sums do not depend on its turn."""
    step = R if splits == 1 else max(256, WS_CAP // (splits * N * 4) // 256 * 256)
    out = [(r0, min(step, R - r0)) for r0 in range(0, R, step)]
    if len(out) > 1 and out[-1][1] <= GEMV_MAX_ROWS:
        (a, n), (_, m) = out[-2], out.pop()
        out[-1:] = [(a, (n + m) // 2), (a + (n + m) // 2, n + m - (n + m) // 2)]
    return out


def qmm(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ W^T for a kmajor weight W (N, K)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return qmm_plain(x, qt, out_dtype)
    req = _build.require
    if kernel_kind(qt) is not None:  # else packed_arrays names the kind it refuses
        req(x.device.type == "cuda", f"qmm: unsupported device {x.device}")
    code, (qs, qh, scl, mins) = packed_arrays(qt, "qmm")
    N, K = qt.shape
    req(x.shape[-1] == K, f"qmm: x has {x.shape[-1]} features, W has K={K}")
    req(x.dtype in (torch.bfloat16, torch.float32), f"qmm: x dtype {x.dtype}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"qmm: out dtype {out_dtype}")
    req(qs.device == x.device, "qmm: packed arrays must be on x's device")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K).contiguous()
    R = x2d.shape[0]
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    if R == 0:
        return out.reshape(*lead, N)
    if R <= GEMV_MAX_ROWS:
        (cps, splits), mw = gemv_plan(code, N, K), 0
    else:  # the tile reads bf16 rows through TMA: 16-byte aligned
        _, _, splits, cps = tile_plan(R, N, K, code)
        x2d = x2d.to(torch.bfloat16)
        if x2d.data_ptr() % 16:
            x2d = x2d.clone()
    lib = _build.load(_PLANE_LIBRARY.get(KINDS[code][0], "qmm"), "tkq_qmm", _ARGTYPES)
    P = _build.ptr
    opt = lambda t: None if t is None else P(t)  # noqa: E731
    chunks = [(0, R)] if R <= GEMV_MAX_ROWS else tile_chunks(R, N, splits)
    ws = torch.empty(splits * max(n for _, n in chunks) * N if splits > 1 else 0,
                     dtype=torch.float32, device=x.device)
    for r0, rows in chunks:
        if R > GEMV_MAX_ROWS:
            mw = tile_plan(rows, N, K, code)[0] // 128
        rc = lib.tkq_qmm(code, P(x2d[r0:]), int(x2d.dtype == torch.float32), P(qs), opt(qh),
                         P(scl), opt(mins), P(out[r0:]), int(out_dtype == torch.float32), P(ws),
                         rows, N, K, cps, splits, mw, _build.stream_ptr(x.device))
        _build.check(lib, rc, "qmm")
    counter.launches += 1
    return out.reshape(*lead, N)
