"""attn_in: rms_norm -> [wqk | wv] -> bf16 round -> (+ bias) -> NEOX rope on
qk, one launch.

Kernel: ``csrc/attn_in.cu`` (replaces ``tpu_kquant/ops/pallas_attn_in.py:
fused_attn_in``, manual and Mosaic-grid variants; device code in
``csrc/attn_in.cuh``: gemv.cuh's tensor-core GEMV core behind the norm, a K
split from ``attn_in_plan`` whose splits form a thread-block cluster that
adds its partials in rank order, so a row's result is the same bits at
any R), decode rows only, for
the kinds the reference's gate takes in either slot: q4, q6w or q8 (Q4_K_M:
wqk q4 + wv q6w; Q8_0: both q8; Q6_K: both q6w; Q4_K_S: both q4), each with
bf16 scale pairs (q4-sm, q6w-sp, q8-sp) or f32 scales (``scales``, and
``mins`` for q4), with or without qwen2's f32 biases (``biases = (bqk [n0],
bv [n1])``, bqk = [bq | bk]).

phi3's pre-fused ``wqkv`` (one tensor [(H + 2 Hkv) hd, D], loaded as one)
runs as the two slots ``qkv_slots`` gives: views of its packed arrays, qk
its first (H + Hkv) hd columns and v the rest, each with wqkv's row
stride, so the kernel reads the tensor's own bytes once. The reference
passes ``ws = [wqkv]`` and ropes output 0 with tables whose last Hkv hd
columns are cos 1, sin 0 (``rope_tables_full(..., n_pad)``): the same
function, its one output the two outputs side by side.

``attn_in_plain`` is the same function in plain PyTorch, in f32 with the
kernel's rounding points: the normalised row is not rounded, each
projection is rounded to bf16, the bias added in f32, then the rotation
(the order of the reference's epilogue, pallas_attn_in.py:237-254).

The int8 folds of the grid variant (#3, pallas_attn_in.py:171-179): where
``ops.dequant.attn_in_folds`` holds at call time (TKQ_INT8_FOLDS=1, or
"auto" at 8B widths with TKQ_Q4_MXU_MINS=0, wherever the TPU would not take
the manual variant), every q4 slot runs ``ops.dequant.int8_group_fold`` on
the normalised rows: the kernel quantizes each row's 32-groups to int8 in
shared memory and runs the codes on int8 tensor cores (``csrc/int8.cuh``),
a run-time flag of the same launch. Such launches also count on
``fold_counter``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.dequant import attn_in_folds, project
from tpu_kquant_torch.ops.ffn import _aligned
from tpu_kquant_torch.ops.qmm import (_SMEM_CAP, GEMV_BLOCK_CHUNKS, GEMV_MAX_ROWS, GEMV_WAVE,
                                      KINDS, SEGMENTS, gemv_smem_bytes, kernel_kind,
                                      packed_arrays, row_stride)
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("attn_in")
fold_counter = _build.LaunchCounter("attn_in.folded")  # the launches (or plain calls) that fold

MAX_ROWS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
#            x   nw  eps              qk: kind qs scl mins v: kind qs scl mins
_ARGTYPES = [_P, _P, ctypes.c_float, _I, _P, _P, _P, _I, _P, _P, _P,
             # cos sin bqk bv out0 out1 R  D  n0 n1 hd ld0 ld1 fold stream
             _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


_KINDS = ("q4", "q6w", "q8")  # pallas_attn_in.py:_KINDS
# the most K splits of attn_in (one thread-block cluster of portable size),
# a block's output columns and its warps across its chunks (csrc/attn_in.cuh)
ATTN_IN_MAX_SPLITS = 8
ATTN_IN_TN = 128
ATTN_IN_WK = 4


@functools.lru_cache(maxsize=None)
def attn_in_plan(qk_code: int, v_code: int, n0: int, n1: int, D: int) -> int:
    """K splits of the attn_in kernel (csrc/attn_in.cuh:attn_in_plan, which
    this mirrors and the launch reads): of the counts s <= 8 (a portable
    cluster) that divide both slots' chunks of D (32 packed rows each), give
    each of a block's four K warps a chunk and fit shared memory at 32 rows
    (the rows staged as two bf16 halves), the one of least cost: waves of
    ceil(n0 / 128) + ceil(n1 / 128) column blocks times s (two blocks a SM)
    times the larger slot's chunk steps a warp plus a block's fixed cost
    (ties: the fewer splits). From the kinds and widths alone, never the
    row count, so a row's sums are taken in the same order at any R."""
    cols = -(-n0 // ATTN_IN_TN) + -(-n1 // ATTN_IN_TN)
    nq, nv = (D // (32 * SEGMENTS[KINDS[c][0]]) for c in (qk_code, v_code))
    best = None
    for s in range(1, ATTN_IN_MAX_SPLITS + 1):
        if nq % s or nv % s:
            continue
        cq, cv = nq // s, nv // s
        if min(cq, cv) < ATTN_IN_WK:
            continue
        if max(gemv_smem_bytes(qk_code, cq, GEMV_MAX_ROWS, halves=2),
               gemv_smem_bytes(v_code, cv, GEMV_MAX_ROWS, halves=2)) > _SMEM_CAP:
            continue
        steps = -(-max(cq, cv) // ATTN_IN_WK)
        cost = -(-cols * s // GEMV_WAVE) * (steps + GEMV_BLOCK_CHUNKS)
        if best is None or cost < best[0]:
            best = (cost, s)
    _build.require(best is not None, f"attn_in_plan: no split of D={D} fits "
                   f"({KINDS[qk_code]}, {KINDS[v_code]})")
    return best[1]


def attn_in_supported(wqk: QTensor, wv: QTensor, rows: int, D: int, head_dim: int,
                      biases: tuple[torch.Tensor, torch.Tensor] | None = None,
                      impl: str = "auto") -> bool:
    """The dispatch gate: the reference's (pallas_attn_in.attn_in_supported
    on [wqk, wv]: rows <= 32, D % 512, each weight kmajor of kind q4, q6w or
    q8 with K = D and N % 128; attn_in_enabled: impl "auto" or "int8", whose
    activation quantization does not reach this kernel), so both packages
    fuse at the same shapes and kinds; then what the kernel itself needs:
    a scale layout it reads (kernel_kind), a head_dim its 128-column blocks
    hold (``kernel_head_dim``: every head_dim of the ported archs, 64, 96,
    128 and 256) with whole heads in each slot, and biases, where given, f32
    vectors of the two outputs' widths. On phi3's ``qkv_slots`` the
    reference's rule is on wqkv's whole width ((H + 2 Hkv) hd % 128), this
    one on each slot's; they agree wherever Hkv hd % 128 == 0 (Phi-3-mini:
    3072)."""
    return (
        impl in ("auto", "int8") and rows <= MAX_ROWS and D % 512 == 0
        and all(w.layout == "kmajor" and w.kind in _KINDS and w.shape[-1] == D
                and w.shape[0] % 128 == 0 and kernel_kind(w) is not None for w in (wqk, wv))
        and kernel_head_dim(head_dim)
        and all(int(w.shape[0]) % head_dim == 0 for w in (wqk, wv))
        and (biases is None or all(
            b.dtype == torch.float32 and tuple(b.shape) == (int(w.shape[0]),)
            for b, w in zip(biases, (wqk, wv))))
    )


def kernel_head_dim(head_dim: int) -> bool:
    """Whether the kernel's 128-column blocks take this head_dim: one that
    divides 128 (a block holds whole heads: 64, 128), or a multiple of 32
    (96, phi3; 256, the gemma family: a block holds 64 columns of its
    heads' first halves, in runs of 8, and their 64 rope partners,
    csrc/attn_in.cuh:ai_col). The reference's gate has no head_dim rule.
    The column map itself needs only head_dim % 16; the gate keeps to the
    multiples of 32 that the ported families use and the card checks
    cover, so 80 (phi2, not ported) stays on qmatmul."""
    return head_dim > 0 and head_dim % 2 == 0 and (128 % head_dim == 0 or head_dim % 32 == 0)


def qkv_slots(wqkv: QTensor, n_rope: int) -> tuple[QTensor, QTensor]:
    """phi3's pre-fused wqkv as attn_in's two slots: (qk, v), QTensors of
    shapes (n_rope, K) and (N - n_rope, K) whose arrays are column views of
    wqkv's (no copy; each keeps wqkv's row stride). n_rope = (H + Hkv) hd,
    the columns the rope takes."""
    N, K = (int(d) for d in wqkv.shape)

    def part(lo: int, hi: int) -> QTensor:
        return QTensor(wqkv.kind, wqkv.layout, (hi - lo, K),
                       {k: v[..., lo:hi] for k, v in wqkv.arrays.items()}, wqkv.tp, wqkv.fold)

    return part(0, n_rope), part(n_rope, N)


def attn_in_enabled(wqk: QTensor, wv: QTensor, rows: int, D: int, head_dim: int,
                    biases: tuple[torch.Tensor, torch.Tensor] | None = None,
                    impl: str = "auto") -> bool:
    """models.llama's gate: the reference's switch TKQ_FUSE_ATTN (default
    "1"; anything else turns the kernel off), read at call time as
    pallas_attn_in.attn_in_enabled reads it, then attn_in_supported."""
    return (os.environ.get("TKQ_FUSE_ATTN", "1") == "1"
            and attn_in_supported(wqk, wv, rows, D, head_dim, biases, impl))


def _rope_neox(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Half rotation of y [R, H*hd] (f32) with cos/sin [R, hd/2]."""
    R = y.shape[0]
    h = y.reshape(R, -1, head_dim)
    half = head_dim // 2
    x1, x2 = h[..., :half], h[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(R, -1)


def attn_in_plain(x: torch.Tensor, norm_w: torch.Tensor, eps: float, wqk: QTensor,
                  wv: QTensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int,
                  biases: tuple[torch.Tensor, torch.Tensor] | None = None,
                  fold: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x [R, D] bf16, cos/sin [R, hd/2] -> (roped qk [R, n0], v [R, n1]) bf16;
    ``fold``: the q4 slots take the int8 group fold."""
    xf = x.float()
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm_w.float()
    qk = project(xn, wqk, fold).to(torch.bfloat16).float()
    v = project(xn, wv, fold).to(torch.bfloat16).float()
    if biases is not None:
        qk, v = qk + biases[0].float(), v + biases[1].float()
    qk = _rope_neox(qk, cos.float(), sin.float(), head_dim)
    return qk.to(torch.bfloat16), v.to(torch.bfloat16)


def fused_attn_in(x: torch.Tensor, norm_w: torch.Tensor, eps: float, wqk: QTensor,
                  wv: QTensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int,
                  biases: tuple[torch.Tensor, torch.Tensor] | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] bf16; cos/sin [..., hd/2] per row of x; biases (bqk [n0],
    bv [n1]) f32 or None. Returns (qk [..., n0] with rope applied, v
    [..., n1]), bf16. wqk / wv may be qkv_slots' views of one wqkv."""
    D = x.shape[-1]
    lead = x.shape[:-1]
    n0, n1 = int(wqk.shape[0]), int(wv.shape[0])
    half = head_dim // 2
    x2d = x.reshape(-1, D)
    c2d, s2d = cos.reshape(-1, half), sin.reshape(-1, half)
    R = x2d.shape[0]
    fold = folds(wqk, wv, R, biases)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        fold_counter.plain_calls += fold
        qk, v = attn_in_plain(x2d, norm_w, eps, wqk, wv, c2d, s2d, head_dim, biases, fold)
        return qk.reshape(*lead, n0), v.reshape(*lead, n1)
    req = _build.require
    req(x.device.type == "cuda", f"attn_in: unsupported device {x.device}")
    req(attn_in_supported(wqk, wv, R, D, head_dim, biases),
        "attn_in: unsupported layout, shape or biases")
    req(x.dtype == torch.bfloat16, f"attn_in: x dtype {x.dtype}")
    req(n0 % head_dim == 0 and c2d.shape == (R, half) and s2d.shape == (R, half),
        "attn_in: rope tables must be [rows, head_dim / 2]")
    req(norm_w.shape == (D,) and norm_w.dtype == torch.float32, "attn_in: norm weight")
    qk_code, qk_arrs = packed_arrays(wqk, "attn_in", strided=True)
    v_code, v_arrs = packed_arrays(wv, "attn_in", strided=True)
    arrs = (qk_arrs[0], qk_arrs[2], qk_arrs[3], v_arrs[0], v_arrs[2], v_arrs[3])
    bs = () if biases is None else tuple(biases)
    req(all(a.device == x.device for a in arrs if a is not None)
        and all(b.device == x.device and b.is_contiguous() for b in bs),
        "attn_in: weights and biases must be on x's device, biases contiguous")
    attn_in_plan(qk_code, v_code, n0, n1, D)  # raises where no split fits
    x2d, nw = _aligned(x2d), _aligned(norm_w)
    c2d = c2d.float().contiguous()
    s2d = s2d.float().contiguous()
    out0 = torch.empty((R, n0), dtype=torch.bfloat16, device=x.device)
    out1 = torch.empty((R, n1), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("attn_in", "tkq_attn_in", _ARGTYPES)
    P = _build.ptr
    bias_ptrs = (None, None) if biases is None else (P(bs[0]), P(bs[1]))
    ptrs = [None if a is None else P(a) for a in arrs]
    rc = lib.tkq_attn_in(P(x2d), P(nw), float(eps), qk_code, *ptrs[:3], v_code, *ptrs[3:],
                         P(c2d), P(s2d), *bias_ptrs, P(out0), P(out1), R, D, n0, n1, head_dim,
                         row_stride(arrs[0]), row_stride(arrs[3]), int(fold),
                         _build.stream_ptr(x.device))
    _build.check(lib, rc, "attn_in")
    counter.launches += 1
    fold_counter.launches += fold
    return out0.reshape(*lead, n0), out1.reshape(*lead, n1)


def folds(wqk: QTensor, wv: QTensor, rows: int,
          biases: tuple[torch.Tensor, torch.Tensor] | None = None) -> bool:
    """Whether a call at ``rows`` rows folds its q4 slots now
    (``ops.dequant.attn_in_folds`` on the reference's weight list: phi3's
    ``qkv_slots``, column views of one wqkv, are one weight there)."""
    qs = wqk.arrays["qs"]
    if isinstance(qs, torch.Tensor) and row_stride(qs) > qs.shape[-1]:
        ws = [QTensor(wqk.kind, wqk.layout, (int(wqk.shape[0]) + int(wv.shape[0]),
                                             int(wqk.shape[1])), {})]
    else:
        ws = [wqk, wv]
    return attn_in_folds(ws, biases, rows)


def kernel_plan(qk_code: int, v_code: int, n0: int, n1: int, D: int) -> int:
    """The kernel's own split count (C ``tkq_attn_in_plan``; needs the
    built library), which ``attn_in_plan`` must equal."""
    lib = _build.load("attn_in", "tkq_attn_in", _ARGTYPES)
    lib.tkq_attn_in_plan.argtypes = [_I] * 5
    lib.tkq_attn_in_plan.restype = _I
    return int(lib.tkq_attn_in_plan(qk_code, v_code, n0, n1, D))
