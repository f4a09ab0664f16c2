"""The FFN block for decode rows, with and without o_proj in front.

- ffn: y = x + down(act(gate(n(x))) * up(n(x))), n = rms_norm, act the
  config's: silu, or the exact (erf) gelu of the gemma family. Kernel
  ``csrc/ffn.cu:tkq_ffn`` (replaces ``tpu_kquant/ops/pallas_ffn.py:
  fused_ffn``), run where the attention width fails oproj_ffn's gate (qwen2).
- oproj_ffn: x2 = x + attn @ Wo^T; y = x2 + down(act(gate(n(x2))) *
  up(n(x2))). Kernel ``csrc/ffn.cu:tkq_oproj_ffn`` (replaces
  ``tpu_kquant/ops/pallas_ffn.py:fused_oproj_ffn``, manual and Mosaic-grid
  variants).
Both take the kinds the reference's gates pass: wo and w_gateup q4, q6w or
q8, w_down q6w or q8 (Q4_K_M: wo q6w, gate/up q4, down q6w; Q8_0: q8 in
every slot; Q6_K: q6w in every slot), each weight with bf16 scale pairs
(q4-sm, q6w-sp, q8-sp) or f32 scales (``scales``, and ``mins`` for q4:
``scale_dtype='f32'``), and share the gate/up phase (``csrc/gate_up.cuh``).

``ffn_plain`` and ``oproj_ffn_plain`` are the same functions in plain
PyTorch with the kernels' rounding points: x2, gate, up and their activated
product are rounded to bf16, the sums are f32.

The int8 folds of the grid variants (#5, #6; pallas_ffn.py:154-162, :201-204,
:474-477, :543): where ``ops.dequant.ffn_folds`` / ``oproj_ffn_folds`` hold
at call time (TKQ_INT8_FOLDS=1, and for oproj_ffn wherever the TPU would
not take the manual variant #4), a q4 gate/up runs
``ops.dequant.int8_group_fold`` on the normalised rows and a q4 o_proj on
the attention output. In the kernels the gate/up phase quantizes each
row's 32-groups in shared memory (a run-time flag of ``gate_up.cuh``), and
the folded o_proj quantizes the attention output into the scratch and runs
``csrc/int8.cuh``'s int8 GEMV with the residual epilogue. Such launches
also count on ``fold_counter`` / ``ffn_fold_counter``.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.dequant import _FLAT_KINDS, ffn_folds, oproj_ffn_folds, project
from tpu_kquant_torch.ops.qmm import KINDS, gemv_plan, kernel_kind, packed_arrays
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("oproj_ffn")
ffn_counter = _build.LaunchCounter("ffn")
gate_up_counter = _build.LaunchCounter("gate_up")
# the launches (or plain calls) of oproj_ffn / ffn that fold a slot
fold_counter = _build.LaunchCounter("oproj_ffn.folded")
ffn_fold_counter = _build.LaunchCounter("ffn.folded")

MAX_ROWS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#            x   attn nw  eps wo: kind qs scl mins  gu: kind qs scl mins  dn: kind qs scl
_ARGTYPES = [_P, _P, _P, _F, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
             # x2 act ws out R  dim K  F  cps_o splits_o cps_g splits_g cps_d splits_d
             _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             # gelu round_first pdl fold_wo fold_gu stream
             _I, _I, _I, _I, _I, _P]
#                x   nw  eps gu: kind qs scl mins  dn: kind qs scl
_FFN_ARGTYPES = [_P, _P, _F, _I, _P, _P, _P, _I, _P, _P,
                 # act ws out R  dim F  cps_g splits_g cps_d splits_d gelu fold stream
                 _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#                    x   nw  eps gu: kind qs scl mins  act ws  R   dim F   cps splits gelu fold
_GATE_UP_ARGTYPES = [_P, _P, _F, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P]  # stream
ACT_FNS = ("silu", "gelu")  # the kernels' activations: C's `gelu` flag 0 / 1


def gelu_flag(act_fn: str) -> int:
    """The C entry points' `gelu` argument for ``act_fn`` ("silu" or
    "gelu"); raises ValueError on any other."""
    _build.require(act_fn in ACT_FNS, f"act_fn must be one of {ACT_FNS}, got {act_fn!r}")
    return int(act_fn == "gelu")


_VMEM_CHUNK_ELEMS = 2_700_000  # pallas_attn_in.py:_VMEM_CHUNK_ELEMS


def _pick_tf(F: int, D: int = 0, cap: int = 1024) -> int:
    """The reference's F tile (pallas_ffn.py:_pick_tf): the largest divisor of
    F that is a multiple of 256 and at most ``cap`` (capped further by D);
    0 where none exists, which its gate refuses."""
    if D:
        cap = min(cap, max(256, _VMEM_CHUNK_ELEMS // D // 256 * 256))
    best = 0
    for t in range(256, cap + 1, 256):
        if F % t == 0:
            best = t
    return best


def ffn_supported(gu: QTensor, dn: QTensor, rows: int) -> bool:
    """The dispatch gate of ffn: the reference's (pallas_ffn.ffn_supported:
    decode rows, w_gateup [2F, D] of kind q4, q6w or q8, w_down [D, F] of
    kind q6w or q8, D % 512 and ``_pick_tf(F, D) != 0``), so both packages
    fuse at the same shapes and kinds; then a scale layout the kernels read."""
    if gu.layout != "kmajor" or dn.layout != "kmajor" or rows > MAX_ROWS:
        return False
    D, Fd = int(gu.shape[-1]), int(dn.shape[-1])
    if gu.shape[0] != 2 * Fd or dn.shape[0] != D:
        return False
    if dn.kind not in _FLAT_KINDS or gu.kind not in ("q4",) + _FLAT_KINDS:
        return False
    if D % 512 or _pick_tf(Fd, D) == 0:
        return False
    return kernel_kind(gu) is not None and kernel_kind(dn) is not None


def oproj_ffn_supported(wo: QTensor, gu: QTensor, dn: QTensor, rows: int) -> bool:
    """The dispatch gate of oproj_ffn: ffn's, and an o_proj [D, K] of kind q4,
    q6w or q8 whose width K is a multiple of 1024
    (pallas_ffn.oproj_ffn_supported), in a scale layout the kernels read."""
    return (ffn_supported(gu, dn, rows) and wo.layout == "kmajor"
            and wo.kind in ("q4",) + _FLAT_KINDS and wo.shape[0] == gu.shape[-1]
            and int(wo.shape[-1]) % 1024 == 0 and kernel_kind(wo) is not None)


def ffn_enabled(impl: str, gu: QTensor, dn: QTensor, rows: int) -> bool:
    """models.llama's gate of ffn: the reference's switch TKQ_FUSE_FFN
    (default "1"), read at call time as pallas_ffn.fused_ffn_enabled reads
    it, impl "auto" or "int8", then ffn_supported."""
    return (os.environ.get("TKQ_FUSE_FFN", "1") == "1" and impl in ("auto", "int8")
            and ffn_supported(gu, dn, rows))


def oproj_ffn_enabled(impl: str, wo: QTensor, gu: QTensor, dn: QTensor, rows: int) -> bool:
    """models.llama's gate of oproj_ffn: the reference's switch
    TKQ_FUSE_OPROJ (default "1"), read at call time as
    pallas_ffn.oproj_ffn_enabled reads it, impl "auto" or "int8", then
    oproj_ffn_supported."""
    return (os.environ.get("TKQ_FUSE_OPROJ", "1") == "1" and impl in ("auto", "int8")
            and oproj_ffn_supported(wo, gu, dn, rows))


def gate_up_plan(code: int, F: int, dim: int) -> tuple[int, int]:
    """(chunks per split, splits) of the gate/up phase (csrc/gate_up.cuh):
    ops.qmm.gemv_plan over the fused w_gateup [2F, dim] (a block's 256
    columns: 128 of gate and the matching 128 of up) with the normalised
    rows staged as two bf16 halves and no cost a split (its partials, [splits,
    R, 2F] f32 at R <= 32, cost nothing measurable: tools/gemv_sweep.py
    --gate-up found the fastest split where the blocks fill one wave of two
    a SM, PERF.md §6). Never from the row count, as the GEMV's."""
    return gemv_plan(code, 2 * F, dim, halves=2, split_cost=0.0)


def fused_ws_floats(R: int, dim: int, F: int, splits_o: int, splits_g: int,
                    splits_d: int, fold_k: int = 0) -> int:
    """f32 scratch floats of the FFN sequence (gate_up.cuh:launch_oproj_ffn):
    the largest of its phases' split partials (o_proj and down [splits, R,
    dim], gate/up [splits, R, 2F]), which run one at a time; ``fold_k``: a
    folded o_proj's depth K, whose phase also holds the quantized attention
    output after its partials (int8 [R, K], its scales and group sums [R, K
    / 32] f32 each)."""
    quant = R * fold_k // 4 + 2 * (R * fold_k // 32)
    return max(splits_o * R * dim + quant, splits_g * R * 2 * F if splits_g > 1 else 0,
               splits_d * R * dim, 1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the gate/up phase reads its rows and
    the norm weight 16 bytes at a time), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fused_arrays(what: str, x: torch.Tensor, *ws: QTensor,
                  strided: bool = False) -> list[tuple[int, list]]:
    """(kind code, [codes, scales, mins or None]) of each weight, checked by
    ops.qmm.packed_arrays (the fused kinds have no high bit plane; strided:
    column views of a wider weight are taken) and required on x's
    device."""
    out = []
    for qt in ws:
        code, (qs, _, scl, mins) = packed_arrays(qt, what, strided)
        _build.require(qs.device == x.device, f"{what}: weights must be on x's device")
        out.append((code, [qs, scl, mins]))
    return out


def gate_up_plain(x: torch.Tensor, norm_w: torch.Tensor, eps: float,
                  gu: QTensor, act_fn: str = "silu", fold: bool = False) -> torch.Tensor:
    """The gate/up phase in plain PyTorch: x [R, dim] -> act [R, F] bf16 =
    bf16(act(bf16(gate(n(x)))) * bf16(up(n(x)))), n(x) in f32, act silu or
    the exact gelu (``act_fn``), in f32; ``fold``: a q4 gate/up takes the
    int8 group fold."""
    gelu_flag(act_fn)
    x = x.float()
    xn = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * norm_w.float()
    gu_out = project(xn, gu, fold)
    Fd = gu_out.shape[-1] // 2
    g = gu_out[:, :Fd].to(torch.bfloat16).float()
    u = gu_out[:, Fd:].to(torch.bfloat16).float()
    a = F.gelu(g) if act_fn == "gelu" else F.silu(g)
    return (a * u).to(torch.bfloat16)


def gate_up(x: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor,
            act_fn: str = "silu", fold: bool = False) -> torch.Tensor:
    """The gate/up phase alone (csrc/ffn.cu:tkq_gate_up): x [R, dim] bf16 ->
    act [R, F] bf16 (``fold``: a q4 gate/up folded). The main path runs it
    inside fused_oproj_ffn and fused_ffn; this entry point times it on its
    own (tools/tile_ab.py) and holds it to gate_up_plain."""
    if x.device.type == "cpu":
        gate_up_counter.plain_calls += 1
        return gate_up_plain(x, norm_w, eps, gu, act_fn, fold)
    R, dim = x.shape
    Fd = int(gu.shape[0]) // 2
    req = _build.require
    req(x.device.type == "cuda" and x.dtype == torch.bfloat16 and R <= MAX_ROWS,
        f"gate_up: x {x.dtype} [{R}, {dim}] on {x.device}")
    req(gu.shape[-1] == dim and dim % 64 == 0 and Fd % 32 == 0, "gate_up: shape")
    req(norm_w.shape == (dim,) and norm_w.dtype == torch.float32, "gate_up: norm weight")
    ((gu_kind, gu_arrs),) = _fused_arrays("gate_up", x, gu)
    req(KINDS[gu_kind][0] in ("q4",) + _FLAT_KINDS, f"gate_up: kind {KINDS[gu_kind]}")
    cps_g, splits_g = gate_up_plan(gu_kind, Fd, dim)
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty(fused_ws_floats(R, dim, Fd, 0, splits_g, 0), dtype=torch.float32,
                     device=x.device)
    x, nw = _aligned(x), _aligned(norm_w)
    lib = _build.load("ffn", "tkq_gate_up", _GATE_UP_ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_gate_up(P(x), P(nw), float(eps), gu_kind,
                         *[None if a is None else P(a) for a in gu_arrs], P(act), P(ws), R, dim,
                         Fd, cps_g, splits_g, gelu_flag(act_fn), int(fold and gu.kind == "q4"),
                         _build.stream_ptr(x.device))
    _build.check(lib, rc, "gate_up")
    gate_up_counter.launches += 1
    return act


def _ffn_tail(x2: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor,
              dn: QTensor, act_fn: str = "silu", fold: bool = False) -> torch.Tensor:
    """x2 [R, dim] f32 -> x2 + down(act) in f32, unrounded."""
    act = gate_up_plain(x2, norm_w, eps, gu, act_fn, fold).float()
    return x2 + act @ dequant_kmajor(dn)


def ffn_plain(x: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor,
              dn: QTensor, act_fn: str = "silu", fold: bool = False) -> torch.Tensor:
    """x [R, dim] -> y [R, dim] in x's dtype (bf16 on the decode path);
    ``fold``: a q4 gate/up takes the int8 group fold."""
    return _ffn_tail(x.float(), norm_w, eps, gu, dn, act_fn, fold).to(x.dtype)


def fused_ffn(x: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor, dn: QTensor,
              act_fn: str = "silu") -> torch.Tensor:
    """x [..., dim] bf16 -> [..., dim] bf16; act_fn "silu" or "gelu"."""
    gelu = gelu_flag(act_fn)
    dim, Fd = int(dn.shape[0]), int(dn.shape[1])
    lead = x.shape[:-1]
    x2d = x.reshape(-1, dim)
    fold = ffn_folds(gu)
    if x.device.type == "cpu":
        ffn_counter.plain_calls += 1
        ffn_fold_counter.plain_calls += fold
        return ffn_plain(x2d, norm_w, eps, gu, dn, act_fn, fold).reshape(*lead, dim)
    R = x2d.shape[0]
    req = _build.require
    req(x.device.type == "cuda", f"ffn: unsupported device {x.device}")
    req(ffn_supported(gu, dn, R), "ffn: unsupported layout or shape")
    req(x.dtype == torch.bfloat16, f"ffn: x dtype {x.dtype}")
    req(norm_w.shape == (dim,) and norm_w.dtype == torch.float32, "ffn: norm weight")
    (gu_kind, gu_arrs), (dn_kind, dn_arrs) = _fused_arrays("ffn", x, gu, dn)
    x2d, nw = _aligned(x2d), _aligned(norm_w)
    cps_g, splits_g = gate_up_plan(gu_kind, Fd, dim)
    cps_d, splits_d = gemv_plan(dn_kind, dim, Fd)
    dev = x.device
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(fused_ws_floats(R, dim, Fd, 0, splits_g, splits_d), dtype=torch.float32,
                     device=dev)
    out = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    lib = _build.load("ffn", "tkq_ffn", _FFN_ARGTYPES)
    P = _build.ptr
    ptrs = lambda arrs: [None if a is None else P(a) for a in arrs]  # noqa: E731
    rc = lib.tkq_ffn(P(x2d), P(nw), float(eps), gu_kind, *ptrs(gu_arrs), dn_kind,
                     *ptrs(dn_arrs[:2]), P(act), P(ws), P(out), R, dim, Fd, cps_g, splits_g,
                     cps_d, splits_d, gelu, int(fold), _build.stream_ptr(dev))
    _build.check(lib, rc, "ffn")
    ffn_counter.launches += 1
    ffn_fold_counter.launches += fold
    return out.reshape(*lead, dim)


def oproj_ffn_plain(x: torch.Tensor, attn: torch.Tensor, wo: QTensor, norm_w: torch.Tensor,
                    eps: float, gu: QTensor, dn: QTensor, act_fn: str = "silu",
                    folds: tuple[bool, bool] = (False, False),
                    round_first: bool = False) -> torch.Tensor:
    """x [R, dim], attn [R, K] bf16 -> y [R, dim] bf16; ``folds``: (a q4
    o_proj, a q4 gate/up) takes the int8 group fold; ``round_first``: the
    o_proj sum is rounded to bf16 before the residual is added (the grid
    variant's order, which fused_oproj_ffn computes where it folds)."""
    o = project(attn.float(), wo, folds[0])
    if round_first:
        o = o.to(torch.bfloat16).float()
    x2 = (x.float() + o).to(torch.bfloat16).float()
    return _ffn_tail(x2, norm_w, eps, gu, dn, act_fn, folds[1]).to(torch.bfloat16)


def fused_oproj_ffn(x: torch.Tensor, attn: torch.Tensor, wo: QTensor, norm_w: torch.Tensor,
                    eps: float, gu: QTensor, dn: QTensor, act_fn: str = "silu") -> torch.Tensor:
    """x [..., dim], attn [..., K] bf16 -> [..., dim] bf16; act_fn "silu" or
    "gelu"."""
    gelu = gelu_flag(act_fn)
    dim, K = int(wo.shape[0]), int(wo.shape[1])
    Fd = int(dn.shape[1])
    lead = x.shape[:-1]
    x2d, a2d = x.reshape(-1, dim), attn.reshape(-1, K)
    R = x2d.shape[0]
    folds = oproj_ffn_folds(wo, gu, dn, R)
    # a fold runs the grid variant's function (#5), which rounds the o_proj
    # sum to bf16 before the residual (pallas_ffn.py:531-536); unfolded,
    # the sum is added in f32 and rounded once, the manual variant's order
    # (#4, pallas_ffn.py:908), at every row count (ROADMAP, Queue 3)
    round_first = any(folds)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        fold_counter.plain_calls += any(folds)
        return oproj_ffn_plain(x2d, a2d, wo, norm_w, eps, gu, dn, act_fn, folds,
                               round_first).reshape(*lead, dim)
    req = _build.require
    req(x.device.type == "cuda", f"oproj_ffn: unsupported device {x.device}")
    req(oproj_ffn_supported(wo, gu, dn, R), "oproj_ffn: unsupported layout or shape")
    req(x.dtype == torch.bfloat16 and attn.dtype == torch.bfloat16, "oproj_ffn: x/attn dtype")
    req(a2d.shape[0] == R, "oproj_ffn: x and attn rows differ")
    req(norm_w.shape == (dim,) and norm_w.dtype == torch.float32, "oproj_ffn: norm weight")
    (wo_kind, wo_arrs), (gu_kind, gu_arrs), (dn_kind, dn_arrs) = _fused_arrays(
        "oproj_ffn", x, wo, gu, dn)
    x2d, a2d, nw = x2d.contiguous(), a2d.contiguous(), _aligned(norm_w)
    # a folded o_proj runs the int8 GEMV, whose plan counts its own staging
    cps_o, splits_o = gemv_plan(wo_kind, dim, K, int8=folds[0])
    cps_g, splits_g = gate_up_plan(gu_kind, Fd, dim)
    cps_d, splits_d = gemv_plan(dn_kind, dim, Fd)
    dev = x.device
    x2 = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(fused_ws_floats(R, dim, Fd, splits_o, splits_g, splits_d,
                                     K if folds[0] else 0), dtype=torch.float32, device=dev)
    out = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    lib = _build.load("ffn", "tkq_oproj_ffn", _ARGTYPES)
    P = _build.ptr
    ptrs = lambda arrs: [None if a is None else P(a) for a in arrs]  # noqa: E731
    rc = lib.tkq_oproj_ffn(P(x2d), P(a2d), P(nw), float(eps), wo_kind, *ptrs(wo_arrs), gu_kind,
                           *ptrs(gu_arrs), dn_kind, *ptrs(dn_arrs[:2]), P(x2), P(act), P(ws),
                           P(out), R, dim, K, Fd, cps_o, splits_o, cps_g, splits_g, cps_d,
                           splits_d, gelu, int(round_first), 0, int(folds[0]), int(folds[1]),
                           _build.stream_ptr(dev))
    _build.check(lib, rc, "oproj_ffn")
    counter.launches += 1
    fold_counter.launches += any(folds)
    return out.reshape(*lead, dim)
