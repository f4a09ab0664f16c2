"""The FFN block for decode rows, with and without o_proj in front.

- ffn: y = x + down(silu(gate(n(x))) * up(n(x))), n = rms_norm. Kernel
  ``csrc/ffn.cu`` (replaces ``tpu_kquant/ops/pallas_ffn.py:fused_ffn``),
  run where the attention width fails oproj_ffn's gate (qwen2).
- oproj_ffn: x2 = x + attn @ Wo^T; y = x2 + down(silu(gate(n(x2))) *
  up(n(x2))). Kernel ``csrc/oproj_ffn.cu`` (replaces
  ``tpu_kquant/ops/pallas_ffn.py:fused_oproj_ffn``, manual and Mosaic-grid
  variants).
Both take the Q4_K_M layouts (w_gateup q4, w_down q6w; wo q4 or q6w), each
weight with bf16 scale pairs (q4-sm, q6w-sp) or f32 scales (q4 ``scales`` +
``mins``, q6w ``scales``: ``scale_dtype='f32'``), as their gates and the
reference's pass them, and share the gate/up phase (``csrc/gate_up.cuh``).

``ffn_plain`` and ``oproj_ffn_plain`` are the same functions in plain
PyTorch with the kernels' rounding points: x2, gate, up and their activated
product are rounded to bf16, the sums are f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.qmm import gemv_split, kernel_kind
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("oproj_ffn")
ffn_counter = _build.LaunchCounter("ffn")

MAX_ROWS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#            x   attn nw  eps wo: kind qs scl mins  gu: kind qs scl mins  dn: kind qs scl
_ARGTYPES = [_P, _P, _P, _F, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
             # x2 act ws out R  dim K  F  cps_o splits_o cps_d splits_d stream
             _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
#                x   nw  eps gu: kind qs scl mins  dn: kind qs scl
_FFN_ARGTYPES = [_P, _P, _F, _I, _P, _P, _P, _I, _P, _P,
                 # act ws out R  dim F  cps_d splits_d stream
                 _P, _P, _P, _I, _I, _I, _I, _I, _P]


def _kind(qt: QTensor) -> str | None:
    """'q4' or 'q6w' for a 2-D kmajor weight of either scale layout."""
    return None if kernel_kind(qt) is None else qt.kind


def ffn_supported(gu: QTensor, dn: QTensor, rows: int) -> bool:
    """The dispatch gate of ffn: decode rows and the kernel's kinds. The
    width rules are the reference's (pallas_ffn.ffn_supported: dim % 512,
    and F % 256, which is ``_pick_tf(F, dim) != 0``) so both packages fuse
    at the same shapes."""
    if rows > MAX_ROWS or _kind(gu) != "q4" or _kind(dn) != "q6w":
        return False
    dim, Fd = int(dn.shape[0]), int(dn.shape[1])
    return gu.shape == (2 * Fd, dim) and dim % 512 == 0 and Fd % 256 == 0


def oproj_ffn_supported(wo: QTensor, gu: QTensor, dn: QTensor, rows: int) -> bool:
    """The dispatch gate of oproj_ffn: ffn's, and an o_proj the kernel reads
    whose width K is a multiple of 1024 (pallas_ffn.oproj_ffn_supported)."""
    return (ffn_supported(gu, dn, rows) and _kind(wo) is not None
            and wo.shape[0] == dn.shape[0] and int(wo.shape[1]) % 1024 == 0)


def _arrays(qt: QTensor) -> tuple[int, list]:
    """(kind code, [codes, scales, mins or None]) of a weight the kernels read."""
    code = kernel_kind(qt)
    scl = qt.arrays[("sm", "sp", "scales", "scales")[code]]
    return code, [qt.arrays["qs"], scl, qt.arrays["mins"] if code == 2 else None]


def _check_arrays(what: str, x: torch.Tensor, *ws: QTensor) -> None:
    for qt in ws:
        code, arrs = _arrays(qt)
        _build.require(arrs[0].dtype == (torch.uint8 if code in (0, 2) else torch.int8)
                       and all(a.dtype == torch.float32 for a in arrs[1:] if a is not None),
                       f"{what}: packed array dtypes")
        _build.require(all(a.device == x.device and a.is_contiguous()
                           for a in arrs if a is not None),
                       f"{what}: weights must be contiguous on x's device")


def _ffn_tail(x2: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor,
              dn: QTensor) -> torch.Tensor:
    """x2 [R, dim] f32 -> x2 + down(act) in f32, unrounded."""
    xn = x2 * torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + eps) * norm_w.float()
    gu_out = xn @ dequant_kmajor(gu)
    Fd = gu_out.shape[-1] // 2
    g = gu_out[:, :Fd].to(torch.bfloat16).float()
    u = gu_out[:, Fd:].to(torch.bfloat16).float()
    act = (F.silu(g) * u).to(torch.bfloat16).float()
    return x2 + act @ dequant_kmajor(dn)


def ffn_plain(x: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor,
              dn: QTensor) -> torch.Tensor:
    """x [R, dim] -> y [R, dim] in x's dtype (bf16 on the decode path)."""
    return _ffn_tail(x.float(), norm_w, eps, gu, dn).to(x.dtype)


def fused_ffn(x: torch.Tensor, norm_w: torch.Tensor, eps: float, gu: QTensor, dn: QTensor,
              act_fn: str = "silu") -> torch.Tensor:
    """x [..., dim] bf16 -> [..., dim] bf16."""
    if act_fn != "silu":
        raise NotImplementedError(f"activation {act_fn!r} is not ported yet")
    dim, Fd = int(dn.shape[0]), int(dn.shape[1])
    lead = x.shape[:-1]
    x2d = x.reshape(-1, dim)
    if x.device.type == "cpu":
        ffn_counter.plain_calls += 1
        return ffn_plain(x2d, norm_w, eps, gu, dn).reshape(*lead, dim)
    R = x2d.shape[0]
    req = _build.require
    req(x.device.type == "cuda", f"ffn: unsupported device {x.device}")
    req(ffn_supported(gu, dn, R), "ffn: unsupported layout or shape")
    req(x.dtype == torch.bfloat16, f"ffn: x dtype {x.dtype}")
    req(norm_w.shape == (dim,) and norm_w.dtype == torch.float32, "ffn: norm weight")
    _check_arrays("ffn", x, gu, dn)
    gu_kind, gu_arrs = _arrays(gu)
    dn_kind, dn_arrs = _arrays(dn)
    x2d, nw = x2d.contiguous(), norm_w.contiguous()
    cps_d, splits_d = gemv_split(1, dim, Fd, R)
    dev = x.device
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(splits_d * R * dim, dtype=torch.float32, device=dev)
    out = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    lib = _build.load("ffn", "tkq_ffn", _FFN_ARGTYPES)
    P = _build.ptr
    ptrs = lambda arrs: [None if a is None else P(a) for a in arrs]  # noqa: E731
    rc = lib.tkq_ffn(P(x2d), P(nw), float(eps), gu_kind, *ptrs(gu_arrs), dn_kind,
                     *ptrs(dn_arrs[:2]), P(act), P(ws), P(out), R, dim, Fd, cps_d, splits_d,
                     _build.stream_ptr(dev))
    _build.check(lib, rc, "ffn")
    ffn_counter.launches += 1
    return out.reshape(*lead, dim)


def oproj_ffn_plain(x: torch.Tensor, attn: torch.Tensor, wo: QTensor, norm_w: torch.Tensor,
                    eps: float, gu: QTensor, dn: QTensor) -> torch.Tensor:
    """x [R, dim], attn [R, K] bf16 -> y [R, dim] bf16."""
    x2 = (x.float() + attn.float() @ dequant_kmajor(wo)).to(torch.bfloat16).float()
    return _ffn_tail(x2, norm_w, eps, gu, dn).to(torch.bfloat16)


def fused_oproj_ffn(x: torch.Tensor, attn: torch.Tensor, wo: QTensor, norm_w: torch.Tensor,
                    eps: float, gu: QTensor, dn: QTensor, act_fn: str = "silu") -> torch.Tensor:
    """x [..., dim], attn [..., K] bf16 -> [..., dim] bf16."""
    if act_fn != "silu":
        raise NotImplementedError(f"activation {act_fn!r} is not ported yet")
    dim, K = int(wo.shape[0]), int(wo.shape[1])
    Fd = int(dn.shape[1])
    lead = x.shape[:-1]
    x2d, a2d = x.reshape(-1, dim), attn.reshape(-1, K)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return oproj_ffn_plain(x2d, a2d, wo, norm_w, eps, gu, dn).reshape(*lead, dim)
    R = x2d.shape[0]
    req = _build.require
    req(x.device.type == "cuda", f"oproj_ffn: unsupported device {x.device}")
    req(oproj_ffn_supported(wo, gu, dn, R), "oproj_ffn: unsupported layout or shape")
    req(x.dtype == torch.bfloat16 and attn.dtype == torch.bfloat16, "oproj_ffn: x/attn dtype")
    req(a2d.shape[0] == R, "oproj_ffn: x and attn rows differ")
    req(norm_w.shape == (dim,) and norm_w.dtype == torch.float32, "oproj_ffn: norm weight")
    _check_arrays("oproj_ffn", x, wo, gu, dn)
    (wo_kind, wo_arrs), (gu_kind, gu_arrs), (dn_kind, dn_arrs) = map(_arrays, (wo, gu, dn))
    x2d, a2d, nw = x2d.contiguous(), a2d.contiguous(), norm_w.contiguous()
    cps_o, splits_o = gemv_split(wo_kind, dim, K, R)
    cps_d, splits_d = gemv_split(1, dim, Fd, R)
    dev = x.device
    x2 = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(max(splits_o, splits_d) * R * dim, dtype=torch.float32, device=dev)
    out = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    lib = _build.load("oproj_ffn", "tkq_oproj_ffn", _ARGTYPES)
    P = _build.ptr
    ptrs = lambda arrs: [None if a is None else P(a) for a in arrs]  # noqa: E731
    rc = lib.tkq_oproj_ffn(P(x2d), P(a2d), P(nw), float(eps), wo_kind, *ptrs(wo_arrs), gu_kind,
                           *ptrs(gu_arrs), dn_kind, *ptrs(dn_arrs[:2]), P(x2), P(act), P(ws),
                           P(out), R, dim, K, Fd, cps_o, splits_o, cps_d, splits_d,
                           _build.stream_ptr(dev))
    _build.check(lib, rc, "oproj_ffn")
    counter.launches += 1
    return out.reshape(*lead, dim)
