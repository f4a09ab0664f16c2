"""attn_out: x + bf16(o_proj(flash decode attention)) for one decode token
per row, one C call.

Kernel: ``csrc/attn_out.cu`` (replaces ``tpu_kquant/ops/pallas_attn_out.py:
fused_attn_out``). ``models.llama`` dispatches to it as the reference does
(``tpu_kquant/models/llama.py:159-172``): with ``TKQ_FUSE_ATTN_OUT=1``
(default off) at T = 1 when the append is not deferred (``TKQ_DEFER_APPEND=0``:
the deferred append's current rows are not in the cache), where
``attn_out_supported`` passes; the layer then goes on to the ffn kernel.

Layouts as the reference's: x [B, 1, dim]; q [B, 1, H, D] roped; k / v
[B, Hkv, S, D] heads-major, bf16 or int8 with ``kv_scales`` (k_scale,
v_scale) [B, Hkv, S] f32; ``q_positions`` [B, 1], slot j live while j <= the
row's position (the cache already holds the current token).

``attn_out_plain`` is the port's plain decode attention
(``ops.decode_attention.decode_attention_plain``, on q rounded to bf16 as
the kernel reads it), whose bf16 output is what the TPU kernel's bf16
scratch holds (pallas_attn_out.py:325), then a plain qmatmul on wo rounded
to bf16, then the residual added in bf16.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.decode_attention import FUSED_HEAD_DIMS, MAX_GROUP, check_cache, \
    decode_attention_plain, fused_attn_plan
from tpu_kquant_torch.ops.qmm import gemv_plan, kernel_kind, packed_arrays, qmm_plain
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

counter = _build.LaunchCounter("attn_out")

MAX_ROWS = 16
# The reference's VMEM cap on the Wo chunk of one KV-head pair, double-buffered
# by Mosaic (pallas_attn_out.py:64-66). A TPU constraint with no counterpart
# here (the GEMV streams wo through registers); kept so that both packages
# fuse at the same shapes.
_CHUNK_BYTES_MAX = 6 * 1024 * 1024
_KINDS = ("q4", "q6w", "q8")
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
#            kv_i8 D   q   sqb k   skb skh v   svb svh ks  ssb ssh vs  svsb svsh q_pos att
_ARGTYPES = [_I, _I, _P, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P,
             # B H  Hkv S   scale tps splits x  wo: kind qs scl mins ws  out dim cps
             _I, _I, _I, _I, _F, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
             # splits stream
             _I, _P]


def attn_out_supported(wo: QTensor, H: int, Hkv: int, D: int, rows: int, S: int) -> bool:
    """The dispatch gate: the reference's (pallas_attn_out.attn_out_supported:
    wo kmajor q4 / q6w / q8 of width H * D, Hkv even, rows <= 16, D % 64,
    S % 64, dim % 128, the pair chunk C = (H / Hkv) D a multiple of the
    kind's group and of 8, C * dim bytes (q4: half) within 6 MB), except
    that a wo with k-pair scales (``sp``) is refused: the reference admits
    it and its kernel then reads ``wo["scales"]`` and raises KeyError
    (pallas_attn_out.py:292, :310). Then what the kernel needs: a scale
    layout the GEMV reads, head_dim 64 or 128, at most 16 query heads per KV
    head."""
    if wo.layout != "kmajor" or wo.kind not in _KINDS or "sp" in wo.arrays:
        return False
    dim, K = int(wo.shape[0]), int(wo.shape[-1])
    if K != H * D or Hkv % 2 or H % Hkv:
        return False
    if rows > MAX_ROWS or D % 64 or S % 64 or dim % 128:
        return False
    C = (H // Hkv) * D
    if C % GROUP_SIZE[wo.kind] or C % 8:
        return False
    if C * dim * (1 if wo.kind == "q4" else 2) > _CHUNK_BYTES_MAX:
        return False
    return kernel_kind(wo) is not None and D in FUSED_HEAD_DIMS and H // Hkv <= MAX_GROUP


def attn_out_enabled(impl: str, wo: QTensor, H: int, Hkv: int, D: int, rows: int,
                     S: int) -> bool:
    """models.llama's gate: TKQ_FUSE_ATTN_OUT=1 (read at call time, default
    off), impl "auto" or "int8" (pallas_attn_out.attn_out_enabled) and
    attn_out_supported."""
    return (os.environ.get("TKQ_FUSE_ATTN_OUT", "0") == "1" and impl in ("auto", "int8")
            and attn_out_supported(wo, H, Hkv, D, rows, S))


def attn_out_plain(x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_scales, wo: QTensor,
                   scale: float | None = None, att: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, 1, dim] bf16 -> [B, 1, dim] bf16 (module docstring); `att` as
    fused_attn_out's."""
    B, _, H, D = q.shape
    attn = decode_attention_plain(q.to(torch.bfloat16), k, v, q_positions, kv_scales, scale)
    if att is not None:
        att.copy_(attn.reshape(B, H * D))
    h = qmm_plain(attn.reshape(B, H * D), wo, torch.bfloat16)
    return (x.reshape(B, -1) + h).reshape(x.shape)


def fused_attn_out(x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_scales, wo: QTensor,
                   scale: float | None = None, att: torch.Tensor | None = None) -> torch.Tensor:
    """x + o_proj(attention(q, K/V)) (module docstring); returns [B, 1, dim].
    `att`, where given, is a bf16 [B, H * D] tensor that receives the
    attention phase's head outputs (the kernel's scratch), so that a check
    can hold that phase per row. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return attn_out_plain(x, q, k, v, q_positions, kv_scales, wo, scale, att)
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dim = int(wo.shape[0])
    scale = D ** -0.5 if scale is None else scale
    req = _build.require
    req(x.device.type == "cuda", f"attn_out: unsupported device {x.device}")
    req(all(t.device == x.device for t in (q, k, v, q_positions)),
        "attn_out: inputs on several devices")
    req(T == 1, f"attn_out: one query token per row, got T = {T}")
    req(attn_out_supported(wo, H, Hkv, D, B, S), "attn_out: unsupported layout or shape")
    req(x.dtype == torch.bfloat16 and x.shape == (B, 1, dim), f"attn_out: x {tuple(x.shape)} "
                                                              f"{x.dtype}")
    req(k.shape == (B, Hkv, S, D) and v.shape == k.shape, "attn_out: k / v shapes")
    quant = kv_scales is not None
    req(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
        f"attn_out: k/v dtype {k.dtype}/{v.dtype} with{'' if quant else 'out'} scales")
    req(q_positions.shape == (B, 1), "attn_out: q_positions must be [B, 1]")
    check_cache("attn_out", k, v, kv_scales)
    wo_kind, (qs, _, scl, mins) = packed_arrays(wo, "attn_out")
    req(qs.device == x.device, "attn_out: wo must be on x's device")
    qb = q[:, 0].to(torch.bfloat16)
    if not (qb.stride(2) == 1 and qb.stride(1) == D):
        qb = qb.contiguous()
    x2d = x.reshape(B, dim).contiguous()
    cps, splits = gemv_plan(wo_kind, dim, H * D)
    if att is None:
        att = torch.empty((B, H * D), dtype=torch.bfloat16, device=x.device)
    req(att.shape == (B, H * D) and att.dtype == torch.bfloat16 and att.is_contiguous()
        and att.device == x.device, "attn_out: att must be a dense bf16 [B, H * D] tensor")
    tps, a_splits = fused_attn_plan(S)
    ws = torch.empty(splits * B * dim, dtype=torch.float32, device=x.device)
    out = torch.empty((B, 1, dim), dtype=torch.bfloat16, device=x.device)
    P = _build.ptr
    scales = [a for t in kv_scales for a in (P(t), t.stride(0), t.stride(1))] if quant \
        else [None, 0, 0] * 2
    qp = q_positions[:, 0].long().contiguous()  # read in place: no copy
    lib = _build.load("attn_out", "tkq_attn_out", _ARGTYPES)
    rc = lib.tkq_attn_out(int(quant), D, P(qb), qb.stride(0), P(k), k.stride(0), k.stride(1),
                          P(v), v.stride(0), v.stride(1), *scales, P(qp), P(att), B, H, Hkv, S,
                          float(scale), tps, a_splits, P(x2d), wo_kind, P(qs), P(scl),
                          None if mins is None else P(mins), P(ws), P(out), dim, cps, splits,
                          _build.stream_ptr(x.device))
    _build.check(lib, rc, "attn_out")
    counter.launches += 1
    return out
