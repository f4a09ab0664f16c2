"""rot: the rotated layer boundary, one C call: layer i's o_proj, residual
and FFN block (oproj_ffn), then layer i + 1's attention input (attn_in: rms
norm, wqk / wv or the two slots of phi3's wqkv (ops.attn_in.qkv_slots),
bf16 round, NEOX rope) on its output.

Kernel: ``csrc/rot.cu`` (replaces ``tpu_kquant/ops/attic/pallas_rot.py:
fused_oproj_ffn_attn_in``; the reference keeps it in ``attic``, measured as
a wash on its TPU and off by default). ``models.llama`` dispatches to it as
the reference does (``tpu_kquant/models/llama.py:181-205``, ``:337-340``,
``:415-439``): with ``TKQ_ROTATE_LAYER=1`` and ``TKQ_FUSE_OPROJ`` not "0",
for every layer but the last where ``rot_supported`` passes on that layer's
o_proj / FFN weights and the next layer's projections; the next layer then
takes the returned qk / v in place of its own attn_in.

``rot_plain`` is ``oproj_ffn_plain`` then ``attn_in_plain`` on its output.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.attn_in import attn_in_plain, attn_in_supported
from tpu_kquant_torch.ops.ffn import (_aligned, _fused_arrays, fused_ws_floats, gate_up_plan,
                                      gelu_flag, oproj_ffn_plain, oproj_ffn_supported)
from tpu_kquant_torch.ops.qmm import gemv_plan, row_stride
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("rot")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_W = [_I, _P, _P, _P]  # a weight: kind code, codes, scales, mins
#            oproj_ffn attn_in (entry addresses) x attn nw eps wo gu
#            dn: kind qs scl  x2  act ws  y   nw2
_ARGTYPES = [_P, _P, _P, _P, _P, _F, *_W, *_W, _I, _P, _P, _P, _P, _P, _P, _P,
             # wqk2 wv2  cos sin qk2 v2
             *_W, *_W, _P, _P, _P, _P,
             # R  dim K   F   n0  n1  hd  ld0 ld1 cps_o splits_o cps_g splits_g cps_d
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             # splits_d
             _I,
             # gelu stream
             _I, _P]


def rot_supported(wo: QTensor, gu: QTensor, dn: QTensor, ws2: list[QTensor], rows: int,
                  dim: int, head_dim: int) -> bool:
    """The dispatch gate: the reference's (pallas_rot.rot_supported:
    oproj_ffn's gate on this layer's weights and attn_in's on the next
    layer's [wqk, wv]), with the port's attn_in gate, which adds its
    kernel's head_dim rule."""
    return (oproj_ffn_supported(wo, gu, dn, rows)
            and attn_in_supported(ws2[0], ws2[1], rows, dim, head_dim))


def rot_enabled(impl: str, wo: QTensor, gu: QTensor, dn: QTensor, ws2: list[QTensor],
                rows: int, dim: int, head_dim: int) -> bool:
    """models.llama's gate: TKQ_ROTATE_LAYER=1 and TKQ_FUSE_OPROJ not "0"
    (both read at call time), impl "auto" or "int8" (pallas_rot.rot_enabled)
    and rot_supported."""
    return (os.environ.get("TKQ_ROTATE_LAYER", "0") == "1"
            and os.environ.get("TKQ_FUSE_OPROJ", "1") == "1" and impl in ("auto", "int8")
            and rot_supported(wo, gu, dn, ws2, rows, dim, head_dim))


def rot_plain(x: torch.Tensor, attn: torch.Tensor, wo: QTensor, norm_w: torch.Tensor,
              eps: float, gu: QTensor, dn: QTensor, norm_w2: torch.Tensor, wqk2: QTensor,
              wv2: QTensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int,
              act_fn: str = "silu"):
    """x [R, dim], attn [R, K] bf16, cos / sin [R, hd/2] -> (y [R, dim],
    qk2 [R, n0] roped, v2 [R, n1]), bf16."""
    y = oproj_ffn_plain(x, attn, wo, norm_w, eps, gu, dn, act_fn)
    qk2, v2 = attn_in_plain(y, norm_w2, eps, wqk2, wv2, cos, sin, head_dim)
    return y, qk2, v2


def fused_oproj_ffn_attn_in(x: torch.Tensor, attn: torch.Tensor, wo: QTensor,
                            norm_w: torch.Tensor, eps: float, gu: QTensor, dn: QTensor,
                            norm_w2: torch.Tensor, wqk2: QTensor, wv2: QTensor,
                            cos: torch.Tensor, sin: torch.Tensor, head_dim: int,
                            act_fn: str = "silu"):
    """x [..., dim], attn [..., K] bf16, cos / sin [..., hd/2] per row ->
    (y [..., dim], qk2 [..., n0] roped, v2 [..., n1]), bf16; act_fn "silu"
    or "gelu". CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    gelu = gelu_flag(act_fn)
    dim, K = int(wo.shape[0]), int(wo.shape[1])
    Fd = int(dn.shape[1])
    n0, n1 = int(wqk2.shape[0]), int(wv2.shape[0])
    half = head_dim // 2
    lead = x.shape[:-1]
    x2d, a2d = x.reshape(-1, dim), attn.reshape(-1, K)
    c2d, s2d = cos.reshape(-1, half), sin.reshape(-1, half)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        y, qk2, v2 = rot_plain(x2d, a2d, wo, norm_w, eps, gu, dn, norm_w2, wqk2, wv2, c2d, s2d,
                               head_dim, act_fn)
        return y.reshape(*lead, dim), qk2.reshape(*lead, n0), v2.reshape(*lead, n1)
    R = x2d.shape[0]
    req = _build.require
    req(x.device.type == "cuda", f"rot: unsupported device {x.device}")
    req(rot_supported(wo, gu, dn, [wqk2, wv2], R, dim, head_dim),
        "rot: unsupported layout or shape")
    req(x.dtype == torch.bfloat16 and attn.dtype == torch.bfloat16, "rot: x/attn dtype")
    req(a2d.shape[0] == R, "rot: x and attn rows differ")
    req(n0 % head_dim == 0 and c2d.shape == (R, half) and s2d.shape == (R, half),
        "rot: rope tables must be [rows, head_dim / 2]")
    req(norm_w.shape == norm_w2.shape == (dim,)
        and norm_w.dtype == norm_w2.dtype == torch.float32, "rot: norm weights")
    wts = _fused_arrays("rot", x, wo, gu, dn) + _fused_arrays("rot", x, wqk2, wv2, strided=True)
    cps_o, splits_o = gemv_plan(wts[0][0], dim, K)
    cps_g, splits_g = gate_up_plan(wts[1][0], Fd, dim)
    cps_d, splits_d = gemv_plan(wts[2][0], dim, Fd)
    dev = x.device
    x2d, a2d = x2d.contiguous(), a2d.contiguous()
    c2d, s2d = c2d.float().contiguous(), s2d.float().contiguous()
    nw, nw2 = _aligned(norm_w), norm_w2.contiguous()
    x2 = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    act = torch.empty((R, Fd), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(fused_ws_floats(R, dim, Fd, splits_o, splits_g, splits_d),
                     dtype=torch.float32, device=dev)
    y = torch.empty((R, dim), dtype=torch.bfloat16, device=dev)
    qk2 = torch.empty((R, n0), dtype=torch.bfloat16, device=dev)
    v2 = torch.empty((R, n1), dtype=torch.bfloat16, device=dev)
    P = _build.ptr
    args = [[code] + [None if a is None else P(a) for a in arrs] for code, arrs in wts]
    lib = _build.load("rot", "tkq_rot", _ARGTYPES)
    rc = lib.tkq_rot(_build.address("ffn", "tkq_oproj_ffn"),
                     _build.address("attn_in", "tkq_attn_in"), P(x2d), P(a2d), P(nw), float(eps),
                     *args[0], *args[1], *args[2][:3],
                     P(x2), P(act), P(ws), P(y), P(nw2), *args[3], *args[4], P(c2d), P(s2d),
                     P(qk2), P(v2), R, dim, K, Fd, n0, n1, head_dim, row_stride(wts[3][1][0]),
                     row_stride(wts[4][1][0]), cps_o, splits_o, cps_g, splits_g, cps_d, splits_d,
                     gelu, _build.stream_ptr(dev))
    _build.check(lib, rc, "rot")
    counter.launches += 1
    return y.reshape(*lead, dim), qk2.reshape(*lead, n0), v2.reshape(*lead, n1)
