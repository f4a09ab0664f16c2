"""layer: one whole decode layer for rows <= 4 in one C call.

Kernel: ``csrc/layer.cu`` (replaces ``tpu_kquant/ops/pallas_layer.py:
fused_layer``). ``models.llama`` dispatches to it as the reference does
(``tpu_kquant/models/llama.py:321-331``, ``:373-398``): with
``TKQ_FUSE_LAYER=1`` (default off; it also turns the deferred append off for
the whole forward) at T = 1 on a bf16 unified cache, where
``layer_supported`` passes. Attention reads the cache BEFORE this step's
append (slots < position) and folds the current token's k and v in from the
QKV phase; the caller appends the returned (k_new, v_new) afterwards
(``KVCache.append``).

``layer_plain`` is the same function in plain PyTorch with the kernel's
rounding points: ``attn_in_plain`` (normalised row f32, projections rounded
to bf16, then the rope), attention over the live cache slots with p rounded
to bf16 against bf16 rows plus the current token's f32 p against its v, the
head outputs rounded to bf16, x2 = bf16(x + bf16(att @ Wo^T)), then the FFN
tail of ``ops.ffn`` (gate, up and their silu or gelu product rounded to bf16, y =
bf16(x2 + act @ Wd^T)). The TPU kernel also rounds the normalised rows to
bf16 before its matmuls; the tests hold the two to the reference's
tolerances.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.attn_in import attn_in_plain
from tpu_kquant_torch.ops.decode_attention import MAX_GROUP, attend_with_current, \
    fused_attn_plan
from tpu_kquant_torch.ops.ffn import (_FLAT_KINDS, _aligned, _ffn_tail, _fused_arrays,
                                      _pick_tf, fused_ws_floats, gate_up_plan, gelu_flag)
from tpu_kquant_torch.ops.qmm import gemv_plan, kernel_kind
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("layer")

MAX_ROWS = 4
_KINDS = ("q4",) + _FLAT_KINDS
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_W = [_I, _P, _P, _P]  # a weight: kind code, codes, scales, mins
#            attn_in oproj_ffn (entry addresses) x anw fnw eps  wqk, wv, wo, gu
#            dn: kind qs scl  cos sin
_ARGTYPES = [_P, _P, _P, _P, _P, _F, *_W, *_W, *_W, *_W, _I, _P, _P, _P, _P,
             # kc skb skh vc svb svh q_pos qk v   att x2  act ws  y
             _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
             # R  D   H   Hkv hd  S   F   scale tps splits cps_o splits_o
             _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
             # cps_g splits_g cps_d splits_d
             _I, _I, _I, _I,
             # gelu stream
             _I, _P]


def layer_supported(wqk: QTensor, wv: QTensor, wo: QTensor, gu: QTensor, dn: QTensor,
                    rows: int, D: int, H: int, Hkv: int, hd: int) -> bool:
    """The dispatch gate: the reference's (pallas_layer.layer_supported: rows
    <= 4, D % 512, head_dim 64 or 128, every weight kmajor q4 / q6w / q8
    without k-pair "sp" scales, wqk [(H + Hkv) hd, D], wv [Hkv hd, D], wo
    [D, H hd] with H hd % 1024, w_gateup [2F, D], a flat w_down [D, F] and
    ``_pick_tf(F, D) != 0``: the TPU kernel's F tile within its VMEM cap, a
    TPU constraint kept so that both packages fuse at the same shapes); then
    what the kernels need: scale layouts they read and at most 16 query heads
    per KV head."""
    if rows > MAX_ROWS or D % 512 or hd not in (64, 128):
        return False
    ws = (wqk, wv, wo, gu, dn)
    if any(w.layout != "kmajor" or w.kind not in _KINDS or "sp" in w.arrays for w in ws):
        return False
    if tuple(wqk.shape) != ((H + Hkv) * hd, D) or tuple(wv.shape) != (Hkv * hd, D):
        return False
    if wo.shape[0] != D or wo.shape[-1] != H * hd or (H * hd) % 1024:
        return False
    F = int(dn.shape[-1])
    if tuple(gu.shape) != (2 * F, D) or dn.shape[0] != D:
        return False
    if dn.kind not in _FLAT_KINDS or _pick_tf(F, D) == 0:
        return False
    return (all(kernel_kind(w) is not None for w in ws)
            and H % Hkv == 0 and H // Hkv <= MAX_GROUP)


def layer_enabled(impl: str, *args) -> bool:
    """models.llama's gate: TKQ_FUSE_LAYER=1 (read at call time, default
    off), impl "auto" or "int8" (pallas_layer.layer_enabled) and
    layer_supported(*args)."""
    return (os.environ.get("TKQ_FUSE_LAYER", "0") == "1" and impl in ("auto", "int8")
            and layer_supported(*args))


def layer_plain(x, positions, anw, fnw, eps, wqk, wv, wo, gu, dn, cos, sin, k_cache, v_cache,
                H: int, Hkv: int, att: torch.Tensor | None = None, act_fn: str = "silu"):
    """Plain version of fused_layer (module docstring); `att` as
    fused_layer's."""
    B, _, D = x.shape
    hd = int(wqk.shape[0]) // (H + Hkv)
    x2d = x.reshape(B, D)
    qk, v = attn_in_plain(x2d, anw, eps, wqk, wv, cos.reshape(B, -1), sin.reshape(B, -1), hd)
    k_new, v_new = qk[:, H * hd:].reshape(B, Hkv, hd), v.reshape(B, Hkv, hd)
    a = attend_with_current(qk[:, :H * hd].reshape(B, H, hd), k_cache, v_cache, positions,
                            k_new, v_new)
    if att is not None:
        att.copy_(a)
    h = (a.float() @ dequant_kmajor(wo)).to(torch.bfloat16).float()
    x2 = (x2d.float() + h).to(torch.bfloat16).float()
    y = _ffn_tail(x2, fnw, eps, gu, dn, act_fn).to(torch.bfloat16)
    return y.reshape(B, 1, D), k_new.reshape(B, 1, Hkv, hd), v_new.reshape(B, 1, Hkv, hd)


def fused_layer(x: torch.Tensor, positions: torch.Tensor, anw: torch.Tensor, fnw: torch.Tensor,
                eps: float, wqk: QTensor, wv: QTensor, wo: QTensor, gu: QTensor, dn: QTensor,
                cos: torch.Tensor, sin: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, H: int, Hkv: int, act_fn: str = "silu",
                att: torch.Tensor | None = None):
    """One decode layer: x [B, 1, D] bf16, positions [B, 1], cos / sin
    [B, 1, hd/2] f32, k_cache / v_cache [B, Hkv, S, hd] bf16, PRE-append.
    Returns (y [B, 1, D], k_new [B, 1, Hkv, hd], v_new [B, 1, Hkv, hd]), bf16;
    the caller appends k_new / v_new. `att`, where given, is a bf16
    [B, H * hd] tensor that receives the attention phase's head outputs (the
    kernel's scratch), so that a check can hold that phase per row. act_fn:
    the FFN's activation, "silu" or "gelu". CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    gelu = gelu_flag(act_fn)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return layer_plain(x, positions, anw, fnw, eps, wqk, wv, wo, gu, dn, cos, sin, k_cache,
                           v_cache, H, Hkv, att, act_fn)
    B, T, D = x.shape
    hd = int(wqk.shape[0]) // (H + Hkv)
    F = int(dn.shape[-1])
    S = k_cache.shape[2]
    req = _build.require
    req(x.device.type == "cuda", f"layer: unsupported device {x.device}")
    req(T == 1, f"layer: one token per row, got T = {T}")
    req(layer_supported(wqk, wv, wo, gu, dn, B, D, H, Hkv, hd), "layer: unsupported layout "
                                                                "or shape")
    req(x.dtype == torch.bfloat16, f"layer: x dtype {x.dtype}")
    req(all(t.device == x.device for t in (positions, cos, sin, k_cache, v_cache)),
        "layer: inputs on several devices")
    req(k_cache.dtype == v_cache.dtype == torch.bfloat16 and k_cache.shape == (B, Hkv, S, hd)
        and v_cache.shape == k_cache.shape, "layer: the cache must be bf16 [B, Hkv, S, hd]")
    for t in (k_cache, v_cache):
        req(t.stride(3) == 1 and t.stride(2) == hd and t.data_ptr() % 16 == 0
            and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0,
            "layer: cache rows must be dense [.., S, hd] and 16-byte aligned")
    req(positions.shape == (B, 1), "layer: positions must be [B, 1]")
    req(anw.shape == fnw.shape == (D,) and anw.dtype == fnw.dtype == torch.float32,
        "layer: norm weights")
    c2d = cos.reshape(B, hd // 2).float().contiguous()
    s2d = sin.reshape(B, hd // 2).float().contiguous()
    req(c2d.shape == (B, hd // 2), "layer: rope tables must be [B, 1, head_dim / 2]")
    wts = _fused_arrays("layer", x, wqk, wv, wo, gu, dn)
    cps_o, splits_o = gemv_plan(wts[2][0], D, H * hd)
    cps_g, splits_g = gate_up_plan(wts[3][0], F, D)
    cps_d, splits_d = gemv_plan(wts[4][0], D, F)
    dev = x.device
    n0, n1 = (H + Hkv) * hd, Hkv * hd
    qk = torch.empty((B, n0), dtype=torch.bfloat16, device=dev)
    v = torch.empty((B, n1), dtype=torch.bfloat16, device=dev)
    if att is None:
        att = torch.empty((B, H * hd), dtype=torch.bfloat16, device=dev)
    req(att.shape == (B, H * hd) and att.dtype == torch.bfloat16 and att.is_contiguous()
        and att.device == dev, "layer: att must be a dense bf16 [B, H * hd] tensor")
    x2 = torch.empty((B, D), dtype=torch.bfloat16, device=dev)
    act = torch.empty((B, F), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(fused_ws_floats(B, D, F, splits_o, splits_g, splits_d), dtype=torch.float32,
                     device=dev)
    y = torch.empty((B, 1, D), dtype=torch.bfloat16, device=dev)
    tps, a_splits = fused_attn_plan(S)
    qp = positions[:, 0].long().contiguous()  # read in place: no copy
    x2d, anw, fnw = x.reshape(B, D).contiguous(), anw.contiguous(), _aligned(fnw)
    P = _build.ptr
    w_args = []
    for code, arrs in wts[:4]:
        w_args += [code] + [None if a is None else P(a) for a in arrs]
    dn_code, dn_arrs = wts[4]
    lib = _build.load("layer", "tkq_layer", _ARGTYPES)
    rc = lib.tkq_layer(_build.address("attn_in", "tkq_attn_in"),
                       _build.address("ffn", "tkq_oproj_ffn"), P(x2d), P(anw), P(fnw),
                       float(eps),
                       *w_args, dn_code, P(dn_arrs[0]), P(dn_arrs[1]), P(c2d), P(s2d),
                       P(k_cache), k_cache.stride(0), k_cache.stride(1), P(v_cache),
                       v_cache.stride(0), v_cache.stride(1), P(qp), P(qk), P(v), P(att),
                       P(x2), P(act), P(ws), P(y), B, D, H, Hkv, hd, S, F, float(hd) ** -0.5,
                       tps, a_splits, cps_o, splits_o, cps_g, splits_g, cps_d,
                       splits_d, gelu, _build.stream_ptr(dev))
    _build.check(lib, rc, "layer")
    counter.launches += 1
    return y, qk[:, H * hd:].reshape(B, 1, Hkv, hd), v.reshape(B, 1, Hkv, hd)
