"""Flash decode attention: one query token per batch row against S cache
slots, GQA, bf16 or int8 KV.

Kernel: ``csrc/decode_attn.cu`` (replaces ``tpu_kquant/ops/pallas_attention.py:
attention_decode_pallas``, kernel ``_attn_kernel``). It runs an online
softmax over 64-slot K/V tiles up to each row's position and never writes a
[B, H, S] logit to device memory, which is why the dispatch
(``ops.attention``) sends it the decode steps whose plain logits would pass
the budget: many concurrent sequences, as in serving.

Layout at the public face, as the reference's: q [B, 1, H, D] (bf16, or f32
where qwen2's biases make it so); k/v [B, Hkv, S, D] heads-major, bf16 or
int8 with ``kv_scales`` (k_scale, v_scale) [B, Hkv, S] f32; ``q_positions``
[B, 1]: slot j is live while j <= the row's position. Returns [B, 1, H, D]
in q's dtype. The reference kernel rounds q to bf16 and returns q's dtype;
so does the kernel (an f32 q is rounded by the wrapper, the output is
written in f32).

``decode_attention_plain`` is the same function in plain PyTorch, in f32
with the kernel's rounding points: q, k and v rounded to bf16 (int8 codes
are exact in bf16), logits times ``scale`` then times the K scale of their
slot, slots past the position at -1e30, the softmax sum taken before the V
scales apply, and p times the V scale rounded to bf16 before it meets v. It
takes the softmax over the whole row at once; the kernel takes it tile by
tile, which changes only the order of f32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.ops import _build

counter = _build.LaunchCounter("decode_attn")

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#           kv_i8 D   q   sqb k   skb skh v   svb svh ks  ssb ssh vs  svsb svsh
_ARGTYPES = [_I, _I, _P, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
             # q_pos out out_f32 B  H  Hkv S  scale           stream
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
KERNEL_HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per KV head the kernel takes
SPLIT_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100


def attn_splits(B: int, Hkv: int, S: int) -> tuple[int, int]:
    """(tiles per split, splits) of the attention phase of attn_out and
    layer (csrc/decode_attn.cuh): enough splits of the S / 64 cache tiles
    that the B * Hkv * splits blocks reach SPLIT_TARGET_BLOCKS, from the
    shapes alone (the positions stay on the device)."""
    n_tiles = -(-S // 64)
    want = max(1, min(n_tiles, -(-SPLIT_TARGET_BLOCKS // (B * Hkv))))
    tps = -(-n_tiles // want)
    return tps, -(-n_tiles // tps)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_positions: torch.Tensor, kv_scales=None,
                           scale: float | None = None) -> torch.Tensor:
    """Plain version of the kernel (module docstring)."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    qg = bf(q[:, 0]).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, bf(k)) * scale
    if kv_scales is not None:
        s = s * kv_scales[0].float()[:, :, None, :]
    live = torch.arange(S, device=q.device)[None, :] <= q_positions.long()[:, :1]  # [B, S]
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if kv_scales is not None:
        p = p * kv_scales[1].float()[:, :, None, :]
    out = torch.einsum("bhgs,bhsd->bhgd", bf(p), bf(v)) / l
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention_decode_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_positions: torch.Tensor, kv_scales=None,
                           scale: float | None = None) -> torch.Tensor:
    """Flash decode attention (module docstring). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        counter.plain_calls += 1
        return decode_attention_plain(q, k, v, q_positions, kv_scales, scale)
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    req = _build.require
    req(q.device.type == "cuda", f"decode_attn: unsupported device {q.device}")
    req(all(t.device == q.device for t in (k, v, q_positions)),
        "decode_attn: inputs on several devices")
    req(T == 1, f"decode_attn: one query token per row, got T = {T}")
    req(D in KERNEL_HEAD_DIMS, f"decode_attn: head_dim {D} (the kernel takes {KERNEL_HEAD_DIMS})")
    req(q.dtype in (torch.bfloat16, torch.float32), f"decode_attn: q dtype {q.dtype}")
    req(H % Hkv == 0 and H // Hkv <= MAX_GROUP and k.shape == (B, Hkv, S, D)
        and v.shape == k.shape,
        f"decode_attn: q {tuple(q.shape)} against k {tuple(k.shape)}, v {tuple(v.shape)}")
    req(S % 64 == 0, f"decode_attn: S = {S} is not a multiple of 64")
    quant = kv_scales is not None
    req(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
        f"decode_attn: k/v dtype {k.dtype}/{v.dtype} with{'' if quant else 'out'} scales")
    req(q_positions.shape == (B, 1), "decode_attn: q_positions must be [B, 1]")
    esz = k.element_size()
    for t in (k, v):  # strided views of the cache: rows of D dense and 16-byte aligned
        req(t.stride(3) == 1 and t.stride(2) == D, "decode_attn: k/v rows must be dense [.., S, D]")
        req(t.data_ptr() % 16 == 0 and t.stride(0) * esz % 16 == 0
            and t.stride(1) * esz % 16 == 0, "decode_attn: k/v must be 16-byte aligned")
    if quant:
        for t in kv_scales:
            req(t.shape == (B, Hkv, S) and t.dtype == torch.float32 and t.stride(2) == 1
                and t.device == q.device, "decode_attn: scales must be f32 [B, Hkv, S], dense "
                                          "along S")
    out_f32 = q.dtype == torch.float32
    qb = q[:, 0].to(torch.bfloat16)
    if not (qb.stride(2) == 1 and qb.stride(1) == D):
        qb = qb.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    P = _build.ptr
    scales = [a for t in kv_scales for a in (P(t), t.stride(0), t.stride(1))] if quant \
        else [None, 0, 0] * 2
    qp32 = q_positions[:, 0].to(torch.int32).contiguous()
    lib = _build.load("decode_attn", "tkq_decode_attn", _ARGTYPES)
    rc = lib.tkq_decode_attn(int(quant), D, P(qb), qb.stride(0),
                             P(k), k.stride(0), k.stride(1), P(v), v.stride(0), v.stride(1),
                             *scales, P(qp32), P(out), int(out_f32), B, H, Hkv, S,
                             float(scale), _build.stream_ptr(q.device))
    _build.check(lib, rc, "decode_attn")
    counter.launches += 1
    return out
