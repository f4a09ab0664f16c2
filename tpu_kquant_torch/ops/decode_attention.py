"""Flash decode attention: one query token per batch row against S cache
slots, GQA, bf16 or int8 KV.

Kernel: ``csrc/decode_attn.cu`` (replaces ``tpu_kquant/ops/pallas_attention.py:
attention_decode_pallas``, kernel ``_attn_kernel``). It runs an online
softmax over 64-slot K/V tiles up to each row's position on tensor cores,
splits each row's cache into runs of ``decode_plan``'s tiles (a plan free
of B, so a row's result is the same bits at any batch size), and never
writes a [B, H, S] logit to device memory, which is why the dispatch
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
tile, which changes only the order of f32 sums. ``decode_attention_split_
plain`` takes it in the kernel's blocks (each split's four 16-slot lanes of
every tile, rescaled to their common max, then the live splits'), so that
the tests hold the combine to the one-pass version.
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
             # q_pos out out_f32 B  H  Hkv S  scale           tps splits part items stream
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P]
KERNEL_HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per KV head the kernel takes
SPLIT_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100
TILE = 64  # cache slots a tile
LANES = 4  # the kernel's warps: warp w takes slots [16 w, 16 w + 16) of each tile
SPLIT_BYTES = 1 << 17  # cache bytes (K, V and scales of a KV head) a split of #7 reads


def decode_plan(S: int, D: int, kv_int8: bool) -> tuple[int, int]:
    """(tiles per split, splits) of the flash decode kernel (#7): runs of
    tiles that read about SPLIT_BYTES of one KV head's cache each, from S,
    the head dim and the KV dtype alone. Never from B: a row's splits, and
    so its sums, do not depend on the other rows of the call. A row reads
    only its live splits (the device knows its position)."""
    slot = 2 * D + 8 if kv_int8 else 4 * D
    n_tiles = -(-S // TILE)
    tps = max(1, min(n_tiles, SPLIT_BYTES // (TILE * slot)))
    return tps, -(-n_tiles // tps)


def attn_splits(B: int, Hkv: int, S: int) -> tuple[int, int]:
    """(tiles per split, splits) of the attention phase of attn_out and
    layer (csrc/decode_attn.cuh, the CUDA-core kernel they keep): enough
    splits of the S / 64 cache tiles that the B * Hkv * splits blocks reach
    SPLIT_TARGET_BLOCKS, from the shapes alone (the positions stay on the
    device)."""
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


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 q_positions: torch.Tensor, kv_scales=None,
                                 scale: float | None = None, tps: int | None = None
                                 ) -> torch.Tensor:
    """decode_attention_plain taken in the kernel's blocks: each (split of
    ``tps`` tiles, lane of 16 slots) block's max, sum and accumulator over
    its live slots, the LANES blocks of a split rescaled to their common
    max, then the splits'. Blocks without a live slot weigh 0 (the kernel
    runs no split past its row's last live tile)."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    tps = decode_plan(S, D, kv_scales is not None)[0] if tps is None else tps
    splits = -(-S // (TILE * tps))
    pad = lambda x: torch.nn.functional.pad(x, (0, splits * tps * TILE - S))  # noqa: E731
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    qg = bf(q[:, 0]).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, bf(k)) * scale
    vsc = torch.ones(B, Hkv, S, device=q.device)
    if kv_scales is not None:
        s = s * kv_scales[0].float()[:, :, None, :]
        vsc = kv_scales[1].float()
    live = torch.arange(S, device=q.device)[None, :] <= q_positions.long()[:, :1]  # [B, S]
    blocks = (splits, tps, LANES, TILE // LANES)  # slot ((z tps + t) LANES + w) 16 + i
    lv = pad(live[:, None, None, :].expand(B, Hkv, G, S)).reshape(B, Hkv, G, *blocks)
    s = torch.where(lv, pad(s).reshape(B, Hkv, G, *blocks), _NEG_INF)
    m = s.amax(dim=(4, 6), keepdim=True)
    p = torch.where(lv, torch.exp(s - m), 0.0)
    l = p.sum(dim=(4, 6))  # [B, Hkv, G, splits, LANES]
    pv = bf(p * pad(vsc).reshape(B, Hkv, 1, *blocks))
    vb = pad(bf(v).transpose(2, 3)).reshape(B, Hkv, D, *blocks)
    o = torch.einsum("bhgztwi,bhdztwi->bhgzwd", pv, vb)
    m = m[:, :, :, :, 0, :, 0]
    for dim in (4, 3):  # the lanes of a split, then the splits
        mm = m.amax(dim=dim, keepdim=True)
        w = torch.exp(m - mm)
        l = (l * w).sum(dim=dim)
        o = (o * w[..., None]).sum(dim=dim)
        m = mm.squeeze(dim)
    return (o / l[..., None]).reshape(B, 1, H, D).to(q.dtype)


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
            req(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0,
                "decode_attn: scale rows must be 16-byte aligned")
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
    tps, splits = decode_plan(S, D, quant)
    part = torch.empty(B * H * splits * (D + 2) if splits > 1 else 1, dtype=torch.float32,
                       device=q.device)
    items = torch.empty(B * splits + 2, dtype=torch.int32, device=q.device)
    lib = _build.load("decode_attn", "tkq_decode_attn", _ARGTYPES)
    rc = lib.tkq_decode_attn(int(quant), D, P(qb), qb.stride(0),
                             P(k), k.stride(0), k.stride(1), P(v), v.stride(0), v.stride(1),
                             *scales, P(qp32), P(out), int(out_f32), B, H, Hkv, S,
                             float(scale), tps, splits, P(part), P(items),
                             _build.stream_ptr(q.device))
    _build.check(lib, rc, "decode_attn")
    counter.launches += 1
    return out
