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

The few-row attention of attn_out (#10) and layer (#11) runs on the same
tensor-core core (``csrc/decode_attn.cuh``), split by ``fused_attn_plan``
(S alone) and combined inside its launch by a thread-block cluster;
``fused_attention`` runs that phase alone, and ``attend_with_current`` is
layer's variant in plain PyTorch (the cache below the position plus the
current token).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.ops import _build

counter = _build.LaunchCounter("decode_attn")
fused_counter = _build.LaunchCounter("fused_attn")

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#           kv_i8 D   q   sqb k   skb skh v   svb svh ks  ssb ssh vs  svsb svsh
_ARGTYPES = [_I, _I, _P, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
             # q_pos out out_f32 B  H  Hkv S  scale           tps splits part items stream
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P]
#                 kv_i8 D   q   sqb k   skb skh v   svb svh ks  ssb ssh vs  svsb svsh
_FUSED_ARGTYPES = [_I, _I, _P, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
                   # q_pos kn sknb vn svnb out B  H  Hkv S  scale           tps splits stream
                   _P, _P, _L, _P, _L, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]
KERNEL_HEAD_DIMS = (64, 128, 256)  # #7's instances (csrc/decode_attn.cu)
FUSED_HEAD_DIMS = (64, 128)  # the few-row kernel's (#10 / #11: their gates' head dims)
MAX_GROUP = 16  # query heads per KV head the kernel takes
TILE = 64  # cache slots a tile
LANES = 4  # the kernel's warps: warp w takes slots [16 w, 16 w + 16) of each tile
SPLIT_BYTES = 1 << 17  # cache bytes (K, V and scales of a KV head) a split of #7 reads
FUSED_MAX_SPLITS = 8  # the few-row kernel's splits of a row: one portable cluster


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


def fused_attn_plan(S: int) -> tuple[int, int]:
    """(tiles per split, splits) of the few-row attention of attn_out (#10)
    and layer (#11) (csrc/decode_attn.cuh:fused_attn_kernel): as many splits
    of the ceil(S / 64) cache tiles as a portable thread-block cluster holds
    (FUSED_MAX_SPLITS), each of as few tiles as that allows, so that a few
    rows still spread their cache over many blocks. From S alone: never B
    (a row's sums do not depend on the other rows of the call) and never the
    positions (they stay on the device)."""
    n_tiles = -(-S // TILE)
    tps = max(1, -(-n_tiles // FUSED_MAX_SPLITS))
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


def _combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, dim: int):
    """The blocks along `dim` of (max m, sum l, accumulator o [..., D])
    rescaled to their common max and added in block order."""
    mm = m.amax(dim=dim)
    w = torch.exp(m - mm.unsqueeze(dim))
    L, O = torch.zeros_like(mm), torch.zeros_like(o.select(dim, 0))
    for i in range(m.shape[dim]):
        L = L + l.select(dim, i) * w.select(dim, i)
        O = O + o.select(dim, i) * w.select(dim, i)[..., None]
    return mm, L, O


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 q_positions: torch.Tensor, kv_scales=None,
                                 scale: float | None = None, tps: int | None = None,
                                 kv_cur=None, round_p: bool = True) -> torch.Tensor:
    """decode_attention_plain taken in the kernels' blocks: each (split of
    ``tps`` tiles, lane of 16 slots) block's max, sum and accumulator over
    its live slots, the LANES blocks of a split rescaled to their common
    max in lane order, then the splits' in split order. Blocks without a
    live slot weigh 0 (#7 runs no split past its row's last live tile; the
    few-row kernel's such ranks leave m = -1e30, l = 0). ``tps`` defaults to
    #7's ``decode_plan``. With ``kv_cur`` = (k_cur, v_cur) [B, Hkv, D] it is
    the few-row kernel's current-token variant (attend_with_current): slots
    < the position live, then the current token folded in after the splits,
    its logit and p in f32 against its f32 v. ``round_p=False`` keeps p (times
    the V scale) in f32, where the kernels round it to bf16 against each
    block's own max, so that the blocking alone can be held to a one-pass
    softmax in f32."""
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
    lim = q_positions.long()[:, :1] + (0 if kv_cur is not None else 1)
    live = torch.arange(S, device=q.device)[None, :] < lim  # [B, S]
    blocks = (splits, tps, LANES, TILE // LANES)  # slot ((z tps + t) LANES + w) 16 + i
    lv = pad(live[:, None, None, :].expand(B, Hkv, G, S)).reshape(B, Hkv, G, *blocks)
    s = torch.where(lv, pad(s).reshape(B, Hkv, G, *blocks), _NEG_INF)
    m = s.amax(dim=(4, 6))  # [B, Hkv, G, splits, LANES]
    p = torch.where(lv, torch.exp(s - m[:, :, :, :, None, :, None]), 0.0)
    l = p.sum(dim=(4, 6))
    pv = p * pad(vsc).reshape(B, Hkv, 1, *blocks)
    pv = bf(pv) if round_p else pv
    vb = pad(bf(v).transpose(2, 3)).reshape(B, Hkv, D, *blocks)
    o = torch.einsum("bhgztwi,bhdztwi->bhgzwd", pv, vb)
    m, l, o = _combine(m, l, o, 4)  # the lanes of a split
    m, l, o = _combine(m, l, o, 3)  # the splits
    if kv_cur is not None:
        s_cur = torch.einsum("bhgd,bhd->bhg", qg, bf(kv_cur[0])) * scale
        mn = torch.maximum(m, s_cur)
        al, p_cur = torch.exp(m - mn), torch.exp(s_cur - mn)
        l = l * al + p_cur
        o = o * al[..., None] + p_cur[..., None] * bf(kv_cur[1])[:, :, None]
    return (o / l[..., None]).reshape(B, 1, H, D).to(q.dtype)


def check_cache(what: str, k: torch.Tensor, v: torch.Tensor, kv_scales) -> None:
    """What the kernels' cp.async tile loads need of the cache views k / v
    [B, Hkv, S, D] and the int8 scales [B, Hkv, S]: rows of D dense, every
    row and scale row 16-byte aligned, all on k's device."""
    B, Hkv, S, D = k.shape
    req = _build.require
    esz = k.element_size()
    for t in (k, v):  # strided views of the cache
        req(t.stride(3) == 1 and t.stride(2) == D, f"{what}: k/v rows must be dense [.., S, D]")
        req(t.data_ptr() % 16 == 0 and t.stride(0) * esz % 16 == 0
            and t.stride(1) * esz % 16 == 0, f"{what}: k/v must be 16-byte aligned")
    for t in kv_scales or ():
        req(t.shape == (B, Hkv, S) and t.dtype == torch.float32 and t.stride(2) == 1
            and t.device == k.device, f"{what}: scales must be f32 [B, Hkv, S], dense along S")
        req(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0,
            f"{what}: scale rows must be 16-byte aligned")


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
    check_cache("decode_attn", k, v, kv_scales)
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


def attend_with_current(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, k_cur: torch.Tensor,
                        v_cur: torch.Tensor) -> torch.Tensor:
    """The attention phase of layer (#11) in plain PyTorch: q [B, H, hd];
    k / v [B, Hkv, S, hd], slots < positions[b] live; k_cur / v_cur [B, Hkv,
    hd] the current token's, its logit and p in f32 against its f32 v (p of
    the cache slots rounded to bf16, as decode_attention_plain's). Returns
    [B, H * hd] bf16."""
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    qg = bf(q).reshape(B, Hkv, H // Hkv, D)
    scale = D ** -0.5
    s = torch.einsum("bhgd,bhsd->bhgs", qg, bf(k)) * scale
    live = torch.arange(S, device=q.device)[None, :] < positions.reshape(B, 1).long()
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    s_cur = torch.einsum("bhgd,bhd->bhg", qg, bf(k_cur)) * scale
    m = torch.maximum(s.amax(-1), s_cur)
    p = torch.exp(s - m[..., None])
    p_cur = torch.exp(s_cur - m)
    l = p.sum(-1) + p_cur
    out = torch.einsum("bhgs,bhsd->bhgd", bf(p), bf(v)) + p_cur[..., None] * bf(v_cur)[:, :, None]
    return (out / l[..., None]).reshape(B, H * D).to(torch.bfloat16)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_scales=None, kv_cur=None) -> torch.Tensor:
    """The attention phase of attn_out (#10) and layer (#11) alone
    (csrc/decode_attn.cu:tkq_fused_attn, the kernel those two launch): q
    [B, H, D] bf16, k / v [B, Hkv, S, D] (bf16, or int8 with ``kv_scales``),
    q_positions [B, 1]; scale D^-0.5. Without ``kv_cur`` slots <= the
    position are live (attn_out's); with ``kv_cur`` = (k_cur, v_cur) [B, Hkv,
    D] bf16 slots < the position, then the current token (layer's; bf16 KV).
    Returns [B, H * D] bf16. The main path runs the phase inside fused_attn_out and
    fused_layer; this entry point times it on its own and holds it to its
    plain versions (decode_attention_plain, attend_with_current). CPU
    tensors run those; CUDA tensors launch the kernel or raise."""
    B, H, D = q.shape
    if q.device.type == "cpu":
        fused_counter.plain_calls += 1
        if kv_cur is not None:
            return attend_with_current(q, k, v, q_positions, *kv_cur)
        out = decode_attention_plain(q[:, None].to(torch.bfloat16), k, v, q_positions,
                                     kv_scales)
        return out.reshape(B, H * D)
    Hkv, S = k.shape[1], k.shape[2]
    quant, self_ = kv_scales is not None, kv_cur is not None
    req = _build.require
    req(q.device.type == "cuda" and all(t.device == q.device for t in (k, v, q_positions)),
        f"fused_attn: inputs on {q.device} and others")
    req(q.dtype == torch.bfloat16 and q.stride(2) == 1 and q.stride(1) == D,
        "fused_attn: q must be bf16 [B, H, D] with dense heads")
    req(D in FUSED_HEAD_DIMS and H % Hkv == 0 and H // Hkv <= MAX_GROUP
        and k.shape == (B, Hkv, S, D) and v.shape == k.shape,
        f"fused_attn: q {tuple(q.shape)} against k {tuple(k.shape)}, v {tuple(v.shape)}")
    req(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16) and not (quant and self_),
        f"fused_attn: k/v dtype {k.dtype} with{'' if quant else 'out'} scales"
        f"{', with the current token' if self_ else ''}")
    req(self_ or S % TILE == 0, f"fused_attn: S = {S} is not a multiple of {TILE}")
    req(q_positions.shape == (B, 1), "fused_attn: q_positions must be [B, 1]")
    check_cache("fused_attn", k, v, kv_scales)
    P = _build.ptr
    cur = [None, 0, None, 0]
    if self_:
        for t in kv_cur:
            req(t.shape == (B, Hkv, D) and t.dtype == torch.bfloat16 and t.stride(2) == 1
                and t.stride(1) == D and t.device == q.device,
                "fused_attn: the current k / v must be bf16 [B, Hkv, D] with dense heads")
        cur = [P(kv_cur[0]), kv_cur[0].stride(0), P(kv_cur[1]), kv_cur[1].stride(0)]
    scales = [a for t in kv_scales for a in (P(t), t.stride(0), t.stride(1))] if quant \
        else [None, 0, 0] * 2
    out = torch.empty((B, H * D), dtype=torch.bfloat16, device=q.device)
    qp = q_positions[:, 0].long().contiguous()  # read in place: no copy
    tps, splits = fused_attn_plan(S)
    lib = _build.load("decode_attn", "tkq_fused_attn", _FUSED_ARGTYPES)
    rc = lib.tkq_fused_attn(int(quant), D, P(q), q.stride(0), P(k), k.stride(0), k.stride(1),
                            P(v), v.stride(0), v.stride(1), *scales, P(qp), *cur, P(out), B,
                            H, Hkv, S, float(D) ** -0.5, tps, splits,
                            _build.stream_ptr(q.device))
    _build.check(lib, rc, "fused_attn")
    fused_counter.launches += 1
    return out
