"""Flash prefill attention: causal GQA of T queries against S cache slots.

Kernel: ``csrc/prefill.cu`` (replaces ``tpu_kquant/ops/pallas_prefill.py:
attention_prefill_pallas``, kernel ``_prefill_kernel``), a TMA-fed,
warp-specialised wgmma kernel for Hopper. It runs an online softmax over
tiles of cache slots and never writes a [T, S] logit to device memory, which
is why the dispatch (``ops.attention``) sends it the long prompts whose
logits would be large.

The host plans the launch (``prefill_plan``): a work item is the rows of
one KV head that one block takes, 2 nq queries of hw of its query heads
(two warpgroups of nq queries x hw heads, at most 64 rows each), and a
persistent grid of min(items, SMs) blocks walks the items, the latest
(heaviest) query blocks first, in snake order (``block_items``). Each item
reads the cache tiles ``item_tiles`` gives: the reference's lo_tile ..
hi_tile for the item's queries at the kernel's tile size ``kv_tile``. With
int8 KV the kernel first converts the codes to bf16 copies (scratch the
wrapper allocates) and reads those, the scales applying as in the reference.

Layout at the public face, as the reference's: q [B, T, H, D]; k/v
[B, Hkv, S, D] heads-major, bf16 or int8 with ``kv_scales`` (k_scale,
v_scale) [B, Hkv, S] f32; ``q_start`` [B] the position of each row's first
query (positions are contiguous per row: query t sits at q_start + t, and
slot j holds position j). Returns [B, T, H, D] in q's dtype. q is bf16 or
f32: qwen2's biases make prefill's q f32, as in the reference, whose kernel
casts q to bf16 itself and returns q's dtype (pallas_prefill.py:69, 171).
Here the wrapper casts f32 q to bf16 before the kernel and widens the bf16
output after it, so the one rounding that differs from the reference is the
output's, to bf16 before it returns as f32 (the next qmm tile rounds its
input to bf16 anyway).

``attention_prefill_plain`` is the same function in plain PyTorch, in f32
with the kernel's operands: q, k and v rounded to bf16 (int8 codes are exact
in bf16), logits times ``scale`` then times the K scale of their column,
masked logits -1e30 with their probability forced to 0, the row sum taken
before the V scales apply, and the sum floored at 1e-20.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu_kquant_torch.ops import _build

counter = _build.LaunchCounter("prefill")

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#           kv_i8 D   q   sqb sqt sqh k   skb skh v   svb svh ks  ssb ssh vs  svsb svsh
_ARGTYPES = [_I, _I, _P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
             # kd vd (int8 KV's bf16 copies)
             _P, _P,
             # q_start out B  T  H  Hkv S  scale           window
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
             # hw nq hg nqb n_items grid stream
             _I, _I, _I, _I, _I, _I, _P]
KERNEL_HEAD_DIMS = (64, 128, 256)
ROWS = 64  # rows of one warpgroup: nq queries x hw heads fit in them


class Plan(NamedTuple):
    hw: int  # query heads of a warpgroup's rows
    nq: int  # queries of a warpgroup (hw * nq <= ROWS); an item takes 2 nq
    hg: int  # head groups of one KV head: G / hw
    nqb: int  # query blocks: ceil(T / (2 nq))
    n_items: int  # B * Hkv * hg * nqb
    grid: int  # persistent blocks: min(n_items, SMs)
    bn: int  # cache slots per tile (kv_tile)


def kv_tile(D: int, int8: bool) -> int:
    """Cache slots per tile of the kernel (csrc/prefill.cu:PfCfg::BN): 64 for
    int8 KV at head_dim 128 and at head_dim 256 (shared memory), else 128."""
    return 64 if D == 256 or (D == 128 and int8) else 128


def heads_per_group(G: int) -> int:
    """The query heads of a warpgroup's rows: all G of the KV head (nq =
    64 // G queries each; the largest divisor of G up to 64 where G > 64).
    Measured on an H100 (tools/prefill_sweep.py --rows, PERF.md §6):
    every divisor of G gives the same time within 2% at the phase-3
    prompts of T >= 40, and at the 1024-request burst (T = 64) one head per
    warpgroup leaves the second warpgroup without queries (2.1x slower)."""
    return max(d for d in range(1, min(G, ROWS) + 1) if G % d == 0)


def prefill_plan(B: int, T: int, H: int, Hkv: int, D: int, int8: bool, sms: int,
                 hw: int | None = None) -> Plan:
    """The kernel's launch plan (module docstring); ``hw`` (measurement
    tools and tests) overrides heads_per_group."""
    G = H // Hkv
    hw = hw or heads_per_group(G)
    if G % hw or hw > ROWS:
        raise ValueError(f"prefill: {hw} heads per row group of a GQA group of {G}")
    nq = ROWS // hw
    nqb = -(-T // (2 * nq))
    n_items = B * Hkv * (G // hw) * nqb
    return Plan(hw, nq, G // hw, nqb, n_items, max(1, min(n_items, sms)), kv_tile(D, int8))


def plan_item(plan: Plan, i: int, B: int, H: int, Hkv: int) -> tuple[int, int, int, int]:
    """Item i's (b, kv head, first query head, first query), as the kernel's
    item_of: query blocks in descending order, then b, KV head, head group."""
    per = B * Hkv * plan.hg
    qb = plan.nqb - 1 - i // per
    r = i % per
    g, r = r % plan.hg, r // plan.hg
    hk, b = r % Hkv, r // Hkv
    return b, hk, hk * (H // Hkv) + g * plan.hw, qb * 2 * plan.nq


def item_tiles(qs: int, t0: int, plan: Plan, T: int, S: int, window: int) -> tuple[int, int]:
    """(lo, hi) cache tiles of an item whose queries start at t0 on a row
    whose first query sits at qs: the reference's lo_tile / hi_tile
    (pallas_prefill.py) over the item's queries below T, at tile size
    plan.bn (lo > hi: no live tile)."""
    blk_lo, blk_hi = qs + t0, qs + min(t0 + 2 * plan.nq, T) - 1
    hi = min(blk_hi // plan.bn, -(-S // plan.bn) - 1)
    lo = max((blk_lo - (window - 1)) // plan.bn, 0) if window > 0 else 0
    return lo, hi


def block_items(plan: Plan, c: int) -> list[int]:
    """The items block c of the persistent grid takes, in order (snake:
    round k takes item k P + c, or k P + P - 1 - c in odd rounds)."""
    out, P = [], plan.grid
    for k in range(-(-plan.n_items // P)):
        i = k * P + (P - 1 - c if k % 2 else c)
        if i >= plan.n_items:
            break
        out.append(i)
    return out


_SMS: dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def prefill_supported(T: int, S: int, D: int) -> bool:
    """The reference's shape rule (pallas_prefill.prefill_supported)."""
    return T % 8 == 0 and D % 64 == 0 and S % 64 == 0 and T >= 8


def attention_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            q_start: torch.Tensor, kv_scales=None, scale: float | None = None,
                            sliding_window: int = 0) -> torch.Tensor:
    """Plain version of the kernel (module docstring)."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    qg = bf(q).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bhsd->bhgts", qg, bf(k)) * scale  # [B, Hkv, G, T, S]
    if kv_scales is not None:
        s = s * kv_scales[0].float()[:, :, None, None, :]
    q_pos = q_start.long()[:, None] + torch.arange(T, device=q.device)  # [B, T]
    kv = torch.arange(S, device=q.device)
    mask = kv[None, None, :] <= q_pos[:, :, None]  # [B, T, S]
    if sliding_window > 0:
        mask &= kv[None, None, :] > q_pos[:, :, None] - sliding_window
    mask = mask[:, None, None]
    s = torch.where(mask, s, _NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if kv_scales is not None:
        p = p * kv_scales[1].float()[:, :, None, None, :]
    out = torch.einsum("bhgts,bhsd->bthgd", p, bf(v)) / l.permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H, D).to(q.dtype)


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_start: torch.Tensor,
                      kv_scales=None, scale: float | None = None,
                      sliding_window: int = 0) -> torch.Tensor:
    """Flash prefill attention (module docstring). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        counter.plain_calls += 1
        return attention_prefill_plain(q, k, v, q_start, kv_scales, scale, sliding_window)
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    req = _build.require
    req(q.device.type == "cuda", f"prefill: unsupported device {q.device}")
    req(all(t.device == q.device for t in (k, v, q_start)), "prefill: inputs on several devices")
    req(D in KERNEL_HEAD_DIMS, f"prefill: head_dim {D} (the kernel takes {KERNEL_HEAD_DIMS})")
    req(q.dtype in (torch.bfloat16, torch.float32), f"prefill: q dtype {q.dtype}")
    q_dtype = q.dtype
    q = q.to(torch.bfloat16)
    req(H % Hkv == 0 and k.shape == (B, Hkv, S, D) and v.shape == k.shape,
        f"prefill: q {tuple(q.shape)} against k {tuple(k.shape)}, v {tuple(v.shape)}")
    req(S % 64 == 0, f"prefill: S = {S} is not a multiple of 64")
    quant = kv_scales is not None
    req(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
        f"prefill: k/v dtype {k.dtype}/{v.dtype} with{'' if quant else 'out'} scales")
    req(q_start.shape == (B,), "prefill: q_start must be [B]")
    esz = k.element_size()
    for t in (k, v):  # strided views of the cache: rows of D must be dense and 16-byte aligned
        req(t.stride(3) == 1 and t.stride(2) == D, "prefill: k/v rows must be dense [.., S, D]")
        req(t.data_ptr() % 16 == 0 and t.stride(0) * esz % 16 == 0 and t.stride(1) * esz % 16 == 0,
            "prefill: k/v must be 16-byte aligned")
    req(q.stride(3) == 1 and q.data_ptr() % 8 == 0 and all(s % 2 == 0 for s in q.stride()[:3]),
        "prefill: q's last axis must be dense and aligned")
    if quant:
        for t in kv_scales:
            req(t.shape == (B, Hkv, S) and t.dtype == torch.float32 and t.stride(2) == 1
                and t.device == q.device, "prefill: scales must be f32 [B, Hkv, S], dense along S")
    return _launch(q, k, v, q_start, kv_scales, scale, sliding_window).to(q_dtype)


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA takes t as it lies: 16-byte aligned, strides of 16-byte
    multiples that grow outwards."""
    esz, st = t.element_size(), t.stride()
    return t.data_ptr() % 16 == 0 and all(s * esz % 16 == 0 for s in st[:-1]) and \
        all(st[i] >= st[i + 1] * t.shape[i + 1] for i in range(t.dim() - 1))


def _launch(q, k, v, q_start, kv_scales, scale, sliding_window, lib=None,
            hw: int | None = None) -> torch.Tensor:
    """Launch the kernel on checked inputs (bf16 q) and return the bf16
    output. ``lib``: another build of csrc/prefill.cu (measurement tools);
    ``hw``: the plan's heads per row group (default: prefill_plan's)."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    quant = kv_scales is not None
    if not _tma_ready(q):
        q = q.contiguous()
    if quant and not all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
                         for t in kv_scales):  # the kernel's bulk copies need 16-byte rows
        kv_scales = tuple(t.contiguous() for t in kv_scales)
    P = _build.ptr
    # (pointer, batch stride, head stride) of each scale plane; null without
    scales = [a for t in kv_scales for a in (P(t), t.stride(0), t.stride(1))] if quant \
        else [None, 0, 0] * 2
    qs32 = q_start.to(torch.int32).contiguous()
    out = torch.empty((B, T, H, D), dtype=torch.bfloat16, device=q.device)
    if B == 0 or T == 0:
        return out
    # int8 KV: the kernel converts the codes to these bf16 copies first
    kd, vd = (torch.empty((B, Hkv, S, D), dtype=torch.bfloat16, device=q.device)
              for _ in range(2)) if quant else (None, None)
    plan = prefill_plan(B, T, H, Hkv, D, quant, _sm_count(q.device), hw)
    if lib is None:
        lib = _build.load("prefill", "tkq_prefill", _ARGTYPES)
    rc = lib.tkq_prefill(int(quant), D,
                         P(q), q.stride(0), q.stride(1), q.stride(2),
                         P(k), k.stride(0), k.stride(1), P(v), v.stride(0), v.stride(1),
                         *scales, *((P(kd), P(vd)) if quant else (None, None)), P(qs32), P(out),
                         B, T, H, Hkv, S, float(scale), int(sliding_window),
                         plan.hw, plan.nq, plan.hg, plan.nqb, plan.n_items, plan.grid,
                         _build.stream_ptr(q.device))
    _build.check(lib, rc, "prefill")
    counter.launches += 1
    return out
