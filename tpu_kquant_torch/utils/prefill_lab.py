"""The prefill-attention lab: three variants of causal GQA prefill attention,
swept beside the flash prefill kernel (#8) and SDPA.

Counterpart of the root ``tools_prefill_lab.py``, ``tools_prefill_lab2.py``
and ``tools_prefill_lab3.py``. Each variant asks one question that a
redesign of the flash prefill kernel needs answered:

  A (#17, ``call_a``)  one-shot: every (query, slot) pair, the final row max
                       before any exp, no tile skipping
  B (#18, ``call_b``)  online softmax over ``ts``-slot tiles: dead tiles
                       skipped, interior tiles unmasked, diagonal tiles
                       masked, m / l / acc rescaled per tile
  G (#19, ``call_g``)  two phases: the live tiles' logits and the row max
                       into an S-wide f32 scratch, then exp and P V over the
                       same tiles (no rescale)

Common numerics: QK^T on bf16 operands summed in f32, times ``scale``;
masked logits (slot after the query's position) -1e30; l summed in f32
before P is rounded to bf16 for P V (f32 sums); bf16(acc / l), l floored at
1e-20 in B and G. Kernels: ``csrc/prefill_lab.cu`` (its header says how the
TPU's tq x G-head block maps to CUDA blocks: tq changes neither work nor
result there).

Layout, as the reference's: q grouped [B, Hkv, G, T, D] (``group_heads``),
k and v [B, Hkv, S, D], ``q_start`` [B] (query t of row b sits at position
q_start[b] + t; slot j holds position j). Returns [B, Hkv, G, T, D].

Two faults of the reference's lab are not carried over (ROADMAP Queue 3):
its B reads past S when the last tile is ragged and live (here slots past S
are masked and never read), and every variant leaves the rows past
T // tq * tq unwritten (here the wrappers refuse T % tq != 0).

``call_a_plain`` / ``call_b_plain`` / ``call_g_plain`` are the same
functions in plain PyTorch (f32 on bf16-rounded operands). ``call_a`` /
``call_b`` / ``call_g`` run them only for CPU tensors; on a card they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_kquant_torch.ops import _build

counter_a = _build.LaunchCounter("prefill_lab_a")
counter_b = _build.LaunchCounter("prefill_lab_b")
counter_g = _build.LaunchCounter("prefill_lab_g")

KERNEL_HEAD_DIMS = (64, 128)
SUB_TILE = 64  # the kernels' staged sub-tile of slots: B and G's ts is a multiple
_NEG = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
#           variant D  q   k   v   qs  out B   Hkv G   T   S   scale           ts  stream
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_VARIANT = {"a": 0, "b": 1, "g": 2}

# The lab's shapes (batch 1, one layer's attention): TinyLlama-1.1B's pp512
# layer is the reference lab's own (32 / 4 heads of 64, T 512 after a 704-slot
# cache); pp2048 its full context; Qwen2.5-1.5B's heads (12 / 2 of 128) at
# pp512; `toy` a narrow shape for the CPU, not a model.
SHAPES = {
    "tiny-pp512": dict(B=1, T=512, S=704, H=32, Hkv=4, D=64, q_start=(0,)),
    "tiny-pp2048": dict(B=1, T=2048, S=2048, H=32, Hkv=4, D=64, q_start=(0,)),
    "qwen-pp512": dict(B=1, T=512, S=704, H=12, Hkv=2, D=128, q_start=(0,)),
    "toy": dict(B=1, T=256, S=320, H=8, Hkv=2, D=64, q_start=(64,)),
}
# the reference scripts' sweeps: variant -> (tq, ts) points (A has no ts)
SWEEPS = {
    "a": tuple((tq, None) for tq in (128, 256, 512)),
    "b": tuple((tq, ts) for tq in (128, 256) for ts in (128, 256, 384)),
    "g": tuple((tq, ts) for tq in (128, 256) for ts in (128, 256)),
}


def group_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[B, T, H, D] -> [B, Hkv, G, T, D], query head h = hk * G + g (the
    lab scripts' transpose), contiguous."""
    B, T, H, D = q.shape
    return q.reshape(B, T, n_kv_heads, H // n_kv_heads, D).permute(0, 2, 3, 1, 4).contiguous()


def ungroup_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, T, D] -> [B, T, H, D], the inverse of ``group_heads``."""
    B, Hkv, G, T, D = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * G, D)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _logits(q, k, q_start, scale, lo: int, hi: int) -> torch.Tensor:
    """f32 logits of slots [lo, hi) times scale, -1e30 where the slot lies
    after the query's position: [B, Hkv, G, T, hi - lo]."""
    T = q.shape[3]
    s = torch.einsum("bhgtd,bhsd->bhgts", _bf(q), _bf(k[:, :, lo:hi])) * scale
    pos = q_start.long()[:, None] + torch.arange(T, device=q.device)  # [B, T]
    kv = torch.arange(lo, hi, device=q.device)
    mask = kv[None, None, :] <= pos[:, :, None]
    return torch.where(mask[:, None, None], s, _NEG)


def _pv(p, v) -> torch.Tensor:
    return torch.einsum("bhgts,bhsd->bhgtd", _bf(p), _bf(v))


def _one_shot(q, k, v, q_start, scale, floor: float) -> torch.Tensor:
    s = _logits(q, k, q_start, scale, 0, k.shape[2])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return (_pv(p, v) / (l.clamp_min(floor) if floor else l)).to(q.dtype)


def call_a_plain(q, k, v, q_start, scale: float, tq: int) -> torch.Tensor:
    """Plain version of variant A (module docstring)."""
    _check(q, k, v, q_start, tq, None, "call_a")
    return _one_shot(q, k, v, q_start, scale, 0.0)


def call_b_plain(q, k, v, q_start, scale: float, tq: int, ts: int) -> torch.Tensor:
    """Plain version of variant B: the tiles of min(ts, S) slots in order,
    the last one cut at S. A tile dead for a row leaves it unchanged
    (alpha 1, p 0), so every tile runs for every row."""
    _check(q, k, v, q_start, tq, ts, "call_b")
    S = k.shape[2]
    TS = min(ts, S)
    m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for lo in range(0, S, TS):
        hi = min(lo + TS, S)
        s = _logits(q, k, q_start, scale, lo, hi)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _pv(p, v[:, :, lo:hi])
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def call_g_plain(q, k, v, q_start, scale: float, tq: int, ts: int) -> torch.Tensor:
    """Plain version of variant G: the final row max over the live tiles is
    the max over every slot (a dead tile's logits are all -1e30), and a dead
    slot's p is 0, so this is A's one-shot with l floored at 1e-20."""
    _check(q, k, v, q_start, tq, ts, "call_g")
    return _one_shot(q, k, v, q_start, scale, 1e-20)


def _check(q, k, v, q_start, tq: int, ts: int | None, what: str) -> None:
    """The shape rules of every path: q [B, Hkv, G, T, D] against k, v
    [B, Hkv, S, D] and q_start [B]; T a multiple of min(tq, T)."""
    req = _build.require
    req(q.dim() == 5, f"{what}: q must be [B, Hkv, G, T, D], got {tuple(q.shape)}")
    B, Hkv, G, T, D = q.shape
    req(k.dim() == 4 and k.shape[:2] == (B, Hkv) and k.shape[3] == D and k.shape[2] > 0
        and v.shape == k.shape,
        f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} against q {tuple(q.shape)}")
    req(q_start.shape == (B,), f"{what}: q_start must be [B], got {tuple(q_start.shape)}")
    req(tq > 0 and T > 0 and T % min(tq, T) == 0,
        f"{what}: T = {T} is not a multiple of tq = {tq} (the reference leaves the rows "
        f"past T // tq * tq unwritten)")
    req(ts is None or ts > 0, f"{what}: ts must be positive, got {ts}")


def _launch(variant: str, counter, q, k, v, q_start, scale, ts: int | None, what: str):
    req = _build.require
    B, Hkv, G, T, D = q.shape
    S = k.shape[2]
    req(q.device.type == "cuda", f"{what}: unsupported device {q.device}")
    req(all(t.device == q.device for t in (k, v, q_start)), f"{what}: inputs on several devices")
    req(D in KERNEL_HEAD_DIMS, f"{what}: head_dim {D} (the kernel takes {KERNEL_HEAD_DIMS})")
    req(q.dtype == k.dtype == v.dtype == torch.bfloat16,
        f"{what}: q, k, v must be bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
        f"{what}: q, k, v must be contiguous and 16-byte aligned")
    TS = S if ts is None else min(ts, S)
    req(TS % SUB_TILE == 0 or TS == S,
        f"{what}: ts = {ts} is not a multiple of {SUB_TILE} (the kernel's sub-tile) and "
        f"does not cover S = {S}")
    lib = _build.load("prefill_lab", "tkq_prefill_lab", _ARGTYPES)
    _build.load("prefill_lab", "tkq_prefill_lab_heads", [_I] * 5)
    req(lib.tkq_prefill_lab_heads(_VARIANT[variant], D, G, S, TS) > 0,
        f"{what}: one head's logit scratch at S = {S} does not fit a block's shared memory")
    qs32 = q_start if q_start.dtype == torch.int32 else q_start.to(torch.int32)
    out = torch.empty_like(q)
    P = _build.ptr
    rc = lib.tkq_prefill_lab(_VARIANT[variant], D, P(q), P(k), P(v), P(qs32.contiguous()),
                             P(out), B, Hkv, G, T, S, float(scale), TS,
                             _build.stream_ptr(q.device))
    _build.check(lib, rc, what)
    counter.launches += 1
    return out


def call_a(q, k, v, q_start, scale: float, tq: int) -> torch.Tensor:
    """Variant A, kernel #17 (module docstring)."""
    if q.device.type == "cpu":
        counter_a.plain_calls += 1
        return call_a_plain(q, k, v, q_start, scale, tq)
    _check(q, k, v, q_start, tq, None, "call_a")
    return _launch("a", counter_a, q, k, v, q_start, scale, None, "call_a")


def call_b(q, k, v, q_start, scale: float, tq: int, ts: int) -> torch.Tensor:
    """Variant B, kernel #18 (module docstring)."""
    if q.device.type == "cpu":
        counter_b.plain_calls += 1
        return call_b_plain(q, k, v, q_start, scale, tq, ts)
    _check(q, k, v, q_start, tq, ts, "call_b")
    return _launch("b", counter_b, q, k, v, q_start, scale, ts, "call_b")


def call_g(q, k, v, q_start, scale: float, tq: int, ts: int) -> torch.Tensor:
    """Variant G, kernel #19 (module docstring)."""
    if q.device.type == "cpu":
        counter_g.plain_calls += 1
        return call_g_plain(q, k, v, q_start, scale, tq, ts)
    _check(q, k, v, q_start, tq, ts, "call_g")
    return _launch("g", counter_g, q, k, v, q_start, scale, ts, "call_g")


CALLS = {"a": (call_a, call_a_plain), "b": (call_b, call_b_plain), "g": (call_g, call_g_plain)}


def lab_work(B: int, T: int, S: int, H: int, Hkv: int, D: int, starts) -> tuple[float, float]:
    """(bytes, flops) causal attention needs for these inputs, as
    ``chip_smoke.py:prefill_work`` counts them: bf16 q and output once, each
    K and V slot some query attends once, and 4 D flops per head for every
    unmasked (query, slot) pair. ``starts`` holds q_start of every row."""
    pairs, n_bytes = 0, 2 * 2 * B * T * H * D
    for qs in starts:
        pos = qs + np.arange(T)
        pairs += int((np.minimum(pos, S - 1) + 1).sum())
        n_bytes += 2 * Hkv * min(qs + T, S) * D * 2
    return float(n_bytes), 4.0 * pairs * H * D


def lab_inputs(shape: dict, device, seed: int = 0):
    """(q [B, T, H, D], k, v [B, Hkv, S, D], all bf16; q_start [B] int32) of
    one of ``SHAPES``, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, T, S, H, Hkv, D = (shape[n] for n in ("B", "T", "S", "H", "Hkv", "D"))

    def draw(*dims):
        return torch.randn(*dims, device=device, generator=g).to(torch.bfloat16)

    q, k, v = draw(B, T, H, D), draw(B, Hkv, S, D), draw(B, Hkv, S, D)
    return q, k, v, torch.tensor(shape["q_start"], dtype=torch.int32, device=device)


def sdpa_call(k, v, starts, T: int, scale: float):
    """The library yardstick, which the port never calls: a function of q
    [B, T, H, D] to SDPA's output in that layout, on bf16 with GQA; the
    top-left causal mask (kv <= t) where every q_start is 0, else the
    explicit mask of the positions."""
    import torch.nn.functional as F

    if not any(starts):
        return lambda q: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, is_causal=True, enable_gqa=True, scale=scale).transpose(1, 2)
    pos = torch.tensor(starts, device=k.device)[:, None] + torch.arange(T, device=k.device)
    mask = (torch.arange(k.shape[2], device=k.device)[None, None, :] <= pos[:, :, None])[:, None]
    return lambda q: F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True, scale=scale).transpose(1, 2)


def row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max over the rows of the last axis of max|got - ref| / max|ref| in
    that row (causal attention's output shrinks along the prompt)."""
    d = (got.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def run_sweep(q, k, v, q_start, variants=("prod", "a", "b", "g"), n_iter: int = 32,
              log=None) -> list[dict]:
    """The lab's entry point: every variant at the reference scripts' sweep
    points (``SWEEPS``) and the flash prefill kernel #8 (``"prod"``, at its one
    64 x 64 tiling: the reference's tq / ts sweep of it is a TPU tiling), on
    the same q [B, T, H, D], k, v and q_start, beside SDPA (``sdpa_call``),
    all with the scripts' scale D ** -0.5.

    Each row: the marginal us per call (``time_chained``: CUDA-graph chains
    on a card, eager on the CPU) and the graph us of the shorter chain, both
    with the ``dep`` op each application adds (``dep_us``: that op alone);
    the output's ``row_rel_err`` against the variant's plain version; the
    bound (``lab_work`` over the card's peaks, ``utils.roofline``) and SDPA's
    marginal us, the same for every row."""
    from tpu_kquant_torch.ops.prefill import attention_prefill, attention_prefill_plain
    from tpu_kquant_torch.utils.attribution import chain_times, dep
    from tpu_kquant_torch.utils.roofline import chip_specs

    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = D ** -0.5
    qg = group_heads(q, Hkv)
    starts = q_start.tolist()
    nb, fl = lab_work(B, T, S, H, Hkv, D, starts)
    gbs, tflops = chip_specs()
    tb, to = nb / (gbs * 1e9), fl / (tflops * 1e12)
    dep_s = chain_times(lambda x: dep(x, x), qg, n_iter)[0]
    sdpa = sdpa_call(k, v, starts, T, scale)
    sdpa_s = chain_times(lambda x: dep(x, sdpa(x)), q, n_iter)[0]
    common = {"bound_us": max(tb, to) * 1e6, "bound_by": "bytes" if tb >= to else "operations",
              "bytes": nb, "flops": fl, "sdpa_us": sdpa_s * 1e6, "dep_us": dep_s * 1e6}
    rows, plains = [], {}
    for variant in variants:
        if variant == "prod":
            fn = lambda x: attention_prefill(x, k, v, q_start, scale=scale)  # noqa: E731
            err = row_rel_err(fn(q), attention_prefill_plain(q, k, v, q_start, scale=scale))
            points, x0 = [(64, 64, fn, err)], q
        else:
            call, plain = CALLS[variant]
            points, x0 = [], qg
            for tq, ts in SWEEPS[variant]:
                extra = () if ts is None else (ts,)
                key = (variant, min(ts, S) if variant == "b" else None)
                if key not in plains:  # only B's function depends on a tile (ts)
                    plains[key] = plain(qg, k, v, q_start, scale, tq, *extra)
                fn = lambda x, tq=tq, extra=extra: call(x, k, v, q_start, scale, tq, *extra)  # noqa: E731
                points.append((tq, ts, fn, row_rel_err(fn(qg), plains[key])))
        for tq, ts, fn, err in points:
            marg, graph = chain_times(lambda x, fn=fn: dep(x, fn(x)), x0, n_iter)
            row = {"variant": variant, "tq": tq, "ts": ts, "us": marg * 1e6,
                   "graph_us": graph * 1e6, "rel_err": err, **common}
            if log is not None:
                log(f"{variant:4s} tq={tq:<4d} ts={ts or '-'!s:<4s} {row['us']:9.2f} us marginal "
                    f"{row['graph_us']:9.2f} graph  err {err:.1e}  bound {row['bound_us']:.2f}  "
                    f"sdpa {row['sdpa_us']:.2f}  dep {row['dep_us']:.2f}")
            rows.append(row)
    return rows
