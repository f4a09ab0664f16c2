"""Causal GQA attention over the KV cache (bf16, or int8 with per-token
scales): the port of ``tpu_kquant.ops.attention.attention_decode``.

Dispatch follows the reference's gates, with "on the TPU" read as "tensors
on the card":
- T > 1 (prefill) with no ``kv_cur``, the kernel's shape rule
  (``prefill_supported``) and plain logits above ``ATTN_PLAIN_MAX_MB`` go to
  the flash prefill kernel (``ops.prefill``; its plain version on the CPU).
  At TinyLlama width that is every bucket-2048 prompt (537 MB of logits per
  layer); bucket 1024 (134 MB) stays plain.
- T == 1 with no ``kv_cur``, D % 64, S % 64 (S % 256 on int8 KV) and plain
  logits above the same budget go to the flash decode kernel
  (``ops.decode_attention``; its plain version on the CPU). The forward
  drops its deferred append past the budget, so this is every decode step
  of many concurrent sequences: 1024 serving slots of 2048 at TinyLlama
  width (268 MB of logits per layer).
- Everything else runs the plain branch (``attention_plain``) in f32; on
  the card its products are bmm calls of one shape per (row, KV head)
  pair whatever B is, so a row's result does not depend on the batch.
gemma2's quirks follow the reference's rules: a logit softcap keeps both
kernels off (the plain branch applies tanh(logits / cap) * cap after the
current token's logit is put in and before the mask); a sliding window
keeps the decode kernel off and rides into the prefill kernel, which
takes one. A ring (the iSWA layout's window layers, ``ring_last``) keeps
both kernels off: the plain branch recovers each slot's position from the
row's last written one (attention.py:191-200 of the reference).
"""

from __future__ import annotations

import os

import torch

from tpu_kquant_torch.ops.decode_attention import attention_decode_flash
from tpu_kquant_torch.ops.prefill import attention_prefill, prefill_supported

# The budget of materialised f32 logits (B * T * H * S * 4 bytes, in MB)
# above which attention leaves the plain branch; the reference's
# _ATTN_XLA_MAX_MB, read once at import as the reference reads it:
# TKQ_ATTN_XLA_MAX_MB, else its alias TKQ_PREFILL_XLA_MAX_MB, else 192. The
# deferred-append gate of models.llama reads it too.
ATTN_PLAIN_MAX_MB = float(
    os.environ.get("TKQ_ATTN_XLA_MAX_MB", os.environ.get("TKQ_PREFILL_XLA_MAX_MB", "192")))


def logits_mb(B: int, T: int, H: int, S: int) -> float:
    """MB of f32 logits the plain branch would materialise."""
    return B * T * H * S * 4 / 1e6


def attention_decode(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] bf16 or int8, heads-major
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    kv_scales: tuple[torch.Tensor, torch.Tensor] | None = None,  # int8: [B, Hkv, S] each
    kv_cur: tuple[torch.Tensor, torch.Tensor] | None = None,
    logit_softcap: float = 0.0,
    sliding_window: int = 0,
    ring_last: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of T query tokens against S cache slots; slot j holds
    position j and is masked where j > the query's position, and, with a
    ``sliding_window`` w > 0, where j <= the position - w. Returns
    [B, T, H, D] in q's dtype. The logit scale is head_dim^-0.5;
    ``logit_softcap`` c > 0 maps each logit l to tanh(l / c) * c.

    ring_last [B]: the cache is a ring of S slots (runtime.kv_cache.
    ISWACache), the row's last written position ``ring_last``: slot j holds
    position last - ((last - j) mod S), and a slot whose position is
    negative (not yet written) is masked.

    kv_scales: int8 KV. The per-token scales are constant along D, so K
    scales multiply logit columns and V scales probability rows.

    kv_cur: deferred-append mode (decode, T == 1). The current token's
    (k, v) [B, T, Hkv, D] are not in the cache yet, so slot q_pos holds stale
    data: its logit is replaced by the current token's (unscaled) before the
    softmax, its probability is taken out before the V scales apply, and it
    re-enters with the current, unquantized value after. The result equals
    attending the cache after the append; it lets the forward write every
    layer's new rows in one batched append after the layer loop. With T > 1
    (engine.step's window on a bf16 cache within the logits budget, its rows
    appended first) each query takes its own row so, and the plain branch
    runs each query as the decode step at its position would
    (attention_plain)."""
    B, T, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    big = logits_mb(B, T, H, S) > ATTN_PLAIN_MAX_MB
    kernel_ok = kv_cur is None and ring_last is None and logit_softcap == 0.0
    if (kernel_ok and T == 1 and sliding_window == 0 and D % 64 == 0 and S % 64 == 0 and big
            and (kv_scales is None or S % 256 == 0)):
        return attention_decode_flash(q, k_cache, v_cache, q_positions, kv_scales)
    if kernel_ok and T > 1 and prefill_supported(T, S, D) and big:
        return attention_prefill(q, k_cache, v_cache, q_positions[:, 0], kv_scales,
                                 sliding_window=sliding_window)

    return attention_plain(q, k_cache, v_cache, q_positions, kv_scales, kv_cur,
                           logit_softcap=logit_softcap, sliding_window=sliding_window,
                           ring_last=ring_last)


# f32 elements of the largest operand that one bmm call of the card's plain
# branch covers (its pairs per call: this over a (row, KV head) pair's
# largest operand, never a function of B). A lone row pads its call to this
# size; many rows take one call per this much.
PLAIN_CALL_FLOATS = 1 << 20


def plain_pairs(T: int, G: int, S: int, D: int) -> int:
    """(row, KV head) pairs per bmm call of the card's plain branch: from the
    shapes of one pair alone (its queries T * G, slots S, head_dim D), so
    the solo row and the row among 16 run the same cuBLAS call shape."""
    return max(1, PLAIN_CALL_FLOATS // max(T * G * D, S * D, T * G * S))


def pairs_f32(t: torch.Tensor, pairs: int) -> torch.Tensor:
    """t [N, ...] as f32 with at least ``pairs`` entries: fewer are copied
    into the first N entries of an uninitialised buffer of ``pairs`` (the
    rest are never read back: each entry's product depends on its own
    operands only)."""
    if t.shape[0] >= pairs:
        return t.float().contiguous()
    out = torch.empty((pairs, *t.shape[1:]), dtype=torch.float32, device=t.device)
    out[:t.shape[0]].copy_(t)
    return out


def bmm_fixed(a: torch.Tensor, b: torch.Tensor, pairs: int, real: int) -> torch.Tensor:
    """The first ``real`` entries of a [N, m, k] @ b [N, k, n] (f32, N >=
    pairs: see pairs_f32), in bmm calls of exactly ``pairs`` batch entries
    each: chunks [i, i + pairs), the last one taken as the final ``pairs``
    entries (overlapping the one before). cuBLAS picks its algorithm, and
    with it each output's order of sums, from the call's shape, so an
    entry's result is the same bits whatever N is."""
    N = a.shape[0]
    out = a.new_empty((N, a.shape[1], b.shape[2]))
    for i in range(0, N, pairs):
        i = min(i, N - pairs)
        torch.bmm(a[i:i + pairs], b[i:i + pairs], out=out[i:i + pairs])
    return out[:real]


def attention_plain(q, k_cache, v_cache, q_positions, kv_scales=None, kv_cur=None,
                    fixed: bool | None = None, parts: dict | None = None,
                    logit_softcap: float = 0.0, sliding_window: int = 0,
                    ring_last: torch.Tensor | None = None) -> torch.Tensor:
    """attention_decode's plain branch, in f32. ``fixed`` (default: on CUDA
    tensors) takes its three products (q k^T, the deferred append's current
    logit, p v) as per-(row, KV head) bmm calls of a fixed shape
    (``bmm_fixed``, ``plain_pairs``, ``pairs_f32``), so that a row's result does not
    depend on the other rows of the call: PyTorch's einsum folds the rows
    into one bmm whose batch count, B x Hkv, steers cuBLAS's choice of
    algorithm, and with it the order of each f32 sum (a served greedy
    stream differed from its solo run where such a sum crossed a bf16
    rounding boundary, tools/batch_invariance.py --serving). With kv_cur
    and T > 1 (engine.step's window) the products are taken query by
    query, at the decode step's call shapes, on one f32 copy of the cache;
    the rest is elementwise or a softmax per row, so query t is the decode
    step at its position bit for bit. Off (the CPU default), the einsums
    that the tests hold to the JAX package. ``parts``: filled with the f32
    logits, probabilities and p v product. ``logit_softcap``,
    ``sliding_window`` and ``ring_last``: as attention_decode's (the ring
    changes only the mask)."""
    B, T, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    fixed = q.is_cuda if fixed is None else fixed
    qf = q.float().reshape(B, T, Hkv, G, D)
    if fixed:
        N, Tq = B * Hkv, 1 if kv_cur is not None else T
        pairs = plain_pairs(Tq, G, S, D)
        qh = qf.permute(0, 2, 1, 3, 4)  # [B, Hkv, T, G, D]

        def products(a, b) -> torch.Tensor:
            """a [B, Hkv, T, G, m] @ b(t0) [N, m, n] per chunk of Tq queries
            -> [B, T, Hkv, G, n]."""
            out = [bmm_fixed(pairs_f32(a[:, :, t0:t0 + Tq].reshape(N, Tq * G, a.shape[-1]),
                                       pairs), b(t0), pairs, N).reshape(B, Hkv, Tq, G, -1)
                   for t0 in range(0, T, Tq)]
            return (out[0] if len(out) == 1 else torch.cat(out, dim=2)).permute(0, 2, 1, 3, 4)

        kn = pairs_f32(k_cache.reshape(N, S, D), pairs)
        logits = products(qh, lambda t0: kn.transpose(1, 2)) * scale
    else:
        logits = torch.einsum("bthgd,bhsd->bthgs", qf, k_cache.float()) * scale
    if kv_scales is not None:
        ks, vs = kv_scales
        logits = logits * ks.float()[:, None, :, None, :]
    kv_pos = torch.arange(S, device=q.device)[None, None, :]  # [1, 1, S]
    if ring_last is not None:  # each slot's position on the row's ring: [B, 1, S]
        last = ring_last.long()[:, None, None]
        kv_pos = last - torch.remainder(last - kv_pos, S)
    at_cur = None
    if kv_cur is not None:
        k_cur, v_cur = kv_cur
        if fixed:
            l_cur = products(qh, lambda t0: pairs_f32(k_cur[:, t0].reshape(N, D, 1), pairs))
            l_cur = l_cur[..., 0] * scale
        else:
            l_cur = torch.einsum("bthgd,bthd->bthg", qf,
                                 k_cur.float().reshape(B, T, Hkv, D)) * scale
        at_cur = (kv_pos == q_positions[:, :, None])[:, :, None, None, :]
        logits = torch.where(at_cur, l_cur[..., None], logits)
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    mask = kv_pos <= q_positions[:, :, None]  # [B, T, S]
    if ring_last is not None:
        mask &= kv_pos >= 0  # slots not written yet
    if sliding_window > 0:
        mask &= kv_pos > q_positions[:, :, None] - sliding_window
    logits = logits.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if parts is not None:
        parts["logits"], parts["p"] = logits, p
    if at_cur is not None:
        p_cur = torch.where(at_cur, p, 0.0).sum(dim=-1)  # [B, T, Hkv, G]
        p = torch.where(at_cur, 0.0, p)
    if kv_scales is not None:
        p = p * vs.float()[:, None, :, None, :]
    if fixed:
        vn = pairs_f32(v_cache.reshape(N, S, D), pairs)
        out = products(p.permute(0, 2, 1, 3, 4), lambda t0: vn)
    else:
        out = torch.einsum("bthgs,bhsd->bthgd", p, v_cache.float())
    if parts is not None:
        parts["pv"] = out
    if at_cur is not None:
        out = out + p_cur[..., None] * v_cur.float().reshape(B, T, Hkv, 1, D)
    return out.reshape(B, T, H, D).to(q.dtype)
