"""Causal GQA attention over the bf16 KV cache, in plain PyTorch.

The port of the plain branch of ``tpu_kquant.ops.attention.attention_decode``
(its fused-XLA path), which is what the reference runs at the main path's
shapes: decode at S = 704 slots materialises 0.09 MB of logits and pp512
46 MB, both far under the 192 MB gate of its flash kernels. The flash decode
and prefill kernels (and int8 KV, sliding windows, softcaps, ring layouts)
belong to later slices.
"""

from __future__ import annotations

import torch


def attention_decode(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] bf16, heads-major
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    kv_cur: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Attention of T query tokens against S cache slots; slot j holds
    position j and is masked where j > the query's position. Returns
    [B, T, H, D] in q's dtype.

    kv_cur: deferred-append mode (decode, T == 1). The current token's
    (k, v) [B, T, Hkv, D] are not in the cache yet, so slot q_pos holds stale
    data: its logit is replaced by the current token's before the softmax,
    and its value row by the current value after. The result equals
    attending the cache after the append; it lets the forward write every
    layer's new rows in one batched append after the layer loop."""
    B, T, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, T, Hkv, G, D)
    logits = torch.einsum("bthgd,bhsd->bthgs", qf, k_cache.float()) * scale
    kv_pos = torch.arange(S, device=q.device)
    at_cur = None
    if kv_cur is not None:
        k_cur, v_cur = kv_cur
        l_cur = torch.einsum("bthgd,bthd->bthg", qf, k_cur.float().reshape(B, T, Hkv, D)) * scale
        at_cur = (kv_pos[None, None, :] == q_positions[:, :, None])[:, :, None, None, :]
        logits = torch.where(at_cur, l_cur[..., None], logits)
    mask = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
    logits = logits.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if at_cur is not None:
        p_cur = torch.where(at_cur, p, 0.0).sum(dim=-1)  # [B, T, Hkv, G]
        p = torch.where(at_cur, 0.0, p)
    out = torch.einsum("bthgs,bhsd->bthgd", p, v_cache.float())
    if at_cur is not None:
        out = out + p_cur[..., None] * v_cur.float().reshape(B, T, Hkv, 1, D)
    return out.reshape(B, T, H, D).to(q.dtype)
