"""Mixture-of-experts FFN (Mixtral-style), the port of
``tpu_kquant.models.moe`` with its single-device ``"loop"`` strategy.

Expert weights are stacked QTensors [E, N, K] (runtime.loader). The router
is a qmatmul with f32 output; routing takes the top-k router logits and a
softmax over the selected ones (Mixtral's semantics). The loop runs every
expert on every row, each a qmatmul gate, up and down, and weights its f32
output by the routing weight (0 for an unselected expert), summing in
expert order 0 .. E-1, as the reference does: static shapes and no gather,
at the price of reading all E experts' weights per token. The multi-device
strategies ("ep", "a2a") wait for ``parallel/``.
"""

from __future__ import annotations

from typing import Any

import torch

from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops.activations import swiglu
from tpu_kquant_torch.ops.qmatmul import qmatmul
from tpu_kquant_torch.quant.qtensor import QTensor


def _routing_weights(router_logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """[..., E] f32 logits -> [..., E] weights: the softmax of the top-k
    logits at their experts, 0 elsewhere."""
    top_w, top_idx = torch.topk(router_logits, top_k, dim=-1)
    return torch.zeros_like(router_logits).scatter(-1, top_idx, torch.softmax(top_w, dim=-1))


def _expert_view(stk: QTensor, e: int) -> QTensor:
    """2-D QTensor of expert ``e`` of a stacked [E, ...] QTensor: views of the
    stacked arrays (contiguous slices, no copy)."""
    return QTensor(stk.kind, "kmajor", tuple(stk.shape[1:]),
                   {k: v[e] for k, v in stk.arrays.items()})


def moe_ffn(layer: dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """h: [B, T, dim] (already ffn-normed) -> [B, T, dim] in h's dtype."""
    router_logits = qmatmul(h, layer["gate_inp"], impl, out_dtype=torch.float32)
    gate_w = _routing_weights(router_logits, cfg.n_experts_used)  # [B, T, E]
    stk = layer["experts"]
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(cfg.n_experts):
        g = qmatmul(h, _expert_view(stk["w_gate"], e), impl)
        u = qmatmul(h, _expert_view(stk["w_up"], e), impl)
        y = qmatmul(swiglu(g, u), _expert_view(stk["w_down"], e), impl, out_dtype=torch.float32)
        out = out + y * gate_w[..., e:e + 1]
    return out.to(h.dtype)
