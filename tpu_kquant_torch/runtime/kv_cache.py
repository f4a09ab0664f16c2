"""bf16 KV cache, heads-major [L, B, Hkv, S, D]: the port of
``tpu_kquant.runtime.kv_cache.KVCache`` for this slice (int8 KV, rings and
context shift belong to later slices).

Unlike the reference's immutable arrays, the port writes appends IN PLACE
into the cache tensors; ``append`` and ``append_all`` return the same
object so call sites read like the reference's. The writes index by the
position tensor on the device, so an append never waits for the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, Hkv, S, D] bf16
    v: torch.Tensor

    @staticmethod
    def create(n_layers: int, batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
               device: str | torch.device = "cuda", quantized: bool = False) -> "KVCache":
        if quantized:
            raise NotImplementedError("int8 KV is not ported yet")
        shape = (n_layers, batch, n_kv_heads, max_seq, head_dim)
        return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                       torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def append(self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor) -> "KVCache":
        """Write layer ``layer_idx``'s new rows: k_new/v_new [B, T, Hkv, D]
        go to slots ``positions`` [B, T]. In place; returns self."""
        b = torch.arange(k_new.shape[0], device=positions.device)[:, None]
        self.k[layer_idx, b, :, positions] = k_new.to(self.k.dtype)
        self.v[layer_idx, b, :, positions] = v_new.to(self.v.dtype)
        return self

    def append_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> "KVCache":
        """Every layer's new rows at once: k_new/v_new [L, B, T, Hkv, D]
        (the deferred-append decode step). In place; returns self."""
        b = torch.arange(k_new.shape[1], device=positions.device)[:, None]
        # advanced indices (b, positions) split by a slice index [B, T, L, ...]
        self.k[:, b, :, positions] = k_new.permute(1, 2, 0, 3, 4).to(self.k.dtype)
        self.v[:, b, :, positions] = v_new.permute(1, 2, 0, 3, 4).to(self.v.dtype)
        return self

    def layer_view(self, layer_idx: int):
        """(k [B, Hkv, S, D], v, None) for attention; the None stands for the
        reference's int8 scales."""
        return self.k[layer_idx], self.v[layer_idx], None
