"""Token selection. This slice of the port decodes greedily only."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
