"""Gated activations, computed in f32 and returned in the gate's dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """gelu(gate) * up, the exact (erf) GELU (the gemma family's FFN)."""
    return (F.gelu(gate.float()) * up.float()).to(gate.dtype)
