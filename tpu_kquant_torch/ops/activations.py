"""Gated activation, computed in f32 and returned in the gate's dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)
