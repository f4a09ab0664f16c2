"""RMSNorm, computed in f32 and returned in the input's dtype.

On the card the sum of squares is taken in two fixed stages (32 elements,
then the row's 32-element sums) so that a row's result does not depend on
how many rows the call holds: PyTorch's one-stage mean over a long row
picks its reduction order from the number of rows, so a 16 x 64-token burst
prefill normed a prompt's rows differently from the prompt alone
(tools/batch_invariance.py). On the CPU the one-stage mean stays, as the
tests hold it against the JAX package.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    D = xf.shape[-1]
    if xf.is_cuda and D % 32 == 0:
        sq = (xf * xf).unflatten(-1, (D // 32, 32))
        var = sq.sum(-1).sum(-1, keepdim=True) / D
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
