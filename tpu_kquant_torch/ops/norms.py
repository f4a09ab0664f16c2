"""RMSNorm, computed in f32 and returned in the input's dtype.

On the card the sum of squares is taken in stages of at most 32 elements
each (32 elements, then groups of 32 of those sums, zero-padded, until one
is left) so that a row's result does not depend on how many rows the call
holds. PyTorch's reduction picks its lanes from the number of rows once a
row's span passes 32: a one-stage mean over a long row normed a 16 x
64-token burst's rows differently from the prompt alone
(tools/batch_invariance.py), and a second stage over 80 sums (Mamba-2.8B's
2560 = 80 x 32) took 64 lanes for one row and 32 for 16, so a served row's
norm differed from its solo run's in the last bit where the sum was
inexact. On the CPU the one-stage mean stays, as the tests hold it against
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SPAN = 32  # elements one reduction stage sums on the card


def staged_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis [..., n] -> [..., 1] in stages of at most
    SPAN elements: for a span of at most 32 PyTorch's reduction takes the
    same lanes whatever the number of rows, so each row's sum is the same
    bits in any batch."""
    while v.shape[-1] > SPAN:
        if v.shape[-1] % SPAN:
            v = F.pad(v, (0, -v.shape[-1] % SPAN))
        v = v.unflatten(-1, (-1, SPAN)).sum(-1)
    return v.sum(-1, keepdim=True)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    D = xf.shape[-1]
    if xf.is_cuda:
        var = staged_sum(xf * xf) / D
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
