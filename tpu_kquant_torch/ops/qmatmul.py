"""Quantized matmul dispatch, the counterpart of ``tpu_kquant.ops.qmatmul``.

Packed weights go to the qmm kernel (its plain version on the CPU); a dense
weight is a plain matmul, as the reference leaves it to XLA.
"""

from __future__ import annotations

import torch

from tpu_kquant_torch.ops.qmm import qmm
from tpu_kquant_torch.quant.qtensor import QTensor


def qmatmul(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] W[n, k], returned in ``out_dtype``
    (default: x's dtype)."""
    if qt.kind == "dense":
        out_dtype = out_dtype or x.dtype
        return (x.float() @ qt.arrays["w"].float().T).to(out_dtype)
    return qmm(x, qt, out_dtype)
