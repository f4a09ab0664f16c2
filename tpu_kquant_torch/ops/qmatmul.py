"""Quantized matmul dispatch, the counterpart of ``tpu_kquant.ops.qmatmul``.

Packed weights go to the qmm kernel (its plain version on the CPU); a dense
weight is a plain matmul, as the reference leaves it to XLA. Under
``impl="int8"`` the reference's gate (``tpu_kquant/ops/qmatmul.py:48-69``)
sends decode-sized products on kmajor q4 / q6 weights with f32 scales to the
qmm_int8 kernel; everything else stays on qmm. ``impl="auto"`` is the
reference's TPU dispatch, where every packed weight takes the bf16-dequant
kernel.
"""

from __future__ import annotations

import math

import torch

from tpu_kquant_torch.ops.qmm import qmm
from tpu_kquant_torch.ops.qmm_int8 import qmm_int8
from tpu_kquant_torch.quant.qtensor import QTensor

IMPLS = ("auto", "int8")
# the smallest K the reference's Pallas kernels take for the kinds the int8
# gate admits (tpu_kquant/ops/pallas_qmm.py:_MIN_K, pallas_supported:57-62)
_MIN_K = {"q4": 512, "q6": 512}
INT8_MAX_ROWS = 32


def int8_eligible(qt: QTensor, rows: int) -> bool:
    """The reference's int8 gate, word for word: a q4 / q6 kmajor 2-D weight
    without bf16 pairs (the kernel reads scales / mins), at most 32 rows, a
    K its Pallas kernels take, and the global bit fold."""
    K = int(qt.shape[-1])
    return ((qt.fold or 1) == 1 and qt.kind in _MIN_K and qt.layout == "kmajor"
            and "sm" not in qt.arrays and len(qt.shape) == 2 and rows <= INT8_MAX_ROWS
            and K >= _MIN_K[qt.kind] and K % 256 == 0)


def qmatmul(x: torch.Tensor, qt: QTensor, impl: str = "auto",
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] W[n, k], returned in ``out_dtype``
    (default: x's dtype)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if qt.kind == "dense":
        out_dtype = out_dtype or x.dtype
        return (x.float() @ qt.arrays["w"].float().T).to(out_dtype)
    if impl == "int8" and int8_eligible(qt, math.prod(x.shape[:-1])):
        return qmm_int8(x, qt, out_dtype)
    return qmm(x, qt, out_dtype)
