"""QTensor: a quantized tensor as packed torch (or numpy) arrays.

Same fields and layouts as ``tpu_kquant.quant.qtensor.QTensor``:

- ``kmajor``  — matmul weights W of logical shape (N, K), stored K-major
  with N last (``qs`` u8[K/2, N] folded nibbles: byte (k, n) holds code k in
  the low nibble and code k + K/2 in the high nibble; ``sm``/``sp`` bf16
  pairs in an f32 container [K/32, N]; q6w and q8 ``qs`` i8[K, N]; the
  other kinds as quant.repack's table).
- ``rowmajor`` — embedding tables, rows intact ([N, K/2] folded per row).
- ``dense``   — plain float ``w``.

The loader builds QTensors from numpy arrays and moves them with ``.to``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class QTensor:
    kind: str  # 'q2' | 'q3' | 'q4' | 'q5' | 'q6' | 'q6w' | 'q8' | 'dense' (quant.repack)
    layout: str  # 'kmajor' | 'rowmajor' | 'dense'
    shape: tuple[int, ...]  # logical numpy shape, (N, K) for a weight
    arrays: dict[str, Any]  # packed fields: torch tensors or numpy arrays
    tp: str | None = None  # tensor-parallel orientation (unused in this port)
    fold: int = 1  # bit-fold block count along packed K (1 = global fold)

    def to(self, device: str | torch.device) -> "QTensor":
        """Copy every array to ``device`` as a torch tensor."""
        arrays = {}
        for k, v in self.arrays.items():
            if isinstance(v, np.ndarray):
                v = np.ascontiguousarray(v)
                v = torch.from_numpy(v if v.flags.writeable else v.copy())
            arrays[k] = v.to(device).contiguous()
        return QTensor(self.kind, self.layout, tuple(self.shape), arrays,
                       self.tp, self.fold)

    def clone(self) -> "QTensor":
        """A copy with every torch array cloned (on its device)."""
        return QTensor(self.kind, self.layout, tuple(self.shape),
                       {k: v.clone() for k, v in self.arrays.items()}, self.tp, self.fold)

    @property
    def n_bytes(self) -> int:
        return sum(int(np.prod(v.shape)) * (v.element_size() if isinstance(v, torch.Tensor)
                                            else v.dtype.itemsize)
                   for v in self.arrays.values())
