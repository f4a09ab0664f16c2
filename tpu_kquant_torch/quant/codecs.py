"""Torch dequantization of QTensors: the counterpart of
``tpu_kquant.quant.jnp_codecs`` and the oracle every matmul kernel is held
against (the plain versions in ``ops`` are built on it).

Unpacks follow ``quant.repack``'s bit conventions; they run on whatever
device the arrays live on.
"""

from __future__ import annotations

import torch

from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE


def _unpack_codes_kmajor(arrays: dict, kind: str) -> torch.Tensor:
    """Packed arrays -> integer codes [..., K, N] (axis -2 is packed K)."""
    if kind in ("q6w", "q8"):
        return arrays["qs"]
    qs = arrays["qs"]
    if kind in ("q4", "q5", "q6"):
        q = torch.cat([qs & 0xF, qs >> 4], dim=-2)
    elif kind in ("q2", "q3"):
        q = torch.cat([(qs >> (2 * j)) & 3 for j in range(4)], dim=-2)
    else:
        raise NotImplementedError(f"kind {kind!r} is not supported by this port")
    if kind in ("q5", "q3"):  # 1-bit high plane, 8-fold
        qh = arrays["qh"]
        h = torch.cat([(qh >> j) & 1 for j in range(8)], dim=-2)
        q = q | (h << (4 if kind == "q5" else 2))
    elif kind == "q6":  # 2-bit high plane, 4-fold
        qh = arrays["qh"]
        q = q | (torch.cat([(qh >> (2 * j)) & 3 for j in range(4)], dim=-2) << 4)
    return q


def unpack_scale_pairs(sm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32-container bf16 pairs -> (low half, high half) as f32."""
    bits = sm.contiguous().view(torch.int32)
    lo = (bits << 16).view(torch.float32)
    hi = (bits & -65536).view(torch.float32)
    return lo, hi


def scales_mins(arrays: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-group (scales, mins-or-None) in f32, group axis at -2."""
    if "sm" in arrays:
        return unpack_scale_pairs(arrays["sm"])
    if "sp" in arrays:
        even, odd = unpack_scale_pairs(arrays["sp"])
        s2 = torch.stack([even, odd], dim=-2)  # [..., G/2, 2, N]
        return s2.reshape(*s2.shape[:-3], -1, s2.shape[-1]), None
    s = arrays["scales"].float()
    m = arrays["mins"].float() if "mins" in arrays else None
    return s, m


def dequant_kmajor(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a kmajor QTensor to W^T of shape [..., K, N]."""
    if qt.kind == "dense":
        return qt.arrays["w"].T.to(dtype)
    if qt.layout != "kmajor":
        raise ValueError(f"dequant_kmajor needs a kmajor tensor, got {qt.layout!r}")
    if qt.fold != 1:
        raise NotImplementedError("block-local folds are not supported by this port")
    g = GROUP_SIZE[qt.kind]
    q = _unpack_codes_kmajor(qt.arrays, qt.kind).float()
    scales, mins = scales_mins(qt.arrays)
    w = q * torch.repeat_interleave(scales, g, dim=-2)
    if mins is not None:
        w = w - torch.repeat_interleave(mins, g, dim=-2)
    return w.to(dtype)


def dequant_rows(qt: QTensor, rows: torch.Tensor | None, dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize rows of a rowmajor QTensor (embedding lookup).

    rows: integer tensor of row indices (any shape), or None for all rows."""
    if qt.kind == "dense":
        w = qt.arrays["w"]
        out = w if rows is None else w[rows]
        return out.to(dtype)
    if qt.layout != "rowmajor":
        raise ValueError(f"dequant_rows needs a rowmajor tensor, got {qt.layout!r}")
    flat = None if rows is None else rows.reshape(-1)
    # rowmajor arrays are the kmajor ones transposed: gather rows, transpose
    # the (small) slices back and reuse the kmajor unpacker
    sub = {k: (v if flat is None else v[flat]).T for k, v in qt.arrays.items()}
    g = GROUP_SIZE[qt.kind]
    q = _unpack_codes_kmajor(sub, qt.kind).float()  # [K, R]
    scales, mins = scales_mins({k: v.contiguous() for k, v in sub.items()})
    w = q * torch.repeat_interleave(scales, g, dim=0)
    if mins is not None:
        w = w - torch.repeat_interleave(mins, g, dim=0)
    K = qt.shape[-1]
    out = w.T
    if rows is None:
        return out.reshape(qt.shape).to(dtype)
    return out.reshape(tuple(rows.shape) + (K,)).to(dtype)
