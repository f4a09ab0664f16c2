"""Plain torch copies of the dequant helpers the qmm kernel lab's math is
written in (``tpu_kquant/ops/pallas_dequant.py``: ``q4_codes_word``,
``group_scale_mulsub``, ``sp_scales``, ``group_scale_dot``), on whole
tensors instead of VMEM tiles. Shapes: codes and weights [TK, N] (K rows,
N columns), per-group scales and mins [TK / g, N]; x [R, TK].
"""

from __future__ import annotations

import torch

from tpu_kquant_torch.quant.codecs import unpack_scale_pairs


def q4_codes_word(qs_u8: torch.Tensor, hi_fold: bool) -> torch.Tensor:
    """Packed q4 bytes [TK2, N] -> the codes 0..15 of one fold as int8:
    fold 0 (the low nibble) is row k, fold 1 (the high nibble) row k + K/2."""
    return ((qs_u8 >> 4) if hi_fold else (qs_u8 & 0x0F)).to(torch.int8)


def group_scale_mulsub(q_f32: torch.Tensor, s: torch.Tensor, m: torch.Tensor | None,
                       g: int) -> torch.Tensor:
    """w = q * s - m with each group's scale and min over its g rows."""
    TK, TN = q_f32.shape
    w = q_f32.reshape(TK // g, g, TN) * s[:, None, :]
    if m is not None:
        w = w - m[:, None, :]
    return w.reshape(TK, TN)


def sp_scales(sp_block: torch.Tensor) -> torch.Tensor:
    """Adjacent-group bf16 scale pairs [G/2, N] (f32 container; low half the
    even group's) -> per-group f32 scales [G, N]."""
    even, odd = unpack_scale_pairs(sp_block)
    return torch.stack([even, odd], dim=1).reshape(-1, sp_block.shape[-1])


def group_scale_dot(x_f32: torch.Tensor, codes: torch.Tensor, s: torch.Tensor,
                    m: torch.Tensor | None, g: int) -> torch.Tensor:
    """x @ dequant with the scale applied per group: sum over groups of
    s[g] * (x_g @ codes_g), minus (x @ G) @ m. Returns [R, N] f32."""
    R, TK = x_f32.shape
    N = codes.shape[-1]
    G = TK // g
    partial = torch.einsum("rgk,gkn->grn", x_f32.reshape(R, G, g),
                           codes.float().reshape(G, g, N))
    out = (partial * s[:, None, :]).sum(0)
    if m is not None:
        out = out - x_f32.reshape(R, G, g).sum(-1) @ m
    return out
