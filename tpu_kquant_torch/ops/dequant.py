"""The reference's dequant-path switches, read at call time under their
names and defaults (``tpu_kquant/ops/pallas_dequant.py``), the dispatch
that decides where a fused decode kernel runs its int8 folds, and the plain
fold itself.

The int8 folds (``pallas_dequant.py:int8_folds_enabled``): inside the grid
variants of attn_in (#3), oproj_ffn (#5) and ffn (#6) the activations that
meet a q4 weight are quantized to int8 per group of 32 (Q8_K style:
``ops.act_quant``), the q4 codes take exact integer group dots with them,
and each group's scale and min are applied to that group's integer partial:
out += z * (xs * s) - gs * m (``int8_group_fold``). Flat kinds (q6w, q8)
never fold. The reference's manual variants (#2, #4) never fold either,
and on the TPU its dispatch sends the production layout to them at decode
rows <= 8; the port has one kernel for #2 / #3 and one for #4 / #5, so it
computes the TPU's choice (``manual_attn_in``, ``manual_oproj``: the
reference's predicates without their backend check; on the CPU the
reference's own return False, so it folds at every row count there).

The other two switches change no kernel of the port: ``mxu_mins_enabled``
(TKQ_Q4_MXU_MINS) moves where the q4 min enters the reference's MXU dots,
and only takes part in ``attn_in_int8_auto``'s rule; ``group_dot_enabled``
(TKQ_GROUP_SCALE) applies each scale once per group, which is what
``csrc/gemv.cuh``'s group dots already do on every path. Both change the
reference's numbers by a rounding, well inside the kernels' 2e-2.
"""

from __future__ import annotations

import os

import torch

from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.quant.codecs import _unpack_codes_kmajor, dequant_kmajor, scales_mins
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

_FLAT_KINDS = ("q6w", "q8")  # pallas_ffn.py:_FLAT_KINDS
MANUAL_MAX_ROWS = 8  # the manual variants' decode rows (pallas_attn_in.py:610, pallas_ffn.py:1030)


def int8_folds_enabled() -> bool:
    """TKQ_INT8_FOLDS (default "auto"): the folds everywhere only at "1"
    (pallas_dequant.py:30)."""
    return os.environ.get("TKQ_INT8_FOLDS", "auto") == "1"


def mxu_mins_enabled() -> bool:
    """TKQ_Q4_MXU_MINS (default "1"; pallas_dequant.py:123)."""
    return os.environ.get("TKQ_Q4_MXU_MINS", "1") == "1"


def attn_in_int8_auto(ns_q4_max: int) -> bool:
    """attn_in's fold rule (pallas_dequant.py:62): on at TKQ_INT8_FOLDS "1";
    at "auto" only where the widest q4 projection has at least 4096 columns
    (8B-class widths: Llama-3-8B's wqk, 5120) and TKQ_Q4_MXU_MINS is off."""
    mode = os.environ.get("TKQ_INT8_FOLDS", "auto")
    if mode == "1":
        return True
    return mode == "auto" and ns_q4_max >= 4096 and not mxu_mins_enabled()


def group_dot_enabled(rows: int) -> bool:
    """TKQ_GROUP_SCALE (default "0"; pallas_dequant.py:192): on at "1" for
    rows <= 8. The port's kernels apply scales per group at any setting."""
    return os.environ.get("TKQ_GROUP_SCALE", "0") == "1" and rows <= 8


def manual_attn_in(ws: list[QTensor], biases, rows: int) -> bool:
    """Whether the TPU runs attn_in's manual variant (#2, no folds):
    pallas_attn_in.py:manual_attn_in_enabled without its backend check
    (TKQ_MANUAL_ATTN_IN "1", rows <= 8, no biases, exactly a q4-sm wqk and
    a q6w / q8 wv with scale pairs)."""
    return (os.environ.get("TKQ_MANUAL_ATTN_IN", "1") == "1" and rows <= MANUAL_MAX_ROWS
            and biases is None and len(ws) == 2
            and ws[0].kind == "q4" and "sm" in ws[0].arrays
            and ws[1].kind in _FLAT_KINDS and "sp" in ws[1].arrays)


def manual_oproj(wo: QTensor, gu: QTensor, dn: QTensor, rows: int) -> bool:
    """Whether the TPU runs oproj_ffn's manual variant (#4, no folds):
    pallas_ffn.py:manual_oproj_enabled without its backend check
    (TKQ_MANUAL_OPROJ "1", rows <= 8, wo and w_gateup q4-sm, w_down q6w /
    q8 with scale pairs)."""
    return (os.environ.get("TKQ_MANUAL_OPROJ", "1") == "1" and rows <= MANUAL_MAX_ROWS
            and wo.kind == "q4" and "sm" in wo.arrays
            and gu.kind == "q4" and "sm" in gu.arrays
            and dn.kind in _FLAT_KINDS and "sp" in dn.arrays)


def attn_in_folds(ws: list[QTensor], biases, rows: int) -> bool:
    """Whether attn_in folds its q4 slots: the TPU takes the grid variant
    (pallas_attn_in.py:fused_attn_in, :404-430) and its fold rule holds at
    the widest q4 projection. ``ws``: the reference's weight list (phi3's
    fused wqkv is one weight)."""
    n_q4 = max((int(w.shape[0]) for w in ws if w.kind == "q4"), default=0)
    return n_q4 > 0 and not manual_attn_in(ws, biases, rows) and attn_in_int8_auto(n_q4)


def oproj_ffn_folds(wo: QTensor, gu: QTensor, dn: QTensor, rows: int) -> tuple[bool, bool]:
    """(fold wo, fold w_gateup) of oproj_ffn: the grid variant's q4 slots
    under TKQ_INT8_FOLDS=1 (pallas_ffn.py:631-632), never the manual one."""
    if not int8_folds_enabled() or manual_oproj(wo, gu, dn, rows):
        return False, False
    return wo.kind == "q4", gu.kind == "q4"


def ffn_folds(gu: QTensor) -> bool:
    """Whether ffn folds its q4 gate/up (pallas_ffn.py:281; #6 has no manual
    variant)."""
    return int8_folds_enabled() and gu.kind == "q4"


def int8_group_fold(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [R, K] f32 (the normalised rows, or the attention output) against
    a kmajor q4 weight (N, K) -> [R, N] f32 (pallas_dequant.py:289): x
    quantized per 32-group (``quantize_activations``), z = xq . codes an
    exact integer dot per group, out = sum over groups of z * (xs * s) -
    gs * m. In f32 the group dots are exact (|z| <= 32 * 127 * 15 < 2^24)."""
    g = GROUP_SIZE[qt.kind]
    R, K = x.shape
    N, G = int(qt.shape[0]), K // g
    xq, xs, gs = quantize_activations(x, g)
    codes = _unpack_codes_kmajor(qt.arrays, qt.kind).float().reshape(G, g, N)
    z = torch.bmm(xq.float().reshape(R, G, g).transpose(0, 1), codes)  # [G, R, N]
    s, m = scales_mins(qt.arrays)
    out = z * (xs.T[:, :, None] * s.float()[:, None, :])
    if m is not None:
        out = out - gs.T[:, :, None] * m.float()[:, None, :]
    return out.sum(0)


def project(x: torch.Tensor, qt: QTensor, fold: bool) -> torch.Tensor:
    """x [R, K] f32 @ dequant(W)^T in f32, through ``int8_group_fold``
    where ``fold`` and W is q4 (the plain versions' projections)."""
    if fold and qt.kind == "q4":
        return int8_group_fold(x, qt)
    return x @ dequant_kmajor(qt)
