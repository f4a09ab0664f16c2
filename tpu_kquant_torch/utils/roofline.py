"""Roofline accounting: how close a run comes to the card's memory and
tensor-core rates.

Single-stream decode is bound by the weights' bytes (every weight is read
once a token), so its roofline is memory rate / bytes per token; prefill
amortises the weights over the prompt and is bound by the matmuls' flops.
The bytes come from the port's ``QTensor`` layouts; the peaks are the
card's spec-sheet numbers, the same that ``chip_smoke.py:bound_ms`` uses.
"""

from __future__ import annotations

from typing import Any

# chip -> (device memory GB/s, dense bf16 tensor-core TFLOP/s): NVIDIA's
# H100 SXM data sheet (80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s at 700 W)
CHIP_SPECS = {
    "h100": (3350.0, 989.0),
}
DEFAULT_CHIP = "h100"


def chip_specs(chip: str = DEFAULT_CHIP) -> tuple[float, float]:
    """(GB/s, bf16 TFLOP/s) of ``chip``; raises KeyError for an unknown one."""
    return CHIP_SPECS[chip]


def model_bytes_per_token(params: dict[str, Any], batch: int = 1) -> dict[str, int]:
    """Device-memory bytes read per decode step: every kmajor weight once;
    of each embedding table (rowmajor) one row per sequence."""
    from tpu_kquant_torch.quant.qtensor import QTensor

    weight_bytes = 0
    embed_row_bytes = 0

    def visit(node):
        nonlocal weight_bytes, embed_row_bytes
        if isinstance(node, QTensor):
            if node.layout == "rowmajor":
                embed_row_bytes += node.n_bytes // max(1, node.shape[0])
            else:
                weight_bytes += node.n_bytes
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(params)
    return {
        "weight_bytes": weight_bytes,
        "embed_row_bytes": embed_row_bytes * batch,
        "total": weight_bytes + embed_row_bytes * batch,
    }


def kv_bytes_per_token(cfg, seq_len: int, batch: int, quantized: bool) -> int:
    """KV cache bytes read per decode step (attention streams the prefix)."""
    per_tok = cfg.n_kv_heads * cfg.head_dim * (1 if quantized else 2)
    scales = cfg.n_kv_heads * 4 if quantized else 0
    return 2 * cfg.n_layers * batch * seq_len * (per_tok + scales)


def matmul_flops_per_token(params: dict[str, Any]) -> float:
    """Matmul flops per token through every kmajor weight (2 N K each); an
    MoE counts every expert (the port's loop computes them all)."""
    from tpu_kquant_torch.quant.qtensor import QTensor

    flops = 0.0

    def visit(node):
        nonlocal flops
        if isinstance(node, QTensor):
            if node.layout == "kmajor":
                n = 1.0
                for d in node.shape:
                    n *= float(d)
                flops += 2.0 * n
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(params)
    return flops


def prefill_roofline_report(params: dict[str, Any], cfg, measured_tok_s: float, T: int,
                            chip: str = DEFAULT_CHIP, batch: int = 1) -> dict[str, float]:
    """Prefill's ceiling: the smaller of the tensor-core rate over the
    flops per token (matmuls plus causal attention at an average context of
    T/2) and the memory rate over the weights' bytes spread over B T tokens."""
    hbm_gbs, tflops = chip_specs(chip)
    mm = matmul_flops_per_token(params)
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (T / 2.0)
    flops_per_tok = mm + attn
    mxu_tok_s = tflops * 1e12 / flops_per_tok
    wb = model_bytes_per_token(params, batch)["weight_bytes"]
    hbm_tok_s = hbm_gbs * 1e9 / (wb / max(1, batch * T))
    roof = min(mxu_tok_s, hbm_tok_s)
    return {
        "flops_per_token": float(flops_per_tok),
        "mxu_roof_tok_s": float(mxu_tok_s),
        "hbm_roof_tok_s": float(hbm_tok_s),
        "roofline_tok_s": float(roof),
        "bound": "mxu" if mxu_tok_s <= hbm_tok_s else "hbm",
        "measured_tok_s": float(measured_tok_s),
        "fraction_of_roofline": float(measured_tok_s / roof),
        "chip": chip,  # type: ignore[dict-item]
    }


def roofline_report(params: dict[str, Any], cfg, measured_tok_s: float,
                    chip: str = DEFAULT_CHIP, batch: int = 1, seq_len: int = 0,
                    kv_quantized: bool = False) -> dict[str, float]:
    """Decode's ceiling: the memory rate over the bytes of one step (the
    weights, one embedding row per sequence and, at ``seq_len``, the KV
    prefix), times the batch."""
    hbm_gbs, _ = chip_specs(chip)
    wb = model_bytes_per_token(params, batch)["total"]
    kb = kv_bytes_per_token(cfg, seq_len, batch, kv_quantized) if seq_len else 0
    bytes_per_step = wb + kb
    roof_tok_s = hbm_gbs * 1e9 / bytes_per_step * batch
    return {
        "bytes_per_step": float(bytes_per_step),
        "weight_bytes": float(wb),
        "kv_bytes": float(kb),
        "roofline_tok_s": float(roof_tok_s),
        "measured_tok_s": float(measured_tok_s),
        "fraction_of_roofline": float(measured_tok_s / roof_tok_s),
        "chip": chip,  # type: ignore[dict-item]
    }
