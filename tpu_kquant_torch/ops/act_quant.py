"""Q8_K-style activation quantization, the counterpart of
``tpu_kquant.ops.act_quant``.

The int8 path (ops.qmm_int8) contracts int8 activations with the weights'
integer codes per 32-group, as ggml's ``ggml_vec_dot_q4_K_q8_K`` does:

  xq     int8 [..., K]     round(x / scale), clamped to +-127
  scales f32  [..., K/g]   amax per group / 127
  gsums  f32  [..., K/g]   scale * sum(xq in group): the Q4_K min term
                           becomes gsums @ mins (ggml's ``bsums``)

Rounding is the reference's, byte for byte: amax and x are divided (not
multiplied by a reciprocal), ``torch.round`` rounds half to even as
``jnp.round`` does, and an all-zero group divides by 1, so its codes and
gsum are 0. The divisor 127 is a full tensor: PyTorch's CUDA division by a
Python scalar multiplies by its reciprocal, which moves some scales by an
ulp and with them codes near .5. Plain PyTorch on any device: the kernel's
own quantization (``csrc/int8.cuh:quantize_kernel``, and ``i8_stage_xn``
for the int8 folds of ``ops.dequant``) is held to it on the card.
"""

from __future__ import annotations

import torch


def quantize_activations(x: torch.Tensor, group: int = 32):
    """x [..., K] float -> (xq int8 [..., K], scales f32 [..., K/g], gsums f32)."""
    K = x.shape[-1]
    if K % group:
        raise ValueError(f"K={K} is not a multiple of the group {group}")
    xg = x.float().reshape(*x.shape[:-1], K // group, group)
    amax = xg.abs().amax(dim=-1)
    scales = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(xg / safe[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scales, scales * q.sum(dim=-1)
