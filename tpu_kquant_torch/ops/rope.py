"""Rotary position embeddings (NORM and NEOX pairing) with linear and YaRN
frequency scaling: the port of ``tpu_kquant.ops.rope``."""

from __future__ import annotations

import math

import torch

from tpu_kquant_torch.models.config import RopeParams


def _yarn_corr_dim(n_rot: int, n_ctx_orig: int, beta: float, base: float) -> float:
    return n_rot * math.log(n_ctx_orig / (beta * 2 * math.pi)) / (2 * math.log(base))


def rope_cos_sin(positions: torch.Tensor, p: RopeParams) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables in f32 for ``positions`` [...] -> [..., n_rot/2]."""
    half = p.n_rot // 2
    dim_idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = p.freq_base ** (-2.0 * dim_idx / p.n_rot)
    theta_extrap = positions.float()[..., None] * inv_freq
    theta_interp = p.freq_scale * theta_extrap
    mscale = p.attn_factor
    if p.ext_factor != 0.0 and p.n_ctx_orig > 0:
        low = _yarn_corr_dim(p.n_rot, p.n_ctx_orig, p.beta_fast, p.freq_base)
        high = _yarn_corr_dim(p.n_rot, p.n_ctx_orig, p.beta_slow, p.freq_base)
        low, high = max(0.0, math.floor(low)), min(p.n_rot - 1.0, math.ceil(high))
        ramp = 1.0 - torch.clamp((dim_idx - low) / max(0.001, high - low), 0.0, 1.0)
        mix = ramp * p.ext_factor
        theta = theta_interp * (1.0 - mix) + theta_extrap * mix
        mscale = p.attn_factor * (1.0 + 0.1 * math.log(1.0 / p.freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def rope_delta_cos_sin(delta: int, p: RopeParams,
                       device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-magnitude tables [n_rot/2] that rotate already-roped K vectors by
    ``delta`` positions (the KV cache's context shift). Theta is linear in
    the position even under YaRN, so rope(pos + delta) = rotate(rope(pos),
    delta); rope_cos_sin folds YaRN's mscale into both tables, and cos at
    position 0 is exactly mscale, so dividing by it leaves a pure
    rotation."""
    c0, _ = rope_cos_sin(torch.zeros((), device=device), p)
    c, s = rope_cos_sin(torch.tensor(float(delta), device=device), p)
    return c / c0, s / c0


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               mode: str = "norm") -> torch.Tensor:
    """Rotate the last dim of x [..., H, D]; cos/sin broadcast to [..., 1, D/2].

    'neox' pairs (i, i + D/2); 'norm' pairs (2i, 2i+1). Computed in f32."""
    d2 = x.shape[-1] // 2
    rot = x[..., : 2 * d2].float()
    if mode == "neox":
        x1, x2 = rot[..., :d2], rot[..., d2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rot.shape)
    if x.shape[-1] > 2 * d2:
        out = torch.cat([out, x[..., 2 * d2:].float()], dim=-1)
    return out.to(x.dtype)
