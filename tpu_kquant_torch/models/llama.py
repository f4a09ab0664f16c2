"""Llama-family forward pass: the port of ``tpu_kquant.models.llama``
(``llama_forward`` / ``llama_layer``, unrolled over layers).

Params: {'tok_embd': QTensor(rowmajor), 'output_norm', 'output',
         'layers': [{'attn_norm', 'wqk' (or 'wq', 'wk'), 'wv', 'wo',
                     'ffn_norm', 'w_gateup' (or 'w_gate', 'w_up'), 'w_down',
                     and with cfg.attn_bias f32 'bqk' ([bq | bk]), 'bv';
                     a MoE layer has 'gate_inp' and 'experts' ({'w_gate',
                     'w_up', 'w_down'}, stacked [E, ...]) instead of the
                     FFN weights}]}

Dispatch follows the reference: at rows <= 32 a layer runs the attn_in
kernel (biases in its epilogue) and the oproj_ffn kernel where their gates
pass, or, where only the FFN gate passes (qwen2: attention width 1536 is
not a multiple of 1024), an o_proj qmatmul and the ffn kernel (on the CPU,
their plain versions); otherwise every projection is a qmatmul and the
biases are added after it, which turns q/k/v (and from there the residual
stream) f32, as in the reference. A MoE layer (cfg.is_moe) never takes
oproj_ffn or ffn: o_proj is a qmatmul, then the residual, rms_norm and
models.moe.moe_ffn. ``impl`` is the reference's: "auto", or "int8", under
which ops.qmatmul sends decode-sized products on q4 and unwidened q6
weights with f32 scales to the qmm_int8 kernel (the fused kernels' gates
accept both). The gates take the reference's kinds: attn_in q4, q6w or q8
in either slot, oproj_ffn and ffn q4, q6w or q8 for o_proj and gate/up and
q6w or q8 for down; every other kind (q5, q3, q2, unwidened q6) goes to
qmatmul. Attention
(ops.attention) runs plain PyTorch, or the flash prefill kernel for long
prompts; the KV cache is bf16 or int8.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.models.moe import moe_ffn
from tpu_kquant_torch.ops import attention
from tpu_kquant_torch.ops.activations import swiglu
from tpu_kquant_torch.ops.attn_in import attn_in_supported, fused_attn_in
from tpu_kquant_torch.ops.ffn import (
    ffn_supported,
    fused_ffn,
    fused_oproj_ffn,
    oproj_ffn_supported,
)
from tpu_kquant_torch.ops.norms import rms_norm
from tpu_kquant_torch.ops.qmatmul import IMPLS, qmatmul
from tpu_kquant_torch.ops.rope import apply_rope, rope_cos_sin
from tpu_kquant_torch.quant.codecs import dequant_rows
from tpu_kquant_torch.runtime.kv_cache import KVCache


def _norm_w(qt) -> torch.Tensor:
    return qt.arrays["w"]


def llama_layer(
    layer: dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, T, dim] bf16
    positions: torch.Tensor,  # [B, T]
    cos: torch.Tensor,  # [B, T, head_dim/2] f32
    sin: torch.Tensor,
    kv_write: Callable,  # (k, v) -> (k_all, v_all, scales[, kv_cur])
    kv_attend_len: int | None = None,  # attention reads only cache slots
    #   [0, kv_attend_len): valid ONLY when every query position is below it
    #   (bucketed prefill, positions = arange(T))
    impl: str = "auto",
) -> torch.Tensor:
    """One transformer block; returns the new residual stream."""
    B, T, dim = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    biases = (layer["bqk"], layer["bv"]) if cfg.attn_bias else None
    if cfg.rope.mode == "neox" and cfg.rope.n_rot == D and "wqk" in layer and \
            attn_in_supported(layer["wqk"], layer["wv"], B * T, dim, D, biases, impl):
        qk, v = fused_attn_in(x, _norm_w(layer["attn_norm"]), cfg.norm_eps, layer["wqk"],
                              layer["wv"], cos, sin, D, biases)
        q = qk[..., : H * D].reshape(B, T, H, D)
        k = qk[..., H * D:].reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
    else:
        h = rms_norm(x, _norm_w(layer["attn_norm"]), cfg.norm_eps)
        if "wqk" in layer:
            qk = qmatmul(h, layer["wqk"], impl)
            q = qk[..., : H * D].reshape(B, T, H, D)
            k = qk[..., H * D:].reshape(B, T, Hkv, D)
        else:
            q = qmatmul(h, layer["wq"], impl).reshape(B, T, H, D)
            k = qmatmul(h, layer["wk"], impl).reshape(B, T, Hkv, D)
        v = qmatmul(h, layer["wv"], impl).reshape(B, T, Hkv, D)
        if cfg.attn_bias:  # bf16 + f32: q/k/v become f32, as in the reference
            q = q + layer["bqk"][: H * D].reshape(H, D)
            k = k + layer["bqk"][H * D:].reshape(Hkv, D)
            v = v + layer["bv"].reshape(Hkv, D)
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :], cfg.rope.mode)
        k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :], cfg.rope.mode)

    view = kv_write(k, v)
    k_all, v_all, kv_scales = view[:3]
    kv_cur = view[3] if len(view) == 4 else None
    if kv_attend_len is not None and kv_cur is None and kv_attend_len < k_all.shape[2]:
        # views of the cache, no copy
        k_all = k_all[:, :, :kv_attend_len]
        v_all = v_all[:, :, :kv_attend_len]
        if kv_scales is not None:
            kv_scales = (kv_scales[0][..., :kv_attend_len], kv_scales[1][..., :kv_attend_len])
    attn = attention.attention_decode(q, k_all, v_all, positions, kv_scales,
                                      kv_cur=kv_cur).reshape(B, T, H * D)

    if "w_gateup" in layer and oproj_ffn_supported(layer["wo"], layer["w_gateup"],
                                                   layer["w_down"], B * T):
        return fused_oproj_ffn(x, attn, layer["wo"], _norm_w(layer["ffn_norm"]),
                               cfg.norm_eps, layer["w_gateup"], layer["w_down"])
    x = x + qmatmul(attn, layer["wo"], impl)
    if "w_gateup" in layer and ffn_supported(layer["w_gateup"], layer["w_down"], B * T):
        return fused_ffn(x, _norm_w(layer["ffn_norm"]), cfg.norm_eps, layer["w_gateup"],
                         layer["w_down"])
    h = rms_norm(x, _norm_w(layer["ffn_norm"]), cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_ffn(layer, cfg, h, impl)
    if "w_gateup" in layer:
        gu = qmatmul(h, layer["w_gateup"], impl)
        F = gu.shape[-1] // 2
        act = swiglu(gu[..., :F], gu[..., F:])
    else:
        act = swiglu(qmatmul(h, layer["w_gate"], impl), qmatmul(h, layer["w_up"], impl))
    return x + qmatmul(act, layer["w_down"], impl)


def llama_forward(
    params: dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int64
    positions: torch.Tensor,  # [B, T] int64, contiguous per row
    cache: KVCache,
    logits_last_only: bool = False,
    kv_attend_len: int | None = None,  # see llama_layer
    impl: str = "auto",  # see the module docstring
    kv_valid: torch.Tensor | None = None,  # [B, T] bool, the non-pad slots: on the
    #   unified cache it only turns the deferred append off, as in the reference
    #   (pads are overwritten before any query attends them)
) -> tuple[torch.Tensor, KVCache]:
    """Returns (logits [B, T, vocab] f32 (or [B, 1, vocab]), cache). The
    cache is updated in place."""
    if cfg.act_fn != "silu" or cfg.post_norms \
            or cfg.sliding_window or cfg.attn_logit_softcap or cfg.final_logit_softcap:
        raise NotImplementedError(f"{cfg.arch} quirks are not ported yet")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    x = dequant_rows(params["tok_embd"], tokens, dtype=torch.bfloat16)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(positions, cfg.rope)

    # deferred batched KV append at decode: each layer's attention takes its
    # current (k, v) as kv_cur and all layers' rows are written in one
    # append after the loop, instead of two writes per layer. kv_cur keeps
    # attention on the plain branch, so past the logits budget (large B * S)
    # the appends are eager and attention may leave it, as in the reference.
    B, T = tokens.shape
    defer = T == 1 and kv_valid is None and \
        attention.logits_mb(B, 1, cfg.n_heads, cache.max_seq) <= attention.ATTN_PLAIN_MAX_MB
    pending: list | None = [] if defer else None
    for i, layer in enumerate(params["layers"]):
        def kv_write(k_new, v_new, _i=i):
            if pending is not None:
                pending.append((k_new, v_new))
                return (*cache.layer_view(_i), (k_new, v_new))
            cache.append(_i, k_new, v_new, positions)
            return cache.layer_view(_i)

        x = llama_layer(layer, cfg, x, positions, cos, sin, kv_write,
                        kv_attend_len=kv_attend_len, impl=impl)
    if pending:
        cache.append_all(torch.stack([kv[0] for kv in pending]),
                         torch.stack([kv[1] for kv in pending]), positions)

    x = rms_norm(x, _norm_w(params["output_norm"]), cfg.norm_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    return qmatmul(x, params["output"], impl, out_dtype=torch.float32), cache
