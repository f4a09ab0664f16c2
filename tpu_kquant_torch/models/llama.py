"""Llama-family forward pass: the port of ``tpu_kquant.models.llama``
(``llama_forward`` / ``llama_layer``, unrolled over layers).

Params: {'tok_embd': QTensor(rowmajor), 'output_norm', 'output',
         'layers': [{'attn_norm', 'wqk' (or 'wq', 'wk'), 'wv' (phi3: one
                     'wqkv' in their place), 'wo',
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

The gemma family follows the reference's quirks: embeddings scaled by
sqrt(dim), the FFN's exact GELU (``cfg.act_fn``, which every fused FFN
kernel takes), a tied lm head; gemma2 adds a norm after attention and one
after the FFN (``post_attn_norm`` / ``post_ffn_norm``, which keep attn_out,
oproj_ffn, ffn, rot and layer off, as in the reference), an attention logit
softcap (plain attention only), a sliding window on every other layer
(``cfg.layer_window``; the layer kernel is off on those layers) and a
softcap on the f32 logits. A recurrent config (mamba) runs
models.mamba.mamba_forward, which the engine picks, as the reference's does.

phi3 keeps q, k and v in one weight, ``wqkv``, as the reference does: the
attn_in kernel (and the rot kernel's next-layer phase) takes it as the two
slots of ops.attn_in.qkv_slots (qk roped, v not), the plain path as one
qmatmul whose output splits into q, k and v (reference llama.py:66-128).

On the iSWA layout (runtime.kv_cache.ISWACache) each layer appends its own
rows before its attention (no deferred append; the pad tokens of a prefill
chunk, ``kv_valid``, leave the ring as it is), a ring layer attends with
``ring_last`` (its rows' last written position), which keeps the flash
kernels off, and neither attn_out nor the layer kernel runs (reference
llama.py:136-142, :320-356, :404-413).

The reference's opt-in decode fusions are read from the environment at
call time, under the reference's names and defaults, where the reference
reads them (tpu_kquant/models/llama.py):
- TKQ_DEFER_APPEND (default "1"): a decode step's K/V rows are written
  after the layer loop in one append_all; "0" appends each layer's rows
  before its attention (KVCache.append, which TKQ_KV_APPEND_PALLAS=1 sends
  to the kv_append kernel).
- TKQ_FUSE_ATTN_OUT=1 (only without the deferred append): attention, o_proj
  and the residual in the attn_out kernel, then the ffn kernel.
- TKQ_FUSE_LAYER=1 (turns the deferred append off): each decode layer in
  the layer kernel over the pre-append bf16 cache, then KVCache.append of
  its k_new / v_new.
- TKQ_ROTATE_LAYER=1 with TKQ_FUSE_OPROJ (default "1"): layer i's oproj_ffn
  and layer i + 1's attn_in in the rot kernel; layer i + 1 takes the qk / v
  it returns.
Each is off by default, as in the reference; the gates are in
ops.{kv_append,attn_out,layer,rot}. The default-on fusions read the
reference's switches at call time too: TKQ_FUSE_ATTN (attn_in),
TKQ_FUSE_OPROJ (oproj_ffn, and the rot kernel) and TKQ_FUSE_FFN (ffn), each
"1" by default and off at any other value (ops.attn_in.attn_in_enabled,
ops.ffn.oproj_ffn_enabled, ops.ffn.ffn_enabled).
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch

from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.models.moe import moe_ffn
from tpu_kquant_torch.ops import attention
from tpu_kquant_torch.ops.activations import geglu, swiglu
from tpu_kquant_torch.ops.attn_in import attn_in_enabled, fused_attn_in, qkv_slots
from tpu_kquant_torch.ops.attn_out import attn_out_enabled, fused_attn_out
from tpu_kquant_torch.ops.ffn import (
    ffn_enabled,
    fused_ffn,
    fused_oproj_ffn,
    oproj_ffn_enabled,
)
from tpu_kquant_torch.ops.layer import fused_layer, layer_enabled
from tpu_kquant_torch.ops.norms import rms_norm
from tpu_kquant_torch.ops.qmatmul import IMPLS, qmatmul
from tpu_kquant_torch.ops.qmm import GEMV_MAX_ROWS
from tpu_kquant_torch.ops.rope import apply_rope, rope_cos_sin
from tpu_kquant_torch.ops.rot import fused_oproj_ffn_attn_in, rot_enabled
from tpu_kquant_torch.quant.codecs import dequant_rows
from tpu_kquant_torch.runtime.kv_cache import ISWACache, KVCache


def _norm_w(qt) -> torch.Tensor:
    return qt.arrays["w"]


def qkv_weights(layer: dict[str, Any], cfg: ModelConfig):
    """A layer's attn_in slots (wqk, wv): phi3's wqkv as qkv_slots' two
    views, else the loaded wqk and wv (None where q and k are apart)."""
    if "wqkv" in layer:
        return qkv_slots(layer["wqkv"], (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim)
    return layer.get("wqk"), layer.get("wv")


def llama_layer(
    layer: dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, T, dim] bf16
    positions: torch.Tensor,  # [B, T]
    cos: torch.Tensor,  # [B, T, head_dim/2] f32
    sin: torch.Tensor,
    kv_write: Callable,  # (k, v) -> (k_all, v_all, scales, kv_cur, ring_last)
    kv_attend_len: int | None = None,  # attention reads only cache slots
    #   [0, kv_attend_len): valid ONLY when every query position is below it
    #   (bucketed prefill, positions = arange(T))
    impl: str = "auto",
    qkv_in: tuple[torch.Tensor, torch.Tensor] | None = None,  # (roped qk, v) of
    #   this layer from the previous layer's rot kernel
    next_layer: dict[str, Any] | None = None,  # the next layer's weights, for
    #   the rot kernel (rotated layer boundary)
    window: int = 0,  # this layer's sliding window (0: full attention)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """One transformer block. Returns (the new residual stream, the next
    layer's (roped qk, v) where the rot kernel computed them, else None)."""
    B, T, dim = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    biases = (layer["bqk"], layer["bv"]) if cfg.attn_bias else None
    wqk, wv = qkv_weights(layer, cfg)
    if qkv_in is not None:
        qk, v = qkv_in
        q = qk[..., : H * D].reshape(B, T, H, D)
        k = qk[..., H * D:].reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
    elif cfg.rope.mode == "neox" and cfg.rope.n_rot == D and wqk is not None and \
            attn_in_enabled(wqk, wv, B * T, dim, D, biases, impl):
        qk, v = fused_attn_in(x, _norm_w(layer["attn_norm"]), cfg.norm_eps, wqk, wv, cos, sin,
                              D, biases)
        q = qk[..., : H * D].reshape(B, T, H, D)
        k = qk[..., H * D:].reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
    else:
        h = rms_norm(x, _norm_w(layer["attn_norm"]), cfg.norm_eps)
        if "wqkv" in layer:  # phi3: one product, split into q, k, v
            qkv = qmatmul(h, layer["wqkv"], impl)
            q = qkv[..., : H * D].reshape(B, T, H, D)
            k = qkv[..., H * D: (H + Hkv) * D].reshape(B, T, Hkv, D)
            v = qkv[..., (H + Hkv) * D:].reshape(B, T, Hkv, D)
        elif "wqk" in layer:
            qk = qmatmul(h, layer["wqk"], impl)
            q = qk[..., : H * D].reshape(B, T, H, D)
            k = qk[..., H * D:].reshape(B, T, Hkv, D)
            v = qmatmul(h, layer["wv"], impl).reshape(B, T, Hkv, D)
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

    k_all, v_all, kv_scales, kv_cur, ring_last = kv_write(k, v)
    if kv_attend_len is not None and kv_cur is None and ring_last is None and \
            kv_attend_len < k_all.shape[2]:
        # views of the cache, no copy
        k_all = k_all[:, :, :kv_attend_len]
        v_all = v_all[:, :, :kv_attend_len]
        if kv_scales is not None:
            kv_scales = (kv_scales[0][..., :kv_attend_len], kv_scales[1][..., :kv_attend_len])
    # the fused FFN kernels (and attn_out) hold no post norm: gemma2 takes the
    # unfused path from o_proj on, as in the reference
    gu = "w_gateup" in layer and not cfg.is_moe and not cfg.post_norms
    act_fn = cfg.act_fn
    if T == 1 and kv_cur is None and ring_last is None and cfg.attn_logit_softcap == 0.0 \
            and window == 0 and not cfg.post_norms and \
            attn_out_enabled(impl, layer["wo"], H, Hkv, D, B, int(k_all.shape[2])):
        # attention + o_proj + residual in one call; then the FFN below
        x = fused_attn_out(x, q, k_all, v_all, positions, kv_scales, layer["wo"])
    else:
        attn = attention.attention_decode(q, k_all, v_all, positions, kv_scales,
                                          kv_cur=kv_cur, logit_softcap=cfg.attn_logit_softcap,
                                          sliding_window=window,
                                          ring_last=ring_last).reshape(B, T, H * D)
        ws2 = (None, None) if next_layer is None else qkv_weights(next_layer, cfg)
        if gu and ws2[0] is not None and rot_enabled(
                impl, layer["wo"], layer["w_gateup"], layer["w_down"], list(ws2), B * T, dim,
                D):
            y, qk2, v2 = fused_oproj_ffn_attn_in(
                x, attn, layer["wo"], _norm_w(layer["ffn_norm"]), cfg.norm_eps,
                layer["w_gateup"], layer["w_down"], _norm_w(next_layer["attn_norm"]), *ws2,
                cos, sin, D, act_fn=act_fn)
            return y, (qk2, v2)
        if gu and oproj_ffn_enabled(impl, layer["wo"], layer["w_gateup"], layer["w_down"],
                                    B * T):
            return fused_oproj_ffn(x, attn, layer["wo"], _norm_w(layer["ffn_norm"]),
                                   cfg.norm_eps, layer["w_gateup"], layer["w_down"],
                                   act_fn=act_fn), None
        h = qmatmul(attn, layer["wo"], impl)
        if cfg.post_norms:  # gemma2's norm after attention
            h = rms_norm(h, _norm_w(layer["post_attn_norm"]), cfg.norm_eps)
        x = x + h
    if gu and ffn_enabled(impl, layer["w_gateup"], layer["w_down"], B * T):
        return fused_ffn(x, _norm_w(layer["ffn_norm"]), cfg.norm_eps, layer["w_gateup"],
                         layer["w_down"], act_fn=act_fn), None
    h = rms_norm(x, _norm_w(layer["ffn_norm"]), cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_ffn(layer, cfg, h, impl), None
    act = geglu if act_fn == "gelu" else swiglu
    if "w_gateup" in layer:
        gu_out = qmatmul(h, layer["w_gateup"], impl)
        F = gu_out.shape[-1] // 2
        a = act(gu_out[..., :F], gu_out[..., F:])
    else:
        a = act(qmatmul(h, layer["w_gate"], impl), qmatmul(h, layer["w_up"], impl))
    h = qmatmul(a, layer["w_down"], impl)
    if cfg.post_norms:  # gemma2's norm after the FFN
        h = rms_norm(h, _norm_w(layer["post_ffn_norm"]), cfg.norm_eps)
    return x + h, None


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
    #   (pads are overwritten before any query attends them); on the iSWA
    #   layout pads leave the ring as it is
    logits_rows: torch.Tensor | None = None,  # [B] one row of each sequence to
    #   take logits of (the iSWA prefill's last prompt token), in place of all T
) -> tuple[torch.Tensor, KVCache | ISWACache]:
    """Returns (logits [B, T, vocab] f32 (or [B, 1, vocab]), cache). The
    cache is updated in place."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    x = dequant_rows(params["tok_embd"], tokens, dtype=torch.bfloat16)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=torch.bfloat16)
    cos, sin = rope_cos_sin(positions, cfg.rope)

    # deferred batched KV append at decode (TKQ_DEFER_APPEND, default on;
    # TKQ_FUSE_LAYER=1 turns it off): each layer's attention takes its
    # current (k, v) as kv_cur and all layers' rows are written in one
    # append after the loop, instead of two writes per layer. kv_cur keeps
    # attention on the plain branch, so past the logits budget (large B * S)
    # the appends are eager and attention may leave it, as in the reference.
    B, T = tokens.shape
    iswa = isinstance(cache, ISWACache)
    step_defers = not iswa and os.environ.get("TKQ_DEFER_APPEND", "1") == "1" and \
        os.environ.get("TKQ_FUSE_LAYER", "0") != "1" and \
        attention.logits_mb(B, 1, cfg.n_heads, cache.max_seq) <= attention.ATTN_PLAIN_MAX_MB
    defer = T == 1 and kv_valid is None and step_defers
    # a window of T > 1 tokens at any positions (engine.step: speculative
    # verification) on a bf16 cache, within the GEMV's rows and with its
    # logits within the budget: its rows are appended first, then each query
    # takes its own (k, v) as kv_cur, which the plain attention runs as the
    # decode step at that position would. So row t equals the deferred
    # decode step at position p + t, bit for bit on the card (every kernel
    # at <= GEMV_MAX_ROWS rows is row-invariant). Past the budget the window
    # takes the reference's route (the flash prefill kernel where its shape
    # rule passes), whose rows are not the decode steps' bits. The reference
    # attends each query's int8 copy instead; int8 caches keep that.
    window_rows = T > 1 and kv_valid is None and kv_attend_len is None and \
        not cache.quantized and B * T <= GEMV_MAX_ROWS and step_defers and \
        attention.logits_mb(B, T, cfg.n_heads, cache.max_seq) <= attention.ATTN_PLAIN_MAX_MB
    # the whole-layer kernel's architecture test (reference: wl_possible);
    # layer_enabled decides per layer
    neox = cfg.rope.mode == "neox" and cfg.rope.n_rot == cfg.head_dim
    whole_layer = T == 1 and neox and not cfg.attn_bias and not cfg.is_moe and \
        not cfg.post_norms and cfg.attn_logit_softcap == 0.0 and kv_valid is None and \
        not cache.quantized and not iswa
    # rotated layer boundaries (reference: rot_arch_ok); rot_enabled decides
    # per pair of layers
    rotate = neox and not cfg.attn_bias and not cfg.is_moe and not cfg.post_norms
    layers = params["layers"]
    pending: list | None = [] if defer else None
    pending_qkv = None
    for i, layer in enumerate(layers):
        if whole_layer and not cfg.layer_window(i) and "wqk" in layer and \
                "w_gateup" in layer and layer_enabled(
                impl, layer["wqk"], layer["wv"], layer["wo"], layer["w_gateup"],
                layer["w_down"], B, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim):
            x, k_new, v_new = fused_layer(
                x, positions, _norm_w(layer["attn_norm"]), _norm_w(layer["ffn_norm"]),
                cfg.norm_eps, layer["wqk"], layer["wv"], layer["wo"], layer["w_gateup"],
                layer["w_down"], cos, sin, cache.k[i], cache.v[i], cfg.n_heads,
                cfg.n_kv_heads, act_fn=cfg.act_fn)
            cache.append(i, k_new, v_new, positions)
            # the layer kernel computes its own QKV: a rot kernel's output for
            # this layer is stale and never reaches layer i + 1
            pending_qkv = None
            continue

        def kv_write(k_new, v_new, _i=i):
            """(k_all, v_all, scales, kv_cur, ring_last) for layer _i's attention."""
            if pending is not None:
                pending.append((k_new, v_new))
                return (*cache.layer_view(_i), (k_new, v_new), None)
            if iswa:
                cache.append(_i, k_new, v_new, positions, valid=kv_valid)
                return (*cache.layer_view(_i), None,
                        positions[:, -1] if cache.is_ring(_i) else None)
            cache.append(_i, k_new, v_new, positions)
            if window_rows:  # the rows as stored, as the reference attends them
                return (*cache.layer_view(_i), (k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)),
                        None)
            return (*cache.layer_view(_i), None, None)

        nxt = layers[i + 1] if rotate and i + 1 < len(layers) else None
        x, pending_qkv = llama_layer(layer, cfg, x, positions, cos, sin, kv_write,
                                     kv_attend_len=kv_attend_len, impl=impl,
                                     qkv_in=pending_qkv, next_layer=nxt,
                                     window=cfg.layer_window(i))
    if pending:
        cache.append_all(torch.stack([kv[0] for kv in pending]),
                         torch.stack([kv[1] for kv in pending]), positions)

    x = rms_norm(x, _norm_w(params["output_norm"]), cfg.norm_eps)
    if logits_rows is not None:
        x = x[torch.arange(B, device=x.device), logits_rows][:, None]
    elif logits_last_only:
        x = x[:, -1:, :]
    logits = qmatmul(x, params["output"], impl, out_dtype=torch.float32)
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits, cache
