"""GGUF -> (ModelConfig, params) loader: the llama branch of
``tpu_kquant.runtime.loader.load_model``.

Each tensor is repacked on the host (quant.repack) into the layout the
kernels read, then copied to ``device`` still packed. Q and K are fused into
``wqk`` and gate and up into ``w_gateup`` (one launch each instead of two);
NORM-mode rope is canonicalised to NEOX by permuting q/k output features, so
every rope downstream is a half rotation. Qwen2-style q/k/v biases load as
f32 vectors ``bqk`` (``[bq | bk]``, permuted with q/k, beside ``wqk``) and
``bv``; a file without ``output.weight`` ties the lm head to ``token_embd``
(qwen2's tied presets, the gemma family). gemma2's post-attention and
post-FFN norms load as ``post_attn_norm`` / ``post_ffn_norm``. phi3's
pre-fused tensors load as they are, as the reference's fused load does:
``attn_qkv`` (rows q, k, v, HF's ``qkv_proj`` order) as ``wqkv``, which
ops.attn_in runs as two slots over its bytes (``qkv_slots``), and
``ffn_up`` [2F, D] (gate rows, then up) as ``w_gateup``, the layout
fuse_kmajor builds from two tensors.
A MoE layer (``expert_count`` in the metadata: Mixtral) loads its router
``gate_inp`` and its experts stacked to [E, ...] (``experts``: ``w_gate``,
``w_up``, ``w_down``), each expert repacked as a 2-D weight.
A ``mamba`` file (``_load_mamba``, the reference's) loads per layer the
matmul weights ``ssm_in``, ``ssm_x``, ``ssm_dt`` and ``ssm_out``, repacked
like any other (an F16 ``ssm_dt`` becomes a ``dense`` QTensor), and its SSM
side arrays as dense f32 tensors: ``conv_w`` [d_inner, d_conv], ``conv_b``,
``dt_b``, ``A_log`` [d_inner, d_state] and ``Dd``.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from tpu_kquant_torch.gguf import GGUFReader
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import (
    pack_scale_kpairs,
    pack_scale_pairs,
    repack,
    widen_q6,
)

LLAMA_FAMILY = {"llama", "mistral", "qwen2", "tinyllama", "mixtral", "gemma", "gemma2", "phi3"}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def _rope_neox_perm(n_feats: int, head_dim: int) -> np.ndarray:
    """Per-head un-interleave: the output-feature permutation that turns
    NORM rope pairing (2i, 2i+1) into NEOX pairing (i, i + D/2). Applied to
    q and k alike it leaves QK^T unchanged."""
    within = np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])
    base = np.arange(0, n_feats, head_dim)
    return (base[:, None] + within[None, :]).reshape(-1)


def permute_out_features(qt: QTensor, perm: np.ndarray) -> QTensor:
    """Reorder a weight's output features: N is the last axis of every
    kmajor packed array (the bit layout is untouched) and the first of a
    dense weight (an F32 / F16 / BF16 file's)."""
    if qt.layout == "kmajor":
        arrays = {k: np.ascontiguousarray(np.asarray(v)[:, perm]) for k, v in qt.arrays.items()}
    elif qt.layout == "dense":
        arrays = {"w": np.ascontiguousarray(np.asarray(qt.arrays["w"])[perm])}
    else:
        raise ValueError(f"cannot permute layout {qt.layout!r}")
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def fuse_kmajor(qts: list[QTensor]) -> QTensor | None:
    """Concatenate same-kind kmajor QTensors along N, or None if they differ."""
    if not all(q.layout == "kmajor" and q.kind == qts[0].kind for q in qts):
        return None
    if not all(q.shape[-1] == qts[0].shape[-1] for q in qts):
        return None
    if not all(set(q.arrays) == set(qts[0].arrays) for q in qts):
        return None
    arrays = {k: np.concatenate([np.asarray(q.arrays[k]) for q in qts], axis=1)
              for k in qts[0].arrays}
    n_total = sum(int(np.prod(q.shape[:-1])) for q in qts)
    return QTensor(qts[0].kind, "kmajor", (n_total, qts[0].shape[-1]), arrays)


def _pack(qt: QTensor, layout: str, pack_pairs: bool, widen: bool) -> QTensor:
    if widen:
        qt = widen_q6(qt)
    if pack_pairs:
        qt = pack_scale_pairs(qt)
        if layout == "kmajor":
            qt = pack_scale_kpairs(qt)
    return qt


def _repack_named(r: GGUFReader, name: str, layout: str, pack_pairs: bool,
                  widen: bool) -> QTensor:
    ti = r.tensors[name]
    return _pack(repack(r.tensor_bytes(name), ti.ggml_type, ti.shape, layout=layout), layout,
                 pack_pairs, widen)


def _repack_tied(r: GGUFReader, name: str, pack_pairs: bool,
                 widen: bool) -> tuple[QTensor, QTensor]:
    """A tied embedding's two layouts (rowmajor for the row gather, kmajor
    for the lm head) from ONE decode of its blocks: repack's rowmajor arrays
    are its kmajor ones transposed, before either is packed further. The
    same bytes as two repacks (tests/test_torch_frontdoor.py)."""
    ti = r.tensors[name]
    km = repack(r.tensor_bytes(name), ti.ggml_type, ti.shape, layout="kmajor")
    if km.layout != "kmajor":  # dense: one layout serves both
        return km, km
    rm = QTensor(km.kind, "rowmajor", km.shape, {k: v.T for k, v in km.arrays.items()})
    return (_pack(rm, "rowmajor", pack_pairs, widen), _pack(km, "kmajor", pack_pairs, widen))


def _expert_split(r: GGUFReader, name: str, pack_pairs: bool, widen: bool) -> list[QTensor]:
    """Split a stacked (E, N, K) expert tensor into per-expert kmajor
    QTensors (each expert's bytes are a contiguous slice of the tensor).
    The experts are repacked on parallel threads: NumPy's array operations
    release the GIL, and a Mixtral-8x7B layer holds 24 expert matrices of
    58.7 M weights."""
    ti = r.tensors[name]
    E, N, K = ti.shape
    raw = r.tensor_bytes(name)
    per = raw.size // E

    def one(e: int) -> QTensor:
        qt = repack(raw[e * per:(e + 1) * per], ti.ggml_type, (N, K), layout="kmajor")
        return _pack(qt, "kmajor", pack_pairs, widen)

    with ThreadPoolExecutor(max_workers=min(E, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, range(E)))


def _stack_experts(qts: list[QTensor]) -> QTensor:
    """Per-expert QTensors -> one QTensor [E, N, K] with each array stacked."""
    arrays = {k: np.stack([np.asarray(q.arrays[k]) for q in qts]) for k in qts[0].arrays}
    return QTensor(qts[0].kind, "kmajor", (len(qts),) + tuple(qts[0].shape), arrays)


def load_model(
    path: str,
    scale_dtype: str = "bf16",
    device: str | torch.device = "cuda",
    widen_q6: bool = True,
) -> tuple[ModelConfig, dict[str, Any], GGUFReader]:
    """Load a llama-family or mamba GGUF model onto ``device``. Every GGML type the
    reference loads is repacked (quant.repack): Q2_K, Q3_K, Q4_K / Q4_0 /
    Q4_1, Q5_K / Q5_0 / Q5_1, Q6_K and Q8_0 into the kinds q2 ... q8; float
    and other types become dense.

    scale_dtype: 'bf16' packs the per-group scale/min side arrays into bf16
    pairs (``sm``/``sp``); 'f32' keeps f32 ``scales``/``mins`` (the
    reference's default, and the layout its int8 path reads). Every kernel
    reads both.

    widen_q6: store Q6_K matmul weights as int8 codes ('q6w',
    quant.repack.widen_q6), as the reference's ``load_model`` does by
    default; False keeps them 6-bit ('q6': ``qs`` + ``qh`` with scales and
    mins), the layout the int8 path's q6 branch reads.

    Returns (cfg, params, reader); the reader holds the metadata."""
    dev = resolve_device(device)
    if scale_dtype not in ("bf16", "f32"):
        raise ValueError(f"scale_dtype must be 'bf16' or 'f32', got {scale_dtype!r}")
    pack_pairs = scale_dtype == "bf16"
    r = GGUFReader(path)
    cfg = ModelConfig.from_gguf(r.metadata)
    if cfg.is_recurrent:
        return _load_mamba(r, cfg, dev, pack_pairs, widen_q6)
    if cfg.arch not in LLAMA_FAMILY:
        raise NotImplementedError(f"architecture {cfg.arch!r} is not ported yet")
    if "blk.0.attn_q.bias" in r.tensors:  # qwen2-style attention biases
        cfg = dataclasses.replace(cfg, attn_bias=True)

    canon_rope = (cfg.rope.mode == "norm" and cfg.rope.n_rot == cfg.head_dim
                  and cfg.head_dim % 2 == 0)
    if canon_rope:
        cfg = dataclasses.replace(cfg, rope=dataclasses.replace(cfg.rope, mode="neox"))
        q_perm = _rope_neox_perm(cfg.n_heads * cfg.head_dim, cfg.head_dim)
        k_perm = _rope_neox_perm(cfg.n_kv_heads * cfg.head_dim, cfg.head_dim)

    def host(name: str, layout: str = "kmajor") -> QTensor:
        return _repack_named(r, name, layout, pack_pairs, widen_q6)

    def rp(name: str, layout: str = "kmajor") -> QTensor:
        return host(name, layout).to(dev)

    def load_layer(i: int) -> dict[str, Any]:
        p = f"blk.{i}."
        layer: dict[str, Any] = {
            "attn_norm": rp(p + "attn_norm.weight", "dense"),
            "wo": rp(p + "attn_output.weight"),
            "ffn_norm": rp(p + "ffn_norm.weight", "dense"),
        }
        if cfg.post_norms:  # gemma2's norms after attention and after the FFN
            layer["post_attn_norm"] = rp(p + "post_attention_norm.weight", "dense")
            layer["post_ffn_norm"] = rp(p + "post_ffw_norm.weight", "dense")
        if p + "attn_qkv.weight" in r.tensors:  # phi3: q, k and v in one tensor
            wqkv = host(p + "attn_qkv.weight")
            if canon_rope:
                nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
                wqkv = permute_out_features(wqkv, np.concatenate(
                    [q_perm, nq + k_perm, nq + nkv + np.arange(nkv)]))
            layer["wqkv"] = wqkv.to(dev)
        else:
            wq = host(p + "attn_q.weight")
            wk = host(p + "attn_k.weight")
            if canon_rope:
                wq = permute_out_features(wq, q_perm)
                wk = permute_out_features(wk, k_perm)
            fused_qk = fuse_kmajor([wq, wk])
            if fused_qk is not None:
                layer["wqk"] = fused_qk.to(dev)
            else:
                layer["wq"], layer["wk"] = wq.to(dev), wk.to(dev)
            layer["wv"] = rp(p + "attn_v.weight")
        if cfg.attn_bias:
            bq, bk = r.tensor_float(p + "attn_q.bias"), r.tensor_float(p + "attn_k.bias")
            if canon_rope:
                bq, bk = bq[q_perm], bk[k_perm]
            bv = r.tensor_float(p + "attn_v.bias")
            for b, v in (("bqk", np.concatenate([bq, bk])), ("bv", bv)):
                layer[b] = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
        if cfg.is_moe:
            layer["gate_inp"] = rp(p + "ffn_gate_inp.weight")
            layer["experts"] = {
                wname: _stack_experts(_expert_split(r, p + tname, pack_pairs, widen_q6)).to(dev)
                for wname, tname in (("w_gate", "ffn_gate_exps.weight"),
                                     ("w_up", "ffn_up_exps.weight"),
                                     ("w_down", "ffn_down_exps.weight"))}
            return layer
        if p + "ffn_gate.weight" not in r.tensors:  # phi3: ffn_up is [gate | up]
            layer["w_gateup"] = rp(p + "ffn_up.weight")
            layer["w_down"] = rp(p + "ffn_down.weight")
            return layer
        fused_gu = fuse_kmajor([host(p + "ffn_gate.weight"), host(p + "ffn_up.weight")])
        if fused_gu is not None:
            layer["w_gateup"] = fused_gu.to(dev)
        else:
            layer["w_gate"] = rp(p + "ffn_gate.weight")
            layer["w_up"] = rp(p + "ffn_up.weight")
        layer["w_down"] = rp(p + "ffn_down.weight")
        return layer

    # the repacks run on parallel threads (NumPy's array operations release
    # the GIL): the embeddings and the layers, in any order; the result is
    # the same as one by one
    with ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1))) as pool:
        emb = pool.submit(_embeddings, r, dev, pack_pairs, widen_q6)
        layers = list(pool.map(load_layer, range(cfg.n_layers)))
        params: dict[str, Any] = emb.result()
    params["layers"] = layers
    return cfg, params, r


def _embeddings(r: GGUFReader, dev: torch.device, pack_pairs: bool,
                widen: bool) -> dict[str, Any]:
    """tok_embd (rowmajor), output_norm and the lm head (kmajor; tied to
    token_embd where the file has no ``output.weight``) on ``dev``."""
    def rp(name: str, layout: str = "kmajor") -> QTensor:
        return _repack_named(r, name, layout, pack_pairs, widen).to(dev)

    norm = rp("output_norm.weight", "dense")
    if "output.weight" in r.tensors:
        embd, head = rp("token_embd.weight", "rowmajor"), rp("output.weight")
    else:  # tied embeddings: token_embd kmajor for the lm head too, one decode
        embd, head = (t.to(dev) for t in _repack_tied(r, "token_embd.weight", pack_pairs,
                                                      widen))
    return {"tok_embd": embd, "output_norm": norm, "output": head}


def _load_mamba(r: GGUFReader, cfg: ModelConfig, dev: torch.device, pack_pairs: bool,
                widen: bool) -> tuple[ModelConfig, dict[str, Any], GGUFReader]:
    """The mamba (recurrent) arch, llama.cpp's ``blk.N.ssm_*`` tensor names
    (reference: ``tpu_kquant/runtime/loader.py:_load_mamba``): the matmul
    weights repack like any other arch; the SSM side parameters are small
    f32 tensors kept dense. Layers repack on parallel threads, as
    load_model's do."""
    di, dc, ds = cfg.ssm_d_inner, cfg.ssm_d_conv, cfg.ssm_d_state

    def f32(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        a = np.ascontiguousarray(r.tensor_float(name), np.float32).reshape(shape)
        return torch.from_numpy(a).to(dev)

    def load_layer(i: int) -> dict[str, Any]:
        p = f"blk.{i}."
        layer: dict[str, Any] = {
            "attn_norm": _repack_named(r, p + "attn_norm.weight", "dense", pack_pairs,
                                       widen).to(dev)}
        for key in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out"):
            layer[key] = _repack_named(r, p + key + ".weight", "kmajor", pack_pairs,
                                       widen).to(dev)
        layer.update(conv_w=f32(p + "ssm_conv1d.weight", (di, dc)),
                     conv_b=f32(p + "ssm_conv1d.bias", (di,)),
                     dt_b=f32(p + "ssm_dt.bias", (di,)), A_log=f32(p + "ssm_a", (di, ds)),
                     Dd=f32(p + "ssm_d", (di,)))
        return layer

    with ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1))) as pool:
        emb = pool.submit(_embeddings, r, dev, pack_pairs, widen)
        layers = list(pool.map(load_layer, range(cfg.n_layers)))
        params: dict[str, Any] = emb.result()
    params["layers"] = layers
    return cfg, params, r


def params_from_numpy(params_np: Any, device: str | torch.device = "cuda") -> Any:
    """Turn parameters exported as numpy (the reference package's params with
    every array converted by ``np.asarray``) into the port's parameters on
    ``device``. A quantized tensor may be any object with ``kind``,
    ``layout``, ``shape`` and ``arrays`` attributes, or a dict with those
    keys; dicts and lists are walked (a MoE layer's ``experts`` dict of
    stacked QTensors and its ``gate_inp`` cross as they are); bare arrays
    become tensors. A layer's ``bq`` and ``bk`` become the port's fused
    ``bqk``; phi3's ``wqkv`` crosses as the one tensor it is."""
    dev = resolve_device(device)

    def conv(v: Any) -> Any:
        if isinstance(v, dict) and {"kind", "layout", "shape", "arrays"} <= set(v):
            v = QTensor(v["kind"], v["layout"], tuple(v["shape"]),
                        dict(v["arrays"]), v.get("tp"), v.get("fold", 1))
        elif all(hasattr(v, a) for a in ("kind", "layout", "shape", "arrays")):
            v = QTensor(v.kind, v.layout, tuple(v.shape), dict(v.arrays),
                        getattr(v, "tp", None), getattr(v, "fold", 1))
        if isinstance(v, QTensor):
            return QTensor(v.kind, v.layout, v.shape,
                           {k: np.asarray(a) for k, a in v.arrays.items()},
                           v.tp, v.fold).to(dev)
        if isinstance(v, dict):
            out = {k: conv(x) for k, x in v.items()}
            if "bq" in out and "bk" in out:
                out["bqk"] = torch.cat([out.pop("bq"), out.pop("bk")])
            return out
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.require(v, requirements=["C", "W"])).to(dev)
        return v

    return conv(params_np)
