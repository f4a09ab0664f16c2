"""Fixture models: GGUF files of a real architecture with random weights.

``write_fixture_gguf`` writes the llama tensor inventory with the llama.cpp
Q4_K_M type recipe (attn_v, ffn_down and output in Q6_K, the other matmul
weights Q4_K, norms F32), like ``tpu_kquant.models.fixtures``; qwen2 adds
F32 q/k/v biases, and a tied config writes no ``output.weight`` (the tied
``token_embd`` stays Q4_K, as the reference's recipe gives it). A MoE config
(``n_experts``) writes the router ``ffn_gate_inp`` [E, D] and the stacked
experts ``ffn_{gate,up}_exps`` [E, F, D] and ``ffn_down_exps`` [E, D, F] in
place of the FFN weights, under the same recipe (the router Q4_K, the downs
Q6_K), as the reference writes them. Unlike the
reference it does not quantize float weights: the port has no fast
quantizer (NumPy K-quant search takes seconds per 2048x2048 tensor, some
twenty minutes for a 1.1B model), so it DRAWS valid K-quant blocks directly.

- Q4_K: random 4-bit codes and 6-bit sub-scales ``sc`` in [32, 63], with mins
  ``m`` within 4 of ``sc`` and ``dmin = 7.5 d``, so every sub-block is
  centred (codes average 7.5); ``d`` is set so weights have standard
  deviation ``scale`` (0.05 by default).
- Q6_K: random 6-bit codes and int8 sub-scales in [8, 31] of random sign,
  ``d`` set the same way.

Everything downstream reads real K-quant bytes; only the values are not the
quantization of any float tensor.
"""

from __future__ import annotations

import numpy as np

from tpu_kquant_torch.gguf import GGMLType, GGUFWriter, row_size
from tpu_kquant_torch.models.config import ModelConfig, RopeParams


def tiny_config(arch: str = "llama", n_layers: int = 2, dim: int = 64,
                n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
                vocab_size: int = 512, max_seq_len: int = 256, n_experts: int = 0,
                n_experts_used: int = 0) -> ModelConfig:
    if arch not in ("llama", "qwen2"):
        raise NotImplementedError(f"arch {arch!r} is not ported yet")
    hd = dim // n_heads
    return ModelConfig(
        arch=arch, n_layers=n_layers, dim=dim, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=hd, ffn_dim=ffn_dim,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        rope=RopeParams(head_dim=hd, n_rot=hd, mode="neox" if arch == "qwen2" else "norm"),
        n_experts=n_experts, n_experts_used=n_experts_used, attn_bias=arch == "qwen2",
    )


def tinyllama_1b_config() -> ModelConfig:
    """TinyLlama-1.1B-Chat-v1.0: 22 layers, dim 2048, 32/4 heads of 64,
    ffn 5632, vocab 32000."""
    return ModelConfig(
        arch="llama", n_layers=22, dim=2048, n_heads=32, n_kv_heads=4,
        head_dim=64, ffn_dim=5632, vocab_size=32000, max_seq_len=2048,
        rope=RopeParams(head_dim=64, n_rot=64),
    )


def qwen2_5_1_5b_config() -> ModelConfig:
    """Qwen2.5-1.5B-Instruct (its config.json): 28 layers, dim 1536, 12/2
    heads of 128, ffn 8960, vocab 151936, rope theta 1e6, rms eps 1e-6,
    context 32768, q/k/v biases, lm head tied to the embedding."""
    return ModelConfig(
        arch="qwen2", n_layers=28, dim=1536, n_heads=12, n_kv_heads=2,
        head_dim=128, ffn_dim=8960, vocab_size=151936, max_seq_len=32768,
        norm_eps=1e-6, rope=RopeParams(head_dim=128, n_rot=128, freq_base=1e6, mode="neox"),
        tie_embeddings=True, attn_bias=True,
    )


def mixtral_8x7b_config() -> ModelConfig:
    """Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's config.json; a llama-arch
    GGUF with ``expert_count``): 32 layers, dim 4096, 32 / 8 heads of 128,
    ffn 14336 per expert, 8 experts of which 2 run per token, vocab 32000,
    rope theta 1e6."""
    return ModelConfig(
        arch="llama", n_layers=32, dim=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, ffn_dim=14336, vocab_size=32000, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=1000000.0),
        n_experts=8, n_experts_used=2,
    )


def qtype_for(name: str) -> GGMLType:
    """llama.cpp Q4_K_M type recipe for a tensor name."""
    if name.endswith("_norm.weight"):
        return GGMLType.F32
    if any(s in name for s in ("attn_v", "ffn_down", "output.weight")):
        return GGMLType.Q6_K
    return GGMLType.Q4_K


def random_q4_k(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q4_K superblocks (144 bytes each), weights centred
    with standard deviation about ``scale``."""
    sc = rng.integers(32, 64, (n_blocks, 8), dtype=np.uint8)
    m = np.clip(sc.astype(np.int16) + rng.integers(-4, 5, (n_blocks, 8)), 0, 63).astype(np.uint8)
    # uniform 4-bit codes: std 4.61; E[sc] = 47.5
    d = np.full(n_blocks, scale / (47.5 * 4.61), np.float32)
    out = np.empty((n_blocks, 144), np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:4] = (7.5 * d).astype("<f2")[:, None].view(np.uint8)
    out[:, 4:8] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 8:12] = (m[:, :4] & 63) | ((m[:, 4:] >> 4) << 6)
    out[:, 12:16] = (sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)
    out[:, 16:144] = rng.integers(0, 256, (n_blocks, 128), dtype=np.uint8)
    return out


def random_q6_k(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q6_K superblocks (210 bytes each)."""
    out = np.empty((n_blocks, 210), np.uint8)
    out[:, 0:192] = rng.integers(0, 256, (n_blocks, 192), dtype=np.uint8)
    sc = rng.integers(8, 32, (n_blocks, 16)) * rng.choice([-1, 1], (n_blocks, 16))
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    # 6-bit codes minus 32: std 18.5; E|sc| = 19.5
    d = np.full(n_blocks, scale / (19.5 * 18.5), np.float32)
    out[:, 208:210] = d.astype("<f2")[:, None].view(np.uint8)
    return out


def write_fixture_gguf(path, cfg: ModelConfig, seed: int = 0, scale: float = 0.05) -> str:
    """Write a Q4_K_M llama (dense or MoE) or qwen2 fixture with random blocks
    drawn from ``seed``."""
    if cfg.arch not in ("llama", "qwen2"):
        raise NotImplementedError("the port writes llama and qwen2 fixtures only")
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    for k, v in cfg.to_gguf_metadata().items():
        w.add(k, v)
    w.add("general.name", f"fixture-{cfg.arch}")

    def add(name: str, shape: tuple[int, ...]) -> None:
        t = qtype_for(name)
        if t == GGMLType.F32:
            # drawn now, in order, so the file depends only on the seed
            w.add_float(name, rng.standard_normal(shape).astype(np.float32) * scale)
            return
        n_blocks = row_size(t, int(np.prod(shape))) // (144 if t == GGMLType.Q4_K else 210)
        draw = random_q4_k if t == GGMLType.Q4_K else random_q6_k
        child = np.random.default_rng(rng.integers(0, 2**63))
        w.add_tensor(name, shape, t, lambda: draw(child, n_blocks, scale))

    D, H, Hkv, hd, F, V = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.ffn_dim, cfg.vocab_size)
    add("token_embd.weight", (V, D))
    add("output_norm.weight", (D,))
    if not cfg.tie_embeddings:
        add("output.weight", (V, D))
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        add(p + "attn_norm.weight", (D,))
        add(p + "attn_q.weight", (H * hd, D))
        add(p + "attn_k.weight", (Hkv * hd, D))
        add(p + "attn_v.weight", (Hkv * hd, D))
        if cfg.arch == "qwen2":  # attention biases, F32
            for bn, bd in (("attn_q.bias", H * hd), ("attn_k.bias", Hkv * hd),
                           ("attn_v.bias", Hkv * hd)):
                w.add_float(p + bn, rng.standard_normal(bd).astype(np.float32) * scale)
        add(p + "attn_output.weight", (D, H * hd))
        add(p + "ffn_norm.weight", (D,))
        if cfg.is_moe:
            E = cfg.n_experts
            add(p + "ffn_gate_inp.weight", (E, D))
            add(p + "ffn_gate_exps.weight", (E, F, D))
            add(p + "ffn_up_exps.weight", (E, F, D))
            add(p + "ffn_down_exps.weight", (E, D, F))
            continue
        add(p + "ffn_gate.weight", (F, D))
        add(p + "ffn_up.weight", (F, D))
        add(p + "ffn_down.weight", (D, F))
    return str(w.write())
