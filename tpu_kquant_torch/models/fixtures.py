"""Fixture models: GGUF files of a real architecture with random weights.

``write_fixture_gguf`` writes the llama tensor inventory with a type recipe
of the quantize tool (``tools/quantize.py``: ``RECIPES`` / ``target_type``,
the reference's): q4_k_m by default (attn_v, ffn_down and
output in Q6_K, the other matmul weights Q4_K, norms F32), or q8_0, q6_k,
q5_k_m, q4_k_s, q3_k_m, q2_k, f16 and bf16; qwen2 adds F32 q/k/v biases,
gemma2 the F32 ``post_attention_norm`` and ``post_ffw_norm``, phi3 its
pre-fused ``attn_qkv`` [(H + 2 Hkv) hd, D] (rows q, k, v: HF's
``qkv_proj``) and ``ffn_up`` [2F, D] (gate rows, then up: HF's
``gate_up_proj``) with no ``attn_q/k/v`` and no ``ffn_gate``, as the
reference writes them, and a tied config (qwen2's, the gemma family's)
writes no ``output.weight``. The substring ``"output.weight"``
also matches ``attn_output.weight``, in both packages. A MoE config
(``n_experts``) writes the router ``ffn_gate_inp`` [E, D] and the stacked
experts ``ffn_{gate,up}_exps`` [E, F, D] and ``ffn_down_exps`` [E, D, F] in
place of the FFN weights, under the same recipe, as the reference writes
them. Unlike the reference it does not quantize float weights, though the
port has a fast quantizer (``ops/quantize.py``'s kernels on the card,
``tools/quantize.py:requantize`` from an F16 fixture): it DRAWS valid blocks
directly, so that every file written before the quantizer existed keeps its
weights, each type's ``d`` set so that weights have standard deviation
about ``scale`` (0.05 by default) and every sub-block is centred:

- Q4_K: 4-bit codes, 6-bit sub-scales ``sc`` in [32, 63], mins ``m`` within
  4 of ``sc``, ``dmin = 7.5 d`` (codes average 7.5).
- Q5_K: the same with 5-bit codes and ``dmin = 15.5 d``.
- Q6_K: 6-bit codes (value q - 32), int8 sub-scales in [8, 31] of random sign.
- Q3_K: 3-bit codes (value q - 4), 6-bit signed sub-scales in [8, 31] of
  random sign.
- Q2_K: 2-bit codes, 4-bit sub-scales in [8, 15], mins within 1 of them,
  ``dmin = 1.5 d``.
- Q8_0: int8 codes in [-127, 127].

Everything downstream reads real block bytes; only the values are not the
quantization of any float tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_kquant_torch.gguf import GGMLType, GGUFWriter, row_size
from tpu_kquant_torch.gguf.constants import type_size
from tpu_kquant_torch.models.config import ModelConfig, RopeParams
from tpu_kquant_torch.quant.repack import _bf16_bits
from tpu_kquant_torch.tools.quantize import RECIPES, target_type  # noqa: F401


def tiny_config(arch: str = "llama", n_layers: int = 2, dim: int = 64,
                n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
                vocab_size: int = 512, max_seq_len: int = 256, n_experts: int = 0,
                n_experts_used: int = 0, sliding_window: int = 0) -> ModelConfig:
    if arch not in ("llama", "qwen2", "gemma", "gemma2", "phi3"):
        raise NotImplementedError(f"arch {arch!r} is not ported yet")
    hd = dim // n_heads
    return ModelConfig(
        arch=arch, n_layers=n_layers, dim=dim, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=hd, ffn_dim=ffn_dim,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        rope=RopeParams(head_dim=hd, n_rot=hd, mode="norm" if arch == "llama" else "neox"),
        n_experts=n_experts, n_experts_used=n_experts_used, attn_bias=arch == "qwen2",
        sliding_window=sliding_window, **_gemma_quirks(arch, dim),
    )


def _gemma_quirks(arch: str, dim: int, attn_softcap: float = 50.0,
                  final_softcap: float = 30.0) -> dict:
    """The fields ModelConfig.from_gguf sets for the gemma family: GELU,
    embeddings scaled by sqrt(dim), a tied lm head; gemma2 adds the post
    norms, every other layer windowed and the two logit softcaps."""
    q: dict = {}
    if arch in ("gemma", "gemma2"):
        q.update(act_fn="gelu", embed_scale=float(dim) ** 0.5, tie_embeddings=True)
    if arch == "gemma2":
        q.update(post_norms=True, swa_pattern=2, attn_logit_softcap=attn_softcap,
                 final_logit_softcap=final_softcap)
    return q


def tiny_mamba_config(n_layers: int = 2, dim: int = 64, vocab_size: int = 512,
                      max_seq_len: int = 256, d_state: int = 16, d_conv: int = 4,
                      expand: int = 2) -> ModelConfig:
    """A tiny mamba (recurrent) config, the reference's: d_inner = expand *
    dim, dt_rank ceil(dim / 16) (HF's "auto")."""
    return ModelConfig(
        arch="mamba", n_layers=n_layers, dim=dim, n_heads=0, n_kv_heads=0, head_dim=0,
        ffn_dim=0, vocab_size=vocab_size, max_seq_len=max_seq_len,
        rope=RopeParams(head_dim=0, n_rot=0), ssm_d_conv=d_conv, ssm_d_inner=expand * dim,
        ssm_d_state=d_state, ssm_dt_rank=max(1, -(-dim // 16)),
    )


def mamba_2_8b_config() -> ModelConfig:
    """Mamba-2.8B (state-spaces/mamba-2.8b-hf's config.json): 64 layers,
    d_model 2560, d_inner 5120 (expand 2), d_state 16, d_conv 4, dt_rank
    160 ("auto": ceil(2560 / 16)), vocab 50280, rms eps 1e-5, lm head tied
    to the embedding, context 2048."""
    return dataclasses.replace(tiny_mamba_config(n_layers=64, dim=2560, vocab_size=50280,
                                                 max_seq_len=2048), tie_embeddings=True)


def tinyllama_1b_config() -> ModelConfig:
    """TinyLlama-1.1B-Chat-v1.0: 22 layers, dim 2048, 32/4 heads of 64,
    ffn 5632, vocab 32000."""
    return ModelConfig(
        arch="llama", n_layers=22, dim=2048, n_heads=32, n_kv_heads=4,
        head_dim=64, ffn_dim=5632, vocab_size=32000, max_seq_len=2048,
        rope=RopeParams(head_dim=64, n_rot=64),
    )


def llama3_8b_config() -> ModelConfig:
    """Meta-Llama-3-8B (its config.json): 32 layers, dim 4096, 32 / 8 heads
    of 128, ffn 14336, vocab 128256, rope theta 5e5, context 8192."""
    return ModelConfig(
        arch="llama", n_layers=32, dim=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, ffn_dim=14336, vocab_size=128256, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=500000.0),
    )


def llama3_70b_config() -> ModelConfig:
    """Meta-Llama-3-70B (its config.json): 80 layers, dim 8192, 64 / 8 heads
    of 128, ffn 28672, vocab 128256, rope theta 5e5, context 8192. About 40
    GB at Q4_K_M: a config only here, until the port shards a model."""
    return ModelConfig(
        arch="llama", n_layers=80, dim=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, ffn_dim=28672, vocab_size=128256, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=500000.0),
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


def gemma_2b_config() -> ModelConfig:
    """Gemma-2B (google/gemma-2b's config.json): 18 layers, dim 2048, 8 / 1
    heads of 256, ffn 16384, vocab 256000, rope theta 1e4, rms eps 1e-6,
    context 8192, GELU, lm head tied to the embedding."""
    return ModelConfig(
        arch="gemma", n_layers=18, dim=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        ffn_dim=16384, vocab_size=256000, max_seq_len=8192, norm_eps=1e-6,
        rope=RopeParams(head_dim=256, n_rot=256, mode="neox"), **_gemma_quirks("gemma", 2048),
    )


def gemma2_9b_config() -> ModelConfig:
    """Gemma-2-9B (google/gemma-2-9b's config.json): 42 layers, dim 3584, 16
    / 8 heads of 256 (head_dim is not dim / heads), ffn 14336, vocab 256000,
    rope theta 1e4, rms eps 1e-6, context 8192, a sliding window of 4096 on
    every other layer, attention and final logit softcaps 50 and 30, post
    norms, GELU, tied lm head. Its query_pre_attn_scalar is 256 = head_dim,
    so the logit scale head_dim^-0.5 is the published one."""
    return ModelConfig(
        arch="gemma2", n_layers=42, dim=3584, n_heads=16, n_kv_heads=8, head_dim=256,
        ffn_dim=14336, vocab_size=256000, max_seq_len=8192, norm_eps=1e-6,
        rope=RopeParams(head_dim=256, n_rot=256, mode="neox"), sliding_window=4096,
        **_gemma_quirks("gemma2", 3584),
    )


def phi3_mini_4k_config() -> ModelConfig:
    """Phi-3-mini-4k-instruct (microsoft/Phi-3-mini-4k-instruct's
    config.json): 32 layers, dim 3072, 32 / 32 heads of 96, ffn 8192, vocab
    32064, context 4096, rope theta 1e4 with no scaling, rms eps 1e-5, a
    sliding window of 2047 on every layer, untied lm head; q/k/v and
    gate/up stored pre-fused (attn_qkv, ffn_up)."""
    return ModelConfig(
        arch="phi3", n_layers=32, dim=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        ffn_dim=8192, vocab_size=32064, max_seq_len=4096, norm_eps=1e-5,
        rope=RopeParams(head_dim=96, n_rot=96, mode="neox"), sliding_window=2047,
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


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    """(n,) floats -> (n, 2) little-endian fp16 bytes."""
    return np.asarray(x, np.float32).astype("<f2")[:, None].view(np.uint8)


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


def random_q5_k(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q5_K superblocks (176 bytes each)."""
    out = random_q4_k(rng, n_blocks, scale)
    # uniform 5-bit codes: std 9.23; centred on 15.5 by dmin = 15.5 d
    d = np.full(n_blocks, scale / (47.5 * 9.23), np.float32)
    blocks = np.empty((n_blocks, 176), np.uint8)
    blocks[:, 0:2] = _f16_bytes(d)
    blocks[:, 2:4] = _f16_bytes(15.5 * d)
    blocks[:, 4:16] = out[:, 4:16]
    blocks[:, 16:176] = rng.integers(0, 256, (n_blocks, 160), dtype=np.uint8)
    return blocks


def random_q3_k(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q3_K superblocks (110 bytes each)."""
    out = np.empty((n_blocks, 110), np.uint8)
    out[:, 0:96] = rng.integers(0, 256, (n_blocks, 96), dtype=np.uint8)  # hmask, qs
    sc = rng.integers(8, 32, (n_blocks, 16)) * rng.choice([-1, 1], (n_blocks, 16))
    b = (sc + 32).astype(np.uint8)  # 6-bit biased
    out[:, 96:100] = (b[:, 0:4] & 0xF) | ((b[:, 8:12] & 0xF) << 4)
    out[:, 100:104] = (b[:, 4:8] & 0xF) | ((b[:, 12:16] & 0xF) << 4)
    out[:, 104:108] = ((b[:, 0:4] >> 4) | ((b[:, 4:8] >> 4) << 2) | ((b[:, 8:12] >> 4) << 4)
                       | ((b[:, 12:16] >> 4) << 6))
    # codes q - 4 in [-4, 3]: rms 2.35; E|sc| = 19.5
    out[:, 108:110] = _f16_bytes(np.full(n_blocks, scale / (19.5 * 2.35), np.float32))
    return out


def random_q2_k(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q2_K superblocks (84 bytes each)."""
    sc = rng.integers(8, 16, (n_blocks, 16))
    m = np.clip(sc + rng.integers(-1, 2, (n_blocks, 16)), 0, 15)
    # uniform 2-bit codes: std 1.118, centred on 1.5 by dmin = 1.5 d; E[sc] = 11.5
    d = np.full(n_blocks, scale / (11.5 * 1.118), np.float32)
    out = np.empty((n_blocks, 84), np.uint8)
    out[:, 0:16] = (sc | (m << 4)).astype(np.uint8)
    out[:, 16:80] = rng.integers(0, 256, (n_blocks, 64), dtype=np.uint8)
    out[:, 80:82] = _f16_bytes(d)
    out[:, 82:84] = _f16_bytes(1.5 * d)
    return out


def random_q8_0(rng: np.random.Generator, n_blocks: int, scale: float) -> np.ndarray:
    """``n_blocks`` valid Q8_0 blocks (34 bytes each)."""
    out = np.empty((n_blocks, 34), np.uint8)
    # uniform codes in [-127, 127]: std 73.6
    out[:, 0:2] = _f16_bytes(np.full(n_blocks, scale / 73.6, np.float32))
    out[:, 2:34] = rng.integers(0, 255, (n_blocks, 32), dtype=np.uint8) - np.uint8(127)
    return out


DRAW = {GGMLType.Q2_K: random_q2_k, GGMLType.Q3_K: random_q3_k, GGMLType.Q4_K: random_q4_k,
        GGMLType.Q5_K: random_q5_k, GGMLType.Q6_K: random_q6_k, GGMLType.Q8_0: random_q8_0}


def fixture_vocab(vocab_size: int) -> dict:
    """The fixture's minimal SPM vocab as GGUF metadata (the reference
    writer's, key for key): the specials, the 256 byte tokens, a few merged
    pieces with descending scores, then filler tokens."""
    toks = ["<unk>", "<s>", "</s>"]
    toks += [f"<0x{b:02X}>" for b in range(256)]
    pieces = ["\u2581the", "\u2581a", "he", "ll", "o", "\u2581hello", "\u2581world", "th", "er",
              "\u2581t"]
    toks += pieces
    toks += [f"tok{i}" for i in range(vocab_size - len(toks))]
    scores = [0.0] * 3 + [0.0] * 256 + [-float(i) for i in range(len(pieces))]
    scores += [-1000.0] * (vocab_size - len(scores))
    ttypes = [2, 3, 3] + [6] * 256 + [1] * (vocab_size - 259)
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": toks[:vocab_size],
            "tokenizer.ggml.scores": np.array(scores[:vocab_size], np.float32),
            "tokenizer.ggml.token_type": np.array(ttypes[:vocab_size], np.int32),
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2}


def write_fixture_gguf(path, cfg: ModelConfig, seed: int = 0, scale: float = 0.05,
                       recipe: str = "q4_k_m", with_tokenizer: bool = True) -> str:
    """Write a llama (dense or MoE), qwen2, gemma, gemma2, phi3 or mamba
    fixture under the quantize tool's ``recipe`` with random blocks drawn
    from ``seed``; ``with_tokenizer`` adds ``fixture_vocab`` (the vocab
    draws nothing from the seed, so the weights are the same either way).
    The tensors, their shapes, types and order are the reference writer's:
    a mamba layer's ``ssm_in`` [2 di, D], ``ssm_x`` [dt_rank + 2 ds, di],
    ``ssm_dt`` [di, dt_rank] and ``ssm_out`` [D, di] under the recipe (a
    dt_rank no block divides: Q8_0 where it is a multiple of 32, else F16),
    then its conv taps [di, dc], conv bias, dt bias, A_log [di, ds] and D in
    F32, drawn like the norms."""
    if cfg.arch not in ("llama", "qwen2", "gemma", "gemma2", "phi3", "mamba"):
        raise NotImplementedError("the port writes llama, qwen2, gemma, phi3 and mamba "
                                  "fixtures only")
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}; one of {sorted(RECIPES)}")
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    for k, v in cfg.to_gguf_metadata().items():
        w.add(k, v)
    w.add("general.name", f"fixture-{cfg.arch}")
    if with_tokenizer:
        for k, v in fixture_vocab(cfg.vocab_size).items():
            w.add(k, v)

    def add(name: str, shape: tuple[int, ...]) -> None:
        t = target_type(name, shape, recipe)
        if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
            # drawn now, in order, so the file depends only on the seed
            x = rng.standard_normal(shape).astype(np.float32) * scale
            if t == GGMLType.F32:
                w.add_float(name, x)
            elif t == GGMLType.F16:
                w.add_tensor(name, shape, t, x.astype("<f2").reshape(-1).view(np.uint8))
            else:
                bits = _bf16_bits(x.reshape(-1)).astype("<u2")
                w.add_tensor(name, shape, t, bits.view(np.uint8))
            return
        n_blocks = row_size(t, int(np.prod(shape))) // type_size(t)
        child = np.random.default_rng(rng.integers(0, 2**63))
        w.add_tensor(name, shape, t, lambda: DRAW[t](child, n_blocks, scale))

    D, H, Hkv, hd, F, V = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.ffn_dim, cfg.vocab_size)
    add("token_embd.weight", (V, D))
    add("output_norm.weight", (D,))
    if not cfg.tie_embeddings:
        add("output.weight", (V, D))
    if cfg.is_recurrent:
        di, ds, dc, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_dt_rank
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            add(p + "attn_norm.weight", (D,))
            add(p + "ssm_in.weight", (2 * di, D))
            add(p + "ssm_x.weight", (dtr + 2 * ds, di))
            add(p + "ssm_dt.weight", (di, dtr))
            add(p + "ssm_out.weight", (D, di))
            for nm, shape in (("ssm_conv1d.weight", (di, dc)), ("ssm_conv1d.bias", (di,)),
                              ("ssm_dt.bias", (di,)), ("ssm_a", (di, ds)), ("ssm_d", (di,))):
                w.add_float(p + nm, rng.standard_normal(shape).astype(np.float32) * scale)
        return str(w.write())
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        add(p + "attn_norm.weight", (D,))
        if cfg.post_norms:  # gemma2
            add(p + "post_attention_norm.weight", (D,))
            add(p + "post_ffw_norm.weight", (D,))
        if cfg.arch == "phi3":  # pre-fused QKV, one tensor (HF qkv_proj order)
            add(p + "attn_qkv.weight", ((H + 2 * Hkv) * hd, D))
        else:
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
        if cfg.arch == "phi3":  # pre-fused gate+up (HF gate_up_proj order)
            add(p + "ffn_up.weight", (2 * F, D))
            add(p + "ffn_down.weight", (D, F))
            continue
        add(p + "ffn_gate.weight", (F, D))
        add(p + "ffn_up.weight", (F, D))
        add(p + "ffn_down.weight", (D, F))
    return str(w.write())


# mean code of each kind with mins: its min centres the weights on zero
_MID_CODE = {"q4": 7.5, "q5": 15.5, "q6": 31.5, "q3": 3.5, "q2": 1.5}


def random_packed(rng: np.random.Generator, kind: str, N: int, K: int, f32: bool = False,
                  scale: float = 0.02):
    """A random kmajor weight (N, K) drawn directly in the loader's packed
    layout of ``kind`` (q2, q3, q4, q5, q6, q6w or q8): uniform codes and
    positive per-group scales, the mins (kinds with mins) centring every
    group, weights of standard deviation about ``scale``. ``f32``: f32
    ``scales`` (and ``mins``) as ``scale_dtype='f32'`` loads them; else the
    bf16 pairs ``sm`` / ``sp``. Returns a QTensor of numpy arrays (``.to``
    moves it)."""
    from tpu_kquant_torch.quant.qtensor import QTensor
    from tpu_kquant_torch.quant.repack import GROUP_SIZE

    g = GROUP_SIZE[kind]
    u8 = lambda rows: rng.integers(0, 256, (rows, N), dtype=np.uint8)  # noqa: E731
    if kind == "q8":
        arrays, spread = {"qs": rng.integers(-127, 128, (K, N)).astype(np.int8)}, 73.6
    elif kind == "q6w":
        arrays, spread = {"qs": rng.integers(-32, 32, (K, N)).astype(np.int8)}, 18.5
    elif kind in ("q4", "q5", "q6"):
        arrays = {"qs": u8(K // 2)}
        if kind != "q4":
            arrays["qh"] = u8(K // 8 if kind == "q5" else K // 4)
        spread = {"q4": 4.61, "q5": 9.23, "q6": 18.5}[kind]
    elif kind in ("q2", "q3"):
        arrays = {"qs": u8(K // 4)}
        if kind == "q3":
            arrays["qh"] = u8(K // 8)
        spread = {"q2": 1.118, "q3": 2.29}[kind]
    else:
        raise ValueError(f"unknown kind {kind!r}")
    s = ((rng.random((K // g, N)) + 0.5) * (scale / spread)).astype(np.float32)
    if kind in _MID_CODE:
        m = (s * _MID_CODE[kind]).astype(np.float32)
        if f32:
            arrays.update(scales=s, mins=m)
        else:
            arrays["sm"] = (_bf16_bits(s) | (_bf16_bits(m) << 16)).view(np.float32)
    elif f32:
        arrays["scales"] = s
    else:
        sb = _bf16_bits(s)
        arrays["sp"] = (sb[0::2] | (sb[1::2] << 16)).view(np.float32)
    return QTensor(kind, "kmajor", (N, K), arrays)
