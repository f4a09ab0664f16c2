"""Kernel #7, flash decode attention: the port's plain version
(``decode_attention_plain``, what ``csrc/decode_attn.cu`` computes) against
the JAX package's Pallas kernel in interpret mode, and the decode dispatch
past the logits budget against the JAX engine, on the CPU.

The Pallas cases are tests/test_pallas_attention.py's (positions in and
across tiles, a ragged batch, int8 KV, a mostly dead cache, a single tile)
plus head_dim 128; the tolerances are theirs (2e-2, int8 3e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops import attention as j_attention
from tpu_kquant.ops.pallas_attention import attention_decode_pallas
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops.decode_attention import attention_decode_flash, decode_attention_plain
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

# (B, S, H, Hkv, D, positions, int8 KV, the Pallas tile)
CASES = {
    "pos 5": (1, 256, 8, 2, 64, [5], False, 128),
    "pos 127": (1, 256, 8, 2, 64, [127], False, 128),
    "pos 200": (1, 256, 8, 2, 64, [200], False, 128),
    "ragged batch": (3, 256, 4, 4, 64, [3, 100, 255], False, 64),
    "int8": (2, 128, 8, 2, 64, [60, 127], True, 64),
    "mostly dead int8": (2, 1024, 8, 2, 64, [7, 130], True, 64),
    "single tile": (1, 64, 4, 1, 64, [63], False, 64),
    "head_dim 128, GQA 6": (2, 512, 12, 2, 128, [37, 450], False, 128),
    "head_dim 128 int8, GQA 4": (2, 512, 16, 4, 128, [300, 511], True, 256),
}


def _inputs(B, S, H, Hkv, D, pos, int8, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    if int8:
        k = r.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        v = r.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        scales = tuple((r.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32)
                       for _ in range(2))
    else:
        k = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
        v = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
        scales = None
    return q, k, v, np.asarray(pos, np.int32).reshape(B, 1), scales


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    B, S, H, Hkv, D, pos, int8, ts = CASES[case]
    q, k, v, qp, sc = _inputs(B, S, H, Hkv, D, pos, int8, seed=sum(pos))
    want = np.asarray(attention_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        None if sc is None else tuple(jnp.asarray(s) for s in sc), ts=ts, interpret=True))
    t = torch.from_numpy
    got = decode_attention_plain(t(q), t(k), t(v), t(qp),
                                 None if sc is None else tuple(t(s) for s in sc))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    tol = 3e-2 if int8 else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_wrapper_runs_plain_on_cpu_and_counts_it():
    q, k, v, qp, _ = _inputs(2, 128, 8, 2, 64, [10, 100], False, seed=1)
    t = torch.from_numpy
    c = _build.COUNTERS["decode_attn"]
    before = (c.plain_calls, c.launches)
    got = attention_decode_flash(t(q).to(torch.bfloat16), t(k).to(torch.bfloat16),
                                 t(v).to(torch.bfloat16), t(qp))
    assert (c.plain_calls, c.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    want = decode_attention_plain(t(q), t(k), t(v), t(qp))
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


def test_plain_ignores_dead_slots():
    """Slots past a row's position (finite garbage, as dummy decodes leave
    it) change nothing."""
    q, k, v, qp, _ = _inputs(2, 256, 8, 2, 64, [70, 3], False, seed=2)
    t = torch.from_numpy
    ref = decode_attention_plain(t(q), t(k), t(v), t(qp))
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 71:] = 1e4
    v2[1, :, 4:] = -3e4
    got = decode_attention_plain(t(q), t(k2), t(v2), t(qp))
    assert torch.equal(got, ref)


# -- dispatch past the budget: a decode step of a tiny fixture -------------------


@pytest.fixture(scope="module")
def head64(tmp_path_factory):
    """A tiny llama with head_dim 64 (dim 256, 4 + 2 heads), which the
    decode kernel's gate takes (D % 64)."""
    path = tmp_path_factory.mktemp("d") / "hd64.gguf"
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=256,
                      vocab_size=512, max_seq_len=256)
    write_fixture_gguf(path, cfg, seed=5, quant="q4_k_m", scale=0.05)
    return jload(str(path), scale_dtype="bf16"), load_model(str(path), scale_dtype="bf16",
                                                            device="cpu")


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_decode_past_budget_takes_the_kernel_and_matches_jax(head64, monkeypatch,
                                                             kv_quantized):
    """With the budget lowered in both packages, a decode step's logits (B
    = 2, 256 slots) pass it: the forward appends eagerly (no deferred
    append) and every layer's attention is the decode kernel's plain
    version; logits within 5e-2 of max|ref| of the JAX engine's (impl
    "xla"), greedy tokens equal, over three steps."""
    (jc, jp, _), (tc, tp, _) = head64
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 1e-3)
    monkeypatch.setattr(j_attention, "_ATTN_XLA_MAX_MB", 1e-3)
    je = JEngine(jc, jp, max_batch=2, max_seq=256, impl="xla", kv_quantized=kv_quantized)
    te = InferenceEngine(tc, tp, max_batch=2, max_seq=256, device="cpu",
                         kv_quantized=kv_quantized)
    prompts = [[3, 100, 7, 256, 42], [9, 300, 5, 11, 12, 13, 14, 15, 16, 17]]
    lj, jcache, lens = je.prefill(prompts, je.new_cache(2))
    lt, tcache, _ = te.prefill(prompts, te.new_cache(2))
    appended = []
    real = type(tcache).append_all
    monkeypatch.setattr(type(tcache), "append_all",
                        lambda self, *a: appended.append(1) or real(self, *a))
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)
    assert tok_t.tolist() == np.asarray(tok_j).tolist()
    pos = np.asarray(lens)
    for step in range(3):
        c = _build.COUNTERS["decode_attn"]
        before = c.plain_calls
        lj, jcache = je.decode_step(tok_j, jnp.asarray(pos, jnp.int32), jcache)
        lt, tcache = te.decode_step(tok_t, torch.from_numpy(pos), tcache)
        assert c.plain_calls - before == tc.n_layers
        want, got = np.asarray(lj, np.float32), lt.numpy()
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = torch.argmax(lt, -1)
        assert tok_t.tolist() == np.asarray(tok_j).tolist(), step
        pos = pos + 1
    assert not appended


def test_decode_below_budget_defers_and_stays_plain(head64):
    """The default budget at B = 2 x 256 slots: the deferred append and the
    plain branch (the kernel is not reached)."""
    _, (tc, tp, _) = head64
    te = InferenceEngine(tc, tp, max_batch=2, max_seq=256, device="cpu")
    logits, cache, lens = te.prefill([[3, 100, 7], [9, 300]], te.new_cache(2))
    c = _build.COUNTERS["decode_attn"]
    before = c.plain_calls
    te.decode_step(torch.argmax(logits, -1), torch.from_numpy(lens), cache)
    assert c.plain_calls == before
