"""The port's slice end to end on the CPU against the JAX engine.

Both packages load the same GGUF (written by the JAX package's fixture
writer). The JAX engine runs with impl="xla"; the port runs its plain
versions, following the same rows <= 32 dispatch to attn_in / oproj_ffn
where the fused gates pass (the dim-1024 fixture), and qmatmul elsewhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.models import llama as t_llama
from tpu_kquant_torch.models.mamba import RecurrentCache
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.attention import attention_decode
from tpu_kquant_torch.runtime import engine as t_engine
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.kv_cache import KVCache
from tpu_kquant_torch.runtime.loader import load_model
from tpu_kquant_torch.serving import ContinuousBatcher

torch.set_num_threads(1)

FIXTURES = {
    # tests/test_model_parity.py's seed-7 tiny model
    "tiny": (dict(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=160,
                  vocab_size=512, max_seq_len=128), 7, 0.08),
    # smallest width that passes the fused gates: runs attn_in / oproj_ffn
    "w1024": (dict(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                   vocab_size=512, max_seq_len=128), 3, 0.05),
}
TOKENS = [3, 100, 7, 256, 42, 9, 300, 5]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for name, (kw, seed, scale) in FIXTURES.items():
        path = tmp_path_factory.mktemp(name) / f"{name}.gguf"
        write_fixture_gguf(path, tiny_config(**kw), seed=seed, quant="q4_k_m", scale=scale)
        jc, jp, _ = jload(str(path), scale_dtype="bf16")
        tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
        out[name] = (JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla"),
                     InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu"))
    return out


def _plain_calls():
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_prefill_logits_match_jax(models, name):
    je, te = models[name]
    lj, _, _ = je.prefill([TOKENS], je.new_cache(1))
    before = _plain_calls()
    lt, _, _ = te.prefill([TOKENS], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    after = _plain_calls()
    # prefill is 8 rows: the fused gates decide, as in the reference
    fused = name == "w1024"
    assert (after["attn_in"] - before["attn_in"] == 2) == fused
    assert (after["oproj_ffn"] - before["oproj_ffn"] == 2) == fused


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_generate_matches_jax(models, name):
    je, te = models[name]
    before = _plain_calls()
    got = te.generate([TOKENS[:3]], max_new_tokens=8)
    assert got == je.generate([TOKENS[:3]], max_new_tokens=8)
    assert len(got[0]) == 8
    if name == "w1024":  # 1 prefill + 7 decode steps through the fused plain versions
        after = _plain_calls()
        assert after["attn_in"] - before["attn_in"] == 8 * 2
        assert after["oproj_ffn"] - before["oproj_ffn"] == 8 * 2


def test_decode_matches_prefill(models):
    _, te = models["w1024"]
    full, _, _ = te.prefill([TOKENS[:6]], te.new_cache(1))
    logits, cache, lens = te.prefill([TOKENS[:3]], te.new_cache(1))
    pos = torch.tensor(lens)
    for t in TOKENS[3:6]:
        logits, cache = te.decode_step(torch.tensor([t]), pos, cache)
        pos = pos + 1
    a, b = full[0].numpy(), logits[0].numpy()
    np.testing.assert_allclose(b, a, rtol=0.05, atol=0.05 * np.abs(a).max())
    assert np.argmax(a) == np.argmax(b)


def test_batched_ragged_prefill_matches_single(models):
    _, te = models["tiny"]
    rows = [[3, 100, 7, 256, 42], [9, 300]]
    logits, _, _ = te.prefill(rows, te.new_cache(2))
    for i, row in enumerate(rows):
        l1, _, _ = te.prefill([row], te.new_cache(1))
        torch.testing.assert_close(logits[i], l1[0], rtol=1e-3, atol=1e-3)


def test_decode_greedy_matches_stepwise(models):
    _, te = models["tiny"]
    want = te.generate([TOKENS[:4]], max_new_tokens=6)[0]
    logits, cache, lens = te.prefill([TOKENS[:4]], te.new_cache(1))
    first = torch.argmax(logits, -1)
    toks, _ = te.decode_greedy(first, torch.tensor(lens), cache, 5)
    assert [int(first[0])] + toks[0].tolist() == want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_kv_attend_len_matches_full_cache(models, name):
    """Bounding prefill attention to the first T slots of an S > T cache
    gives the same logits and cache as attending all S slots."""
    _, te = models[name]
    cfg, params = te.cfg, te.params
    T = 16
    toks = torch.tensor([TOKENS + TOKENS[:T - len(TOKENS)]])
    pos = torch.arange(T)[None]
    caches = [te.new_cache(1) for _ in range(2)]
    assert caches[0].max_seq > T
    caches[0].k.normal_()  # stale slots beyond T must not matter either way
    caches[1].k.copy_(caches[0].k)
    with torch.no_grad():
        l_full, c_full = t_llama.llama_forward(params, cfg, toks, pos, caches[0])
        l_cut, c_cut = t_llama.llama_forward(params, cfg, toks, pos, caches[1], kv_attend_len=T)
    torch.testing.assert_close(l_cut, l_full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c_cut.k, c_full.k, rtol=0, atol=0)
    torch.testing.assert_close(c_cut.v, c_full.v, rtol=0, atol=0)


def test_only_prefill_sets_kv_attend_len(models, monkeypatch):
    _, te = models["tiny"]
    seen = []
    real = t_engine.llama_forward

    def spy(*a, **kw):
        seen.append((a[2].shape[1], kw.get("kv_attend_len")))
        return real(*a, **kw)

    monkeypatch.setattr(t_engine, "llama_forward", spy)
    te.generate([TOKENS[:5]], max_new_tokens=4)
    logits, cache, lens = te.prefill([TOKENS], te.new_cache(1))
    te.decode_step(torch.tensor([1]), torch.tensor(lens), cache)
    prefills = [s for s in seen if s[0] > 1]
    decodes = [s for s in seen if s[0] == 1]
    assert prefills == [(16, 16), (16, 16)]
    assert decodes and all(b is None for _, b in decodes)


def test_deferred_append_attention_equals_post_append():
    rng = np.random.default_rng(0)
    B, H, Hkv, S, D = 2, 4, 2, 12, 8
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, 1, Hkv, D)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, 1, Hkv, D)).astype(np.float32))
    pos = torch.tensor([[3], [7]])
    got = attention_decode(q, k, v, pos, kv_cur=(kc, vc))
    k2, v2 = k.clone(), v.clone()
    for b in range(B):
        k2[b, :, pos[b, 0]] = kc[b, 0]
        v2[b, :, pos[b, 0]] = vc[b, 0]
    torch.testing.assert_close(got, attention_decode(q, k2, v2, pos), rtol=1e-5, atol=1e-6)


def test_attention_matches_jax():
    from tpu_kquant.ops.attention import attention_decode as jattn

    rng = np.random.default_rng(1)
    B, T, H, Hkv, S, D = 2, 5, 4, 2, 16, 8
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    pos = np.stack([np.arange(T), np.arange(T) + 4])
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            impl="xla"))
    got = attention_decode(*(torch.from_numpy(a) for a in (q, k, v, pos))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kv_cache_appends_in_place():
    c = KVCache.create(3, 2, 8, 2, 4, device="cpu")
    k = torch.randn(2, 2, 2, 4).to(torch.bfloat16)
    pos = torch.tensor([[0, 1], [4, 5]])
    assert c.append(1, k, -k, pos) is c
    torch.testing.assert_close(c.k[1, 0, :, 0:2], k[0].transpose(0, 1))
    torch.testing.assert_close(c.v[1, 1, :, 4:6], -k[1].transpose(0, 1))
    ks = torch.randn(3, 2, 1, 2, 4).to(torch.bfloat16)
    assert c.append_all(ks, ks, torch.tensor([[2], [6]])) is c
    for layer in range(3):
        torch.testing.assert_close(c.k[layer, 0, :, 2], ks[layer, 0, 0])
        torch.testing.assert_close(c.k[layer, 1, :, 6], ks[layer, 1, 0])
    assert c.k[0, 0, :, 3].abs().sum() == 0


def test_rope_matches_jax():
    from tpu_kquant.ops import rope as jrope
    from tpu_kquant_torch.models.config import RopeParams
    from tpu_kquant_torch.ops import rope as trope

    pos = np.arange(0, 40, 3)[None]
    x = np.random.default_rng(2).standard_normal((1, pos.shape[1], 4, 64)).astype(np.float32)
    yarn = dict(freq_scale=0.25, ext_factor=1.0, n_ctx_orig=4096)
    for mode, kw in (("neox", {}), ("norm", {}), ("neox", yarn)):
        jp = jrope.RopeParams(head_dim=64, n_rot=64, mode=mode, **kw)
        tp = RopeParams(head_dim=64, n_rot=64, mode=mode, **kw)
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jp)
        tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), tp)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
        want = jrope.apply_rope(jnp.asarray(x), jc[:, :, None], js[:, :, None], mode)
        got = trope.apply_rope(torch.from_numpy(x), tc[:, :, None], ts[:, :, None], mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_entry_points_refuse_what_this_slice_lacks(models, tmp_path):
    _, te = models["tiny"]
    # the iSWA layout is ported; the reference's guard on an arch without a
    # sliding window stays
    with pytest.raises(ValueError, match="sliding-window"):
        InferenceEngine(te.cfg, te.params, kv_layout="iswa", device="cpu")
    # context shift is ported, and recurrent (mamba) sessions: such a file
    # loads as a RecurrentCache; a recurrent engine refuses int8 KV, as the
    # reference's does
    assert len(te.generate([TOKENS], max_new_tokens=2, context_shift=True)[0]) == 2
    conv, ssm = np.ones((2, 1, 3, 8), np.float32), np.full((2, 1, 8, 4), 2.0, np.float32)
    np.savez(tmp_path / "mamba.npz", lengths=np.full(1, 5, np.int32), conv=conv, ssm=ssm,
             recurrent=np.int32(1))
    cache, lens = te.load_session(str(tmp_path / "mamba.npz"))
    assert isinstance(cache, RecurrentCache) and list(lens) == [5]
    assert np.array_equal(cache.conv.numpy(), conv) and np.array_equal(cache.ssm.numpy(), ssm)
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(te, mesh=object())
    with pytest.raises(ValueError, match="recurrent"):
        InferenceEngine(dataclasses.replace(te.cfg, arch="mamba"), te.params,
                        kv_quantized=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(te.cfg, te.params)
