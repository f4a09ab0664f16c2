"""The iSWA KV layout (runtime.kv_cache.ISWACache: window layers on a ring
of window + chunk slots) in the port on the CPU, against its unified layout
and the JAX package's ISWACache and engine.

tests/test_iswa.py's seven cases ported (the ring is smaller than max_seq;
prefill and decode match the unified layout; generate matches it, on bf16
and int8 KV; the decode loop; the guards; gemma2's alternating layers),
each also against the JAX engine on the same fixture; then the ring
itself: ISWACache.append against the reference's on the same rows
(bytes equal, bf16 and int8, a chunk that wraps with pads), a wrapped
prefill's ring contents against the reference engine's, and the plain
attention's ring mask against the reference's attention_decode.

Inputs are made by numpy from a seed and handed to both packages. The
tolerance of each comparison is stated where it is made.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config as j_tiny_config
from tpu_kquant.models.fixtures import write_fixture_gguf as j_write_fixture
from tpu_kquant.ops.attention import attention_decode as j_attention_decode
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime.kv_cache import ISWACache as JISWACache
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.kv_cache import ISWACache
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

TINY = dict(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=512)


@pytest.fixture(scope="module")
def swa_model(tmp_path_factory):
    """tests/test_iswa.py's fixture (window 16 on every layer, seed 11),
    written by the JAX writer, loaded by both packages."""
    path = tmp_path_factory.mktemp("m") / "swa.gguf"
    j_write_fixture(path, j_tiny_config(**TINY, max_seq_len=256, sliding_window=16), seed=11,
                    scale=0.08)
    return load_model(str(path), device="cpu"), jload(str(path), scale_dtype="bf16")


def _engines(swa_model, **kw):
    (cfg, params, _), _ = swa_model
    uni = InferenceEngine(cfg, params, max_batch=2, max_seq=128, device="cpu", **kw)
    isw = InferenceEngine(cfg, params, max_batch=2, max_seq=128, device="cpu",
                          kv_layout="iswa", iswa_chunk=16, **kw)
    return uni, isw


def _j_iswa(swa_model, **kw):
    _, (cfg, params, _) = swa_model
    return JEngine(cfg, params, max_batch=2, max_seq=128, impl="xla", kv_layout="iswa",
                   iswa_chunk=16, **kw)


def test_ring_smaller_than_max_seq(swa_model):
    """Window 16 + chunk 16: a ring of 32 slots of the 128, no full cache
    (every layer slides), as in the reference."""
    _, isw = _engines(swa_model)
    cache = isw.new_cache(1)
    assert cache.ring == 32 == _j_iswa(swa_model).new_cache(1).ring
    assert cache.full is None
    assert cache.swa.k.shape[3] == 32 < 128 and cache.max_seq == 32
    assert cache.layer_map == (("swa", 0), ("swa", 1))


def test_iswa_prefill_matches_unified(swa_model):
    """A 40-token prompt (3 chunks of 16: the ring wraps once) and a 23-token
    one in one ragged batch: the last logits on the ring within 2e-2 of the
    unified layout's (the reference test's tolerance) with the same argmax,
    and within 2e-2 of max|ref| of the JAX iSWA engine's; then 5 decode
    steps in lockstep (the same argmax every step)."""
    uni, isw = _engines(swa_model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, 40).tolist(), rng.integers(3, 500, 23).tolist()]
    lu, cu, lens_u = uni.prefill(prompts, uni.new_cache(2))
    li, ci, lens_i = isw.prefill(prompts, isw.new_cache(2))
    np.testing.assert_array_equal(lens_u, lens_i)
    np.testing.assert_allclose(lu.numpy(), li.numpy(), rtol=2e-2, atol=2e-2)
    assert (lu.argmax(-1) == li.argmax(-1)).all()
    je = _j_iswa(swa_model)
    jl, _, _ = je.prefill(prompts, je.new_cache(2))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(li.numpy(), jl, rtol=0, atol=2e-2 * np.abs(jl).max())
    tu, ti = lu.argmax(-1), li.argmax(-1)
    pu, pi = torch.tensor(lens_u), torch.tensor(lens_i)
    for _ in range(5):
        lu2, cu = uni.decode_step(tu, pu, cu)
        li2, ci = isw.decode_step(ti, pi, ci)
        assert (lu2.argmax(-1) == li2.argmax(-1)).all()
        tu, ti = lu2.argmax(-1), li2.argmax(-1)
        pu, pi = pu + 1, pi + 1


def test_iswa_generate_matches_unified(swa_model):
    """48 tokens (decode wraps the 32-slot ring) equal on both layouts, and
    equal to the JAX iSWA engine's."""
    uni, isw = _engines(swa_model)
    prompt = [3, 100, 7, 256, 42, 9, 300, 5]
    gi = isw.generate([prompt], max_new_tokens=48)
    assert uni.generate([prompt], max_new_tokens=48) == gi
    assert _j_iswa(swa_model).generate([prompt], max_new_tokens=48) == gi


def test_iswa_generate_int8(swa_model):
    """The same on int8 KV, 24 tokens (the ring quantizes each row with
    _quant_i8 as the unified cache does)."""
    uni, isw = _engines(swa_model, kv_quantized=True)
    prompt = [3, 100, 7, 256, 42]
    gi = isw.generate([prompt], max_new_tokens=24)
    assert uni.generate([prompt], max_new_tokens=24) == gi
    assert _j_iswa(swa_model, kv_quantized=True).generate([prompt], max_new_tokens=24) == gi


def test_iswa_decode_loop(swa_model):
    """tests/test_iswa.py:test_iswa_fused_decode_loop: the greedy decode
    loop (decode_greedy; the reference's fused lax.scan) over the ring: 40
    tokens of two rows equal to the unified layout's and the JAX iSWA
    engine's decode_greedy_jit."""
    uni, isw = _engines(swa_model)
    prompt = [3, 100, 7, 256]
    lu, cu, lens = uni.prefill([prompt, prompt], uni.new_cache(2))
    li, ci, _ = isw.prefill([prompt, prompt], isw.new_cache(2))
    pos = torch.tensor(lens)
    toks_u, _ = uni.decode_greedy(lu.argmax(-1), pos, cu, 40)
    toks_i, _ = isw.decode_greedy(li.argmax(-1), pos, ci, 40)
    assert torch.equal(toks_u, toks_i)
    je = _j_iswa(swa_model)
    jl, jc, _ = je.prefill([prompt, prompt], je.new_cache(2))
    jt, _ = je.decode_greedy_jit(jnp.argmax(jl, -1).astype(jnp.int32), jnp.asarray(lens), jc, 40)
    np.testing.assert_array_equal(toks_i.numpy(), np.asarray(jt))


def test_iswa_guards(swa_model, tmp_path):
    """The reference's guards: sessions, context shift and the slot prefill
    (serving) stay on the unified layout (NotImplementedError); iswa on a
    model without a window, or an unknown layout, raises ValueError."""
    (cfg, params, _), _ = swa_model
    _, isw = _engines(swa_model)
    cache = isw.new_cache(1)
    with pytest.raises(NotImplementedError):
        isw.save_session(str(tmp_path / "x.npz"), cache, [1])
    with pytest.raises(NotImplementedError):
        isw.shift_context(cache, np.array([60]), 4, 8)
    with pytest.raises(NotImplementedError, match="unified"):
        isw.prefill_slot([3, 100, 7], cache, 0)
    cfg2 = t_fixtures.tiny_config(**TINY)
    with pytest.raises(ValueError, match="sliding-window"):
        InferenceEngine(cfg2, params, kv_layout="iswa", device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        InferenceEngine(cfg, params, kv_layout="ring", device="cpu")


def test_iswa_alternating_layers(tmp_path):
    """gemma2's alternating window: layer 0 on a ring of 32, layer 1 on a
    full cache of 128; 24 tokens equal to the unified layout's and the JAX
    iSWA engine's."""
    path = tmp_path / "g2.gguf"
    j_write_fixture(path, j_tiny_config(arch="gemma2", **TINY, sliding_window=16), seed=13,
                    scale=0.08)
    cfg, params, _ = load_model(str(path), device="cpu")
    uni = InferenceEngine(cfg, params, max_batch=1, max_seq=128, device="cpu")
    isw = InferenceEngine(cfg, params, max_batch=1, max_seq=128, device="cpu",
                          kv_layout="iswa", iswa_chunk=16)
    cache = isw.new_cache(1)
    assert cache.full is not None and cache.swa is not None
    assert cache.full.k.shape[0] == 1 and cache.swa.k.shape[0] == 1
    assert cache.swa.k.shape[3] == 32 and cache.full.k.shape[3] == 128
    assert cache.is_ring(0) and not cache.is_ring(1)
    prompt = [3, 100, 7, 256, 42, 9]
    gi = isw.generate([prompt], max_new_tokens=24)
    assert uni.generate([prompt], max_new_tokens=24) == gi
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    assert JEngine(jc, jp, max_batch=1, max_seq=128, impl="xla", kv_layout="iswa",
                   iswa_chunk=16).generate([prompt], max_new_tokens=24) == gi


def test_last_chunk_ends_at_max_seq(tmp_path):
    """gemma2's alternating window on 40 slots, a 37-token prompt in chunks
    of 16: the last chunk (bucket 16 from position 32) ends at max_seq, as
    the unified prefill's bucket does; the reference's would run to 48 and
    write its full layer's rows clamped onto slots 24..39. The ring's last
    logits within 2e-2 of the unified layout's (same argmax) and 3 tokens
    equal; the reference's ring parts from its unified layout by more than
    a tenth of max|ref| (its fault, pinned), whose logits the port's
    unified layout holds within 2e-2 of max|ref|."""
    path = tmp_path / "g2.gguf"
    j_write_fixture(path, j_tiny_config(arch="gemma2", **TINY, sliding_window=16), seed=14,
                    scale=0.08)
    cfg, params, _ = load_model(str(path), device="cpu")
    uni = InferenceEngine(cfg, params, max_seq=40, device="cpu")
    isw = InferenceEngine(cfg, params, max_seq=40, device="cpu", kv_layout="iswa",
                          iswa_chunk=16)
    prompt = np.random.default_rng(37).integers(3, 500, 37).tolist()
    lu, _, _ = uni.prefill([prompt], uni.new_cache(1))
    li, ci, _ = isw.prefill([prompt], isw.new_cache(1))
    assert ci.full.k.shape[3] == 40 and ci.ring == 32
    np.testing.assert_allclose(li.numpy(), lu.numpy(), rtol=2e-2, atol=2e-2)
    assert int(li.argmax()) == int(lu.argmax())
    assert isw.generate([prompt], max_new_tokens=3) == uni.generate([prompt], max_new_tokens=3)
    # the reference's iSWA prefill runs its last bucket to position 47 and
    # its logits part from its own unified layout's
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    ju, ji = (JEngine(jc, jp, max_batch=1, max_seq=40, impl="xla", **kw)
              for kw in ({}, {"kv_layout": "iswa", "iswa_chunk": 16}))
    jlu = np.asarray(ju.prefill([prompt], ju.new_cache(1))[0], np.float32)
    jli = np.asarray(ji.prefill([prompt], ji.new_cache(1))[0], np.float32)
    assert np.abs(jli - jlu).max() > 0.1 * np.abs(jlu).max()
    np.testing.assert_allclose(lu.numpy(), jlu, rtol=0, atol=2e-2 * np.abs(jlu).max())


def test_generate_cli_runs_on_the_ring(swa_model, tmp_path):
    """tools/main.py --kv-layout iswa on the CPU: its greedy ids equal the
    iSWA engine's generate at the CLI's cache size (prompt + n + 16 slots,
    all of them the ring: fewer than window + 512)."""
    from tpu_kquant.models.fixtures import write_fixture_gguf
    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.tools import main as t_main

    path = str(tmp_path / "swa.gguf")
    write_fixture_gguf(path, j_tiny_config(**TINY, max_seq_len=256, sliding_window=16), seed=11,
                       scale=0.08)
    res = t_main.run(["-m", path, "-p", "hello world", "-n", "8", "--kv-layout", "iswa",
                      "--device", "cpu"])
    tok = from_gguf_metadata(GGUFReader(path).metadata)
    ids = tok.encode("hello world", add_bos=True)
    (cfg, params, _), _ = swa_model
    eng = InferenceEngine(cfg, params, max_seq=len(ids) + 8 + 16, device="cpu", kv_layout="iswa")
    assert eng.new_cache(1).ring == min(len(ids) + 24, 16 + 512)
    assert res["ids"] == eng.generate([ids], max_new_tokens=8, eos_id=tok.eos_id)[0]


# -- the ring ----------------------------------------------------------------------


def _ring_arrays(c) -> list[np.ndarray]:
    """Every array of an ISWACache of either package, as f32 numpy."""
    return [a.float().numpy() if torch.is_tensor(a) else np.array(a, np.float32)
            for part in (c.full, c.swa) if part is not None
            for a in (part.k, part.v, part.k_scale, part.v_scale) if a is not None]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_append_matches_the_reference_bytes(quantized):
    """ISWACache.append against the reference's on the same rows: a
    window layer and a full one (gemma2's pattern), a 12-token chunk at
    positions 26..37 of a ring of 16 (it wraps) whose second row has 5 pad
    tokens (kv_valid), then a decode step at 38 / 33; every array equal
    (bf16 bits, int8 codes and f32 scales)."""
    rng = np.random.default_rng(3 + quantized)
    B, Hkv, D, ring, S = 2, 2, 16, 16, 64
    t = ISWACache.create([8, 0], B, S, ring, Hkv, D, device="cpu", quantized=quantized)
    j = JISWACache.create([8, 0], B, S, ring, Hkv, D, quantized=quantized)
    prev = [rng.standard_normal((B, 16, Hkv, D)).astype(np.float32) for _ in range(2)]
    steps = [(prev, np.broadcast_to(np.arange(10, 26), (B, 16)), None)]
    kv = [rng.standard_normal((B, 12, Hkv, D)).astype(np.float32) for _ in range(2)]
    pos = np.broadcast_to(np.arange(26, 38), (B, 12))
    valid = pos < np.array([[38], [33]])
    steps.append((kv, pos, valid))
    one = [rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2)]
    steps.append((one, np.array([[38], [33]]), None))
    for (k, v), p, val in steps:
        kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
        for layer in (0, 1):
            t.append(layer, kb, vb, torch.from_numpy(np.ascontiguousarray(p)),
                     valid=None if val is None else torch.from_numpy(val))
            j = j.append(layer, jnp.asarray(kb.float().numpy(), jnp.bfloat16),
                         jnp.asarray(vb.float().numpy(), jnp.bfloat16),
                         jnp.asarray(p, jnp.int32), valid=None if val is None else
                         jnp.asarray(val))
    got, want = _ring_arrays(t), _ring_arrays(j)
    assert len(got) == len(want) == (8 if quantized else 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_wrapped_prefill_ring_matches_the_reference(swa_model):
    """After a 40-token prefill (3 chunks of 16 on a ring of 32: it wraps),
    the port's ring against the JAX iSWA engine's: each layer's K and V
    within 2e-2 of max|ref| (the two packages' projections round
    differently), and the slots of positions 8..39 hold those positions
    (the slots positions 0..7 held were written over)."""
    _, isw = _engines(swa_model)
    je = _j_iswa(swa_model)
    prompt = np.random.default_rng(5).integers(3, 500, 40).tolist()
    _, tc, _ = isw.prefill([prompt], isw.new_cache(1))
    _, jc, _ = je.prefill([prompt], je.new_cache(1))
    for a, b in zip(_ring_arrays(tc), _ring_arrays(jc)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * np.abs(b).max())
    # slot p % 32 holds position p for p in 8..39: the K rows of a shorter
    # prefill of the same prompt (positions 0..23 stay in place) equal them
    _, short, _ = isw.prefill([prompt[:24]], isw.new_cache(1))
    np.testing.assert_array_equal(tc.swa.k[:, :, :, 8:24].float().numpy(),
                                  short.swa.k[:, :, :, 8:24].float().numpy())


@pytest.mark.parametrize("fixed", [False, True], ids=["einsum", "card form"])
def test_ring_mask_matches_the_reference(fixed):
    """attention_plain with ring_last against the reference's
    attention_decode(ring_last): a ring of 24 slots whose rows last wrote
    positions 50 and 10 (the second has unwritten slots), a window of 12,
    T = 4 queries, bf16 KV; within 1e-5 of max|ref| (f32 order only)."""
    rng = np.random.default_rng(24)
    B, T, H, Hkv, S, D = 2, 4, 4, 2, 24, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    last = np.array([50, 10])
    qpos = last[:, None] - 3 + np.arange(T)[None, :]
    ref = np.asarray(j_attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(qpos, jnp.int32), sliding_window=12,
                                        impl="xla", ring_last=jnp.asarray(last, jnp.int32)))
    t = torch.from_numpy
    got = t_attention.attention_plain(t(q), t(k), t(v), t(qpos), fixed=fixed, sliding_window=12,
                                      ring_last=t(last))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    dispatched = t_attention.attention_decode(t(q), t(k), t(v), t(qpos), sliding_window=12,
                                              ring_last=t(last))
    assert torch.equal(dispatched, t_attention.attention_plain(
        t(q), t(k), t(v), t(qpos), sliding_window=12, ring_last=t(last)))
