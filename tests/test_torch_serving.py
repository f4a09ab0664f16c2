"""The port's continuous batcher (tpu_kquant_torch.serving) against the JAX
package's, on the CPU, on tests/test_serving.py's tiny fixture.

Both packages load the same GGUF. The JAX batcher runs its engine with
impl="xla"; the port runs its plain versions. Greedy token streams must be
identical in the reference's serving cases (single and concurrent requests,
more requests than slots, staggered admission, eos, chunked runs and the
chunk's eos early exit), and so must the batchers' counters. The port's
sampled streams use its own noise, so they are held to the port's own
properties: independent of the batch around them, and equal to
``generate``'s. The admission burst's cache rows equal the single-admission
path's, and the slot prefill reads only the live prefix, on bf16 and int8
KV.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant import serving as jserving
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch import serving as tserving
from tpu_kquant_torch.runtime import engine as t_engine
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

STATS = ("steps", "prefills", "tokens_out", "tokens_in", "dispatches", "batch_occupancy_sum")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "serve.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=256)
    write_fixture_gguf(path, cfg, seed=13, quant="q4_k_m", scale=0.08)
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
    return (jc, jp), (tc, tp)


def _engines(models, B, max_seq=64, kv_quantized=False):
    (jc, jp), (tc, tp) = models
    return (JEngine(jc, jp, max_batch=B, max_seq=max_seq, impl="xla",
                    kv_quantized=kv_quantized),
            InferenceEngine(tc, tp, max_batch=B, max_seq=max_seq, device="cpu",
                            kv_quantized=kv_quantized))


def _serve(mod, eng, specs, max_chunk=None, seed=0, pre_steps=0, late=()):
    """Serve ``specs`` (Request fields) with ``mod``'s batcher; ``late``
    specs are submitted after ``pre_steps`` ticks. Returns (outputs in
    submission order, stats)."""
    cb = mod.ContinuousBatcher(eng, seed=seed)
    for s in specs:
        cb.submit(mod.Request(**s))
    for _ in range(pre_steps):
        cb.step()
    for s in late:
        cb.submit(mod.Request(**s))
    done = sorted(cb.run(max_chunk=max_chunk), key=lambda r: r.rid)
    return [r.output for r in done], {k: cb.stats[k] for k in STATS}


def _both(models, B, specs, **kw):
    je, te = _engines(models, B)
    jo, js = _serve(jserving, je, specs, **kw)
    to, ts = _serve(tserving, te, specs, **kw)
    return (jo, js), (to, ts), te


def test_single_request_matches_jax_and_generate(models):
    spec = dict(prompt=[3, 100, 7], max_new_tokens=6)
    (jo, js), (to, ts), te = _both(models, 2, [spec])
    assert to == jo
    assert to[0] == te.generate([[3, 100, 7]], max_new_tokens=6)[0]
    assert ts == js


def test_concurrent_requests_match_jax(models):
    prompts = [[3, 100, 7], [9, 300], [17, 5, 11, 200, 42], [250]]
    (jo, js), (to, ts), te = _both(models, 4, [dict(prompt=p, max_new_tokens=5)
                                               for p in prompts])
    assert to == jo
    assert to == [te.generate([p], max_new_tokens=5)[0] for p in prompts]
    assert ts == js


def test_more_requests_than_slots_match_jax(models):
    prompts = [[3, 100, 7], [9, 300], [17, 5, 11], [250, 9], [77]]
    (jo, js), (to, ts), _ = _both(models, 2, [dict(prompt=p, max_new_tokens=4)
                                              for p in prompts])
    assert len(to) == 5 and to == jo
    assert ts == js


def test_staggered_admission_matches_jax(models):
    (jo, js), (to, ts), te = _both(models, 2, [dict(prompt=[3, 100, 7], max_new_tokens=8)],
                                   pre_steps=3, late=[dict(prompt=[9, 300], max_new_tokens=4)])
    assert to == jo
    assert to == [te.generate([[3, 100, 7]], max_new_tokens=8)[0],
                  te.generate([[9, 300]], max_new_tokens=4)[0]]
    assert ts == js


def test_eos_stops_early_matches_jax(models):
    _, te = _engines(models, 2)
    probe = te.generate([[3, 100, 7]], max_new_tokens=8)[0]
    (jo, js), (to, ts), _ = _both(models, 2, [dict(prompt=[3, 100, 7], max_new_tokens=8,
                                                   eos_id=probe[2])])
    assert to == jo == [probe[:3]]
    assert ts == js


def test_chunked_run_matches_per_tick_and_jax(models):
    """Chunks of 8 ticks and per-tick stepping give the same streams; the
    greedy requests' streams and the counters equal the JAX batcher's."""
    specs = [dict(prompt=[3, 100, 7], max_new_tokens=9),
             dict(prompt=[9, 300], max_new_tokens=4, temperature=0.9, top_k=20, seed=11),
             dict(prompt=[17, 5, 11], max_new_tokens=7, temperature=0.7, repeat_penalty=1.2,
                  seed=3),
             dict(prompt=[250, 9], max_new_tokens=6)]
    _, te = _engines(models, 2)
    chunked, cs = _serve(tserving, te, specs, max_chunk=8, seed=5)
    per_tick, _ = _serve(tserving, te, specs, max_chunk=1, seed=5)
    assert chunked == per_tick
    (jo, js), _, _ = _both(models, 2, specs, max_chunk=8, seed=5)
    assert [chunked[0], chunked[3]] == [jo[0], jo[3]]
    assert [len(o) for o in chunked] == [9, 4, 7, 6]
    assert cs == js


def test_chunk_eos_early_exit_matches_jax(models):
    """A chunk freezes a row at its eos and ends once no row is active: the
    stream stops at the eos's first occurrence, and the ticks run equal the
    JAX batcher's (one admission tick and a chunk cut at the eos)."""
    _, te = _engines(models, 2)
    base = te.generate([[3, 100, 7]], max_new_tokens=24)[0]
    eos = base[5]
    cut = base.index(eos)
    spec = dict(prompt=[3, 100, 7], max_new_tokens=24, eos_id=eos)
    (jo, js), (to, ts), _ = _both(models, 2, [spec], max_chunk=32)
    assert to == jo == [base[: cut + 1]]
    assert ts["steps"] <= cut + 3 and ts == js
    per_tick, _ = _serve(tserving, te, [spec], max_chunk=1)
    assert per_tick == to


def test_submit_rejects_oversized_prompt(models):
    _, te = _engines(models, 2, max_seq=32)
    cb = tserving.ContinuousBatcher(te)
    with pytest.raises(ValueError):
        cb.submit(tserving.Request(prompt=list(range(40)), max_new_tokens=4))
    assert not cb.has_work()
    cb.submit(tserving.Request(prompt=[3, 100, 7], max_new_tokens=4))
    done = cb.run()
    assert len(done) == 1 and len(done[0].output) == 4


def test_sampled_output_independent_of_batch_composition(models):
    """The same sampled request gives the same tokens alone and in a crowd,
    in another slot."""
    _, te = _engines(models, 4)
    mk = dict(prompt=[3, 100, 7], max_new_tokens=8, temperature=0.8, top_k=50, min_p=0.05,
              seed=1234)
    alone, _ = _serve(tserving, te, [mk])
    crowd, _ = _serve(tserving, te, [dict(prompt=[9, 300], max_new_tokens=8, temperature=1.2,
                                          seed=1), mk,
                                     dict(prompt=[250], max_new_tokens=3, temperature=0.5,
                                          seed=2)])
    assert alone[0] == crowd[1]
    assert len(set(map(tuple, crowd))) == 3


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_penalised_run_matches_generate(models, temperature):
    """A penalised request served alone equals generate with the same
    settings and seed: greedy (the reference's case, also held to the JAX
    batcher) and sampled, where both draw from the request's stream."""
    kw = dict(max_new_tokens=10, temperature=temperature, repeat_penalty=1e9 if
              temperature == 0 else 1.3, penalty_last_n=64, top_k=40)
    _, te = _engines(models, 2)
    want = te.generate([[3, 100, 7]], seed=77, **kw)[0]
    got, _ = _serve(tserving, te, [dict(prompt=[3, 100, 7], seed=77, **kw)])
    assert got[0] == want and len(want) == 10
    if temperature == 0:
        assert len(set(want)) == len(want)  # repeat penalty 1e9: no token twice
        (jo, _), _, _ = _both(models, 2, [dict(prompt=[3, 100, 7], **kw)])
        assert jo[0] == got[0]


def test_heterogeneous_sampler_params_one_batch(models):
    """Greedy and sampled rows share one sampler pass; the greedy row equals
    the JAX batcher's."""
    specs = [dict(prompt=[3, 100, 7], max_new_tokens=6),
             dict(prompt=[9, 300], max_new_tokens=6, temperature=1.0, top_p=0.9, min_p=0.1,
                  seed=5),
             dict(prompt=[17, 5], max_new_tokens=6, temperature=0.7, frequency_penalty=0.5,
                  penalty_last_n=32, seed=6)]
    (jo, _), (to, _), _ = _both(models, 3, specs)
    assert to[0] == jo[0]
    assert all(len(o) == 6 for o in to)


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_burst_cache_matches_single_admission(models, kv_quantized):
    """Four requests admitted as one burst (a [4, 16] prefill over a
    16-slot cache, copied into their rows) leave the same cache below each
    row's position as four single admissions, and the same first tokens."""
    _, te = _engines(models, 4, kv_quantized=kv_quantized)
    prompts = [[3, 100, 7], [9, 300, 1, 2, 3, 4, 5, 6, 7, 8, 9], [17], [250, 9, 44, 1]]
    burst = tserving.ContinuousBatcher(te)
    for p in prompts:
        burst.submit(tserving.Request(prompt=p, max_new_tokens=2))
    burst.step()
    single = tserving.ContinuousBatcher(te)
    for b, p in enumerate(prompts):
        req = tserving.Request(prompt=p, max_new_tokens=2)
        single.submit(req)
        single.queue.popleft()
        single.slots[b] = tserving.scheduler._Slot(req, len(p))
        single._admit(b, req)
    assert burst.stats["dispatches"] == 2  # one burst, one tick
    fields = ("k", "v", "k_scale", "v_scale") if kv_quantized else ("k", "v")
    for b, p in enumerate(prompts):
        for f in fields:
            got = getattr(burst.cache, f)[:, b, :, : len(p)].float()
            want = getattr(single.cache, f)[:, b, :, : len(p)].float()
            tol = 1.0 if f in ("k", "v") and kv_quantized else 0
            assert (got - want).abs().max().item() <= tol + 2e-2 * want.abs().max().item(), f
    torch.testing.assert_close(burst.state.pending, single.state.pending, rtol=1e-4,
                               atol=1e-4)
    single._tick(False)
    assert [r.output[0] for r in (s.req for s in burst.slots)] == \
        single.tick_logits.argmax(-1).tolist()


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_prefill_slot_reads_only_the_live_prefix(models, monkeypatch, kv_quantized):
    """prefill_slot bounds attention to the prompt's bucket (kv_attend_len
    = T) on the unified layout, on bf16 and int8 KV, and writes only its
    row: its logits and cache row match the JAX engine's prefill_slot, and
    the other row is untouched."""
    je, te = _engines(models, 2, max_seq=128, kv_quantized=kv_quantized)
    seen = []
    real = t_engine.llama_forward

    def spy(*a, **kw):
        seen.append(kw.get("kv_attend_len"))
        return real(*a, **kw)

    monkeypatch.setattr(t_engine, "llama_forward", spy)
    other, prompt = [5, 6, 7, 8, 9], [3, 100, 7, 256, 42, 9, 300, 5, 11, 12, 13, 14, 15, 16,
                                      17, 18, 19]  # 17 tokens: bucket 32
    tc = te.new_cache(2)
    _, tc = te.prefill_slot(other, tc, 0)
    before = [t.clone() for t in (tc.k, tc.v)]
    lt, tc = te.prefill_slot(prompt, tc, 1)
    assert seen == [16, 32]
    assert torch.equal(tc.k[:, 0], before[0][:, 0]) and torch.equal(tc.v[:, 0], before[1][:, 0])
    jc = je.new_cache(2)
    _, jc = je.prefill_slot(other, jc, 0)
    lj, jc = je.prefill_slot(prompt, jc, 1)
    want, got = np.asarray(lj, np.float32), lt.numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    n = len(prompt)
    for f in ("k", "v") + (("k_scale", "v_scale") if kv_quantized else ()):
        w = np.asarray(getattr(jc, f), np.float32)[:, 1, :, :n]
        g = getattr(tc, f)[:, 1, :, :n].float().numpy()
        atol = 1.0 if f in ("k", "v") and kv_quantized else 0.02 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0.02, atol=atol)


@pytest.mark.parametrize("quantized", [False, True])
def test_batch_row_helpers_match_jax(quantized):
    """slice_batch_row is a view of one batch row (a write through it lands
    in the cache) and set_batch_row copies a row cache in place; both give
    the JAX helpers' bytes, on bf16 and int8 KV."""
    from tpu_kquant.runtime.kv_cache import KVCache as JKV
    from tpu_kquant.runtime.kv_cache import set_batch_row as j_set
    from tpu_kquant.runtime.kv_cache import slice_batch_row as j_slice
    from tpu_kquant_torch.runtime.kv_cache import KVCache, set_batch_row, slice_batch_row

    r = np.random.default_rng(3)
    shape = (2, 3, 2, 16, 8)

    def arrays():
        if quantized:
            return (r.integers(-127, 128, shape).astype(np.int8),
                    r.integers(-127, 128, shape).astype(np.int8),
                    r.random(shape[:-1]).astype(np.float32),
                    r.random(shape[:-1]).astype(np.float32))
        bf = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())  # noqa: E731
        return (bf(r.standard_normal(shape).astype(np.float32)),
                bf(r.standard_normal(shape).astype(np.float32)), None, None)

    base, row_src = arrays(), arrays()
    tc = KVCache.from_numpy(*base, device="cpu")
    dt = jnp.int8 if quantized else jnp.bfloat16
    jc = JKV(*(jnp.asarray(a, dt) for a in base[:2]),
             *((jnp.asarray(a) for a in base[2:]) if quantized else (None, None)))
    fields = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")

    def same(t, j):
        return all(np.array_equal(getattr(t, f).float().numpy(),
                                  np.asarray(getattr(j, f), np.float32)) for f in fields)

    trow, jrow = slice_batch_row(tc, 1), j_slice(jc, 1)
    assert same(trow, jrow) and trow.k.data_ptr() == tc.k[:, 1].data_ptr()
    src = KVCache.from_numpy(*(None if a is None else a[:, :1] for a in row_src),
                             device="cpu")
    jsrc = JKV(*(jnp.asarray(a[:, :1], dt) for a in row_src[:2]),
               *((jnp.asarray(a[:, :1]) for a in row_src[2:]) if quantized else (None, None)))
    tc = set_batch_row(tc, src, 2)
    jc = j_set(jc, jsrc, 2)
    assert same(tc, jc)
    trow.k.fill_(0)  # the view writes through
    assert (tc.k[:, 1] == 0).all()
