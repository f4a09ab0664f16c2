"""The port's captured decode step and serving tick (runtime.graphs) on the
CPU, against the JAX package's one-dispatch loops.

On the CPU a captured step runs its body eagerly (``plain=False``), which is
what a CUDA graph of it replays on the card. Held to JAX, tokens equal:
- the greedy loop (``decode_greedy(plain=False)``) to
  ``InferenceEngine.decode_greedy_jit`` (bf16 and int8 KV) and on a tiny
  mamba; the sampled loop with temperature, top-k, top-p and penalties to
  ``decode_sampled_jit``, the port fed JAX's own Gumbel noise, step by step,
  through ``ops.sampling.gumbel``; the penalty state after it bit for bit;
- the replayed chunk (``ContinuousBatcher(plain=False)``) to the JAX
  batcher's ``_tick_n_fn``: streams and tick counts equal, one host read a
  chunk and none between its ticks, on a workload where every row meets
  its eos inside a chunk and on one where none does.
Held to the port's plain loops, bit for bit: the tokens and the last step's
logits (the same ops in the same order on the CPU). The launch accounting
(a capture's wrapper calls taken back, its deltas added once a replay) runs
``StepGraph``'s CUDA path against stand-ins of torch.cuda's graph calls. The
models are tests/test_speculative.py's (2 layers, dim 64, vocab 512, seed
7) and tests/test_torch_mamba.py's (dim 64, scale 0.3); the JAX engines run
impl="xla".
"""

import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant import serving as jserving
from tpu_kquant.models.fixtures import tiny_config, tiny_mamba_config, write_fixture_gguf
from tpu_kquant.ops import sampling as j_sampling
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch import serving as tserving
from tpu_kquant_torch.ops import _build, attention
from tpu_kquant_torch.ops import sampling as t_sampling
from tpu_kquant_torch.runtime import engine as t_engine
from tpu_kquant_torch.runtime import graphs
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

PROMPTS = [[3, 100, 7, 256, 42], [8, 9, 10]]
SC = t_sampling.SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1,
                              penalty_last_n=16)
STATS = ("steps", "prefills", "tokens_out", "tokens_in", "dispatches", "batch_occupancy_sum")


def _pair(path, max_batch=2, max_seq=64, kv_quantized=False):
    jc, jp, _ = jload(path, scale_dtype="bf16")
    tc, tp, _ = load_model(path, scale_dtype="bf16", device="cpu")
    return (JEngine(jc, jp, max_batch=max_batch, max_seq=max_seq, impl="xla",
                    kv_quantized=kv_quantized),
            InferenceEngine(tc, tp, max_batch=max_batch, max_seq=max_seq, device="cpu",
                            kv_quantized=kv_quantized))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graphs")
    out = {"llama": str(tmp / "llama.gguf"), "mamba": str(tmp / "mamba.gguf")}
    write_fixture_gguf(out["llama"], tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                                                 ffn_dim=128, vocab_size=512), seed=7,
                       scale=0.08)
    write_fixture_gguf(out["mamba"], tiny_mamba_config(dim=64), seed=0, scale=0.3)
    return out


@pytest.fixture(scope="module")
def llama(paths):
    return _pair(paths["llama"])


def _prefilled(je, te, prompts=PROMPTS):
    """Both engines' caches after the prompts, and the first greedy token
    from the JAX prefill's logits (fed to both loops)."""
    jl, jcache, lens = je.prefill(prompts, je.new_cache(len(prompts)))
    _, tcache, tlens = te.prefill(prompts, te.new_cache(len(prompts)))
    assert list(tlens) == list(lens)
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)
    return jcache, tcache, lens, first


# -- the decode loops ----------------------------------------------------------------


@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_greedy_step_body_matches_jax_decode_loop(paths, kv_quantized):
    """12 runs of the captured step's body give decode_greedy_jit's tokens
    (tokens equal), and the plain loop's tokens and last logits bit for
    bit."""
    je, te = _pair(paths["llama"], kv_quantized=kv_quantized)
    jcache, tcache, lens, first = _prefilled(je, te)
    want, _ = je.decode_greedy_jit(jnp.asarray(first, jnp.int32), jnp.asarray(lens, jnp.int32),
                                   jcache, 12)
    plain_cache = te.new_cache(2)
    te.prefill(PROMPTS, plain_cache)
    got, _ = te.decode_greedy(torch.from_numpy(first), torch.from_numpy(lens), tcache, 12,
                              plain=False)
    body_logits = te.last_logits.clone()
    plain, _ = te.decode_greedy(torch.from_numpy(first), torch.from_numpy(lens), plain_cache, 12,
                                plain=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, plain) and torch.equal(body_logits, te.last_logits)
    assert torch.equal(tcache.k, plain_cache.k) and torch.equal(tcache.v, plain_cache.v)


def test_loop_in_turns_of_its_buffer(llama, monkeypatch):
    """A loop longer than its token buffer runs in turns (LOOP_WIDTH = 5
    here): 12 steps give the plain loop's tokens."""
    monkeypatch.setattr(t_engine, "LOOP_WIDTH", 5)
    _, te = llama
    caches = [te.prefill(PROMPTS, te.new_cache(2))[1] for _ in range(2)]
    lens = torch.tensor([len(p) for p in PROMPTS])
    first = torch.tensor([5, 6])
    got, _ = te.decode_greedy(first, lens, caches[0], 12, plain=False)
    want, _ = te.decode_greedy(first, lens, caches[1], 12, plain=True)
    assert got.shape == (2, 12) and torch.equal(got, want)


@contextlib.contextmanager
def _jax_noise(monkeypatch, key, n: int, B: int, V: int):
    """Feed the port's sampler JAX's Gumbel noise: decode_sampled_jit's step
    s splits its key and draws categorical(sub_s) = argmax(l + gumbel(sub_s,
    [B, V])); the port's keys carry the step in column 1."""
    noise = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (B, V)))))

    def gumbel(keys, V_):
        assert V_ == V
        return noise[int(keys[0, 1])]

    monkeypatch.setattr(t_sampling, "gumbel", gumbel)
    yield


def test_sampled_step_body_matches_jax_decode_loop(llama, monkeypatch):
    """12 runs of the captured sampled step (temperature 0.8, top-k 40,
    top-p 0.95, repeat penalty 1.1 over 16), fed JAX's noise, give
    decode_sampled_jit's tokens (tokens equal) and its penalty state (bit
    for bit); the plain loop gives the same tokens, last logits, keys and
    penalty state."""
    je, te = llama
    jcache, tcache, lens, first = _prefilled(je, te)
    B, V = len(PROMPTS), te.cfg.vocab_size
    key = jax.random.PRNGKey(5)
    jsc = j_sampling.SamplerConfig(temperature=SC.temperature, top_k=SC.top_k, top_p=SC.top_p,
                                   repeat_penalty=SC.repeat_penalty,
                                   penalty_last_n=SC.penalty_last_n)
    jstate = j_sampling.init_penalty_state(PROMPTS, V, SC.penalty_last_n)
    want, _, _, jstate = je.decode_sampled_jit(jnp.asarray(first, jnp.int32),
                                               jnp.asarray(lens, jnp.int32), jcache, 12, jsc,
                                               key, jstate)
    runs = {}
    with _jax_noise(monkeypatch, key, 12, B, V):
        for plain in (False, True):
            cache = tcache if not plain else te.prefill(PROMPTS, te.new_cache(2))[1]
            state = t_sampling.init_penalty_state(PROMPTS, V, SC.penalty_last_n)
            keys = t_sampling.row_keys(torch.arange(B), 0)
            toks, _, keys, state = te.decode_sampled(torch.from_numpy(first),
                                                     torch.from_numpy(lens), cache, 12, SC,
                                                     keys, state, plain=plain)
            runs[plain] = (toks, te.last_logits.clone(), keys, state)
    (got, logits, keys, state), plain = runs[False], runs[True]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mine, theirs in zip(state, jstate):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert torch.equal(got, plain[0]) and torch.equal(logits, plain[1])
    assert torch.equal(keys, plain[2]) and keys[:, 1].tolist() == [12, 12]
    assert all(torch.equal(a, b) for a, b in zip(state, plain[3]))


def test_mamba_step_body_matches_jax_decode_loop(paths):
    """A tiny mamba: 12 runs of the captured step give decode_greedy_jit's
    tokens, and the plain loop's tokens, last logits and final state bit
    for bit."""
    je, te = _pair(paths["mamba"], max_seq=96)
    jcache, tcache, lens, first = _prefilled(je, te)
    want, _ = je.decode_greedy_jit(jnp.asarray(first, jnp.int32), jnp.asarray(lens, jnp.int32),
                                   jcache, 12)
    plain_cache = te.prefill(PROMPTS, te.new_cache(2))[1]
    got, _ = te.decode_greedy(torch.from_numpy(first), torch.from_numpy(lens), tcache, 12,
                              plain=False)
    body_logits = te.last_logits.clone()
    plain, _ = te.decode_greedy(torch.from_numpy(first), torch.from_numpy(lens), plain_cache, 12,
                                plain=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, plain) and torch.equal(body_logits, te.last_logits)
    assert torch.equal(tcache.ssm, plain_cache.ssm) and torch.equal(tcache.conv,
                                                                    plain_cache.conv)


def test_loops_are_keyed_on_cache_and_switches(paths, monkeypatch):
    """One captured step per (batch, cache, sampler, switches): the same
    cache reuses it; a switch or the attention budget makes another; a
    cache's step goes when the cache does; at most maxsize stay."""
    _, te = _pair(paths["llama"])
    lens = torch.tensor([len(p) for p in PROMPTS])
    first = torch.tensor([5, 6])
    cache = te.prefill(PROMPTS, te.new_cache(2))[1]
    for _ in range(2):
        te.decode_greedy(first, lens, cache, 2, plain=False)
    assert len(te._graphs) == 1
    monkeypatch.setenv("TKQ_FUSE_FFN", "0")
    te.decode_greedy(first, lens, cache, 2, plain=False)
    monkeypatch.setattr(attention, "ATTN_PLAIN_MAX_MB", 0.5)
    te.decode_greedy(first, lens, cache, 2, plain=False)
    assert len(te._graphs) == 3
    del cache
    gc.collect()
    assert len(te._graphs) == 0
    for _ in range(6):
        te.decode_greedy(first, lens, te.new_cache(2), 1, plain=False)
    assert len(te._graphs) == 0
    kept = [te.new_cache(2) for _ in range(6)]
    for c in kept:
        te.decode_greedy(first, lens, c, 1, plain=False)
    assert len(te._graphs) == te._graphs.maxsize


@pytest.mark.parametrize("name,value", [("TKQ_INT8_FOLDS", "1"), ("TKQ_Q4_MXU_MINS", "0"),
                                        ("TKQ_GROUP_SCALE", "1"), ("TKQ_MANUAL_ATTN_IN", "0"),
                                        ("TKQ_MANUAL_OPROJ", "0")])
def test_fold_switches_key_the_loops(paths, name, value, monkeypatch):
    """The int8 folds' switches and the TPU's choice of manual variants
    (ops/dequant.py) key the captured steps: a step captured before the
    switch is not the one run after it."""
    from tpu_kquant_torch.runtime import graphs

    assert name in graphs.SWITCHES
    monkeypatch.delenv(name, raising=False)
    _, te = _pair(paths["llama"])
    lens = torch.tensor([len(p) for p in PROMPTS])
    first = torch.tensor([5, 6])
    cache = te.prefill(PROMPTS, te.new_cache(2))[1]
    te.decode_greedy(first, lens, cache, 2, plain=False)
    te.decode_greedy(first, lens, cache, 2, plain=False)
    assert len(te._graphs) == 1
    monkeypatch.setenv(name, value)
    te.decode_greedy(first, lens, cache, 2, plain=False)
    assert len(te._graphs) == 2


# -- the serving chunk ---------------------------------------------------------------


class _HostReads:
    """Counts the tensor-to-host reads of the batcher's chunks: .cpu(),
    .item(), .tolist(), bool() on a tensor, per step_chunk call."""

    def __init__(self, monkeypatch, cb):
        self.chunks: list[int] = []
        self.n = None
        for name in ("cpu", "item", "tolist", "__bool__"):
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._spy(real))
        real_chunk = cb.step_chunk

        def chunk(n, on_token=None):
            self.n = 0
            real_chunk(n, on_token)
            self.chunks.append(self.n)
            self.n = None

        cb.step_chunk = chunk

    def _spy(self, real):
        def f(t, *a, **k):
            if self.n is not None:
                self.n += 1
            return real(t, *a, **k)
        return f


def _serve_both(models, specs, B=2, max_seq=64, max_chunk=32, monkeypatch=None):
    """Serve specs with the JAX batcher and the port's replayed chunk
    (plain=False); returns (JAX outputs, stats), (port outputs, stats,
    ticks_run, host reads per chunk)."""
    (jc, jp), (tc, tp) = models
    out = []
    for mod, eng in ((jserving, JEngine(jc, jp, max_batch=B, max_seq=max_seq, impl="xla")),
                     (tserving, InferenceEngine(tc, tp, max_batch=B, max_seq=max_seq,
                                                device="cpu"))):
        cb = mod.ContinuousBatcher(eng, seed=5) if mod is jserving else \
            mod.ContinuousBatcher(eng, seed=5, plain=False)
        reads = _HostReads(monkeypatch, cb) if mod is tserving else None
        for s in specs:
            cb.submit(mod.Request(**s))
        done = sorted(cb.run(max_chunk=max_chunk), key=lambda r: r.rid)
        out.append(([r.output for r in done], {k: cb.stats[k] for k in STATS},
                    cb.stats.get("ticks_run"), reads and reads.chunks))
    return out


@pytest.fixture(scope="module")
def serve_models(paths):
    jc, jp, _ = jload(paths["llama"], scale_dtype="bf16")
    tc, tp, _ = load_model(paths["llama"], scale_dtype="bf16", device="cpu")
    return (jc, jp), (tc, tp)


def test_replayed_chunk_matches_jax_when_every_row_meets_its_eos(serve_models, llama,
                                                                  monkeypatch):
    """Both rows meet their eos inside the first chunk: the streams stop at
    their eos, the ticks that began with a live row equal _tick_n_fn's
    early-exit count (stats equal the JAX batcher's), the device ran the
    whole chunk (ticks_run), and the chunk read the host once."""
    _, te = llama
    base = [te.generate([p], max_new_tokens=24)[0] for p in PROMPTS]
    specs = [dict(prompt=p, max_new_tokens=24, eos_id=b[3 + 2 * i])
             for i, (p, b) in enumerate(zip(PROMPTS, base))]
    (jo, js, _, _), (to, ts, run, reads) = _serve_both(serve_models, specs,
                                                       monkeypatch=monkeypatch)
    assert to == jo == [b[: b.index(s["eos_id"]) + 1] for b, s in zip(base, specs)]
    assert ts == js and ts["steps"] < 24
    assert reads and all(r == 1 for r in reads)
    assert run == 1 + 23 * len(reads)  # the admission tick, then whole chunks of 23


def test_replayed_chunk_matches_jax_when_no_row_meets_its_eos(serve_models, monkeypatch):
    """Greedy and sampled rows (temperature, top-k, top-p, penalties) with no
    eos, and a third request that waits for a slot: the greedy streams, the lengths and the
    stats equal the JAX batcher's; every chunk read the host once and ran
    the ticks it counted."""
    specs = [dict(prompt=[3, 100, 7], max_new_tokens=20),
             dict(prompt=[9, 300], max_new_tokens=9, temperature=0.9, top_k=20, top_p=0.9,
                  repeat_penalty=1.2, seed=11),
             dict(prompt=[17, 5, 11], max_new_tokens=13)]
    (jo, js, _, _), (to, ts, run, reads) = _serve_both(serve_models, specs,
                                                       monkeypatch=monkeypatch)
    assert [to[0], to[2]] == [jo[0], jo[2]] and [len(o) for o in to] == [20, 9, 13]
    assert ts == js and run == ts["steps"]
    assert reads and all(r == 1 for r in reads)


@pytest.mark.parametrize("model", ["llama", "mamba"])
def test_idle_ticks_change_nothing_the_host_reads(paths, model):
    """Ticks on an all-inactive batch (a replayed chunk past every row's
    eos): tokens, positions, the active and fresh masks, the record's count
    and (mamba) every row's state stay as they were, bit for bit."""
    tc, tp, _ = load_model(paths[model], scale_dtype="bf16", device="cpu")
    eng = InferenceEngine(tc, tp, max_batch=2, max_seq=64, device="cpu")
    base = [eng.generate([p], max_new_tokens=8)[0] for p in PROMPTS]
    cb = tserving.ContinuousBatcher(eng, plain=False)
    for p, b in zip(PROMPTS, base):
        cb.submit(tserving.Request(prompt=p, max_new_tokens=8, eos_id=b[1]))
    cb.step()
    cb._record[-2:].zero_()
    while bool(cb.state.active.any()):
        cb._replay_tick(False)
    st = cb.state
    before = {k: getattr(st, k).clone() for k in ("toks", "poss", "active", "fresh")}
    count = int(cb._count)
    state = [t.clone() for t in graphs.cache_tensors(cb.cache)] if model == "mamba" else []
    for _ in range(3):
        cb._replay_tick(False)
    assert all(torch.equal(getattr(st, k), v) for k, v in before.items())
    assert int(cb._count) == count
    assert all(torch.equal(a, b) for a, b in zip(state, graphs.cache_tensors(cb.cache)))


def test_per_tick_and_chunked_replays_match_the_plain_batcher(serve_models):
    """The replayed tick and chunk give the plain batcher's streams (greedy
    and sampled, equal), per tick and in chunks, and the same stats."""
    _, (tc, tp) = serve_models
    specs = [dict(prompt=[3, 100, 7], max_new_tokens=10),
             dict(prompt=[9, 300], max_new_tokens=7, temperature=0.8, top_k=40, seed=2),
             dict(prompt=[17, 5, 11], max_new_tokens=6, repeat_penalty=1.3)]
    runs = []
    for plain, max_chunk in ((True, 8), (False, 8), (False, 1)):
        eng = InferenceEngine(tc, tp, max_batch=2, max_seq=64, device="cpu")
        cb = tserving.ContinuousBatcher(eng, seed=3, plain=plain)
        for s in specs:
            cb.submit(tserving.Request(**s))
        done = sorted(cb.run(max_chunk=max_chunk), key=lambda r: r.rid)
        runs.append(([r.output for r in done], {k: cb.stats[k] for k in STATS},
                     bool(cb.logits_finite)))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert runs[0][1] == runs[1][1] and all(r[2] for r in runs)


# -- the launch accounting ----------------------------------------------------------


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_replays_add_the_captured_launches(monkeypatch):
    """StepGraph's CUDA path with torch.cuda's graph calls stood in for: the
    warm run's launches count, the capture's are taken back and become the
    graph's deltas, and every replay adds them once; STATS counts the
    capture and the replays by the step's number."""
    for name, value in {
            "current_stream": lambda d=None: _Side(), "Stream": lambda d=None: _Side(),
            "stream": lambda s: contextlib.nullcontext(), "synchronize": lambda d=None: None,
            "empty_cache": lambda: None, "memory_reserved": lambda d=None: 0,
            "CUDAGraph": _FakeGraph, "graph": lambda g: contextlib.nullcontext(),
            "get_sync_debug_mode": lambda: 0, "set_sync_debug_mode": lambda m: None,
            "device": lambda d: contextlib.nullcontext()}.items():
        monkeypatch.setattr(torch.cuda, name, value)
    qmm = _build.COUNTERS["qmm"]
    monkeypatch.setattr(qmm, "launches", 0)
    calls = []

    def step(x):
        calls.append(graphs.capturing())
        qmm.launches += 3  # the step's wrapper calls
        return ()

    g = graphs.StepGraph("cuda")
    captures, replays = graphs.STATS.captures, graphs.STATS.replays
    for _ in range(5):
        g.run(step, 1)
    assert calls == [None, g.seq]  # the warm run, then the capture; replays call nothing
    assert g.deltas == {"qmm": 3} and qmm.launches == 3 * 5
    assert graphs.STATS.captures == captures + 1 and graphs.STATS.replays == replays + 4
    assert graphs.STATS.by_step[g.seq] == 4 and _FakeGraph.replays >= 4


class _Side:
    def wait_stream(self, other):
        pass


def test_take_back_and_add_launches():
    """take_back restores the counts and returns what was added (a counter
    made since included); add_launches adds it back."""
    before = _build.launch_counts()
    _build.COUNTERS["qmm"].launches += 2
    extra = _build.LaunchCounter("graphs_test_kernel")
    extra.launches = 5
    try:
        delta = _build.take_back(before)
        assert delta == {"qmm": 2, "graphs_test_kernel": 5}
        assert _build.launch_counts() == {**before, "graphs_test_kernel": 0}
        _build.add_launches(delta)
        assert _build.COUNTERS["qmm"].launches == before["qmm"] + 2
    finally:
        _build.COUNTERS.pop("graphs_test_kernel")
        _build.COUNTERS["qmm"].launches = before["qmm"]
