"""The port's front door on the CPU against the JAX package: the rope delta
tables, the KV cache's context shift, the general step at T > 1
mid-sequence, context-shift generation, sessions read across the two
packages, both speculators and the three CLIs (main, bench_cli,
perplexity). The model is tests/test_speculative.py's (2 layers, dim 64,
vocab 512, seed 7; the "bad" draft seed 99), written by the JAX writer,
whose vocab the CLIs tokenize with. The JAX engine runs impl="xla"; the port
its plain versions.
"""

import dataclasses
import importlib
import pkgutil
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops import rope as j_rope
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import kv_cache as j_kv
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime import speculative as j_spec
from tpu_kquant.tools import main as j_main
from tpu_kquant.tools import perplexity as j_ppl
from tpu_kquant_torch.models.config import RopeParams
from tpu_kquant_torch.ops import rope as t_rope
from tpu_kquant_torch.runtime import kv_cache as t_kv
from tpu_kquant_torch.runtime import speculative as t_spec
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model
from tpu_kquant_torch.tools import bench_cli as t_bench
from tpu_kquant_torch.tools import main as t_main
from tpu_kquant_torch.tools import perplexity as t_ppl

torch.set_num_threads(1)

CFG = dict(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=512)


def _write(tmp, name, seed):
    path = tmp / f"{name}.gguf"
    write_fixture_gguf(path, tiny_config(**CFG), seed=seed, scale=0.08)
    return str(path)


def _pair(path, max_batch=2, max_seq=128, kv_quantized=False):
    jc, jp, _ = jload(path)
    tc, tp, _ = load_model(path, scale_dtype="bf16", device="cpu")
    return (JEngine(jc, jp, max_batch=max_batch, max_seq=max_seq, impl="xla",
                    kv_quantized=kv_quantized),
            InferenceEngine(tc, tp, max_batch=max_batch, max_seq=max_seq, device="cpu",
                            kv_quantized=kv_quantized))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontdoor")
    return {"target": _write(tmp, "target", 7), "draft": _write(tmp, "draft", 99)}


@pytest.fixture(scope="module")
def engines(paths):
    """(JAX, port) engine pairs: the target and the bad draft."""
    return {name: _pair(p) for name, p in paths.items()}


def test_front_door_modules_are_checked_for_jax():
    """test_torch_quant.py::test_port_imports_nothing_of_jax walks every
    module of the package; the front door's are among them."""
    import tpu_kquant_torch

    names = {m.name for m in pkgutil.walk_packages(tpu_kquant_torch.__path__,
                                                   "tpu_kquant_torch.")}
    for mod in ("tokenizer", "tokenizer.spm", "tokenizer.bpe", "tokenizer.tokenizer",
                "runtime.speculative", "tools.main", "tools.bench_cli", "tools.perplexity"):
        assert f"tpu_kquant_torch.{mod}" in names
        importlib.import_module(f"tpu_kquant_torch.{mod}")


# -- rope delta and the context shift -------------------------------------------
D = 8
ROPES = {
    "norm": dict(head_dim=D, n_rot=D, mode="norm"),
    "neox": dict(head_dim=D, n_rot=D, mode="neox"),
    "yarn": dict(head_dim=D, n_rot=D, mode="norm", freq_scale=0.25, ext_factor=1.0,
                 n_ctx_orig=64),
}


@pytest.mark.parametrize("delta", [-5, 3, -1000])
@pytest.mark.parametrize("rope", list(ROPES))
def test_rope_delta_matches_jax(rope, delta):
    c, s = t_rope.rope_delta_cos_sin(delta, RopeParams(**ROPES[rope]))
    jc, js = j_rope.rope_delta_cos_sin(delta, j_rope.RopeParams(**ROPES[rope]))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rope", list(ROPES))
def test_shift_cache_matches_jax(rope, quantized):
    """tests/test_kv_shift.py's cache (every slot roped at its position)
    shifted by both packages: bf16 K within one bf16 ulp, int8 codes within
    1 and scales within 1e-6 relative (sums in f32 in another order), V and
    the kept slots equal."""
    L, B, S, H = 2, 2, 16, 2
    rng = np.random.default_rng(0)
    k_raw, v_raw = (rng.standard_normal((L, B, S, H, D)).astype(np.float32) for _ in range(2))
    jr = j_rope.RopeParams(**ROPES[rope])
    cache = j_kv.KVCache.create(L, B, S, H, D, quantized=quantized)
    cos, sin = j_rope.rope_cos_sin(jnp.arange(S)[None, :], jr)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    for layer in range(L):
        k = j_rope.apply_rope(jnp.asarray(k_raw[layer]), cos[:, :, None, :], sin[:, :, None, :],
                              jr.mode)
        cache = cache.append(layer, k, jnp.asarray(v_raw[layer]), pos)
    np_of = lambda a: None if a is None else np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)  # noqa: E731
    ours = t_kv.KVCache.from_numpy(*(np_of(getattr(cache, f)) for f in
                                     ("k", "v", "k_scale", "v_scale")), device="cpu")
    n_keep, n_discard = 3, 5
    want = j_kv.shift_cache(cache, n_keep, n_discard, jr)
    got = t_kv.shift_cache(ours, n_keep, n_discard, RopeParams(**ROPES[rope]))
    assert got is ours  # in place
    wk, gk = np_of(want.k), got.k.float().numpy()
    if quantized:
        assert np.abs(gk - wk).max() <= 1
        np.testing.assert_allclose(got.k_scale.numpy(), np_of(want.k_scale), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got.v_scale.numpy(), np_of(want.v_scale))
    else:
        ulp = np.abs(wk) * 2.0 ** -7
        assert (np.abs(gk - wk) <= ulp + 1e-30).all()
    np.testing.assert_array_equal(gk[:, :, :, :n_keep], np_of(cache.k)[:, :, :, :n_keep])
    np.testing.assert_array_equal(got.v.float().numpy(), np_of(want.v))


# -- the general step -----------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_step_mid_sequence_matches_jax(paths, quantized):
    """A 5-token window at positions 9..13 after a 9-token prefill, on both
    packages' caches: the logits of every row within 5e-2 of max|ref| (bf16
    activations), the greedy tokens equal."""
    je, te = _pair(paths["target"], max_batch=2, max_seq=64, kv_quantized=quantized)
    prompts = [[3, 5, 7, 11, 2, 9, 40, 41, 42], [100, 20, 9, 42, 8, 1, 2, 3, 4]]
    jcache, tcache = je.new_cache(2), te.new_cache(2)
    _, jcache, _ = je.prefill(prompts, jcache)
    _, tcache, _ = te.prefill(prompts, tcache)
    window = np.array([[5, 6, 7, 8, 9], [300, 301, 302, 303, 304]], np.int32)
    pos = 9 + np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    jl, _ = je._step(je.params, jnp.asarray(window), jnp.asarray(pos), jcache, False)
    tl, _ = te.step(window, pos, tcache)
    want, got = np.asarray(jl, np.float32), tl.numpy()
    assert got.shape == want.shape == (2, 5, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_step_rows_equal_decode_steps(paths):
    """Row t of a window equals the decode step at its position (the
    property the card holds bit for bit; here the plain CPU forms within
    f32 order)."""
    _, te = _pair(paths["target"], max_batch=1, max_seq=64)
    prompt = [3, 5, 7, 11, 2, 9]
    window = [8, 9, 10, 11]
    c1, c2 = te.new_cache(1), te.new_cache(1)
    _, c1, _ = te.prefill([prompt], c1)
    _, c2, _ = te.prefill([prompt], c2)
    wl, _ = te.step([window], [list(range(6, 10))], c1)
    for t, tok in enumerate(window):
        dl, c2 = te.decode_step(torch.tensor([tok]), torch.tensor([6 + t]), c2)
        torch.testing.assert_close(wl[0, t], dl[0], rtol=1e-5, atol=1e-5)


def test_window_attention_fixed_rows_equal_decode_calls():
    """The card's form of the plain attention (fixed=True, here on CPU
    tensors): query t of a window whose rows are in the cache equals the
    deferred decode call at its position, whose cache holds other data
    past it, bit for bit."""
    from tpu_kquant_torch.ops.attention import attention_plain

    g = torch.Generator().manual_seed(5)
    B, T, H, Hkv, S, D, p = 2, 5, 8, 2, 64, 32, 20
    q = torch.randn(B, T, H, D, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16) for _ in range(2))
    pos = p + torch.arange(T).expand(B, T)
    cur = tuple(c[:, :, p:p + T].transpose(1, 2) for c in (k, v))  # [B, T, Hkv, D]
    win = attention_plain(q, k, v, pos, kv_cur=cur, fixed=True)
    for t in range(T):
        kd, vd = (c.clone() for c in (k, v))
        for c in (kd, vd):
            c[:, :, p + t:] = torch.randn(B, Hkv, S - p - t, D, generator=g).to(torch.bfloat16)
        dec = attention_plain(q[:, t:t + 1], kd, vd, pos[:, t:t + 1],
                              kv_cur=tuple(c[:, t:t + 1] for c in cur), fixed=True)
        assert torch.equal(win[:, t:t + 1], dec), t


def test_window_past_the_budget_takes_the_reference_route(paths, monkeypatch):
    """A window whose plain logits pass the budget where a decode step's do
    not attends without kv_cur, as the reference's window does; its logits
    within 5e-2 of max|ref| of the JAX _step's and its greedy tokens equal."""
    from tpu_kquant_torch.ops import attention

    je, te = _pair(paths["target"], max_batch=1, max_seq=64)
    # a decode step's logits 4 * 1 * 64 * 4 B = 1.0e-3 MB, the window's 8x that
    monkeypatch.setattr(attention, "ATTN_PLAIN_MAX_MB", 2e-3)
    prompt, window = [[3, 5, 7, 11, 2, 9]], np.array([[8, 9, 10, 11, 12, 13, 14, 15]])
    pos = 6 + np.arange(8)[None, :]
    seen = []
    real = attention.attention_decode
    monkeypatch.setattr(attention, "attention_decode",
                        lambda *a, **k: seen.append(k.get("kv_cur")) or real(*a, **k))
    _, tcache, _ = te.prefill(prompt, te.new_cache(1))
    seen.clear()
    tl, _ = te.step(window, pos, tcache)
    assert len(seen) == 2 and all(c is None for c in seen)
    _, jcache, _ = je.prefill(prompt, je.new_cache(1))
    jl, _ = je._step(je.params, jnp.asarray(window, jnp.int32), jnp.asarray(pos, jnp.int32),
                     jcache, False)
    want, got = np.asarray(jl, np.float32), tl.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()


# -- context shift ----------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_generate_context_shift_matches_jax(paths, quantized):
    """max_seq 32, a 10-token prompt and 50 new tokens with n_keep 2: two
    shifts; the port's tokens equal the JAX engine's."""
    je, te = _pair(paths["target"], max_batch=1, max_seq=32, kv_quantized=quantized)
    prompt = [[3, 5, 7, 11, 2, 9, 40, 41, 42, 43]]
    want = je.generate(prompt, max_new_tokens=50, context_shift=True, n_keep=2)
    got = te.generate(prompt, max_new_tokens=50, context_shift=True, n_keep=2)
    assert len(got[0]) == 50
    assert got == want
    # without the shift generation stops at the KV capacity
    assert len(te.generate(prompt, max_new_tokens=50)[0]) == 22


def test_shift_guard_matches_jax(engines):
    je, te = engines["target"]
    for eng, cache in ((je, je.new_cache(2)), (te, te.new_cache(2))):
        with pytest.raises(ValueError, match="would drop live entries of a row at position 6"):
            eng.shift_context(cache, np.array([20, 6]), 2, 5)
    cache, pos = te.shift_context(te.new_cache(2), np.array([20, 7]), 2, 5)
    assert pos.tolist() == [15, 2]


# -- sessions -----------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_across_packages(paths, tmp_path, writer, quantized):
    """Prefill and 6 greedy tokens, saved by one package and loaded by the
    other: the cache bytes survive the trip, and the 8 tokens decoded from
    the loaded cache equal those the writer decodes on."""
    je, te = _pair(paths["target"], max_batch=1, max_seq=64, kv_quantized=quantized)
    prompt = [[3, 5, 7, 11, 2, 9]]
    path = str(tmp_path / "s.npz")
    if writer == "jax":
        cache = je.new_cache(1)
        logits, cache, lens = je.prefill(prompt, cache)
        first = jnp.argmax(logits, -1).astype(jnp.int32)
        toks, cache = je.decode_greedy_jit(first, jnp.asarray(lens), cache, 6)
        last, pos = np.asarray(toks)[:, -1], lens + 6
        je.save_session(path, cache, pos)
        want, _ = je.decode_greedy_jit(jnp.asarray(last), jnp.asarray(pos), cache, 8)
        loaded, lens2 = te.load_session(path)
        got, _ = te.decode_greedy(torch.tensor(last), torch.tensor(lens2), loaded, 8)
    else:
        cache = te.new_cache(1)
        logits, cache, lens = te.prefill(prompt, cache)
        toks, cache = te.decode_greedy(torch.argmax(logits, -1), torch.tensor(lens), cache, 6)
        last, pos = toks[:, -1].numpy(), lens + 6
        te.save_session(path, cache, pos)
        want, _ = te.decode_greedy(torch.tensor(last), torch.tensor(pos), cache, 8)
        loaded, lens2 = je.load_session(path)
        got, _ = je.decode_greedy_jit(jnp.asarray(last, jnp.int32), jnp.asarray(lens2), loaded, 8)
    assert np.asarray(lens2).tolist() == [12]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_session_round_trip_bytes(engines, tmp_path):
    _, te = engines["target"]
    for q in (False, True):
        eng = InferenceEngine(te.cfg, te.params, max_batch=2, max_seq=32, device="cpu",
                              kv_quantized=q)
        cache = eng.new_cache(2)
        _, cache, lens = eng.prefill([[3, 5, 7], [9, 8, 7, 6, 5]], cache)
        eng.save_session(str(tmp_path / "r.npz"), cache, lens)
        back, lens2 = eng.load_session(str(tmp_path / "r.npz"))
        for f in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(cache, f), getattr(back, f)
            assert (a is None) == (b is None) == (not q and f.endswith("scale"))
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert lens2.tolist() == [3, 5]


# -- speculative decoding: tests/test_speculative.py's seven cases ------------------
NEAR_TIE = 1e-3  # logits of the tiny model are ~0.2; bf16 keeps 2^-8 of that


def _both(engines, fn):
    (jt, tt), (jd, td) = engines["target"], engines["draft"]
    return fn(j_spec, jt, jd), fn(t_spec, tt, td)


def _hold(engines, prompts, got, want, greedy):
    """The port's speculative rows must be the port's plain greedy rows, and
    the JAX package's rows and stats. Where the two packages' greedy streams
    part (the port's bf16 rounding against XLA's at a near tie), a row is
    held to JAX's up to that token, which must be a near tie in JAX's
    logits; stats then count other rounds and are not compared."""
    assert got[0] == greedy
    if got[0] == want[0]:
        assert got[1] == want[1]
        return
    je = engines["target"][0]
    for prompt, g, w in zip(prompts, got[0], want[0]):
        if g == w:
            continue
        i = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        logits, _, _ = je.prefill([prompt + w[:i]], je.new_cache(1))
        lj = np.asarray(logits[0], np.float32)
        assert lj[w[i]] - lj[g[i]] < NEAR_TIE, (i, g[i], w[i], lj[w[i]], lj[g[i]])


def test_perfect_draft_accepts_everything(engines):
    prompts = [[3, 5, 7, 11]]
    want, got = _both(engines, lambda m, t, d: m.generate_speculative(
        t, t, prompts, max_new_tokens=12, n_draft=4))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=12))
    assert got[1]["accepted"] == got[1]["drafted"] and got[1]["rounds"] <= 3


def test_bad_draft_output_unchanged(engines):
    prompts = [[3, 5, 7, 11, 2, 9]]
    want, got = _both(engines, lambda m, t, d: m.generate_speculative(
        t, d, prompts, max_new_tokens=16, n_draft=4))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=16))
    assert got[1]["accepted"] < got[1]["drafted"]


def test_batched_rows_diverge(engines):
    prompts = [[3, 5, 7], [100, 20, 9, 42, 8]]
    want, got = _both(engines, lambda m, t, d: m.generate_speculative(
        t, d, prompts, max_new_tokens=10, n_draft=3))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=10))


def test_eos_stops_row(engines):
    prompts = [[3, 5, 7, 11]]
    eos = engines["target"][1].generate(prompts, max_new_tokens=12)[0][4]
    want, got = _both(engines, lambda m, t, d: m.generate_speculative(
        t, t, prompts, max_new_tokens=12, n_draft=4, eos_id=eos))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=12, eos_id=eos))
    assert got[0][0][-1] == eos and len(got[0][0]) == 5


def test_device_speculator_ngram_matches_greedy(engines):
    prompts = [[3, 5, 7, 11], [9, 300]]
    want, got = _both(engines, lambda m, t, d: m.DeviceSpeculator(
        t, None, n_draft=4, ngram=2).generate(prompts, max_new_tokens=16))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=16))
    assert got[1]["rounds"] >= 1


def test_device_speculator_two_model_matches_greedy(engines):
    prompts = [[3, 5, 7, 11]]
    want, got = _both(engines, lambda m, t, d: m.DeviceSpeculator(
        t, d, n_draft=4).generate(prompts, max_new_tokens=14))
    _hold(engines, prompts, got, want,
          engines["target"][1].generate(prompts, max_new_tokens=14))


def test_device_speculator_repetitive_text_accepts(engines):
    te = engines["target"][1]
    prompt = [3, 100, 7] + te.generate([[3, 100, 7]], max_new_tokens=24)[0]
    want, got = _both(engines, lambda m, t, d: m.DeviceSpeculator(
        t, None, n_draft=4, ngram=2).generate([prompt], max_new_tokens=16))
    _hold(engines, [prompt], got, want, te.generate([prompt], max_new_tokens=16))
    assert got[1]["rounds"] < 16


def test_device_speculator_accept_all(engines):
    """accept_all emits n_draft + 1 tokens a round: the JAX package's
    tokens and stats."""
    prompts = [[3, 5, 7, 11], [9, 300]]
    want, got = _both(engines, lambda m, t, d: m.DeviceSpeculator(
        t, None, n_draft=4, ngram=2, accept_all=True).generate(prompts, max_new_tokens=15))
    assert got == want
    assert got[1]["accepted"] == got[1]["drafted"] == 3 * 4 * 2


# -- the CLIs -----------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--kv-int8"], ["--ctx-shift", "--max-seq", "24",
                                                        "--keep", "2"],
                                   ["--temp", "0", "--repeat-penalty", "1.3"]],
                         ids=["greedy", "int8", "ctx-shift", "penalty"])
def test_main_matches_jax(paths, capsys, extra):
    argv = ["-m", paths["target"], "-p", "hello the world", "-n", "20", *extra]
    want = j_main.main(argv)
    j_out, j_err = capsys.readouterr()
    res = t_main.run(argv + ["--device", "cpu"])
    t_out, t_err = capsys.readouterr()
    assert res["text"] == want and t_out == j_out
    assert len(res["ids"]) == 20
    # the same stderr lines, times aside
    strip = lambda s: re.sub(r"[0-9.]+s|[0-9.]+ tok/s", "#", s)  # noqa: E731
    assert strip(t_err) == strip(j_err)
    assert t_main.main(argv + ["--device", "cpu"]) == want


def test_main_draft_matches_jax(paths, capsys):
    argv = ["-m", paths["target"], "-p", "hello the world", "-n", "16", "--draft",
            paths["draft"], "--n-draft", "3"]
    want = j_main.main(argv)
    j_out, j_err = capsys.readouterr()
    res = t_main.run(argv + ["--device", "cpu"])
    t_out, t_err = capsys.readouterr()
    assert res["text"] == want and t_out == j_out
    assert "[speculative:" in t_err and t_err.splitlines()[1] == j_err.splitlines()[1]


def test_main_sampled_is_generate(paths, engines):
    """Sampling draws from the port's own streams (ops.sampling), so the CLI
    is held to the port's generate(seed=...)."""
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.gguf import GGUFReader

    argv = ["-m", paths["target"], "-p", "hello", "-n", "12", "--temp", "0.8", "--top-k", "40",
            "--top-p", "0.95", "--repeat-penalty", "1.1", "--seed", "3", "--device", "cpu"]
    res = t_main.run(argv)
    tok = from_gguf_metadata(GGUFReader(paths["target"]).metadata)
    ids = tok.encode("hello", add_bos=True)
    te = InferenceEngine(engines["target"][1].cfg, engines["target"][1].params, max_batch=1,
                         max_seq=len(ids) + 12 + 16, device="cpu")
    want = te.generate([ids], max_new_tokens=12, temperature=0.8, top_k=40, top_p=0.95,
                       repeat_penalty=1.1, seed=3, eos_id=2)
    assert res["ids"] == want[0]


def test_main_raises_without_a_card(paths):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main.main(["-m", paths["target"]])
    # --kv-layout iswa runs on a sliding-window arch; this llama has no window
    with pytest.raises(ValueError, match="sliding-window"):
        t_main.main(["-m", paths["target"], "--kv-layout", "iswa", "--device", "cpu"])
    with pytest.raises(ValueError, match="scale_dtype"):
        t_main.main(["-m", paths["target"], "--scale-dtype", "f16", "--device", "cpu"])


def test_bench_table(paths, capsys):
    lines = t_bench.main(["-m", paths["target"], "-p", "32", "-n", "8", "-r", "2", "--device",
                          "cpu"])
    assert capsys.readouterr().out.splitlines() == lines
    assert lines[:2] == ["| model | size | params | backend | test | t/s |",
                         "| ----- | ---: | -----: | ------- | ---- | --: |"]
    for line, test in zip(lines[2:], ("pp32", "tg8")):
        assert re.fullmatch(r"\| llama 0\.0B Q4_K_M \| [0-9.]+ MiB \| 0\.00 B \| cpu \| "
                            + test + r" \| [0-9.]+ ± [0-9.]+ \|", line), line


def test_perplexity_matches_jax(engines):
    """Three windows of 64 over 192 ids from a seed: ppl within 1e-5
    relative of the JAX package's."""
    je, te = engines["target"]
    ids = np.random.default_rng(4).integers(3, 512, 192).tolist()
    want = j_ppl.perplexity(je, ids, ctx=64)
    got = t_ppl.perplexity(te, ids, ctx=64)
    assert got["tokens"] == want["tokens"] == 189 and got["windows"] == want["windows"] == 3
    assert abs(got["ppl"] / want["ppl"] - 1) < 1e-5, (got, want)


def test_perplexity_cli(paths, tmp_path, capsys):
    text = tmp_path / "t.txt"
    text.write_text("hello the world " * 30)
    argv = ["--model", paths["target"], "--text", str(text), "--ctx", "32", "--max-windows", "2"]
    res = t_ppl.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res["windows"] == 2 and res["tokens"] == 62
    assert out.startswith("ppl = ") and np.isfinite(res["ppl"])


@pytest.mark.parametrize("recipe", ["q4_k_m", "q8_0", "q6_k", "q2_k"])
@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_tied_embedding_repacked_once(tmp_path, recipe, scale_dtype):
    """The loader decodes a tied embedding once for both layouts: the bytes
    equal two separate repacks (rowmajor for the gather, kmajor for the lm
    head), and loading decodes token_embd once."""
    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.models.fixtures import tiny_config as t_tiny
    from tpu_kquant_torch.models.fixtures import write_fixture_gguf as t_write
    from tpu_kquant_torch.runtime import loader

    cfg = dataclasses.replace(t_tiny(n_layers=1, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=256,
                                     vocab_size=384), tie_embeddings=True)
    path = t_write(tmp_path / "tied.gguf", cfg, seed=3, recipe=recipe)
    r = GGUFReader(path)
    pairs = scale_dtype == "bf16"
    embd, head = loader._repack_tied(r, "token_embd.weight", pairs, True)
    for qt, layout in ((embd, "rowmajor"), (head, "kmajor")):
        want = loader._repack_named(r, "token_embd.weight", layout, pairs, True)
        assert (qt.kind, qt.layout, qt.shape) == (want.kind, want.layout, want.shape)
        assert qt.arrays.keys() == want.arrays.keys()
        for k in want.arrays:
            np.testing.assert_array_equal(np.asarray(qt.arrays[k]), np.asarray(want.arrays[k]))
    calls = []
    real = loader.repack
    try:
        loader.repack = lambda raw, t, shape, **kw: calls.append(shape) or real(raw, t, shape, **kw)
        _, params, _ = load_model(path, scale_dtype=scale_dtype, device="cpu")
    finally:
        loader.repack = real
    assert calls.count((384, 256)) == 1
    for k, v in params["output"].arrays.items():
        assert torch.equal(v, head.to("cpu").arrays[k])
