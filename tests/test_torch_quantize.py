"""The port's quantizer against the JAX package's, on the CPU.

- ``tpu_kquant_torch.quant.numpy_codecs.quantize`` gives the reference's
  NumPy ``quantize(x, t, use_native=False)`` bytes, bit for bit, for every
  type in ``_QUANT`` (and F32 / F16 / BF16), on seeded Gaussian rows and on
  tests/test_native.py's edge cases;
- the plain PyTorch Q4_K / Q6_K / Q8_0 of ``ops/quantize.py`` (the CUDA
  kernels' plain versions) give the same bytes, and the wrappers run them on
  CPU tensors only;
- ``tools/quantize.py:requantize`` of an F16 fixture written by the
  reference writer gives the reference tool's file byte for byte (q4_k_m
  and q8_0; the reference's native library is switched off inside the test,
  so it runs its NumPy code), and the requantized model's logits in the
  port (CPU, plain versions) match the JAX engine's (impl="xla") within
  5e-2 of max|ref| (tests/test_torch_model.py's tolerance: bf16 rounding
  points differ), with the same argmax;
- ``tools/ppl_delta.py:main`` gives the reference's rows, within limits
  set from this fixture's readings (both engines see the same bytes; their
  logits differ by bf16 rounding only): ppl within 5e-4 relative, KL within
  5e-2 of the reference's + 1e-7, dppl within 0.35 of the reference's, top-1
  within one position; and ``window_metrics`` on identical logits gives the
  reference's ppl, KL and top-1 bit for bit.
"""

import numpy as np
import pytest
import torch

import tpu_kquant.quant.native as j_native
from tpu_kquant.gguf import GGMLType as JGGMLType
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.quant import numpy_codecs as j_codecs
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.tools import ppl_delta as j_ppl_delta
from tpu_kquant.tools import quantize as j_quantize_tool
from tpu_kquant_torch.gguf import GGMLType, GGUFReader, GGUFWriter
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.ops import quantize as t_qops
from tpu_kquant_torch.quant import numpy_codecs as t_codecs
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model
from tpu_kquant_torch.tools import ppl_delta as t_ppl_delta
from tpu_kquant_torch.tools import quantize as t_quantize_tool

torch.set_num_threads(1)
TOL = 5e-2


def _edge_cases():
    """tests/test_native.py's six edge cases, then seeded Gaussian rows."""
    rng = np.random.default_rng(5)
    return {
        "zeros": np.zeros(512, np.float32),
        "constant": np.full(512, 3.25, np.float32),
        "plus-minus-one": np.tile(np.array([1, -1], np.float32), 256),
        "half-zeros": np.concatenate([np.zeros(256), rng.standard_normal(256)]).astype(np.float32),
        "x100": (rng.standard_normal(256 * 16) * 100.0).astype(np.float32),
        "x0.01": (rng.standard_normal(256 * 16) * 0.01).astype(np.float32),
        "gaussian": rng.standard_normal(256 * 32).astype(np.float32),
    }


CASES = _edge_cases()


@pytest.fixture
def no_native(monkeypatch):
    """The reference's NumPy path: its native library reported unavailable."""
    monkeypatch.setattr(j_native, "get_lib", lambda: None)


@pytest.mark.parametrize("t", sorted(int(t) for t in j_codecs._QUANT)
                         + [int(JGGMLType.F32), int(JGGMLType.F16), int(JGGMLType.BF16)])
def test_numpy_codecs_equal_reference(t):
    for name, x in CASES.items():
        want = j_codecs.quantize(x, JGGMLType(t), use_native=False)
        got = t_codecs.quantize(x, GGMLType(t))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{GGMLType(t).name} {name}")


def test_quant_tables_cover_the_same_types():
    assert {int(t) for t in t_codecs._QUANT} == {int(t) for t in j_codecs._QUANT}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("t", ["Q4_K", "Q6_K", "Q8_0"])
def test_plain_equal_numpy(t, case):
    """The kernels' plain versions, on the CPU, byte for byte."""
    t = GGMLType[t]
    x = CASES[case]
    want = t_codecs.quantize(x, t)
    got = t_qops.PLAIN[t](torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_psum_is_numpys_pairwise_sum():
    rng = np.random.default_rng(0)
    for n in (16, 32):
        v = rng.standard_normal((1000, n))
        np.testing.assert_array_equal(t_qops._psum(torch.from_numpy(v)).numpy(), v.sum(axis=1))
    # a sum of -0.0 is +0.0, as NumPy's reduction from its initial 0.0
    s = t_qops._psum(torch.full((1, 16), -0.0, dtype=torch.float64))
    assert not torch.signbit(s).item()


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions; the codec sends the three types
    to the kernels only for the card, and never falls back to NumPy."""
    x = torch.from_numpy(CASES["gaussian"])
    for t, fn in t_qops.QUANTIZERS.items():
        c = t_qops.counters[t]
        launches, plain = c.launches, c.plain_calls
        np.testing.assert_array_equal(fn(x).numpy(), t_codecs.quantize(x.numpy(), t))
        assert (c.launches, c.plain_calls) == (launches, plain + 1)
        t_codecs.quantize(x.numpy(), t, device="cpu")  # host NumPy: no wrapper call
        assert (c.launches, c.plain_calls) == (launches, plain + 1)
        with pytest.raises(ValueError, match="multiple"):
            fn(x[:100])
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                t_codecs.quantize(x.numpy(), t, device="cuda")


def test_work_counts():
    n = 256 * 4
    b, f64, f32 = t_qops.work(GGMLType.Q4_K, n)
    assert b == 4 * n + 4 * 144 and f64 > 250 * n and f32 > 0
    assert t_qops.work(GGMLType.Q8_0, 64)[:2] == (4 * 64 + 2 * 34, 0)


def test_writer_quantizes_lazily(tmp_path, monkeypatch):
    """add_values encodes when the file is written, not before."""
    calls = []
    real = t_codecs.quantize
    monkeypatch.setattr(t_codecs, "quantize", lambda *a: calls.append(a[1]) or real(*a))
    x = CASES["gaussian"].reshape(32, 256)
    w = GGUFWriter(tmp_path / "v.gguf")
    w.add("general.architecture", "llama")
    w.add_values("a", x, GGMLType.Q4_K, device="cpu")
    w.add_values("b", x, GGMLType.Q8_0, device="cpu")
    assert calls == [] and w.n_bytes("a") == 32 * 144 and w.n_bytes("b") == 32 * 8 * 34
    w.write()
    assert calls == [GGMLType.Q4_K, GGMLType.Q8_0]
    with GGUFReader(tmp_path / "v.gguf") as r:
        np.testing.assert_array_equal(r.tensor_bytes("a"), real(x, GGMLType.Q4_K))
        np.testing.assert_array_equal(r.tensor_bytes("b"), real(x, GGMLType.Q8_0))
        assert r.tensors["a"].shape == (32, 256)


def test_fixture_writer_uses_the_tools_recipe_table():
    assert t_fixtures.RECIPES is t_quantize_tool.RECIPES
    assert t_fixtures.target_type is t_quantize_tool.target_type


# ---------------------------------------------------------------------------
# the tools, against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f16_model(tmp_path_factory):
    """tests/test_quantize_tool.py's F16 fixture (dims multiples of 256, so
    the K-quants apply) from the reference writer."""
    path = tmp_path_factory.mktemp("m") / "f16.gguf"
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=512,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=17, quant="f16", scale=0.08)
    return str(path)


@pytest.mark.parametrize("recipe", ["q4_k_m", "q8_0"])
def test_requantize_equals_reference(f16_model, tmp_path, no_native, recipe):
    ref, got = str(tmp_path / "ref.gguf"), str(tmp_path / "port.gguf")
    sj = j_quantize_tool.requantize(f16_model, ref, recipe, verbose=False)
    st = t_quantize_tool.requantize(f16_model, got, recipe, verbose=False, device="cpu")
    assert (st["tensors"], st["bytes_in"], st["bytes_out"]) == \
        (sj["tensors"], sj["bytes_in"], sj["bytes_out"])
    assert open(got, "rb").read() == open(ref, "rb").read()
    with GGUFReader(got) as r:
        assert {k: r.tensors[k].ggml_type for k in r.tensors} == st["types"]
    if recipe == "q4_k_m":
        assert st["types"]["blk.0.attn_q.weight"] == GGMLType.Q4_K
        assert st["types"]["blk.0.ffn_down.weight"] == GGMLType.Q6_K
        assert st["types"]["output.weight"] == GGMLType.Q6_K
        assert st["types"]["blk.0.attn_norm.weight"] == GGMLType.F32
    sec = st["seconds"]
    assert sec["quantize_card"] == 0 and sec["quantize_host"] > 0
    assert abs(sum(v for k, v in sec.items() if k != "total") - sec["total"]) < 1e-6


def test_requantize_cli_needs_a_card_unless_cpu(f16_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_quantize_tool.main(["--in", f16_model, "--out", str(tmp_path / "q.gguf"), "-q"])
    s = t_quantize_tool.main(["--in", f16_model, "--out", str(tmp_path / "q.gguf"), "-q",
                              "--type", "q8_0", "--device", "cpu"])
    assert s["tensors"] == 2 + 2 * 9 + 1


def test_requantized_logits_match_jax(f16_model, tmp_path):
    path = str(tmp_path / "q4.gguf")
    t_quantize_tool.requantize(f16_model, path, "q4_k_m", verbose=False, device="cpu")
    tokens = [3, 100, 7, 42, 9, 300]
    jc, jp, _ = jload(path)
    tc, tp, _ = load_model(path, device="cpu")
    je = JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla")
    te = InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu")
    lj, _, _ = je.prefill([tokens], je.new_cache(1))
    lt, _, _ = te.prefill([tokens], te.new_cache(1))
    a, b = np.asarray(lj[0], np.float32), lt[0].float().numpy()
    assert np.abs(a - b).max() <= TOL * np.abs(a).max()
    assert np.argmax(a) == np.argmax(b)


def _recorded(monkeypatch, module) -> list:
    """The unrounded (ppl, kl, top1) of each ``module.window_metrics`` call
    (main's rows round KL to 6 decimals)."""
    out, f = [], module.window_metrics

    def rec(*a, **k):
        r = f(*a, **k)
        out.append(r[:3])
        return r

    monkeypatch.setattr(module, "window_metrics", rec)
    return out


def test_ppl_delta_equals_reference(f16_model, tmp_path, no_native, monkeypatch):
    """The two engines' logits differ by bf16 rounding, so the rows differ
    a little; the limits were set from this fixture's readings (CHANGES.md):
    ppl within 2.2e-4 relative (limit 5e-4), KL within 5.5% of the
    reference's (q8_0's 1.6e-6; limit 5e-2 of it + 1e-7), dppl within 25% of
    the reference's (q8_0: -0.157 against -0.209; limit 0.35 of it), top-1
    within one of the 128 positions."""
    text = tmp_path / "t.txt"
    text.write_text("hello world the " * 40)
    args = ["--model", f16_model, "--text", str(text), "--types", "q8_0,q6_k,q4_k_m", "--ctx",
            "64", "--max-windows", "2"]
    jw, tw = _recorded(monkeypatch, j_ppl_delta), _recorded(monkeypatch, t_ppl_delta)
    want = j_ppl_delta.main(args + ["--impl", "xla"])
    got = t_ppl_delta.main(args + ["--device", "cpu", "--json-out", str(tmp_path / "r.json")])
    assert [r["type"] for r in got] == [r["type"] for r in want] == ["q8_0", "q6_k", "q4_k_m"]
    assert len(jw) == len(tw) == 4 and jw[0][1:] == tw[0][1:] == (0.0, 1.0)
    for (gp, gk, g1), (wp, wk, w1) in zip(tw, jw):
        assert abs(gp - wp) <= 5e-4 * wp, (gp, wp)
        assert abs(gk - wk) <= 5e-2 * wk + 1e-7, (gk, wk)
        assert abs(g1 - w1) <= 1 / 128 + 1e-12, (g1, w1)
    for (gp, _, _), (wp, _, _) in zip(tw[1:], jw[1:]):
        gd, wd = gp - tw[0][0], wp - jw[0][0]
        assert abs(gd - wd) <= 0.35 * abs(wd), (gd, wd)
    for g, (gp, gk, g1) in zip(got, tw[1:]):  # the rows are the unrounded values, rounded
        assert (g["ppl"], g["dppl"], g["kl"], g["top1"]) == \
            (round(gp, 4), round(gp - tw[0][0], 4), round(gk, 6), round(g1, 4))
    for m in (jw, tw):  # the ordering the ladder exists to show
        assert m[3][1] > m[2][1] > m[1][1] > 0
    assert abs(got[0]["dppl"]) < 1.0  # q8_0 is near-lossless (tests/test_quantize_tool.py)
    assert (tmp_path / "r.json").exists()


def test_window_metrics_equal_reference_on_the_same_logits(tmp_path, monkeypatch):
    """Both ``window_metrics`` on identical logits (each engine replaced by
    a seeded table: a window's logits are rows picked by its tokens) give
    the same ppl, KL and top-1 bit for bit: the f16 store, its
    renormalization, KL(base || q) averaged over the scored positions."""
    import jax
    import jax.numpy as jnp

    import tpu_kquant.runtime as j_runtime
    import tpu_kquant_torch.runtime.engine as t_engine
    import tpu_kquant_torch.runtime.loader as t_loader
    import tpu_kquant_torch.tools.perplexity as t_perplexity

    V, ctx = 96, 16
    rng = np.random.default_rng(3)
    base = (rng.standard_normal((V, V)) * 3).astype(np.float32)
    table = {"base": base, "q": base + (rng.standard_normal((V, V)) * 0.2).astype(np.float32)}
    ids = rng.integers(0, V, 3 * ctx + 5).tolist()

    class Reader:
        def close(self):
            pass

    class Cfg:
        vocab_size = V

    class JEngineStub:
        def __init__(self, cfg, params, **kw):
            self.params = params

        def new_cache(self, b):
            return None

        def _step(self, params, toks, pos, cache, flag):
            return jnp.asarray(table[params][np.asarray(toks)]), cache

    def load(path, **kw):
        return Cfg(), path, Reader()

    def t_window_logprobs(eng, toks):
        lp = jax.nn.log_softmax(jnp.asarray(table[eng.params][np.asarray(toks)]), axis=-1)
        return torch.from_numpy(np.array(lp))

    monkeypatch.setattr(j_runtime, "InferenceEngine", JEngineStub)
    monkeypatch.setattr(j_runtime, "load_model", load)
    monkeypatch.setattr(t_engine, "InferenceEngine", JEngineStub)
    monkeypatch.setattr(t_loader, "load_model", load)
    monkeypatch.setattr(t_perplexity, "window_logprobs", t_window_logprobs)
    jb = j_ppl_delta.window_metrics("base", ids, ctx, None, "xla")
    tb = t_ppl_delta.window_metrics("base", ids, ctx, None, "auto", device="cpu")
    jq = j_ppl_delta.window_metrics("q", ids, ctx, None, "xla", base_lp=jb[3])
    tq = t_ppl_delta.window_metrics("q", ids, ctx, None, "auto", base_lp=tb[3], device="cpu")
    assert jb[:3] == tb[:3] and jb[1:3] == (0.0, 1.0)
    assert jq[:3] == tq[:3]
    # KL(base || q), a mean over the 3 x 16 positions, against a sum here
    lb = np.concatenate([jb[3].get(w) for w in range(3)])
    lq = np.asarray(jax.nn.log_softmax(jnp.asarray(table["q"][np.asarray(ids[:3 * ctx])]), -1))
    fwd = (np.exp(lb) * (lb - lq)).sum(-1).mean()
    rev = (np.exp(lq) * (lq - lb)).sum(-1).mean()
    assert abs(tq[1] - fwd) <= 1e-6 * fwd < abs(rev - fwd)
    assert tq[2] == (lb.argmax(-1) == lq.argmax(-1)).mean()
    jb[3].close()
    tb[3].close()
