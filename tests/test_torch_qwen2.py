"""The port's Qwen2 path on the CPU against the JAX package.

A tiny Qwen2 written by the JAX package's fixture writer: 2 layers, dim 512,
4 query heads and 2 KV heads of 128, ffn 256, vocab 512, q/k/v biases, with
and without a tied lm head. Its attention width H * hd = 512 fails
oproj_ffn's K % 1024 gate while the ffn gate passes, as at Qwen2.5-1.5B
(1536), so decode rows run attn_in with biases, an o_proj qmatmul and the
ffn kernel's plain version; prefill past 32 rows runs the qmatmuls with the
biases added after them (f32 from there on, as in the reference).

Inputs are made by numpy from a seed and handed to both packages. The
tolerance of each comparison is stated where it is made.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops.pallas_attn_in import fused_attn_in as j_fused_attn_in
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.ops.pallas_ffn import ffn_supported as j_ffn_supported
from tpu_kquant.ops.pallas_ffn import fused_ffn as j_fused_ffn
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime.kv_cache import KVCache as JKVCache
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import prefill as t_prefill
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.kv_cache import KVCache
from tpu_kquant_torch.runtime.loader import load_model, params_from_numpy

torch.set_num_threads(1)

QWEN = dict(arch="qwen2", n_layers=2, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=256,
            vocab_size=512, max_seq_len=128)
# The writers draw the biases at the weights' scale (0.05), about 4% of a
# q/k value at dim 512; the engine fixture scales them up to q/k/v's own
# size (real Qwen2 k biases are large), so that a fault in the bias path
# moves the logits past the comparisons' tolerance.
BIAS_GAIN = 20.0
PROMPTS = {n: [int(t) for t in np.random.default_rng(n).integers(3, 512, n)] for n in (8, 40)}


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


def _plain_calls() -> dict:
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


def _same_biases(jl, tl) -> None:
    """The reference layer's bq / bk / bv against the port's bqk / bv, bit
    for bit."""
    for got, want in ((tl["bqk"], np.concatenate([np.asarray(jl["bq"]), np.asarray(jl["bk"])])),
                      (tl["bv"], np.asarray(jl["bv"]))):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """{tied: (jax cfg, jax params, jax engine, port cfg, port params, port
    engine, path)} for the tiny Qwen2, untied and tied; both packages'
    biases scaled by BIAS_GAIN."""
    out = {}
    for tied in (False, True):
        cfg = dataclasses.replace(tiny_config(**QWEN), tie_embeddings=tied)
        path = tmp_path_factory.mktemp("qwen2") / f"qwen2-tied{int(tied)}.gguf"
        write_fixture_gguf(path, cfg, seed=5, quant="q4_k_m", scale=0.05)
        jc, jp, _ = jload(str(path), scale_dtype="bf16")
        tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
        for jl, tl in zip(jp["layers"], tp["layers"]):
            for b in ("bq", "bk", "bv"):
                jl[b] = jl[b] * BIAS_GAIN
            for b in ("bqk", "bv"):
                tl[b] = tl[b] * BIAS_GAIN
        out[tied] = (jc, jp, JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla"),
                     tc, tp, InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu"), path)
    return out


# -- config and fixture --------------------------------------------------------


def test_tiny_config_mirrors_reference():
    from tpu_kquant.models.fixtures import tiny_config as j_tiny

    got, want = t_fixtures.tiny_config(**QWEN), j_tiny(**QWEN)
    for f in ("arch", "n_layers", "dim", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "max_seq_len", "norm_eps", "tie_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rope.mode == want.rope.mode == "neox" and got.attn_bias


def test_qwen2_5_1_5b_preset_round_trips_both_packages():
    """The preset's GGUF metadata reads back to the same shapes in the port
    and in the reference (which parses qwen2 as NEOX rope)."""
    from tpu_kquant.models.config import ModelConfig as JModelConfig

    cfg = t_fixtures.qwen2_5_1_5b_config()
    assert (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
            cfg.vocab_size) == (28, 1536, 12, 2, 128, 8960, 151936)
    assert cfg.n_heads * cfg.head_dim % 1024 != 0  # oproj_ffn's gate fails
    md = cfg.to_gguf_metadata()
    for back in (ModelConfig.from_gguf(md), JModelConfig.from_gguf(md)):
        assert (back.arch, back.dim, back.n_heads, back.n_kv_heads, back.head_dim,
                back.ffn_dim, back.vocab_size, back.max_seq_len) == \
            ("qwen2", 1536, 12, 2, 128, 8960, 151936, 32768)
        assert back.rope.mode == "neox" and back.rope.freq_base == 1e6
        assert back.norm_eps == pytest.approx(1e-6)


@pytest.mark.parametrize("tied", [False, True])
def test_port_fixture_writer_qwen2_inventory(tmp_path, tied):
    """The port's writer: F32 biases, no output.weight when tied, the tied
    token_embd Q4_K; both loaders read the same biases from its file."""
    from tpu_kquant_torch.gguf import GGMLType, GGUFReader

    cfg = dataclasses.replace(t_fixtures.tiny_config(**QWEN), tie_embeddings=tied)
    path = t_fixtures.write_fixture_gguf(tmp_path / "q.gguf", cfg, seed=2)
    r = GGUFReader(path)
    assert ("output.weight" in r.tensors) == (not tied)
    assert r.tensors["token_embd.weight"].ggml_type == GGMLType.Q4_K
    assert r.tensors["blk.0.attn_output.weight"].ggml_type == GGMLType.Q6_K
    for nm, n in (("attn_q.bias", 512), ("attn_k.bias", 256), ("attn_v.bias", 256)):
        ti = r.tensors[f"blk.1.{nm}"]
        assert ti.ggml_type == GGMLType.F32 and tuple(ti.shape) == (n,)
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
    assert jc.attn_bias and tc.attn_bias
    _same_biases(jp["layers"][1], tp["layers"][1])


# -- loader --------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
def test_loader_biases_and_lm_head_match_jax(qwen, tied):
    jc, jp, _, tc, tp, _, _ = qwen[tied]
    assert tc.arch == "qwen2" and tc.attn_bias and jc.attn_bias
    assert tc.rope.mode == jc.rope.mode == "neox"
    for jl, tl in zip(jp["layers"], tp["layers"]):
        _same_biases(jl, tl)
    jo, to = jp["output"], tp["output"]
    assert (to.kind, to.layout, tuple(to.shape)) == (jo.kind, jo.layout, tuple(jo.shape))
    assert to.kind == ("q4" if tied else "q6w")  # the tied token_embd stays Q4_K
    for k in jo.arrays:
        np.testing.assert_array_equal(to.arrays[k].numpy().view(np.uint8),
                                      np.asarray(jo.arrays[k]).view(np.uint8))


def test_params_from_numpy_fuses_the_reference_biases(qwen):
    """The reference's params exported as numpy: each layer's bq / bk
    become the port's bqk, as the port's loader makes it from the file."""
    path = qwen[True][6]
    _, pj, _ = jload(str(path), scale_dtype="bf16")
    _, pt, _ = load_model(str(path), scale_dtype="bf16", device="cpu")

    def export(v):
        if isinstance(v, dict):
            return {k: export(x) for k, x in v.items()}
        if isinstance(v, list):
            return [export(x) for x in v]
        if hasattr(v, "arrays"):
            return {"kind": v.kind, "layout": v.layout, "shape": v.shape,
                    "arrays": {k: np.asarray(a) for k, a in v.arrays.items()}}
        return np.asarray(v)

    got = params_from_numpy(export(pj), "cpu")
    for jl, gl, tl in zip(pj["layers"], got["layers"], pt["layers"]):
        assert set(gl) == set(tl) and "bq" not in gl
        _same_biases(jl, gl)
        _same_biases(jl, tl)


# -- kernels' plain versions against the Pallas kernels ----------------------------


@pytest.mark.parametrize("R", [1, 4])
def test_ffn_plain_matches_pallas_fused_ffn(R):
    """fused_ffn in interpret mode on the same q4-sm / q6w-sp bytes; 3e-2 of
    max|ref|, the tolerance tests/test_pallas_ffn.py and the oproj_ffn
    sibling (tests/test_torch_kernels.py) use: interpret mode runs f32 dots
    where the TPU's MXU rounds to bf16."""
    rng = np.random.default_rng(20 + R)
    D, Fd = 512, 512
    gu, dn = mk_q4(2 * Fd, D, rng), mk_q6w(D, Fd, rng)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    ref = np.asarray(j_fused_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-6, gu, dn,
                                 interpret=True), np.float32)
    c = t_ffn.ffn_counter
    plain, launches = c.plain_calls, c.launches
    got = t_ffn.fused_ffn(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(nw), 1e-6,
                          _port(gu), _port(dn))
    assert c.plain_calls == plain + 1 and c.launches == launches
    assert got.dtype == torch.bfloat16 and got.shape == (R, D)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_ffn_gate_matches_reference():
    rng = np.random.default_rng(0)
    for D, Fd, rows in ((512, 256, 1), (512, 512, 32), (512, 256, 33), (1024, 640, 1),
                        (1536, 8960, 1), (640, 512, 1)):
        gu, dn = mk_q4(2 * Fd, D, rng), mk_q6w(D, Fd, rng)
        assert t_ffn.ffn_supported(_port(gu), _port(dn), rows) == \
            j_ffn_supported(gu, dn, rows), (D, Fd, rows)


def test_ffn_wrapper_raises_off_the_cpu():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    the kernel or raises (here: a meta tensor, which no kernel takes)."""
    rng = np.random.default_rng(1)
    gu, dn = _port(mk_q4(512, 512, rng)), _port(mk_q6w(512, 256, rng))
    with pytest.raises(ValueError, match="device"):
        t_ffn.fused_ffn(torch.empty(1, 512, dtype=torch.bfloat16, device="meta"),
                        torch.ones(512), 1e-6, gu, dn)


@pytest.mark.parametrize("R", [1, 3])
def test_attn_in_plain_with_biases_matches_pallas_grid_kernel(R):
    """Biases go through the Mosaic-grid kernel's epilogue (round to bf16,
    add the f32 bias, rope, cast), at head_dim 128; 3e-2 of max|ref|, the
    tolerance of tests/test_pallas_attn_in.py and the port's attn_in test."""
    rng = np.random.default_rng(30 + R)
    D, hd, H, Hkv = 512, 128, 4, 2
    wqk, wv = mk_q4((H + Hkv) * hd, D, rng), mk_q6w(Hkv * hd, D, rng)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos = rng.random((R, hd // 2)).astype(np.float32)
    sin = rng.random((R, hd // 2)).astype(np.float32)
    bqk = (rng.standard_normal((H + Hkv) * hd) * 0.5).astype(np.float32)
    bv = (rng.standard_normal(Hkv * hd) * 0.5).astype(np.float32)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd)
    o0, o1 = j_fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-6, [wqk, wv],
                             cf, sf, hd // 2, biases=[jnp.asarray(bqk), jnp.asarray(bv)],
                             interpret=True)
    biases = (torch.from_numpy(bqk), torch.from_numpy(bv))
    assert t_attn_in.attn_in_supported(_port(wqk), _port(wv), R, D, hd, biases)
    g0, g1 = t_attn_in.fused_attn_in(torch.from_numpy(x).to(torch.bfloat16),
                                     torch.from_numpy(nw), 1e-6, _port(wqk), _port(wv),
                                     torch.from_numpy(cos), torch.from_numpy(sin), hd, biases)
    for got, ref in ((g0, o0), (g1, o1)):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())
    # the biases matter at this scale: without them the outputs move past it
    n0, _ = t_attn_in.attn_in_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(nw),
                                    1e-6, _port(wqk), _port(wv), torch.from_numpy(cos),
                                    torch.from_numpy(sin), hd)
    assert np.abs(n0.float().numpy() - np.asarray(o0, np.float32)).max() > \
        3e-2 * np.abs(np.asarray(o0, np.float32)).max()


def test_attn_in_gate_checks_biases():
    rng = np.random.default_rng(2)
    wqk, wv = _port(mk_q4(768, 512, rng)), _port(mk_q6w(256, 512, rng))
    ok = (torch.zeros(768), torch.zeros(256))
    assert t_attn_in.attn_in_supported(wqk, wv, 1, 512, 128, ok)
    assert not t_attn_in.attn_in_supported(wqk, wv, 1, 512, 128, (torch.zeros(512), ok[1]))
    assert not t_attn_in.attn_in_supported(wqk, wv, 1, 512, 128,
                                           (ok[0].to(torch.bfloat16), ok[1]))


# -- the engine end to end -----------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("n", [8, 40])
def test_prefill_logits_match_jax(qwen, tied, n):
    """Prefill of 8 tokens (bucket 16: the fused plain versions, bf16 q/k/v)
    and 40 tokens (bucket 64: qmatmuls, biases added in f32, f32 residual
    stream in both packages); logits within 5e-2 of max|ref| (the port's
    llama tests' tolerance) and the same argmax. The JAX engine on the CPU
    runs impl="xla", its unfused path, at every row count."""
    _, _, je, _, _, te, _ = qwen[tied]
    prompt = PROMPTS[n]
    lj, _, _ = je.prefill([prompt], je.new_cache(1))
    before = _plain_calls()
    lt, _, _ = te.prefill([prompt], te.new_cache(1))
    used = {k: v - before[k] for k, v in _plain_calls().items()}
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    fused = n == 8
    assert used["attn_in"] == used["ffn"] == (2 if fused else 0)
    assert used["oproj_ffn"] == 0
    assert used["qmm"] == (2 + 1 if fused else 5 * 2 + 1)


@pytest.mark.parametrize("n", [8, 40])
def test_prefill_logits_comparison_fails_without_biases(qwen, n):
    """Planted fault: the port's biases zeroed. The comparison of
    test_prefill_logits_match_jax must then fail, at 8 tokens (attn_in's
    bias epilogue) and at 40 (the bias add after the unfused qmatmuls)."""
    _, _, je, tc, tp, _, _ = qwen[False]
    layers = [{**lay, "bqk": torch.zeros_like(lay["bqk"]), "bv": torch.zeros_like(lay["bv"])}
              for lay in tp["layers"]]
    te = InferenceEngine(tc, {**tp, "layers": layers}, max_batch=1, max_seq=64, device="cpu")
    lj, _, _ = je.prefill([PROMPTS[n]], je.new_cache(1))
    lt, _, _ = te.prefill([PROMPTS[n]], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("n", [8, 40])
def test_greedy_tokens_match_jax(qwen, tied, n):
    """Greedy generation of 8 tokens, the same ids. The port's decode runs
    the fused plain versions with bf16 q/k/v, as the reference does on the
    TPU (fused attn_in); the JAX engine on the CPU runs the unfused path,
    where the bias add makes q/k/v and the residual f32. The two differ by
    bf16 roundings (about 4e-3 of a logit's scale), far inside the margins
    between this random model's top logits."""
    _, _, je, _, _, te, _ = qwen[tied]
    prompt = PROMPTS[n][:n]
    assert te.generate([prompt], max_new_tokens=8) == je.generate([prompt], max_new_tokens=8)


def test_decode_dispatch_runs_ffn_not_oproj_ffn(qwen):
    """Per decode step at the tiny Qwen2: attn_in and ffn once per layer,
    oproj_ffn never; qmm for each o_proj and the lm head."""
    _, _, _, _, _, te, _ = qwen[False]
    logits, cache, lens = te.prefill([PROMPTS[8]], te.new_cache(1))
    before = _plain_calls()
    pos = torch.tensor(lens)
    for t in (7, 99, 300):
        logits, cache = te.decode_step(torch.tensor([t]), pos, cache)
        pos = pos + 1
    used = {k: v - before[k] for k, v in _plain_calls().items()}
    assert used["attn_in"] == used["ffn"] == 3 * 2
    assert used["oproj_ffn"] == 0 and used["qmm"] == 3 * (2 + 1)


def test_llama_dispatch_runs_oproj_ffn_not_ffn(tmp_path):
    """The reverse at the dim-1024 llama fixture of tests/test_torch_model.py
    (attention width 1024 passes oproj_ffn's gate)."""
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512, max_seq_len=128)
    path = write_fixture_gguf(tmp_path / "w1024.gguf", cfg, seed=3, quant="q4_k_m", scale=0.05)
    tc, tp, _ = load_model(path, scale_dtype="bf16", device="cpu")
    te = InferenceEngine(tc, tp, max_seq=64, device="cpu")
    logits, cache, lens = te.prefill([PROMPTS[8]], te.new_cache(1))
    before = _plain_calls()
    te.decode_step(torch.tensor([7]), torch.tensor(lens), cache)
    used = {k: v - before[k] for k, v in _plain_calls().items()}
    assert used["oproj_ffn"] == used["attn_in"] == 2
    assert used["ffn"] == 0 and used["qmm"] == 1


def test_long_prompt_flash_plain_takes_f32_q(qwen, monkeypatch):
    """With the logits budget at 0, a 40-token prompt (bucket 64) sends each
    layer's f32 q (bf16 + f32 bias) to the flash prefill's plain version,
    which rounds q to bf16 as the kernel does and returns f32; the logits
    match the plain attention's under the real budget within 2e-2 of
    max|ref| (tests/test_torch_prefill.py's tolerance for the two)."""
    _, _, _, _, _, te, _ = qwen[False]
    seen = []
    real = t_prefill.attention_prefill_plain

    def spy(q, *a, **kw):
        seen.append(q.dtype)
        out = real(q, *a, **kw)
        assert out.dtype == q.dtype
        return out

    ref, _, _ = te.prefill([PROMPTS[40]], te.new_cache(1))
    monkeypatch.setattr(t_prefill, "attention_prefill_plain", spy)
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
    c = t_prefill.counter
    plain = c.plain_calls
    got, _, _ = te.prefill([PROMPTS[40]], te.new_cache(1))
    assert c.plain_calls == plain + 2 and seen == [torch.float32] * 2
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("quantized", [False, True])
def test_f32_appends_round_like_jax_cache(quantized):
    """The unfused path hands the cache f32 k/v; both caches round them the
    same way (bf16: round to nearest even; int8: scales and codes from the
    f32 rows), byte for byte."""
    rng = np.random.default_rng(8 + quantized)
    L, B, S, Hkv, D = 2, 1, 16, 2, 128
    kn, vn = ((rng.standard_normal((B, 5, Hkv, D)) * 2).astype(np.float32) for _ in range(2))
    pos = np.arange(3, 8, dtype=np.int32)[None]
    jc = JKVCache.create(L, B, S, Hkv, D, quantized=quantized).append(
        1, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    tc = KVCache.create(L, B, S, Hkv, D, device="cpu", quantized=quantized).append(
        1, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pos).long())
    pairs = [(tc.k, jc.k), (tc.v, jc.v)]
    if quantized:
        pairs += [(tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy() if got.dtype == torch.bfloat16
                                      else got.numpy(), want.view(np.uint8)
                                      if want.dtype.itemsize == 2 else want)
