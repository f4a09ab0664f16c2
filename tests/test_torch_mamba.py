"""The recurrent family (mamba) in the port on the CPU against the JAX package.

Fixtures: tiny mambas of 2 layers written by the JAX writer, at dim 64
(d_inner 128, dt_rank 4: ``ssm_dt`` F16, a dense weight; the other matmuls
Q8_0) and at dim 512 (d_inner 1024, dt_rank 32: ``ssm_dt`` Q8_0 at K = 32,
one scale group, so the bf16 load keeps its f32 scales; the rest Q4_K and
the lm head Q6_K). The writer draws every weight with std ``scale``; at its
default 0.05 a tiny mamba's logits do not depend on the tokens before the
last one (the SSM's output is ~1e-4 of the residual stream), which would
leave the state checks below blind, so the fixtures draw at 0.3 (dim 64)
and 0.2 (dim 512) and ``test_fixtures_depend_on_history`` holds them to it.

Checked: the configs and the writer's inventory; every loaded array byte for
byte (bf16 and f32 scales); ``mamba_forward``'s logits and final conv / ssm
states on one set of weights (the JAX params carried by ``params_from_numpy``)
with a right-padded batch; the engine's greedy tokens, sessions, slot
prefill and serving against the JAX engine and against solo runs; the
refusals both packages share (iSWA, int8 KV, context shift) and the port's
refusal of speculative decoding, with the reference's fault it answers; the
CLIs with ``--device cpu``. Tolerances are stated where they are used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.gguf import GGUFReader as JReader
from tpu_kquant.models import mamba as j_mamba
from tpu_kquant.models.config import ModelConfig as JModelConfig
from tpu_kquant.models.fixtures import tiny_mamba_config as j_tiny_mamba_config
from tpu_kquant.models.fixtures import write_fixture_gguf as j_write_fixture
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime.speculative import generate_speculative as j_generate_speculative
from tpu_kquant.serving.scheduler import ContinuousBatcher as JBatcher
from tpu_kquant.serving.scheduler import Request as JRequest
from tpu_kquant_torch.gguf import GGUFReader
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.models import mamba as t_mamba
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.runtime import speculative as t_speculative
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model, params_from_numpy
from tpu_kquant_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(1)

# (dim, writer scale) of the two fixtures; both seed 0, 2 layers, vocab 512
FIXTURES = {64: 0.3, 512: 0.2}
PROMPTS = [[3, 77, 200, 145, 9, 411, 32], [8, 12, 400]]
# the port against the JAX package: their bf16 roundings of the same f32
# sums differ (XLA's dot against the port's dequant-then-matmul), ~7e-3 of
# max|ref| in these fixtures' logits and states
TOL = 2e-2


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mamba")
    out = {}
    for dim, scale in FIXTURES.items():
        out[dim] = str(d / f"m{dim}.gguf")
        j_write_fixture(out[dim], j_tiny_mamba_config(dim=dim), seed=0, scale=scale)
    return out


@pytest.fixture(scope="module")
def models(paths):
    """Per dim: (JAX engine, port engine), both of 2 rows on 96 slots."""
    out = {}
    for dim, path in paths.items():
        jc, jp, _ = jload(path, scale_dtype="bf16")
        tc, tp, _ = load_model(path, device="cpu")
        out[dim] = (JEngine(jc, jp, max_batch=2, max_seq=96),
                    InferenceEngine(tc, tp, max_batch=2, max_seq=96, device="cpu"))
    return out


def _plain_calls() -> dict:
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


# -- configs, fixtures, loader ------------------------------------------------------


def test_configs_match_the_reference():
    """tiny_mamba_config is the reference's; Mamba-2.8B's metadata reads back
    to itself in both packages (64 layers, d_model 2560, d_inner 5120,
    d_state 16, d_conv 4, dt_rank 160, vocab 50280)."""
    for kw in ({}, {"dim": 512}, {"dim": 2560, "n_layers": 3}):
        j, t = j_tiny_mamba_config(**kw), t_fixtures.tiny_mamba_config(**kw)
        for f in ("arch", "n_layers", "dim", "vocab_size", "max_seq_len", "norm_eps",
                  "ssm_d_conv", "ssm_d_inner", "ssm_d_state", "ssm_dt_rank"):
            assert getattr(t, f) == getattr(j, f), (kw, f)
        assert t.is_recurrent and j.is_recurrent
    cfg = t_fixtures.mamba_2_8b_config()
    assert (cfg.n_layers, cfg.dim, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv,
            cfg.ssm_dt_rank, cfg.vocab_size, cfg.max_seq_len) == (64, 2560, 5120, 16, 4, 160,
                                                                 50280, 2048)
    assert cfg.tie_embeddings
    md = cfg.to_gguf_metadata()
    assert md == JModelConfig.to_gguf_metadata(j_tiny_mamba_config(
        n_layers=64, dim=2560, vocab_size=50280, max_seq_len=2048))
    for back in (ModelConfig.from_gguf(md), JModelConfig.from_gguf(md)):
        for f in ("arch", "n_layers", "dim", "vocab_size", "max_seq_len", "ssm_d_conv",
                  "ssm_d_inner", "ssm_d_state", "ssm_dt_rank"):
            assert getattr(back, f) == getattr(cfg, f), f
        assert back.norm_eps == pytest.approx(1e-5) and back.is_recurrent


def test_config_from_a_file_matches_the_reference(paths):
    md = GGUFReader(paths[512]).metadata
    got = dataclasses.asdict(ModelConfig.from_gguf(md))
    want = dataclasses.asdict(JModelConfig.from_gguf(md))
    want.pop("moe_impl")
    assert got == want


@pytest.mark.parametrize("dim,tied", [(64, True), (512, False), (2560, True)])
def test_port_writer_writes_the_reference_inventory(tmp_path, dim, tied):
    """The port's writer gives a mamba the reference writer's tensors: names,
    shapes and GGML types in order (ssm_dt F16 at dt_rank 4, Q8_0 at 32 and
    160), the side arrays F32; a tied config writes no output.weight. (At
    dim 64 an untied lm head differs: the reference's writer gives
    ``output.weight`` Q6_K at any K, the quantize tool's recipe, which the
    port's writer follows for every arch, Q8_0 where 256 does not divide K.)"""
    kw = dict(n_layers=1, dim=dim, vocab_size=512)
    cfgs = [dataclasses.replace(c(**kw), tie_embeddings=tied)
            for c in (t_fixtures.tiny_mamba_config, j_tiny_mamba_config)]
    t_fixtures.write_fixture_gguf(tmp_path / "t.gguf", cfgs[0])
    j_write_fixture(tmp_path / "j.gguf", cfgs[1])
    inv = [[(n, tuple(ti.shape), int(ti.ggml_type)) for n, ti in r(str(tmp_path / f)).tensors.items()]
           for r, f in ((GGUFReader, "t.gguf"), (JReader, "j.gguf"))]
    assert inv[0] == inv[1]
    types = {n: t for n, _, t in inv[0]}
    assert types["blk.0.ssm_dt.weight"] == {64: 1, 512: 8, 2560: 8}[dim]  # F16, Q8_0
    assert types["blk.0.ssm_a"] == types["blk.0.ssm_conv1d.weight"] == 0  # F32
    assert ("output.weight" in types) == (not tied)


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("dim", [64, 512])
def test_fixture_loads_to_the_same_bytes(paths, dim, scale_dtype):
    """Both loaders read a mamba to the same arrays, byte for byte: every
    packed weight (its kind, shape and side arrays; at dim 512 ssm_dt is
    q8 on f32 scales under either scale_dtype: one group), the dense F16
    ssm_dt at dim 64, the norms and the f32 side arrays."""
    _, jp, _ = jload(paths[dim], scale_dtype=scale_dtype)
    _, tp, _ = load_model(paths[dim], scale_dtype=scale_dtype, device="cpu")

    def same(t, j, what):
        if hasattr(j, "arrays"):
            assert t.kind == j.kind and t.layout == j.layout, what
            assert tuple(t.shape) == tuple(j.shape), what
            assert set(t.arrays) == set(j.arrays), what
            for k, v in j.arrays.items():
                np.testing.assert_array_equal(t.arrays[k].numpy(), np.asarray(v), (what, k))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), what)

    for k in ("tok_embd", "output_norm", "output"):
        same(tp[k], jp[k], k)
    for i, (tl, jl) in enumerate(zip(tp["layers"], jp["layers"])):
        assert set(tl) == set(jl) == {"attn_norm", "ssm_in", "ssm_x", "ssm_dt", "ssm_out",
                                      "conv_w", "conv_b", "dt_b", "A_log", "Dd"}
        for k in tl:
            same(tl[k], jl[k], (i, k))
    dt = tp["layers"][0]["ssm_dt"]
    assert (dt.kind, sorted(dt.arrays)) == ({64: ("dense", ["w"]), 512: ("q8", ["qs", "scales"])}
                                            [dim])


# -- the forward ---------------------------------------------------------------------


def _export(v):
    """The JAX package's params as numpy (QTensors as dicts)."""
    if isinstance(v, dict):
        return {k: _export(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_export(x) for x in v]
    if hasattr(v, "arrays"):
        return {"kind": v.kind, "layout": v.layout, "shape": v.shape,
                "arrays": {k: np.asarray(a) for k, a in v.arrays.items()}}
    return np.asarray(v)


@pytest.mark.parametrize("dim", [64, 512])
def test_fixtures_depend_on_history(models, dim):
    """The last logits of two prompts that end in the same two tokens differ
    by more than 0.1 of max|logits| in both packages: the state matters."""
    je, te = models[dim]
    a, b = [5, 6, 7, 8, 9], [50, 60, 70, 8, 9]
    for eng in (te, je):
        la = np.asarray(eng.prefill([a], eng.new_cache(1))[0], np.float32)
        lb = np.asarray(eng.prefill([b], eng.new_cache(1))[0], np.float32)
        assert _rel(la, lb) > 0.1


@pytest.mark.parametrize("dim", [64, 512])
def test_forward_matches_reference(paths, dim):
    """mamba_forward on the JAX loader's weights (params_from_numpy) against
    the reference's on a right-padded batch (rows of 7 and 3 tokens in 8
    steps) from a nonzero state, then one decode step: the logits of every
    valid step and the final conv and ssm states within TOL of max|ref|; a
    padded row's state is its unpadded run's."""
    jc, jp, _ = jload(paths[dim], scale_dtype="bf16")
    tp = params_from_numpy(_export(jp), "cpu")
    tc = ModelConfig.from_gguf(GGUFReader(paths[dim]).metadata)
    rng = np.random.default_rng(dim)
    L, B, T = tc.n_layers, 2, 8
    conv0 = (rng.standard_normal((L, B, tc.ssm_d_conv - 1, tc.ssm_d_inner)) * 0.5).astype(np.float32)
    ssm0 = (rng.standard_normal((L, B, tc.ssm_d_inner, tc.ssm_d_state)) * 0.5).astype(np.float32)
    toks = rng.integers(3, tc.vocab_size, (B, T))
    valid = np.arange(T)[None, :] < np.array([[7], [3]])
    jcache = j_mamba.RecurrentCache(jnp.asarray(conv0), jnp.asarray(ssm0))
    tcache = t_mamba.RecurrentCache(torch.from_numpy(conv0.copy()), torch.from_numpy(ssm0.copy()))
    pos = np.tile(np.arange(T), (B, 1))
    jl, jcache = j_mamba.mamba_forward(jp, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                                       jcache, kv_valid=jnp.asarray(valid))
    before = _plain_calls()
    tl, tcache = t_mamba.mamba_forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos),
                                       tcache, kv_valid=torch.from_numpy(valid))
    # 4 packed matmuls a layer and the lm head (dim 64: ssm_dt is dense)
    assert _plain_calls()["qmm"] - before["qmm"] == (4 if dim == 512 else 3) * L + 1
    jl = np.asarray(jl, np.float32)
    for b in range(B):
        assert _rel(tl[b][valid[b]].numpy(), jl[b][valid[b]]) < TOL
    assert _rel(tcache.conv.numpy(), np.asarray(jcache.conv)) < TOL
    assert _rel(tcache.ssm.numpy(), np.asarray(jcache.ssm)) < TOL
    # row 1 alone, unpadded, from its own start state: the same state, bit for bit
    one = t_mamba.RecurrentCache(torch.from_numpy(conv0[:, 1:].copy()),
                                 torch.from_numpy(ssm0[:, 1:].copy()))
    t_mamba.mamba_forward(tp, tc, torch.from_numpy(toks[1:, :3]), torch.from_numpy(pos[1:, :3]),
                          one)
    assert torch.equal(one.conv, tcache.conv[:, 1:]) and torch.equal(one.ssm, tcache.ssm[:, 1:])
    # one decode step from there, logits of the last row only
    step = rng.integers(3, tc.vocab_size, (B, 1))
    jl, jcache = j_mamba.mamba_forward(jp, jc, jnp.asarray(step, jnp.int32),
                                       jnp.zeros((B, 1), jnp.int32), jcache,
                                       logits_last_only=True)
    tl, tcache = t_mamba.mamba_forward(tp, tc, torch.from_numpy(step), torch.zeros(B, 1), tcache,
                                       logits_last_only=True)
    assert tl.shape == (B, 1, tc.vocab_size)
    assert _rel(tl.numpy(), np.asarray(jl)) < TOL
    assert _rel(tcache.ssm.numpy(), np.asarray(jcache.ssm)) < TOL


def test_pad_steps_and_frozen_rows_keep_their_state(models):
    """A decode step with valid False leaves that row's conv and ssm state
    bit for bit, and the valid row's state and logits equal a step without
    a mask (serving's frozen rows)."""
    _, te = models[512]
    _, cache, lens = te.prefill(PROMPTS, te.new_cache(2))
    ref = t_mamba.RecurrentCache(cache.conv.clone(), cache.ssm.clone())
    tok = torch.tensor([11, 12])
    lg, masked = te.decode_step(tok, torch.tensor(lens), t_mamba.RecurrentCache(
        cache.conv.clone(), cache.ssm.clone()), valid=torch.tensor([True, False]))
    lp, plain = te.decode_step(tok, torch.tensor(lens), cache)
    assert torch.equal(masked.conv[:, 1], ref.conv[:, 1]) and torch.equal(masked.ssm[:, 1],
                                                                           ref.ssm[:, 1])
    assert torch.equal(masked.conv[:, 0], plain.conv[:, 0])
    assert torch.equal(masked.ssm[:, 0], plain.ssm[:, 0]) and torch.equal(lg[0], lp[0])


@pytest.mark.parametrize("chunk_steps", [1, 3, 7])
def test_scan_chunks_give_the_unchunked_bits(models, monkeypatch, chunk_steps):
    """mamba_layer_scan over a right-padded 2-row call of 20 steps, its
    steps taken in chunks of `chunk_steps` (SCAN_CHUNK_ELEMS lowered): the
    output and both states equal the one-chunk call's, bit for bit."""
    _, te = models[512]
    cfg, lay = te.cfg, te.params["layers"][0]
    di, ds, dc = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(2, 20, cfg.dim, generator=gen) * 0.3).to(torch.bfloat16)
    conv = torch.randn(2, dc - 1, di, generator=gen)
    ssm = torch.randn(2, di, ds, generator=gen)
    valid = torch.ones(2, 20, dtype=torch.bool)
    valid[1, 13:] = False
    whole = t_mamba.mamba_layer_scan(lay, cfg, x, conv, ssm, valid)
    monkeypatch.setattr(t_mamba, "SCAN_CHUNK_ELEMS", chunk_steps * 2 * di * ds)
    chunked = t_mamba.mamba_layer_scan(lay, cfg, x, conv, ssm, valid)
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))


# -- the engine ----------------------------------------------------------------------


@pytest.mark.parametrize("dim", [64, 512])
def test_engine_matches_jax(models, dim):
    """A right-padded batched prefill's last logits and states within TOL of
    the JAX engine's, greedy generation token for token, a row's logits
    equal alone and in the batch within 1e-5 of max|ref|, and prefill then
    one decode step equal to the one-shot prefill of the longer prompt
    (the reference's test_chunked_prefill_equals_oneshot, 2e-2)."""
    je, te = models[dim]
    jl, jcache, jlens = je.prefill(PROMPTS, je.new_cache(2))
    tl, tcache, tlens = te.prefill(PROMPTS, te.new_cache(2))
    assert list(tlens) == list(jlens)
    assert _rel(tl.numpy(), np.asarray(jl)) < TOL
    assert _rel(tcache.ssm.numpy(), np.asarray(jcache.ssm)) < TOL
    assert _rel(tcache.conv.numpy(), np.asarray(jcache.conv)) < TOL
    assert te.generate(PROMPTS, max_new_tokens=12) == je.generate(PROMPTS, max_new_tokens=12)
    alone, _, _ = te.prefill([PROMPTS[1]], te.new_cache(1))
    assert _rel(alone[0].numpy(), tl[1].numpy()) < 1e-5
    ids = PROMPTS[0] + [18]
    one, _, _ = te.prefill([ids], te.new_cache(1))
    _, cache, lens = te.prefill([ids[:-1]], te.new_cache(1))
    step, _ = te.decode_step(torch.tensor([ids[-1]]), torch.tensor(lens), cache)
    np.testing.assert_allclose(step.numpy(), one.numpy(), rtol=0, atol=2e-2)


def test_sampled_generation_runs(models):
    """Sampled generation with penalties: valid ids, equal for one seed."""
    _, te = models[64]
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1,
              seed=3)
    a, b = te.generate(PROMPTS, **kw), te.generate(PROMPTS, **kw)
    assert a == b and all(len(r) == 8 and all(0 <= t < 512 for t in r) for r in a)


def test_reused_slot_prefills_from_zeros(models):
    """prefill_slot into a row that holds another request's state gives the
    fresh cache's logits and state, bit for bit, and leaves the other row."""
    _, te = models[64]
    cache = te.new_cache(2)
    _, cache = te.prefill_slot(PROMPTS[0], cache, 1)
    _, cache = te.prefill_slot(PROMPTS[0], cache, 0)
    other = (cache.conv[:, 0].clone(), cache.ssm[:, 0].clone())
    got, cache = te.prefill_slot(PROMPTS[1], cache, 1)
    fresh = te.new_cache(2)
    want, fresh = te.prefill_slot(PROMPTS[1], fresh, 1)
    assert torch.equal(got, want)
    assert torch.equal(cache.conv[:, 1], fresh.conv[:, 1])
    assert torch.equal(cache.ssm[:, 1], fresh.ssm[:, 1])
    assert torch.equal(cache.conv[:, 0], other[0]) and torch.equal(cache.ssm[:, 0], other[1])


def test_sessions_cross_load_and_continue(models, tmp_path):
    """A session the port writes loads in the JAX package and one the JAX
    package writes loads in the port, state for state (the npz keys
    lengths, conv, ssm, recurrent); decoding from a loaded session equals
    the uninterrupted run, token for token."""
    je, te = models[512]
    _, tcache, lens = te.prefill([PROMPTS[0]], te.new_cache(1))
    te.save_session(str(tmp_path / "t.npz"), tcache, lens)
    with np.load(tmp_path / "t.npz") as z:
        assert sorted(z.files) == ["conv", "lengths", "recurrent", "ssm"]
    jc, jlens = je.load_session(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(jc.conv), tcache.conv.numpy())
    np.testing.assert_array_equal(np.asarray(jc.ssm), tcache.ssm.numpy())
    assert list(jlens) == list(lens)
    _, jcache, jl = je.prefill([PROMPTS[1]], je.new_cache(1))
    je.save_session(str(tmp_path / "j.npz"), jcache, jl)
    tc, tl = te.load_session(str(tmp_path / "j.npz"))
    assert isinstance(tc, t_mamba.RecurrentCache) and list(tl) == list(jl)
    np.testing.assert_array_equal(tc.ssm.numpy(), np.asarray(jcache.ssm))
    np.testing.assert_array_equal(tc.conv.numpy(), np.asarray(jcache.conv))
    # continue from the port's own file against the run that never stopped
    first = torch.tensor([7])
    cache, lens2 = te.load_session(str(tmp_path / "t.npz"))
    resumed, _ = te.decode_greedy(first, torch.tensor(lens2), cache, 8)
    _, c2, _ = te.prefill([PROMPTS[0]], te.new_cache(1))
    straight, _ = te.decode_greedy(first, torch.tensor(lens), c2, 8)
    assert torch.equal(resumed, straight)


def test_refusals_match_the_reference(models, tmp_path):
    """Both packages refuse the iSWA layout and int8 KV on a recurrent model
    (ValueError) and context shift (NotImplementedError), the port also
    through generate(context_shift=True) once the state would need it."""
    je, te = models[64]
    for kw in ({"kv_layout": "iswa"}, {"kv_quantized": True}):
        with pytest.raises(ValueError):
            InferenceEngine(te.cfg, te.params, device="cpu", **kw)
        with pytest.raises(ValueError):
            JEngine(je.cfg, je.params, **kw)
    _, cache, lens = te.prefill([PROMPTS[0]], te.new_cache(1))
    with pytest.raises(NotImplementedError):
        te.shift_context(cache, lens, 0, 1)
    _, jcache, jlens = je.prefill([PROMPTS[0]], je.new_cache(1))
    with pytest.raises(NotImplementedError):
        je.shift_context(jcache, jlens, 0, 1)
    small = InferenceEngine(te.cfg, te.params, max_seq=16, device="cpu")
    with pytest.raises(NotImplementedError):
        small.generate([PROMPTS[0]], max_new_tokens=12, context_shift=True)


def test_speculative_refused_where_the_reference_errs(models, tmp_path):
    """The reference's generate_speculative runs a recurrent target as it
    would a KV one, and its verify forward folds rejected drafts into the
    state: on this fixture its greedy stream parts from its own plain
    greedy run, with a draft of another seed and even with the target as
    its own draft (whose state then misses each round's last draft). The
    port refuses both entry points for a recurrent target or draft."""
    je, te = models[64]
    plain = je.generate(PROMPTS, max_new_tokens=16)
    path = str(tmp_path / "draft.gguf")
    j_write_fixture(path, j_tiny_mamba_config(), seed=1, scale=FIXTURES[64])
    dc, dp, _ = jload(path, scale_dtype="bf16")
    for draft in (je, JEngine(dc, dp, max_batch=2, max_seq=96)):
        out, _ = j_generate_speculative(je, draft, PROMPTS, max_new_tokens=16, n_draft=4)
        assert out != plain
    with pytest.raises(NotImplementedError):
        t_speculative.generate_speculative(te, te, PROMPTS, max_new_tokens=4, n_draft=2)
    with pytest.raises(NotImplementedError):
        t_speculative.DeviceSpeculator(te, None)
    with pytest.raises(NotImplementedError):
        t_speculative.DeviceSpeculator(te, te)


# -- serving -------------------------------------------------------------------------


def _serve(batcher, req_cls, prompts, n_new, staggered):
    cb = batcher
    if not staggered:
        for p in prompts:
            cb.submit(req_cls(prompt=p, max_new_tokens=n_new))
        done = cb.run()
    else:
        # the reference's staggered test: r0 alone for 3 ticks (slot 1 idles),
        # r1 into the idled slot, then r2 into a slot a finished request held
        cb.submit(req_cls(prompt=prompts[0], max_new_tokens=n_new))
        for _ in range(3):
            cb.step()
        cb.submit(req_cls(prompt=prompts[1], max_new_tokens=n_new))
        while cb.has_work():
            cb.step()
        cb.submit(req_cls(prompt=prompts[2], max_new_tokens=n_new))
        done = cb.run()
    return {tuple(r.prompt): r.output for r in done}


@pytest.mark.parametrize("staggered", [False, True], ids=["continuous", "staggered"])
def test_serving_matches_solo_and_jax(models, staggered):
    """tests/test_mamba.py's two serving tests (continuous batching; staggered
    admission into an idled slot and slot reuse) on the port: every stream
    equals its solo engine.generate and the JAX batcher's stream."""
    je, te = models[512]
    prompts = [[3, 77, 200, 145, 9], [8, 12, 400], [41, 7, 300, 18]]
    if not staggered:
        prompts = prompts[:2]
    n_new = 6 if staggered else 8
    got = _serve(ContinuousBatcher(te), Request, prompts, n_new, staggered)
    jgot = _serve(JBatcher(je), JRequest, prompts, n_new, staggered)
    for p in prompts:
        want = te.generate([p], max_new_tokens=n_new)[0]
        assert got[tuple(p)] == want == jgot[tuple(p)], p


def test_serving_burst_and_chunks(models):
    """Four requests on two slots (a burst of two, then reuse), run in
    chunks and per tick: the same streams, each its solo run's."""
    _, te = models[64]
    prompts = [[3, 77, 200, 145, 9], [8, 12, 400], [41, 7, 300, 18], [9, 9, 21]]
    outs = []
    for max_chunk in (None, 1):
        cb = ContinuousBatcher(te)
        for p in prompts:
            cb.submit(Request(prompt=p, max_new_tokens=5))
        outs.append({tuple(r.prompt): r.output for r in cb.run(max_chunk=max_chunk)})
    assert outs[0] == outs[1]
    for p in prompts:
        assert outs[0][tuple(p)] == te.generate([p], max_new_tokens=5)[0]


# -- the CLIs ------------------------------------------------------------------------


def test_clis_on_the_cpu(tmp_path, capsys):
    """A mamba written by the port's writer (with its vocab) through the
    generate CLI (its ids equal generate's), the bench CLI and perplexity
    (finite), all with --device cpu."""
    from tpu_kquant_torch.tools import bench_cli, main, perplexity
    from tpu_kquant_torch.tokenizer import from_gguf_metadata

    path = str(tmp_path / "m.gguf")
    t_fixtures.write_fixture_gguf(path, t_fixtures.tiny_mamba_config(), seed=4, scale=0.3)
    out = main.run(["-m", path, "-p", "hello the world", "-n", "8", "--device", "cpu"])
    cfg, params, reader = load_model(path, device="cpu")
    ids = from_gguf_metadata(reader.metadata).encode("hello the world", add_bos=True)
    eng = InferenceEngine(cfg, params, max_seq=cfg.max_seq_len, device="cpu")
    assert out["ids"] == eng.generate([ids], max_new_tokens=8, eos_id=2)[0]
    lines = bench_cli.main(["-m", path, "-p", "16", "-n", "4", "-r", "1", "--device", "cpu"])
    assert [ln.split("|")[5].strip() for ln in lines[2:]] == ["pp16", "tg4"]
    (tmp_path / "t.txt").write_text("hello the world, the hello world " * 8)
    res = perplexity.main(["--model", path, "--text", str(tmp_path / "t.txt"), "--ctx", "32",
                           "--device", "cpu"])
    assert np.isfinite(res["ppl"]) and res["tokens"] > 0
