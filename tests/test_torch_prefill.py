"""The port's long-prompt slice on the CPU against the JAX package: the flash
prefill kernel's plain version against the Pallas kernel (interpret mode),
int8 KV (quantization, appends, scale folding in attention), the attention
dispatch, and the engine end to end on an int8 cache.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances: 2e-2 for the prefill kernel, as tests/test_pallas_prefill.py
holds the Pallas kernel (both round q, k, v and P to bf16 at other points);
1e-5 where both sides compute the same f32 function.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops.attention import attention_decode as jattn
from tpu_kquant.ops.pallas_prefill import attention_prefill_pallas
from tpu_kquant.ops.pallas_prefill import prefill_supported as j_prefill_supported
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime.kv_cache import KVCache as JKVCache
from tpu_kquant.runtime.kv_cache import _quant_i8 as j_quant_i8
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import prefill as t_prefill
from tpu_kquant_torch.ops.decode_attention import decode_attention_plain
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.kv_cache import KVCache, _quant_i8
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(rng, B, T, S, H, Hkv, D, starts, quantized=False):
    """tests/test_pallas_prefill.py's inputs: f32 q; f32 k/v, or int8 codes
    with f32 scales."""
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        v = rng.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        scales = tuple((rng.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32)
                       for _ in range(2))
    else:
        k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
        v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
        scales = None
    starts = np.asarray(starts, np.int32)
    return q, k, v, starts, scales


# the six cases of tests/test_pallas_prefill.py, with that file's tiles:
# (B, T, S, H, Hkv, D, starts, int8, window, tq)
PALLAS_CASES = {
    "fresh_prompt": (2, 64, 128, 8, 2, 64, [0, 0], False, 0, 32),
    "mid_history": (2, 32, 256, 4, 4, 64, [96, 96], False, 0, 16),
    "int8_kv": (2, 32, 128, 8, 2, 64, [40, 40], True, 0, 16),
    "window_32": (1, 64, 256, 4, 2, 64, [150], False, 32, 32),
    "window_100": (1, 64, 256, 4, 2, 64, [150], False, 100, 32),
    "ragged_t40_gqa8": (3, 40, 320, 16, 2, 64, [0, 100, 200], False, 0, 8),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_prefill_plain_matches_pallas(case):
    B, T, S, H, Hkv, D, starts, quant, window, tq = PALLAS_CASES[case]
    rng = np.random.default_rng(11)
    q, k, v, qs, scales = _setup(rng, B, T, S, H, Hkv, D, starts, quant)
    want = np.asarray(attention_prefill_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs),
        None if scales is None else tuple(map(jnp.asarray, scales)),
        sliding_window=window, tq=tq, ts=64, interpret=True))
    c = t_prefill.counter
    plain, launches = c.plain_calls, c.launches
    got = t_prefill.attention_prefill(_t(q), _t(k), _t(v), _t(qs),
                                      None if scales is None else tuple(map(_t, scales)),
                                      sliding_window=window)
    assert c.plain_calls == plain + 1 and c.launches == launches
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked_attention(q, k, v, mask):
    """f32 attention of q [T, H, D] against one KV head k/v [S, D] under a
    [T, S] mask."""
    s = torch.einsum("thd,sd->hts", q, k) * q.shape[-1] ** -0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hts,sd->thd", p, v)


@pytest.mark.parametrize("fault", ["none", "drop_diagonal_tile_past_1024",
                                   "drop_tenth_of_slots_past_1024"])
def test_prefill_check_catches_late_tile_faults(fault):
    """chip_smoke.py's measure for the prefill kernel, at the path's
    T = S = 2048: the plain version's output rounded to bf16 passes, and an
    output that loses part of the late tiles fails."""
    smoke = _chip_smoke()
    T = S = 2048
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).float()
               for shape in ((T, 4, 64), (S, 64), (S, 64)))
    ref = t_prefill.attention_prefill_plain(q[None], k[None, None], v[None, None],
                                            torch.zeros(1, dtype=torch.long))[0]
    t, j = torch.arange(T)[:, None], torch.arange(S)[None]
    if fault == "none":
        got = ref.to(torch.bfloat16)
    else:
        drop = (j // 64 == t // 64) & (t >= 1024) if fault.startswith("drop_diagonal") \
            else (j >= 1024) & (j % 10 == 0)
        got = _masked_attention(q, k, v, (j <= t) & ~drop).to(torch.bfloat16)
    err = smoke.row_rel_err(got, ref)
    assert (err < smoke.TOL) == (fault == "none"), err


def _plan_shapes():
    """(label, B, T, S, H, Hkv, D, q_starts, int8, window): PALLAS_CASES and
    chip_smoke.py's phase-3 prefill shapes (the 1024-request burst among
    them)."""
    out = [(f"pallas {k}", B, T, S, H, Hkv, D, st, i8, w)
           for k, (B, T, S, H, Hkv, D, st, i8, w, _) in PALLAS_CASES.items()]
    for label, B, T, S, st, i8, w, (H, Hkv, D), _ in _chip_smoke().PREFILL_CASES:
        out.append((f"phase 3 {label}", B, T, S, H, Hkv, D, st, i8, w))
    return out


PLAN_SHAPES = {s[0]: s[1:] for s in _plan_shapes()}


def _divisors(G):
    return [d for d in range(1, min(G, t_prefill.ROWS) + 1) if G % d == 0]


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_prefill_plan_covers_each_row_once(shape):
    """For every row grouping the kernel takes (each divisor hw of the GQA
    group), the work items cover each (b, head, query) once, and the
    persistent blocks take each item once."""
    B, T, S, H, Hkv, D, starts, int8, window = PLAN_SHAPES[shape]
    for hw in _divisors(H // Hkv):
        plan = t_prefill.prefill_plan(B, T, H, Hkv, D, int8, sms=132, hw=hw)
        assert plan.hw * plan.nq <= t_prefill.ROWS and plan.grid <= plan.n_items
        seen = np.zeros((B, H, T), np.int32)
        for i in range(plan.n_items):
            b, hk, h0, t0 = t_prefill.plan_item(plan, i, B, H, Hkv)
            assert h0 // (H // Hkv) == hk and t0 < T
            seen[b, h0:h0 + hw, t0:t0 + 2 * plan.nq] += 1
        assert (seen == 1).all(), (hw, np.unique(seen))
        items = sorted(i for c in range(plan.grid) for i in t_prefill.block_items(plan, c))
        assert items == list(range(plan.n_items))


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_prefill_plan_tiles_are_the_references(shape):
    """Each item's cache tiles are the reference's lo_tile .. hi_tile
    (pallas_prefill.py:_prefill_call) at the kernel's tile size, for a
    query block of the item's 2 nq queries, and they hold every slot some
    query of the item attends: the first and last tiles each hold one."""
    B, T, S, H, Hkv, D, starts, int8, window = PLAN_SHAPES[shape]
    plan = t_prefill.prefill_plan(B, T, H, Hkv, D, int8, sms=132)
    TQ, TS, nS = 2 * plan.nq, plan.bn, -(-S // plan.bn)
    for i in range(plan.n_items):
        b, _, _, t0 = t_prefill.plan_item(plan, i, B, H, Hkv)
        qs, tq_i = starts[b], t0 // TQ
        lo, hi = t_prefill.item_tiles(qs, t0, plan, T, S, window)
        if t0 + TQ <= T:  # a whole query block: the reference's own formulas
            assert hi == min((qs + (tq_i + 1) * TQ - 1) // TS, nS - 1)
            assert lo == (max((qs + tq_i * TQ - (window - 1)) // TS, 0) if window > 0 else 0)
        pos = qs + np.arange(t0, min(t0 + TQ, T))
        kv = np.arange(S)
        live = (kv[None] <= pos[:, None]) & ((kv[None] > pos[:, None] - window) | (window <= 0))
        tiles = np.unique(np.nonzero(live)[1] // TS)
        assert (lo, hi) == (tiles.min(), tiles.max()), (i, lo, hi, tiles)


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_prefill_plan_items_give_the_plain_output(case):
    """The kernel's work split on the CPU: each item's rows attend only the
    slots of its tiles, masked by each row's own position and by S, with
    the kernel's tile size; together they give attention_prefill_plain."""
    B, T, S, H, Hkv, D, starts, quant, window, _ = PALLAS_CASES[case]
    rng = np.random.default_rng(13)
    q, k, v, qs, scales = _setup(rng, B, T, S, H, Hkv, D, starts, quant)
    q, k, v, qs = map(_t, (q, k, v, qs))
    scales = None if scales is None else tuple(map(_t, scales))
    want = t_prefill.attention_prefill_plain(q, k, v, qs, scales, sliding_window=window)
    G = H // Hkv
    for hw in _divisors(G):
        plan = t_prefill.prefill_plan(B, T, H, Hkv, D, quant, sms=7, hw=hw)
        got = torch.full_like(want, float("nan"))
        for c in range(plan.grid):
            for i in t_prefill.block_items(plan, c):
                b, hk, h0, t0 = t_prefill.plan_item(plan, i, B, H, Hkv)
                lo, hi = t_prefill.item_tiles(starts[b], t0, plan, T, S, window)
                s0, s1 = lo * plan.bn, min((hi + 1) * plan.bn, S)
                t1 = min(t0 + 2 * plan.nq, T)
                sub = [x[b:b + 1, hk:hk + 1, s0:s1] for x in (k, v)]
                sc = None if scales is None else tuple(x[b:b + 1, hk:hk + 1, s0:s1]
                                                       for x in scales)
                # positions relative to the tile range's first slot
                out = t_prefill.attention_prefill_plain(
                    q[b:b + 1, t0:t1, h0:h0 + hw], *sub,
                    torch.tensor([starts[b] + t0 - s0]), sc, sliding_window=window)
                got[b, t0:t1, h0:h0 + hw] = out[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_supported_matches_reference():
    for T in (1, 7, 8, 40, 64, 2048):
        for S in (63, 64, 320, 2240):
            for D in (32, 64, 96, 128):
                assert t_prefill.prefill_supported(T, S, D) == j_prefill_supported(T, S, D)


def test_prefill_wrapper_raises_off_the_cpu():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    the kernel or raises (here: meta tensors, which no kernel takes)."""
    meta = dict(device="meta")
    q = torch.empty(1, 64, 8, 64, dtype=torch.bfloat16, **meta)
    k = torch.empty(1, 2, 128, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="device"):
        t_prefill.attention_prefill(q, k, k, torch.zeros(1, dtype=torch.long, **meta))


def test_decode_gate_raises_on_the_card_not_on_the_cpu(monkeypatch):
    """Where the reference dispatches its flash decode kernel (T == 1, no
    kv_cur, logits past the budget), the port dispatches kernel #7's
    wrapper: the CPU runs its plain version (counted), the card launches the
    kernel, and any other device raises there instead of falling back."""
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
    rng = np.random.default_rng(3)
    q, k, v, _, _ = _setup(rng, 1, 1, 128, 4, 2, 64, [0])
    pos = torch.tensor([[100]])
    c = _build.COUNTERS["decode_attn"]
    before = c.plain_calls
    out = t_attention.attention_decode(_t(q), _t(k), _t(v), pos)
    assert c.plain_calls == before + 1
    assert out.shape == (1, 1, 4, 64) and torch.isfinite(out).all()
    assert torch.equal(out, decode_attention_plain(_t(q), _t(k), _t(v), pos))
    with pytest.raises(ValueError, match="decode_attn"):
        t_attention.attention_decode(*(_t(a).to("meta") for a in (q, k, v)), pos.to("meta"))


def _attn_inputs(rng, B, T, S, H, Hkv, D):
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    ks, vs = ((rng.random((B, Hkv, S)) * 0.02 + 0.001).astype(np.float32) for _ in range(2))
    return q, k, v, (ks, vs)


@pytest.mark.parametrize("T", [1, 5])
def test_attention_with_kv_scales_matches_jax(T):
    """int8 KV on the plain branch: a decode step (T 1) and a short prefill."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v, sc = _attn_inputs(rng, B, T, S, H, Hkv, D)
    pos = np.stack([np.arange(T), np.arange(T) + 6]).astype(np.int32)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            tuple(map(jnp.asarray, sc)), impl="xla"))
    got = t_attention.attention_decode(_t(q), _t(k), _t(v), _t(pos).long(), tuple(map(_t, sc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_with_kv_scales_and_kv_cur_matches_jax():
    """Deferred append on int8 KV: the current logit is unscaled and the
    current value unquantized; slot q_pos's stale code and scale drop out."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v, sc = _attn_inputs(rng, B, 1, S, H, Hkv, D)
    kc, vc = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    pos = np.array([[3], [11]], np.int32)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            tuple(map(jnp.asarray, sc)), impl="xla",
                            kv_cur=(jnp.asarray(kc), jnp.asarray(vc))))
    got = t_attention.attention_decode(_t(q), _t(k), _t(v), _t(pos).long(), tuple(map(_t, sc)),
                                       kv_cur=(_t(kc), _t(vc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_i8_is_byte_equal_to_jax(dtype):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 2, 64)) * rng.choice([1e-3, 1.0, 40.0], (3, 5, 2, 1)))
    x = x.astype(np.float32)
    x[1, 2, 0] = 0.0  # a zero row: scale 0, divided by 1
    x[0, 0, 1, :4] = [127.0, -63.5, 0.5, -0.5]  # ties round half to even
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_quant_i8(jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype)))
    tq, ts = _quant_i8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def _jcache_np(c):
    return [np.asarray(a) for a in (c.k, c.v, c.k_scale, c.v_scale)]


def test_int8_appends_match_jax_cache():
    rng = np.random.default_rng(7)
    L, B, S, Hkv, D = 3, 2, 16, 2, 8
    jc = JKVCache.create(L, B, S, Hkv, D, quantized=True)
    tc = KVCache.create(L, B, S, Hkv, D, device="cpu", quantized=True)
    assert tc.quantized and tc.k.dtype == torch.int8 and tc.k_scale.shape == (L, B, Hkv, S)
    kn, vn = ((rng.standard_normal((B, 4, Hkv, D)) * 3).astype(np.float32) for _ in range(2))
    pos = np.array([[0, 1, 2, 3], [5, 6, 7, 8]], np.int32)
    jc = jc.append(1, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                   jnp.asarray(pos))
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    assert tc.append(1, tb(kn), tb(vn), _t(pos).long()) is tc
    ka, va = ((rng.standard_normal((L, B, 1, Hkv, D)) * 2).astype(np.float32) for _ in range(2))
    pos1 = np.array([[4], [9]], np.int32)
    jc = jc.append_all(jnp.asarray(ka, jnp.bfloat16), jnp.asarray(va, jnp.bfloat16),
                       jnp.asarray(pos1))
    assert tc.append_all(tb(ka), tb(va), _t(pos1).long()) is tc
    for want, got in zip(_jcache_np(jc), (tc.k, tc.v, tc.k_scale, tc.v_scale)):
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    view = tc.layer_view(2)
    assert view[2] is not None and view[2][0].shape == (B, Hkv, S)
    # the same bytes through from_numpy
    tc2 = KVCache.from_numpy(*_jcache_np(jc), device="cpu")
    for a, b in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), (tc2.k, tc2.v, tc2.k_scale, tc2.v_scale)):
        assert torch.equal(a, b)


def test_bf16_cache_from_numpy_matches_jax_appends():
    rng = np.random.default_rng(9)
    L, B, S, Hkv, D = 2, 1, 8, 2, 4
    kn, vn = ((rng.standard_normal((B, 3, Hkv, D))).astype(np.float32) for _ in range(2))
    pos = np.arange(2, 5, dtype=np.int32)[None]
    jc = JKVCache.create(L, B, S, Hkv, D).append(
        1, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16), jnp.asarray(pos))
    tc = KVCache.create(L, B, S, Hkv, D, device="cpu").append(
        1, _t(kn).to(torch.bfloat16), _t(vn).to(torch.bfloat16), _t(pos).long())
    got = KVCache.from_numpy(np.asarray(jc.k), np.asarray(jc.v), device="cpu")
    assert not got.quantized and got.k_scale is None and got.layer_view(0)[2] is None
    assert torch.equal(got.k, tc.k) and torch.equal(got.v, tc.v)


@pytest.fixture(scope="module")
def w1024(tmp_path_factory):
    """The dim-1024 fixture of tests/test_torch_model.py (head_dim 64), on
    int8 KV in both packages."""
    kw = dict(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024, vocab_size=512,
              max_seq_len=128)
    path = tmp_path_factory.mktemp("w1024") / "w1024.gguf"
    write_fixture_gguf(path, tiny_config(**kw), seed=3, quant="q4_k_m", scale=0.05)
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
    return (JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla", kv_quantized=True),
            InferenceEngine(tc, tp, max_batch=1, max_seq=64, kv_quantized=True, device="cpu"))


PROMPT = [int(t) for t in np.random.default_rng(8).integers(3, 512, 50)]


def test_int8_engine_prefill_and_greedy_match_jax(w1024):
    je, te = w1024
    assert te.new_cache(1).quantized
    lj, _, _ = je.prefill([PROMPT[:9]], je.new_cache(1))
    lt, _, _ = te.prefill([PROMPT[:9]], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    assert te.generate([PROMPT[:5]], max_new_tokens=8) == je.generate([PROMPT[:5]],
                                                                     max_new_tokens=8)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_dispatch_follows_the_logits_budget(w1024, monkeypatch, kv_int8):
    """A 50-token prompt (bucket 64 = S, prefill_supported) goes to the
    prefill kernel's plain version in both layers once the budget is 0, and
    stays on the plain branch under the real budget; both give the same
    logits."""
    _, te = w1024
    eng = InferenceEngine(te.cfg, te.params, max_seq=64, kv_quantized=kv_int8, device="cpu")
    c = _build.COUNTERS["prefill"]
    base = c.plain_calls
    ref, _, _ = eng.prefill([PROMPT], eng.new_cache(1))
    assert c.plain_calls == base
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
    got, _, _ = eng.prefill([PROMPT], eng.new_cache(1))
    assert c.plain_calls == base + 2 and c.launches == 0
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * ref.abs().max().item())


def test_decode_past_the_budget_appends_eagerly(w1024, monkeypatch):
    """Past the budget the forward stops deferring the append (kv_cur off),
    as the reference's llama.py does. The cache has 80 slots, which fails
    the decode kernel's S % 64 rule, so the plain branch then reads the
    appended cache (tests/test_torch_decode_attention.py covers the kernel's
    side of the gate). On bf16 KV both orders give the same step (the
    deferred current row is the bf16 row the append writes)."""
    _, te = w1024
    eng = InferenceEngine(te.cfg, te.params, max_seq=80, device="cpu")
    logits, cache, lens = eng.prefill([PROMPT[:7]], eng.new_cache(1))
    outs = []
    kernel = _build.COUNTERS["decode_attn"]
    for budget in (t_attention.ATTN_PLAIN_MAX_MB, 0.0):
        monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", budget)
        c = KVCache(cache.k.clone(), cache.v.clone())
        before = kernel.plain_calls
        outs.append((*eng.decode_step(torch.tensor([11]), torch.tensor(lens), c),))
        assert kernel.plain_calls == before
    (a, ca), (b, cb) = outs
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * a.abs().max().item())
    assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)
    assert not torch.equal(ca.k, cache.k)  # the step did write its row
