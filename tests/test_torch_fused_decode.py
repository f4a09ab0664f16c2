"""The reference's opt-in decode fusions in the port, on the CPU.

Four kernels: kv_append (#9, ops.kv_append), attn_out (#10, ops.attn_out),
layer (#11, ops.layer) and rot (#12, ops.rot). On the CPU each wrapper runs
its plain version; these tests hold the plain versions against the JAX
package's Pallas kernels in interpret mode on the same packed bytes, at the
reference tests' shapes and tolerances (tests/test_kv_append.py,
test_pallas_attn_out.py, test_pallas_layer.py, test_pallas_rot.py); hold
each port gate to the reference's over a grid of shapes, kinds and scale
layouts (the reference's gates also require a TPU backend, patched here);
and run the three switch settings of the forward end to end against the
JAX engine, whose TPU-only gates keep it on its unfused path, the same
function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.gguf.constants import GGMLType
from tpu_kquant.ops import pallas_attn_out as j_attn_out
from tpu_kquant.ops import pallas_kv_append as j_kv_append
from tpu_kquant.ops import pallas_layer as j_layer
from tpu_kquant.ops.attic import pallas_rot as j_rot
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.quant import quantize
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.quant.repack import pack_scale_kpairs, pack_scale_pairs, repack, widen_q6
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.runtime.kv_cache import KVCache as JKVCache
from tpu_kquant_torch.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attn_out as t_attn_out
from tpu_kquant_torch.ops import kv_append as t_kv_append
from tpu_kquant_torch.ops import layer as t_layer
from tpu_kquant_torch.ops import rot as t_rot
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.kv_cache import KVCache
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

SWITCHES = ("TKQ_KV_APPEND_PALLAS", "TKQ_FUSE_ATTN_OUT", "TKQ_DEFER_APPEND", "TKQ_FUSE_LAYER",
            "TKQ_ROTATE_LAYER", "TKQ_FUSE_OPROJ")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    """Every test starts with the reference's defaults (switches unset)."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    return t.float().numpy()


def _plain_calls() -> dict:
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


def _delta(before: dict) -> dict:
    after = _plain_calls()
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


# ---------------------------------------------------------------------------
# #9 kv_append
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3, 32])
def test_kv_append_plain_is_bit_exact_to_pallas(B):
    L, Hkv, S, D = 3, 4, 64, 8
    rng = np.random.default_rng(B)
    k0, v0 = (rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    start = rng.integers(0, S, B).astype(np.int32)
    jk, jv = j_kv_append.kv_append_pallas(
        jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16),
        jnp.asarray(vn, jnp.bfloat16), 1, jnp.asarray(start), interpret=True)
    tk, tv = _bf(k0), _bf(v0)
    before = _plain_calls()
    t_kv_append.kv_append(tk, tv, _bf(kn), _bf(vn), 1, torch.from_numpy(start).long())
    assert _delta(before) == {"kv_append": 1}
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


@pytest.mark.parametrize("switch", ["1", "0"])
def test_kvcache_append_dispatch_matches_jax_cache(monkeypatch, switch):
    """KVCache.append under TKQ_KV_APPEND_PALLAS: the gate sends decode rows
    of a bf16 cache to kv_append, and the bytes equal the JAX cache's."""
    monkeypatch.setenv("TKQ_KV_APPEND_PALLAS", switch)
    L, B, Hkv, S, D = 2, 2, 2, 32, 8
    rng = np.random.default_rng(4)
    kn, vn = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    pos = np.array([[3], [17]], np.int32)
    jc = JKVCache.create(L, B, S, Hkv, D).append(
        1, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16), jnp.asarray(pos))
    tc = KVCache.create(L, B, S, Hkv, D, device="cpu")
    before = _plain_calls()
    tc.append(1, _bf(kn), _bf(vn), torch.from_numpy(pos).long())
    assert _delta(before).get("kv_append", 0) == (switch == "1")
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    # an int8 cache, or two tokens a row, keeps the indexed writes
    tq = KVCache.create(L, B, S, Hkv, D, device="cpu", quantized=True)
    before = _plain_calls()
    tq.append(1, _bf(kn), _bf(vn), torch.from_numpy(pos).long())
    tc.append(0, _bf(np.concatenate([kn, kn], 1)), _bf(np.concatenate([vn, vn], 1)),
              torch.from_numpy(np.concatenate([pos, pos + 1], 1)).long())
    assert "kv_append" not in _delta(before)


# ---------------------------------------------------------------------------
# #10 attn_out
# ---------------------------------------------------------------------------

RNG_SEED = 11


def _mk_w(rng, qtype, N, K, pairs=False, widen=False, kpairs=False):
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.1
    qt = repack(quantize(w, qtype), qtype, (N, K), layout="kmajor")
    if widen:
        qt = widen_q6(qt)
    if pairs:
        qt = pack_scale_pairs(qt)
    if kpairs:
        qt = pack_scale_kpairs(qt)
    return qt


# (_mk_w args for wo, B, S, H, Hkv, D, dim, positions, int8 KV, ts) by label:
# tests/test_pallas_attn_out.py's cases
ATTN_OUT_CASES = {
    "q4-f32": ((GGMLType.Q4_K, False, False), 1, 256, 8, 2, 64, 512, [100], False, 128),
    "q4-sm": ((GGMLType.Q4_K, True, False), 1, 256, 8, 2, 64, 512, [100], False, 128),
    "q6w-f32": ((GGMLType.Q6_K, False, True), 1, 128, 8, 4, 64, 512, [64], False, 64),
    "q8-f32": ((GGMLType.Q8_0, False, False), 1, 128, 8, 4, 64, 512, [64], False, 64),
    "ragged q4-sm": ((GGMLType.Q4_K, True, False), 3, 256, 8, 2, 64, 512, [3, 100, 255], False,
                     64),
    "int8 KV q4-sm": ((GGMLType.Q4_K, True, False), 2, 128, 8, 2, 64, 512, [60, 127], True, 64),
    "gqa pairs q4-f32": ((GGMLType.Q4_K, False, False), 1, 128, 8, 4, 64, 640, [127], False, 64),
}


def _attn_out_inputs(case):
    (qtype, pairs, widen), B, S, H, Hkv, D, dim, pos, int8, ts = ATTN_OUT_CASES[case]
    rng = np.random.default_rng(RNG_SEED)
    wo = _mk_w(rng, qtype, dim, H * D, pairs=pairs, widen=widen)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    x = rng.standard_normal((B, 1, dim)).astype(np.float32)
    if int8:
        k, v = (rng.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8) for _ in range(2))
        scales = tuple((rng.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32)
                       for _ in range(2))
    else:
        k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
        scales = None
    positions = np.asarray(pos, np.int32).reshape(B, 1)
    return wo, q, x, k, v, scales, positions, ts


@pytest.mark.parametrize("case", sorted(ATTN_OUT_CASES))
def test_attn_out_plain_matches_pallas(case):
    wo, q, x, k, v, scales, positions, ts = _attn_out_inputs(case)
    H, D = q.shape[2], q.shape[3]
    Hkv, S = k.shape[1], k.shape[2]
    jkv = (jnp.asarray(k), jnp.asarray(v)) if scales is not None else \
        (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    jscales = None if scales is None else tuple(jnp.asarray(s) for s in scales)
    ref = np.asarray(j_attn_out.fused_attn_out(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16), *jkv, jnp.asarray(positions),
        jscales, wo, ts=ts, interpret=True), np.float32)
    two = _port(wo)
    assert t_attn_out.attn_out_supported(two, H, Hkv, D, q.shape[0], S)
    tkv = (torch.from_numpy(k), torch.from_numpy(v)) if scales is not None else (_bf(k), _bf(v))
    tscales = None if scales is None else tuple(torch.from_numpy(s) for s in scales)
    before = _plain_calls()
    got = t_attn_out.fused_attn_out(_bf(x), _bf(q), *tkv, torch.from_numpy(positions).long(),
                                    tscales, two)
    assert _delta(before) == {"attn_out": 1}
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=3e-2, atol=3e-2 * np.abs(ref).max())


def test_reference_attn_out_admits_kpairs_and_fails_on_them():
    """Fault of the reference, pinned: its gate admits a q6w wo with k-pair
    scales ("sp", the loader's default bf16 layout) and its kernel then reads
    wo["scales"] and raises KeyError. The port's gate refuses "sp", so the
    layer takes the unfused path."""
    B, S, H, Hkv, D, dim = 1, 128, 8, 4, 64, 512
    rng = np.random.default_rng(3)
    wo = _mk_w(rng, GGMLType.Q6_K, dim, H * D, pairs=True, widen=True, kpairs=True)
    assert wo.kind == "q6w" and "sp" in wo.arrays
    assert j_attn_out.attn_out_supported(wo, H, Hkv, D, B, S)
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)
    kv = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((B, 1, dim)), jnp.bfloat16)
    with pytest.raises(KeyError, match="scales"):
        j_attn_out.fused_attn_out(x, q, kv, kv, jnp.asarray([[64]], jnp.int32), None, wo, ts=64,
                                  interpret=True)
    assert not t_attn_out.attn_out_supported(_port(wo), H, Hkv, D, B, S)


# ---------------------------------------------------------------------------
# #11 layer
# ---------------------------------------------------------------------------

# tests/test_pallas_layer.py's shapes: S = 96 is not a multiple of the TPU
# kernel's 256-slot tile (nor of the port's 64)
LD, LH, LHKV, LHD, LF, LS = 512, 16, 4, 64, 512, 96


def _pairs(s, m):
    bits = [torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
            .astype(np.uint32) for a in (s, m)]
    return (bits[0] | (bits[1] << 16)).view(np.float32)


def _q4(rng, N, K, sm=True):
    qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    s = rng.random((K // 32, N), dtype=np.float32) * 0.02 + 0.001
    m = rng.random((K // 32, N), dtype=np.float32) * 0.02
    arrays = {"qs": qs, "sm": _pairs(s, m)} if sm else {"qs": qs, "scales": s, "mins": m}
    return arrays, "q4", (N, K)


def _q6w(rng, N, K):
    return ({"qs": rng.integers(-32, 32, (K, N)).astype(np.int8),
             "scales": rng.random((K // 16, N), dtype=np.float32) * 0.02 + 0.001}, "q6w", (N, K))


def _both(spec):
    arrays, kind, shape = spec
    return (JQTensor(kind, "kmajor", shape, {k: jnp.asarray(v) for k, v in arrays.items()}),
            QTensor(kind, "kmajor", shape, dict(arrays)).to("cpu"))


@pytest.fixture(scope="module")
def layer_setup():
    rng = np.random.default_rng(7)
    ws = [_both(s) for s in (_q4(rng, (LH + LHKV) * LHD, LD), _q6w(rng, LHKV * LHD, LD),
                             _q4(rng, LD, LH * LHD, sm=False), _q4(rng, 2 * LF, LD),
                             _q6w(rng, LD, LF))]
    return dict(ws=ws, rng=rng)


def _rope(pos, hd):
    ang = pos[..., None] / (10000.0 ** (np.arange(hd // 2) * 2 / hd))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("positions", [[1], [40], [LS - 1]], ids=["pos1", "pos40", "pos95"])
def test_layer_plain_matches_pallas(layer_setup, positions):
    B = len(positions)
    rng = np.random.default_rng(100 + B)
    x = rng.standard_normal((B, 1, LD)).astype(np.float32) * 0.5
    anw, fnw = (rng.random(LD).astype(np.float32) + 0.5 for _ in range(2))
    kc, vc = (rng.standard_normal((B, LHKV, LS, LHD)).astype(np.float32) * 0.3 for _ in range(2))
    pos = np.asarray(positions, np.int32).reshape(B, 1)
    cos, sin = _rope(pos, LHD)
    jws = [w[0] for w in layer_setup["ws"]]
    tws = [w[1] for w in layer_setup["ws"]]
    assert j_layer.layer_supported(*jws, B, LD, LH, LHKV, LHD)
    assert t_layer.layer_supported(*tws, B, LD, LH, LHKV, LHD)
    y_r, k_r, v_r = (np.asarray(a, np.float32) for a in j_layer.fused_layer(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(anw), jnp.asarray(fnw), 1e-5,
        *jws, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), LH, LHKV, interpret=True))
    before = _plain_calls()
    y, k, v = t_layer.fused_layer(_bf(x), torch.from_numpy(pos).long(), torch.from_numpy(anw),
                                  torch.from_numpy(fnw), 1e-5, *tws, torch.from_numpy(cos),
                                  torch.from_numpy(sin), _bf(kc), _bf(vc), LH, LHKV)
    assert _delta(before) == {"layer": 1}
    assert y.shape == (B, 1, LD) and k.shape == v.shape == (B, 1, LHKV, LHD)
    np.testing.assert_allclose(_np(k), k_r, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(_np(v), v_r, rtol=0.05, atol=0.02)
    a, b = _np(y).ravel(), y_r.ravel()
    assert float(np.corrcoef(a, b)[0, 1]) > 0.999
    np.testing.assert_allclose(a, b, rtol=0.12, atol=0.01 * float(np.sqrt((b ** 2).mean())))


def test_layer_plain_equals_append_then_attend_at_ragged_positions(layer_setup):
    """Rows at positions 0, 1 and 95 in one call: the layer's attention over
    the PRE-append cache plus the current token equals appending first and
    attending the cache (ops.decode_attention's plain version), up to the
    current token's p, which the layer keeps f32 where the cache path rounds
    it to bf16."""
    from tpu_kquant_torch.ops.attn_in import attn_in_plain
    from tpu_kquant_torch.ops.decode_attention import decode_attention_plain

    tws = [w[1] for w in layer_setup["ws"]]
    B, pos = 3, np.array([[0], [1], [LS - 1]], np.int32)
    rng = np.random.default_rng(9)
    x = _bf(rng.standard_normal((B, 1, LD)) * 0.5)
    anw, fnw = (torch.from_numpy(rng.random(LD).astype(np.float32) + 0.5) for _ in range(2))
    kc, vc = (_bf(rng.standard_normal((B, LHKV, LS, LHD)) * 0.3) for _ in range(2))
    cos, sin = (torch.from_numpy(a) for a in _rope(pos, LHD))
    tpos = torch.from_numpy(pos).long()
    y, k, v = t_layer.layer_plain(x, tpos, anw, fnw, 1e-5, *tws, cos, sin, kc, vc, LH, LHKV)
    qk, v2 = attn_in_plain(x.reshape(B, LD), anw, 1e-5, tws[0], tws[1], cos.reshape(B, -1),
                           sin.reshape(B, -1), LHD)
    assert torch.equal(k.reshape(B, -1), qk[:, LH * LHD:]) and torch.equal(v.reshape(B, -1), v2)
    kc2, vc2 = kc.clone(), vc.clone()
    b = torch.arange(B)
    kc2[b, :, tpos[:, 0]] = k[:, 0]
    vc2[b, :, tpos[:, 0]] = v[:, 0]
    want = decode_attention_plain(qk[:, None, :LH * LHD].reshape(B, 1, LH, LHD), kc2, vc2, tpos)
    got = t_layer.attend_with_current(qk[:, :LH * LHD].reshape(B, LH, LHD), kc, vc, tpos,
                                      k[:, 0], v[:, 0])
    want = want.reshape(B, -1).float()
    # per row: p of the current token in bf16 is within 2^-8 of its f32 value
    err = ((got.float() - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    assert err < 1e-2, err
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("which", ["attn_out", "layer"])
def test_att_hook_receives_the_plain_attention_and_leaves_y_alone(layer_setup, which):
    """The wrappers' `att` (the kernels' attention scratch, which the card's
    checks hold per row) receives, on the CPU, the plain attention phase's
    bf16 head outputs, and the outputs are those of a call without it."""
    from tpu_kquant_torch.ops.attn_in import attn_in_plain
    from tpu_kquant_torch.ops.decode_attention import decode_attention_plain

    rng = np.random.default_rng(11)
    B, pos = 2, np.array([[0], [LS - 1]], np.int32)
    tpos = torch.from_numpy(pos).long()
    kc, vc = (_bf(rng.standard_normal((B, LHKV, LS, LHD)) * 0.3) for _ in range(2))
    x = _bf(rng.standard_normal((B, 1, LD)) * 0.5)
    att = torch.full((B, LH * LHD), float("nan"), dtype=torch.bfloat16)
    if which == "attn_out":
        wo = _port(_mk_w(rng, GGMLType.Q6_K, LD, LH * LHD, pairs=False, widen=True))
        q = _bf(rng.standard_normal((B, 1, LH, LHD)))
        plain = t_attn_out.fused_attn_out(x, q, kc, vc, tpos, None, wo)
        got = t_attn_out.fused_attn_out(x, q, kc, vc, tpos, None, wo, att=att)
        want = decode_attention_plain(q, kc, vc, tpos).reshape(B, -1)
    else:
        tws = [w[1] for w in layer_setup["ws"]]
        anw, fnw = (torch.from_numpy(rng.random(LD).astype(np.float32) + 0.5) for _ in range(2))
        cos, sin = (torch.from_numpy(a) for a in _rope(pos, LHD))
        args = (x, tpos, anw, fnw, 1e-5, *tws, cos, sin, kc, vc, LH, LHKV)
        plain = t_layer.fused_layer(*args)
        got = t_layer.fused_layer(*args, att=att)
        qk, v = attn_in_plain(x.reshape(B, LD), anw, 1e-5, tws[0], tws[1], cos.reshape(B, -1),
                              sin.reshape(B, -1), LHD)
        want = t_layer.attend_with_current(qk[:, :LH * LHD].reshape(B, LH, LHD), kc, vc, tpos,
                                           qk[:, LH * LHD:].reshape(B, LHKV, LHD),
                                           v.reshape(B, LHKV, LHD))
    got, plain = (t if isinstance(t, tuple) else (t,) for t in (got, plain))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert torch.equal(att, want.to(torch.bfloat16))


def test_layer_plain_attends_the_current_token_alone_at_position_zero():
    """At position 0 no cache slot is live: the attention output is the
    current token's v, whatever the cache holds."""
    rng = np.random.default_rng(5)
    q = _bf(rng.standard_normal((1, LH, LHD)))
    kc, vc = (_bf(rng.standard_normal((1, LHKV, LS, LHD)) * 1e3) for _ in range(2))
    kn, vn = (_bf(rng.standard_normal((1, LHKV, LHD))) for _ in range(2))
    att = t_layer.attend_with_current(q, kc, vc, torch.zeros(1, 1, dtype=torch.long), kn, vn)
    want = vn.repeat_interleave(LH // LHKV, dim=1).reshape(1, LH * LHD)
    assert torch.equal(att, want)


# ---------------------------------------------------------------------------
# #12 rot
# ---------------------------------------------------------------------------


def _rot_setup(R, seed=0, D=512, F=768, Hhd=1024, Nqk=1152, Nv=128):
    """tests/test_pallas_rot.py's setup: q4-sm wo / gate-up / wqk, q6w-f32
    down / wv."""
    rng = np.random.default_rng(seed)
    wo = _mk_w(rng, GGMLType.Q4_K, D, Hhd, pairs=True)
    gu = _mk_w(rng, GGMLType.Q4_K, 2 * F, D, pairs=True)
    dn = _mk_w(rng, GGMLType.Q6_K, D, F, widen=True)
    wqk2 = _mk_w(rng, GGMLType.Q4_K, Nqk, D, pairs=True)
    wv2 = _mk_w(rng, GGMLType.Q6_K, Nv, D, widen=True)
    x = (rng.standard_normal((R, 1, D)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((R, 1, Hhd)) * 0.5).astype(np.float32)
    nw = (rng.standard_normal((D,)) * 0.1 + 1.0).astype(np.float32)
    nw2 = (rng.standard_normal((D,)) * 0.1 + 1.0).astype(np.float32)
    cos, sin = _rope(rng.integers(0, 100, (R, 1)), 64)
    return [wo, gu, dn, wqk2, wv2], x, attn, nw, nw2, cos, sin


def _check_rot(ws, x, attn, nw, nw2, cos, sin, hd=64):
    wo, gu, dn, wqk2, wv2 = ws
    R = x.shape[0]
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), wqk2.shape[0] // hd, hd,
                              n_pad=0)
    ref = [np.asarray(a, np.float32) for a in j_rot.fused_oproj_ffn_attn_in(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw), 1e-5,
        gu, dn, jnp.asarray(nw2), [wqk2, wv2], cf, sf, hd // 2, interpret=True)]
    pw = [_port(w) for w in ws]
    assert t_rot.rot_supported(*pw[:3], pw[3:], R, x.shape[-1], hd)
    before = _plain_calls()
    got = t_rot.fused_oproj_ffn_attn_in(_bf(x), _bf(attn), pw[0], torch.from_numpy(nw), 1e-5,
                                        pw[1], pw[2], torch.from_numpy(nw2), pw[3], pw[4],
                                        torch.from_numpy(cos), torch.from_numpy(sin), hd)
    assert _delta(before) == {"rot": 1}
    for g, r, name in zip(got, ref, ("y", "qk", "v")):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(_np(g), r, atol=2e-2 * max(1.0, np.abs(r).max()), err_msg=name)


@pytest.mark.parametrize("R", [1, 8])
def test_rot_plain_matches_pallas(R):
    _check_rot(*_rot_setup(R))


def test_rot_plain_matches_pallas_flat_wo_and_kpairs():
    ws, x, attn, nw, nw2, cos, sin = _rot_setup(1)
    rng = np.random.default_rng(3)
    ws[0] = _mk_w(rng, GGMLType.Q6_K, x.shape[-1], attn.shape[-1], widen=True)
    ws[2] = pack_scale_kpairs(ws[2])
    ws[4] = pack_scale_kpairs(ws[4])
    _check_rot(ws, x, attn, nw, nw2, cos, sin)


# ---------------------------------------------------------------------------
# the gates against the reference's
# ---------------------------------------------------------------------------

_SIDES = {  # scale layouts of each kind: the loader's bf16 pairs, f32 scales
    ("q4", "sm"): ("sm",), ("q4", "f32"): ("scales", "mins"),
    ("q6w", "sp"): ("sp",), ("q6w", "f32"): ("scales",),
    ("q8", "sp"): ("sp",), ("q8", "f32"): ("scales",)}
_ONE = np.zeros(1, np.float32)


def _dummy(kind, side, shape, layout="kmajor"):
    """The two packages' QTensors of a kind, layout and shape; the gates
    read nothing but these, so the arrays are placeholders."""
    keys = ("qs",) + _SIDES[(kind, side)]
    return (JQTensor(kind, layout, tuple(shape), {k: _ONE for k in keys}),
            QTensor(kind, layout, tuple(shape), {k: _ONE for k in keys}))


@pytest.fixture
def tpu_backend(monkeypatch):
    """The reference's *_enabled gates also require a TPU backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def test_kv_append_gate_matches_reference(monkeypatch, tpu_backend):
    n = 0
    for switch in ("0", "1"):
        monkeypatch.setenv("TKQ_KV_APPEND_PALLAS", switch)
        for quantized in (False, True):
            for T in (1, 2):
                for B in (1, 32, 33):
                    for S in (64, 72, 704, 2048, 2056):
                        args = (quantized, T, B, S)
                        want = j_kv_append.kv_append_enabled(*args)
                        assert t_kv_append.kv_append_enabled(*args) == want, args
                        n += want
    assert n == 6  # switch on, bf16, T = 1, B of 1 or 32, S of 64, 704 or 2048


def test_attn_out_gate_matches_reference_but_refuses_kpairs():
    n = 0
    for (kind, side) in _SIDES:
        for layout in ("kmajor", "rowmajor"):
            for H, Hkv, D in ((8, 2, 64), (8, 1, 64), (8, 4, 64), (32, 4, 64), (16, 4, 128),
                              (12, 2, 128), (64, 2, 128), (8, 2, 192)):
                for dim in (512, 640, 2048, 8192):
                    for Kw in (H * D, H * D // 2):
                        wj, wt = _dummy(kind, side, (dim, Kw), layout)
                        for rows in (1, 16, 17):
                            for S in (128, 96, 704):
                                want = j_attn_out.attn_out_supported(wj, H, Hkv, D, rows, S)
                                got = t_attn_out.attn_out_supported(wt, H, Hkv, D, rows, S)
                                # fault 2 of the reference ("sp"), and the
                                # flash decode kernel's head_dim and group
                                assert got == (want and side != "sp" and D in (64, 128)
                                               and H // Hkv <= 16), (kind, side, layout, H, Hkv,
                                                                     D, dim, Kw, rows, S)
                                n += got
    assert n > 50


# (wqk, wv, wo, w_gateup, w_down): f32 scales as the loader gives Q4_K_M,
# its bf16 pairs, Q8_0 on f32 scales, q4-sm with a q8 down, a q4 down
LAYER_KINDS = (
    (("q4", "f32"), ("q6w", "f32"), ("q6w", "f32"), ("q4", "f32"), ("q6w", "f32")),
    (("q4", "sm"), ("q6w", "sp"), ("q6w", "sp"), ("q4", "sm"), ("q6w", "sp")),
    (("q8", "f32"),) * 5,
    (("q4", "sm"),) * 4 + (("q8", "f32"),),
    (("q4", "f32"),) * 5)


def test_layer_gate_matches_reference():
    n = 0
    for D, H, Hkv, hd, F in ((512, 16, 4, 64, 512), (2048, 32, 4, 64, 5632),
                             (1024, 8, 8, 128, 1024), (768, 12, 4, 64, 768),
                             (512, 8, 4, 64, 512), (512, 16, 4, 32, 512),
                             (2048, 32, 4, 64, 5000)):
        for kinds in LAYER_KINDS:
            shapes = (((H + Hkv) * hd, D), (Hkv * hd, D), (D, H * hd), (2 * F, D), (D, F))
            pairs = [_dummy(k, s, shp) for (k, s), shp in zip(kinds, shapes)]
            for rows in (1, 4, 5):
                args = (rows, D, H, Hkv, hd)
                want = j_layer.layer_supported(*(p[0] for p in pairs), *args)
                assert t_layer.layer_supported(*(p[1] for p in pairs), *args) == want, \
                    (D, H, Hkv, hd, F, kinds, rows)
                n += want
    assert n > 5


def test_rot_gate_matches_reference():
    n = 0
    for dim, K, F, Nqk, Nv in ((512, 1024, 768, 1152, 128), (2048, 2048, 5632, 2304, 256),
                               (1536, 1536, 8960, 1792, 256), (512, 1024, 768, 1100, 128),
                               (640, 1024, 768, 1152, 128)):
        for kinds in ((("q4", "sm"), ("q4", "sm"), ("q6w", "sp"), ("q4", "sm"), ("q6w", "sp")),
                      (("q6w", "f32"), ("q4", "f32"), ("q6w", "f32"), ("q4", "f32"),
                       ("q6w", "f32")),
                      (("q8", "sp"),) * 5, (("q4", "sm"),) * 5):
            shapes = ((dim, K), (2 * F, dim), (dim, F), (Nqk, dim), (Nv, dim))
            pairs = [_dummy(k, s, shp) for (k, s), shp in zip(kinds, shapes)]
            for rows in (1, 32, 33):
                want = j_rot.rot_supported(*(p[0] for p in pairs[:3]), [p[0] for p in pairs[3:]],
                                           rows, dim)
                got = t_rot.rot_supported(*(p[1] for p in pairs[:3]), [p[1] for p in pairs[3:]],
                                          rows, dim, 64)
                assert got == want, (dim, K, F, Nqk, Nv, kinds, rows)
                n += want
    assert n > 5


@pytest.mark.parametrize("impl", ["auto", "int8", "xla"])
def test_switches_and_impl_gate_as_the_reference(monkeypatch, tpu_backend, impl):
    """The *_enabled gates read the reference's switches and impl values the
    same way, on shapes that every *_supported passes."""
    rng = np.random.default_rng(1)
    jr = _rot_setup(1)[0]
    wo, gu, dn, wqk2, wv2 = (_port(w) for w in jr)
    jws, tws = zip(*(_both(s) for s in (
        _q4(rng, (LH + LHKV) * LHD, LD), _q6w(rng, LHKV * LHD, LD), _q4(rng, LD, LH * LHD, False),
        _q4(rng, 2 * LF, LD), _q6w(rng, LD, LF))))
    for env in ({}, {"TKQ_FUSE_ATTN_OUT": "1"}, {"TKQ_FUSE_LAYER": "1"},
                {"TKQ_ROTATE_LAYER": "1"}, {"TKQ_ROTATE_LAYER": "1", "TKQ_FUSE_OPROJ": "0"}):
        for k in SWITCHES:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        pairs = (
            (j_attn_out.attn_out_enabled(impl, jws[2], LH, LHKV, LHD, 1, 128),
             t_attn_out.attn_out_enabled(impl, tws[2], LH, LHKV, LHD, 1, 128)),
            (j_layer.layer_enabled(impl, *jws, 1, LD, LH, LHKV, LHD),
             t_layer.layer_enabled(impl, *tws, 1, LD, LH, LHKV, LHD)),
            (j_rot.rot_enabled(impl, *jr[:3], jr[3:], 1, 512),
             t_rot.rot_enabled(impl, wo, gu, dn, [wqk2, wv2], 1, 512, 64)))
        for want, got in pairs:
            assert got == want, (env, impl)


# ---------------------------------------------------------------------------
# the forward under each switch setting, against the JAX engine
# ---------------------------------------------------------------------------

# 2 layers at dim 512, 16 / 4 heads of 64 (H hd = 1024), ffn 512: every gate
# passes (attn_out's and layer's on f32 scales, rot's on either layout)
PATH_CFG = dict(n_layers=2, dim=512, n_heads=16, n_kv_heads=4, ffn_dim=512, vocab_size=512,
                max_seq_len=128)
PROMPT = [3, 100, 7, 256, 42, 9, 300, 5]
MAX_SEQ = 64

# (switches, scale layout, int8 KV, a decode step's plain calls)
PATHS = {
    "a: rotate": ({"TKQ_ROTATE_LAYER": "1"}, "bf16", False,
                  {"attn_in": 1, "rot": 1, "oproj_ffn": 1, "qmm": 1}),
    "b: layer + kv_append": ({"TKQ_FUSE_LAYER": "1", "TKQ_KV_APPEND_PALLAS": "1"}, "f32", False,
                             {"layer": 2, "kv_append": 2, "qmm": 1}),
    "c: attn_out, bf16 KV": ({"TKQ_FUSE_ATTN_OUT": "1", "TKQ_DEFER_APPEND": "0",
                              "TKQ_KV_APPEND_PALLAS": "1"}, "f32", False,
                             {"attn_in": 2, "kv_append": 2, "attn_out": 2, "ffn": 2, "qmm": 1}),
    "c: attn_out, int8 KV": ({"TKQ_FUSE_ATTN_OUT": "1", "TKQ_DEFER_APPEND": "0",
                              "TKQ_KV_APPEND_PALLAS": "1"}, "f32", True,
                             {"attn_in": 2, "attn_out": 2, "ffn": 2, "qmm": 1}),
}


def _path_config():
    cfg = tiny_config(**PATH_CFG)  # head_dim dim / n_heads = 32: widen it to 64
    return dataclasses.replace(cfg, head_dim=64,
                               rope=dataclasses.replace(cfg.rope, head_dim=64, n_rot=64))


@pytest.fixture(scope="module")
def path_models(tmp_path_factory):
    path = tmp_path_factory.mktemp("fused") / "fused.gguf"
    write_fixture_gguf(path, _path_config(), seed=5, recipe="q4_k_m")
    out = {}
    for scale_dtype in ("bf16", "f32"):
        jc, jp, _ = jload(str(path), scale_dtype=scale_dtype)
        tc, tp, _ = load_model(str(path), scale_dtype=scale_dtype, device="cpu")
        for kv8 in (False, True):
            je = JEngine(jc, jp, max_batch=1, max_seq=MAX_SEQ, impl="xla", kv_quantized=kv8)
            lj, jcache, lens = je.prefill([PROMPT], je.new_cache(1))
            tok = jnp.argmax(lj, -1)
            dj, _ = je.decode_step(tok, jnp.asarray(lens, jnp.int32), jcache)
            out[scale_dtype, kv8] = dict(
                cfg=tc, params=tp, prefill=np.asarray(lj[0], np.float32),
                decode=np.asarray(dj[0], np.float32),
                tokens=je.generate([PROMPT[:3]], max_new_tokens=8)[0])
    return out


@pytest.mark.parametrize("name", sorted(PATHS))
def test_fused_paths_match_jax(path_models, monkeypatch, name):
    env, scale_dtype, kv8, step = PATHS[name]
    ref = path_models[scale_dtype, kv8]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    te = InferenceEngine(ref["cfg"], ref["params"], max_batch=1, max_seq=MAX_SEQ,
                         kv_quantized=kv8, device="cpu")
    lt, cache, lens = te.prefill([PROMPT], te.new_cache(1))
    before = _plain_calls()
    dt, _ = te.decode_step(torch.argmax(lt, -1), torch.tensor(lens), cache)
    assert _delta(before) == step
    for got, want in ((lt[0], ref["prefill"]), (dt[0], ref["decode"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.05 * np.abs(want).max())
    before = _plain_calls()
    assert te.generate([PROMPT[:3]], max_new_tokens=8)[0] == ref["tokens"]
    calls = _delta(before)
    for k, v in step.items():  # 7 decode steps after the prefill
        assert calls.get(k, 0) >= 7 * v, (k, calls)


def test_switches_unset_keep_the_default_dispatch(path_models):
    ref = path_models["f32", False]
    te = InferenceEngine(ref["cfg"], ref["params"], max_batch=1, max_seq=MAX_SEQ, device="cpu")
    lt, cache, lens = te.prefill([PROMPT], te.new_cache(1))
    before = _plain_calls()
    te.decode_step(torch.argmax(lt, -1), torch.tensor(lens), cache)
    assert _delta(before) == {"attn_in": 2, "oproj_ffn": 2, "qmm": 1}
