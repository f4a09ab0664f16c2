"""The int8 folds of the grid kernels #3 (attn_in), #5 (oproj_ffn) and #6
(ffn), their switches and dispatch, and the Llama-3 presets, on the CPU.

The reference's grid kernels run in interpret mode on the CPU, where its
dispatch never takes a manual variant (its ``manual_*_enabled`` return
False off the TPU), so they fold at every row count under
TKQ_INT8_FOLDS=1. The port computes the TPU's choice: the tests that hold
a folded port to the reference set TKQ_MANUAL_* to "0" where the TPU would
take the manual variant.

The folds move the reference's own output by about 1% of the block's delta
(its "fold gap": folded against unfolded on the same inputs), below every
tolerance the kernel tests use. So each fold test holds the port's folded
delta within a quarter of that gap (mean absolute error, f32), and checks
that the port with folds forced off fails the same criterion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.models import fixtures as j_fixtures
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops import pallas_attn_in as j_attn_in
from tpu_kquant.ops import pallas_dequant as j_dequant
from tpu_kquant.ops import pallas_ffn as j_ffn
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.ops import _build, dequant
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import layer as t_layer
from tpu_kquant_torch.ops import rot as t_rot
from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime import engine as t_engine
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

SWITCHES = ("TKQ_INT8_FOLDS", "TKQ_Q4_MXU_MINS", "TKQ_GROUP_SCALE", "TKQ_MANUAL_ATTN_IN",
            "TKQ_MANUAL_OPROJ")
D, F, EPS = 512, 768, 1e-5  # tests/test_pallas_ffn.py's widths


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    """Every test starts from the reference's defaults (switches unset)."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _only(monkeypatch, **kv):
    """Exactly these switches set, every other one unset."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in kv.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _hold(port_fold, port_off, ref_fold, ref_off, what):
    """The criterion: the folded port's mean |error| against the folded
    reference is below a quarter of the reference's fold gap; the port
    with its folds off is not."""
    gap = float(np.abs(ref_fold - ref_off).mean())
    err = float(np.abs(port_fold - ref_fold).mean())
    err_off = float(np.abs(port_off - ref_fold).mean())
    assert gap > 0, f"{what}: the folds moved nothing"
    assert err < gap / 4, f"{what}: mean |port - ref| {err:.3e} >= gap / 4 ({gap:.3e} / 4)"
    assert err_off >= gap / 4, (f"{what}: the unfolded port passes too ({err_off:.3e} < "
                                f"{gap:.3e} / 4): the criterion cannot see the folds")


# -- module 3: the activation quantization -------------------------------------------


@pytest.mark.parametrize("R", [1, 3, 16])
def test_act_quant_equals_reference_on_normed_rows(R):
    """quantize_activations gives act_quant_to_scratch's xq, xs and gs bit
    for bit on normalised rows (the reference's own norm, in f32)."""
    rng = np.random.default_rng(R)
    x = _bf16(rng.standard_normal((R, D)).astype(np.float32) * 2)
    x[0, :32] = 0.0  # an all-zero group: scale 0, codes 0
    nw = (rng.random(D) + 0.5).astype(np.float32)
    xf = jnp.asarray(x)
    xn = xf * jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + EPS) * jnp.asarray(nw)
    g = 32
    xq = np.zeros((D // g, g, R), np.int8)
    xs = np.zeros((D // g, R), np.float32)
    gs = np.zeros((D // g, R), np.float32)
    j_dequant.act_quant_to_scratch(xn, xq, xs, gs, g)
    tq, ts, tg = quantize_activations(torch.from_numpy(np.array(xn)), g)
    np.testing.assert_array_equal(tq.numpy(), xq.transpose(2, 0, 1).reshape(R, D))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), xs.T.view(np.uint32))
    np.testing.assert_array_equal(tg.numpy().view(np.uint32), gs.T.view(np.uint32))


# -- the folded kernels against the reference's grid kernels ------------------------------


def _ffn_case(sm: bool, R: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    gu, dn = mk_q4(2 * F, D, rng, sm=sm), mk_q6w(D, F, rng, sp=sm)
    x = _bf16(rng.standard_normal((R, D)).astype(np.float32))
    nw = (rng.random(D) + 0.5).astype(np.float32)
    return gu, dn, x, nw


@pytest.mark.parametrize("sm", [True, False], ids=["q4-sm", "q4-f32"])
def test_ffn_folds_match_the_grid_kernel(sm, monkeypatch):
    """#6: fused_ffn's q4 gate/up folded (pallas_ffn.py:154-162, :201-204)."""
    gu, dn, x, nw = _ffn_case(sm)

    def ref(folds):
        _only(monkeypatch, TKQ_INT8_FOLDS="1" if folds else None)
        return np.asarray(j_ffn.fused_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), EPS, gu,
                                          dn, interpret=True), np.float32) - x

    def port(folds):
        _only(monkeypatch, TKQ_INT8_FOLDS="1" if folds else "0")
        c = t_ffn.ffn_fold_counter.plain_calls
        y = t_ffn.fused_ffn(_t(x), torch.from_numpy(nw), EPS, _port(gu), _port(dn))
        assert t_ffn.ffn_fold_counter.plain_calls - c == int(folds)
        return y.float().numpy() - x

    _hold(port(True), port(False), ref(True), ref(False), f"ffn {'sm' if sm else 'f32'}")


@pytest.mark.parametrize("wo_kind", ["q4", "q6w"])
def test_oproj_ffn_folds_match_the_grid_kernel(wo_kind, monkeypatch):
    """#5: a q4 wo folds on the attention output (pallas_ffn.py:474-477), a
    q4 gate/up on the normalised x2 (:543). The fixture's layout (wo q6w-sp)
    sends the TPU to the grid at every row count; with a q4-sm wo it takes
    the manual variant at rows <= 8, so the port is asked for the grid
    (TKQ_MANUAL_OPROJ=0)."""
    rng = np.random.default_rng(5)
    K, R = 1024, 4
    wo = mk_q4(D, K, rng) if wo_kind == "q4" else mk_q6w(D, K, rng)
    gu, dn, x, nw = _ffn_case(True, R, seed=6)
    attn = _bf16(rng.standard_normal((R, K)).astype(np.float32))
    manual = "0" if wo_kind == "q4" else None

    def ref(folds):
        _only(monkeypatch, TKQ_INT8_FOLDS="1" if folds else None)
        return np.asarray(j_ffn.fused_oproj_ffn(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw),
            EPS, gu, dn, interpret=True), np.float32) - x

    def port(folds):
        _only(monkeypatch, TKQ_INT8_FOLDS="1" if folds else "0", TKQ_MANUAL_OPROJ=manual)
        assert t_ffn.oproj_ffn_folds(_port(wo), _port(gu), _port(dn), R) == \
            (folds and wo_kind == "q4", folds)
        y = t_ffn.fused_oproj_ffn(_t(x), _t(attn), _port(wo), torch.from_numpy(nw), EPS,
                                  _port(gu), _port(dn))
        return y.float().numpy() - x

    _hold(port(True), port(False), ref(True), ref(False), f"oproj_ffn wo {wo_kind}")


def _attn_in_case(R: int, n_heads: int, seed: int):
    rng = np.random.default_rng(seed)
    hd, Hkv = 128, 2
    wqk, wv = mk_q4((n_heads + Hkv) * hd, D, rng), mk_q6w(Hkv * hd, D, rng)
    x = _bf16(rng.standard_normal((R, D)).astype(np.float32))
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos = rng.random((R, hd // 2)).astype(np.float32)
    sin = rng.random((R, hd // 2)).astype(np.float32)
    return wqk, wv, x, nw, cos, sin, hd, n_heads + Hkv


@pytest.mark.parametrize("R,env,heads", [
    (16, {"TKQ_INT8_FOLDS": "1"}, 4),
    (1, {"TKQ_INT8_FOLDS": "1", "TKQ_MANUAL_ATTN_IN": "0"}, 4),
    # "auto" at an 8B-class width (wqk 4096 columns) with the MXU mins off
    (16, {"TKQ_Q4_MXU_MINS": "0"}, 30),
], ids=["R16", "R1-grid", "R16-auto"])
def test_attn_in_folds_match_the_grid_kernel(R, env, heads, monkeypatch):
    """#3: the q4 slot folds on the normalised rows (pallas_attn_in.py:
    171-179); the flat wv slot is unchanged."""
    wqk, wv, x, nw, cos, sin, hd, nr = _attn_in_case(R, heads, seed=R + heads)
    cf, sf = j_attn_in.rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), nr, hd)

    def ref(folds):
        _only(monkeypatch, **(env if folds else {"TKQ_INT8_FOLDS": "0"}))
        outs = j_attn_in.fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), EPS,
                                       [wqk, wv], cf, sf, hd // 2, interpret=True)
        return np.concatenate([np.asarray(o, np.float32) for o in outs], -1)

    def port(folds):
        _only(monkeypatch, **(env if folds else {"TKQ_INT8_FOLDS": "0"}))
        c = t_attn_in.fold_counter.plain_calls
        outs = t_attn_in.fused_attn_in(_t(x), torch.from_numpy(nw), EPS, _port(wqk), _port(wv),
                                       torch.from_numpy(cos), torch.from_numpy(sin), hd)
        assert t_attn_in.fold_counter.plain_calls - c == int(folds)
        return np.concatenate([o.float().numpy() for o in outs], -1)

    _hold(port(True), port(False), ref(True), ref(False), f"attn_in R={R} {env}")


def test_folded_oproj_ffn_rounds_as_the_grid_kernel(monkeypatch):
    """A fold runs the grid variant's function (#5), which rounds the o_proj
    sum to bf16 before the residual (pallas_ffn.py:531-536). At the
    fixture's q6w wo the folded port equals its plain form with that
    rounding, and without it the criterion of the fold tests fails."""
    rng = np.random.default_rng(9)
    K, R = 1024, 2
    wo = mk_q6w(D, K, rng)
    gu, dn, x, nw = _ffn_case(True, R, seed=10)
    attn = _bf16(rng.standard_normal((R, K)).astype(np.float32))
    _only(monkeypatch, TKQ_INT8_FOLDS="1")
    ref = np.asarray(j_ffn.fused_oproj_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw), EPS,
        gu, dn, interpret=True), np.float32) - x
    args = (_t(x), _t(attn), _port(wo), torch.from_numpy(nw), EPS, _port(gu), _port(dn))
    got = t_ffn.fused_oproj_ffn(*args).float().numpy() - x
    plain = lambda rf: t_ffn.oproj_ffn_plain(  # noqa: E731
        *args, folds=(False, True), round_first=rf).float().numpy() - x
    np.testing.assert_array_equal(got, plain(True))
    _only(monkeypatch)
    gap = float(np.abs(ref - (np.asarray(j_ffn.fused_oproj_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw), EPS,
        gu, dn, interpret=True), np.float32) - x)).mean())
    assert float(np.abs(got - ref).mean()) < gap / 4
    assert float(np.abs(plain(False) - ref).mean()) >= gap / 4


@pytest.mark.parametrize("env", [{"TKQ_GROUP_SCALE": "1"}, {"TKQ_Q4_MXU_MINS": "0"}],
                         ids=["group-scale", "no-mxu-mins"])
@pytest.mark.parametrize("kernel", ["attn_in", "ffn"])
def test_unfolded_switches_change_no_kernel(kernel, env, monkeypatch):
    """TKQ_GROUP_SCALE=1 (rows <= 8) and TKQ_Q4_MXU_MINS=0 move where the
    reference applies its scales and mins; the port's unfolded kernels
    (which apply scales per group already) stay within the usual 2e-2 of
    max|ref| of both, and do not change."""
    _env(monkeypatch, **env)
    if kernel == "ffn":
        gu, dn, x, nw = _ffn_case(True, 4, seed=11)
        ref = np.asarray(j_ffn.fused_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), EPS, gu,
                                         dn, interpret=True), np.float32)
        got = t_ffn.fused_ffn(_t(x), torch.from_numpy(nw), EPS, _port(gu), _port(dn))
        base = t_ffn.ffn_plain(_t(x), torch.from_numpy(nw), EPS, _port(gu), _port(dn))
        got, base = got.float().numpy(), base.float().numpy()
    else:
        wqk, wv, x, nw, cos, sin, hd, nr = _attn_in_case(4, 4, seed=12)
        cf, sf = j_attn_in.rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), nr, hd)
        _env(monkeypatch, TKQ_MANUAL_ATTN_IN="0")
        ref = np.concatenate([np.asarray(o, np.float32) for o in j_attn_in.fused_attn_in(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), EPS, [wqk, wv], cf, sf, hd // 2,
            interpret=True)], -1)
        args = (_t(x), torch.from_numpy(nw), EPS, _port(wqk), _port(wv), torch.from_numpy(cos),
                torch.from_numpy(sin), hd)
        got = np.concatenate([o.float().numpy() for o in t_attn_in.fused_attn_in(*args)], -1)
        base = np.concatenate([o.float().numpy() for o in t_attn_in.attn_in_plain(*args)], -1)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_layer_and_rot_never_fold(monkeypatch):
    """#11 and #12 have no int8 branch in the reference (_layer_call,
    _rot_call): under every fold switch their outputs do not move and no
    fold is counted."""
    rng = np.random.default_rng(13)
    H, Hkv, hd, K, B, S = 8, 2, 64, 512, 2, 64
    ws = dict(wqk=mk_q4((H + Hkv) * hd, D, rng), wv=mk_q6w(Hkv * hd, D, rng, sp=False),
              wo=mk_q4(D, H * hd, rng), gu=mk_q4(2 * F, D, rng), dn=mk_q6w(D, F, rng, sp=False))
    w = {k: _port(v) for k, v in ws.items()}
    x = _t(rng.standard_normal((B, 1, D)).astype(np.float32))
    attn = _t(rng.standard_normal((B, 1, K)).astype(np.float32))
    nw = torch.from_numpy((rng.random(D) + 0.5).astype(np.float32))
    cos = torch.from_numpy(rng.random((B, 1, hd // 2)).astype(np.float32))
    sin = torch.from_numpy(rng.random((B, 1, hd // 2)).astype(np.float32))
    kc = _t(rng.standard_normal((B, Hkv, S, hd)).astype(np.float32))
    vc = _t(rng.standard_normal((B, Hkv, S, hd)).astype(np.float32))
    pos = torch.tensor([[5], [17]])

    def run():
        folds = [c.plain_calls for c in (t_attn_in.fold_counter, t_ffn.fold_counter)]
        outs = [*t_rot.fused_oproj_ffn_attn_in(x, attn, w["wo"], nw, EPS, w["gu"], w["dn"], nw,
                                               w["wqk"], w["wv"], cos, sin, hd),
                *t_layer.fused_layer(x, pos, nw, nw, EPS, w["wqk"], w["wv"], w["wo"], w["gu"],
                                     w["dn"], cos, sin, kc, vc, H, Hkv)]
        assert [c.plain_calls for c in (t_attn_in.fold_counter, t_ffn.fold_counter)] == folds
        return outs

    base = run()
    _env(monkeypatch, TKQ_INT8_FOLDS="1", TKQ_MANUAL_ATTN_IN="0", TKQ_MANUAL_OPROJ="0",
         TKQ_Q4_MXU_MINS="0")
    for a, b in zip(run(), base):
        assert torch.equal(a, b)


# -- the dispatch -----------------------------------------------------------------------


def _weights(kind: str, side: str, N: int, K: int) -> tuple[JQTensor, QTensor]:
    """A weight of each package with the given kind and scale arrays; the
    predicates read only kind, shape and array names."""
    keys = {("q4", "sm"): ("qs", "sm"), ("q4", "f32"): ("qs", "scales", "mins"),
            ("q6w", "sp"): ("qs", "sp"), ("q6w", "f32"): ("qs", "scales"),
            ("q8", "sp"): ("qs", "sp"), ("q8", "f32"): ("qs", "scales")}[kind, side]
    z = np.zeros((1, 1), np.float32)
    return (JQTensor(kind, "kmajor", (N, K), {k: jnp.asarray(z) for k in keys}),
            QTensor(kind, "kmajor", (N, K), {k: torch.from_numpy(z) for k in keys}))


KIND_SIDES = [("q4", "sm"), ("q4", "f32"), ("q6w", "sp"), ("q6w", "f32"), ("q8", "sp"),
              ("q8", "f32")]
ENVS = [dict(zip(SWITCHES, v)) for v in (
    (None, None, None, None, None), ("1", None, None, None, None), ("1", None, None, "0", "0"),
    ("0", None, None, None, None), (None, "0", None, None, None), ("1", "0", "1", "0", None),
    (None, "0", None, "0", "0"), ("auto", "1", "1", "1", "1"))]


@pytest.fixture
def tpu_backend(monkeypatch):
    """The reference's manual_* predicates give their TPU answer."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_fold_dispatch_agrees_with_the_reference_on_the_tpu(env, tpu_backend, monkeypatch):
    """attn_in, oproj_ffn and ffn fold where the reference's TPU dispatch
    runs a grid variant with its int8 branch: over kinds, scale layouts,
    biases, rows 1, 8, 9, 32 and the switches."""
    _env(monkeypatch, **ENVS[env])
    for (k0, s0), (k1, s1) in [(a, b) for a in KIND_SIDES for b in KIND_SIDES]:
        for n0 in (2304, 5120):
            j0, t0 = _weights(k0, s0, n0, 2048)
            j1, t1 = _weights(k1, s1, 1024, 2048)
            for rows in (1, 8, 9, 32):
                for bias in (False, True):
                    jb = [np.zeros(n0), np.zeros(1024)] if bias else None
                    manual = j_attn_in.manual_attn_in_enabled([j0, j1], jb, rows)
                    assert dequant.manual_attn_in([t0, t1], jb, rows) == manual
                    nq = max([n for w, n in ((j0, n0), (j1, 1024)) if w.kind == "q4"],
                             default=0)
                    want = nq > 0 and not manual and j_dequant.attn_in_int8_auto(nq)
                    assert t_attn_in.folds(t0, t1, rows, jb) == want, (k0, s0, k1, s1, rows)
                # oproj_ffn: wo (t0's kind and layout), gate/up (t1's), down flat
                for dk, ds in KIND_SIDES[2:]:
                    jd, td = _weights(dk, ds, 2048, 1024)
                    manual = j_ffn.manual_oproj_enabled(j0, j1, jd, rows)
                    assert dequant.manual_oproj(t0, t1, td, rows) == manual
                    i8 = j_dequant.int8_folds_enabled() and not manual
                    assert dequant.oproj_ffn_folds(t0, t1, td, rows) == \
                        (i8 and k0 == "q4", i8 and k1 == "q4")
        assert dequant.ffn_folds(t1) == (j_dequant.int8_folds_enabled() and k1 == "q4")
    for rows in (1, 8, 9):
        assert dequant.group_dot_enabled(rows) == j_dequant.group_dot_enabled(rows)


@pytest.mark.parametrize("mxu", [None, "1", "0"])
@pytest.mark.parametrize("folds", [None, "auto", "0", "1"])
def test_attn_in_auto_rule_at_model_widths(folds, mxu, monkeypatch):
    """The auto rule at TinyLlama's wqk (2304), Llama-3-8B's (5120) and the
    rule's edge (4096): on under TKQ_INT8_FOLDS=1, or "auto" with
    TKQ_Q4_MXU_MINS=0 from 4096 columns on."""
    _env(monkeypatch, TKQ_INT8_FOLDS=folds, TKQ_Q4_MXU_MINS=mxu)
    for n in (2304, 4096, 5120):
        want = folds == "1" or (folds in (None, "auto") and mxu == "0" and n >= 4096)
        assert dequant.attn_in_int8_auto(n) == j_dequant.attn_in_int8_auto(n) == want
    assert dequant.int8_folds_enabled() == j_dequant.int8_folds_enabled() == (folds == "1")
    assert dequant.mxu_mins_enabled() == j_dequant.mxu_mins_enabled() == (mxu != "0")


def test_phi3_fused_wqkv_is_one_weight_to_the_auto_rule(monkeypatch):
    """The reference passes phi3's wqkv as one weight: never the manual
    variant, and its whole width (not the qk slot's) meets the auto rule."""
    rng = np.random.default_rng(14)
    wqkv = _port(mk_q4(4096, D, rng))
    qk, v = t_attn_in.qkv_slots(wqkv, 3072)
    _env(monkeypatch, TKQ_Q4_MXU_MINS="0")
    assert t_attn_in.folds(qk, v, 1)  # 4096 columns as one weight; 3072 alone would not fold
    assert not dequant.attn_in_int8_auto(3072)


# -- the presets and the Llama-3 shape family ------------------------------------------------


@pytest.mark.parametrize("name", ["llama3_8b_config", "llama3_70b_config"])
def test_llama3_presets_equal_the_reference(name):
    port, ref = getattr(t_fixtures, name)(), getattr(j_fixtures, name)()
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):  # RopeParams: a class of each package
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


LLAMA3_CUT = dict(n_layers=2, dim=1024, n_heads=8, n_kv_heads=2, ffn_dim=1024, vocab_size=512,
                  max_seq_len=128)
TOKENS = [3, 100, 7, 256, 42, 9, 300, 5]


@pytest.fixture(scope="module")
def llama3_cut(tmp_path_factory):
    """Llama-3-8B's shape family cut to 2 layers at narrow widths: GQA 4:1,
    head_dim 128, rope base 5e5, the fused gates passing."""
    cfg = tiny_config(**LLAMA3_CUT)
    cfg = dataclasses.replace(cfg, rope=dataclasses.replace(cfg.rope, freq_base=500000.0))
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (128, 4)
    path = tmp_path_factory.mktemp("llama3") / "llama3-cut.gguf"
    write_fixture_gguf(path, cfg, seed=3, quant="q4_k_m", scale=0.05)
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
    assert tc.rope.freq_base == jc.rope.freq_base == 500000.0
    return (JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla"),
            InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu"))


def test_llama3_cut_matches_jax(llama3_cut):
    """Prefill logits within the port's usual 5e-2 of max|ref|, and the
    greedy stream JAX's up to a near tie (a random model's logits are
    flat: top-2 margins of 1e-3 occur; ROADMAP, Settled), the first half at
    least, through the fused plain versions (attn_in, oproj_ffn)."""
    je, te = llama3_cut
    lj, _, _ = je.prefill([TOKENS], je.new_cache(1))
    lt, _, _ = te.prefill([TOKENS], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    before = {k: c.plain_calls for k, c in _build.COUNTERS.items()}
    prompt = TOKENS[:3]
    mine = te.generate([prompt], max_new_tokens=8)[0]
    ref = je.generate([prompt], max_new_tokens=8)[0]
    after = {k: c.plain_calls for k, c in _build.COUNTERS.items()}
    n = next((i for i, (a, b) in enumerate(zip(mine, ref)) if a != b), len(ref))
    assert n >= 4, (mine, ref)
    if n < len(ref):
        lj, _, _ = je.prefill([prompt + ref[:n]], je.new_cache(1))
        top = np.sort(np.asarray(lj[0], np.float32))
        assert top[-1] - top[-2] < 0.02 * top[-1], (n, mine, ref, top[-2:])
    assert after["attn_in"] - before["attn_in"] == 8 * 2
    assert after["oproj_ffn"] - before["oproj_ffn"] == 8 * 2
    assert after["attn_in.folded"] == before["attn_in.folded"]


def test_llama3_cut_folds_under_the_switch(llama3_cut, monkeypatch):
    """Under TKQ_INT8_FOLDS=1 every forward folds oproj_ffn's q4 gate/up (wo
    is q6w, so the TPU takes the grid), and attn_in folds in the layers
    where the TPU takes the grid (past 8 rows, or a wv that is not the
    manual variant's q6w-sp, or TKQ_MANUAL_ATTN_IN=0); the folded
    logits stay within the usual 5e-2 of max|ref| of the unfolded ones."""
    _, te = llama3_cut
    layers = te.params["layers"]
    want = te.prefill([TOKENS], te.new_cache(1))[0][0].numpy()
    rows = t_engine._bucket(len(TOKENS))  # the prefill's padded rows
    _env(monkeypatch, TKQ_INT8_FOLDS="1")
    for manual in ("1", "0"):
        _env(monkeypatch, TKQ_MANUAL_ATTN_IN=manual)
        folded = sum(t_attn_in.folds(lay["wqk"], lay["wv"], rows) for lay in layers)
        assert folded == (len(layers) if manual == "0" or rows > 8 else
                          sum(lay["wv"].kind == "q4" for lay in layers))
        before = {k: c.plain_calls for k, c in _build.COUNTERS.items()}
        got = te.prefill([TOKENS], te.new_cache(1))[0][0].numpy()
        after = {k: c.plain_calls for k, c in _build.COUNTERS.items()}
        assert after["oproj_ffn.folded"] - before["oproj_ffn.folded"] == len(layers)
        assert after["attn_in.folded"] - before["attn_in.folded"] == folded
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * np.abs(want).max())
