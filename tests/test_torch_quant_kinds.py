"""Every GGML type the reference loads, held against the JAX package at small
sizes: repack bytes (both layouts, with and without widen_q6, bf16 pairs and
f32 scales), dequantize, qmm's plain version on the new kinds against
qmm_pallas in interpret mode, qmm_int8's q6 branch, the fused kernels' plain
versions with q8 / q6w / q4 in every slot, the widened gates, the quantize
tool's recipe function, and the port writer's drawn blocks.

Blocks come from the JAX package's ``quantize`` on numpy-seeded floats, and
both packages read the same numpy arrays. Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.gguf import GGMLType
from tpu_kquant.gguf import GGUFReader as JReader
from tpu_kquant.models.fixtures import mixtral_8x7b_config as j_mixtral
from tpu_kquant.models.fixtures import tinyllama_1b_config as j_tinyllama
from tpu_kquant.ops import pallas_attn_in as j_attn_in
from tpu_kquant.ops import pallas_ffn as j_ffn
from tpu_kquant.ops import pallas_qmm_int8 as j_qmm_int8_mod
from tpu_kquant.ops.pallas_qmm import pallas_supported, qmm_pallas
from tpu_kquant.ops.qmatmul import qmatmul as j_qmatmul
from tpu_kquant.quant import dequantize as j_dequantize
from tpu_kquant.quant import quantize
from tpu_kquant.quant import repack as jrepack
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime.loader import load_model as jload
from tpu_kquant.tools import quantize as j_quantize_tool
from tpu_kquant_torch.gguf import GGUFReader
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import qmatmul as t_qmatmul
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops import qmm_int8 as t_qmm_int8
from tpu_kquant_torch.quant import repack
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

BLOCK_TYPES = [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K,
               GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0]
KIND_TYPE = {"q2": GGMLType.Q2_K, "q3": GGMLType.Q3_K, "q4": GGMLType.Q4_K,
             "q5": GGMLType.Q5_K, "q6": GGMLType.Q6_K, "q6w": GGMLType.Q6_K,
             "q8": GGMLType.Q8_0}


def _np(qt):
    return {k: np.asarray(v) for k, v in qt.arrays.items()}


def _jq(qt, jax_arrays=False):
    conv = jnp.asarray if jax_arrays else np.asarray
    return JQTensor(qt.kind, qt.layout, tuple(qt.shape), {k: conv(v) for k, v in qt.arrays.items()})


def _port(qt):
    return QTensor(qt.kind, qt.layout, tuple(qt.shape), _np(qt)).to("cpu")


def _raw(qtype, N, K, seed):
    rng = np.random.default_rng(seed)
    return quantize(rng.standard_normal((N, K)).astype(np.float32) * 0.1, qtype)


def _ref_loaded(raw, qtype, shape, layout, pairs, widen):
    """The reference loader's steps (runtime/loader.py:_repack_named)."""
    qt = jrepack.repack(raw, qtype, shape, layout=layout)
    if widen:
        qt = jrepack.widen_q6(qt)
    if pairs:
        qt = jrepack.pack_scale_pairs(_jq(qt))
        if layout == "kmajor":
            qt = jrepack.pack_scale_kpairs(qt)
    return qt


def _port_loaded(raw, qtype, shape, layout, pairs, widen):
    qt = repack.repack(raw, qtype, shape, layout=layout)
    if widen:
        qt = repack.widen_q6(qt)
    if pairs:
        qt = repack.pack_scale_pairs(qt)
        if layout == "kmajor":
            qt = repack.pack_scale_kpairs(qt)
    return qt


def _kind_weight(kind, N, K, seed, pairs):
    """A kmajor weight of ``kind`` quantized by the reference, in its
    loader's layout (widened for q6w, bf16 pairs or f32 scales)."""
    qtype = KIND_TYPE[kind]
    return _ref_loaded(_raw(qtype, N, K, seed), qtype, (N, K), "kmajor", pairs, kind == "q6w")


# -- repack and dequantize ----------------------------------------------------------


@pytest.mark.parametrize("pairs", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("widen", [False, True], ids=["q6", "widen_q6"])
@pytest.mark.parametrize("layout", ["kmajor", "rowmajor"])
@pytest.mark.parametrize("qtype", BLOCK_TYPES, ids=lambda t: t.name)
def test_repack_bytes_match_reference(qtype, layout, widen, pairs):
    """Byte for byte the reference loader's repack, widen_q6 and scale
    pairing (K = 512: every block size; N = 96 rows)."""
    N, K = 96, 512
    raw = _raw(qtype, N, K, int(qtype) * 7 + N)
    want = _ref_loaded(raw, qtype, (N, K), layout, pairs, widen)
    got = _port_loaded(raw, qtype, (N, K), layout, pairs, widen)
    assert (got.kind, got.layout, tuple(got.shape)) == (want.kind, want.layout, tuple(want.shape))
    assert set(got.arrays) == set(want.arrays)
    for k, a in want.arrays.items():
        a, b = np.asarray(a), np.asarray(got.arrays[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("qtype", BLOCK_TYPES + [GGMLType.Q8_1, GGMLType.Q8_K, GGMLType.F16,
                                                 GGMLType.BF16, GGMLType.F32],
                         ids=lambda t: t.name)
def test_dequantize_matches_reference(qtype):
    """Every type the reference decodes, bit for bit (the port runs the
    reference's own arithmetic per type)."""
    N, K = 8, 512
    raw = _raw(qtype, N, K, int(qtype))
    got, want = repack.dequantize(raw, qtype, (N, K)), j_dequantize(raw, qtype, (N, K))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_dequantize_integer_types_match_reference():
    rng = np.random.default_rng(0)
    for qtype, dt in ((GGMLType.I8, "i1"), (GGMLType.I16, "<i2"), (GGMLType.I32, "<i4"),
                      (GGMLType.I64, "<i8"), (GGMLType.F64, "<f8")):
        raw = rng.integers(-100, 100, 24).astype(dt).view(np.uint8)
        got, want = repack.dequantize(raw, qtype, (4, 6)), j_dequantize(raw, qtype, (4, 6))
        assert got.tobytes() == want.tobytes(), qtype.name


# -- qmm's new kinds, qmm_int8's q6 branch ------------------------------------------


# (kind, K): a K the reference's pallas_supported takes (q5 needs K >= 2048)
QMM_KINDS = [("q8", 256), ("q5", 2048), ("q6", 512), ("q3", 1024), ("q2", 512)]


@pytest.mark.parametrize("pairs", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,K", QMM_KINDS)
def test_qmm_plain_matches_pallas_new_kinds(kind, K, pairs):
    """qmm_plain against qmm_pallas(interpret=True) and the XLA path on bf16
    activations, 3 rows, N = 256: within 3e-2 of max|ref|, the tolerance of
    tests/test_torch_kernels.py's bf16 case (the interpret kernel rounds its
    dequantized operands to bf16 per tile)."""
    assert pallas_supported(kind, K)
    N = 256
    qt = _kind_weight(kind, N, K, N + K, pairs)
    x = np.random.default_rng(K).standard_normal((3, K)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    got = t_qmm.qmm_plain(xt, _port(qt), torch.float32).numpy()
    jq = _jq(qt, True)
    for ref in (j_qmatmul(xj, jq, impl="xla", out_dtype=jnp.float32),
                qmm_pallas(xj, jq, out_dtype=jnp.float32, interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("pairs", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["q8", "q5", "q6", "q3", "q2"])
def test_kernel_kind_codes_of_the_new_kinds(kind, pairs):
    """Each loader layout maps to its csrc/common.cuh kind code."""
    K = 2048
    qt = _port(_kind_weight(kind, 64, K, 5, pairs))
    code = t_qmm.kernel_kind(qt)
    assert t_qmm.KINDS[code] == (kind, ("sp" if kind == "q8" else "sm") if pairs else "f32")
    assert t_qmm.k_ok(code, K) and not t_qmm.k_ok(code, K + 16)
    assert t_qmm.k_ok(code, K + 32) == (kind == "q8" and not pairs)


@pytest.mark.parametrize("R", [1, 5])
def test_qmm_int8_plain_q6_matches_reference(R):
    """The q6 branch (widen_q6=False, f32 scales and mins) against the
    reference's qmm_int8(interpret=True): within 1e-3 of max|ref| (both sum
    the same exact integer partials of the same 16-group Q8 codes)."""
    qt = _kind_weight("q6", 256, 512, 31 + R, pairs=False)
    assert qt.kind == "q6" and {"qh", "scales", "mins"} <= set(qt.arrays)
    x = np.random.default_rng(R).standard_normal((R, 512)).astype(np.float32)
    ref = np.asarray(j_qmm_int8_mod.qmm_int8(jnp.asarray(x), _jq(qt, True),
                                              out_dtype=jnp.float32, interpret=True))
    got = t_qmm_int8.qmm_int8_plain(torch.from_numpy(x), _port(qt), torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("case,rows", [
    (("q6", 512, "f32"), 1), (("q6", 512, "f32"), 32), (("q6", 512, "f32"), 33),
    (("q6", 256, "f32"), 1), (("q6", 1024, "pairs"), 1), (("q5", 2048, "f32"), 1),
    (("q8", 512, "f32"), 1), (("q2", 512, "f32"), 1), (("q3", 1024, "f32"), 1)])
def test_int8_gate_matches_reference_new_kinds(monkeypatch, case, rows):
    """The port's int8 gate (ops/qmatmul.py:int8_eligible) against the
    reference's qmatmul(impl="int8"): a spy in place of its qmm_int8 records
    whether the dispatch reaches it; q6 goes there, the other new kinds
    never do."""
    kind, K, layout = case
    qt = _kind_weight(kind, 256, K, rows + K, layout == "pairs")
    hit = []

    def spy(x, w, out_dtype=None, interpret=False):
        hit.append(True)
        return jnp.zeros(x.shape[:-1] + (w.shape[0],), out_dtype or x.dtype)

    monkeypatch.setattr(j_qmm_int8_mod, "qmm_int8", spy)
    j_qmatmul(jnp.ones((rows, K), jnp.bfloat16), _jq(qt, True), "int8")
    assert t_qmatmul.int8_eligible(_port(qt), rows) == bool(hit), (case, rows)


# -- the fused kernels with q8 / q6w / q4 in every slot -----------------------------


@pytest.mark.parametrize("kinds", [("q8", "q8", True), ("q6w", "q6w", True), ("q4", "q4", True),
                                   ("q8", "q8", False), ("q4", "q8", True)])
def test_attn_in_plain_every_slot_kind_matches_grid_kernel(kinds):
    """attn_in_plain against the reference's fused_attn_in(interpret=True) at
    D = 512, 4 + 2 heads of 128, R = 2, with the Q8_0 (q8, q8), Q6_K (q6w,
    q6w) and Q4_K_S (q4, q4) slots and a mixed pair; 3e-2 of max|ref|, the
    tolerance of tests/test_pallas_attn_in.py."""
    kq, kv, pairs = kinds
    D, hd, H, Hkv, R = 512, 128, 4, 2, 2
    wqk = _kind_weight(kq, (H + Hkv) * hd, D, 11, pairs)
    wv = _kind_weight(kv, Hkv * hd, D, 12, pairs)
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = (rng.random((R, hd // 2)).astype(np.float32) for _ in range(2))
    cf, sf = j_attn_in.rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd)
    o0, o1 = j_attn_in.fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-5,
                                     [_jq(wqk, True), _jq(wv, True)], cf, sf, hd // 2,
                                     interpret=True)
    tqk, tv = _port(wqk), _port(wv)
    assert t_attn_in.attn_in_supported(tqk, tv, R, D, hd)
    g0, g1 = t_attn_in.fused_attn_in(torch.from_numpy(x).to(torch.bfloat16),
                                     torch.from_numpy(nw), 1e-5, tqk, tv,
                                     torch.from_numpy(cos), torch.from_numpy(sin), hd)
    for got, ref in ((g0, o0), (g1, o1)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("kinds", [("q8", "q8", "q8", True), ("q6w", "q6w", "q6w", True),
                                   ("q8", "q8", "q8", False), ("q4", "q8", "q6w", True)])
def test_ffn_plains_every_slot_kind_match_reference(kinds):
    """oproj_ffn_plain and ffn_plain against the reference's fused_oproj_ffn
    and fused_ffn (interpret=True) with q8 or q6w in every slot (Q8_0, Q6_K)
    and a mix: D = 512, o_proj K = 1024, F = 512, R = 2; 3e-2 of max|ref|."""
    ko, kg, kd, pairs = kinds
    D, K, F, R = 512, 1024, 512, 2
    wo = _kind_weight(ko, D, K, 21, pairs)
    gu = _kind_weight(kg, 2 * F, D, 22, pairs)
    dn = _kind_weight(kd, D, F, 23, pairs)
    rng = np.random.default_rng(24)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((R, K)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    xj, aj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16)
    ref_o = np.asarray(j_ffn.fused_oproj_ffn(xj, aj, _jq(wo, True), jnp.asarray(nw), 1e-5,
                                             _jq(gu, True), _jq(dn, True), interpret=True),
                       np.float32)
    ref_f = np.asarray(j_ffn.fused_ffn(xj, jnp.asarray(nw), 1e-5, _jq(gu, True), _jq(dn, True),
                                       interpret=True), np.float32)
    two, tgu, tdn = _port(wo), _port(gu), _port(dn)
    assert t_ffn.oproj_ffn_supported(two, tgu, tdn, R) and t_ffn.ffn_supported(tgu, tdn, R)
    xt, at = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(attn).to(torch.bfloat16)
    got_o = t_ffn.fused_oproj_ffn(xt, at, two, torch.from_numpy(nw), 1e-5, tgu, tdn)
    got_f = t_ffn.fused_ffn(xt, torch.from_numpy(nw), 1e-5, tgu, tdn)
    for got, ref in ((got_o, ref_o), (got_f, ref_f)):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


# -- the gates over a grid of kinds, layouts and rows -------------------------------


def _meta(kind, N, K, side):
    """A weight of the given kind, shape and scale layout with placeholder
    arrays: the gates read only the kind, layout, shape and array names."""
    if kind == "dense":
        return {"w": None}, "dense"
    arrays = {"qs": None}
    if kind in ("q5", "q6", "q3"):
        arrays["qh"] = None
    if side == "pairs":
        arrays["sp" if kind in ("q6w", "q8") else "sm"] = None
    else:
        arrays["scales"] = None
        if kind not in ("q6w", "q8"):
            arrays["mins"] = None
    return arrays, "kmajor"


def _pair(kind, N, K, side):
    arrays, layout = _meta(kind, N, K, side)
    return (JQTensor(kind, layout, (N, K), arrays), QTensor(kind, layout, (N, K), arrays))


GATE_KINDS = ["q2", "q3", "q4", "q5", "q6", "q6w", "q8", "dense"]


@pytest.mark.parametrize("side", ["pairs", "f32"])
@pytest.mark.parametrize("kq", GATE_KINDS)
def test_attn_in_gate_matches_reference_over_kinds(kq, side):
    """attn_in_supported against the reference's, over every kind in either
    slot, both scale layouts, and rows / widths on both sides of its rules."""
    for kv in GATE_KINDS:
        for D, n0, n1, rows in ((2048, 2304, 256, 1), (2048, 2304, 256, 32),
                                (2048, 2304, 256, 33), (1536, 1792, 256, 8),
                                (1024, 1280, 200, 1), (768, 1024, 256, 1)):
            jqk, tqk = _pair(kq, n0, D, side)
            jv, tv = _pair(kv, n1, D, "f32" if side == "pairs" else "pairs")
            assert t_attn_in.attn_in_supported(tqk, tv, rows, D, 64) == \
                j_attn_in.attn_in_supported([jqk, jv], rows, D), (kq, kv, D, rows)


@pytest.mark.parametrize("side", ["pairs", "f32"])
@pytest.mark.parametrize("kg", GATE_KINDS)
def test_ffn_gates_match_reference_over_kinds(kg, side):
    """ffn_supported and oproj_ffn_supported against the reference's, over
    every kind of w_gateup, w_down and wo, both layouts, and rows / widths
    on both sides of their rules (D % 512, _pick_tf(F, D), K % 1024)."""
    for kd in GATE_KINDS:
        for ko in ("q4", "q6w", "q8", "q5", "dense"):
            for D, K, F, rows in ((2048, 2048, 5632, 1), (2048, 2048, 5632, 33),
                                  (1536, 1536, 8960, 1), (1024, 1024, 640, 4),
                                  (512, 1024, 512, 32), (768, 1024, 512, 1)):
                jgu, tgu = _pair(kg, 2 * F, D, side)
                jdn, tdn = _pair(kd, D, F, side)
                jwo, two = _pair(ko, D, K, "f32" if side == "pairs" else "pairs")
                assert t_ffn.ffn_supported(tgu, tdn, rows) == \
                    j_ffn.ffn_supported(jgu, jdn, rows), (kg, kd, D, F, rows)
                assert t_ffn.oproj_ffn_supported(two, tgu, tdn, rows) == \
                    j_ffn.oproj_ffn_supported(jwo, jgu, jdn, rows), (ko, kg, kd, D, K, F, rows)
    for F, D in ((5632, 2048), (8960, 1536), (640, 1024), (14336, 4096), (18944, 3584)):
        assert t_ffn._pick_tf(F, D) == j_ffn._pick_tf(F, D)


# -- the recipes and the port writer ------------------------------------------------


def _inventory(cfg):
    """(name, shape) of every tensor a llama-family GGUF of cfg holds."""
    D, H, Hkv, hd, F, V = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                           cfg.vocab_size)
    out = [("token_embd.weight", (V, D)), ("output_norm.weight", (D,)),
           ("output.weight", (V, D))]
    for i in range(2):
        p = f"blk.{i}."
        out += [(p + "attn_norm.weight", (D,)), (p + "attn_q.weight", (H * hd, D)),
                (p + "attn_k.weight", (Hkv * hd, D)), (p + "attn_v.weight", (Hkv * hd, D)),
                (p + "attn_q.bias", (H * hd,)), (p + "attn_output.weight", (D, H * hd)),
                (p + "ffn_norm.weight", (D,)), (p + "ffn_gate.weight", (F, D)),
                (p + "ffn_up.weight", (F, D)), (p + "ffn_down.weight", (D, F))]
        if cfg.n_experts:
            E = cfg.n_experts
            out += [(p + "ffn_gate_inp.weight", (E, D)), (p + "ffn_gate_exps.weight", (E, F, D)),
                    (p + "ffn_up_exps.weight", (E, F, D)), (p + "ffn_down_exps.weight", (E, D, F))]
    return out


@pytest.mark.parametrize("recipe", sorted(j_quantize_tool.RECIPES))
def test_recipe_types_match_reference(recipe):
    """The port's target_type is the quantize tool's _target_type for every
    tensor of TinyLlama, Qwen2.5-1.5B and Mixtral, and for widths whose
    blocks do not divide K (the Q8_0 / F16 fallbacks)."""
    assert set(t_fixtures.RECIPES) == set(j_quantize_tool.RECIPES)
    cfgs = [t_fixtures.tinyllama_1b_config(), t_fixtures.qwen2_5_1_5b_config(),
            t_fixtures.mixtral_8x7b_config(), t_fixtures.tiny_config(dim=64, ffn_dim=160),
            t_fixtures.tiny_config(dim=96, n_heads=4, ffn_dim=100)]
    for cfg in cfgs:
        for name, shape in _inventory(cfg):
            assert t_fixtures.target_type(name, shape, recipe) == \
                j_quantize_tool._target_type(name, shape, recipe), (recipe, name, shape)
    assert j_tinyllama().dim == t_fixtures.tinyllama_1b_config().dim
    assert j_mixtral().n_experts == t_fixtures.mixtral_8x7b_config().n_experts


@pytest.mark.parametrize("recipe", ["q8_0", "q5_k_m", "q3_k_m", "q2_k", "q6_k", "q4_k_s"])
def test_port_drawn_blocks_load_in_reference(tmp_path, recipe):
    """The port writer's drawn blocks (Q8_0, Q5_K, Q3_K, Q2_K beside Q4_K and
    Q6_K) under each recipe: both packages read the file, their loaders give
    the same bytes, every tensor decodes to the same floats, and the
    weights are centred with about the requested spread (0.05)."""
    cfg = t_fixtures.tiny_config(n_layers=1, dim=512, n_heads=8, n_kv_heads=2, ffn_dim=512,
                                 vocab_size=256)
    path = t_fixtures.write_fixture_gguf(tmp_path / f"{recipe}.gguf", cfg, seed=4, recipe=recipe)
    jr, tr = JReader(path), GGUFReader(path)
    types = set()
    for name, ti in tr.tensors.items():
        tj = jr.tensors[name]
        assert (int(ti.ggml_type), tuple(ti.shape)) == (int(tj.ggml_type), tuple(tj.shape))
        assert int(ti.ggml_type) == int(j_quantize_tool._target_type(name, ti.shape, recipe))
        w = j_dequantize(jr.tensor_bytes(name), tj.ggml_type, tj.shape)
        got = repack.dequantize(tr.tensor_bytes(name), ti.ggml_type, ti.shape)
        assert got.tobytes() == w.tobytes(), name
        if len(ti.shape) == 2:
            types.add(ti.ggml_type.name)
            assert abs(float(w.mean())) < 0.01 and 0.035 < float(w.std()) < 0.065, name
    want = {"q8_0": {"Q8_0"}, "q5_k_m": {"Q5_K", "Q6_K"}, "q3_k_m": {"Q3_K", "Q4_K", "Q5_K"},
            "q2_k": {"Q2_K", "Q4_K", "Q6_K"}, "q6_k": {"Q6_K"}, "q4_k_s": {"Q4_K"}}[recipe]
    assert types == want
    for scale_dtype in ("bf16", "f32"):
        for widen in (True, False):
            _, pj, _ = jload(path, scale_dtype=scale_dtype, widen_q6=widen)
            _, pt, _ = load_model(path, scale_dtype=scale_dtype, device="cpu", widen_q6=widen)
            _assert_same(pj, pt)


def _assert_same(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_same(ref[k], got[k], f"{path}/{k}")
        return
    if isinstance(ref, list):
        for i, (a, b) in enumerate(zip(ref, got, strict=True)):
            _assert_same(a, b, f"{path}[{i}]")
        return
    assert (ref.kind, ref.layout, tuple(ref.shape)) == (got.kind, got.layout, tuple(got.shape))
    assert set(ref.arrays) == set(got.arrays), path
    for k in ref.arrays:
        assert np.asarray(ref.arrays[k]).tobytes() == got.arrays[k].numpy().tobytes(), (path, k)
