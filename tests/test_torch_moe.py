"""The port's MoE and int8 path on the CPU against the JAX package.

Tiny Mixtral-style fixtures written by the JAX package's writer and loaded
by both packages: 2 layers, 4 query heads and 2 KV heads, ffn 256, 4 experts
of which 2 run per token, vocab 512; dim 256 (the smallest width whose
experts are Q4_K) and dim 512 (the smallest K at which the reference's int8
gate, ``pallas_supported``, lets q4 weights into ``qmm_int8``: at dim 256
the int8 configuration runs qmm everywhere, in both packages). Each runs
with bf16 scale pairs under ``impl="auto"`` and with f32 scales under
``impl="int8"``.

The JAX engine on the CPU runs its unfused path: ``impl="xla"`` for the
bf16 configuration, and under ``impl="int8"`` ``qmm_int8`` in interpret mode
for the router, the experts' gate/up and (its attn_in being TPU-gated) wqk.
The port follows the TPU dispatch: attn_in at decode rows, with no
activation quantization. Inputs are made by numpy from a seed and handed to
both packages; each comparison states its tolerance where it is made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_kquant.models.moe as j_moe
import tpu_kquant.ops.pallas_qmm_int8 as j_qmm_int8_mod
from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.gguf import GGUFReader as JReader
from tpu_kquant.models.fixtures import mixtral_8x7b_config as j_mixtral
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops.act_quant import quantize_activations as j_quantize
from tpu_kquant.ops.pallas_attn_in import fused_attn_in as j_fused_attn_in
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.ops.pallas_qmm import qmm_pallas
from tpu_kquant.ops.pallas_qmm_int8 import qmm_int8 as j_qmm_int8
from tpu_kquant.ops.qmatmul import qmatmul as j_qmatmul
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.gguf import GGMLType, GGUFReader, GGUFWriter
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.models import moe as t_moe
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import qmatmul as t_qmatmul
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops import qmm_int8 as t_qmm_int8
from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model, params_from_numpy

torch.set_num_threads(1)

MOE = dict(n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256, vocab_size=512, max_seq_len=128,
           n_experts=4, n_experts_used=2)
DIMS = (256, 512)
# (scale_dtype, port impl, JAX engine impl)
CONFIGS = {"bf16-auto": ("bf16", "auto", "xla"), "f32-int8": ("f32", "int8", "int8")}
PROMPTS = {n: [int(t) for t in np.random.default_rng(n).integers(3, 512, n)] for n in (8, 40)}
# The fixture seed: the packages' router logits differ by about 1% of their
# spread (bf16 roundings at other points), so some seeds put a routing
# decision of the 8-token prompt inside that noise. At this seed every such
# decision's margin (2nd against 3rd logit) is at least 5x the largest
# difference between the packages' router logits, in all four cells.
SEED = 12
# The writer draws the norm weights at the weights' scale (0.05), which makes
# the FFN's output about 1% of the residual stream: a fault in the MoE would
# move the logits far less than the comparisons' tolerance. The fixture
# scales both packages' ffn_norm weights by this gain, so that the MoE's
# output is about the residual's size (a planted routing fault then moves
# the logits by about 0.25 of max|ref|, against a 5e-2 tolerance).
FFN_NORM_GAIN = 10.0


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


def _plain_calls() -> dict:
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    """{dim: {"path": gguf, config name: (jax cfg, jax params, port cfg, port
    params)}} for the tiny MoE at dims 256 and 512, ffn_norm scaled by
    FFN_NORM_GAIN in both packages."""
    out = {}
    for dim in DIMS:
        cfg = tiny_config(dim=dim, **MOE)
        path = tmp_path_factory.mktemp("moe") / f"moe{dim}.gguf"
        write_fixture_gguf(path, cfg, seed=SEED, quant="q4_k_m", scale=0.05)
        out[dim] = {"path": str(path)}
        for name, (sd, _, _) in CONFIGS.items():
            jc, jp, _ = jload(str(path), scale_dtype=sd)
            tc, tp, _ = load_model(str(path), scale_dtype=sd, device="cpu")
            for jl, tl in zip(jp["layers"], tp["layers"]):
                q = jl["ffn_norm"]
                jl["ffn_norm"] = JQTensor(q.kind, q.layout, q.shape,
                                          {"w": q.arrays["w"] * FFN_NORM_GAIN})
                tl["ffn_norm"].arrays["w"] = tl["ffn_norm"].arrays["w"] * FFN_NORM_GAIN
            out[dim][name] = (jc, jp, tc, tp)
    return out


def _engines(moe, dim, name):
    jc, jp, tc, tp = moe[dim][name]
    _, impl, jimpl = CONFIGS[name]
    return (JEngine(jc, jp, max_batch=1, max_seq=64, impl=jimpl),
            InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu", impl=impl))


# -- config, fixture, GGUF ----------------------------------------------------------


def test_mixtral_preset_mirrors_reference():
    got, want = t_fixtures.mixtral_8x7b_config(), j_mixtral()
    for f in ("arch", "n_layers", "dim", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "max_seq_len", "n_experts", "n_experts_used"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rope.freq_base == want.rope.freq_base == 1e6
    back = ModelConfig.from_gguf(got.to_gguf_metadata())
    assert (back.is_moe, back.n_experts, back.n_experts_used) == (True, 8, 2)


def test_port_writer_moe_inventory_matches_jax(tmp_path):
    """Names, ggml types and shapes of the port writer's MoE file equal the
    reference writer's (the router Q4_K, the stacked downs Q6_K)."""
    cfg = t_fixtures.tiny_config(dim=256, **MOE)
    mine = GGUFReader(t_fixtures.write_fixture_gguf(tmp_path / "t.gguf", cfg, seed=1))
    theirs = JReader(write_fixture_gguf(tmp_path / "j.gguf", tiny_config(dim=256, **MOE), seed=1))
    assert list(mine.tensors) == list(theirs.tensors)
    for name, ti in mine.tensors.items():
        tj = theirs.tensors[name]
        assert (int(ti.ggml_type), tuple(ti.shape)) == (int(tj.ggml_type), tuple(tj.shape)), name
    assert mine.tensors["blk.0.ffn_gate_inp.weight"].ggml_type == GGMLType.Q4_K
    assert mine.tensors["blk.1.ffn_down_exps.weight"].ggml_type == GGMLType.Q6_K
    assert tuple(mine.tensors["blk.1.ffn_up_exps.weight"].shape) == (4, 256, 256)
    assert mine.metadata["llama.expert_count"] == 4


def test_gguf_3d_tensor_round_trips(tmp_path):
    """A 3-D tensor's dims are stored reversed (ggml order) and read back in
    numpy order by both readers; its bytes survive."""
    raw = np.arange(2 * 3 * 32, dtype=np.float32).view(np.uint8)
    w = GGUFWriter(tmp_path / "3d.gguf")
    w.add("general.architecture", "llama")
    w.add_tensor("x", (2, 3, 32), GGMLType.F32, raw)
    path = w.write()
    for r in (GGUFReader(path), JReader(path)):
        assert tuple(r.tensors["x"].shape) == (2, 3, 32)
        np.testing.assert_array_equal(np.asarray(r.tensor_bytes("x")), raw)


# -- loader ------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stacked_experts_match_jax_bytes(moe, name):
    """The stacked expert arrays and the router of both loaders, byte for
    byte, for bf16 pairs and f32 scales."""
    jc, jp, tc, tp = moe[256][name]
    assert tc.is_moe and tc.n_experts == 4 and tc.n_experts_used == 2
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert "w_gateup" not in tl and "w_down" not in tl
        pairs = [(jl["gate_inp"], tl["gate_inp"])] + [(jl["experts"][k], tl["experts"][k])
                                                      for k in ("w_gate", "w_up", "w_down")]
        for jq, tq in pairs:
            assert (tq.kind, tq.layout, tuple(tq.shape)) == (jq.kind, jq.layout, tuple(jq.shape))
            assert set(tq.arrays) == set(jq.arrays)
            for k in jq.arrays:
                assert tq.arrays[k].is_contiguous()
                np.testing.assert_array_equal(_bits(tq.arrays[k]), _bits(jq.arrays[k]))
    kinds = {k: v.kind for k, v in tp["layers"][0]["experts"].items()}
    assert kinds == {"w_gate": "q4", "w_up": "q4", "w_down": "q6w"}


def test_params_from_numpy_carries_experts(moe):
    _, jp, _, tp = moe[256]["f32-int8"]

    def export(v):
        if isinstance(v, dict):
            return {k: export(x) for k, x in v.items()}
        if isinstance(v, list):
            return [export(x) for x in v]
        if hasattr(v, "arrays"):
            return {"kind": v.kind, "layout": v.layout, "shape": v.shape,
                    "arrays": {k: np.asarray(a) for k, a in v.arrays.items()}}
        return np.asarray(v)

    got = params_from_numpy(export(jp), "cpu")
    for gl, tl in zip(got["layers"], tp["layers"]):
        assert set(gl) == set(tl) and set(gl["experts"]) == {"w_gate", "w_up", "w_down"}
        for k, tq in tl["experts"].items():
            gq = gl["experts"][k]
            assert tuple(gq.shape) == tuple(tq.shape) == (4,) + tuple(tq.shape[1:])
            for a in tq.arrays:
                np.testing.assert_array_equal(_bits(gq.arrays[a]), _bits(tq.arrays[a]))
        np.testing.assert_array_equal(_bits(gl["gate_inp"].arrays["qs"]),
                                      _bits(tl["gate_inp"].arrays["qs"]))


def test_expert_view_is_a_view(moe):
    _, _, _, tp = moe[256]["bf16-auto"]
    stk = tp["layers"][0]["experts"]["w_gate"]
    v = t_moe._expert_view(stk, 3)
    assert tuple(v.shape) == tuple(stk.shape[1:])
    for k, a in v.arrays.items():
        assert a.is_contiguous() and a.data_ptr() == stk.arrays[k][3].data_ptr()


# -- Q8 activations and the int8 product ---------------------------------------------


def _act_cases():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 256)) * 2).astype(np.float32)
    ties = x.copy()
    ties[0, :32] = 0.0  # an all-zero group
    # amax 127 -> scale 1: x / 1 lands exactly on .5 (half to even)
    ties[1, 32:64] = np.array([127.0, 2.5, -2.5, 0.5, 1.5, -0.5, -1.5, 3.5] * 4, np.float32)
    ties[2, 64:96] = 0.0
    ties[2, 64] = -1e-30  # a tiny group: scale in the subnormals' range
    bf16 = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return {"random": x, "ties_and_zeros": ties, "bf16_values": bf16}


@pytest.mark.parametrize("case", ["random", "ties_and_zeros", "bf16_values"])
def test_quantize_activations_is_byte_equal_to_jax(case):
    x = _act_cases()[case]
    want = j_quantize(jnp.asarray(x))
    got = quantize_activations(torch.from_numpy(x))
    assert got[0].dtype == torch.int8 and got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if case == "ties_and_zeros":
        assert got[0][1, 33:38].tolist() == [2, -2, 0, 2, 0]
        assert not got[0][0, :32].any() and got[2][0, 0] == 0 and got[1][0, 0] == 0


@pytest.mark.parametrize("K", [256, 2048])
@pytest.mark.parametrize("N", [8, 256])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_qmm_int8_plain_matches_pallas_interpret(R, N, K):
    """The plain version against qmm_int8(interpret=True) on the same
    repacked q4 arrays (f32 scales and mins): both quantize the activations
    alike and sum exact integer partials, so they differ only by the f32
    rescale's summation order; held to 1e-5 of max|ref|."""
    rng = np.random.default_rng(R + N + K)
    qt = mk_q4(N, K, rng, sm=False)
    x = rng.standard_normal((R, K)).astype(np.float32)
    ref = np.asarray(j_qmm_int8(jnp.asarray(x), qt, out_dtype=jnp.float32, interpret=True))
    c = t_qmm_int8.counter
    plain = c.plain_calls
    got = t_qmm_int8.qmm_int8(torch.from_numpy(x), _port(qt), torch.float32)
    assert c.plain_calls == plain + 1 and got.shape == (R, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_qmm_int8_plain_reads_the_q6_layout():
    """The kmajor q6 layout (qs + qh, mins = 32 s) that the reference kernel
    also takes: the plain version reads it (1e-5 of max|ref|)."""
    from tpu_kquant.quant import quantize
    from tpu_kquant.quant import repack as jrepack

    rng = np.random.default_rng(5)
    raw = quantize(rng.standard_normal((128, 512)).astype(np.float32) * 0.1, 14)  # Q6_K
    qt = jrepack.repack(raw, 14, (128, 512))
    assert qt.kind == "q6" and "qh" in qt.arrays
    x = rng.standard_normal((2, 512)).astype(np.float32)
    jqt = JQTensor(qt.kind, qt.layout, qt.shape, {k: jnp.asarray(v) for k, v in qt.arrays.items()})
    ref = np.asarray(j_qmm_int8(jnp.asarray(x), jqt, out_dtype=jnp.float32, interpret=True))
    got = t_qmm_int8.qmm_int8_plain(torch.from_numpy(x), _port(qt), torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_qmm_int8_wrapper_raises_off_the_cpu():
    """A non-CPU tensor never takes the plain version; the bf16-pair layouts
    (which the int8 gate never sends here) are refused by name."""
    qt = _port(mk_q4(8, 512, np.random.default_rng(0), sm=False))
    with pytest.raises(ValueError, match="device"):
        t_qmm_int8.qmm_int8(torch.empty(1, 512, dtype=torch.bfloat16, device="meta"), qt)
    q6 = QTensor("q6", "kmajor", (8, 512), {"qs": None, "qh": None, "sm": None})
    with pytest.raises(NotImplementedError, match="q6"):
        t_qmm_int8.qmm_int8(torch.empty(1, 512, device="meta"), q6)


# -- the f32-scale layouts of qmm and attn_in ----------------------------------------


@pytest.mark.parametrize("kind", ["q4", "q6w"])
@pytest.mark.parametrize("N,K,R", [(256, 512, 4), (128, 2048, 40)])
def test_qmm_plain_f32_layouts_match_pallas(kind, N, K, R):
    """qmm's plain version on f32 scales (q4 scales + mins, q6w scales)
    against qmm_pallas(interpret=True) on the same arrays, f32 activations;
    2e-2 of max|ref| as tests/test_torch_kernels.py's q6w case (the Pallas
    kernel rounds its MXU operands to bf16)."""
    rng = np.random.default_rng(N + K + R)
    qt = mk_q4(N, K, rng, sm=False) if kind == "q4" else mk_q6w(N, K, rng, sp=False)
    x = rng.standard_normal((R, K)).astype(np.float32)
    ref = np.asarray(qmm_pallas(jnp.asarray(x), qt, interpret=True), np.float32)
    assert t_qmm.kernel_kind(_port(qt)) == (2 if kind == "q4" else 3)
    got = t_qmm.qmm(torch.from_numpy(x), _port(qt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["q4", "q6w"])
def test_qmm_plain_f32_layouts_at_router_width_match_xla(kind):
    """N = 8 (a router's width), bf16 activations, against the reference's
    XLA path (both dequantize to bf16 and multiply in f32): 1e-5 of
    max|ref|."""
    rng = np.random.default_rng(8)
    qt = mk_q4(8, 512, rng, sm=False) if kind == "q4" else mk_q6w(8, 512, rng, sp=False)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(j_qmatmul(xb, qt, impl="xla", out_dtype=jnp.float32))
    got = t_qmm.qmm(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                    _port(qt), torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("R", [1, 3])
def test_attn_in_plain_f32_layouts_match_pallas_grid_kernel(R):
    """attn_in's plain version on f32 scales (wqk q4 scales + mins, wv q6w
    scales) against the Mosaic-grid kernel in interpret mode, at head_dim
    128; 3e-2 of max|ref|, the tolerance of tests/test_pallas_attn_in.py."""
    rng = np.random.default_rng(50 + R)
    D, hd, H, Hkv = 512, 128, 4, 2
    wqk, wv = mk_q4((H + Hkv) * hd, D, rng, sm=False), mk_q6w(Hkv * hd, D, rng, sp=False)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = rng.random((R, hd // 2)).astype(np.float32), rng.random((R, hd // 2)).astype(
        np.float32)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd)
    o0, o1 = j_fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-5, [wqk, wv],
                             cf, sf, hd // 2, interpret=True)
    tqk, tv = _port(wqk), _port(wv)
    assert (t_qmm.kernel_kind(tqk), t_qmm.kernel_kind(tv)) == (2, 3)  # q4-f32, q6w-f32
    assert t_attn_in.attn_in_supported(tqk, tv, R, D, hd, impl="int8")
    g0, g1 = t_attn_in.fused_attn_in(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(nw),
                                     1e-5, tqk, tv, torch.from_numpy(cos), torch.from_numpy(sin),
                                     hd)
    for got, ref in ((g0, o0), (g1, o1)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_attn_in_gate_takes_both_layouts_and_the_reference_impls():
    rng = np.random.default_rng(9)
    pairs = (_port(mk_q4(768, 512, rng)), _port(mk_q6w(256, 512, rng)))
    f32 = (_port(mk_q4(768, 512, rng, sm=False)), _port(mk_q6w(256, 512, rng, sp=False)))
    for ws, codes in ((pairs, (0, 1)), (f32, (2, 3))):
        assert tuple(map(t_qmm.kernel_kind, ws)) == codes
        for impl, ok in (("auto", True), ("int8", True), ("xla", False)):
            assert t_attn_in.attn_in_supported(*ws, 1, 512, 128, impl=impl) is ok
    # mixed layouts: the reference's gate fuses them, and the kernel reads
    # each slot's layout by its own kind code
    assert t_attn_in.attn_in_supported(pairs[0], f32[1], 1, 512, 128)
    assert t_attn_in.attn_in_supported(f32[0], pairs[1], 1, 512, 128)


def test_ffn_gates_pass_f32_layouts_and_wrappers_refuse_them_off_the_cpu():
    """As the reference's gates, ffn's and oproj_ffn's pass the kinds with
    f32 scales, and the kernels now read them too: the wrappers hand each
    weight to the kernel by its kind code of csrc/common.cuh (q4 with f32
    scales and mins: 2; q6w with f32 scales: 3) and refuse only the kinds no
    kernel reads; the CPU's plain versions read every layout."""
    rng = np.random.default_rng(10)
    gu, dn = _port(mk_q4(1024, 512, rng, sm=False)), _port(mk_q6w(512, 512, rng, sp=False))
    wo = _port(mk_q6w(512, 1024, rng, sp=False))
    assert t_ffn.ffn_supported(gu, dn, 1) and t_ffn.oproj_ffn_supported(wo, gu, dn, 1)
    code, arrs = t_qmm.packed_arrays(gu, "ffn")  # [codes, high plane, scales, mins]
    assert code == 2 and arrs[2] is gu.arrays["scales"] and arrs[3] is gu.arrays["mins"]
    code, arrs = t_qmm.packed_arrays(dn, "ffn")
    assert code == 3 and arrs[2] is dn.arrays["scales"] and arrs[3] is None
    assert not hasattr(t_ffn, "_require_pairs")
    x = torch.ones(1, 512, dtype=torch.bfloat16)
    y = t_ffn.fused_ffn(x, torch.ones(512), 1e-5, gu, dn)  # the CPU reads every layout
    assert y.shape == (1, 512) and torch.isfinite(y.float()).all()


# -- the impl="int8" gate -------------------------------------------------------------


def _gate_weight(case, rng):
    kind, K, layout = case
    if kind == "q4":
        return mk_q4(256, K, rng, sm=layout == "pairs")
    if kind == "q6w":
        return mk_q6w(256, K, rng, sp=layout == "pairs")
    return JQTensor("dense", "dense", (256, K), {"w": jnp.ones((256, K), jnp.float32)})


@pytest.mark.parametrize("case,rows", [
    (("q4", 512, "f32"), 1), (("q4", 512, "f32"), 32), (("q4", 512, "f32"), 33),
    (("q4", 256, "f32"), 1), (("q4", 768, "f32"), 8), (("q4", 2048, "pairs"), 1),
    (("q6w", 512, "f32"), 1), (("q6w", 512, "pairs"), 1), (("dense", 512, "f32"), 1)])
def test_int8_gate_matches_reference(monkeypatch, case, rows):
    """The port's gate against the reference's qmatmul(impl="int8"): a spy
    in place of the reference's qmm_int8 records whether its dispatch
    reaches it."""
    rng = np.random.default_rng(rows)
    qt = _gate_weight(case, rng)
    hit = []

    def spy(x, w, out_dtype=None, interpret=False):
        hit.append(True)
        return jnp.zeros(x.shape[:-1] + (w.shape[0],), out_dtype or x.dtype)

    monkeypatch.setattr(j_qmm_int8_mod, "qmm_int8", spy)
    x = jnp.ones((rows, case[1]), jnp.bfloat16)
    j_qmatmul(x, qt, "int8")
    assert t_qmatmul.int8_eligible(_port(qt), rows) == bool(hit), (case, rows)


def test_int8_gate_counts_leading_dims_and_refuses_stacks():
    rng = np.random.default_rng(1)
    qt = _port(mk_q4(256, 512, rng, sm=False))
    assert t_qmatmul.int8_eligible(qt, 2 * 16) and not t_qmatmul.int8_eligible(qt, 2 * 17)
    stk = QTensor("q4", "kmajor", (4, 256, 512), qt.arrays)
    assert not t_qmatmul.int8_eligible(stk, 1)
    with pytest.raises(ValueError, match="impl"):
        t_qmatmul.qmatmul(torch.ones(1, 512), qt, "xla")


# -- routing and the MoE FFN ------------------------------------------------------------


def test_routing_weights_match_jax():
    """top-2 of 4 logits, softmax over the two: 1e-6 (f32 softmax of the
    same two numbers)."""
    logits = np.random.default_rng(4).standard_normal((2, 5, 4)).astype(np.float32)
    want = np.asarray(j_moe._routing_weights(jnp.asarray(logits), 2))
    got = t_moe._routing_weights(torch.from_numpy(logits), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got > 0).sum(-1) == 2).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_ffn_matches_jax(moe, name):
    """moe_ffn of layer 0 on the same bf16 h [1, 3, 512], in both packages,
    per configuration (dim 512: under int8 the router and the experts'
    gate/up go through qmm_int8 on both sides, interpret mode in the
    reference); 1e-2 of max|ref|: the experts' outputs are rounded to bf16
    between gate/up and down in both, at the same points."""
    jc, jp, tc, tp = moe[512][name]
    _, impl, jimpl = CONFIGS[name]
    h = (np.random.default_rng(11).standard_normal((1, 3, 512))).astype(np.float32)
    hb = jnp.asarray(h, jnp.bfloat16)
    want = np.asarray(j_moe.moe_ffn(jp["layers"][0], jc, hb, jimpl), np.float32)
    before = _plain_calls()
    got = t_moe.moe_ffn(tp["layers"][0], tc,
                        torch.from_numpy(np.asarray(hb.astype(jnp.float32))).to(torch.bfloat16),
                        impl)
    used = {k: v - before[k] for k, v in _plain_calls().items()}
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 512)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())
    E = tc.n_experts
    if impl == "int8":
        assert used["qmm_int8"] == 1 + 2 * E and used["qmm"] == E
    else:
        assert used["qmm_int8"] == 0 and used["qmm"] == 1 + 3 * E


# -- the whole slice against the JAX engine ---------------------------------------------


@pytest.fixture
def routing_spy(monkeypatch):
    """(jax logits, port logits): the router logits of every moe_ffn call in
    both packages (the reference's through a debug callback, its jit caches
    cleared so that the callback is traced in, and cleared again after the
    test so that no later test runs it)."""
    jseen, tseen = [], []
    jreal, treal = j_moe._routing_weights, t_moe._routing_weights

    def jspy(logits, k):
        jax.debug.callback(lambda a: jseen.append(np.asarray(a)), logits)
        return jreal(logits, k)

    def tspy(logits, k):
        tseen.append(logits.float().numpy().copy())
        return treal(logits, k)

    monkeypatch.setattr(j_moe, "_routing_weights", jspy)
    monkeypatch.setattr(t_moe, "_routing_weights", tspy)
    jax.clear_caches()
    yield jseen, tseen
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("n", [8, 40])
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dim", DIMS)
def test_prefill_logits_match_jax(moe, dim, name, n):
    """Prefill of 8 tokens (bucket 16, decode rows: attn_in where D % 512 ==
    0, qmm_int8 under int8 at dim 512) and 40 tokens (bucket 64: qmm
    everywhere); logits within 5e-2 of max|ref| (the port's llama tests'
    tolerance; measured up to about 1e-2 here) and the same argmax."""
    je, te = _engines(moe, dim, name)
    lj, _, _ = je.prefill([PROMPTS[n]], je.new_cache(1))
    lt, _, _ = te.prefill([PROMPTS[n]], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dim", DIMS)
def test_selected_experts_match_jax(moe, routing_spy, dim, name):
    """The experts each package selects for every token and layer of the
    8-token prompt agree, and the agreement is not luck: the smallest router
    margin (2nd against 3rd logit) is over twice the largest router-logit
    difference between the packages, so no difference of that size could
    swap a selection (SEED says how far over)."""
    je, te = _engines(moe, dim, name)
    jseen, tseen = routing_spy
    je.prefill([PROMPTS[8]], je.new_cache(1))
    te.prefill([PROMPTS[8]], te.new_cache(1))
    assert len(jseen) == len(tseen) == 2
    margins, diffs = [], []
    for a, b in zip(jseen, tseen):
        a, b = a[0, :8], b[0, :8]
        sel_j = np.sort(np.argsort(-a, -1)[:, :2], -1)
        sel_t = np.sort(np.argsort(-b, -1)[:, :2], -1)
        np.testing.assert_array_equal(sel_t, sel_j)
        srt = -np.sort(-b, -1)
        margins.append((srt[:, 1] - srt[:, 2]).min())
        diffs.append(np.abs(a - b).max())
    assert min(margins) > 2 * max(diffs), (min(margins), max(diffs))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dim", DIMS)
def test_greedy_tokens_match_jax(moe, dim, name):
    """Greedy generation of 8 tokens after an 8-token prompt: the same ids.
    The packages differ by bf16 roundings and, under int8, by the reference
    quantizing wqk's activations on the CPU; far inside this random model's
    top-logit margins."""
    je, te = _engines(moe, dim, name)
    prompt = PROMPTS[8]
    assert te.generate([prompt], max_new_tokens=8) == je.generate([prompt], max_new_tokens=8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_dispatch(moe, name):
    """Per decode step at dim 512 (L = 2 layers, E = 4 experts): attn_in
    once per layer; under auto the router, 3E expert projections and o_proj
    per layer plus the lm head on qmm; under int8 the router and 2E gate/up
    on qmm_int8, o_proj and E downs (q6w) plus the lm head on qmm."""
    _, te = _engines(moe, 512, name)
    logits, cache, lens = te.prefill([PROMPTS[8]], te.new_cache(1))
    before = _plain_calls()
    pos = torch.tensor(lens)
    for t in (7, 99):
        logits, cache = te.decode_step(torch.tensor([t]), pos, cache)
        pos = pos + 1
    used = {k: v - before[k] for k, v in _plain_calls().items()}
    L, E = 2, 4
    assert used["attn_in"] == 2 * L and used["oproj_ffn"] == used["ffn"] == 0
    if name == "f32-int8":
        assert used["qmm_int8"] == 2 * (1 + 2 * E) * L and used["qmm"] == 2 * ((1 + E) * L + 1)
    else:
        assert used["qmm_int8"] == 0 and used["qmm"] == 2 * ((2 + 3 * E) * L + 1)


def test_prefill_comparison_fails_with_softmax_over_all_experts(moe, monkeypatch):
    """Planted fault: routing weights from a softmax over all E logits (then
    the top k kept, unnormalised) instead of over the selected ones. The
    logits comparison of test_prefill_logits_and_selected_experts_match_jax
    must then fail."""
    je, te = _engines(moe, 256, "bf16-auto")

    def faulty(logits, k):
        w = torch.softmax(logits, dim=-1)
        top = torch.topk(logits, k, dim=-1).indices
        return torch.zeros_like(w).scatter(-1, top, w.gather(-1, top))

    monkeypatch.setattr(t_moe, "_routing_weights", faulty)
    lj, _, _ = je.prefill([PROMPTS[8]], je.new_cache(1))
    lt, _, _ = te.prefill([PROMPTS[8]], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * np.abs(want).max())


def test_engine_refuses_unknown_impl(moe):
    _, _, tc, tp = moe[256]["bf16-auto"]
    with pytest.raises(ValueError, match="impl"):
        InferenceEngine(tc, tp, device="cpu", impl="xla")
