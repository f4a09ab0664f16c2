"""The port's gemma family on the CPU against the JAX package.

- GELU: the plain versions of the fused FFN kernels (ffn, oproj_ffn in its
  manual (#4) and grid (#5) forms, layer, rot) with ``act_fn="gelu"``
  against the Pallas kernels in interpret mode, and ``geglu``.
- head_dim 256: attn_in's plain version against the JAX ``fused_attn_in``
  (interpret), flash decode's and flash prefill's plain versions against
  their Pallas kernels (interpret), and the dispatch gates against the
  reference's at Gemma-2B's and Gemma-2-9B's shapes.
- Engines: tiny ``gemma`` and ``gemma2`` models (2 layers, dim 512, 2 query
  heads and 1 KV head of 256, ffn 256; gemma2 with a window of 6 on layer
  0) written by the JAX fixture writer and loaded by both packages: the
  loader's bytes, logits and greedy tokens against the JAX engine, decode
  against prefill, the window and the softcaps, the dispatch.

Inputs are made by numpy from a seed and handed to both packages. The
tolerance of each comparison is stated where it is made.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.models.config import ModelConfig as JModelConfig
from tpu_kquant.models.fixtures import tiny_config as j_tiny_config
from tpu_kquant.models.fixtures import write_fixture_gguf as j_write_fixture
from tpu_kquant.ops import activations as j_act
from tpu_kquant.ops import pallas_attention as j_pallas_attention
from tpu_kquant.ops import pallas_ffn as j_ffn
from tpu_kquant.ops import pallas_layer as j_layer
from tpu_kquant.ops import pallas_prefill as j_pallas_prefill
from tpu_kquant.ops.attention import attention_decode as j_attention_decode
from tpu_kquant.ops.attic import pallas_rot as j_rot
from tpu_kquant.ops.pallas_attn_in import attn_in_supported as j_attn_in_supported
from tpu_kquant.ops.pallas_attn_in import fused_attn_in as j_fused_attn_in
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.ops.pallas_attn_out import attn_out_supported as j_attn_out_supported
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import activations as t_act
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import attn_out as t_attn_out
from tpu_kquant_torch.ops import decode_attention as t_decode
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import layer as t_layer
from tpu_kquant_torch.ops import prefill as t_prefill
from tpu_kquant_torch.ops import rot as t_rot
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

TINY = dict(n_layers=2, dim=512, n_heads=2, n_kv_heads=1, ffn_dim=256, vocab_size=512,
            max_seq_len=128)
WINDOW = 6  # gemma2's tiny window: layer 0 attends its last 6 positions
PROMPTS = {n: [int(t) for t in np.random.default_rng(n).integers(3, 512, n)] for n in (8, 40)}
# interpret mode runs f32 dots where the TPU's MXU rounds to bf16: the
# fused kernels' tests hold the plain versions within 3e-2 of max|ref|
# (tests/test_pallas_ffn.py, tests/test_torch_kernels.py)
FUSED_TOL = 3e-2


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


def _close(got, ref, tol=FUSED_TOL) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=tol * np.abs(ref).max())


# -- configs and fixtures ---------------------------------------------------------


@pytest.mark.parametrize("preset", ["gemma_2b_config", "gemma2_9b_config"])
def test_gemma_presets_round_trip_both_packages(preset):
    """The preset's GGUF metadata reads back to the preset in the port and
    in the reference: head_dim 256 from attention.key_length (not dim /
    heads at 9B), the softcaps, the window, and the quirks from_gguf sets."""
    cfg = getattr(t_fixtures, preset)()
    md = cfg.to_gguf_metadata()
    fields = ("arch", "n_layers", "dim", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "max_seq_len", "act_fn", "post_norms", "embed_scale",
              "attn_logit_softcap", "final_logit_softcap", "sliding_window", "swa_pattern",
              "tie_embeddings")
    for back in (ModelConfig.from_gguf(md), JModelConfig.from_gguf(md)):
        for f in fields:
            assert getattr(back, f) == getattr(cfg, f), f
        assert back.rope.mode == "neox" and back.rope.n_rot == 256
        assert back.norm_eps == pytest.approx(1e-6)
    assert cfg.head_dim == 256 and cfg.act_fn == "gelu" and cfg.tie_embeddings
    if cfg.arch == "gemma2":
        assert cfg.dim // cfg.n_heads != cfg.head_dim
        assert [cfg.layer_window(i) for i in range(4)] == [4096, 0, 4096, 0]


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_tiny_config_mirrors_reference(arch):
    got = t_fixtures.tiny_config(arch=arch, sliding_window=WINDOW, **TINY)
    want = j_tiny_config(arch=arch, sliding_window=WINDOW, **TINY)
    for f in ("arch", "dim", "n_heads", "n_kv_heads", "head_dim", "act_fn", "post_norms",
              "embed_scale", "attn_logit_softcap", "final_logit_softcap", "sliding_window",
              "swa_pattern", "tie_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rope.mode == want.rope.mode == "neox"
    assert [got.layer_window(i) for i in range(3)] == [want.layer_window(i) for i in range(3)]


def test_port_fixture_writer_gemma2_inventory(tmp_path):
    """The port's writer: the post norms in F32, no output.weight (tied),
    and the reference's loader reads its file as gemma2."""
    from tpu_kquant_torch.gguf import GGMLType, GGUFReader

    cfg = t_fixtures.tiny_config(arch="gemma2", sliding_window=WINDOW, **TINY)
    path = t_fixtures.write_fixture_gguf(tmp_path / "g2.gguf", cfg, seed=2)
    r = GGUFReader(path)
    assert "output.weight" not in r.tensors
    for nm in ("post_attention_norm.weight", "post_ffw_norm.weight"):
        ti = r.tensors[f"blk.1.{nm}"]
        assert ti.ggml_type == GGMLType.F32 and tuple(ti.shape) == (512,)
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
    assert jc.post_norms and tc.post_norms and tc.attn_logit_softcap == 50.0
    np.testing.assert_array_equal(tp["layers"][1]["post_ffn_norm"].arrays["w"].numpy(),
                                  np.asarray(jp["layers"][1]["post_ffn_norm"].arrays["w"]))


# -- GELU in the fused FFN kernels -----------------------------------------------------


def test_geglu_matches_reference():
    """Exact (erf) GELU in f32 times up, in the gate's dtype: within one
    bf16 ulp (at most 2^-7 of the value) of the reference's, whose f32 erf
    rounds differently."""
    rng = np.random.default_rng(0)
    g, u = (rng.standard_normal((4, 256)).astype(np.float32) * 3 for _ in range(2))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = t_act.geglu(torch.from_numpy(g).to(dt), torch.from_numpy(u).to(dt))
        want = np.asarray(j_act.geglu(jnp.asarray(g, jdt), jnp.asarray(u, jdt)), np.float32)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-6)


def _ffn_inputs(seed, R, D=512, K=1024, F=512):
    rng = np.random.default_rng(seed)
    wo, gu, dn = mk_q6w(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((R, K)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    return wo, gu, dn, x, attn, nw


@pytest.mark.parametrize("R", [1, 4])
def test_ffn_plain_gelu_matches_pallas(R):
    """#6 (fused_ffn) with act_fn "gelu"; and the comparison tells GELU from
    SiLU (the SiLU plain version misses the GELU reference)."""
    _, gu, dn, x, _, nw = _ffn_inputs(40 + R, R)
    ref = j_ffn.fused_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-6, gu, dn,
                          act_fn="gelu", interpret=True)
    before = _plain_calls()
    got = t_ffn.fused_ffn(_bf(x), torch.from_numpy(nw), 1e-6, _port(gu), _port(dn),
                          act_fn="gelu")
    assert _delta(before) == {"ffn": 1}
    _close(got, ref)
    silu = t_ffn.ffn_plain(_bf(x), torch.from_numpy(nw), 1e-6, _port(gu), _port(dn))
    with pytest.raises(AssertionError):
        _close(silu - _bf(x), np.asarray(ref, np.float32) - x.astype(np.float32))


@pytest.mark.parametrize("tko_tf", [(128, 256), (256, 512)])
def test_oproj_ffn_plain_gelu_matches_manual_kernel(tko_tf):
    """#4, the manual variant, at tests/test_manual_kernels.py's shapes."""
    tko, tf = tko_tf
    rng = np.random.default_rng(2)
    D, K, F = 512, 512, 1024
    wo, gu, dn = mk_q4(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    x = (rng.standard_normal((1, D)) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((1, K)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    ref = j_ffn._oproj_ffn_manual_call(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), jnp.asarray(nw),
        wo.arrays["qs"], wo.arrays["sm"], gu.arrays["qs"], gu.arrays["sm"], dn.arrays["qs"],
        dn.arrays["sp"], D, K, F, 1e-5, "gelu", "bfloat16", True, tko, tf)
    got = t_ffn.fused_oproj_ffn(_bf(x), _bf(attn), _port(wo), torch.from_numpy(nw), 1e-5,
                                _port(gu), _port(dn), act_fn="gelu")
    _close(got, ref)


@pytest.mark.parametrize("R", [1, 3])
def test_oproj_ffn_plain_gelu_matches_grid_kernel(R):
    """#5, the Mosaic-grid variant (interpret mode takes it), wo q6w as the
    fixtures store it."""
    wo, gu, dn, x, attn, nw = _ffn_inputs(50 + R, R)
    ref = j_ffn.fused_oproj_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16),
                                wo, jnp.asarray(nw), 1e-5, gu, dn, act_fn="gelu",
                                interpret=True)
    before = _plain_calls()
    got = t_ffn.fused_oproj_ffn(_bf(x), _bf(attn), _port(wo), torch.from_numpy(nw), 1e-5,
                                _port(gu), _port(dn), act_fn="gelu")
    assert _delta(before) == {"oproj_ffn": 1}
    _close(got, ref)


def test_gate_up_plain_gelu_feeds_the_ffn_plain():
    """The gate/up phase alone (the entry point that times it) with GELU is
    the FFN's activation: ffn_plain = x + gate_up_plain @ down, bit for bit
    against the same f32 sums."""
    _, gu, dn, x, _, nw = _ffn_inputs(60, 2)
    xt, nwt, gut = _bf(x), torch.from_numpy(nw), _port(gu)
    before = _plain_calls()
    act = t_ffn.gate_up(xt, nwt, 1e-6, gut, act_fn="gelu")
    assert _delta(before) == {"gate_up": 1}
    assert torch.equal(act, t_ffn.gate_up_plain(xt, nwt, 1e-6, gut, "gelu"))
    assert not torch.equal(act, t_ffn.gate_up_plain(xt, nwt, 1e-6, gut, "silu"))
    with pytest.raises(ValueError, match="act_fn"):
        t_ffn.gate_up(xt, nwt, 1e-6, gut, act_fn="relu")


def _q4_spec(rng, N, K, sm=True):
    qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    s = rng.random((K // 32, N), dtype=np.float32) * 0.02 + 0.001
    m = rng.random((K // 32, N), dtype=np.float32) * 0.02
    if not sm:
        return {"qs": qs, "scales": s, "mins": m}, "q4", (N, K)
    bits = [torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
            .astype(np.uint32) for a in (s, m)]
    return {"qs": qs, "sm": (bits[0] | (bits[1] << 16)).view(np.float32)}, "q4", (N, K)


def _q6w_spec(rng, N, K):
    return ({"qs": rng.integers(-32, 32, (K, N)).astype(np.int8),
             "scales": rng.random((K // 16, N), dtype=np.float32) * 0.02 + 0.001}, "q6w", (N, K))


def _both(spec):
    arrays, kind, shape = spec
    return (JQTensor(kind, "kmajor", shape, {k: jnp.asarray(v) for k, v in arrays.items()}),
            QTensor(kind, "kmajor", shape, dict(arrays)).to("cpu"))


def _rope(pos, hd):
    ang = pos[..., None] / (10000.0 ** (np.arange(hd // 2) * 2 / hd))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("positions", [[1], [40], [95]], ids=["pos1", "pos40", "pos95"])
def test_layer_plain_gelu_matches_pallas(positions):
    """#11 with act_fn "gelu" on tests/test_torch_fused_decode.py's layer
    inputs (dim 512, 16 / 4 heads of 64, F 512, 96 slots; the same seeds:
    the layer gate's head dims are 64 and 128 in both packages) and with
    that test's tolerances."""
    D, H, Hkv, hd, F, S = 512, 16, 4, 64, 512, 96
    rng = np.random.default_rng(7)
    ws = [_both(s) for s in (_q4_spec(rng, (H + Hkv) * hd, D), _q6w_spec(rng, Hkv * hd, D),
                             _q4_spec(rng, D, H * hd, sm=False), _q4_spec(rng, 2 * F, D),
                             _q6w_spec(rng, D, F))]
    B = len(positions)
    rng = np.random.default_rng(100 + B)
    x = rng.standard_normal((B, 1, D)).astype(np.float32) * 0.5
    anw, fnw = (rng.random(D).astype(np.float32) + 0.5 for _ in range(2))
    kc, vc = (rng.standard_normal((B, Hkv, S, hd)).astype(np.float32) * 0.3 for _ in range(2))
    pos = np.asarray(positions, np.int32).reshape(B, 1)
    cos, sin = _rope(pos, hd)
    jws, tws = [w[0] for w in ws], [w[1] for w in ws]
    y_r, k_r, v_r = (np.asarray(a, np.float32) for a in j_layer.fused_layer(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(anw), jnp.asarray(fnw), 1e-5,
        *jws, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), H, Hkv, act_fn="gelu", interpret=True))
    before = _plain_calls()
    y, k, v = t_layer.fused_layer(_bf(x), torch.from_numpy(pos).long(), torch.from_numpy(anw),
                                  torch.from_numpy(fnw), 1e-5, *tws, torch.from_numpy(cos),
                                  torch.from_numpy(sin), _bf(kc), _bf(vc), H, Hkv, act_fn="gelu")
    assert _delta(before) == {"layer": 1}
    np.testing.assert_allclose(_np(k), k_r, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(_np(v), v_r, rtol=0.05, atol=0.02)
    a, b = _np(y).ravel(), y_r.ravel()
    assert float(np.corrcoef(a, b)[0, 1]) > 0.999
    np.testing.assert_allclose(a, b, rtol=0.12, atol=0.01 * float(np.sqrt((b ** 2).mean())))


@pytest.mark.parametrize("hd", [64, 256])
def test_rot_plain_gelu_matches_pallas(hd):
    """#12 with act_fn "gelu": o_proj + FFN, then the next layer's QKV with
    its rope (at head_dim 256 the QKV phase's 256-wide heads, as at
    Gemma-2B); tests/test_torch_fused_decode.py's tolerance for rot, 2e-2 of
    max(1, max|ref|)."""
    rng = np.random.default_rng(hd)
    D, K, F, R = 512, 1024, 512, 2
    n0, n1 = 3 * 256 if hd == 256 else 12 * hd, 256
    wo, gu, dn = mk_q4(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    wqk2, wv2 = mk_q4(n0, D, rng), mk_q6w(n1, D, rng)
    x = (rng.standard_normal((R, 1, D)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((R, 1, K)) * 0.5).astype(np.float32)
    nw, nw2 = ((rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32) for _ in range(2))
    cos, sin = _rope(rng.integers(0, 100, (R, 1)), hd)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), n0 // hd, hd)
    ref = j_rot.fused_oproj_ffn_attn_in(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw), 1e-5,
        gu, dn, jnp.asarray(nw2), [wqk2, wv2], cf, sf, hd // 2, act_fn="gelu", interpret=True)
    pw = [_port(w) for w in (wo, gu, dn, wqk2, wv2)]
    assert t_rot.rot_supported(*pw[:3], pw[3:], R, D, hd)
    before = _plain_calls()
    got = t_rot.fused_oproj_ffn_attn_in(_bf(x), _bf(attn), pw[0], torch.from_numpy(nw), 1e-5,
                                        pw[1], pw[2], torch.from_numpy(nw2), pw[3], pw[4],
                                        torch.from_numpy(cos), torch.from_numpy(sin), hd,
                                        act_fn="gelu")
    assert _delta(before) == {"rot": 1}
    for g, r, name in zip(got, ref, ("y", "qk", "v")):
        r = np.asarray(r, np.float32)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(_np(g), r, atol=2e-2 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


# -- head_dim 256 ----------------------------------------------------------------------


@pytest.mark.parametrize("R", [1, 3])
def test_attn_in_plain_hd256_matches_pallas(R):
    """attn_in at dim 512 with 2 + 1 heads of 256 against the JAX
    fused_attn_in (interpret), whose rope is a lane roll by 128; 3e-2 of
    max|ref|, the tolerance of the head_dim 64 / 128 cases."""
    rng = np.random.default_rng(70 + R)
    D, hd, H, Hkv = 512, 256, 2, 1
    wqk, wv = mk_q4((H + Hkv) * hd, D, rng), mk_q6w(Hkv * hd, D, rng)
    x = (rng.standard_normal((R, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = _rope(rng.integers(0, 4000, (R,)), hd)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd)
    o0, o1 = j_fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-6, [wqk, wv],
                             cf, sf, hd // 2, interpret=True)
    pq, pv = _port(wqk), _port(wv)
    assert t_attn_in.attn_in_supported(pq, pv, R, D, hd)
    before = _plain_calls()
    g0, g1 = t_attn_in.fused_attn_in(_bf(x), torch.from_numpy(nw), 1e-6, pq, pv,
                                     torch.from_numpy(cos), torch.from_numpy(sin), hd)
    assert _delta(before) == {"attn_in": 1}
    _close(g0, o0)
    _close(g1, o1)


def test_attn_in_head_dim_rule():
    """The reference's attn_in gate has no head_dim rule; the port's takes
    every head_dim its 128-column blocks hold (dividing 128, or a multiple
    of 32: phi3's 96, the gemma family's 256) with whole heads in each
    slot. Head dims no ported family uses, such as phi2's 80, stay on
    qmatmul."""
    assert all(t_attn_in.kernel_head_dim(h) for h in (32, 64, 96, 128, 192, 256, 512))
    assert not any(t_attn_in.kernel_head_dim(h) for h in (0, 48, 80, 112))
    rng = np.random.default_rng(3)
    wqk, wv = mk_q4(768, 512, rng), mk_q6w(256, 512, rng)
    assert j_attn_in_supported([wqk, wv], 1, 512)
    assert t_attn_in.attn_in_supported(_port(wqk), _port(wv), 1, 512, 256)
    assert not t_attn_in.attn_in_supported(_port(wqk), _port(wv), 1, 512, 80)


# (B, S, H, Hkv, positions, int8 KV, the Pallas tile)
DECODE_CASES = {
    "bf16": (2, 256, 8, 1, [37, 255], False, 128),
    "int8": (2, 512, 8, 1, [100, 511], True, 256),
    "GQA 2": (1, 128, 16, 8, [64], False, 64),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_hd256_matches_pallas(case):
    """#7's plain version at head_dim 256 against attention_decode_pallas
    (interpret); tests/test_torch_decode_attention.py's tolerances (2e-2,
    int8 3e-2)."""
    B, S, H, Hkv, pos, int8, ts = DECODE_CASES[case]
    D = 256
    r = np.random.default_rng(sum(pos))
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    if int8:
        k, v = (r.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8) for _ in range(2))
        sc = tuple((r.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32) for _ in range(2))
    else:
        k, v = (r.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
        sc = None
    qp = np.asarray(pos, np.int32).reshape(B, 1)
    want = np.asarray(j_pallas_attention.attention_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        None if sc is None else tuple(map(jnp.asarray, sc)), ts=ts, interpret=True))
    t = torch.from_numpy
    before = _plain_calls()
    got = t_decode.attention_decode_flash(t(q), t(k), t(v), t(qp),
                                          None if sc is None else tuple(map(t, sc)))
    assert _delta(before) == {"decode_attn": 1}
    tol = 3e-2 if int8 else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert 256 in t_decode.KERNEL_HEAD_DIMS and 256 not in t_decode.FUSED_HEAD_DIMS


# (B, T, S, H, Hkv, starts, int8, window, tq)
PREFILL_CASES = {
    "fresh": (1, 64, 128, 8, 1, [0], False, 0, 32),
    "offset_window": (2, 32, 256, 8, 1, [100, 180], False, 48, 16),
    "offset_window_int8": (1, 40, 256, 4, 2, [130], True, 64, 8),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_plain_hd256_matches_pallas(case):
    """#8's plain version at head_dim 256, with a q offset and a window,
    against attention_prefill_pallas (interpret); tests/test_torch_prefill.
    py's tolerance (2e-2)."""
    B, T, S, H, Hkv, starts, quant, window, tq = PREFILL_CASES[case]
    D = 256
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    if quant:
        k, v = (rng.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8) for _ in range(2))
        sc = tuple((rng.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
        sc = None
    qs = np.asarray(starts, np.int32)
    want = np.asarray(j_pallas_prefill.attention_prefill_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs),
        None if sc is None else tuple(map(jnp.asarray, sc)), sliding_window=window, tq=tq,
        ts=64, interpret=True))
    t = torch.from_numpy
    before = _plain_calls()
    got = t_prefill.attention_prefill(t(q), t(k), t(v), t(qs),
                                      None if sc is None else tuple(map(t, sc)),
                                      sliding_window=window)
    assert _delta(before) == {"prefill": 1}
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    assert 256 in t_prefill.KERNEL_HEAD_DIMS and t_prefill.kv_tile(256, False) == 64


def _shape_only(kind: str, N: int, K: int, side: str = "pairs"):
    """(reference, port) weights of a shape and scale layout with one-byte
    arrays: the gates read the kind, layout, shape and the arrays' names."""
    names = {("q4", "pairs"): ("qs", "sm"), ("q6w", "pairs"): ("qs", "sp"),
             ("q4", "f32"): ("qs", "scales", "mins"), ("q6w", "f32"): ("qs", "scales")}
    arrays = {n: np.zeros((1, 1), np.uint8) for n in names[(kind, side)]}
    return (JQTensor(kind, "kmajor", (N, K), dict(arrays)),
            QTensor(kind, "kmajor", (N, K), dict(arrays)))


@pytest.mark.parametrize("preset", ["gemma_2b_config", "gemma2_9b_config"])
@pytest.mark.parametrize("side", ["pairs", "f32"])
@pytest.mark.parametrize("rows", [1, 4, 32, 33])
def test_gates_match_reference_at_gemma_shapes(preset, side, rows):
    """The port's gates against the reference's at the preset's Q4_K_M
    weights (wqk and gate/up q4, wv, wo and down q6w): attn_in, oproj_ffn,
    ffn, attn_out and layer (both refuse: Hkv is odd at 2B; at 9B the
    reference's VMEM cap on attn_out's Wo chunk and layer's head_dim 64 /
    128), rot, and the prefill kernel's shape rule."""
    cfg = getattr(t_fixtures, preset)()
    D, H, Hkv, hd, F = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim
    wqk = _shape_only("q4", (H + Hkv) * hd, D, side)
    wv = _shape_only("q6w", Hkv * hd, D, side)
    wo = _shape_only("q6w", D, H * hd, side)
    gu = _shape_only("q4", 2 * F, D, side)
    dn = _shape_only("q6w", D, F, side)
    jw = [w[0] for w in (wqk, wv, wo, gu, dn)]
    tw = [w[1] for w in (wqk, wv, wo, gu, dn)]
    assert t_attn_in.attn_in_supported(tw[0], tw[1], rows, D, hd) == \
        j_attn_in_supported(jw[:2], rows, D)
    assert t_ffn.oproj_ffn_supported(*tw[2:], rows) == j_ffn.oproj_ffn_supported(*jw[2:], rows)
    assert t_ffn.ffn_supported(*tw[3:], rows) == j_ffn.ffn_supported(*jw[3:], rows)
    assert t_rot.rot_supported(*tw[2:], tw[:2], rows, D, hd) == \
        j_rot.rot_supported(*jw[2:], jw[:2], rows, D)
    for S in (2048, 8192):
        # both refuse Gemma-2B's single KV head; at 9B the reference admits
        # head_dim 256 where the port's few-row kernel has no instance (a
        # gap the forward never reaches: gemma2's softcap keeps attn_out
        # off in both packages; ROADMAP, #10 at head_dim 256)
        assert not t_attn_out.attn_out_supported(tw[2], H, Hkv, hd, rows, S)
        assert j_attn_out_supported(jw[2], H, Hkv, hd, rows, S) == \
            (preset == "gemma2_9b_config" and rows <= 16)
    assert t_layer.layer_supported(*tw, rows, D, H, Hkv, hd) == \
        j_layer.layer_supported(*jw, rows, D, H, Hkv, hd) is False
    for T, S in ((4096, 4096), (3000, 4096), (64, 4352)):
        assert t_prefill.prefill_supported(T, S, hd) == j_pallas_prefill.prefill_supported(T, S, hd)
    if preset == "gemma_2b_config" and rows <= 32:  # decode: attn_in and oproj_ffn
        assert t_attn_in.attn_in_supported(tw[0], tw[1], rows, D, hd)
        assert t_ffn.oproj_ffn_supported(*tw[2:], rows)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("T", [1, 64])
def test_attention_dispatch_matches_reference(monkeypatch, softcap, window, T):
    """Past the logits budget at head_dim 256, the reference's dispatch: #7
    only with no softcap and no window, #8 only with no softcap (it takes
    the window); else the plain branch. The reference is asked with its
    kernels stubbed (impl "pallas" on the CPU) and the same inputs; the
    port's plain branch matches its output within 2e-2 where both run it."""
    B, S, H, Hkv, D = 1, 128, 2, 1, 256
    rng = np.random.default_rng(T + window)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    qp = (np.arange(T, dtype=np.int32) + 60)[None]
    called = []
    monkeypatch.setattr(j_pallas_attention, "attention_decode_pallas",
                        lambda *a, **kw: called.append("decode_attn") or jnp.zeros(q.shape))
    monkeypatch.setattr(j_pallas_prefill, "attention_prefill_pallas",
                        lambda *a, **kw: called.append("prefill") or jnp.zeros(q.shape))
    want = np.asarray(j_attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(qp), logit_softcap=softcap,
                                         sliding_window=window, impl="pallas"))
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
    before = _plain_calls()
    got = t_attention.attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(qp).long(),
                                       logit_softcap=softcap, sliding_window=window)
    assert list(_delta(before)) == called
    if not called:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_plain_attention_softcap_and_window_match_reference():
    """The plain branch's softcap (tanh after the current token's logit is
    put in, before the mask) and window, with and without the deferred
    append's current token, against the reference's XLA branch; 1e-5 (f32
    both sides)."""
    B, S, H, Hkv, D = 2, 64, 4, 2, 256
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((B, 1, H, D)) * 2).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    qp = np.asarray([[20], [63]], np.int32)
    for cur in (False, True):
        want = np.asarray(j_attention_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
            logit_softcap=5.0, sliding_window=9, impl="xla",
            kv_cur=(jnp.asarray(kc), jnp.asarray(vc)) if cur else None))
        t = torch.from_numpy
        got = t_attention.attention_plain(t(q), t(k), t(v), t(qp).long(),
                                          kv_cur=(t(kc), t(vc)) if cur else None,
                                          logit_softcap=5.0, sliding_window=9)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        nocap = t_attention.attention_plain(t(q), t(k), t(v), t(qp).long(),
                                            kv_cur=(t(kc), t(vc)) if cur else None,
                                            sliding_window=9)
        assert not np.allclose(nocap.numpy(), want, rtol=1e-3, atol=1e-3)


# -- the engines -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    """{arch: (jax cfg, jax params, jax engine, port cfg, port params, port
    engine)} for the tiny gemma and gemma2 (Q4_K_M, the JAX writer)."""
    out = {}
    for arch in ("gemma", "gemma2"):
        cfg = j_tiny_config(arch=arch, sliding_window=WINDOW if arch == "gemma2" else 0, **TINY)
        path = tmp_path_factory.mktemp(arch) / f"{arch}.gguf"
        j_write_fixture(path, cfg, seed=9, quant="q4_k_m", scale=0.05)
        jc, jp, _ = jload(str(path), scale_dtype="bf16")
        tc, tp, _ = load_model(str(path), scale_dtype="bf16", device="cpu")
        out[arch] = (jc, jp, JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla"),
                     tc, tp, InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu"))
    return out


def _same_bytes(j, t) -> None:
    assert (t.kind, t.layout, tuple(t.shape)) == (j.kind, j.layout, tuple(j.shape))
    for k in j.arrays:
        np.testing.assert_array_equal(t.arrays[k].numpy().view(np.uint8),
                                      np.asarray(j.arrays[k]).view(np.uint8))


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_loader_matches_jax(gemma, arch):
    """The tied lm head (token_embd repacked kmajor, q4) and, for gemma2,
    the post norms, byte for byte; the quirks of both configs."""
    jc, jp, _, tc, tp, _ = gemma[arch]
    for f in ("act_fn", "post_norms", "embed_scale", "attn_logit_softcap",
              "final_logit_softcap", "sliding_window", "swa_pattern", "head_dim"):
        assert getattr(tc, f) == getattr(jc, f), f
    _same_bytes(jp["output"], tp["output"])
    assert tp["output"].kind == "q4" and tuple(tp["output"].shape) == (512, 512)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert ("post_attn_norm" in tl) == (arch == "gemma2")
        for n in ("post_attn_norm", "post_ffn_norm") if arch == "gemma2" else ():
            _same_bytes(jl[n], tl[n])


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
@pytest.mark.parametrize("n", [8, 40])
def test_prefill_logits_match_jax(gemma, arch, n):
    """Prefill of 8 tokens (bucket 16: the fused plain versions; gemma2's
    post norms keep the FFN kernels off) and 40 (bucket 64: qmatmuls);
    logits within 5e-2 of max|ref| (the port's llama tests' tolerance) and
    the same argmax. The JAX engine on the CPU runs impl="xla"."""
    _, _, je, _, _, te = gemma[arch]
    lj, _, _ = je.prefill([PROMPTS[n]], je.new_cache(1))
    before = _plain_calls()
    lt, _, _ = te.prefill([PROMPTS[n]], te.new_cache(1))
    used = _delta(before)
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    fused = n == 8
    assert used.get("attn_in", 0) == (2 if fused else 0)
    assert used.get("ffn", 0) == (2 if fused and arch == "gemma" else 0)
    if arch == "gemma2":
        assert np.abs(got).max() < 30.0  # the final softcap


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
@pytest.mark.parametrize("n", [8, 40])
def test_greedy_tokens_match_jax(gemma, arch, n):
    """Greedy generation of 8 tokens against the JAX engine's. Both engines
    are fed the JAX tokens step by step: at every step the port's logits
    lie within 5e-2 of max|ref|, and its argmax is the JAX one wherever the
    JAX top-2 gap exceeds twice the step's largest logit difference (a
    nearer tie may flip on a bf16 rounding: the port's decode runs the
    fused plain versions on bf16 q / k / v, the JAX engine on the CPU its
    unfused path). The port's own generate() equals the JAX tokens up to
    the first such tie."""
    _, _, je, _, _, te = gemma[arch]
    prompt = PROMPTS[n]
    want_toks = je.generate([prompt], max_new_tokens=8)[0]
    lj, jc, _ = je.prefill([prompt], je.new_cache(1))
    lt, tc, _ = te.prefill([prompt], te.new_cache(1))
    steps = [(np.asarray(lj[0], np.float32), lt[0].numpy())]
    for i, tok in enumerate(want_toks[:-1]):
        lj, jc = je.decode_step(jnp.asarray([tok]), jnp.asarray([n + i]), jc)
        lt, tc = te.decode_step(torch.tensor([tok]), torch.tensor([n + i]), tc)
        steps.append((np.asarray(lj[0], np.float32), lt[0].numpy()))
    first_tie = len(steps)
    for i, (want, got) in enumerate(steps):
        diff = float(np.abs(got - want).max())
        assert diff <= 5e-2 * np.abs(want).max(), i
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * diff:
            assert np.argmax(got) == np.argmax(want) == want_toks[i], i
        else:
            first_tie = min(first_tie, i)
    assert first_tie > 0
    got_toks = te.generate([prompt], max_new_tokens=8)[0]
    assert got_toks[:first_tie] == want_toks[:first_tie]


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_decode_matches_prefill(gemma, arch):
    """Prefill of 12 tokens against a prefill of 9 and 3 decode steps (the
    fused decode paths with bf16 q / k / v, gemma2's windowed layer 0 past
    its window); within 5e-2 of max|ref| (the port's llama tests'
    tolerance between the fused and unfused paths) and the same argmax."""
    _, _, _, _, _, te = gemma[arch]
    toks = PROMPTS[40][:12]
    full, _, _ = te.prefill([toks], te.new_cache(1))
    cache = te.new_cache(1)
    lg, cache, _ = te.prefill([toks[:-3]], cache)
    pos = torch.tensor([len(toks) - 3])
    for tok in toks[-3:]:
        lg, cache = te.decode_step(torch.tensor([tok]), pos, cache)
        pos = pos + 1
    want = full.numpy()
    np.testing.assert_allclose(lg.numpy(), want, rtol=0, atol=5e-2 * np.abs(want).max())
    assert np.argmax(lg.numpy()) == np.argmax(want)


def test_window_actually_masks(gemma):
    """gemma2 with 40 tokens > window 6: the port without its window
    disagrees with the windowed JAX engine, and with it agrees (as
    tests/test_gemma2.py guards the reference)."""
    _, _, je, tc, tp, te = gemma["gemma2"]
    want = np.asarray(je.prefill([PROMPTS[40]], je.new_cache(1))[0][0], np.float32)
    nosw = InferenceEngine(dataclasses.replace(tc, sliding_window=0), tp, max_batch=1,
                           max_seq=64, device="cpu")
    got = nosw.prefill([PROMPTS[40]], nosw.new_cache(1))[0][0].numpy()
    assert not np.allclose(got, want, atol=5e-2 * np.abs(want).max())
    got = te.prefill([PROMPTS[40]], te.new_cache(1))[0][0].numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_decode_dispatch(gemma, arch):
    """Per decode step: gemma runs attn_in (head_dim 256) and the ffn kernel
    (GELU; attention width 512 fails oproj_ffn's K % 1024) in each layer,
    qmm for o_proj and the lm head; gemma2's post norms keep every FFN
    kernel off: attn_in, then qmm for o_proj, gate/up and down."""
    _, _, _, _, _, te = gemma[arch]
    logits, cache, lens = te.prefill([PROMPTS[8]], te.new_cache(1))
    before = _plain_calls()
    pos = torch.tensor(lens)
    for t in (7, 99):
        logits, cache = te.decode_step(torch.tensor([t]), pos, cache)
        pos = pos + 1
    used = _delta(before)
    if arch == "gemma":
        assert used == {"attn_in": 4, "ffn": 4, "qmm": 2 * (2 + 1)}
    else:
        assert used == {"attn_in": 4, "qmm": 2 * (2 * 3 + 1)}


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_attention_kernels_past_the_budget(gemma, arch, monkeypatch):
    """With the logits budget at 0, gemma's 40-token prompt takes the flash
    prefill's plain version at head_dim 256 in each layer and its decode
    steps the flash decode's; gemma2's softcap keeps both off (the plain
    branch), as in the reference. Logits within 2e-2 of max|ref| of the
    budget-192 run (tests/test_torch_prefill.py's tolerance)."""
    _, _, _, _, _, te = gemma[arch]
    ref, _, lens = te.prefill([PROMPTS[40]], te.new_cache(1))
    ref_step, _ = te.decode_step(torch.tensor([5]), torch.tensor(lens),
                                 te.prefill([PROMPTS[40]], te.new_cache(1))[1])
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
    before = _plain_calls()
    got, cache, _ = te.prefill([PROMPTS[40]], te.new_cache(1))
    step, _ = te.decode_step(torch.tensor([5]), torch.tensor(lens), cache)
    used = _delta(before)
    flash = arch == "gemma"
    assert used.get("prefill", 0) == used.get("decode_attn", 0) == (2 if flash else 0)
    for g, r in ((got, ref), (step, ref_step)):
        torch.testing.assert_close(g, r, rtol=2e-2, atol=2e-2 * r.abs().max().item())
