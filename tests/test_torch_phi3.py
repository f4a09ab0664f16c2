"""phi3 in the port on the CPU against the JAX package: the pre-fused QKV
and gate/up tensors, head_dim 96, and the sliding window.

- Fixtures: the port's ``tiny_config(arch="phi3")`` and Phi-3-mini-4k preset
  against the reference's metadata, the port writer's tensor inventory
  against the reference writer's, and a reference-written fixture loaded by
  both packages to the same packed bytes (``wqkv`` one tensor,
  ``w_gateup`` the pre-fused ``ffn_up``).
- The forward: tests/test_session_and_archs.py:78-165 ported (fused-QKV
  parity with the NumPy reference forward, the fused load against the
  reference's split load, the window's mask, a window from the metadata),
  each also against the JAX engine.
- attn_in's one-slot branch: ``qkv_slots`` (wqkv's columns as two slots of
  its own bytes) through attn_in's plain version against the reference's
  ``fused_attn_in(ws=[wqkv], interpret=True)`` at head_dim 96 and 64, the
  kernel's column map (csrc/attn_in.cuh:ai_col) rebuilt in Python, its
  arithmetic mirrored in numpy on the slots, and rot (#12) with the next
  layer's wqkv at head_dim 96 against the reference's Pallas kernel.
- Dispatch at head_dim 96: a dim-512 phi3 whose decode steps run attn_in
  on the slots in every layer, against the JAX engine.

Inputs are made by numpy from a seed and handed to both packages. The
tolerance of each comparison is stated where it is made.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.gguf import GGUFReader as JReader
from tpu_kquant.models.config import ModelConfig as JModelConfig
from tpu_kquant.models.fixtures import tiny_config as j_tiny_config
from tpu_kquant.models.fixtures import write_fixture_gguf as j_write_fixture
from tpu_kquant.ops.attention import attention_decode as j_attention_decode
from tpu_kquant.ops.attic import pallas_rot as j_rot
from tpu_kquant.ops.pallas_attn_in import attn_in_supported as j_attn_in_supported
from tpu_kquant.ops.pallas_attn_in import fused_attn_in as j_fused_attn_in
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.gguf import GGUFReader
from tpu_kquant_torch.models import fixtures as t_fixtures
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops import rot as t_rot
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

TINY = dict(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=512)
# interpret mode runs f32 dots where the TPU's MXU rounds to bf16: the fused
# kernels' tests hold the plain versions within 3e-2 of max|ref|
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


def _rope(pos, hd):
    ang = pos[..., None] / (10000.0 ** (np.arange(hd // 2) * 2 / hd))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.fixture(scope="module")
def phi3_path(tmp_path_factory):
    """The reference test's tiny phi3 (seed 5), written by the JAX writer."""
    path = tmp_path_factory.mktemp("phi3") / "p.gguf"
    j_write_fixture(path, j_tiny_config(arch="phi3", **TINY), seed=5, scale=0.08)
    return str(path)


# -- configs and fixtures ---------------------------------------------------------


def test_tiny_config_and_preset_match_the_reference():
    """tiny_config(arch="phi3") is the reference's (neox rope, no biases, no
    window), and the Phi-3-mini-4k preset's metadata reads back to itself in
    both packages: head_dim 96, window 2047 on every layer, untied."""
    j, t = j_tiny_config(arch="phi3", **TINY), t_fixtures.tiny_config(arch="phi3", **TINY)
    for f in ("arch", "n_layers", "dim", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
              "vocab_size", "max_seq_len", "attn_bias", "sliding_window", "act_fn"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rope.mode == j.rope.mode == "neox"
    cfg = t_fixtures.phi3_mini_4k_config()
    md = cfg.to_gguf_metadata()
    for back in (ModelConfig.from_gguf(md), JModelConfig.from_gguf(md)):
        for f in ("arch", "n_layers", "dim", "n_heads", "n_kv_heads", "head_dim", "ffn_dim",
                  "vocab_size", "max_seq_len", "sliding_window", "swa_pattern",
                  "tie_embeddings", "attn_bias"):
            assert getattr(back, f) == getattr(cfg, f), f
        assert back.rope.mode == "neox" and back.rope.n_rot == 96
        assert back.norm_eps == pytest.approx(1e-5)
    assert [cfg.layer_window(i) for i in range(cfg.n_layers)] == [2047] * 32
    assert (cfg.head_dim, cfg.dim, cfg.ffn_dim, cfg.vocab_size) == (96, 3072, 8192, 32064)


def test_port_writer_writes_the_reference_inventory(tmp_path):
    """The port's writer gives a phi3 file the reference writer's tensors:
    the same names, shapes and GGML types in the same order (attn_qkv and
    the [2F, D] ffn_up, no attn_q/k/v and no ffn_gate); the blocks are the
    port's own draws."""
    cfg = t_fixtures.tiny_config(arch="phi3", n_layers=2, dim=256, n_heads=4, n_kv_heads=2,
                                 ffn_dim=512, vocab_size=512)
    t_fixtures.write_fixture_gguf(tmp_path / "t.gguf", cfg, seed=1)
    j_write_fixture(tmp_path / "j.gguf", j_tiny_config(arch="phi3", n_layers=2, dim=256,
                                                       n_heads=4, n_kv_heads=2, ffn_dim=512,
                                                       vocab_size=512), seed=1)
    t_inv = [(n, tuple(ti.shape), int(ti.ggml_type))
             for n, ti in GGUFReader(str(tmp_path / "t.gguf")).tensors.items()]
    j_inv = [(n, tuple(ti.shape), int(ti.ggml_type))
             for n, ti in JReader(str(tmp_path / "j.gguf")).tensors.items()]
    assert t_inv == j_inv
    names = [n for n, _, _ in t_inv]
    assert "blk.0.attn_qkv.weight" in names and "blk.0.ffn_gate.weight" not in names
    assert dict((n, s) for n, s, _ in t_inv)["blk.0.ffn_up.weight"] == (1024, 256)


def test_fixture_loads_to_the_same_bytes(phi3_path):
    """Both loaders read the reference-written phi3 fixture to the same
    packed bytes: wqkv one tensor [(H + 2 Hkv) hd, D], w_gateup the
    pre-fused ffn_up, every other weight and norm."""
    jc, jp, _ = jload(phi3_path, scale_dtype="bf16")
    tc, tp, _ = load_model(phi3_path, device="cpu")
    assert tc.arch == jc.arch == "phi3" and tc.rope.mode == "neox"
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert set(tl) == set(jl) == {"attn_norm", "wqkv", "wo", "ffn_norm", "w_gateup",
                                      "w_down"}
        for name in tl:
            assert tl[name].kind == jl[name].kind and tuple(tl[name].shape) == \
                tuple(jl[name].shape), name
            for k, v in jl[name].arrays.items():
                assert np.array_equal(tl[name].arrays[k].numpy(), np.asarray(v)), (name, k)
    assert tuple(tp["layers"][0]["wqkv"].shape) == ((4 + 2 * 2) * 16, 64)


# -- the forward -------------------------------------------------------------------


def test_phi3_fused_qkv_parity(phi3_path):
    """tests/test_session_and_archs.py:test_phi3_fused_qkv_parity on the
    port: the last logits against the NumPy reference forward (correlation
    > 0.99, the same argmax), and against the JAX engine on the same file
    within 2e-2 of max|ref| with its greedy tokens equal."""
    from tests.reference_forward import ref_forward

    tc, tp, reader = load_model(phi3_path, device="cpu")
    tokens = [3, 100, 7, 256, 42]
    eng = InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu")
    logits, _, _ = eng.prefill([tokens], eng.new_cache(1))
    ref = ref_forward(JReader(phi3_path), tc, np.array(tokens))
    got, want = logits[0].double().numpy(), ref[-1]
    corr = float((got * want).mean() / np.sqrt((got ** 2).mean() * (want ** 2).mean()))
    assert corr > 0.99, corr
    assert np.argmax(got) == np.argmax(want)
    jc, jp, _ = jload(phi3_path, scale_dtype="bf16")
    je = JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla")
    jl, _, _ = je.prefill([tokens], je.new_cache(1))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(logits.numpy(), jl, rtol=0, atol=2e-2 * np.abs(jl).max())
    assert eng.generate([tokens], max_new_tokens=8) == je.generate([tokens], max_new_tokens=8)


def test_phi3_split_load_matches_fused(tmp_path):
    """tests/test_session_and_archs.py:test_phi3_split_load_matches_fused:
    the reference's split load (fuse=False: wq / wk / wv and w_gate / w_up
    cut from the fused tensors' rows) against the port's fused load (one
    wqkv, one w_gateup), on its seed-6 fixture: the reference's tolerance
    (2e-2) and the same argmax."""
    path = tmp_path / "p.gguf"
    j_write_fixture(path, j_tiny_config(arch="phi3", **TINY), seed=6, scale=0.08)
    cfg_s, params_s, _ = jload(str(path), fuse=False, scale_dtype="bf16")
    assert "wq" in params_s["layers"][0] and "w_gate" in params_s["layers"][0]
    tc, tp, _ = load_model(str(path), device="cpu")
    tokens = [3, 100, 7, 9]
    es = JEngine(cfg_s, params_s, max_batch=1, max_seq=64, impl="xla")
    ef = InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu")
    ls, _, _ = es.prefill([tokens], es.new_cache(1))
    lf, _, _ = ef.prefill([tokens], ef.new_cache(1))
    np.testing.assert_allclose(lf.numpy(), np.asarray(ls), rtol=2e-2, atol=2e-2)
    assert np.argmax(lf[0].numpy()) == np.argmax(np.asarray(ls[0]))


def test_sliding_window_attention():
    """tests/test_session_and_archs.py:test_sliding_window_attention on the
    port's attention_decode (its plain branch, einsum and card forms): the
    window changes the output, corrupting K/V outside it does not (1e-6),
    and each form equals the reference's within 1e-5."""
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 1, 64, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    pos = np.asarray([[40]])
    t = torch.from_numpy
    full = t_attention.attention_decode(t(q), t(k), t(v), t(pos))
    win = t_attention.attention_decode(t(q), t(k), t(v), t(pos), sliding_window=8)
    assert not np.allclose(full.numpy(), win.numpy(), atol=1e-4)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, :30], v2[:, :, :30] = 99.0, 99.0
    win2 = t_attention.attention_decode(t(q), t(k2), t(v2), t(pos), sliding_window=8)
    np.testing.assert_allclose(win.numpy(), win2.numpy(), atol=1e-6)
    ref = np.asarray(j_attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pos, jnp.int32), sliding_window=8,
                                        impl="xla"))
    for fixed in (False, True):
        got = t_attention.attention_plain(t(q), t(k), t(v), t(pos), fixed=fixed,
                                          sliding_window=8)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_sliding_window_from_metadata(tmp_path):
    """tests/test_session_and_archs.py:test_sliding_window_from_metadata:
    the window reads back from the file and the port generates 4 tokens,
    the JAX engine's greedy tokens."""
    path = tmp_path / "swa.gguf"
    j_write_fixture(path, j_tiny_config(**TINY, sliding_window=16), seed=8, scale=0.08)
    tc, tp, _ = load_model(str(path), device="cpu")
    assert tc.sliding_window == 16
    eng = InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu")
    out = eng.generate([[3, 100, 7]], max_new_tokens=4)
    assert len(out[0]) == 4
    jc, jp, _ = jload(str(path), scale_dtype="bf16")
    assert out == JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla").generate(
        [[3, 100, 7]], max_new_tokens=4)


# -- attn_in's one-slot branch ------------------------------------------------------


def _wqkv(rng, H, Hkv, hd, D):
    return mk_q4((H + 2 * Hkv) * hd, D, rng)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("hd", [96, 64])
def test_one_slot_plain_matches_pallas(hd, R):
    """attn_in on one pre-fused wqkv at dim 512: the port's two views of its
    columns (qkv_slots: qk roped, v not; no copy) through the wrapper's
    plain version, against the reference's fused_attn_in(ws=[wqkv],
    interpret=True), which ropes its one output with tables padded by cos
    1, sin 0 over the v columns (n_pad); the port's two outputs side by
    side within 3e-2 of max|ref|. The gates agree: both fuse."""
    rng = np.random.default_rng(hd + R)
    D, H, Hkv = 512, 4, 4
    wqkv = _wqkv(rng, H, Hkv, hd, D)
    x = (rng.standard_normal((R, D)) * 0.5).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = _rope(rng.integers(0, 4000, (R,)), hd)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd, n_pad=Hkv * hd)
    (o,) = j_fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-5, [wqkv], cf, sf,
                           hd // 2, interpret=True)
    pq, pv = t_attn_in.qkv_slots(_port(wqkv), (H + Hkv) * hd)
    assert pq.arrays["qs"].data_ptr() + (H + Hkv) * hd == pv.arrays["qs"].data_ptr()
    assert t_attn_in.attn_in_supported(pq, pv, R, D, hd) and j_attn_in_supported([wqkv], R, D)
    before = _plain_calls()
    g0, g1 = t_attn_in.fused_attn_in(_bf(x), torch.from_numpy(nw), 1e-5, pq, pv,
                                     torch.from_numpy(cos), torch.from_numpy(sin), hd)
    assert _delta(before) == {"attn_in": 1}
    assert g0.shape == (R, (H + Hkv) * hd) and g1.shape == (R, Hkv * hd)
    _close(torch.cat([g0, g1], -1), o)


def _ai_col(tile: int, c: int, hd: int, tn: int = 128) -> int:
    """csrc/attn_in.cuh:ai_col, line for line."""
    if tn % hd == 0:
        return tile * tn + c
    runs, p = hd // 16, tile * (tn // 16) + (c % (tn // 2)) // 8
    return (p // runs) * hd + (hd // 2 if c >= tn // 2 else 0) + (p % runs) * 8 + c % 8


@pytest.mark.parametrize("hd, n", [(96, 6144), (96, 3072), (256, 4096), (64, 2304),
                                   (128, 1792), (96, 768), (96, 384)])
def test_column_map_covers_the_slot_in_rope_pairs(hd, n):
    """The kernel's column map over a slot of n columns (Phi-3-mini's qk and
    v slots, Gemma-2B's qk, TinyLlama's, Qwen's; the CPU tests' narrow
    ones): every column exactly once; a lane's 8 code columns (block
    columns 8 g .. 8 g + 7) one contiguous run; block column c < 64 and c +
    64 rope partners (the same head, half a head apart) where head_dim does
    not divide 128, and whole heads a block where it does; at 256 the map
    is the gemma family's earlier one (64 columns of a head's first half a
    block)."""
    assert t_attn_in.kernel_head_dim(hd) and n % 128 == 0 and n % hd == 0
    cols = [[_ai_col(tile, c, hd) for c in range(128)] for tile in range(n // 128)]
    assert sorted(x for b in cols for x in b) == list(range(n))
    for b in cols:
        for g in range(16):
            assert b[8 * g: 8 * g + 8] == list(range(b[8 * g], b[8 * g] + 8))
        if 128 % hd:
            for c in range(64):
                assert b[c + 64] == b[c] + hd // 2 and b[c] // hd == b[c + 64] // hd
                assert b[c] % hd < hd // 2
        else:
            assert b == list(range(b[0], b[0] + 128)) and b[0] % hd == 0
    if hd == 256:  # the earlier map: block h (hd / 128) + q, columns [64 q, 64 q + 64)
        for tile, b in enumerate(cols):
            h, q = divmod(tile, 2)
            assert b[:64] == [h * 256 + 64 * q + c for c in range(64)]


def test_head_dims_of_the_gate():
    """kernel_head_dim: the divisors of 128 and the multiples of 32 (phi3's
    96, the gemma family's 256); 80 (phi2, not ported) and odd or zero head
    dims stay on qmatmul, where the reference's gate has no head_dim rule."""
    assert all(t_attn_in.kernel_head_dim(h) for h in (16, 32, 64, 96, 128, 256))
    assert not any(t_attn_in.kernel_head_dim(h) for h in (0, 48, 80, 112, 3))


def _mirror():
    """tests/test_torch_attn_in.py's numpy mirror of the kernel's arithmetic
    (mirror_attn_in), loaded by path."""
    path = Path(__file__).with_name("test_torch_attn_in.py")
    spec = importlib.util.spec_from_file_location("_attn_in_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.mirror_attn_in


@pytest.mark.parametrize("R", [1, 16])
def test_kernel_mirror_on_the_slots_matches_plain(R):
    """The kernel's order mirrored in numpy (rms, bf16 hi + lo rows,
    gemv.cuh's group dots per K split of attn_in_plan, the splits in rank
    order, bf16, the rope in f32) on qkv_slots' views of one wqkv at head_dim
    96 (8 + 4 heads roped, 4 not; D 512) against attn_in_plain, within 1e-2
    of max|ref| (tests/test_torch_attn_in.py's bound)."""
    mirror = _mirror()
    rng = np.random.default_rng(96 + R)
    D, H, Hkv, hd = 512, 8, 4, 96
    wqkv = t_fixtures.random_packed(rng, "q4", (H + 2 * Hkv) * hd, D).to("cpu")
    wqk, wv = t_attn_in.qkv_slots(wqkv, (H + Hkv) * hd)
    x = (torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32) * 0.5)
         .to(torch.bfloat16).float().numpy())
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = (rng.random((R, hd // 2)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    p0, p1 = t_attn_in.attn_in_plain(t(x).to(torch.bfloat16), t(nw), 1e-5, wqk, wv, t(cos),
                                     t(sin), hd)
    m0, m1 = mirror(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    for got, ref in ((m0, p0), (m1, p1)):
        ref = ref.float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    # the slots' packed arrays for the kernel: wqkv's own, at its row stride
    for w in (wqk, wv):
        code, arrs = t_qmm.packed_arrays(w, "attn_in", strided=True)
        assert code == t_qmm.kernel_kind(wqkv)
        assert all(t_qmm.row_stride(a) == wqkv.shape[0] for a in arrs if a is not None)
    with pytest.raises(ValueError, match="contiguous"):
        t_qmm.packed_arrays(wqk, "qmm")  # the other kernels take whole weights only


def test_rot_plain_with_the_next_wqkv_matches_pallas():
    """#12 with the next layer's wqkv at head_dim 96 (4 + 4 heads, one
    slot): the port's plain rot on qkv_slots' views against the reference's
    fused_oproj_ffn_attn_in(ws2=[wqkv], interpret=True); y and the one-slot
    output (the port's two, side by side) within 2e-2 of max(1, max|ref|),
    tests/test_torch_fused_decode.py's tolerance for rot."""
    rng = np.random.default_rng(12)
    D, K, F, R, H, Hkv, hd = 512, 1024, 512, 2, 4, 4, 96
    wo, gu, dn = mk_q4(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    wqkv = _wqkv(rng, H, Hkv, hd, D)
    x = (rng.standard_normal((R, 1, D)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((R, 1, K)) * 0.5).astype(np.float32)
    nw, nw2 = ((rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32) for _ in range(2))
    cos, sin = _rope(rng.integers(0, 100, (R, 1)), hd)
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd, n_pad=Hkv * hd)
    y_r, qkv_r = j_rot.fused_oproj_ffn_attn_in(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), wo, jnp.asarray(nw), 1e-5,
        gu, dn, jnp.asarray(nw2), [wqkv], cf, sf, hd // 2, interpret=True)
    pw = [_port(w) for w in (wo, gu, dn)]
    slots = t_attn_in.qkv_slots(_port(wqkv), (H + Hkv) * hd)
    assert t_rot.rot_supported(*pw, list(slots), R, D, hd)
    before = _plain_calls()
    y, qk2, v2 = t_rot.fused_oproj_ffn_attn_in(
        _bf(x), _bf(attn), pw[0], torch.from_numpy(nw), 1e-5, pw[1], pw[2],
        torch.from_numpy(nw2), *slots, torch.from_numpy(cos), torch.from_numpy(sin), hd)
    assert _delta(before) == {"rot": 1}
    for g, r in ((y, y_r), (torch.cat([qk2, v2], -1), qkv_r)):
        r = np.asarray(r, np.float32)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), r, atol=2e-2 * max(1.0, np.abs(r).max()))


# -- dispatch at head_dim 96 ---------------------------------------------------------


@pytest.fixture(scope="module")
def wide_phi3(tmp_path_factory):
    """A 2-layer phi3 at dim 512 with 4 + 4 heads of 96 (tiny_config derives
    head_dim from dim / heads, so it is widened by dataclasses.replace, as
    tests/test_torch_fused_decode.py does), written by the JAX writer."""
    cfg = dataclasses.replace(j_tiny_config(arch="phi3", n_layers=2, dim=512, n_heads=4,
                                            n_kv_heads=4, ffn_dim=256, vocab_size=512),
                              head_dim=96)
    cfg = dataclasses.replace(cfg, rope=dataclasses.replace(cfg.rope, head_dim=96, n_rot=96))
    path = tmp_path_factory.mktemp("phi3w") / "w.gguf"
    j_write_fixture(path, cfg, seed=9, scale=0.08)
    return str(path)


def test_decode_runs_attn_in_on_the_slots(wide_phi3):
    """At head_dim 96 and dim 512 a decode step takes attn_in (the slots of
    wqkv) in both layers, as the reference's gate fuses ws = [wqkv]; the
    prefill and decode logits against the JAX engine's within 2e-2 of
    max|ref|, and 8 greedy tokens equal."""
    tc, tp, _ = load_model(wide_phi3, device="cpu")
    jc, jp, _ = jload(wide_phi3, scale_dtype="bf16")
    assert tc.head_dim == 96 and "wqkv" in tp["layers"][0]
    assert j_attn_in_supported([jp["layers"][0]["wqkv"]], 1, 512)
    eng = InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu")
    je = JEngine(jc, jp, max_batch=1, max_seq=64, impl="xla")
    prompt = [3, 100, 7, 256, 42, 9]
    lg, cache, lens = eng.prefill([prompt], eng.new_cache(1))
    jl, jcache, _ = je.prefill([prompt], je.new_cache(1))
    _close(lg, jl, 2e-2)
    tok = torch.argmax(lg, -1)
    before = _plain_calls()
    lg2, _ = eng.decode_step(tok, torch.tensor(lens), cache)
    assert _delta(before).get("attn_in") == 2
    jl2, _ = je.decode_step(jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(lens), jcache)
    _close(lg2, jl2, 2e-2)
    assert eng.generate([prompt], max_new_tokens=8) == je.generate([prompt], max_new_tokens=8)
