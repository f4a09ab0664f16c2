"""The port's CUDA kernels against their plain PyTorch versions, on a card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports neither JAX nor the JAX package, so
it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Tolerance:
2e-2 of max|ref|; the kernels sum in another order and the GEMV path keeps
dequantized weights in f32 where the plain version rounds them to bf16. The
prefill kernel is held to 2e-2 of each output row's own max|ref|: causal
attention's output shrinks along the prompt, so the whole output's max|ref|
(set by the first rows) would let a fault in the late tiles pass. The decode
kernel likewise, per (row, head): a row that attends few slots has a larger
output than one that attends many. qmm_int8
is held to 1e-3 of max|ref|: both sides sum exact integer partials of the
same Q8 codes (its activation quantization byte for byte), and differ only
in the f32 rescale's order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_kquant_torch.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import decode_attention as t_decode
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import prefill as t_prefill
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops import qmm_int8 as t_qmm_int8
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine, _bucket
from tpu_kquant_torch.runtime.loader import load_model
from tpu_kquant_torch.serving import ContinuousBatcher, Request

TOL = 2e-2
# the kernel lab's rungs against their plain versions: f32 summation order
# only (adjacent rungs differ by about 1e-3 of max|ref|, so TOL could not
# tell one rung's chain from another's)
LAB_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _pairs(a, b):
    bits = [torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
            .astype(np.uint32) for v in (a, b)]
    return (bits[0] | (bits[1] << 16)).view(np.float32)


def q4(N, K, rng, dev):
    s = rng.random((K // 32, N), dtype=np.float32) * 0.01
    return QTensor("q4", "kmajor", (N, K), {
        "qs": rng.integers(0, 256, (K // 2, N), dtype=np.uint8),
        "sm": _pairs(s, s * 7.5)}).to(dev)


def q6w(N, K, rng, dev):
    s = rng.random((K // 16, N), dtype=np.float32) * 0.004
    return QTensor("q6w", "kmajor", (N, K), {
        "qs": rng.integers(-32, 32, (K, N)).astype(np.int8),
        "sp": _pairs(s[0::2], s[1::2])}).to(dev)


def q4f(N, K, rng, dev):
    """q4 with f32 scales and mins (scale_dtype='f32')."""
    s = rng.random((K // 32, N), dtype=np.float32) * 0.01
    return QTensor("q4", "kmajor", (N, K), {
        "qs": rng.integers(0, 256, (K // 2, N), dtype=np.uint8), "scales": s,
        "mins": s * 7.5}).to(dev)


def q6wf(N, K, rng, dev):
    """q6w with f32 scales [K/16, N] (scale_dtype='f32')."""
    return QTensor("q6w", "kmajor", (N, K), {
        "qs": rng.integers(-32, 32, (K, N)).astype(np.int8),
        "scales": rng.random((K // 16, N), dtype=np.float32) * 0.004}).to(dev)


WEIGHTS = {"q4": q4, "q6w": q6w, "q4f": q4f, "q6wf": q6wf}


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _row_rel(got, ref):
    d = (got.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K,R", [("q4", 2304, 2048, 1), ("q6w", 32000, 2048, 3),
                                        ("q4", 11264, 2048, 512), ("q6w", 2048, 5632, 40),
                                        ("q4", 2048, 2048, 32), ("q6w", 256, 2048, 33),
                                        ("q4", 2064, 1024, 7), ("q6w", 400, 512, 64)])
def test_qmm_kernel_matches_plain(card, kind, N, K, R):
    rng = np.random.default_rng(N + R)
    qt = (q4 if kind == "q4" else q6w)(N, K, rng, card)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    launches = t_qmm.counter.launches
    y = t_qmm.qmm(x, qt)
    torch.cuda.synchronize()
    assert t_qmm.counter.launches == launches + 1
    assert _rel(y, t_qmm.qmm_plain(x, qt)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K,R,x_dtype,out_dtype", [
    ("q4", 151936, 1536, 1, "bfloat16", "float32"),  # Qwen2.5-1.5B's tied lm head
    ("q6w", 1536, 1536, 1, "bfloat16", "bfloat16"),  # its o_proj at decode
    ("q4", 17920, 1536, 512, "float32", "float32"),  # gate/up past the bias add
    ("q6w", 1536, 8960, 512, "float32", "float32"),  # down past the bias add
    ("q6w", 400, 512, 40, "float32", "bfloat16"),  # ragged tile edges
    ("q4", 2064, 1024, 5, "float32", "float32")])  # the GEMV's f32 staging
def test_qmm_kernel_qwen_shapes_and_f32_x_match_plain(card, kind, N, K, R, x_dtype, out_dtype):
    """f32 activations (qwen2's prefill after bf16 + f32 bias) are rounded to
    bf16 by the kernel and kept f32 by the plain version (ops/qmm.py)."""
    rng = np.random.default_rng(N + R)
    qt = (q4 if kind == "q4" else q6w)(N, K, rng, card)
    x = torch.randn(R, K, device=card).to(getattr(torch, x_dtype))
    odt = getattr(torch, out_dtype)
    launches = t_qmm.counter.launches
    y = t_qmm.qmm(x, qt, odt)
    torch.cuda.synchronize()
    assert t_qmm.counter.launches == launches + 1
    assert y.dtype == odt and y.shape == (R, N) and torch.isfinite(y).all()
    assert _rel(y, t_qmm.qmm_plain(x, qt, odt)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 5, 16])
def test_attn_in_kernel_matches_plain(card, R):
    rng = np.random.default_rng(R)
    D, hd, H, Hkv = 2048, 64, 32, 4
    wqk, wv = q4((H + Hkv) * hd, D, rng, card), q6w(Hkv * hd, D, rng, card)
    x = torch.randn(R, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(R, hd // 2, device=card), torch.rand(R, hd // 2, device=card)
    got = t_attn_in.fused_attn_in(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    torch.cuda.synchronize()
    ref = t_attn_in.attn_in_plain(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("wo_kind,R", [("q4", 1), ("q6w", 3), ("q6w", 16)])
def test_oproj_ffn_kernel_matches_plain(card, wo_kind, R):
    rng = np.random.default_rng(R)
    D, F = 2048, 5632
    ws = [(q4 if wo_kind == "q4" else q6w)(D, D, rng, card), q4(2 * F, D, rng, card),
          q6w(D, F, rng, card)]
    x = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    attn = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    got = t_ffn.fused_oproj_ffn(x, attn, ws[0], nw, 1e-5, ws[1], ws[2])
    torch.cuda.synchronize()
    assert _rel(got, t_ffn.oproj_ffn_plain(x, attn, ws[0], nw, 1e-5, ws[1], ws[2])) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D,F,R", [(1536, 8960, 1), (1536, 8960, 8), (3584, 18944, 3),
                                   (512, 256, 32)])
def test_ffn_kernel_matches_plain(card, D, F, R):
    """Qwen2.5-1.5B and -7B FFN shapes, and the tiny Qwen2's."""
    rng = np.random.default_rng(D + R)
    gu, dn = q4(2 * F, D, rng, card), q6w(D, F, rng, card)
    x = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    launches = t_ffn.ffn_counter.launches
    got = t_ffn.fused_ffn(x, nw, 1e-6, gu, dn)
    torch.cuda.synchronize()
    assert t_ffn.ffn_counter.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (R, D)
    assert _rel(got, t_ffn.ffn_plain(x, nw, 1e-6, gu, dn)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8])
def test_attn_in_kernel_with_biases_matches_plain(card, R):
    """Qwen2.5-1.5B: 12 + 2 heads of 128 over D = 1536, f32 biases."""
    rng = np.random.default_rng(40 + R)
    D, hd, H, Hkv = 1536, 128, 12, 2
    wqk, wv = q4((H + Hkv) * hd, D, rng, card), q6w(Hkv * hd, D, rng, card)
    x = torch.randn(R, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(R, hd // 2, device=card), torch.rand(R, hd // 2, device=card)
    biases = (torch.randn((H + Hkv) * hd, device=card), torch.randn(Hkv * hd, device=card))
    got = t_attn_in.fused_attn_in(x, nw, 1e-6, wqk, wv, cos, sin, hd, biases)
    torch.cuda.synchronize()
    ref = t_attn_in.attn_in_plain(x, nw, 1e-6, wqk, wv, cos, sin, hd, biases)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


@pytest.mark.cuda
def test_qwen2_engine_on_card_matches_cpu(card, tmp_path):
    """A tiny Qwen2 (biases, tied lm head; attention width 512 fails
    oproj_ffn's gate) on the card against the CPU: an 11-token prompt
    (attn_in with biases + ffn), a 40-token one (qmm with f32 activations),
    then decode steps fed the same tokens on both sides."""
    cfg = tiny_config(arch="qwen2", n_layers=2, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=256,
                      vocab_size=512)
    cfg = dataclasses.replace(cfg, tie_embeddings=True)
    path = write_fixture_gguf(tmp_path / "qwen2.gguf", cfg, seed=5)
    engines = [InferenceEngine(*load_model(path, device=d)[:2], max_seq=64, device=d)
               for d in (card, "cpu")]
    rng = np.random.default_rng(0)
    for n in (11, 40):
        prompt = rng.integers(3, 512, n).tolist()
        launches = {k: c.launches for k, c in _build.COUNTERS.items()}
        outs = []
        for eng in engines:
            logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
            steps, pos = [logits], torch.tensor(lens, device=eng.device)
            for t in (7, 99, 300):
                step, cache = eng.decode_step(torch.full((1,), t, device=eng.device), pos, cache)
                steps.append(step)
                pos = pos + 1
            outs.append([x.float().cpu() for x in steps])
        for got, ref in zip(*outs):
            assert torch.isfinite(got).all() and _rel(got, ref) < 5e-2
            top3 = torch.topk(ref, 3, dim=-1).indices
            assert (top3 == got.argmax(-1, keepdim=True)).any(-1).all()
        used = {k: c.launches - launches[k] for k, c in _build.COUNTERS.items()}
        fused = n <= 16
        assert used["attn_in"] == used["ffn"] == 2 * (3 + fused)
        assert used["oproj_ffn"] == 0
        assert used["qmm"] == 3 * 3 + (3 if fused else 11)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card, tmp_path):
    """The whole slice on the card (kernels) against the CPU (plain
    versions) on one fixture: a ragged batch of two prompts (32 rows: the
    decode kernels), a 40-token prompt (the qmm tiles), then decode steps
    fed the same tokens on both sides."""
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512)
    path = write_fixture_gguf(tmp_path / "w1024.gguf", cfg, seed=5)
    engines = [InferenceEngine(*load_model(path, device=d)[:2], max_batch=2, max_seq=64,
                               device=d) for d in (card, "cpu")]
    rng = np.random.default_rng(0)
    for rows in ([rng.integers(3, 512, 11).tolist(), rng.integers(3, 512, 5).tolist()],
                 [rng.integers(3, 512, 40).tolist()]):
        launches = {k: c.launches for k, c in _build.COUNTERS.items()}
        outs = []
        for eng in engines:
            logits, cache, lens = eng.prefill(rows, eng.new_cache(len(rows)))
            steps = [logits]
            pos = torch.tensor(lens, device=eng.device)
            for t in (7, 99, 300):
                tok = torch.full((len(rows),), t, device=eng.device)
                step, cache = eng.decode_step(tok, pos, cache)
                steps.append(step)
                pos = pos + 1
            outs.append([x.float().cpu() for x in steps])
        for got, ref in zip(*outs):
            assert torch.isfinite(got).all() and _rel(got, ref) < 5e-2
            top3 = torch.topk(ref, 3, dim=-1).indices
            assert (top3 == got.argmax(-1, keepdim=True)).any(-1).all()
        used = {k: c.launches - launches[k] for k, c in _build.COUNTERS.items()}
        fused = len(rows) * _bucket(max(map(len, rows))) <= 32
        assert used["attn_in"] == 2 * (3 + fused) and used["oproj_ffn"] == 2 * (3 + fused)
        assert used["qmm"] == 3 + (1 if fused else 11)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K,R,out_dtype", [
    ("q4f", 14336, 4096, 1, "bfloat16"),  # Mixtral expert gate/up, f32 scales
    ("q6wf", 4096, 14336, 1, "float32"),  # expert down
    ("q4f", 8, 4096, 1, "float32"),  # the router (N = 8)
    ("q4", 8, 4096, 3, "float32"),  # the router on bf16 pairs
    ("q4f", 8, 4096, 512, "float32"),  # the router's prefill tile
    ("q4", 8, 4096, 64, "float32"),
    ("q6wf", 4096, 14336, 40, "bfloat16"),
    ("q4f", 14336, 4096, 512, "bfloat16"),
    ("q6w", 12, 512, 40, "bfloat16"),  # N % 16 != 0 on the pairs' tile
    # every other projection a Mixtral-8x7B layer gives qmm, on either scale
    # layout, at decode rows, the bucket-16 prefill and the tiles
    ("q4", 14336, 4096, 1, "bfloat16"),  # expert gate/up on bf16 pairs
    ("q4", 14336, 4096, 16, "bfloat16"),
    ("q4", 14336, 4096, 512, "bfloat16"),
    ("q6w", 4096, 14336, 1, "float32"),  # expert down on bf16 pairs
    ("q6w", 4096, 14336, 16, "float32"),
    ("q6w", 4096, 14336, 512, "float32"),
    ("q6wf", 4096, 14336, 16, "float32"),
    ("q4", 8, 4096, 16, "float32"),
    ("q6w", 4096, 4096, 1, "bfloat16"),  # wo
    ("q6wf", 4096, 4096, 1, "bfloat16"),
    ("q6wf", 4096, 4096, 16, "bfloat16"),
    ("q6w", 32000, 4096, 1, "float32"),  # the lm head
    ("q6wf", 32000, 4096, 1, "float32"),
    ("q4", 5120, 4096, 512, "bfloat16"),  # wqk's prefill tile
    ("q6wf", 1024, 4096, 512, "bfloat16")])  # wv's, on f32 scales
def test_qmm_kernel_f32_layouts_and_narrow_n_match_plain(card, kind, N, K, R, out_dtype):
    rng = np.random.default_rng(N + K + R)
    qt = WEIGHTS[kind](N, K, rng, card)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    odt = getattr(torch, out_dtype)
    launches = t_qmm.counter.launches
    y = t_qmm.qmm(x, qt, odt)
    torch.cuda.synchronize()
    assert t_qmm.counter.launches == launches + 1
    assert y.dtype == odt and y.shape == (R, N) and torch.isfinite(y).all()
    assert _rel(y, t_qmm.qmm_plain(x, qt, odt)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 16])
def test_quantize_q8_kernel_is_byte_equal_to_act_quant(card, R):
    """The kernel's first launch against ops.act_quant: codes, scales and
    gsums bit for bit, with .5 ties (amax 127: scale 1) and an all-zero
    group."""
    from tpu_kquant_torch.ops.act_quant import quantize_activations

    x = (torch.randn(R, 4096, device=card) * 3).to(torch.bfloat16)
    x[0, :32] = 0
    x[-1, 32:64] = torch.tensor([127.0, 2.5, -2.5, 0.5, 1.5, -0.5, -1.5, 3.5] * 4, device=card)
    for got, want in zip(t_qmm_int8.quantize_q8(x), quantize_activations(x)):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,R", [(14336, 4096, 1), (14336, 4096, 8), (14336, 4096, 16),
                                   (8, 4096, 1), (256, 512, 32), (2064, 1024, 5)])
def test_qmm_int8_kernel_matches_plain(card, N, K, R):
    """Mixtral's expert gate/up and router, and ragged small shapes. The f32
    output is held to 1e-3 of max|ref|; the bf16 output (the gate/up's on
    the main path) is that output rounded, bit for bit (one rounding of an
    f32 sum moves a value by up to 2^-8, past 1e-3 of max|ref|)."""
    rng = np.random.default_rng(N + K + R)
    qt = q4f(N, K, rng, card)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    launches = t_qmm_int8.counter.launches
    y = t_qmm_int8.qmm_int8(x, qt, torch.float32)
    y16 = t_qmm_int8.qmm_int8(x, qt, torch.bfloat16)
    torch.cuda.synchronize()
    assert t_qmm_int8.counter.launches == launches + 2
    assert y.shape == (R, N) and torch.isfinite(y).all()
    assert torch.equal(y16, y.to(torch.bfloat16))
    assert _rel(y, t_qmm_int8.qmm_int8_plain(x, qt, torch.float32)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 5, 16])
def test_attn_in_kernel_f32_layouts_match_plain(card, R):
    """Mixtral-8x7B: 32 + 8 heads of 128 over D = 4096, f32 scales."""
    _check_mixtral_attn_in(card, R, q4f, q6wf)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 16])
def test_attn_in_kernel_mixtral_pairs_match_plain(card, R):
    """Mixtral-8x7B: 32 + 8 heads of 128 over D = 4096, bf16 scale pairs."""
    _check_mixtral_attn_in(card, R, q4, q6w)


def _check_mixtral_attn_in(card, R, make_qk, make_v):
    rng = np.random.default_rng(60 + R)
    D, hd, H, Hkv = 4096, 128, 32, 8
    wqk, wv = make_qk((H + Hkv) * hd, D, rng, card), make_v(Hkv * hd, D, rng, card)
    x = torch.randn(R, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(R, hd // 2, device=card), torch.rand(R, hd // 2, device=card)
    launches = t_attn_in.counter.launches
    got = t_attn_in.fused_attn_in(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    torch.cuda.synchronize()
    assert t_attn_in.counter.launches == launches + 1
    ref = t_attn_in.attn_in_plain(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8])
def test_ffn_kernel_f32_layouts_match_plain(card, R):
    """Qwen2.5-1.5B's FFN loaded with scale_dtype='f32': w_gateup q4 with
    f32 scales and mins, w_down q6w with f32 scales."""
    rng = np.random.default_rng(70 + R)
    D, F = 1536, 8960
    gu, dn = q4f(2 * F, D, rng, card), q6wf(D, F, rng, card)
    x = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    launches = t_ffn.ffn_counter.launches
    got = t_ffn.fused_ffn(x, nw, 1e-6, gu, dn)
    torch.cuda.synchronize()
    assert t_ffn.ffn_counter.launches == launches + 1
    assert _rel(got, t_ffn.ffn_plain(x, nw, 1e-6, gu, dn)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("wo_kind,R", [("q6wf", 1), ("q4f", 3), ("q6wf", 16)])
def test_oproj_ffn_kernel_f32_layouts_match_plain(card, wo_kind, R):
    """TinyLlama's decode layer loaded with scale_dtype='f32' (wo q6w, as the
    fixture stores it, and q4)."""
    rng = np.random.default_rng(80 + R)
    D, F = 2048, 5632
    ws = [WEIGHTS[wo_kind](D, D, rng, card), q4f(2 * F, D, rng, card), q6wf(D, F, rng, card)]
    x = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    attn = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    launches = t_ffn.counter.launches
    got = t_ffn.fused_oproj_ffn(x, attn, ws[0], nw, 1e-5, ws[1], ws[2])
    torch.cuda.synchronize()
    assert t_ffn.counter.launches == launches + 1
    assert _rel(got, t_ffn.oproj_ffn_plain(x, attn, ws[0], nw, 1e-5, ws[1], ws[2])) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype,impl", [("bf16", "auto"), ("f32", "int8")])
def test_moe_engine_on_card_matches_cpu(card, tmp_path, scale_dtype, impl):
    """A tiny Mixtral-style MoE (dim 512, 4 + 2 heads of 128, 4 experts, top
    2) from the port's writer, card against CPU: an 11-token prompt (decode
    rows: attn_in; qmm_int8 for the router and gate/up under int8) and a
    40-token one (the qmm tiles), then decode steps fed the same tokens."""
    cfg = tiny_config(n_layers=2, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=256,
                      vocab_size=512, n_experts=4, n_experts_used=2)
    path = write_fixture_gguf(tmp_path / "moe.gguf", cfg, seed=5)
    engines = [InferenceEngine(*load_model(path, scale_dtype=scale_dtype, device=d)[:2],
                               max_seq=64, device=d, impl=impl) for d in (card, "cpu")]
    rng = np.random.default_rng(0)
    L, E = 2, 4
    for n in (11, 40):
        prompt = rng.integers(3, 512, n).tolist()
        launches = {k: c.launches for k, c in _build.COUNTERS.items()}
        outs = []
        for eng in engines:
            logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
            steps, pos = [logits], torch.tensor(lens, device=eng.device)
            for t in (7, 99, 300):
                step, cache = eng.decode_step(torch.full((1,), t, device=eng.device), pos, cache)
                steps.append(step)
                pos = pos + 1
            outs.append([x.float().cpu() for x in steps])
        for got, ref in zip(*outs):
            assert torch.isfinite(got).all() and _rel(got, ref) < 5e-2
            top3 = torch.topk(ref, 3, dim=-1).indices
            assert (top3 == got.argmax(-1, keepdim=True)).any(-1).all()
        used = {k: c.launches - launches[k] for k, c in _build.COUNTERS.items()}
        fused = n <= 16
        int8 = impl == "int8"
        assert used["attn_in"] == L * (3 + fused)
        assert used["qmm_int8"] == (1 + 2 * E) * L * (3 + fused) * int8
        per_step = (1 + E) * L + 1 if int8 else (2 + 3 * E) * L + 1
        assert used["qmm"] == 3 * per_step + (per_step if fused else (4 + 3 * E) * L + 1)


# flash prefill cases: chip_smoke.py's phase-3 shapes (TinyLlama: 32 / 4
# heads of 64; the 1024-request burst), plus head_dim 128 (llama GGUFs with
# 128-wide heads; Qwen2.5-1.5B's 12 / 2 with a window and a ragged T)
# (B, T, S, H, Hkv, D, q_starts, int8, window)
PREFILL_CASES = {
    "path_t2048_bf16": (1, 2048, 2048, 32, 4, 64, [0], False, 0),
    "path_t2048_int8": (1, 2048, 2048, 32, 4, 64, [0], True, 0),
    "mid_history": (1, 256, 2240, 32, 4, 64, [1024], False, 0),
    "window_300": (1, 512, 2048, 32, 4, 64, [1024], True, 300),
    "ragged_t40": (3, 40, 320, 32, 4, 64, [0, 100, 200], False, 0),
    "head_dim_128": (2, 128, 256, 8, 2, 128, [64, 0], True, 0),
    "burst_bf16": (1024, 64, 64, 32, 4, 64, [0] * 1024, False, 0),
    "burst_int8": (1024, 64, 64, 32, 4, 64, [0] * 1024, True, 0),
    "hd128_window_ragged": (2, 72, 384, 12, 2, 128, [100, 248], False, 96),
    "hd128_window_ragged_int8": (2, 72, 384, 12, 2, 128, [100, 248], True, 96),
    # head_dim 256 (the gemma family; Gemma-2B's 8 / 1 heads)
    "hd256_t1024_bf16": (1, 1024, 1024, 8, 1, 256, [0], False, 0),
    "hd256_window_ragged_int8": (2, 72, 640, 8, 1, 256, [100, 500], True, 96),
}


def prefill_inputs(case, dev, seed=0):
    """Inputs of one case; k/v (and scales) are strided views of a 2-layer
    cache with 64 spare slots, as the llama path hands them over."""
    B, T, S, H, Hkv, D, starts, int8, window = PREFILL_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, device=dev, generator=g).to(torch.bfloat16)
    shape = (2, B, Hkv, S + 64, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.01 + 0.001
                  for _ in range(2))
        scales = (ks[1, :, :, :S], vs[1, :, :, :S])
    else:
        k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    qs = torch.tensor(starts, device=dev)
    return q, k[1, :, :, :S], v[1, :, :, :S], qs, scales, window


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_kernel_matches_plain(card, case):
    q, k, v, qs, scales, window = prefill_inputs(case, card)
    assert not k.is_contiguous()
    launches = t_prefill.counter.launches
    got = t_prefill.attention_prefill(q, k, v, qs, scales, sliding_window=window)
    torch.cuda.synchronize()
    assert t_prefill.counter.launches == launches + 1
    assert got.dtype == q.dtype and got.shape == q.shape and torch.isfinite(got).all()
    ref = t_prefill.attention_prefill_plain(q, k, v, qs, scales, sliding_window=window)
    assert _row_rel(got, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_t40", "mid_history", "head_dim_128",
                                  "hd128_window_ragged_int8"])
def test_prefill_kernel_every_row_grouping(card, case):
    """The kernel at every row grouping its plan can take (hw heads of the
    GQA group per warpgroup, each divisor), not only the default one."""
    q, k, v, qs, scales, window = prefill_inputs(case, card)
    ref = t_prefill.attention_prefill_plain(q, k, v, qs, scales, sliding_window=window)
    H, Hkv = q.shape[2], k.shape[1]
    for hw in [d for d in range(1, H // Hkv + 1) if (H // Hkv) % d == 0]:
        got = t_prefill._launch(q, k, v, qs, scales, q.shape[-1] ** -0.5, window, hw=hw)
        torch.cuda.synchronize()
        assert _row_rel(got, ref) < TOL, hw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_t40", "head_dim_128"])
def test_prefill_kernel_takes_f32_q(card, case):
    """qwen2's prefill hands the kernel f32 q (bf16 + f32 bias): the wrapper
    rounds it to bf16 for the kernel and returns f32, as the reference's
    kernel does; fp16 q raises instead of being cast."""
    q, k, v, qs, scales, window = prefill_inputs(case, card)
    qf = q.float() + 0.01 * torch.randn_like(q.float())  # not exactly bf16
    launches = t_prefill.counter.launches
    got = t_prefill.attention_prefill(qf, k, v, qs, scales)
    torch.cuda.synchronize()
    assert t_prefill.counter.launches == launches + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _row_rel(got, t_prefill.attention_prefill_plain(qf, k, v, qs, scales)) < TOL
    with pytest.raises(ValueError, match="dtype"):
        t_prefill.attention_prefill(q.half(), k, v, qs, scales)
    assert t_prefill.counter.launches == launches + 1


@pytest.mark.cuda
def test_int8_engine_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """The dim-1024 fixture on int8 KV, card against CPU: a 40-token prompt
    sent to the prefill kernel (budget 0; bucket 64 = the cache's 64 slots),
    then decode steps under the real budget (plain attention with kv_cur)."""
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512)
    path = write_fixture_gguf(tmp_path / "w1024.gguf", cfg, seed=5)
    engines = [InferenceEngine(*load_model(path, device=d)[:2], max_seq=64, kv_quantized=True,
                               device=d) for d in (card, "cpu")]
    prompt = np.random.default_rng(1).integers(3, 512, 40).tolist()
    outs = []
    launches = t_prefill.counter.launches
    for eng in engines:
        monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 0.0)
        logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
        monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 192.0)
        steps, pos = [logits], torch.tensor(lens, device=eng.device)
        for t in (7, 99):
            step, cache = eng.decode_step(torch.tensor([t], device=eng.device), pos, cache)
            steps.append(step)
            pos = pos + 1
        outs.append([x.float().cpu() for x in steps])
    assert t_prefill.counter.launches == launches + 2
    for got, ref in zip(*outs):
        assert torch.isfinite(got).all() and _rel(got, ref) < 5e-2


# flash decode (kernel #7) cases: chip_smoke.py's phase-3 shapes. The
# serving cell: 1024 slots of 2048, TinyLlama's 32 / 4 heads of 64, its
# positions 32-111 and positions uniform over the context; head_dim 128 at
# Qwen2.5-1.5B's 12 / 2 heads and Mixtral-8x7B's 32 / 8.
# (B, S, H, Hkv, D, positions: "serve" 32..111 or "uniform" 0..S-1, int8)
DECODE_CASES = {
    "serve_bf16": (1024, 2048, 32, 4, 64, "serve", False),
    "serve_int8": (1024, 2048, 32, 4, 64, "serve", True),
    "uniform_bf16": (1024, 2048, 32, 4, 64, "uniform", False),
    "uniform_int8": (1024, 2048, 32, 4, 64, "uniform", True),
    "qwen_hd128_bf16": (64, 2048, 12, 2, 128, "uniform", False),
    "mixtral_hd128_int8": (64, 2048, 32, 8, 128, "uniform", True),
}


def decode_inputs(case, dev, seed=0):
    """Inputs of one case: q [B, 1, H, D] as the unfused path slices it from
    its qk projection (strided), k/v strided views of layer 1 of a 2-layer
    cache."""
    B, S, H, Hkv, D, pos, int8 = DECODE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    qk = torch.randn(B, 1, (H + Hkv) * D, device=dev, generator=g).to(torch.bfloat16)
    q = qk[..., : H * D].reshape(B, 1, H, D)
    shape = (2, B, Hkv, S, D)
    if int8:
        k, v = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], device=dev, generator=g) * 0.01 + 0.001
                  for _ in range(2))
        scales = (ks[1], vs[1])
    else:
        k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    if pos == "serve":
        qp = torch.randint(32, 112, (B, 1), device=dev, generator=g)
    else:
        qp = torch.randint(0, S, (B, 1), device=dev, generator=g)
    return q, k[1], v[1], qp, scales


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attn_kernel_matches_plain(card, case):
    q, k, v, qp, scales = decode_inputs(case, card)
    launches = t_decode.counter.launches
    got = t_decode.attention_decode_flash(q, k, v, qp, scales)
    torch.cuda.synchronize()
    assert t_decode.counter.launches == launches + 1
    assert got.dtype == q.dtype and got.shape == q.shape and torch.isfinite(got.float()).all()
    assert _row_rel(got, t_decode.decode_attention_plain(q, k, v, qp, scales)) < TOL


@pytest.mark.cuda
def test_decode_attn_kernel_takes_f32_q_and_edge_positions(card):
    """An f32 q (qwen2's unfused decode) comes back f32; positions at a
    tile's first and last slot and at the cache's end."""
    q, k, v, _, scales = decode_inputs("qwen_hd128_bf16", card)
    B = q.shape[0]
    qp = torch.tensor([0, 63, 64, 127, 2047] * (B // 5) + [1] * (B % 5), device=card)[:, None]
    qf = q.float() + 0.01 * torch.randn_like(q.float())
    got = t_decode.attention_decode_flash(qf, k, v, qp, scales)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _row_rel(got, t_decode.decode_attention_plain(qf, k, v, qp, scales)) < TOL
    with pytest.raises(ValueError, match="dtype"):
        t_decode.attention_decode_flash(q.half(), k, v, qp, scales)


@pytest.mark.cuda
def test_serving_b16_on_card_counts_and_matches_cpu(card, tmp_path):
    """Sixteen greedy requests on 16 slots of the dim-1024 fixture, card
    against CPU: one admission burst (16 x bucket 16 = 256 rows: the qmm
    tiles for every projection), then ticks of 16 decode rows (attn_in and
    oproj_ffn in each layer, the lm head's qmm GEMV; the plain attention
    with the deferred append, below the budget). Launches exactly so; the
    first tokens agree and every row's first token is in the CPU's top 3."""
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512)
    path = write_fixture_gguf(tmp_path / "w1024.gguf", cfg, seed=5)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 512, int(n)).tolist() for n in rng.integers(3, 16, 16)]
    outs = []
    for d in (card, "cpu"):
        eng = InferenceEngine(*load_model(path, device=d)[:2], max_batch=16, max_seq=64, device=d)
        cb = ContinuousBatcher(eng)
        for p in prompts:
            cb.submit(Request(prompt=p, max_new_tokens=6))
        launches = {k: c.launches for k, c in _build.COUNTERS.items()}
        cb.step()
        first = cb.tick_logits.float().cpu()
        done = cb.run()
        if d == card:
            torch.cuda.synchronize()
            used = {k: c.launches - launches[k] for k, c in _build.COUNTERS.items()}
            ticks, L = cb.stats["steps"], cfg.n_layers
            assert cb.stats["prefills"] == 16 and ticks == 6
            assert used == {**used, "attn_in": L * ticks, "oproj_ffn": L * ticks,
                            "qmm": 5 * L + 1 + ticks, "prefill": 0, "decode_attn": 0,
                            "ffn": 0, "qmm_int8": 0}
        outs.append((first, {r.rid: r.output for r in done}))
    (fg, og), (fc, oc) = outs
    assert _rel(fg, fc) < 5e-2
    top3 = torch.topk(fc, 3, dim=-1).indices
    assert (top3 == fg.argmax(-1, keepdim=True)).any(-1).all()
    assert all(len(o) == 6 for o in og.values())


# -- every GGML type the loader reads: qmm's kinds, qmm_int8's q6 branch, ----------
# -- q8 / q6w / q4 in every slot of the fused kernels, the recipes end to end ------


def packed(kind, N, K, rng, dev, f32=False):
    """A random weight of any kind (models.fixtures.random_packed) on dev."""
    from tpu_kquant_torch.models.fixtures import random_packed

    return random_packed(rng, kind, N, K, f32=f32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("kind", ["q8", "q5", "q6", "q3", "q2"])
@pytest.mark.parametrize("N,K,R", [(11264, 2048, 1), (2304, 2048, 7), (2048, 5632, 33),
                                   (12, 512, 64), (400, 512, 3)])
def test_qmm_kernel_every_kind_matches_plain(card, kind, f32, N, K, R):
    """The kinds of Q8_0, Q5_K, unwidened Q6_K, Q3_K and Q2_K on bf16 pairs
    and f32 scales: the split-K GEMV (R <= 32) and the tile, at TinyLlama's
    gate/up, wqk and down and at ragged small shapes."""
    rng = np.random.default_rng(N + K + R)
    qt = packed(kind, N, K, rng, card, f32)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    launches = t_qmm.counter.launches
    y = t_qmm.qmm(x, qt, torch.float32)
    torch.cuda.synchronize()
    assert t_qmm.counter.launches == launches + 1
    assert y.shape == (R, N) and torch.isfinite(y).all()
    assert _rel(y, t_qmm.qmm_plain(x, qt, torch.float32)) < TOL


@pytest.mark.cuda
def test_qmm_kernel_refuses_a_k_it_does_not_take(card):
    """No quiet plain path: a bit-plane kind needs K % 256, q8 on bf16 pairs
    K % 64."""
    rng = np.random.default_rng(0)
    x = torch.randn(1, 384, device=card).to(torch.bfloat16)
    for kind in ("q5", "q3"):
        with pytest.raises(ValueError, match="shape"):
            t_qmm.qmm(x, packed(kind, 64, 384, rng, card))
    with pytest.raises(ValueError, match="shape"):
        t_qmm.qmm(x[:, :96], packed("q8", 64, 96, rng, card))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 16])
def test_quantize_q8_kernel_group16_is_byte_equal_to_act_quant(card, R):
    """The 16-groups of qmm_int8's q6 branch, ties and a zero group included."""
    from tpu_kquant_torch.ops.act_quant import quantize_activations

    x = (torch.randn(R, 2048, device=card) * 3).to(torch.bfloat16)
    x[0, :16] = 0
    x[-1, 16:32] = torch.tensor([127.0, 2.5, -2.5, 0.5, 1.5, -0.5, -1.5, 3.5] * 2, device=card)
    for got, want in zip(t_qmm_int8.quantize_q8(x, 16), quantize_activations(x, 16)):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,R", [(2048, 5632, 1), (2048, 5632, 8), (2048, 5632, 16),
                                   (32000, 2048, 1), (256, 512, 5)])
def test_qmm_int8_kernel_q6_matches_plain(card, N, K, R):
    """The q6 branch (widen_q6=False, f32 scales and mins) at TinyLlama's
    down and lm head: f32 output within 1e-3 of max|ref|."""
    rng = np.random.default_rng(N + K + R)
    qt = packed("q6", N, K, rng, card, f32=True)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    launches = t_qmm_int8.counter.launches
    y = t_qmm_int8.qmm_int8(x, qt, torch.float32)
    torch.cuda.synchronize()
    assert t_qmm_int8.counter.launches == launches + 1
    assert y.shape == (R, N) and torch.isfinite(y).all()
    assert _rel(y, t_qmm_int8.qmm_int8_plain(x, qt, torch.float32)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 16])
@pytest.mark.parametrize("kinds", [("q8", "q8", False, False), ("q6w", "q6w", False, False),
                                   ("q4", "q4", False, False), ("q8", "q8", True, True),
                                   ("q4", "q8", False, True), ("q6w", "q4", True, False)])
def test_attn_in_kernel_every_slot_kind_matches_plain(card, kinds, R):
    """TinyLlama's attn_in at Q8_0, Q6_K and Q4_K_S, and mixed kinds and
    scale layouts per slot, as the reference's gate admits them."""
    kq, kv, fq, fv = kinds
    rng = np.random.default_rng(R + len(kq) * 7)
    D, hd, H, Hkv = 2048, 64, 32, 4
    wqk, wv = packed(kq, (H + Hkv) * hd, D, rng, card, fq), packed(kv, Hkv * hd, D, rng, card, fv)
    assert t_attn_in.attn_in_supported(wqk, wv, R, D, hd)
    x = torch.randn(R, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(R, hd // 2, device=card), torch.rand(R, hd // 2, device=card)
    launches = t_attn_in.counter.launches
    got = t_attn_in.fused_attn_in(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    torch.cuda.synchronize()
    assert t_attn_in.counter.launches == launches + 1
    ref = t_attn_in.attn_in_plain(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True], ids=["pairs", "f32"])
@pytest.mark.parametrize("kind", ["q4", "q6w", "q8"])
def test_attn_in_kernel_rows_match_plain_and_the_row_alone(card, kind, f32):
    """TinyLlama's attn_in (32 + 4 heads of 64, D = 2048) with `kind` in both
    slots on bf16 pairs or f32 scales, at R = 1, 2, 8, 16 and 32: against
    its plain version, one launch counted per call, and each row of every
    call equal to that row computed alone, bit for bit (the K split and
    every order of sums come from the kinds and widths, never from R)."""
    rng = np.random.default_rng(len(kind) + 3 * f32)
    D, hd, H, Hkv = 2048, 64, 32, 4
    wqk, wv = packed(kind, (H + Hkv) * hd, D, rng, card, f32), packed(kind, Hkv * hd, D, rng,
                                                                      card, f32)
    x = torch.randn(32, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(32, hd // 2, device=card), torch.rand(32, hd // 2, device=card)
    run = lambda lo, hi: t_attn_in.fused_attn_in(x[lo:hi], nw, 1e-5, wqk, wv,  # noqa: E731
                                                 cos[lo:hi], sin[lo:hi], hd)
    alone = [run(r, r + 1) for r in range(32)]
    for R in (1, 2, 8, 16, 32):
        launches = t_attn_in.counter.launches
        got = run(0, R)
        torch.cuda.synchronize()
        assert t_attn_in.counter.launches == launches + 1
        ref = t_attn_in.attn_in_plain(x[:R], nw, 1e-5, wqk, wv, cos[:R], sin[:R], hd)
        assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL, R
        for r in range(R):
            assert all(torch.equal(g[r:r + 1], a) for g, a in zip(got, alone[r])), (R, r)


@pytest.mark.cuda
def test_attn_in_kernel_plan_is_the_host_plan(card):
    """The kernel's own split (C attn_in_plan) equals ops/attn_in.py's
    mirror at every pair of slot kinds and the models' widths."""
    codes = [c for c, (k, _) in enumerate(t_qmm.KINDS) if k in ("q4", "q6w", "q8")]
    for n0, n1, D in ((2304, 256, 2048), (1792, 256, 1536), (5120, 1024, 4096),
                      (768, 256, 512), (1536, 512, 1024), (9216, 1024, 8192)):
        for qk in codes:
            for v in codes:
                assert t_attn_in.kernel_plan(qk, v, n0, n1, D) == \
                    t_attn_in.attn_in_plan(qk, v, n0, n1, D), (qk, v, n0, n1, D)


@pytest.mark.cuda
@pytest.mark.parametrize("defer", [False, True], ids=["append", "deferred"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_decode_attention_rows_do_not_depend_on_the_batch(card, int8, defer):
    """The plain decode attention (the serving cell's: 16 rows of 128 slots,
    TinyLlama's heads) on the card: each row of the 16-row call equals the
    row computed alone, bit for bit, and the call is within 2e-2 of each
    (row, head)'s max|ref| of the CPU's einsum form."""
    g = torch.Generator(device=card).manual_seed(3 + int8 + 2 * defer)
    B, S, H, Hkv, D = 16, 128, 32, 4, 64
    q = torch.randn(B, 1, H, D, device=card, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=card, generator=g,
                              dtype=torch.int8) for _ in range(2))
        sc = tuple(torch.rand(B, Hkv, S, device=card, generator=g) * 0.02 + 0.001
                   for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, D, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
        sc = None
    pos = torch.randint(1, S, (B, 1), device=card, generator=g)
    cur = tuple(torch.randn(B, 1, Hkv, D, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2)) if defer else None
    sl = lambda t, lo, hi: None if t is None else tuple(u[lo:hi] for u in t)  # noqa: E731
    got = t_attention.attention_decode(q, k, v, pos, sc, kv_cur=cur)
    for b in range(B):
        one = t_attention.attention_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1],
                                           sl(sc, b, b + 1), kv_cur=sl(cur, b, b + 1))
        assert torch.equal(got[b:b + 1], one), b
    cpu = lambda t: None if t is None else (tuple(u.cpu() for u in t) if isinstance(t, tuple)  # noqa: E731
                                            else t.cpu())
    ref = t_attention.attention_plain(cpu(q), cpu(k), cpu(v), cpu(pos), cpu(sc), cpu(cur))
    assert _row_rel(got.cpu(), ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("kinds,f32", [(("q8", "q8", "q8"), False), (("q8", "q8", "q8"), True),
                                       (("q6w", "q6w", "q6w"), False), (("q4", "q8", "q6w"), True)])
def test_oproj_ffn_and_ffn_kernels_every_slot_kind_match_plain(card, kinds, f32, R):
    """TinyLlama's decode FFN with q8 (Q8_0) or q6w (Q6_K) in every slot, and
    a mix, on either scale layout: oproj_ffn, and ffn on its last two."""
    rng = np.random.default_rng(90 + R + f32)
    D, F = 2048, 5632
    wo, gu, dn = (packed(k, n, kk, rng, card, f32)
                  for k, (n, kk) in zip(kinds, ((D, D), (2 * F, D), (D, F))))
    assert t_ffn.oproj_ffn_supported(wo, gu, dn, R) and t_ffn.ffn_supported(gu, dn, R)
    x = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    attn = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    before = (t_ffn.counter.launches, t_ffn.ffn_counter.launches)
    got = t_ffn.fused_oproj_ffn(x, attn, wo, nw, 1e-5, gu, dn)
    got_ffn = t_ffn.fused_ffn(x, nw, 1e-5, gu, dn)
    torch.cuda.synchronize()
    assert (t_ffn.counter.launches, t_ffn.ffn_counter.launches) == (before[0] + 1, before[1] + 1)
    assert _rel(got, t_ffn.oproj_ffn_plain(x, attn, wo, nw, 1e-5, gu, dn)) < TOL
    assert _rel(got_ffn, t_ffn.ffn_plain(x, nw, 1e-5, gu, dn)) < TOL


def _card_against_cpu(card, path, load_kw, impl, prompts, **eng_kw):
    """Prefill each prompt and take 3 decode steps fed the same tokens, on the
    card and on the CPU (engines of 64 slots, with ``eng_kw``); logits within
    5e-2 of max|ref| and the card's top token in the CPU's top 3. Returns
    the card's launches per counter."""
    engines = [InferenceEngine(*load_model(path, device=d, **load_kw)[:2], max_seq=64,
                               device=d, impl=impl, **eng_kw) for d in (card, "cpu")]
    launches = {k: c.launches for k, c in _build.COUNTERS.items()}
    for prompt in prompts:
        outs = []
        for eng in engines:
            logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
            steps, pos = [logits], torch.tensor(lens, device=eng.device)
            for t in (7, 99, 300):
                step, cache = eng.decode_step(torch.full((1,), t, device=eng.device), pos, cache)
                steps.append(step)
                pos = pos + 1
            outs.append([x.float().cpu() for x in steps])
        for got, ref in zip(*outs):
            assert torch.isfinite(got).all() and _rel(got, ref) < 5e-2
            top3 = torch.topk(ref, 3, dim=-1).indices
            assert (top3 == got.argmax(-1, keepdim=True)).any(-1).all()
    return {k: c.launches - launches[k] for k, c in _build.COUNTERS.items()}


@pytest.mark.cuda
def test_tiny_q8_fixture_engine_on_card_matches_cpu(card, tmp_path):
    """A tiny fixture at the model tests' width (dim 64: the port's writer
    gives every weight Q8_0, since no 256-block divides K = 64 or 128) runs
    its q8 weights through the q8 GEMV and tiles on the card: 5 qmm a layer
    (no fused gate at dim 64) and the lm head, per forward."""
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=512)
    path = write_fixture_gguf(tmp_path / "tiny.gguf", cfg, seed=7)
    used = _card_against_cpu(card, path, {}, "auto", [list(range(3, 14))])
    assert used["qmm"] == 4 * (5 * 2 + 1) and used["attn_in"] == used["oproj_ffn"] == 0


# per recipe of the quantize tool, at dim 1024 (16 + 4 heads of 64, ffn 1024):
# (recipe, load options, impl, decode-step launches per layer, lm head counter)
RECIPE_DISPATCH = {
    "q8_0": ({}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    "q6_k": ({}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    "q5_k_m": ({}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_s": ({}, "auto", {"attn_in": 1, "qmm": 3}, "qmm"),
    "q3_k_m": ({}, "auto", {"qmm": 5}, "qmm"),
    "q2_k": ({}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_m widen_q6=False": ({"widen_q6": False}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_m widen_q6=False f32 int8": ({"widen_q6": False, "scale_dtype": "f32"}, "int8",
                                       {"qmm_int8": 5}, "qmm_int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RECIPE_DISPATCH))
def test_recipe_engine_on_card_matches_cpu(card, tmp_path, case):
    """Each recipe's fixture (port writer, 2 layers at dim 1024) on the card
    against the CPU, and its decode steps' launches as the recipe table
    gives them (11-token prompts: a 16-row prefill takes the decode kernels
    too)."""
    load_kw, impl, per_layer, head = RECIPE_DISPATCH[case]
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512)
    path = write_fixture_gguf(tmp_path / "r.gguf", cfg, seed=5, recipe=case.split()[0])
    used = _card_against_cpu(card, path, load_kw, impl, [list(range(3, 14))])
    want = {k: 4 * 2 * v for k, v in per_layer.items()}  # prefill + 3 steps, 2 layers
    want[head] = want.get(head, 0) + 4
    assert {k: used.get(k, 0) for k in ("attn_in", "oproj_ffn", "ffn", "qmm", "qmm_int8")} == \
        {k: want.get(k, 0) for k in ("attn_in", "oproj_ffn", "ffn", "qmm", "qmm_int8")}


# ---------------------------------------------------------------------------
# the reference's opt-in decode fusions: kv_append (#9), attn_out (#10),
# layer (#11), rot (#12) at TinyLlama's shapes
# ---------------------------------------------------------------------------

TINY = dict(D=2048, H=32, Hkv=4, hd=64, F=5632)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 704), (32, 2048)])
def test_kv_append_kernel_matches_plain(card, B, S):
    from tpu_kquant_torch.ops import kv_append as t_kv

    g = torch.Generator(device=card).manual_seed(B)
    shape = (3, B, TINY["Hkv"], S, TINY["hd"])
    k0, v0 = (torch.randn(shape, device=card, generator=g).to(torch.bfloat16) for _ in range(2))
    qk = torch.randn(B, 1, 36 * 64, device=card, generator=g).to(torch.bfloat16)
    kn = qk[..., 32 * 64:].reshape(B, 1, 4, 64)  # a strided view, as the forward gives it
    vn = torch.randn(B, 1, 4, 64, device=card, generator=g).to(torch.bfloat16)
    start = torch.randint(0, S, (B,), device=card, generator=g)
    k1, v1 = k0.clone(), v0.clone()
    launches = t_kv.counter.launches
    t_kv.kv_append(k1, v1, kn, vn, 2, start)
    torch.cuda.synchronize()
    assert t_kv.counter.launches == launches + 1
    t_kv.kv_append_plain(k0, v0, kn, vn, 2, start)
    assert torch.equal(k1, k0) and torch.equal(v1, v0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,pos,int8,wo_kind", [(1, 40, False, "q6wf"), (1, 700, True, "q4"),
                                                (16, 700, False, "q8f"), (16, 40, True, "q6wf")])
def test_attn_out_kernel_matches_plain(card, B, pos, int8, wo_kind):
    from tpu_kquant_torch.models.fixtures import random_packed
    from tpu_kquant_torch.ops import attn_out as t_ao

    rng = np.random.default_rng(B + pos)
    D, H, Hkv, hd, S = TINY["D"], TINY["H"], TINY["Hkv"], TINY["hd"], 704
    kind, f32 = wo_kind.rstrip("f"), wo_kind.endswith("f")
    wo = random_packed(rng, kind, D, H * hd, f32=f32).to(card)
    g = torch.Generator(device=card).manual_seed(pos)
    x = torch.randn(B, 1, D, device=card, generator=g).to(torch.bfloat16)
    q = torch.randn(B, 1, H, hd, device=card, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, hd), device=card, generator=g,
                              dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(B, Hkv, S, device=card, generator=g) * 0.02 + 0.001
                       for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, hd, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    qp = torch.randint(max(0, pos - 30), pos + 1, (B, 1), device=card, generator=g)
    assert t_ao.attn_out_supported(wo, H, Hkv, hd, B, S)
    att, att_ref = (torch.empty(B, H * hd, dtype=torch.bfloat16, device=card) for _ in range(2))
    launches = t_ao.counter.launches
    got = t_ao.fused_attn_out(x, q, k, v, qp, scales, wo, att=att)
    torch.cuda.synchronize()
    assert t_ao.counter.launches == launches + 1
    ref = t_ao.attn_out_plain(x, q, k, v, qp, scales, wo, att=att_ref)
    assert _row_rel(got.reshape(B, D), ref.reshape(B, D)) < TOL
    # the attention phase alone (6 splits of 2 tiles in a cluster), per row
    # and head, and the same bits as the phase's own entry point
    assert _row_rel(att.reshape(B, H, hd), att_ref.reshape(B, H, hd)) < TOL
    assert torch.equal(att, t_decode.fused_attention(q[:, 0], k, v, qp, scales))


# the attention phase of attn_out / layer alone (ops/decode_attention.py:
# fused_attention): (B, S, H, Hkv, hd, positions, int8 KV, the current token)
FUSED_ATTN_CASES = {
    "attn_out B=1 pos 700": (1, 704, 32, 4, 64, [700], False, False),
    "attn_out B=16 int8 ragged": (16, 704, 32, 4, 64, list(range(0, 704, 44)), True, False),
    "attn_out hd 128 GQA 6": (2, 512, 12, 2, 128, [37, 511], False, False),
    "attn_out hd 128 int8 GQA 16": (2, 2048, 32, 2, 128, [0, 2047], True, False),
    "layer B=4 ragged": (4, 704, 32, 4, 64, [0, 1, 255, 700], False, True),
    "layer S 100": (4, 100, 16, 4, 64, [0, 63, 64, 99], False, True),
    "layer hd 128 S 2048": (2, 2048, 12, 2, 128, [64, 2047], False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_ATTN_CASES))
def test_fused_attention_kernel_matches_plain(card, case):
    B, S, H, Hkv, hd, positions, int8, self_ = FUSED_ATTN_CASES[case]
    g = torch.Generator(device=card).manual_seed(S + B)
    q = torch.randn(B, H, hd, device=card, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, hd), device=card, generator=g,
                              dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(B, Hkv, S, device=card, generator=g) * 0.02 + 0.001
                       for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, hd, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    cur = tuple(torch.randn(B, Hkv, hd, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2)) if self_ else None
    qp = torch.tensor(positions, device=card)[:, None]
    launches = t_decode.fused_counter.launches
    got = t_decode.fused_attention(q, k, v, qp, scales, cur)
    torch.cuda.synchronize()
    assert t_decode.fused_counter.launches == launches + 1
    if self_:
        ref = t_decode.attend_with_current(q, k, v, qp, *cur)
    else:
        ref = t_decode.decode_attention_plain(q[:, None], k, v, qp, scales)
    assert _row_rel(got.reshape(B, H, hd), ref.reshape(B, H, hd)) < TOL
    # row b alone gives the same bits
    row = lambda ts, b: None if ts is None else tuple(t[b:b + 1] for t in ts)  # noqa: E731
    for b in range(B):
        one = t_decode.fused_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], qp[b:b + 1],
                                       row(scales, b), row(cur, b))
        assert torch.equal(one, got[b:b + 1])


def _layer_weights(rng, card):
    from tpu_kquant_torch.models.fixtures import random_packed

    D, H, Hkv, hd, F = (TINY[k] for k in ("D", "H", "Hkv", "hd", "F"))
    return [random_packed(rng, kind, N, K, f32=True).to(card) for kind, N, K in (
        ("q4", (H + Hkv) * hd, D), ("q6w", Hkv * hd, D), ("q6w", D, H * hd), ("q4", 2 * F, D),
        ("q6w", D, F))]


@pytest.mark.cuda
@pytest.mark.parametrize("positions,S", [([0], 704), ([256], 704), ([0, 1, 255, 700], 704),
                                         ([1, 255, 256, 700], 704),
                                         ([64, 1000, 1500, 2047], 2048)])
def test_layer_kernel_matches_plain(card, positions, S):
    from tpu_kquant_torch.ops import layer as t_layer
    from tpu_kquant_torch.ops.rope import rope_cos_sin
    from tpu_kquant_torch.models.config import RopeParams

    B = len(positions)
    D, H, Hkv, hd = TINY["D"], TINY["H"], TINY["Hkv"], TINY["hd"]
    rng = np.random.default_rng(B)
    ws = _layer_weights(rng, card)
    g = torch.Generator(device=card).manual_seed(B)
    x = (torch.randn(B, 1, D, device=card, generator=g) * 0.5).to(torch.bfloat16)
    anw, fnw = (torch.rand(D, device=card, generator=g) + 0.5 for _ in range(2))
    kc, vc = (torch.randn(B, Hkv, S, hd, device=card, generator=g).to(torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor(positions, device=card)[:, None]
    cos, sin = rope_cos_sin(pos, RopeParams(head_dim=hd, n_rot=hd))
    assert t_layer.layer_supported(*ws, B, D, H, Hkv, hd)
    att, att_ref = (torch.empty(B, H * hd, dtype=torch.bfloat16, device=card) for _ in range(2))
    launches = t_layer.counter.launches
    got = t_layer.fused_layer(x, pos, anw, fnw, 1e-5, *ws, cos, sin, kc, vc, H, Hkv, att=att)
    torch.cuda.synchronize()
    assert t_layer.counter.launches == launches + 1
    ref = t_layer.layer_plain(x, pos, anw, fnw, 1e-5, *ws, cos, sin, kc, vc, H, Hkv, att=att_ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _row_rel(a.reshape(B, -1), b.reshape(B, -1)) < TOL
    # the attention phase alone (S = 2048: 8 splits of 4 tiles in a
    # cluster), per row and head
    assert _row_rel(att.reshape(B, H, hd), att_ref.reshape(B, H, hd)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("R,f32", [(1, False), (8, False), (1, True), (8, True)])
def test_rot_kernel_matches_plain(card, R, f32):
    from tpu_kquant_torch.models.fixtures import random_packed
    from tpu_kquant_torch.ops import rot as t_rot

    D, H, Hkv, hd, F = (TINY[k] for k in ("D", "H", "Hkv", "hd", "F"))
    rng = np.random.default_rng(R + 10 * f32)
    ws = [random_packed(rng, kind, N, K, f32=f32).to(card) for kind, N, K in (
        ("q6w", D, H * hd), ("q4", 2 * F, D), ("q6w", D, F), ("q4", (H + Hkv) * hd, D),
        ("q6w", Hkv * hd, D))]
    g = torch.Generator(device=card).manual_seed(R)
    x, attn = ((torch.randn(R, D, device=card, generator=g) * 0.5).to(torch.bfloat16)
               for _ in range(2))
    nw, nw2 = (torch.rand(D, device=card, generator=g) + 0.5 for _ in range(2))
    cos, sin = (torch.rand(R, hd // 2, device=card, generator=g) for _ in range(2))
    launches = t_rot.counter.launches
    got = t_rot.fused_oproj_ffn_attn_in(x, attn, ws[0], nw, 1e-5, ws[1], ws[2], nw2, ws[3],
                                        ws[4], cos, sin, hd)
    torch.cuda.synchronize()
    assert t_rot.counter.launches == launches + 1
    ref = t_rot.rot_plain(x, attn, ws[0], nw, 1e-5, ws[1], ws[2], nw2, ws[3], ws[4], cos, sin,
                          hd)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


# (switches, load options, int8 KV, a decode step's launches) at a 2-layer
# fixture of dim 512 with 16 / 4 heads of 64 (every gate passes)
FUSED_PATHS = {
    "rotate": ({"TKQ_ROTATE_LAYER": "1"}, {}, False,
               {"attn_in": 1, "rot": 1, "oproj_ffn": 1, "qmm": 1}),
    "layer": ({"TKQ_FUSE_LAYER": "1", "TKQ_KV_APPEND_PALLAS": "1"}, {"scale_dtype": "f32"},
              False, {"layer": 2, "kv_append": 2, "qmm": 1}),
    "attn_out": ({"TKQ_FUSE_ATTN_OUT": "1", "TKQ_DEFER_APPEND": "0",
                  "TKQ_KV_APPEND_PALLAS": "1"}, {"scale_dtype": "f32"}, False,
                 {"attn_in": 2, "kv_append": 2, "attn_out": 2, "ffn": 2, "qmm": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_PATHS))
def test_fused_decode_paths_on_card_match_cpu(card, tmp_path, monkeypatch, name):
    env, load_kw, kv8, step = FUSED_PATHS[name]
    cfg = tiny_config(n_layers=2, dim=512, n_heads=16, n_kv_heads=4, ffn_dim=512,
                      vocab_size=512)
    cfg = dataclasses.replace(cfg, head_dim=64, rope=dataclasses.replace(cfg.rope, head_dim=64,
                                                                         n_rot=64))
    path = write_fixture_gguf(tmp_path / "f.gguf", cfg, seed=5)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    used = _card_against_cpu(card, path, load_kw, "auto", [list(range(3, 50))])
    # the 64-row prefill runs qmm for every projection; then 3 decode steps
    want = {k: 3 * v for k, v in step.items()}
    want["qmm"] = want.get("qmm", 0) + 5 * 2 + 1
    assert {k: used.get(k, 0) for k in want} == want


# the qmm kernel lab (#14 n geometry, #15 k geometry, #16 manual): one
# TinyLlama shape per kind and scale layout: (label, kind, s_fmt, N, K, R, tk)
LAB_CASES = (
    ("gate/up q4-sm", "q4", "sm", 11264, 2048, 1, 256),
    ("gate/up q4-f32", "q4", "f32", 11264, 2048, 1, 512),
    ("down q6w-sp", "q6w", "sp", 2048, 5632, 1, 256),
    ("down q6w-f32", "q6w", "f32", 2048, 5632, 1, 512),
    ("gate/up q8-sp", "q8", "sp", 11264, 2048, 1, 256),
    ("gate/up q8-f32", "q8", "f32", 11264, 2048, 1, 256),
    ("wqk q4-sm R=3", "q4", "sm", 2304, 2048, 3, 256),
    ("wqk q4-sm nk=1", "q4", "sm", 2304, 2048, 1, 1024),
)


def _lab_weight(kind, s_fmt, N, K, dev):
    from tpu_kquant_torch.models.fixtures import random_packed

    return random_packed(np.random.default_rng(N + K), kind, N, K, f32=s_fmt == "f32").to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["k", "n"])
@pytest.mark.parametrize("label,kind,s_fmt,N,K,R,tk", LAB_CASES)
def test_lab_qmm_kernels_match_plain(card, label, kind, s_fmt, N, K, R, tk, geometry):
    from tpu_kquant_torch.utils import kernel_lab as lab

    qt = _lab_weight(kind, s_fmt, N, K, card)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    xi8 = torch.ones(R, K, dtype=torch.int8, device=card)
    for mode in lab.MODES:
        got = lab.lab_qmm(x, xi8, qt, mode, s_fmt, tk, geometry=geometry, tn=256 if R == 1 else 512)
        torch.cuda.synchronize()
        ref = lab.lab_qmm_plain(x, xi8, qt, mode, s_fmt)
        if mode in ("dma", "extract"):
            assert torch.equal(got, ref), (label, mode)
        else:
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            assert rel <= LAB_TOL, (label, mode, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("s_fmt,R,tk", [("sm", 1, 256), ("sm", 3, 1024), ("f32", 1, 512),
                                        ("sm", 1, 128)])
def test_lab_qmm_manual_kernel_matches_plain(card, s_fmt, R, tk):
    from tpu_kquant_torch.quant.codecs import dequant_kmajor
    from tpu_kquant_torch.utils import kernel_lab as lab

    qt = _lab_weight("q4", s_fmt, 11264, 2048, card)
    x = torch.randn(R, 2048, device=card).to(torch.bfloat16)
    dma = lab.lab_qmm_manual(x, qt, "dma", s_fmt, tk)
    full = lab.lab_qmm_manual(x, qt, "full", s_fmt, tk)
    torch.cuda.synchronize()
    assert torch.equal(dma, lab.lab_qmm_manual_plain(x, qt, "dma", s_fmt))
    for ref, tol in ((lab.lab_qmm_manual_plain(x, qt, "full", s_fmt), LAB_TOL),
                     (x.float() @ dequant_kmajor(qt).float(), TOL)):
        assert ((full - ref).abs().max() / ref.abs().max()).item() <= tol


# the prefill-attention lab (#17 A, #18 B, #19 G): (H, Hkv, D, T, S,
# q_start, ts). Ragged: B's last ts tile is live and cut at S (the slots the
# reference reads past S), at S 704 and at an S that no 64-slot sub-tile
# divides; even: every tile whole, the queries late in the cache.
PREFILL_LAB_CASES = {
    "tiny ragged S 704 ts 384": (32, 4, 64, 512, 704, 0, 384),
    "tiny ragged S 700 ts 384": (32, 4, 64, 512, 700, 0, 384),
    "tiny even S 1024 q_start 512": (32, 4, 64, 512, 1024, 512, 256),
    "qwen ragged S 704 ts 384": (12, 2, 128, 512, 704, 0, 384),
    "qwen even S 512 q_start 256": (12, 2, 128, 256, 512, 256, 128),
}


def _prefill_lab_inputs(case, dev):
    H, Hkv, D, T, S, q_start, ts = PREFILL_LAB_CASES[case]
    g = torch.Generator(device=dev).manual_seed(T + S)
    q = torch.randn(1, Hkv, H // Hkv, T, D, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, torch.tensor([q_start], dtype=torch.int32, device=dev), D ** -0.5, ts


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["a", "b", "g"])
@pytest.mark.parametrize("case", sorted(PREFILL_LAB_CASES))
def test_prefill_lab_kernels_match_plain(card, case, variant):
    from tpu_kquant_torch.utils import prefill_lab as lab

    q, k, v, qs, scale, ts = _prefill_lab_inputs(case, card)
    call, plain = lab.CALLS[variant]
    counter = {"a": lab.counter_a, "b": lab.counter_b, "g": lab.counter_g}[variant]
    extra = () if variant == "a" else (ts,)
    launches = counter.launches
    got = call(q, k, v, qs, scale, 128, *extra)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _row_rel(got, plain(q, k, v, qs, scale, 128, *extra)) < TOL


@pytest.mark.cuda
def test_prefill_lab_kernels_refuse_what_they_do_not_take(card):
    from tpu_kquant_torch.utils import prefill_lab as lab

    q, k, v, qs, scale, _ = _prefill_lab_inputs("tiny even S 1024 q_start 512", card)
    with pytest.raises(ValueError, match="bf16"):
        lab.call_a(q.float(), k, v, qs, scale, 128)
    with pytest.raises(ValueError, match="head_dim"):
        lab.call_b(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(),
                   qs, scale, 128, 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        lab.call_b(q, k, v, qs, scale, 128, 100)
    with pytest.raises(ValueError, match="contiguous"):
        lab.call_g(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, qs, scale, 128, 128)
    # G keeps 16 rows x S f32 logits a warp: at S = 8192 one head's do not fit
    kl = torch.zeros(1, 4, 8192, 64, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="does not fit"):
        lab.call_g(q, kl, kl, qs, scale, 128, 128)


# ---------------------------------------------------------------------------
# qmm's wgmma tile (R > 32; csrc/qmm_tile.cuh)
# ---------------------------------------------------------------------------

TILE_KINDS = [(k, f) for k in ("q4", "q6w", "q8", "q5", "q6", "q3", "q2") for f in (False, True)]


def _tile_case(kind, f32, N, K, R, card, x_dtype=torch.bfloat16, out_dtype=torch.bfloat16):
    rng = np.random.default_rng(N + K + R)
    qt = packed(kind, N, K, rng, card, f32)
    x = torch.randn(R, K, device=card).to(x_dtype)
    launches = t_qmm.counter.launches
    y = t_qmm.qmm(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert t_qmm.counter.launches == launches + 1
    assert y.dtype == out_dtype and y.shape == (R, N) and torch.isfinite(y).all()
    assert _rel(y, t_qmm.qmm_plain(x, qt, out_dtype)) < TOL
    return qt, x, y


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("R", [512, 2048])
@pytest.mark.parametrize("kind,f32", TILE_KINDS, ids=[f"{k}{'-f32' if f else ''}"
                                                      for k, f in TILE_KINDS])
def test_qmm_tile_every_kind_code_matches_plain(card, kind, f32, R, out_dtype):
    """All 14 kind codes at TinyLlama's wqk [2304, 2048], prefill rows."""
    _tile_case(kind, f32, 2304, 2048, R, card, out_dtype=getattr(torch, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f32", [("q4", False), ("q6w", True), ("q5", True), ("q8", False)])
def test_qmm_tile_takes_f32_x(card, kind, f32):
    """f32 activations are rounded to bf16 once by the wrapper."""
    _tile_case(kind, f32, 1536, 8960 if kind in ("q6w", "q8") else 1536, 512, card,
               x_dtype=torch.float32, out_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f32,N,K,R,out_dtype", [
    ("q4", True, 8, 4096, 512, "float32"),  # Mixtral's router
    ("q6w", False, 256, 2048, 1024, "bfloat16"),  # TinyLlama's wv at a 1024-slot tick
    ("q6w", True, 1024, 4096, 512, "bfloat16"),  # Mixtral's wv
    ("q6w", False, 2048, 5632, 512, "bfloat16"),  # TinyLlama's down
    ("q6w", True, 4096, 14336, 128, "float32"),  # Mixtral's expert down, 128 rows
    ("q6", False, 2048, 5632, 512, "float32"),  # unwidened Q6_K's down
    ("q3", True, 256, 2048, 65, "bfloat16")])
def test_qmm_tile_split_k_matches_plain_and_repeats_bit_for_bit(card, kind, f32, N, K, R,
                                                                  out_dtype):
    """Splits over K (tile_plan) sum their partials in a fixed order: two
    calls give equal bits."""
    bm, _, splits, _ = t_qmm.tile_plan(R, N, K, t_qmm.KIND_CODE[(kind, "f32" if f32 else
                                                                 ("sp" if kind in ("q6w", "q8")
                                                                  else "sm"))])
    assert splits > 1
    qt, x, y = _tile_case(kind, f32, N, K, R, card, out_dtype=getattr(torch, out_dtype))
    assert torch.equal(t_qmm.qmm(x, qt, y.dtype), y)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [33, 65, 1000])
@pytest.mark.parametrize("kind,f32,N,K", [("q4", False, 1000, 2048), ("q6w", False, 2052, 2080),
                                          ("q8", True, 8, 2048), ("q5", False, 2052, 2304),
                                          ("q2", True, 1000, 1024)])
def test_qmm_tile_ragged_rows_and_columns_match_plain(card, kind, f32, N, K, R):
    """R % 128 != 0, N % 128 != 0 (N % 16 != 0 takes the 4-byte code copies),
    and q6w's K % 64 == 32 (a half step)."""
    for out_dtype in (torch.bfloat16, torch.float32):
        _tile_case(kind, f32, N, K, R, card, out_dtype=out_dtype)


@pytest.mark.cuda
def test_qmm_tile_graph_replay_equals_eager(card):
    """The wrapper allocates out and ws with torch.empty: a captured call
    replays to the eager call's bits, split and unsplit."""
    rng = np.random.default_rng(5)
    cases = [(q4(11264, 2048, rng, card), torch.randn(512, 2048, device=card)),
             (q6w(2048, 5632, rng, card), torch.randn(512, 5632, device=card))]
    for qt, x in cases:
        x = x.to(torch.bfloat16)
        eager = t_qmm.qmm(x, qt)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            t_qmm.qmm(x, qt)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = t_qmm.qmm(x, qt)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager)


# ---------------------------------------------------------------------------
# the decode GEMV (R <= 32; csrc/gemv.cuh) and qmm_int8's int8-mma kernel
# ---------------------------------------------------------------------------

GEMV_ROWS = [1, 2, 3, 8, 16, 17, 31, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 96, 2304])
@pytest.mark.parametrize("kind,f32", TILE_KINDS, ids=[f"{k}{'-f32' if f else ''}"
                                                      for k, f in TILE_KINDS])
def test_gemv_every_kind_code_matches_plain(card, kind, f32, N):
    """All 14 kind codes at every GEMV row count (one to four n-tiles, ragged
    ones among them) and N = 8 (the router: a block's first lanes only), 96
    (N % 8 != 0 past a 256-column block's edge: 4-byte code loads) and
    2304, K = 2048; f32 and bf16 out."""
    rng = np.random.default_rng(N + 7)
    qt = packed(kind, N, 2048, rng, card, f32)
    for R in GEMV_ROWS:
        x = torch.randn(R, 2048, device=card).to(torch.bfloat16)
        for odt in (torch.float32, torch.bfloat16):
            y = t_qmm.qmm(x, qt, odt)
            torch.cuda.synchronize()
            assert y.dtype == odt and y.shape == (R, N) and torch.isfinite(y).all()
            assert _rel(y, t_qmm.qmm_plain(x, qt, odt)) < TOL, (R, odt)


def _solo_rows_equal(fn, xs, rows=(16, 32)):
    """Row r of fn at R rows (R in rows) equals, bit for bit, that row alone."""
    tup = lambda y: y if isinstance(y, tuple) else (y,)  # noqa: E731
    solo = [tup(fn(*(x[r:r + 1] for x in xs))) for r in range(max(rows))]
    for R in rows:
        got = tup(fn(*(x[:R] for x in xs)))
        for r in range(R):
            for g, o in zip(got, solo[r]):
                assert torch.equal(g[r:r + 1], o), (R, r)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(2304, 2048), (4096, 4096)])
@pytest.mark.parametrize("kind,f32", TILE_KINDS, ids=[f"{k}{'-f32' if f else ''}"
                                                      for k, f in TILE_KINDS])
def test_gemv_rows_do_not_depend_on_the_batch(card, kind, f32, N, K):
    """qmm's row r at R = 16 and 32 is the row computed alone, bit for bit:
    the split plan ignores R and the per-row arithmetic is R's too."""
    rng = np.random.default_rng(N + K)
    qt = packed(kind, N, K, rng, card, f32)
    x = torch.randn(32, K, device=card).to(torch.bfloat16)
    _solo_rows_equal(lambda xx: t_qmm.qmm(xx, qt, torch.float32), (x,))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K", [("q4", 14336, 4096), ("q6", 2048, 5632), ("q4", 96, 2048)])
def test_qmm_int8_rows_do_not_depend_on_the_batch(card, kind, N, K):
    from tpu_kquant_torch.models.fixtures import random_packed

    qt = random_packed(np.random.default_rng(N), kind, N, K, f32=True).to(card)
    x = torch.randn(32, K, device=card).to(torch.bfloat16)
    _solo_rows_equal(lambda xx: t_qmm_int8.qmm_int8(xx, qt, torch.float32), (x,))


@pytest.mark.cuda
def test_fused_kernels_rows_do_not_depend_on_the_batch(card):
    """attn_in, oproj_ffn, ffn and rot (TinyLlama's widths; ffn at
    Qwen2.5-1.5B's) at R = 16 and 32, each row against the row alone."""
    from tpu_kquant_torch.models.fixtures import random_packed
    from tpu_kquant_torch.ops import rot as t_rot

    rng = np.random.default_rng(3)
    D, H, Hkv, hd, F = (TINY[k] for k in ("D", "H", "Hkv", "hd", "F"))
    w = lambda kind, N, K: random_packed(rng, kind, N, K).to(card)  # noqa: E731
    wqk, wv, wo, gu, dn = (w("q4", (H + Hkv) * hd, D), w("q6w", Hkv * hd, D), w("q6w", D, H * hd),
                           w("q4", 2 * F, D), w("q6w", D, F))
    nw = torch.rand(D, device=card) + 0.5
    x, at = ((torch.randn(32, D, device=card) * 0.5).to(torch.bfloat16) for _ in range(2))
    cos, sin = (torch.rand(32, hd // 2, device=card) for _ in range(2))
    _solo_rows_equal(lambda a, c, s: t_attn_in.fused_attn_in(a, nw, 1e-5, wqk, wv, c, s, hd),
                     (x, cos, sin))
    _solo_rows_equal(lambda a, b: t_ffn.fused_oproj_ffn(a, b, wo, nw, 1e-5, gu, dn), (x, at))
    _solo_rows_equal(lambda a, b, c, s: t_rot.fused_oproj_ffn_attn_in(
        a, b, wo, nw, 1e-5, gu, dn, nw, wqk, wv, c, s, hd), (x, at, cos, sin))
    gq, dq = w("q4", 2 * 8960, 1536), w("q6w", 1536, 8960)
    nq = torch.rand(1536, device=card) + 0.5
    xq = (torch.randn(32, 1536, device=card) * 0.5).to(torch.bfloat16)
    _solo_rows_equal(lambda a: t_ffn.fused_ffn(a, nq, 1e-6, gq, dq), (xq,))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 32])
@pytest.mark.parametrize("kinds", [("q6w", "q4", "q6w"), ("q8f", "q8f", "q8f"),
                                   ("q4f", "q4f", "q6wf")])
def test_oproj_ffn_residual_epilogue_matches_plain(card, kinds, R):
    """oproj_ffn's two GEMV steps end in store_out's residual epilogue
    (o_proj: + x, rounded to bf16; down: + x2), split over K or not."""
    from tpu_kquant_torch.models.fixtures import random_packed

    rng = np.random.default_rng(R)
    D, H, hd, F = (TINY[k] for k in ("D", "H", "hd", "F"))
    ko, kg, kd = kinds
    wo, gu, dn = (random_packed(rng, k.rstrip("f"), N, K, f32=k.endswith("f")).to(card)
                  for k, N, K in ((ko, D, H * hd), (kg, 2 * F, D), (kd, D, F)))
    nw = torch.rand(D, device=card) + 0.5
    x, at = ((torch.randn(R, D, device=card) * 0.5).to(torch.bfloat16) for _ in range(2))
    got = t_ffn.fused_oproj_ffn(x, at, wo, nw, 1e-5, gu, dn)
    torch.cuda.synchronize()
    assert _rel(got, t_ffn.oproj_ffn_plain(x, at, wo, nw, 1e-5, gu, dn)) < TOL


@pytest.mark.cuda
def test_gemv_graph_replay_equals_eager(card):
    """A captured GEMV call (split over K and not; qmm_int8 too) replays to
    the eager call's bits."""
    from tpu_kquant_torch.models.fixtures import random_packed

    rng = np.random.default_rng(6)
    calls = [(lambda x, qt=q6w(2048, 5632, rng, card): t_qmm.qmm(x, qt), 5632, 16),
             (lambda x, qt=q4(32000, 2048, rng, card): t_qmm.qmm(x, qt, torch.float32), 2048, 1),
             (lambda x, qt=random_packed(rng, "q4", 14336, 4096, f32=True).to(card):
              t_qmm_int8.qmm_int8(x, qt), 4096, 32)]
    for fn, K, R in calls:
        x = torch.randn(R, K, device=card).to(torch.bfloat16)
        eager = fn(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(x)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = fn(x)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,K", [("q4", 14336, 4096), ("q6", 32000, 2048), ("q4", 96, 2048),
                                      ("q6", 8, 2048)])
@pytest.mark.parametrize("R", [1, 17, 32])
def test_qmm_int8_kernel_every_tile_count_matches_plain(card, kind, N, K, R):
    from tpu_kquant_torch.models.fixtures import random_packed

    qt = random_packed(np.random.default_rng(N + R), kind, N, K, f32=True).to(card)
    x = torch.randn(R, K, device=card).to(torch.bfloat16)
    y = t_qmm_int8.qmm_int8(x, qt, torch.float32)
    torch.cuda.synchronize()
    assert _rel(y, t_qmm_int8.qmm_int8_plain(x, qt, torch.float32)) < 1e-3


# flash decode (#7) on tensor cores: head dims 64 and 128, GQA groups 6 and
# 8, bf16 and int8 KV, positions at the tiles' and the splits' edges
@pytest.mark.cuda
@pytest.mark.parametrize("G", [6, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attn_heads_and_edges_match_plain_and_the_row_alone(card, int8, D, G):
    """Each row against decode_attention_plain (per row, TOL) and the
    kernel's blocking in plain PyTorch (decode_attention_split_plain), and
    each row of the B-row call equal, bit for bit, to the row alone."""
    Hkv, S = 2, 2048
    H = G * Hkv
    g = torch.Generator(device=card).manual_seed(D + G + int8)
    tps = t_decode.decode_plan(S, D, int8)[0]
    pos = [0, 1, 63, 64, 65, 127, 64 * tps - 1, 64 * tps, 2047, 1000, 447]
    B = len(pos)
    q = torch.randn(B, 1, H, D, device=card, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=card, generator=g,
                              dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(B, Hkv, S, device=card, generator=g) * 0.02 + 0.001
                       for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, D, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    qp = torch.tensor(pos, device=card)[:, None]
    got = t_decode.attention_decode_flash(q, k, v, qp, scales)
    torch.cuda.synchronize()
    assert _row_rel(got, t_decode.decode_attention_plain(q, k, v, qp, scales)) < TOL
    assert _row_rel(got, t_decode.decode_attention_split_plain(q, k, v, qp, scales)) < TOL
    for b in range(B):
        sc = None if scales is None else tuple(t[b:b + 1] for t in scales)
        alone = t_decode.attention_decode_flash(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                qp[b:b + 1], sc)
        assert torch.equal(got[b:b + 1], alone), b


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attn_rows_do_not_depend_on_the_batch(card, int8):
    """Row b of B = 16 and B = 1024 calls at the serving cell's shapes
    (TinyLlama's heads, 2048 slots, positions over the whole context)
    equals row b alone, bit for bit: the split plan ignores B."""
    q, k, v, qp, scales = decode_inputs("uniform_int8" if int8 else "uniform_bf16", card, seed=4)

    def rows(lo, hi):
        sc = None if scales is None else tuple(t[lo:hi] for t in scales)
        return t_decode.attention_decode_flash(q[lo:hi], k[lo:hi], v[lo:hi], qp[lo:hi], sc)

    full, sixteen = rows(0, q.shape[0]), rows(0, 16)
    for b in list(range(16)) + list(range(16, q.shape[0], 101)):
        alone = rows(b, b + 1)
        assert torch.equal(full[b:b + 1], alone), b
        if b < 16:
            assert torch.equal(sixteen[b:b + 1], alone), b


# the gate/up phase alone (csrc/gate_up.cuh) at every kind the fused gates take
@pytest.mark.cuda
@pytest.mark.parametrize("kind,f32", [("q4", False), ("q4", True), ("q6w", False), ("q6w", True),
                                      ("q8", False), ("q8", True)])
def test_gate_up_phase_every_kind_matches_plain_and_the_row_alone(card, kind, f32):
    """ops/ffn.py:gate_up at TinyLlama's w_gateup [11264, 2048] and Qwen2.5-
    1.5B's [17920, 1536], R = 1, 8 and 32, against gate_up_plain (TOL of
    max|ref| on the bf16 activation); rows at R = 16 and 32 equal the row
    alone, bit for bit."""
    rng = np.random.default_rng(7 + f32)
    for F, D in ((5632, 2048), (8960, 1536)):
        gu = packed(kind, 2 * F, D, rng, card, f32)
        nw = torch.rand(D, device=card) + 0.5
        x = (torch.randn(32, D, device=card) * 0.5).to(torch.bfloat16)
        for R in (1, 8, 32):
            before = t_ffn.gate_up_counter.launches
            got = t_ffn.gate_up(x[:R], nw, 1e-5, gu)
            torch.cuda.synchronize()
            assert t_ffn.gate_up_counter.launches == before + 1
            assert got.shape == (R, F) and got.dtype == torch.bfloat16
            assert _rel(got, t_ffn.gate_up_plain(x[:R], nw, 1e-5, gu)) < TOL, (F, R)
        _solo_rows_equal(lambda a: t_ffn.gate_up(a, nw, 1e-5, gu), (x,))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f32,N,K", [("q4", False, 2304, 2048), ("q6w", False, 256, 2048),
                                          ("q6w", False, 2048, 5632), ("q4", False, 11264, 2048),
                                          ("q8", True, 2304, 2048), ("q5", False, 2304, 2048),
                                          ("q2", True, 2304, 2048)])
def test_qmm_tile_burst_blocks_equal_the_64_row_calls(card, kind, f32, N, K):
    """qmm's tile: rows [64 i, 64 i + 64) of a 16 x 64 burst (the batcher's
    burst prefill) equal the 64-row call of the same rows, bit for bit (the
    tile's K split does not depend on R), as do rows of a 2048-row call
    against its 512-row slices."""
    rng = np.random.default_rng(N + K)
    qt = packed(kind, N, K, rng, card, f32)
    x = torch.randn(2048, K, device=card).to(torch.bfloat16)
    burst = t_qmm.qmm(x[:1024], qt)
    for i in range(16):
        assert torch.equal(burst[64 * i:64 * i + 64], t_qmm.qmm(x[64 * i:64 * i + 64], qt)), i
    full = t_qmm.qmm(x, qt, torch.float32)
    for i in range(4):
        assert torch.equal(full[512 * i:512 * i + 512],
                           t_qmm.qmm(x[512 * i:512 * i + 512], qt, torch.float32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1536, 2048, 4096])
def test_rms_norm_rows_do_not_depend_on_the_batch(card, D):
    """ops/norms.py:rms_norm on the card: a prompt's rows of a 16 x 64-token
    burst equal the prompt alone, and a row of 1024 rows the row alone, bit
    for bit (the two-stage sum of squares)."""
    from tpu_kquant_torch.ops.norms import rms_norm

    g = torch.Generator(device=card).manual_seed(D)
    x = (torch.randn(16, 64, D, device=card, generator=g) * 2).to(torch.bfloat16)
    w = torch.rand(D, device=card, generator=g) + 0.5
    burst = rms_norm(x, w)
    for i in (0, 7, 15):
        assert torch.equal(burst[i:i + 1], rms_norm(x[i:i + 1], w)), i
    flat = x.reshape(1024, D)
    rows = rms_norm(flat, w)
    for r in (0, 100, 1023):
        assert torch.equal(rows[r:r + 1], rms_norm(flat[r:r + 1], w)), r


# the gemma family: GELU in the fused FFN kernels, head_dim 256 in attn_in
# and the flash decode
@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 32])
def test_fused_ffn_kernels_with_gelu_match_plain(card, R):
    """gate_up, ffn and oproj_ffn with act_fn "gelu" at Gemma-2B's dim and a
    shorter F, against their plain versions (TOL); gate/up rows at R = 16
    and 32 equal the row alone, bit for bit."""
    rng = np.random.default_rng(70 + R)
    D, F = 2048, 4096
    wo, gu, dn = q6w(D, D, rng, card), q4(2 * F, D, rng, card), q6w(D, F, rng, card)
    x = (torch.randn(32, D, device=card) * 0.3).to(torch.bfloat16)
    attn = (torch.randn(R, D, device=card) * 0.1).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    act = t_ffn.gate_up(x[:R], nw, 1e-6, gu, "gelu")
    torch.cuda.synchronize()
    assert _rel(act, t_ffn.gate_up_plain(x[:R], nw, 1e-6, gu, "gelu")) < TOL
    assert _rel(act, t_ffn.gate_up_plain(x[:R], nw, 1e-6, gu, "silu")) > TOL
    got = t_ffn.fused_ffn(x[:R], nw, 1e-6, gu, dn, act_fn="gelu")
    assert _rel(got, t_ffn.ffn_plain(x[:R], nw, 1e-6, gu, dn, "gelu")) < TOL
    got = t_ffn.fused_oproj_ffn(x[:R], attn, wo, nw, 1e-6, gu, dn, act_fn="gelu")
    assert _rel(got, t_ffn.oproj_ffn_plain(x[:R], attn, wo, nw, 1e-6, gu, dn, "gelu")) < TOL
    if R == 32:
        _solo_rows_equal(lambda a: t_ffn.gate_up(a, nw, 1e-6, gu, "gelu"), (x,))


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,Hkv", [(2048, 8, 1), (3584, 16, 8)])
def test_attn_in_kernel_head_dim_256_matches_plain_and_the_row_alone(card, D, H, Hkv):
    """attn_in at head_dim 256 (Gemma-2B's and Gemma-2-9B's widths), R = 1,
    5, 16 against attn_in_plain (TOL); rows at R = 16 and 32 equal the row
    alone, bit for bit."""
    rng = np.random.default_rng(D)
    hd = 256
    wqk, wv = q4((H + Hkv) * hd, D, rng, card), q6w(Hkv * hd, D, rng, card)
    x = (torch.randn(32, D, device=card) * 0.5).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(32, hd // 2, device=card), torch.rand(32, hd // 2, device=card)
    for R in (1, 5, 16):
        got = t_attn_in.fused_attn_in(x[:R], nw, 1e-6, wqk, wv, cos[:R], sin[:R], hd)
        torch.cuda.synchronize()
        ref = t_attn_in.attn_in_plain(x[:R], nw, 1e-6, wqk, wv, cos[:R], sin[:R], hd)
        assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL, R
    _solo_rows_equal(lambda a, c, s_: t_attn_in.fused_attn_in(a, nw, 1e-6, wqk, wv, c, s_, hd),
                     (x, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attn_head_dim_256_matches_plain_and_the_row_alone(card, int8):
    """#7 at Gemma-2B's 8 / 1 heads of 256, positions at the tiles' and the
    splits' edges, against decode_attention_plain and its split blocking
    (per row, TOL); each row of the call equal to the row alone."""
    H, Hkv, D, S = 8, 1, 256, 2048
    g = torch.Generator(device=card).manual_seed(256 + int8)
    tps = t_decode.decode_plan(S, D, int8)[0]
    pos = [0, 1, 63, 64, 65, 64 * tps - 1, 64 * tps, 2047, 1000]
    B = len(pos)
    q = torch.randn(B, 1, H, D, device=card, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=card, generator=g,
                              dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(B, Hkv, S, device=card, generator=g) * 0.02 + 0.001
                       for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, D, device=card, generator=g).to(torch.bfloat16)
                for _ in range(2))
        scales = None
    qp = torch.tensor(pos, device=card)[:, None]
    got = t_decode.attention_decode_flash(q, k, v, qp, scales)
    torch.cuda.synchronize()
    assert _row_rel(got, t_decode.decode_attention_plain(q, k, v, qp, scales)) < TOL
    assert _row_rel(got, t_decode.decode_attention_split_plain(q, k, v, qp, scales)) < TOL
    for b in range(B):
        sc = None if scales is None else tuple(t[b:b + 1] for t in scales)
        alone = t_decode.attention_decode_flash(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                qp[b:b + 1], sc)
        assert torch.equal(got[b:b + 1], alone), b


@pytest.fixture
def w1024_engine(card, tmp_path):
    """A 2-layer model at dim 1024 (the fused kernels' gates pass): attn_in,
    oproj_ffn and the GEMV lm head at every row count <= 32."""
    cfg = tiny_config(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                      vocab_size=512, max_seq_len=2048)
    path = write_fixture_gguf(tmp_path / "w1024.gguf", cfg, seed=3, scale=0.05)
    cfg, params, _ = load_model(str(path), device=card)
    return lambda B, q=False, max_seq=128: InferenceEngine(
        cfg, params, max_batch=B, max_seq=max_seq, device=card, kv_quantized=q)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_verify_window_rows_equal_decode_steps(w1024_engine, B):
    """Row t of a speculative verify window (engine.step, T = 5, bf16 KV)
    equals the decode step at its position bit for bit, at B = 1 and at two
    rows of other lengths: greedy speculative output is plain greedy's."""
    from tpu_kquant_torch.tools.batch_invariance import window_checks

    prompts = [[3, 100, 7, 256, 42, 9, 300, 5, 11], [8, 9, 10, 11, 12, 13]][:B]
    rows = window_checks(w1024_engine(B), prompts, T=5, seed=B)
    assert all(r["equal"] for r in rows), rows


@pytest.mark.cuda
def test_verify_window_at_a_long_context(w1024_engine, monkeypatch):
    """Two rows 1500 and 1900 tokens deep in 2048 slots: a window of 8 equals
    the decode steps bit for bit and takes at most 1.5x a decode step's peak
    device memory (one f32 copy of the cache for its 8 queries, not one a
    query). With the budget lowered between a decode step's logits and the
    window's, the window runs the flash prefill kernel in every layer, as
    the reference's does, within 5e-2 of max|ref| of the decode steps."""
    eng = w1024_engine(2, max_seq=2048)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(10, 512, n).tolist() for n in (1500, 1900)]
    lens = np.array([1500, 1900])
    window = rng.integers(10, 512, (2, 8))

    def run(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def decode_rows():
        _, c, _ = eng.prefill(prompts, eng.new_cache(2))
        rows, peak = [], 0
        for t in range(8):
            (dl, c), m = run(lambda: eng.decode_step(eng._tensor(window[:, t]),
                                                     eng._tensor(lens + t), c))
            rows.append(dl)
            peak = max(peak, m)
        return torch.stack(rows, 1), peak

    def window_rows():
        _, c, _ = eng.prefill(prompts, eng.new_cache(2))
        before = {k: c.launches for k, c in _build.COUNTERS.items()}
        (wl, _), m = run(lambda: eng.step(window, lens[:, None] + np.arange(8), c))
        return wl, m, {k: c.launches - before[k] for k, c in _build.COUNTERS.items()}

    dec, dec_peak = decode_rows()
    win, win_peak, used = window_rows()
    assert torch.equal(win, dec) and used["prefill"] == 0
    assert win_peak <= 1.5 * dec_peak, (win_peak, dec_peak)
    # decode 2 * 16 * 2048 * 4 B = 0.26 MB of logits, the window 2.1 MB
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 1.0)
    win, _, used = window_rows()
    assert used["prefill"] == eng.cfg.n_layers
    assert (win - dec).abs().max() <= 5e-2 * dec.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_shift_cache_on_card_matches_cpu(card, int8):
    """shift_cache on the card against its CPU run on the same cache: bf16
    K within one bf16 ulp after rotation, int8 codes within 1 and scales
    within 1e-6 relative (f32 math in another order), V equal."""
    from tpu_kquant_torch.models.config import RopeParams
    from tpu_kquant_torch.runtime.kv_cache import KVCache, shift_cache

    g = torch.Generator().manual_seed(4)
    L, B, H, S, D = 2, 2, 4, 256, 64
    if int8:
        k, v = (torch.randint(-127, 128, (L, B, H, S, D), generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(L, B, H, S, generator=g) * 0.02 + 0.001 for _ in range(2))
        cpu = KVCache(k, v, ks, vs)
    else:
        cpu = KVCache(*(torch.randn(L, B, H, S, D, generator=g).to(torch.bfloat16)
                        for _ in range(2)))
    dev = KVCache(*(None if t is None else t.to(card) for t in (cpu.k, cpu.v, cpu.k_scale,
                                                                 cpu.v_scale)))
    rope = RopeParams(head_dim=D, n_rot=D, mode="neox")
    want, got = shift_cache(cpu, 4, 100, rope), shift_cache(dev, 4, 100, rope)
    gk, wk = got.k.cpu().float(), want.k.float()
    if int8:
        assert (gk - wk).abs().max() <= 1
        torch.testing.assert_close(got.k_scale.cpu(), want.k_scale, rtol=1e-6, atol=0)
        assert torch.equal(got.v_scale.cpu(), want.v_scale)
    else:
        assert ((gk - wk).abs() <= wk.abs() * 2.0 ** -7 + 1e-30).all()
    assert torch.equal(got.v.cpu(), want.v)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_session_round_trip_on_card(w1024_engine, tmp_path, int8):
    """A session saved after prefill and 8 tokens, loaded into a fresh
    engine: 12 more greedy tokens equal the uninterrupted run's."""
    eng = w1024_engine(1, int8)
    prompt = [[3, 100, 7, 256, 42, 9]]
    logits, cache, lens = eng.prefill(prompt, eng.new_cache(1))
    toks, cache = eng.decode_greedy(torch.argmax(logits, -1), eng._tensor(lens), cache, 8)
    eng.save_session(str(tmp_path / "s.npz"), cache, lens + 8)
    want, _ = eng.decode_greedy(toks[:, -1], eng._tensor(lens + 8), cache, 12)
    fresh = w1024_engine(1, int8)
    back, lens2 = fresh.load_session(str(tmp_path / "s.npz"))
    assert back.k.is_cuda and lens2.tolist() == [14]
    got, _ = fresh.decode_greedy(toks[:, -1], fresh._tensor(lens2), back, 12)
    assert torch.equal(got, want)


# -- the sliding-window family: phi3's wqkv at head_dim 96, the iSWA ring ---------

PHI3 = dict(D=3072, H=32, Hkv=32, hd=96, F=8192)  # Phi-3-mini-4k's widths


@pytest.mark.cuda
def test_attn_in_kernel_phi3_wqkv_slots_match_plain_and_the_row_alone(card):
    """attn_in on Phi-3-mini-4k's wqkv q4-sm [9216, 3072] as qkv_slots' two
    views (head_dim 96: a block's 64 first-half columns and their rope
    partners; both slots read at wqkv's row stride): R = 1, 5, 16, 32
    against attn_in_plain (TOL), one launch a call; the same bits as on
    contiguous copies of the slots; rows at R = 16 and 32 equal the row
    alone, bit for bit."""
    D, H, Hkv, hd = (PHI3[k] for k in ("D", "H", "Hkv", "hd"))
    rng = np.random.default_rng(96)
    wqkv = packed("q4", (H + 2 * Hkv) * hd, D, rng, card)
    wqk, wv = t_attn_in.qkv_slots(wqkv, (H + Hkv) * hd)
    copies = [QTensor(w.kind, w.layout, w.shape, {k: v.contiguous() for k, v in w.arrays.items()})
              for w in (wqk, wv)]
    x = (torch.randn(32, D, device=card) * 0.5).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(32, hd // 2, device=card), torch.rand(32, hd // 2, device=card)
    for R in (1, 5, 16, 32):
        assert t_attn_in.attn_in_supported(wqk, wv, R, D, hd)
        launches = t_attn_in.counter.launches
        got = t_attn_in.fused_attn_in(x[:R], nw, 1e-5, wqk, wv, cos[:R], sin[:R], hd)
        torch.cuda.synchronize()
        assert t_attn_in.counter.launches == launches + 1
        ref = t_attn_in.attn_in_plain(x[:R], nw, 1e-5, wqk, wv, cos[:R], sin[:R], hd)
        assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL, R
        again = t_attn_in.fused_attn_in(x[:R], nw, 1e-5, *copies, cos[:R], sin[:R], hd)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), R
    _solo_rows_equal(lambda a, c, s_: t_attn_in.fused_attn_in(a, nw, 1e-5, wqk, wv, c, s_, hd),
                     (x, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8])
def test_rot_kernel_phi3_next_wqkv_matches_plain(card, R):
    """#12 at Phi-3-mini-4k's widths: wo q6w [3072, 3072], w_gateup q4
    [16384, 3072], w_down q6w [3072, 8192], then the next layer's wqkv
    [9216, 3072] as qkv_slots' views at head_dim 96; against rot_plain
    (TOL), one launch a call."""
    from tpu_kquant_torch.ops import rot as t_rot

    D, H, Hkv, hd, F = (PHI3[k] for k in ("D", "H", "Hkv", "hd", "F"))
    rng = np.random.default_rng(12 + R)
    wo, gu, dn, wqkv = (packed(kind, N, K, rng, card) for kind, N, K in (
        ("q6w", D, H * hd), ("q4", 2 * F, D), ("q6w", D, F), ("q4", (H + 2 * Hkv) * hd, D)))
    slots = t_attn_in.qkv_slots(wqkv, (H + Hkv) * hd)
    g = torch.Generator(device=card).manual_seed(R)
    x, attn = ((torch.randn(R, D, device=card, generator=g) * 0.5).to(torch.bfloat16)
               for _ in range(2))
    nw, nw2 = (torch.rand(D, device=card, generator=g) + 0.5 for _ in range(2))
    cos, sin = (torch.rand(R, hd // 2, device=card, generator=g) for _ in range(2))
    assert t_rot.rot_supported(wo, gu, dn, list(slots), R, D, hd)
    launches = t_rot.counter.launches
    got = t_rot.fused_oproj_ffn_attn_in(x, attn, wo, nw, 1e-5, gu, dn, nw2, *slots, cos, sin, hd)
    torch.cuda.synchronize()
    assert t_rot.counter.launches == launches + 1
    ref = t_rot.rot_plain(x, attn, wo, nw, 1e-5, gu, dn, nw2, *slots, cos, sin, hd)
    assert max(_rel(a, b) for a, b in zip(got, ref)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kv_layout", ["unified", "iswa"])
def test_phi3_engine_on_card_matches_cpu(card, tmp_path, kv_layout, kv_quantized):
    """A 2-layer phi3 at dim 512 (4 + 4 heads of 96, a window of 24) on the
    card against the CPU, on the unified layout and on the iSWA ring (24 +
    16 = 40, rounded to 48 slots; a 60-token prompt prefills in 4 chunks of
    16 and wraps it): attn_in runs on wqkv's slots in both layers of every
    forward of at most 32 rows: 3 decode steps a prompt, the 8-token
    prompt's bucket of 16 and, on the ring, each 16-token chunk."""
    cfg = tiny_config(arch="phi3", n_layers=2, dim=512, n_heads=4, n_kv_heads=4, ffn_dim=256,
                      vocab_size=512, sliding_window=24)
    cfg = dataclasses.replace(cfg, head_dim=96, rope=dataclasses.replace(cfg.rope, head_dim=96,
                                                                         n_rot=96))
    path = write_fixture_gguf(tmp_path / "phi3.gguf", cfg, seed=3)
    used = _card_against_cpu(card, path, {}, "auto", [list(range(3, 11)), list(range(3, 63))],
                             kv_layout=kv_layout, kv_quantized=kv_quantized, iswa_chunk=16)
    assert used["attn_in"] == 2 * (2 * 3 + (1 + 4 if kv_layout == "iswa" else 1))


# -- the recurrent family (mamba): qmm at Mamba-2.8B's shapes, the engine ----------

MAMBA_SHAPES = [("q4", 10240, 2560, False), ("q4", 192, 5120, False), ("q8", 5120, 160, True),
                ("q4", 2560, 5120, False), ("q4", 50280, 2560, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 16, 33, 512])
@pytest.mark.parametrize("kind,N,K,f32", MAMBA_SHAPES,
                         ids=["ssm_in", "ssm_x", "ssm_dt", "ssm_out", "lm_head"])
def test_qmm_kernel_mamba_shapes_match_plain_and_the_row_alone(card, kind, N, K, f32, R):
    """qmm at Mamba-2.8B's Q4_K_M matmuls: ssm_dt q8 on f32 scales at K =
    160 (the GEMV's 5 chunks; the tile's half step at K % 64 = 32), ssm_x's
    ragged second column block (N = 192), the tied lm head's N = 50280;
    row 0 alone equals row 0 of the call, bit for bit."""
    rng = np.random.default_rng(N + R)
    w = packed(kind, N, K, rng, card, f32=f32)
    x = (torch.randn(R, K, device=card) * 0.5).to(torch.bfloat16)
    got = t_qmm.qmm(x, w, torch.float32)
    assert _rel(got, t_qmm.qmm_plain(x, w, torch.float32)) < TOL
    if R <= t_qmm.GEMV_MAX_ROWS:
        assert torch.equal(t_qmm.qmm(x[:1], w, torch.float32), got[:1])


@pytest.mark.cuda
def test_mamba_engine_on_card_matches_cpu(card, tmp_path):
    """A 2-layer mamba at dim 512 (ssm_dt q8 on f32 scales at K = 32) on
    the card against the CPU: a right-padded prefill of 7 and 40 tokens,
    then 4 decode steps fed the CPU's tokens (logits and final states
    within TOL of max|ref|); qmm launches 4 x 2 + 1 times a forward, no
    plain version runs; served greedy streams equal their solo runs."""
    from tpu_kquant_torch.models.fixtures import tiny_mamba_config

    path = write_fixture_gguf(tmp_path / "m.gguf", tiny_mamba_config(dim=512), seed=2, scale=0.2)
    prompts = [list(range(3, 10)), list(range(3, 43))]
    runs = {}
    for d in ("cpu", card):
        cfg, params, _ = load_model(path, device=d)
        eng = InferenceEngine(cfg, params, max_batch=2, max_seq=96, device=d)
        _build.COUNTERS["qmm"].reset()
        plain0 = _build.COUNTERS["qmm"].plain_calls
        logits, cache, lens = eng.prefill(prompts, eng.new_cache(2))
        seq = [logits.float().cpu()]
        toks = runs["cpu"]["toks"] if "cpu" in runs else []
        for i in range(4):
            if d == "cpu":
                toks.append(seq[-1].argmax(-1))
            logits, cache = eng.decode_step(toks[i].to(d), torch.tensor(lens, device=d) + i,
                                            cache)
            seq.append(logits.float().cpu())
        runs["cpu" if d == "cpu" else "card"] = {
            "seq": seq, "toks": toks, "conv": cache.conv.cpu(), "ssm": cache.ssm.cpu(),
            "launches": _build.COUNTERS["qmm"].launches,
            "plain": _build.COUNTERS["qmm"].plain_calls - plain0}
    c, g = runs["cpu"], runs["card"]
    assert g["launches"] == 5 * 9 and g["plain"] == 0
    assert max(_rel(a, b) for a, b in zip(g["seq"], c["seq"])) < TOL
    assert _rel(g["conv"], c["conv"]) < TOL and _rel(g["ssm"], c["ssm"]) < TOL
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts + [list(range(50, 70))]]
    cb = ContinuousBatcher(eng)
    for r in reqs:
        cb.submit(r)
    cb.run()
    for r in reqs:
        assert r.output == eng.generate([r.prompt], max_new_tokens=8)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2048, 2560, 3072, 4096])
def test_rms_norm_rows_over_many_binades_do_not_depend_on_the_batch(card, D):
    """rms_norm's staged sum of squares on rows whose squares span many
    binades (inexact f32 sums, so any reduction order that follows the row
    count shows): every row of 16 equals the row alone, bit for bit. With a
    second stage of D / 32 sums in one reduction, PyTorch took 64 lanes for
    one row and 32 for 16 at D = 2560, and Mamba-2.8B's served rows parted
    from their solo runs."""
    from tpu_kquant_torch.ops.norms import rms_norm

    g = torch.Generator(device=card).manual_seed(D)
    for _ in range(8):
        x = (torch.randn(16, D, device=card, generator=g)
             * torch.exp(2 * torch.randn(16, D, device=card, generator=g))).to(torch.bfloat16)
        w = torch.rand(D, device=card, generator=g) + 0.5
        rows = rms_norm(x, w)
        for r in range(16):
            assert torch.equal(rows[r:r + 1], rms_norm(x[r:r + 1], w)), r


@pytest.mark.cuda
@pytest.mark.parametrize("t", ["Q4_K", "Q6_K", "Q8_0"])
def test_quantize_kernels_give_the_numpy_bytes(card, t):
    """csrc/quantize.cu against its plain version and the port's NumPy copy,
    bit for bit: tests/test_native.py's edge cases, a Gaussian tensor at
    TinyLlama's ffn_down shape (the NumPy copy on its first 16 rows), and
    the codec's card route; the kernel runs only on the card."""
    from tpu_kquant_torch.gguf import GGMLType
    from tpu_kquant_torch.ops import quantize as t_quant
    from tpu_kquant_torch.quant import numpy_codecs

    t = GGMLType[t]
    rng = np.random.default_rng(1)
    cases = [np.zeros(512), np.full(512, 3.25), np.tile([1.0, -1.0], 256),
             np.concatenate([np.zeros(256), rng.standard_normal(256)]),
             rng.standard_normal(256 * 64) * 100.0, rng.standard_normal(256 * 64) * 0.01]
    for x in cases:
        x = x.astype(np.float32)
        xt = torch.from_numpy(x).to(card)
        got = t_quant.QUANTIZERS[t](xt)
        assert torch.equal(got, t_quant.PLAIN[t](xt))
        np.testing.assert_array_equal(got.cpu().numpy(), numpy_codecs.quantize(x, t))
        np.testing.assert_array_equal(numpy_codecs.quantize(xt, t), numpy_codecs.quantize(x, t))
    g = torch.Generator(device=card).manual_seed(0)
    w = torch.randn(2048, 5632, device=card, generator=g) * 0.05
    launches = t_quant.counters[t].launches
    got = t_quant.QUANTIZERS[t](w)
    assert t_quant.counters[t].launches == launches + 1
    assert torch.equal(got, t_quant.PLAIN[t](w))
    head = numpy_codecs.quantize(w[:16].cpu().numpy(), t)
    np.testing.assert_array_equal(got[:head.size].cpu().numpy(), head)


# -- the decode loop and the serving tick as CUDA graphs (runtime.graphs) ------------


def _graph_counts():
    from tpu_kquant_torch.runtime import graphs

    return graphs.STATS.captures, graphs.STATS.replays


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_decode_loops_as_graphs_equal_the_plain_loops(w1024_engine, kv_quantized):
    """decode_greedy and decode_sampled (temperature, top-k, top-p,
    penalties) replaying the captured step against the plain loop on the
    same prefilled caches: tokens, the last step's logits, keys and penalty
    state equal bit for bit; the first call captures once (its warm run is
    the first step) and replays the rest, a second call on the same cache
    replays every step; the launch counts are the plain loop's. The
    capture runs under set_sync_debug_mode("error") (StepGraph) and leaves
    the mode as it was."""
    from tpu_kquant_torch.ops.sampling import SamplerConfig, init_penalty_state, row_keys

    eng = w1024_engine(2, kv_quantized)
    prompts = [[3, 100, 7, 256, 42, 9, 300, 5, 11], [8, 9, 10, 11, 12, 13]]
    sc = SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1)
    lens = eng._tensor([len(p) for p in prompts])
    first = torch.tensor([5, 6], device=eng.device)
    runs = {}
    for plain in (True, False):
        cache = eng.prefill(prompts, eng.new_cache(2))[1]
        torch.cuda.synchronize()
        before, graphs0 = _build.launch_counts(), _graph_counts()
        greedy, _ = eng.decode_greedy(first, lens, cache, 12, plain=plain)
        greedy2, _ = eng.decode_greedy(greedy[:, -1], lens + 12, cache, 12, plain=plain)
        g_logits = eng.last_logits.clone()
        keys = row_keys(torch.arange(2) + 3, 0).to(eng.device)
        state = init_penalty_state(prompts, eng.cfg.vocab_size, 64, eng.device)
        sampled, _, keys, state = eng.decode_sampled(first, lens + 24, cache, 12, sc, keys,
                                                     state, plain=plain)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        runs[plain] = dict(toks=(greedy, greedy2, sampled), logits=(g_logits, eng.last_logits),
                           keys=keys, state=state, graphs=tuple(
                               a - b for a, b in zip(_graph_counts(), graphs0)),
                           launches={k: after[k] - before.get(k, 0) for k in after})
    p, g = runs[True], runs[False]
    assert all(torch.equal(a, b) for a, b in zip(p["toks"], g["toks"]))
    assert all(torch.equal(a, b) for a, b in zip(p["logits"], g["logits"]))
    assert torch.equal(p["keys"], g["keys"])
    assert all(torch.equal(a, b) for a, b in zip(p["state"], g["state"]))
    assert p["graphs"] == (0, 0) and g["graphs"] == (2, 11 + 12 + 11)
    assert p["launches"] == g["launches"] and p["launches"]["attn_in"] == 2 * 36
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_serving_tick_and_chunk_as_graphs_equal_the_plain_batcher(w1024_engine):
    """The batcher replaying its captured tick (per tick and in chunks)
    against the plain batcher: the same streams (greedy with an eos, and
    sampled) and finite logits; in chunks, the same stats, and attn_in's
    launches differ from the plain run's by 2 (layers) a tick the device
    ran more (ticks_run)."""
    specs = [dict(prompt=[3, 100, 7], max_new_tokens=20),
             dict(prompt=[9, 300], max_new_tokens=9, temperature=0.9, top_k=20, top_p=0.9,
                  repeat_penalty=1.2, seed=11),
             dict(prompt=[17, 5, 11, 2], max_new_tokens=13),
             dict(prompt=list(range(40, 70)), max_new_tokens=16, temperature=0.7, seed=4),
             dict(prompt=[250, 9], max_new_tokens=11)]
    eng = w1024_engine(4)
    eos = eng.generate([specs[0]["prompt"]], max_new_tokens=20)[0][6]
    specs[0]["eos_id"] = eos
    runs = []
    for plain, max_chunk in ((True, None), (False, None), (False, 1)):
        cb = ContinuousBatcher(eng, seed=2, plain=plain)
        for s in specs:
            cb.submit(Request(**s))
        torch.cuda.synchronize()
        before = _build.launch_counts()
        done = sorted(cb.run(max_chunk=max_chunk), key=lambda r: r.rid)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        runs.append(([r.output for r in done], dict(cb.stats),
                     {k: after[k] - before.get(k, 0) for k in after}, bool(cb.logits_finite)))
    (po, ps, pl, pf), (go, gs, gl, gf), (to, ts, tl, tf) = runs
    assert po == go == to and po[0][-1] == eos and pf and gf and tf
    # per tick, a finished row's slot is refilled a tick sooner than at the
    # end of its chunk: the same tokens in fewer ticks
    keys = ("prefills", "tokens_out", "tokens_in")
    assert [ps[k] for k in keys] == [gs[k] for k in keys] == [ts[k] for k in keys]
    assert ps["steps"] == gs["steps"] and ps["dispatches"] == gs["dispatches"]
    assert gl["attn_in"] - pl["attn_in"] == 2 * (gs["ticks_run"] - ps["ticks_run"])


@pytest.mark.cuda
def test_mamba_decode_loop_as_graph_equals_the_plain_loop(card, tmp_path):
    """A 2-layer mamba at dim 512: the graph loop against the plain loop on
    the same prefilled state, tokens, last logits and final state bit for
    bit; served greedy streams (replayed chunks) equal their solo runs."""
    from tpu_kquant_torch.models.fixtures import tiny_mamba_config

    path = write_fixture_gguf(tmp_path / "m.gguf", tiny_mamba_config(dim=512), seed=2, scale=0.2)
    cfg, params, _ = load_model(path, device=card)
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=96, device=card)
    prompts = [list(range(3, 10)), list(range(3, 43))]
    out = {}
    for plain in (True, False):
        logits, cache, lens = eng.prefill(prompts, eng.new_cache(2))
        toks, cache = eng.decode_greedy(torch.argmax(logits, -1), eng._tensor(lens), cache, 16,
                                        plain=plain)
        out[plain] = (toks, eng.last_logits.clone(), cache.conv.clone(), cache.ssm.clone())
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts + [list(range(50, 70))]]
    cb = ContinuousBatcher(eng)
    for r in reqs:
        cb.submit(r)
    cb.run()
    for r in reqs:
        assert r.output == eng.generate([r.prompt], max_new_tokens=12)[0]


# -- the int8 folds of the grid kernels #3, #5 and #6 (ops/dequant.py) ---------------


def _fold_check(got, plain_fold, plain_off):
    """The kernel's folded output against its plain folded form: within TOL
    of max|ref|, and its mean |error| below a quarter of the fold gap (the
    plain folded form against the plain unfolded one)."""
    got, ref, off = (t.float() for t in (got, plain_fold, plain_off))
    gap = (ref - off).abs().mean().item()
    err = (got - ref).abs().mean().item()
    assert gap > 0 and err < gap / 4, (err, gap)
    assert _rel(got, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("qkind,R", [("q4", 1), ("q4", 8), ("q4", 16), ("q4f", 16)])
def test_attn_in_folds_match_plain(card, qkind, R, monkeypatch):
    """#3 folded at Llama-3-8B's widths (wqk [5120, 4096] q4, wv [1024,
    4096] q6w-sp); a row of the call equals the row alone, bit for bit."""
    monkeypatch.setenv("TKQ_INT8_FOLDS", "1")
    monkeypatch.setenv("TKQ_MANUAL_ATTN_IN", "0")
    rng = np.random.default_rng(R)
    D, hd, H, Hkv = 4096, 128, 32, 8
    wqk, wv = WEIGHTS[qkind]((H + Hkv) * hd, D, rng, card), q6w(Hkv * hd, D, rng, card)
    x = torch.randn(R, D, device=card).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    cos, sin = torch.rand(R, hd // 2, device=card), torch.rand(R, hd // 2, device=card)
    folds = t_attn_in.fold_counter.launches
    got = t_attn_in.fused_attn_in(x, nw, 1e-5, wqk, wv, cos, sin, hd)
    torch.cuda.synchronize()
    assert t_attn_in.fold_counter.launches == folds + 1
    args = (x, nw, 1e-5, wqk, wv, cos, sin, hd)
    ref = t_attn_in.attn_in_plain(*args, fold=True)
    off = t_attn_in.attn_in_plain(*args, fold=False)
    _fold_check(got[0], ref[0], off[0])
    monkeypatch.setenv("TKQ_INT8_FOLDS", "0")  # the flat wv slot does not fold
    assert torch.equal(got[1], t_attn_in.fused_attn_in(*args)[1])
    monkeypatch.setenv("TKQ_INT8_FOLDS", "1")
    alone = t_attn_in.fused_attn_in(x[:1], nw, 1e-5, wqk, wv, cos[:1], sin[:1], hd)
    assert torch.equal(alone[0], got[0][:1]) and torch.equal(alone[1], got[1][:1])


@pytest.mark.cuda
@pytest.mark.parametrize("wo_kind,F,R", [("q6w", 5632, 1), ("q6w", 5632, 8), ("q6w", 14336, 8),
                                         ("q4", 14336, 1), ("q4", 14336, 8), ("q4f", 5632, 3)])
def test_oproj_ffn_folds_match_plain(card, wo_kind, F, R, monkeypatch):
    """#5 folded: gate/up always (q4), wo where it is q4 (the production
    layout asks for the grid with TKQ_MANUAL_OPROJ=0); TinyLlama's and
    Llama-3-8B's FFN widths; the row alone equals the row in the call."""
    monkeypatch.setenv("TKQ_INT8_FOLDS", "1")
    monkeypatch.setenv("TKQ_MANUAL_OPROJ", "0")
    rng = np.random.default_rng(R + F)
    D = 2048 if F == 5632 else 4096
    wo = WEIGHTS[wo_kind](D, D, rng, card)
    gu, dn = (q4f if wo_kind == "q4f" else q4)(2 * F, D, rng, card), q6w(D, F, rng, card)
    x = (torch.randn(R, D, device=card) * 0.5).to(torch.bfloat16)
    attn = (torch.randn(R, D, device=card) * 0.5).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    folds = t_ffn.fold_counter.launches
    got = t_ffn.fused_oproj_ffn(x, attn, wo, nw, 1e-5, gu, dn)
    torch.cuda.synchronize()
    assert t_ffn.fold_counter.launches == folds + 1
    fold_wo = wo.kind == "q4"
    ref = t_ffn.oproj_ffn_plain(x, attn, wo, nw, 1e-5, gu, dn, folds=(fold_wo, True),
                                round_first=True)
    off = t_ffn.oproj_ffn_plain(x, attn, wo, nw, 1e-5, gu, dn)
    _fold_check(got - x, ref - x, off - x)
    alone = t_ffn.fused_oproj_ffn(x[:1], attn[:1], wo, nw, 1e-5, gu, dn)
    assert torch.equal(alone, got[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("gkind,R", [("q4", 1), ("q4", 8), ("q4f", 8), ("q4", 32)])
def test_ffn_and_gate_up_folds_match_plain(card, gkind, R, monkeypatch):
    """#6 folded (Qwen2.5-1.5B's FFN widths) and the gate/up phase alone."""
    monkeypatch.setenv("TKQ_INT8_FOLDS", "1")
    rng = np.random.default_rng(R)
    D, F = 1536, 8960
    gu, dn = WEIGHTS[gkind](2 * F, D, rng, card), q6w(D, F, rng, card)
    x = (torch.randn(R, D, device=card) * 0.5).to(torch.bfloat16)
    nw = torch.rand(D, device=card) + 0.5
    folds = t_ffn.ffn_fold_counter.launches
    got = t_ffn.fused_ffn(x, nw, 1e-6, gu, dn)
    torch.cuda.synchronize()
    assert t_ffn.ffn_fold_counter.launches == folds + 1
    _fold_check(got - x, t_ffn.ffn_plain(x, nw, 1e-6, gu, dn, fold=True) - x,
                t_ffn.ffn_plain(x, nw, 1e-6, gu, dn) - x)
    assert torch.equal(t_ffn.fused_ffn(x[:1], nw, 1e-6, gu, dn), got[:1])
    act = t_ffn.gate_up(x, nw, 1e-6, gu, fold=True)
    _fold_check(act, t_ffn.gate_up_plain(x, nw, 1e-6, gu, fold=True),
                t_ffn.gate_up_plain(x, nw, 1e-6, gu))


@pytest.mark.cuda
def test_graph_captured_without_folds_does_not_replay_with_them(w1024_engine, monkeypatch):
    """TKQ_INT8_FOLDS keys the graph cache (runtime.graphs.SWITCHES): after
    the switch the loop captures anew, its replays launch the folded
    oproj_ffn (wo q6w: the grid at every row count), and its tokens equal
    the plain loop's under the same switch."""
    from tpu_kquant_torch.runtime import graphs

    eng = w1024_engine(1)
    cache = eng.new_cache(1)
    prompt = [3, 100, 7, 256, 42, 9]

    def refill():
        for t in graphs.cache_tensors(cache):
            t.zero_()
        logits, _, lens = eng.prefill([prompt], cache)
        return torch.argmax(logits, -1), eng._tensor(lens)

    monkeypatch.delenv("TKQ_INT8_FOLDS", raising=False)
    eng.decode_greedy(*refill(), cache, 4, plain=False)
    captures = graphs.STATS.captures
    eng.decode_greedy(*refill(), cache, 4, plain=False)
    assert graphs.STATS.captures == captures  # the same cache and switches: replays
    monkeypatch.setenv("TKQ_INT8_FOLDS", "1")
    out = {}
    for plain in (True, False):
        first, lens = refill()  # its 6-row prefill folds too (oproj_ffn at 6 rows)
        folds = t_ffn.fold_counter.launches
        out[plain] = eng.decode_greedy(first, lens, cache, 8, plain=plain)[0]
        torch.cuda.synchronize()
        assert t_ffn.fold_counter.launches - folds == 2 * 8
    assert graphs.STATS.captures == captures + 1
    assert torch.equal(out[True], out[False])
