"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those plain versions against the Pallas kernels in interpret mode (and the
XLA path) on the same packed bytes. The CUDA kernels themselves run only on
a card: tests/test_torch_cuda.py holds them against the plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tools_kernel_bench import mk_q4, mk_q6w
from tpu_kquant.gguf.constants import GGMLType
from tpu_kquant.ops.pallas_qmm import qmm_pallas
from tpu_kquant.ops.qmatmul import qmatmul
from tpu_kquant.quant import quantize
from tpu_kquant.quant import repack as jrepack
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.quant.qtensor import QTensor

torch.set_num_threads(1)


def _port(qt) -> QTensor:
    return QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.array(v) for k, v in qt.arrays.items()}).to("cpu")


def _packed(kind, N, K, seed):
    """q4-sm or q6w-sp weights quantized from random floats (loader layout)."""
    rng = np.random.default_rng(seed)
    qtype = GGMLType.Q4_K if kind == "q4" else GGMLType.Q6_K
    raw = quantize(rng.standard_normal((N, K)).astype(np.float32) * 0.1, qtype)
    qt = jrepack.widen_q6(jrepack.repack(raw, qtype, (N, K)))
    qt = jrepack.pack_scale_kpairs(jrepack.pack_scale_pairs(
        JQTensor(qt.kind, qt.layout, qt.shape, {k: np.asarray(v) for k, v in qt.arrays.items()})))
    return JQTensor(qt.kind, qt.layout, qt.shape, {k: jnp.asarray(v) for k, v in qt.arrays.items()})


# shapes of tests/test_pallas_qmm.py: (N, K, rows)
QMM_SHAPES = [(256, 512, 4), (128, 2048, 8)]


@pytest.mark.parametrize("kind", ["q4", "q6w"])
@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_qmm_plain_matches_pallas_f32(kind, shape):
    """f32 activations: both sides decode the same bf16 pairs; the Pallas
    kernel rounds its q6w operands to bf16 for the MXU (2^-9 relative per
    product), so that case is held at the reference's own 2e-2."""
    N, K, B = shape
    qt = _packed(kind, N, K, seed=N + K)
    x = np.random.default_rng(1).standard_normal((B, K)).astype(np.float32)
    got = t_qmm.qmm_plain(torch.from_numpy(x), _port(qt)).numpy()
    xla = np.asarray(qmatmul(jnp.asarray(x), qt, impl="xla"))
    pallas = np.asarray(qmm_pallas(jnp.asarray(x), qt, interpret=True))
    scale = np.abs(xla).max()
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-4 * scale)
    tol = 1e-4 if kind == "q4" else 2e-2
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("kind", ["q4", "q6w"])
@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_qmm_plain_matches_pallas_bf16(kind, shape):
    N, K, B = shape
    qt = _packed(kind, N, K, seed=N + K + 1)
    x = np.random.default_rng(2).standard_normal((B, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = t_qmm.qmm_plain(xt, _port(qt), torch.float32).numpy()
    for ref in (qmatmul(xj, qt, impl="xla", out_dtype=jnp.float32),
                qmm_pallas(xj, qt, out_dtype=jnp.float32, interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_qmm_wrapper_runs_plain_version_on_cpu():
    qt = _packed("q4", 256, 512, seed=3)
    x = torch.randn(3, 512).to(torch.bfloat16)
    c = t_qmm.counter
    launches, plain = c.launches, c.plain_calls
    y = t_qmm.qmm(x, _port(qt))
    assert c.plain_calls == plain + 1 and c.launches == launches
    assert y.dtype == torch.bfloat16 and y.shape == (3, 256)
    torch.testing.assert_close(y, t_qmm.qmm_plain(x, _port(qt)), rtol=0, atol=0)


def test_wrappers_raise_off_the_cpu_without_a_card():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    the kernel or raises (here: a meta tensor, which no kernel takes)."""
    qt = _port(_packed("q4", 256, 512, seed=4))
    with pytest.raises(ValueError, match="device"):
        t_qmm.qmm(torch.empty(2, 512, dtype=torch.bfloat16, device="meta"), qt)
    with pytest.raises(NotImplementedError):  # a layout no kernel reads
        t_qmm.qmm(torch.empty(2, 512, device="meta"),
                  QTensor("q8", "rowmajor", (256, 512), {"qs": None, "scales": None}))


@pytest.mark.parametrize("kind,N,K,rows", [(0, 32000, 2048, 1), (0, 2304, 2048, 3),
                                           (1, 256, 2048, 8), (1, 2048, 5632, 1),
                                           (0, 2048, 2048, 32), (1, 96, 64, 5)])
def test_gemv_split_covers_k(kind, N, K, rows):
    """The GEMV's K split (no row count among its inputs) covers K's chunks
    and fits shared memory at these rows and at 32, the most it takes."""
    cps, splits = t_qmm.gemv_plan(kind, N, K)
    n_chunks = (K // 2 if kind == 0 else K) // 32
    assert cps * splits >= n_chunks > cps * (splits - 1)
    smem = t_qmm.gemv_smem_bytes
    assert smem(kind, cps, rows) <= smem(kind, cps, 32) <= 200 * 1024


_GATE_UP_CODES = (0, 2, 1, 3, 4, 5)  # q4-sm, q4-f32, q6w-sp, q6w-f32, q8-sp, q8-f32


@pytest.mark.parametrize("code", _GATE_UP_CODES)
def test_gate_up_plan_does_not_depend_on_the_rows(code):
    """The gate/up phase's K split (ops/ffn.py:gate_up_plan) takes the kind,
    F and dim, never a row count: gemv_plan over the fused [2F, dim] with
    the normalised rows staged as two bf16 halves and no split cost. It
    covers dim's chunks and fits shared memory at 32 rows, the most the
    phase takes; at TinyLlama's and Qwen2.5-1.5B's widths it takes the
    split that tools/gemv_sweep.py --gate-up measured fastest on the H100
    (6 and 3 splits: the blocks fill one wave of two a SM)."""
    import inspect

    assert list(inspect.signature(t_ffn.gate_up_plan).parameters) == ["code", "F", "dim"]
    seg = 2 if t_qmm.KINDS[code][0] == "q4" else 1
    for F, dim in ((5632, 2048), (8960, 1536), (18944, 3584), (14336, 4096), (1024, 512)):
        cps, splits = t_ffn.gate_up_plan(code, F, dim)
        assert (cps, splits) == t_qmm.gemv_plan(code, 2 * F, dim, halves=2, split_cost=0.0)
        n_chunks = dim // (32 * seg)
        assert cps * splits >= n_chunks > cps * (splits - 1)
        assert t_qmm.gemv_smem_bytes(code, cps, 32, halves=2) <= 200 * 1024
    assert t_ffn.gate_up_plan(code, 5632, 2048)[1] == 6
    assert t_ffn.gate_up_plan(code, 8960, 1536)[1] == 3


def test_gate_up_wrapper_runs_plain_on_cpu_and_feeds_the_ffn_plain():
    """ops/ffn.py:gate_up on CPU tensors is gate_up_plain (counted as a
    plain call), whose activation is the one ffn_plain's down step meets."""
    rng = np.random.default_rng(6)
    D, F = 512, 1024
    gu, dn = _port(mk_q4(2 * F, D, rng)), _port(mk_q6w(D, F, rng))
    x = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32) * 0.3).to(torch.bfloat16)
    nw = torch.from_numpy((rng.random(D) + 0.5).astype(np.float32))
    c = _build.COUNTERS["gate_up"]
    before = (c.plain_calls, c.launches)
    act = t_ffn.gate_up(x, nw, 1e-5, gu)
    assert (c.plain_calls, c.launches) == (before[0] + 1, before[1])
    assert act.dtype == torch.bfloat16 and act.shape == (3, F)
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    want = (x.float() + act.float() @ dequant_kmajor(dn)).to(torch.bfloat16)
    assert torch.equal(t_ffn.ffn_plain(x, nw, 1e-5, gu, dn), want)


@pytest.mark.parametrize("kind", ["q4", "q6w", "q8"])
def test_gate_up_hi_lo_group_dots_keep_f32_activations(kind):
    """csrc/gate_up.cuh's arithmetic for one column, in numpy f32: the
    normalised row staged as hi = bf16(v) and lo = bf16(v - hi); each scale
    group's dot taken by mma on codes + OFF (exact in bf16) against hi and
    then lo, started at -OFF * sum(hi + lo); then acc += s * d - m * sum.
    Against the f64 dot of the dequantized column with the f32 row it is
    within 2e-5 of max|ref| (f32 order and the offset's cancellation), where
    staging v in bf16 alone costs ten times that or more."""
    rng = np.random.default_rng(len(kind))
    K, cols = 2048, 64
    G, OFF = {"q4": (32, 128.0), "q6w": (16, 160.0), "q8": (32, 2304.0)}[kind]
    lo_q, hi_q = {"q4": (0, 16), "q6w": (-32, 32), "q8": (-128, 128)}[kind]
    q = rng.integers(lo_q, hi_q, (K, cols)).astype(np.float32)
    s = (rng.random((K // G, cols)) * 0.01).astype(np.float32)
    m = (rng.random((K // G, cols)) * 0.05).astype(np.float32) if kind == "q4" else \
        np.zeros((K // G, cols), np.float32)
    v = (rng.standard_normal(K) * 1.7).astype(np.float32)
    hi = _bf16(v)
    lo = _bf16(v - hi)
    ref = (np.repeat(s.astype(np.float64), G, 0) * q - np.repeat(m.astype(np.float64), G, 0)
           ).T @ v.astype(np.float64)

    def column_dots(halves):
        acc = np.zeros(cols, np.float32)
        for gi in range(K // G):
            k = slice(gi * G, gi * G + G)
            xs = np.float32(0)
            for part in halves:
                for val in part[k]:
                    xs = np.float32(xs + val)
            d = np.full(cols, np.float32(-OFF) * xs, np.float32)
            for part in halves:
                # the mma's products are exact (bf16 x bf16); its sums f32
                d = (d + ((q[k] + np.float32(OFF)) * part[k][:, None]).sum(0, dtype=np.float32)
                     ).astype(np.float32)
            acc = (acc + s[gi] * d).astype(np.float32) - m[gi] * xs
        return acc.astype(np.float64)

    err_hl = np.abs(column_dots((hi, lo)) - ref).max() / np.abs(ref).max()
    err_hi = np.abs(column_dots((hi,)) - ref).max() / np.abs(ref).max()
    assert err_hl < 2e-5 and err_hl * 10 < err_hi, (err_hl, err_hi)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _rope_inputs(rng, R, hd):
    cos = rng.random((R, hd // 2)).astype(np.float32)
    sin = rng.random((R, hd // 2)).astype(np.float32)
    return cos, sin


@pytest.mark.parametrize("tk", [128, 256])
def test_attn_in_plain_matches_manual_kernel(tk):
    """Shapes of tests/test_manual_kernels.py (D=512); tolerance 3e-2 of
    max|ref|, that test's own: interpret mode runs f32 dots where the TPU's
    MXU rounds to bf16."""
    from tpu_kquant.ops.pallas_attn_in import _attn_in_manual_call, rope_tables_full

    rng = np.random.default_rng(1)
    D, hd, H, Hkv = 512, 64, 4, 2
    wqk = mk_q4((H + Hkv) * hd, D, rng)
    wv = mk_q6w(Hkv * hd, D, rng)
    x = (rng.standard_normal((1, D)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = _rope_inputs(rng, 1, hd)
    cf, sf = rope_tables_full(jnp.asarray(cos)[None], jnp.asarray(sin)[None], H + Hkv, hd)
    o0, o1 = _attn_in_manual_call(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), wqk.arrays["qs"], wqk.arrays["sm"],
        wv.arrays["qs"], wv.arrays["sp"], cf, sf, (H + Hkv) * hd, Hkv * hd, D, hd // 2,
        1e-5, 0.0, "bfloat16", True, tk)
    c = t_attn_in.counter
    plain = c.plain_calls
    g0, g1 = t_attn_in.fused_attn_in(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(nw), 1e-5, _port(wqk),
        _port(wv), torch.from_numpy(cos), torch.from_numpy(sin), hd)
    assert c.plain_calls == plain + 1
    for got, ref in ((g0, o0), (g1, o1)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_attn_in_gate_matches_reference():
    from tpu_kquant.ops.pallas_attn_in import attn_in_supported

    rng = np.random.default_rng(0)
    for D, n0, n1, rows in ((512, 384, 128, 1), (1024, 1280, 256, 32), (1024, 1280, 256, 33),
                            (64, 96, 32, 1), (1536, 1280, 256, 8)):
        ws = [mk_q4(n0, D, rng), mk_q6w(n1, D, rng)]
        assert t_attn_in.attn_in_supported(_port(ws[0]), _port(ws[1]), rows, D, 64) == \
            attn_in_supported(ws, rows, D), (D, rows)


@pytest.mark.parametrize("tko_tf", [(128, 256), (256, 512)])
def test_oproj_ffn_plain_matches_manual_kernel(tko_tf):
    """Shapes of tests/test_manual_kernels.py; tolerance 3e-2 as there."""
    from tpu_kquant.ops.pallas_ffn import _oproj_ffn_manual_call

    tko, tf = tko_tf
    rng = np.random.default_rng(2)
    D, K, F = 512, 512, 1024
    wo, gu, dn = mk_q4(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    x = (rng.standard_normal((1, D)) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((1, K)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    ref = np.asarray(_oproj_ffn_manual_call(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16), jnp.asarray(nw),
        wo.arrays["qs"], wo.arrays["sm"], gu.arrays["qs"], gu.arrays["sm"], dn.arrays["qs"],
        dn.arrays["sp"], D, K, F, 1e-5, "silu", "bfloat16", True, tko, tf), np.float32)
    got = t_ffn.fused_oproj_ffn(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(attn).to(torch.bfloat16), _port(wo),
                                torch.from_numpy(nw), 1e-5, _port(gu), _port(dn))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_oproj_ffn_plain_with_q6w_oproj_matches_grid_kernel():
    """The fixture recipe stores attn_output as Q6_K, so o_proj is q6w-sp on
    the main path; the reference runs its Mosaic-grid kernel there."""
    from tpu_kquant.ops.pallas_ffn import fused_oproj_ffn

    rng = np.random.default_rng(3)
    D, K, F = 512, 1024, 1024
    wo, gu, dn = mk_q6w(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)
    x = (rng.standard_normal((2, D)) * 0.1).astype(np.float32)
    attn = (rng.standard_normal((2, K)) * 0.1).astype(np.float32)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    ref = np.asarray(fused_oproj_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(attn, jnp.bfloat16),
                                     wo, jnp.asarray(nw), 1e-5, gu, dn, interpret=True),
                     np.float32)
    args = (_port(wo), torch.from_numpy(nw), 1e-5, _port(gu), _port(dn))
    assert t_ffn.oproj_ffn_supported(args[0], args[3], args[4], 2)
    got = t_ffn.fused_oproj_ffn(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(attn).to(torch.bfloat16), *args)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_oproj_ffn_gate_matches_reference():
    from tpu_kquant.ops.pallas_ffn import oproj_ffn_supported

    rng = np.random.default_rng(0)
    for D, K, F, rows in ((512, 1024, 1024, 1), (1024, 1024, 1024, 32), (512, 512, 1024, 1),
                          (512, 1024, 1024, 33), (512, 1024, 640, 4)):
        ws = [mk_q6w(D, K, rng), mk_q4(2 * F, D, rng), mk_q6w(D, F, rng)]
        assert t_ffn.oproj_ffn_supported(*[_port(w) for w in ws], rows) == \
            oproj_ffn_supported(*ws, rows), (D, K, F, rows)


def test_kernel_sources_are_registered():
    # every kernel module registers its counter on import; import them here so
    # the check does not depend on what other test files imported first
    from tpu_kquant_torch.ops import decode_attention, prefill, qmm_int8  # noqa: F401

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert set(_build.COUNTERS) >= {"qmm", "attn_in", "oproj_ffn", "ffn", "prefill"}


@pytest.mark.parametrize("n", [1, 31, 32, 33, 80, 1024, 2560, 4097])
def test_staged_sum_spans_at_most_32_and_sums(n, monkeypatch):
    """ops/norms.py:staged_sum, the card's sum of squares: every reduction it
    makes spans at most 32 elements (so PyTorch's lanes never follow the
    row count), and it is the sum within f32 rounding."""
    from tpu_kquant_torch.ops import norms

    spans = []
    real = torch.Tensor.sum

    def spy(self, *a, **k):
        spans.append(self.shape[-1])
        return real(self, *a, **k)

    v = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)).astype(np.float32))
    monkeypatch.setattr(torch.Tensor, "sum", spy)
    got = norms.staged_sum(v)
    monkeypatch.undo()
    assert got.shape == (3, 1) and max(spans) <= norms.SPAN
    np.testing.assert_allclose(got.numpy()[:, 0], v.double().sum(-1).numpy(), rtol=1e-5,
                               atol=1e-5)
