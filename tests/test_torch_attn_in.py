"""attn_in's kernel (csrc/attn_in.cuh) and the plain decode attention's card
form (ops/attention.py:attention_plain) on the CPU.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py -m cuda). What
a CPU can hold it to is here: its K split (ops/attn_in.py:attn_in_plan, the
mirror of the kernel's own) never sees the row count, divides both slots'
chunks, fits a portable cluster and shared memory at 32 rows, and cuts the
columns into blocks of whole heads; and its arithmetic mirrored in numpy
(rms over the whole row, the normalised rows staged as bf16 hi + lo,
gemv.cuh's group dots rebuilt lane by lane per split, the splits' partials
added in rank order, then bf16, the bias and the rope in f32) gives
attn_in_plain, which the reference's fused_attn_in (interpret mode) holds
in turn.

The plain decode attention's card form takes its three products as bmm
calls of one shape per (row, KV head) pair, whatever the batch: here it is
held to the einsums it replaces and to the reference's attention_decode,
at 1 and 16 rows, bf16 and int8 KV, with and without the deferred append,
and a row of 16 to the row alone, bit for bit; and a decode step of a tiny
model with it forced on, to the JAX engine's.
"""

import functools
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops import attention as j_attention
from tpu_kquant.ops.pallas_attn_in import fused_attn_in as j_fused_attn_in
from tpu_kquant.ops.pallas_attn_in import rope_tables_full
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.models.fixtures import random_packed
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)


def _gemv_mirror():
    """tests/test_torch_gemv.py's lane-by-lane mirror of gemv.cuh
    (mirror_gemv), loaded by path."""
    path = Path(__file__).with_name("test_torch_gemv.py")
    spec = importlib.util.spec_from_file_location("_gemv_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.mirror_gemv


mirror_gemv = _gemv_mirror()

FUSED_CODES = [c for c, (k, _) in enumerate(t_qmm.KINDS) if k in ("q4", "q6w", "q8")]
# (n0, n1, D, head_dim) of the models the port runs attn_in at: TinyLlama,
# Qwen2.5-1.5B, Mixtral-8x7B, Llama-3-8B; narrow shapes of the CPU tests
WIDTHS = [(2304, 256, 2048, 64), (1792, 256, 1536, 128), (5120, 1024, 4096, 128),
          (6144, 1024, 4096, 128), (768, 256, 512, 64), (768, 256, 512, 128),
          (1536, 512, 1024, 128)]


def _chunks(code, D):
    return D // (32 * t_qmm.SEGMENTS[t_qmm.KINDS[code][0]])


@pytest.mark.parametrize("v_code", FUSED_CODES, ids=lambda c: "-".join(t_qmm.KINDS[c]))
@pytest.mark.parametrize("qk_code", FUSED_CODES, ids=lambda c: "-".join(t_qmm.KINDS[c]))
def test_attn_in_plan_is_row_free_divides_fits_and_keeps_heads_whole(qk_code, v_code):
    """For every pair of slot kinds at every width: the plan takes no row
    count (so the split is the same at R = 1..32), is at most a portable
    cluster of 8, divides both slots' chunks of D with at least one chunk
    for each of a block's four K warps, and fits shared memory at 32 rows
    (the rows staged as two bf16 halves); every 128-column block of either
    slot holds whole heads."""
    assert list(inspect.signature(t_attn_in.attn_in_plan).parameters) == \
        ["qk_code", "v_code", "n0", "n1", "D"]
    for n0, n1, D, hd in WIDTHS:
        s = t_attn_in.attn_in_plan(qk_code, v_code, n0, n1, D)
        assert 1 <= s <= t_attn_in.ATTN_IN_MAX_SPLITS == 8
        for code in (qk_code, v_code):
            nch = _chunks(code, D)
            assert nch % s == 0 and nch // s >= t_attn_in.ATTN_IN_WK, (code, D, s)
            for R in range(1, 33):
                assert t_qmm.gemv_smem_bytes(code, nch // s, R, halves=2) <= t_qmm._SMEM_CAP
        for n in (n0, n1):
            for j in range(0, n, t_attn_in.ATTN_IN_TN):
                assert min(t_attn_in.ATTN_IN_TN, n - j) % hd == 0


def test_attn_in_plan_takes_the_most_splits_of_one_wave_at_the_model_widths():
    """At TinyLlama, Qwen2.5-1.5B and Mixtral (Q4_K_M's q4 + q6w on either
    scale layout, Q8_0's q8 in both slots) the plan is the most splits the
    rules allow whose blocks stay inside one wave of two a SM: 8 at
    TinyLlama (160 blocks), 6 at Qwen (24 chunks of q4: 8 would leave K
    warps without one), 4 at Mixtral (48 column blocks)."""
    want = {2048: 8, 1536: 6, 4096: 4}
    for qk, v in ((0, 1), (2, 3), (4, 4), (5, 5)):
        for n0, n1, D, _ in WIDTHS[:3]:
            assert t_attn_in.attn_in_plan(qk, v, n0, n1, D) == want[D], (qk, v, D)


# -- the kernel's arithmetic, in numpy -------------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def mirror_attn_in(x, nw, eps, wqk, wv, cos, sin, hd, biases=None):
    """csrc/attn_in.cuh for x [R, D] (bf16 values): rstd from the whole
    row's sum of squares in f32; per slot and K split, the split's
    normalised rows x * rstd * nw in f32, staged as
    hi = bf16(v) and lo = bf16(v - hi); gemv.cuh's group dots of hi + lo on
    the split's chunks (mirror_gemv on the split's columns of x, zero
    elsewhere); the splits' f32 partials in rank order; bf16, + bias, the
    half rotation in f32 (qk), bf16."""
    R, D = x.shape
    qk_code, v_code = t_qmm.kernel_kind(wqk), t_qmm.kernel_kind(wv)
    splits = t_attn_in.attn_in_plan(qk_code, v_code, wqk.shape[0], wv.shape[0], D)
    outs = []
    for w, code, bias in ((wqk, qk_code, None if biases is None else biases[0]),
                          (wv, v_code, None if biases is None else biases[1])):
        nseg = t_qmm.SEGMENTS[t_qmm.KINDS[code][0]]
        S, cps = D // nseg, _chunks(code, D) // splits
        masks = []
        for q in range(splits):  # the split's elements: [q cps 32, +cps 32) of each segment
            m = np.zeros(D, bool)
            for seg in range(nseg):
                m[seg * S + q * cps * 32: seg * S + (q + 1) * cps * 32] = True
            masks.append(m)
        tot = np.sum(x.astype(np.float32) ** 2, axis=1, dtype=np.float32)
        rstd = (1.0 / np.sqrt(tot / np.float32(D) + np.float32(eps))).astype(np.float32)
        v = (x * rstd[:, None]).astype(np.float32) * nw[None, :]
        hi = _bf16(v)
        lo = _bf16(v - hi)
        acc = np.zeros((R, w.shape[0]), np.float32)
        for m in masks:
            xs = np.where(m[None, :], hi.astype(np.float64) + lo, 0.0)
            acc = (acc + mirror_gemv(w, xs).astype(np.float32)).astype(np.float32)
        y = _bf16(acc)
        if bias is not None:
            y = (y + bias.numpy()[None, :]).astype(np.float32)
        outs.append(y)
    y = outs[0].reshape(R, -1, hd)
    half = hd // 2
    c, s = cos[:, None, :], sin[:, None, :]
    y0, y1 = y[..., :half], y[..., half:]
    roped = np.concatenate([(y0 * c).astype(np.float32) - (y1 * s).astype(np.float32),
                            (y1 * c).astype(np.float32) + (y0 * s).astype(np.float32)], -1)
    return _bf16(roped.reshape(R, -1)), _bf16(outs[1])


def _jq(qt):
    return JQTensor(qt.kind, qt.layout, tuple(qt.shape),
                    {k: jnp.asarray(v.numpy()) for k, v in qt.arrays.items()})


# (qk kind, v kind, f32 scales, D, H, Hkv, head_dim, biases, R): TinyLlama's
# Q4_K_M slots at narrow width (heads of 64), Qwen2.5's biases at head_dim
# 128, Q8_0's q8 in both slots on pairs and on f32 scales, the f32 layouts
# of Mixtral's Q4_K_M load
MIRROR_CASES = {
    "tinyllama-q4-q6w-pairs": ("q4", "q6w", False, 512, 8, 4, 64, False, 3),
    "qwen-biases-hd128": ("q4", "q6w", False, 512, 4, 2, 128, True, 2),
    "q8-q8-pairs": ("q8", "q8", False, 512, 8, 4, 64, False, 16),
    "q8-q8-f32": ("q8", "q8", True, 512, 4, 2, 128, False, 1),
    "mixtral-q4-q6w-f32": ("q4", "q6w", True, 1024, 8, 4, 128, False, 2),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_kernel_mirror_matches_plain_and_plain_matches_reference(case):
    """The kernel's order mirrored in numpy against attn_in_plain: within a
    bf16 step of each output (1e-2 of max|ref|: the two round the same f32
    sums to bf16 at different points only where a sum sits on a rounding
    boundary); attn_in_plain against the reference's fused_attn_in
    (interpret mode) within 3e-2 of max|ref|, tests/test_pallas_attn_in.py's
    tolerance; the wrapper on CPU tensors is attn_in_plain."""
    kq, kv, f32, D, H, Hkv, hd, with_bias, R = MIRROR_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    wqk = random_packed(rng, kq, (H + Hkv) * hd, D, f32=f32).to("cpu")
    wv = random_packed(rng, kv, Hkv * hd, D, f32=f32).to("cpu")
    x = _bf16(rng.standard_normal((R, D)) * 0.5)
    nw = (rng.random(D) + 0.5).astype(np.float32)
    cos, sin = (rng.random((R, hd // 2)).astype(np.float32) for _ in range(2))
    biases = None
    if with_bias:
        biases = tuple(torch.from_numpy((rng.standard_normal(n) * 0.5).astype(np.float32))
                       for n in ((H + Hkv) * hd, Hkv * hd))
    t = torch.from_numpy
    xt = t(x).to(torch.bfloat16)
    assert t_attn_in.attn_in_supported(wqk, wv, R, D, hd, biases)
    p0, p1 = t_attn_in.attn_in_plain(xt, t(nw), 1e-5, wqk, wv, t(cos), t(sin), hd, biases)
    m0, m1 = mirror_attn_in(x, nw, 1e-5, wqk, wv, cos, sin, hd, biases)
    for got, ref in ((m0, p0), (m1, p1)):
        ref = ref.float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    cf, sf = rope_tables_full(jnp.asarray(cos), jnp.asarray(sin), H + Hkv, hd)
    jb = None if biases is None else [jnp.asarray(b.numpy()) for b in biases]
    o0, o1 = j_fused_attn_in(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw), 1e-5,
                             [_jq(wqk), _jq(wv)], cf, sf, hd // 2, biases=jb, interpret=True)
    for got, ref in ((p0, o0), (p1, o1)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())
    g0, g1 = t_attn_in.fused_attn_in(xt, t(nw), 1e-5, wqk, wv, t(cos), t(sin), hd, biases)
    assert torch.equal(g0, p0) and torch.equal(g1, p1)


# -- the plain decode attention's card form --------------------------------------------


def _attn_inputs(B, S, H, Hkv, D, int8, seed):
    r = np.random.default_rng(seed)
    q = _bf16(r.standard_normal((B, 1, H, D)))
    if int8:
        k, v = (r.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8) for _ in range(2))
        sc = tuple((r.random((B, Hkv, S)) * 0.02 + 0.001).astype(np.float32) for _ in range(2))
    else:
        k, v = (_bf16(r.standard_normal((B, Hkv, S, D))) for _ in range(2))
        sc = None
    pos = r.integers(1, S, (B, 1)).astype(np.int64)
    pos[0, 0] = S - 1
    cur = tuple(_bf16(r.standard_normal((B, 1, Hkv, D))) for _ in range(2))
    return q, k, v, pos, sc, cur


def _torch_args(q, k, v, pos, sc, cur, defer):
    t = torch.from_numpy
    kv = (lambda a: t(a)) if k.dtype == np.int8 else (lambda a: t(a).to(torch.bfloat16))
    return (t(q).to(torch.bfloat16), kv(k), kv(v), t(pos),
            None if sc is None else tuple(t(s) for s in sc),
            tuple(t(c).to(torch.bfloat16) for c in cur) if defer else None)


@pytest.mark.parametrize("defer", [False, True], ids=["append", "deferred"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 16])
def test_plain_card_form_matches_einsums_and_reference(B, int8, defer):
    """attention_plain with the fixed-shape bmm calls (its CUDA form, forced
    here) against its einsum form, the branch it replaces (f32 outputs
    before the cast within 1e-5 of max|ref|: only the order of f32 sums
    differs), and against the reference's attention_decode (impl "xla") on
    the same inputs, within 2e-2 of max|ref| (3e-2 on int8 KV); 128 slots,
    TinyLlama's 32 / 4 heads of 64."""
    S, H, Hkv, D = 128, 32, 4, 64
    q, k, v, pos, sc, cur = _attn_inputs(B, S, H, Hkv, D, int8, seed=B + 2 * int8 + 4 * defer)
    args = _torch_args(q, k, v, pos, sc, cur, defer)
    fixed = t_attention.attention_plain(*args, fixed=True)
    plain = t_attention.attention_plain(*args, fixed=False)
    assert fixed.dtype == torch.bfloat16 and fixed.shape == (B, 1, H, D)
    pf, pe = {}, {}
    t_attention.attention_plain(*args, fixed=True, parts=pf)
    t_attention.attention_plain(*args, fixed=False, parts=pe)
    for key in ("logits", "p", "pv"):
        a, b = pf[key], pe[key]
        fin = b.isfinite()
        assert torch.equal(fin, a.isfinite())
        assert (a[fin] - b[fin]).abs().max() <= 1e-5 * b[fin].abs().max(), key
    assert (fixed.float() - plain.float()).abs().max() <= 1e-2 * plain.float().abs().max()
    j = jnp.asarray
    want = np.asarray(j_attention.attention_decode(
        j(q, jnp.bfloat16), j(k) if int8 else j(k, jnp.bfloat16),
        j(v) if int8 else j(v, jnp.bfloat16), j(pos.astype(np.int32)),
        None if sc is None else tuple(j(s) for s in sc), impl="xla",
        kv_cur=tuple(j(c, jnp.bfloat16) for c in cur) if defer else None), np.float32)
    tol = 3e-2 if int8 else 2e-2
    np.testing.assert_allclose(fixed.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("defer", [False, True], ids=["append", "deferred"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_card_form_rows_do_not_depend_on_the_batch(int8, defer):
    """Each row of a 16-row call equals the row computed alone, bit for bit,
    in the card form: every bmm call has the same shape (plain_pairs of a
    pair's shapes, padded or overlapped), so each (row, KV head) pair's
    sums are taken in one order. Also at 40 rows (160 pairs: several calls,
    the last overlapping) and at a pair count that pads."""
    S, H, Hkv, D = 128, 32, 4, 64
    q, k, v, pos, sc, cur = _attn_inputs(40, S, H, Hkv, D, int8, seed=7 + int8 + 2 * defer)
    args = _torch_args(q, k, v, pos, sc, cur, defer)

    def rows(lo, hi):
        a = [None if x is None else (tuple(t[lo:hi] for t in x) if isinstance(x, tuple)
                                     else x[lo:hi]) for x in args]
        return t_attention.attention_plain(*a, fixed=True)

    old = t_attention.PLAIN_CALL_FLOATS
    try:
        t_attention.PLAIN_CALL_FLOATS = 48 * S * D  # 48 pairs a call: 160 pairs overlap
        assert t_attention.plain_pairs(1, H // Hkv, S, D) == 48
        full, sixteen = rows(0, 40), rows(0, 16)
        for b in range(40):
            alone = rows(b, b + 1)
            assert torch.equal(full[b:b + 1], alone), b
            if b < 16:
                assert torch.equal(sixteen[b:b + 1], alone), b
    finally:
        t_attention.PLAIN_CALL_FLOATS = old


def test_bmm_fixed_pads_and_overlaps():
    """bmm_fixed on pairs_f32's operands equals torch.bmm at pair counts
    below, at and past the call size, every call of exactly ``pairs``
    entries (padded below it, the last call overlapping past it)."""
    rng = np.random.default_rng(3)
    seen = []
    real = torch.bmm

    def spy(a, b, **kw):
        seen.append(a.shape[0])
        return real(a, b, **kw)

    for N in (3, 8, 13, 16):
        a = torch.from_numpy(rng.standard_normal((N, 5, 7)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((N, 6, 7)).astype(np.float32))
        ap, bp = t_attention.pairs_f32(a, 8), t_attention.pairs_f32(b.to(torch.bfloat16), 8)
        assert ap.shape[0] == bp.shape[0] == max(N, 8) and bp.dtype == torch.float32
        seen.clear()
        torch.bmm = spy
        try:
            got = t_attention.bmm_fixed(ap, bp.transpose(1, 2), 8, N)
        finally:
            torch.bmm = real
        assert set(seen) == {8} and len(seen) == -(-N // 8)
        want = real(a, b.to(torch.bfloat16).float().transpose(1, 2))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def head64(tmp_path_factory):
    """A tiny llama with head_dim 64 (dim 256, 4 + 2 heads), both packages."""
    path = tmp_path_factory.mktemp("ai") / "hd64.gguf"
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=256,
                      vocab_size=512, max_seq_len=128)
    write_fixture_gguf(path, cfg, seed=9, quant="q4_k_m", scale=0.05)
    return jload(str(path), scale_dtype="bf16"), load_model(str(path), scale_dtype="bf16",
                                                            device="cpu")


@pytest.mark.parametrize("B", [1, 16])
def test_decode_with_the_card_form_matches_jax_engine(head64, monkeypatch, B):
    """The port's decode steps (deferred append, plain branch) with the card
    form of the plain attention forced on, against the JAX engine (impl
    "xla") at 1 and 16 rows of 128 slots: logits within 5e-2 of max|ref|
    and greedy tokens equal over three steps."""
    (jc, jp, _), (tc, tp, _) = head64
    monkeypatch.setattr(t_attention, "attention_plain",
                        functools.partial(t_attention.attention_plain, fixed=True))
    je = JEngine(jc, jp, max_batch=B, max_seq=128, impl="xla")
    te = InferenceEngine(tc, tp, max_batch=B, max_seq=128, device="cpu")
    rng = np.random.default_rng(B)
    prompts = [rng.integers(3, 512, int(n)).tolist() for n in rng.integers(3, 12, B)]
    lj, jcache, lens = je.prefill(prompts, je.new_cache(B))
    lt, tcache, _ = te.prefill(prompts, te.new_cache(B))
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)
    pos = np.asarray(lens)
    for step in range(3):
        lj, jcache = je.decode_step(tok_j, jnp.asarray(pos, jnp.int32), jcache)
        lt, tcache = te.decode_step(tok_t, torch.from_numpy(pos), tcache)
        want, got = np.asarray(lj, np.float32), lt.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = torch.argmax(lt, -1)
        assert tok_t.tolist() == np.asarray(tok_j).tolist(), step
        pos = pos + 1
