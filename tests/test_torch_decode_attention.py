"""Kernel #7, flash decode attention: the port's plain version
(``decode_attention_plain``, what ``csrc/decode_attn.cu`` computes) against
the JAX package's Pallas kernel in interpret mode, and the decode dispatch
past the logits budget against the JAX engine, on the CPU.

The Pallas cases are tests/test_pallas_attention.py's (positions in and
across tiles, a ragged batch, int8 KV, a mostly dead cache, a single tile)
plus head_dim 128; the tolerances are theirs (2e-2, int8 3e-2).

The kernel's host side and blocking, which the card alone runs: its split
plan (``decode_plan``) takes no batch size; the plain version taken in the
kernel's blocks (``decode_attention_split_plain``: splits of tiles, four
16-slot lanes a tile, rescaled to their common max) equals the one-pass
version within one bf16 rounding of p (2^-8 of max|ref|: each block rounds
p against its own max);
and the kernel's fragment maps (which query row, slot and head dim each
lane's mma.sync registers hold, bf16 and int8, and where each accumulator
lands) rebuilt lane by lane in numpy give q K^T and P V.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.ops import attention as j_attention
from tpu_kquant.ops.pallas_attention import attention_decode_pallas
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attention as t_attention
from tpu_kquant_torch.ops import decode_attention as t_decode
from tpu_kquant_torch.ops.decode_attention import attention_decode_flash, decode_attention_plain
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

# (B, S, H, Hkv, D, positions, int8 KV, the Pallas tile)
CASES = {
    "pos 5": (1, 256, 8, 2, 64, [5], False, 128),
    "pos 127": (1, 256, 8, 2, 64, [127], False, 128),
    "pos 200": (1, 256, 8, 2, 64, [200], False, 128),
    "ragged batch": (3, 256, 4, 4, 64, [3, 100, 255], False, 64),
    "int8": (2, 128, 8, 2, 64, [60, 127], True, 64),
    "mostly dead int8": (2, 1024, 8, 2, 64, [7, 130], True, 64),
    "single tile": (1, 64, 4, 1, 64, [63], False, 64),
    "head_dim 128, GQA 6": (2, 512, 12, 2, 128, [37, 450], False, 128),
    "head_dim 128 int8, GQA 4": (2, 512, 16, 4, 128, [300, 511], True, 256),
}


def _inputs(B, S, H, Hkv, D, pos, int8, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    if int8:
        k = r.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        v = r.integers(-127, 127, (B, Hkv, S, D)).astype(np.int8)
        scales = tuple((r.random((B, Hkv, S)) * 0.01 + 0.001).astype(np.float32)
                       for _ in range(2))
    else:
        k = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
        v = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
        scales = None
    return q, k, v, np.asarray(pos, np.int32).reshape(B, 1), scales


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    B, S, H, Hkv, D, pos, int8, ts = CASES[case]
    q, k, v, qp, sc = _inputs(B, S, H, Hkv, D, pos, int8, seed=sum(pos))
    want = np.asarray(attention_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        None if sc is None else tuple(jnp.asarray(s) for s in sc), ts=ts, interpret=True))
    t = torch.from_numpy
    got = decode_attention_plain(t(q), t(k), t(v), t(qp),
                                 None if sc is None else tuple(t(s) for s in sc))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    tol = 3e-2 if int8 else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_wrapper_runs_plain_on_cpu_and_counts_it():
    q, k, v, qp, _ = _inputs(2, 128, 8, 2, 64, [10, 100], False, seed=1)
    t = torch.from_numpy
    c = _build.COUNTERS["decode_attn"]
    before = (c.plain_calls, c.launches)
    got = attention_decode_flash(t(q).to(torch.bfloat16), t(k).to(torch.bfloat16),
                                 t(v).to(torch.bfloat16), t(qp))
    assert (c.plain_calls, c.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    want = decode_attention_plain(t(q), t(k), t(v), t(qp))
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


def test_plain_ignores_dead_slots():
    """Slots past a row's position (finite garbage, as dummy decodes leave
    it) change nothing."""
    q, k, v, qp, _ = _inputs(2, 256, 8, 2, 64, [70, 3], False, seed=2)
    t = torch.from_numpy
    ref = decode_attention_plain(t(q), t(k), t(v), t(qp))
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 71:] = 1e4
    v2[1, :, 4:] = -3e4
    got = decode_attention_plain(t(q), t(k2), t(v2), t(qp))
    assert torch.equal(got, ref)


# -- the kernel's split plan and blocking ------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_plan_does_not_depend_on_the_batch(D, kv_int8):
    """decode_plan takes S, the head dim and the KV dtype, never B: a row's
    splits (and its sums) are the same at any batch size. Its splits cover
    the tiles exactly and read at most SPLIT_BYTES of a KV head's cache."""
    assert list(inspect.signature(t_decode.decode_plan).parameters) == ["S", "D", "kv_int8"]
    slot = 2 * D + 8 if kv_int8 else 4 * D
    for S in (64, 128, 704, 1024, 2048, 2240, 4096, 4288, 32768):
        tps, splits = t_decode.decode_plan(S, D, kv_int8)
        n_tiles = -(-S // 64)
        assert (splits - 1) * tps < n_tiles <= splits * tps
        assert tps == n_tiles or tps * 64 * slot <= t_decode.SPLIT_BYTES < (tps + 1) * 64 * slot
    # the serving cell's positions (32-111 of 2048 slots) live in one split
    assert t_decode.decode_plan(2048, 64, kv_int8)[0] >= 2


@pytest.mark.parametrize("tps", [1, 2, 3, None])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_plain_matches_one_pass(case, tps):
    """decode_attention_split_plain, the kernel's blocking in plain PyTorch
    (f32 output), against the one-pass version at the reference's cases.
    Tolerance 2^-8 of max|ref|: a block rounds p * v_scale to bf16 against
    its own running max, not the row's, so each term may differ by one bf16
    rounding of p (as the reference's tiles do); the rest is f32 order."""
    B, S, H, Hkv, D, pos, int8, _ = CASES[case]
    q, k, v, qp, sc = _inputs(B, S, H, Hkv, D, pos, int8, seed=sum(pos) + 1)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), t(qp), None if sc is None else tuple(t(s) for s in sc))
    want = decode_attention_plain(*args)
    got = t_decode.decode_attention_split_plain(*args, tps=tps)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max() <= 2 ** -8 * want.abs().max()


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _mma(a_regs, b_regs, c_regs):
    """mma.sync.m16n8k16 on lane registers: a_regs[lane] = 4 pairs, b_regs
    2 pairs, c_regs 4 values (PTX's fragment layouts); returns the new C."""
    A, B = np.full((16, 16), np.nan), np.full((16, 8), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        a0, a1, a2, a3 = a_regs[lane]
        A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = a0, a1
        A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = a2, a3
        B[2 * t:2 * t + 2, g], B[2 * t + 8:2 * t + 10, g] = b_regs[lane]
    C = A @ B
    return [[c_regs[lane][e] + C[lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2]
             for e in range(4)] for lane in range(32)]


def _ldmatrix(mat, addr, trans):
    """ldmatrix.x4 (.trans): lane l gives row l % 8 of matrix l // 8 as
    addr(l) -> 8 values of `mat` (an array indexed [row][col]); returns each
    lane's 4 registers as pairs."""
    rows = [[mat(*addr(8 * i + r)) for r in range(8)] for i in range(4)]
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        if trans:
            out.append([np.array([rows[i][2 * t][g], rows[i][2 * t + 1][g]]) for i in range(4)])
        else:
            out.append([np.array(rows[i][g][2 * t:2 * t + 2]) for i in range(4)])
    return out


def _byte_perm(x, y, sel):
    b = [(x >> (8 * i)) & 255 for i in range(4)] + [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _i8_pair(u, j0, j1):
    """decode_attn.cu:i8_bf16x2 on u = the word ^ 0x80808080: bytes j0, j1
    placed in the mantissa of 2^23, minus 2^23 + 128, in f32."""
    f = [np.array(_byte_perm(u, 0x4B000000, j | 0x7440), np.uint32).view(np.float32)
         - np.float32(8388736.0) for j in (j0, j1)]
    return np.array(f, np.float32)


def test_int8_to_bf16_is_exact():
    for code in range(-128, 128):
        u = (code & 255) ^ 0x80
        assert _i8_pair(u | (u << 8), 0, 1).tolist() == [code, code]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_fragment_maps_give_qk_and_pv(D, int8):
    """csrc/decode_attn.cu's fragment maps for warp 0's 16 slots, rebuilt
    lane by lane (lane = 4 g + t): q's A fragment and K's B fragments (bf16:
    ldmatrix at the kernel's row addresses; int8: the head dim in the order
    16 ks + 4 t + 0..3) give q K^T where the kernel reads each logit; P's A
    fragment packed from those C fragments and V's B fragments (bf16:
    ldmatrix.trans; int8: four slots' words transposed by byte_perm, n-tile
    4 h + c serving column 32 h + 4 g + c) give P V at the columns the
    kernel stores each accumulator to."""
    r = np.random.default_rng(D + int8)
    q = _bf16(r.standard_normal((16, D)))
    if int8:
        kc, vc = (r.integers(-128, 128, (16, D)).astype(np.int8) for _ in range(2))
        k, v = kc.astype(np.float32), vc.astype(np.float32)
        word = lambda m, slot, col: int(m[slot, col:col + 4].view(np.uint32)[0])  # noqa: E731
    else:
        k, v = _bf16(r.standard_normal((16, D))), _bf16(r.standard_normal((16, D)))
    zero = [[0.0] * 4 for _ in range(32)]
    s = [zero, zero]
    for ks in range(D // 16):
        qa = []
        for lane in range(32):
            g, t = divmod(lane, 4)
            d0 = 16 * ks + (4 * t if int8 else 2 * t)
            d1 = d0 + (2 if int8 else 8)
            qa.append([q[g, d0:d0 + 2], q[g + 8, d0:d0 + 2], q[g, d1:d1 + 2], q[g + 8, d1:d1 + 2]])
        if int8:
            kb = [[], []]
            for lane in range(32):
                g, t = divmod(lane, 4)
                for j in range(2):
                    u = word(kc, 8 * j + g, 16 * ks + 4 * t) ^ 0x80808080
                    kb[j].append([_i8_pair(u, 0, 1), _i8_pair(u, 2, 3)])
        else:
            regs = _ldmatrix(lambda slot, d: k[slot, d:d + 8],
                             lambda l: ((l // 8 // 2) * 8 + l % 8, 16 * ks + (l // 8 % 2) * 8),
                             trans=False)
            kb = [[x[0:2] for x in regs], [x[2:4] for x in regs]]
        s = [_mma(qa, kb[j], s[j]) for j in range(2)]
    logits = q @ k.T
    p = _bf16(r.random((16, 16)))  # P, as the kernel packs it from the C fragments
    pa = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(2):
            for e in range(4):
                row, slot = g + 8 * (e // 2), 8 * j + 2 * t + e % 2
                assert s[j][lane][e] == pytest.approx(logits[row, slot], rel=1e-5, abs=1e-4)
        pa.append([p[g, 2 * t:2 * t + 2], p[g + 8, 2 * t:2 * t + 2],
                   p[g, 2 * t + 8:2 * t + 10], p[g + 8, 2 * t + 8:2 * t + 10]])
    o = [zero] * (D // 8)
    if int8:
        for h in range(D // 32):
            vb = [[] for _ in range(4)]
            for lane in range(32):
                g, t = divmod(lane, 4)
                w = [word(vc, 2 * t + e % 2 + 8 * (e // 2), 32 * h + 4 * g) ^ 0x80808080
                     for e in range(4)]
                lo0, hi0 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
                lo1, hi1 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
                vb[0].append([_i8_pair(lo0, 0, 1), _i8_pair(lo1, 0, 1)])
                vb[1].append([_i8_pair(lo0, 2, 3), _i8_pair(lo1, 2, 3)])
                vb[2].append([_i8_pair(hi0, 0, 1), _i8_pair(hi1, 0, 1)])
                vb[3].append([_i8_pair(hi0, 2, 3), _i8_pair(hi1, 2, 3)])
            for c in range(4):
                o[4 * h + c] = _mma(pa, vb[c], o[4 * h + c])
    else:
        for n in range(0, D // 8, 2):
            regs = _ldmatrix(lambda slot, d: v[slot, d:d + 8],
                             lambda l: ((l // 8 % 2) * 8 + l % 8, 8 * (n + l // 8 // 2)),
                             trans=True)
            o[n] = _mma(pa, [x[0:2] for x in regs], o[n])
            o[n + 1] = _mma(pa, [x[2:4] for x in regs], o[n + 1])
    pv = p @ v
    for n in range(D // 8):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(4):
                col = 32 * (n // 4) + 8 * t + 4 * (e % 2) + n % 4 if int8 else 8 * n + 2 * t + e % 2
                assert o[n][lane][e] == pytest.approx(pv[g + 8 * (e // 2), col], rel=1e-5,
                                                      abs=1e-3)


# -- dispatch past the budget: a decode step of a tiny fixture -------------------


@pytest.fixture(scope="module")
def head64(tmp_path_factory):
    """A tiny llama with head_dim 64 (dim 256, 4 + 2 heads), which the
    decode kernel's gate takes (D % 64)."""
    path = tmp_path_factory.mktemp("d") / "hd64.gguf"
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=256,
                      vocab_size=512, max_seq_len=256)
    write_fixture_gguf(path, cfg, seed=5, quant="q4_k_m", scale=0.05)
    return jload(str(path), scale_dtype="bf16"), load_model(str(path), scale_dtype="bf16",
                                                            device="cpu")


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_decode_past_budget_takes_the_kernel_and_matches_jax(head64, monkeypatch,
                                                             kv_quantized):
    """With the budget lowered in both packages, a decode step's logits (B
    = 2, 256 slots) pass it: the forward appends eagerly (no deferred
    append) and every layer's attention is the decode kernel's plain
    version; logits within 5e-2 of max|ref| of the JAX engine's (impl
    "xla"), greedy tokens equal, over three steps."""
    (jc, jp, _), (tc, tp, _) = head64
    monkeypatch.setattr(t_attention, "ATTN_PLAIN_MAX_MB", 1e-3)
    monkeypatch.setattr(j_attention, "_ATTN_XLA_MAX_MB", 1e-3)
    je = JEngine(jc, jp, max_batch=2, max_seq=256, impl="xla", kv_quantized=kv_quantized)
    te = InferenceEngine(tc, tp, max_batch=2, max_seq=256, device="cpu",
                         kv_quantized=kv_quantized)
    prompts = [[3, 100, 7, 256, 42], [9, 300, 5, 11, 12, 13, 14, 15, 16, 17]]
    lj, jcache, lens = je.prefill(prompts, je.new_cache(2))
    lt, tcache, _ = te.prefill(prompts, te.new_cache(2))
    appended = []
    real = type(tcache).append_all
    monkeypatch.setattr(type(tcache), "append_all",
                        lambda self, *a: appended.append(1) or real(self, *a))
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)
    assert tok_t.tolist() == np.asarray(tok_j).tolist()
    pos = np.asarray(lens)
    for step in range(3):
        c = _build.COUNTERS["decode_attn"]
        before = c.plain_calls
        lj, jcache = je.decode_step(tok_j, jnp.asarray(pos, jnp.int32), jcache)
        lt, tcache = te.decode_step(tok_t, torch.from_numpy(pos), tcache)
        assert c.plain_calls - before == tc.n_layers
        want, got = np.asarray(lj, np.float32), lt.numpy()
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = torch.argmax(lt, -1)
        assert tok_t.tolist() == np.asarray(tok_j).tolist(), step
        pos = pos + 1
    assert not appended


def test_decode_below_budget_defers_and_stays_plain(head64):
    """The default budget at B = 2 x 256 slots: the deferred append and the
    plain branch (the kernel is not reached)."""
    _, (tc, tp, _) = head64
    te = InferenceEngine(tc, tp, max_batch=2, max_seq=256, device="cpu")
    logits, cache, lens = te.prefill([[3, 100, 7], [9, 300]], te.new_cache(2))
    c = _build.COUNTERS["decode_attn"]
    before = c.plain_calls
    te.decode_step(torch.argmax(logits, -1), torch.from_numpy(lens), cache)
    assert c.plain_calls == before
