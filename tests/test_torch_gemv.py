"""The decode GEMV (csrc/gemv.cuh) and qmm_int8's kernel (csrc/qmm_int8.cu)
on the CPU: their host-side split plan, their arithmetic mirrored in numpy,
and qmm_plain against the reference's Pallas kernel in interpret mode at the
row counts the GEMV takes.

The CUDA kernels run only on a card (tests/test_torch_cuda.py -m cuda). What
a CPU can hold them to is here: the plan that decides every row's order of
summation never sees the row count, covers K and fits shared memory at 32
rows; and the kernels' fragment mapping (byte permutes, lop3 conversions of
the codes into bf16 mantissas, the magic offsets, the k-slot order, the
segment and scale-row indexing; int8: the 4 x 4 byte transposes) rebuilt
from the packed words lane by lane in numpy gives x @ dequant(W)^T.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_kquant.ops.pallas_qmm import qmm_pallas
from tpu_kquant.ops.qmatmul import qmatmul as j_qmatmul
from tpu_kquant.quant import quantize
from tpu_kquant.quant import repack as jrepack
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.gguf.constants import GGMLType
from tpu_kquant_torch.models.fixtures import random_packed
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops import qmm_int8 as t_qmm_int8
from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

torch.set_num_threads(1)

U32 = np.uint32
PLANES = ("q5", "q6", "q3", "q2")
# (N, K) of every R <= 32 case that chip_smoke.py's phase 3 gives the GEMV
# (qmm, the fused kernels' o_proj and down, qmm_int8): TinyLlama's wqk, wo,
# gate/up, down and lm head, Qwen2.5-1.5B's wo, down and tied lm head,
# Mixtral-8x7B's expert gate/up, down, wo, lm head and router, a ragged N
PHASE3_SHAPES = [(2304, 2048), (2048, 2048), (11264, 2048), (2048, 5632), (32000, 2048),
                 (1536, 1536), (1536, 8960), (151936, 1536), (14336, 4096), (4096, 14336),
                 (4096, 4096), (32000, 4096), (8, 4096), (96, 2048)]


def _chunks(code, K):
    return K // (32 * t_qmm.SEGMENTS[t_qmm.KINDS[code][0]])


@pytest.mark.parametrize("code", range(len(t_qmm.KINDS)),
                         ids=["-".join(k) for k in t_qmm.KINDS])
def test_gemv_plan_is_row_free_covers_k_and_fits(code):
    """For every kind code at every phase-3 shape the kernels take: the plan
    is a function of (kind, N, K) alone (the wrappers pass no row count), so
    it is the same for every R in 1..32; its splits cover K's chunks exactly
    once; its shared memory fits the cap at every R up to 32, the largest
    row count the kernel takes."""
    for N, K in PHASE3_SHAPES:
        if not t_qmm.k_ok(code, K):
            continue
        plan = t_qmm.gemv_plan(code, N, K)
        n_chunks = _chunks(code, K)
        cps, splits = plan
        assert cps * splits >= n_chunks > cps * (splits - 1), (N, K, plan)
        assert splits == 1 or cps >= 2  # each of a block's two K warps has a chunk
        for R in range(1, 33):
            assert t_qmm.gemv_plan(code, N, K) == plan
            assert t_qmm.gemv_smem_bytes(code, cps, R) <= t_qmm._SMEM_CAP
        assert t_qmm.gemv_smem_bytes(code, cps, 32) >= t_qmm.gemv_smem_bytes(code, cps, 1)


@pytest.mark.parametrize("kind", ["q4", "q6"])
def test_qmm_int8_plan_is_row_free_covers_k_and_fits(kind):
    """qmm_int8's plan (its own shared-memory model: xq bytes, scales and
    gsums) at its shapes: Mixtral's gate/up and router, TinyLlama's down
    and lm head, a ragged N."""
    code = t_qmm.KIND_CODE[(kind, "f32")]
    for N, K in ((14336, 4096), (8, 4096), (2048, 5632), (32000, 2048), (96, 2048)):
        cps, splits = t_qmm.gemv_plan(code, N, K, int8=True)
        n_chunks = _chunks(code, K)
        assert cps * splits >= n_chunks > cps * (splits - 1)
        for R in (1, 8, 16, 17, 32):
            assert t_qmm.gemv_smem_bytes(code, cps, R, int8=True) <= t_qmm._SMEM_CAP


def test_gemv_plan_fills_the_card_at_the_big_shapes():
    """At the shapes whose GEMV moves the most bytes the plan gives at least
    3/4 of a block per SM and no more blocks than one wave of two a SM (a
    second wave would split K further for nothing)."""
    for code, N, K in ((1, 4096, 14336), (0, 14336, 4096), (1, 32000, 2048), (0, 11264, 2048),
                       (3, 4096, 14336), (2, 14336, 4096)):
        cps, splits = t_qmm.gemv_plan(code, N, K)
        blocks = -(-N // t_qmm.GEMV_TN) * splits
        assert 0.75 * t_qmm.SMS <= blocks <= t_qmm.GEMV_WAVE, (code, N, K, cps, splits)


# -- the kernels' arithmetic, lane by lane --------------------------------------------


def byte_perm(a, b, s):
    """__byte_perm(a, b, s) (prmt.b32) on uint32 arrays."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        sel = np.uint64(8 * ((s >> (4 * i)) & 7))
        out |= ((src >> sel) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(U32)


def lop3(a, b, c, lut):
    """lop3.b32 with immLut = F(0xF0, 0xCC, 0xAA)."""
    a, b, c = (np.asarray(v, U32) for v in (a, b, c))
    out = np.zeros(np.broadcast(a, b, c).shape, U32)
    for i in range(8):
        if lut >> i & 1:
            out |= (a if i & 4 else ~a) & (b if i & 2 else ~b) & (c if i & 1 else ~c)
    return out


def conv(kind, field, v):
    """gemv.cuh gv_conv: bytes 0 and 2 of v as a bf16x2 of 128 + field."""
    if field:
        v = v >> U32(4)
    if kind == "q6w":
        return lop3(v, 0x003F003F, 0x43204320, 0x6A)
    if kind == "q8" and field:
        return lop3(v, 0x000F000F, 0x43084308, 0x6A)
    if kind in PLANES:
        return lop3(v, 0x007F007F, 0x43004300, 0xE2)
    return lop3(v, 0x000F000F, 0x43004300, 0xE2)


def bf16_halves(r):
    r = np.asarray(r, U32)
    return (r << U32(16)).view(np.float32), (r & U32(0xFFFF0000)).view(np.float32)


def plane_codes(kind, w, h, p, seg):
    """common.cuh plane_codes: the 4 codes of field p of qs word w with the
    high bits of segment seg from qh word h."""
    W = 4 if kind in ("q5", "q6") else 2
    HB = {"q5": 1, "q6": 2, "q3": 1, "q2": 0}[kind]
    q = (w >> U32(W * p)) & U32(0x0F0F0F0F if W == 4 else 0x03030303)
    if HB == 1:
        q |= ((h >> U32(seg)) & U32(0x01010101)) << U32(W)
    elif HB == 2:
        q |= ((h >> U32(2 * seg)) & U32(0x03030303)) << U32(W)
    return q


def _words(rows):
    """uint8 rows [..., N] -> [..., N/8, 2] uint32: a lane's 8-column words
    (.x: columns 8g..8g+3, .y: 8g+4..8g+7)."""
    rows = np.ascontiguousarray(rows.view(np.uint8))
    return rows.view(U32).reshape(*rows.shape[:-1], rows.shape[-1] // 8, 2)


def _segment_words(kind, a, K, n_chunks):
    """{segment: (words [n_chunks, 32, N/8, 2], field)}: the words a lane
    turns into the mma's A operand, per packed row 32c + i of a segment."""
    seg_n = t_qmm.SEGMENTS[kind]
    S = K // seg_n
    qs = a["qs"].view(np.uint8)
    rows = lambda arr, r0: arr[r0:r0 + 32 * n_chunks].reshape(n_chunks, 32, -1)  # noqa: E731
    if kind in ("q4", "q6w", "q8"):
        w = _words(rows(qs, 0))
        return {0: (w, 0), 1: (w, 1)} if kind == "q4" else {0: (w, 0)}
    NTP = {"q5": 4, "q6": 2, "q3": 2, "q2": 1}[kind]
    NP = 2 if kind in ("q5", "q6") else 4
    h = _words(rows(a["qh"], 0)) if "qh" in a else np.zeros_like(_words(rows(qs, 0)))
    out = {}
    for tt in range(NTP):
        w = _words(rows(qs, tt * S))
        for p in range(NP):
            out[tt + NTP * p] = (plane_codes(kind, w, h, p, tt + NTP * p), 0)
    return out


def _a_values(kind, words, field):
    """The A operand the mma sees for one segment, [N, n_chunks * 32]: per
    lane (g, t), step s and column pair p the registers gv_frag builds from
    rows 16s + 4t + e, scattered back to (column, row) through the
    fragment's (m-slot, k-slot) map."""
    n_chunks, _, G8, _ = words.shape
    N = 8 * G8
    V = np.zeros((N, n_chunks * 32), np.float32)
    chunk_rows = 32 * np.arange(n_chunks)[:, None]
    gcols = 8 * np.arange(G8)[None, :]
    for s in range(2):
        for t in range(4):
            rw = [words[:, 16 * s + 4 * t + e] for e in range(4)]  # [n_chunks, G8, 2]
            rows = [chunk_rows + 16 * s + 4 * t + e for e in range(4)]
            for p in range(4):
                sel = 0x7632 if p & 1 else 0x5410
                u01 = byte_perm(rw[0][..., p // 2], rw[1][..., p // 2], sel)
                u23 = byte_perm(rw[2][..., p // 2], rw[3][..., p // 2], sel)
                c0, c1 = gcols + 2 * p, gcols + 2 * p + 1
                for reg, col, (ea, eb) in ((conv(kind, field, u01), c0, (0, 1)),
                                           (conv(kind, field, u01 >> U32(8)), c1, (0, 1)),
                                           (conv(kind, field, u23), c0, (2, 3)),
                                           (conv(kind, field, u23 >> U32(8)), c1, (2, 3))):
                    lo, hi = bf16_halves(reg)
                    V[np.broadcast_to(col, lo.shape), np.broadcast_to(rows[ea], lo.shape)] = lo
                    V[np.broadcast_to(col, hi.shape), np.broadcast_to(rows[eb], hi.shape)] = hi
    return V


def _side(kind, side, a, row):
    """(scale, min) [N] of group row ``row`` as the kernels decode it."""
    if side == "f32":
        s = a["scales"][row].astype(np.float32)
        return s, (a["mins"][row].astype(np.float32) if "mins" in a else np.zeros_like(s))
    if side == "sm":
        return bf16_halves(a["sm"][row].view(U32))
    lo, hi = bf16_halves(a["sp"][row // 2].view(U32))  # sp: groups 2j (low), 2j + 1 (high)
    return (hi if row % 2 else lo), np.zeros_like(lo)


def mirror_gemv(qt, x):
    """csrc/gemv.cuh's arithmetic for x [R, K] (bf16 values) in float64:
    per segment and scale group, d = -OFF sum(x) + sum over the group of
    A * x (q8: + A_high * 16 x), then acc += s d - m sum(x)."""
    code = t_qmm.kernel_kind(qt)
    kind, side = t_qmm.KINDS[code]
    a = {k: np.asarray(v) for k, v in qt.arrays.items()}
    N, K = qt.shape
    seg_n, G = t_qmm.SEGMENTS[kind], GROUP_SIZE[kind]
    S, n_chunks = K // seg_n, _chunks(code, K)
    off = {"q8": 2304.0, "q6w": 160.0}.get(kind, 128.0)
    xd = x.astype(np.float64)
    acc = np.zeros((N, x.shape[0]))
    for seg, (words, field) in _segment_words(kind, a, K, n_chunks).items():
        V = _a_values(kind, words, field).astype(np.float64)
        Vh = _a_values(kind, words, 1).astype(np.float64) if kind == "q8" else None
        for lg in range(n_chunks * 32 // G):
            rows = slice(lg * G, lg * G + G)
            xg = xd[:, seg * S + lg * G: seg * S + lg * G + G]
            xsum = xg.sum(1)
            d = -off * xsum[None, :] + V[:, rows] @ xg.T
            if Vh is not None:
                d += Vh[:, rows] @ (16 * xg).T
            s, m = _side(kind, side, a, (seg * S) // G + lg)
            acc += s[:, None].astype(np.float64) * d - m[:, None].astype(np.float64) * xsum
    return acc.T


def _bf16_values(rng, R, K):
    return torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("code", range(len(t_qmm.KINDS)),
                         ids=["-".join(k) for k in t_qmm.KINDS])
def test_gemv_mirror_matches_dequant(code):
    """The kernel's mapping rebuilt lane by lane gives x @ W^T with W the
    f32 dequantization (no bf16 rounding of W: the kernel scales exact
    integer group dots in f32), to 1e-5 of max|ref| at R = 3, N = 96 (ragged
    for a 256-column block), K = 512 (1024 for the bit-plane kinds, whose
    chunk covers 256 of K)."""
    kind, side = t_qmm.KINDS[code]
    K = 1024 if kind in PLANES else 512
    rng = np.random.default_rng(code)
    qt = random_packed(rng, kind, 96, K, f32=side == "f32")
    x = _bf16_values(rng, 3, K)
    got = mirror_gemv(qt, x)
    w = dequant_kmajor(qt.to("cpu"), dtype=torch.float32).double().numpy()
    ref = x.astype(np.float64) @ w
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def transpose4(w0, w1, w2, w3):
    """qmm_int8.cu transpose4: column j of the 4 x 4 byte square."""
    t01, t23 = byte_perm(w0, w1, 0x5140), byte_perm(w2, w3, 0x5140)
    u01, u23 = byte_perm(w0, w1, 0x7362), byte_perm(w2, w3, 0x7362)
    return (byte_perm(t01, t23, 0x5410), byte_perm(t01, t23, 0x7632),
            byte_perm(u01, u23, 0x5410), byte_perm(u01, u23, 0x7632))


def _int8_codes(words, field):
    """The s8 A operand of one segment [N, n_chunks * 32]: per lane (g, t)
    and 16-row step s, the transposed squares of rows 16s + 4t + e (k-slots
    4t + e of the step), nibble `field` for q4 (None: whole 6-bit bytes)."""
    n_chunks, _, G8, _ = words.shape
    N = 8 * G8
    V = np.zeros((N, n_chunks * 32), np.int64)
    for s in range(2):
        for t in range(4):
            rows = 32 * np.arange(n_chunks)[:, None] + 16 * s + 4 * t
            for h in range(2):
                cols = transpose4(*(words[:, 16 * s + 4 * t + e, :, h] for e in range(4)))
                for j, cw in enumerate(cols):
                    if field is not None:
                        cw = (cw >> U32(4 * field)) & U32(0x0F0F0F0F)
                    col = 8 * np.arange(G8)[None, :] + 4 * h + j
                    for e in range(4):
                        byte = ((cw >> U32(8 * e)) & U32(0xFF)).astype(np.int64)
                        V[np.broadcast_to(col, byte.shape),
                          np.broadcast_to(rows + e, byte.shape)] = byte
    return V


@pytest.mark.parametrize("kind", ["q4", "q6"])
def test_qmm_int8_mirror_matches_plain(kind):
    """qmm_int8's kernel mapping rebuilt lane by lane (transposed code
    squares against xq, exact int32 group sums, then z * (xs * s) - gsum *
    m) against qmm_int8_plain at R = 3, N = 96, K = 1024: the group sums
    are exact on both sides, so 1e-5 of max|ref|."""
    code = t_qmm.KIND_CODE[(kind, "f32")]
    rng = np.random.default_rng(40 + code)
    K = 1024
    qt = random_packed(rng, kind, 96, K, f32=True)
    x = torch.from_numpy(_bf16_values(rng, 3, K)).to(torch.bfloat16)
    G = GROUP_SIZE[kind]
    xq, xs, gs = (v.double().numpy() for v in quantize_activations(x.float(), G))
    a = {k: np.asarray(v) for k, v in qt.arrays.items()}
    seg_n, S, n_chunks = t_qmm.SEGMENTS[kind], K // t_qmm.SEGMENTS[kind], _chunks(code, K)
    acc = np.zeros((96, 3))
    for seg, (words, field) in _segment_words(kind, a, K, n_chunks).items():
        V = _int8_codes(words, field if kind == "q4" else None).astype(np.float64)
        for lg in range(n_chunks * 32 // G):
            gk = (seg * S) // G + lg
            z = V[:, lg * G: lg * G + G] @ xq[:, gk * G: gk * G + G].T
            s, m = a["scales"][gk].astype(np.float64), a["mins"][gk].astype(np.float64)
            acc += z * (xs[None, :, gk] * s[:, None]) - gs[None, :, gk] * m[:, None]
    ref = t_qmm_int8.qmm_int8_plain(x, qt.to("cpu"), torch.float32).double().numpy()
    np.testing.assert_allclose(acc.T, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# -- the plain version at the GEMV's row counts, against the reference ---------------


def _ref_weight(kind, N, K, seed, pairs):
    """A kmajor weight quantized by the reference and laid out by its loader
    (q6w widened; bf16 pairs or f32 scales)."""
    qtype = {"q4": GGMLType.Q4_K, "q6w": GGMLType.Q6_K, "q8": GGMLType.Q8_0}[kind]
    raw = quantize(np.random.default_rng(seed).standard_normal((N, K)).astype(np.float32) * 0.1,
                   qtype)
    qt = jrepack.repack(raw, qtype, (N, K), layout="kmajor")
    if kind == "q6w":
        qt = jrepack.widen_q6(qt)
    qt = JQTensor(qt.kind, qt.layout, tuple(qt.shape),
                  {k: np.asarray(v) for k, v in qt.arrays.items()})
    if pairs:
        qt = jrepack.pack_scale_kpairs(jrepack.pack_scale_pairs(qt))
    return qt


@pytest.mark.parametrize("R", [1, 16, 32])
@pytest.mark.parametrize("pairs", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["q4", "q6w", "q8"])
def test_qmm_plain_matches_pallas_at_gemv_rows(kind, pairs, R):
    """qmm_plain (what the GEMV is held to on the card) against
    qmm_pallas(interpret=True) and the XLA path on bf16 activations at the
    GEMV's row counts, N = 256, K = 512: within 3e-2 of max|ref|, the
    tolerance of tests/test_torch_kernels.py's bf16 case (the interpret
    kernel rounds its dequantized operands to bf16 per tile)."""
    N, K = 256, 512
    qt = _ref_weight(kind, N, K, N + K + R, pairs)
    x = np.random.default_rng(R).standard_normal((R, K)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    port = QTensor(qt.kind, qt.layout, tuple(qt.shape),
                   {k: np.asarray(v) for k, v in qt.arrays.items()}).to("cpu")
    got = t_qmm.qmm_plain(xt, port, torch.float32).numpy()
    jq = JQTensor(qt.kind, qt.layout, tuple(qt.shape),
                  {k: jnp.asarray(v) for k, v in qt.arrays.items()})
    for ref in (j_qmatmul(xj, jq, impl="xla", out_dtype=jnp.float32),
                qmm_pallas(xj, jq, out_dtype=jnp.float32, interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())
