"""qmm's wgmma tile (csrc/qmm_tile.cuh) on the CPU: its host side and its
arithmetic.

The kernel itself runs only on the card (tests/test_torch_cuda.py). Here:
- ops/qmm.py:tile_plan at every R > 32 shape of chip_smoke.py's phase 3 and
  at R in {33, 64, 65, 512, 1000, 1024, 2048}: the splits cover K's steps
  exactly and are the same at every R, the partials of each launch fit, a
  bit-plane kind's splits take whole packed chunks, and the grid fills the
  card;
- the kernel's dequantization, written out here in numpy as the kernel
  walks it (its step map: which K rows, packed rows, fields and scale rows
  a step reads; and its rounding: the bf16-pair kinds' bf16x2 sub and fma,
  one rounding of the exact s q - m; the others' f32 fma, then bf16), held
  against the port's dequant_kmajor (itself held to the reference's unpacking
  in test_torch_quant_kinds.py) for all 14 kind codes: every weight within
  one bf16 ulp, and the step map a permutation of K.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_kquant_torch.models.fixtures import random_packed
from tpu_kquant_torch.ops import qmm as t_qmm
from tpu_kquant_torch.ops.qmm import KINDS, SEGMENTS, SMS, TILE_BK, WS_CAP, tile_plan
from tpu_kquant_torch.quant.codecs import dequant_kmajor

ROOT = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# tile_plan
# ---------------------------------------------------------------------------

_PLANE = ("q5", "q6", "q3", "q2")
_SMOKE_KIND = {"q4": (0, 2), "q6w": (1, 3), "q8": (4, 5), "q5": (6, 7), "q6": (8, 9),
               "q3": (10, 11), "q2": (12, 13)}


def _smoke_shapes() -> set:
    """(N, K, code) of every qmm case of chip_smoke.py's phase 3."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert set(chip_smoke.TILE_CASES) <= set(chip_smoke.qmm_cases())
    out = set()
    for case in chip_smoke.qmm_cases():
        _, kind, N, K = case[:4]
        base, f32 = (kind[:-1], 1) if kind.endswith("f") else (kind, 0)
        out.add((N, K, _SMOKE_KIND[base][f32]))
    return out


def _check_plan(R, N, K, code):
    kind = KINDS[code][0]
    bm, bn, splits, sps = tile_plan(R, N, K, code)
    n_steps = -(-K // TILE_BK)
    assert bm in (128, 256) and bn == 128
    # the splits cover the steps exactly: none empty, none past K
    assert (splits - 1) * sps < n_steps <= splits * sps, (R, N, K, code)
    # the split is the same at every row count (a row's sums do not depend
    # on the other rows of the call)
    assert sps == t_qmm.tile_split(N, K, code)
    unit = SEGMENTS[kind] // 2 if kind in _PLANE else 1
    if splits > 1:
        assert sps % unit == 0  # whole packed chunks (no split inside one)
        assert sps >= t_qmm.MIN_SPLIT_STEPS
    # the launches cover the rows, each past the GEMV's 32 rows with its
    # partials within WS_CAP
    chunks = t_qmm.tile_chunks(R, N, splits)
    assert [r0 for r0, _ in chunks] == list(np.cumsum([0] + [n for _, n in chunks[:-1]]))
    assert sum(n for _, n in chunks) == R
    assert all(n > t_qmm.GEMV_MAX_ROWS and (splits == 1 or splits * n * N * 4 <= WS_CAP)
               for _, n in chunks)
    # the block height is plan_cost's faster at this split; the split is the
    # one of least plan_cost summed over TILE_REF_ROWS
    cost = t_qmm.plan_cost(bm, -(-N // bn) * -(-R // bm), n_steps, sps, R, N)
    for h in (128, 256):
        assert cost <= t_qmm.plan_cost(h, -(-N // bn) * -(-R // h), n_steps, sps, R, N)

    def best(run, rows):
        return min(t_qmm.plan_cost(h, -(-N // bn) * -(-rows // h), n_steps, run, rows, N)
                   for h in (128, 256))

    runs = [n_steps] + list(range(unit * -(-t_qmm.MIN_SPLIT_STEPS // unit), n_steps, unit))
    score = lambda run: sum(best(run, rows) for rows in t_qmm.TILE_REF_ROWS)  # noqa: E731
    assert score(sps) <= min(score(r) for r in runs) * (1 + 1e-9), (N, K, code)
    return bm, splits, sps


def test_tile_plan_at_the_smoke_shapes():
    shapes = _smoke_shapes()
    assert len(shapes) > 20
    for N, K, code in sorted(shapes):
        if not t_qmm.k_ok(code, K):
            continue
        for R in (33, 64, 65, 512, 1000, 1024, 2048):
            _check_plan(R, N, K, code)


@pytest.mark.parametrize("R", [33, 64, 65, 512, 1000, 1024, 2048])
def test_tile_plan_covers_every_kind_and_ragged_shape(R):
    for code, (kind, _) in enumerate(KINDS):
        for N, K in ((8, 4096), (256, 2048), (1024, 4096), (2048, 5632), (4096, 14336),
                     (151936, 1536), (1000, 2048), (2052, 2304)):
            if t_qmm.k_ok(code, K):
                _check_plan(R, N, K, code)


def test_tile_plan_fills_the_card_at_the_issue_cases():
    """The small-N cases whose one-block-per-tile grids left most of the card
    idle (4 to 72 blocks on 132 SMs) now split K: at least 64 blocks, and a
    wave of 128 where the partials stay small."""
    code = {k: c for c, k in enumerate(KINDS)}
    for R, N, K, kl in ((512, 8, 4096, ("q4", "f32")), (1024, 256, 2048, ("q6w", "sp")),
                        (512, 1024, 4096, ("q6w", "f32")), (512, 2048, 5632, ("q6w", "sp")),
                        (512, 2048, 14336, ("q6w", "f32")), (512, 2304, 2048, ("q5", "sm"))):
        bm, splits, _ = _check_plan(R, N, K, code[kl])
        blocks = -(-N // 128) * -(-R // bm) * splits
        assert blocks >= (64 if R * N < 2 ** 19 or N == 2304 else 128), (R, N, K, kl, bm, splits)


# TinyLlama-1.1B's, Qwen2.5-1.5B's and Mixtral-8x7B's projections (N, K):
# wqk, wv, wo, gate/up, down, lm head; wqk, wv, wo, gate/up, down; wqk, wv,
# wo, expert gate/up, expert down, router
_MODEL_SHAPES = ((2304, 2048), (256, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
                 (32000, 2048), (1792, 1536), (256, 1536), (1536, 1536), (17920, 1536),
                 (1536, 8960), (5120, 4096), (1024, 4096), (4096, 4096), (28672, 4096),
                 (4096, 14336), (8, 4096))


@pytest.mark.parametrize("code", range(len(KINDS)))
def test_tile_split_does_not_depend_on_the_rows(code):
    """The K split (splits, steps per split) at R in {33, 64, 512, 1024,
    2048} is one plan, at every model shape the kind takes: the 16 x 64
    burst's rows sum in the order of the 64-row call."""
    for N, K in _MODEL_SHAPES:
        if not t_qmm.k_ok(code, K):
            continue
        plans = {tile_plan(R, N, K, code)[2:] for R in (33, 64, 512, 1024, 2048)}
        assert len(plans) == 1, (N, K, KINDS[code], plans)


# ---------------------------------------------------------------------------
# the kernel's dequantization, as it walks the packed arrays
# ---------------------------------------------------------------------------

_PLANE_GEOM = {"q5": (4, 1, 4), "q6": (4, 2, 2), "q3": (2, 1, 2), "q2": (2, 0, 1)}  # W, HB, NT
_GROUP = {"q4": 32, "q8": 32, "q5": 32, "q6w": 16, "q6": 16, "q3": 16, "q2": 16}


def step_map(kind: str, K: int, s: int) -> dict:
    """qmm_tile.cuh:step_map."""
    if kind in ("q6w", "q8"):
        return dict(ka=64 * s, kb=64 * s + 32, qrow=64 * s)
    if kind == "q4":
        return dict(ka=32 * s, kb=K // 2 + 32 * s, qrow=32 * s)
    W, _, NT = _PLANE_GEOM[kind]
    NP = 8 // W
    S = K // (NT * NP)
    c, j = divmod(s, NT * NP // 2)
    t = j // (NP // 2)
    pa = 2 * (j % (NP // 2))
    sa, sb = t + NT * pa, t + NT * (pa + 1)
    return dict(ka=sa * S + 32 * c, kb=sb * S + 32 * c, qrow=t * S + 32 * c, hrow=32 * c,
                pa=pa, pb=pa + 1, sa=sa, sb=sb)


def scale_row(kind: str, side: str, m: dict, r: int, K: int) -> int:
    """qmm_tile.cuh:scale_row (a flat kind's rows past K read the last row)."""
    if (kind, side) == ("q8", "sp"):
        return m["ka"] // 64
    if kind in ("q6w", "q8"):
        per = 32 if (kind, side) in (("q6w", "sp"), ("q8", "f32")) else 16
        return min(m["ka"] // per + r, K // per - 1)
    G = _GROUP[kind]
    per = 32 // G
    return (m["ka"] if r < per else m["kb"]) // G + r % per


def _rne_bf16(v: np.ndarray) -> np.ndarray:
    """Round float64 values to the nearest bf16 (ties to even), once."""
    mant, exp = np.frexp(v)
    return np.ldexp(np.rint(mant * 256.0) / 256.0, exp)


def _bf16_halves(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    u = words.view(np.uint32).astype(np.uint64)
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32).astype(np.float64)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32).astype(np.float64)
    return lo, hi


def tile_weights(qt, code: int) -> np.ndarray:
    """W [K, N] as the tile's dequantization writes it (float64 of bf16
    values), walking the kernel's steps; asserts every K row is written
    exactly once."""
    kind, side = KINDS[code]
    N, K = qt.shape
    a = {k: v.numpy() for k, v in qt.arrays.items()}
    qs = a["qs"]
    scl = a[{"sm": "sm", "sp": "sp", "f32": "scales"}[side]]
    W = np.full((K, N), np.nan)
    seen = np.zeros(K, np.int64)
    bf16x2 = side != "f32" and kind != "q8"  # qmm_tile.cuh:tile_bf16
    for s in range(-(-K // TILE_BK)):
        m = step_map(kind, K, s)
        for i in range(64):
            k = (m["ka"] if i < 32 else m["kb"]) + i % 32
            if k >= K:  # flat kinds' ragged last step
                continue
            seen[k] += 1
            pr = i % 32
            if kind in ("q6w", "q8"):
                q = qs[m["qrow"] + i].astype(np.int64)
                i0 = i // 4 * 4  # the thread's first row
                r = {("q6w", "sp"): i0 // 32, ("q6w", "f32"): i0 // 16, ("q8", "sp"): 0,
                     ("q8", "f32"): i0 // 32}[(kind, side)]
                hi = (i0 // 16) % 2 if (kind, side) == ("q6w", "sp") else (i0 // 32) % 2
            else:
                byte = qs[m["qrow"] + pr].astype(np.int64)
                if kind == "q4":
                    q = byte & 15 if i < 32 else byte >> 4
                else:
                    W_, HB, _ = _PLANE_GEOM[kind]
                    p, seg = (m["pa"], m["sa"]) if i < 32 else (m["pb"], m["sb"])
                    q = (byte >> (W_ * p)) & ((1 << W_) - 1)
                    if HB:
                        h = a["qh"][m["hrow"] + pr].astype(np.int64)
                        q |= ((h >> (HB * seg)) & ((1 << HB) - 1)) << W_
                per = 1 if kind == "q4" else 32 // _GROUP[kind]
                r0 = pr - pr % 2  # the thread's first packed row
                r = (0 if i < 32 else per) + (r0 * per) // 32
                hi = 0
            g = scale_row(kind, side, m, r, K)
            assert 0 <= g < scl.shape[0]
            if side == "f32":
                sc = scl[g].astype(np.float64)
                mn = a["mins"][g].astype(np.float64) if "mins" in a else 0.0
            else:
                lo_h, hi_h = _bf16_halves(scl[g])
                if side == "sm":
                    sc, mn = lo_h, hi_h
                else:
                    sc, mn = (hi_h if hi else lo_h), 0.0
            exact = sc * q - mn  # exact in float64 at these magnitudes
            if bf16x2:
                W[k] = _rne_bf16(exact)
            else:  # fma in f32, then cvt.rn to bf16
                W[k] = _rne_bf16(exact.astype(np.float32).astype(np.float64))
    assert (seen == 1).all(), np.flatnonzero(seen != 1)[:8]
    return W


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    _, exp = np.frexp(np.abs(v))
    return np.ldexp(1.0, exp - 8)


# (kind, K) per kind: K % 64 == 32 for the flat kinds on f32 scales and q6w
# pairs (a half step), segments of 96 and 32 rows for the bit-plane kinds
_KS = {"q4": (1536, 2048), "q6w": (2080, 2048), "q8": (2048, 4096), "q5": (768, 2048),
       "q6": (256, 1280), "q3": (256, 768), "q2": (768, 2048)}


@pytest.mark.parametrize("code", range(len(KINDS)), ids=lambda c: "-".join(KINDS[c]))
def test_tile_dequant_matches_dequant_kmajor(code):
    """Every weight the tile writes is within one bf16 ulp of the plain
    dequantization rounded to bf16 (they differ only where the plain f32
    product and subtraction round twice), and nearly all are bit-equal."""
    kind, side = KINDS[code]
    rng = np.random.default_rng(100 + code)
    for K in _KS[kind]:
        if kind == "q8" and side == "sp" and K % 64:
            continue
        for N in (40, 136):
            qt = random_packed(rng, kind, N, K, f32=side == "f32").to("cpu")
            assert t_qmm.kernel_kind(qt) == code and t_qmm.k_ok(code, K)
            got = tile_weights(qt, code)
            ref = dequant_kmajor(qt, torch.bfloat16).double().numpy()
            diff = np.abs(got - ref)
            assert (diff <= _ulp_bf16(ref)).all(), (kind, side, K, N, diff.max())
            assert (diff == 0).mean() > 0.99, (kind, side, K, N, (diff == 0).mean())


def test_tile_dequant_reads_the_step_map_not_natural_order():
    """A planted change to one packed byte moves exactly the weights the
    step map says it feeds (q5: 2 fields x the qh bits of 8 segments)."""
    code = KINDS.index(("q5", "sm"))
    K, N = 768, 40
    qt = random_packed(np.random.default_rng(7), "q5", N, K).to("cpu")
    base = tile_weights(qt, code)
    qt.arrays["qs"][100, 3] ^= 0x11  # both nibbles of qs row 100, column 3
    moved = np.flatnonzero((tile_weights(qt, code) != base).any(axis=1))
    S = K // 8
    t, r = divmod(100, S)
    assert set(moved) <= {t * S + r, (t + 4) * S + r} and len(moved) >= 1


def test_rne_bf16_agrees_with_torch_on_f32_values():
    v = np.random.default_rng(3).standard_normal(10000).astype(np.float32)
    want = torch.from_numpy(v).to(torch.bfloat16).double().numpy()
    assert np.array_equal(_rne_bf16(v.astype(np.float64)), want)
    assert math.isclose(_rne_bf16(np.array([1.0 + 2 ** -8]))[0], 1.0)  # tie to even
