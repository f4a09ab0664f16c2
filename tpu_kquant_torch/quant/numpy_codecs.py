"""Float -> ggml block quantizers: the port's own copy of the quantizers of
``tpu_kquant.quant.numpy_codecs``, byte for byte the same output.

The K-quants run ggml's error-minimizing scale searches (``make_qx_quants``,
``make_qkx2_quants``, ``make_q3_quants``): a weighted least-squares fit of
(scale[, min]) over a grid of candidate inverse scales. Elementwise math is
float32 (rounding half to even, ggml's ``nearest_int``), accumulations are
float64, and NumPy sums a row pairwise (eight accumulators, then
``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``), which the CUDA kernels and the
plain PyTorch versions of ``ops/quantize.py`` follow op for op.

``quantize(x, ggml_type, device=None)`` sends Q4_K, Q6_K and Q8_0 to those
kernels when ``x`` is a CUDA tensor or ``device`` is a CUDA device; every
other type, and every call on the host, runs the NumPy code here. A kernel
that fails to build or launch raises: there is no fallback to NumPy.
Raw-bytes dequantization lives in ``quant/repack.py:dequantize``.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_kquant_torch.gguf.constants import GGMLType, block_size
from tpu_kquant_torch.quant.repack import (
    _Q2K_Q_IDX,
    _Q2K_Q_SHIFT,
    _Q3K_H_BIT,
    _Q3K_H_IDX,
    _Q6K_QH_IDX,
    _Q6K_QH_SHIFT,
    _Q6K_QL_IDX,
    _Q6K_QL_SHIFT,
    _f16,
)

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 little-endian bytes, shape (..., 2)."""
    return x.astype("<f2")[..., None].view(np.uint8)


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den != 0, num / np.where(den != 0, den, 1.0), 0.0)


_GROUP_MAX_EPS = 1e-15  # ggml GROUP_MAX_EPS


def _nearest(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int == round-half-to-even == np.round."""
    return np.round(x)


# ---------------------------------------------------------------------------
# error-minimizing scale searches, vectorized over groups
# ---------------------------------------------------------------------------


def _make_qx_quants(x: np.ndarray, nmax: int) -> np.ndarray:
    """Symmetric per-group scale (ggml make_qx_quants, rmse_type=1: weights
    x^2). x: (G, n) f32 -> scale (G,) f64. Candidates -(nmax + 0.1 k) / max
    for k = 0, then -9..-1, 1..9; each scored by sumlx^2 / suml2."""
    G, n = x.shape
    xd = x.astype(np.float64)
    w = xd * xd
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(G), idx]  # signed value of largest magnitude
    dead = np.abs(maxv) < _GROUP_MAX_EPS
    safe = np.where(dead, np.float32(1.0), maxv)

    def cand(step: int):
        isc = -(np.float32(nmax) + np.float32(0.1) * np.float32(step)) / safe
        l = np.clip(_nearest((isc[:, None] * x).astype(np.float32)),
                    -nmax, nmax - 1).astype(np.float64)
        sumlx = np.sum(w * xd * l, axis=1)
        suml2 = np.sum(w * l * l, axis=1)
        return sumlx, suml2

    sumlx, suml2 = cand(0)
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1.0), 0.0)
    best = scale * sumlx
    for step in (*range(-9, 0), *range(1, 10)):
        slx, sl2 = cand(step)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        new_scale = np.where(better, slx / np.where(sl2 > 0, sl2, 1.0), scale)
        best = np.where(better, new_scale * slx, best)
        scale = new_scale
    return np.where(dead, 0.0, scale)


def _make_qkx2_quants(x: np.ndarray, nmax: int, weights: np.ndarray, rmin: float,
                      rdelta: float, nstep: int, use_mad: bool) -> tuple[np.ndarray, np.ndarray]:
    """Asymmetric per-group (scale, min) (ggml make_qkx2_quants). x, weights:
    (G, n) f32. Returns (scale, the_min), both (G,) f64, the_min >= 0."""
    xd = x.astype(np.float64)
    wd = weights.astype(np.float64)
    sum_w = wd.sum(axis=1)
    sum_x = (wd * xd).sum(axis=1)
    mn = np.minimum(x.min(axis=1), np.float32(0.0))
    mx = x.max(axis=1)
    degen = mx == mn
    span = np.where(degen, np.float32(1.0), mx - mn)

    isc0 = np.float32(nmax) / span
    scale = (np.float32(1.0) / isc0).astype(np.float64)
    minv = mn.astype(np.float64)
    l0 = np.clip(_nearest((isc0[:, None] * (x - mn[:, None])).astype(np.float32)),
                 0, nmax).astype(np.float64)
    diff = scale[:, None] * l0 + minv[:, None] - xd
    best_mad = np.sum(wd * (np.abs(diff) if use_mad else diff * diff), axis=1)

    for step in range(nstep + 1):
        isc = (np.float32(rmin) + np.float32(rdelta) * np.float32(step)
               + np.float32(nmax)) / span
        l = np.clip(_nearest((isc[:, None] * (x - mn[:, None])).astype(np.float32)),
                    0, nmax).astype(np.float64)
        sum_l = (wd * l).sum(axis=1)
        sum_l2 = (wd * l * l).sum(axis=1)
        sum_xl = (wd * l * xd).sum(axis=1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        Ds = np.where(ok, D, 1.0)
        ts = (sum_w * sum_xl - sum_x * sum_l) / Ds
        tm = (sum_l2 * sum_x - sum_l * sum_xl) / Ds
        pos = tm > 0
        sl2s = np.where(sum_l2 > 0, sum_l2, 1.0)
        ts = np.where(pos, sum_xl / sl2s, ts)
        tm = np.where(pos, 0.0, tm)
        diff = ts[:, None] * l + tm[:, None] - xd
        mad = np.sum(wd * (np.abs(diff) if use_mad else diff * diff), axis=1)
        upd = ok & (mad < best_mad)
        scale = np.where(upd, ts, scale)
        minv = np.where(upd, tm, minv)
        best_mad = np.where(upd, mad, best_mad)
    scale = np.where(degen, 0.0, scale)
    minv = np.where(degen, mn.astype(np.float64), minv)
    return scale, -minv


def _make_q3_quants(x: np.ndarray, nmax: int) -> np.ndarray:
    """Symmetric scale with per-element coordinate-descent refinement (ggml
    make_q3_quants, do_rmse=true). x: (G, n) f32 -> scale (G,) f64."""
    G, n = x.shape
    xd = x.astype(np.float64)
    w = xd * xd
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(G), idx]
    dead = np.abs(maxv) == 0.0
    safe = np.where(dead, np.float32(1.0), maxv)
    isc = -np.float32(nmax) / safe
    L = np.clip(_nearest((isc[:, None] * x).astype(np.float32)),
                -nmax, nmax - 1).astype(np.float64)
    sumlx = np.sum(w * xd * L, axis=1)
    suml2 = np.sum(w * L * L, axis=1)
    for _ in range(5):
        any_changed = False
        for i in range(n):
            wi, xi, Li = w[:, i], xd[:, i], L[:, i]
            slx = sumlx - wi * xi * Li
            sl2 = suml2 - wi * Li * Li
            good = slx > 0
            new_l = np.clip(
                _nearest(np.where(good, xi * sl2 / np.where(slx != 0, slx, 1.0), Li)),
                -nmax, nmax - 1,
            )
            cand = good & (new_l != Li)
            slx2 = slx + wi * xi * new_l
            sl22 = sl2 + wi * new_l * new_l
            improve = cand & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(improve, new_l, Li)
            sumlx = np.where(improve, slx2, sumlx)
            suml2 = np.where(improve, sl22, suml2)
            any_changed = any_changed or bool(improve.any())
        if not any_changed:
            break
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1.0), 0.0)
    return np.where(dead, 0.0, scale)


# ---------------------------------------------------------------------------
# Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q8_0 / Q8_1  (32-element blocks)
# ---------------------------------------------------------------------------


def _q_q4_0(x: np.ndarray) -> np.ndarray:
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -8.0
    q = np.clip(np.round(_safe_div(x, d[:, None])) + 8, 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _q_q4_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    q = np.clip(np.round(_safe_div(x - mn[:, None], d[:, None])), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _q_q5_0(x: np.ndarray) -> np.ndarray:
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -16.0
    q = np.clip(np.round(_safe_div(x, d[:, None])) + 16, 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 22), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:6] = np.packbits(q >> 4, axis=1, bitorder="little")
    lo = q & 0xF
    out[:, 6:22] = lo[:, :16] | (lo[:, 16:] << 4)
    return out


def _q_q5_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    q = np.clip(np.round(_safe_div(x - mn[:, None], d[:, None])), 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 24), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:8] = np.packbits(q >> 4, axis=1, bitorder="little")
    lo = q & 0xF
    out[:, 8:24] = lo[:, :16] | (lo[:, 16:] << 4)
    return out


def _q_q8_0(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:34] = q.view(np.uint8)
    return out


def _q_q8_1(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    s = d * q.astype(np.float32).sum(axis=1)  # stored block sum (d * sum qs)
    out = np.empty((x.shape[0], 36), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(s)
    out[:, 4:36] = q.view(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Q4_K / Q5_K  (256-element superblocks, 6-bit packed scales+mins)
# ---------------------------------------------------------------------------


def pack_kscales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of ``repack.unpack_kscales``. sc, m: (nb, 8) in [0, 63] -> (nb, 12)."""
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)
    return out


def _q4k_pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(nb, 256) 4-bit values -> (nb, 128): chunk c's bytes hold elements
    64c..64c+31 in their low nibbles and 64c+32..64c+63 in their high ones."""
    nb = q.shape[0]
    g = q.reshape(nb, 4, 2, 32)
    return (g[:, :, 0, :] | (g[:, :, 1, :] << 4)).reshape(nb, 128)


def _kquant_search_scales(x: np.ndarray, qmax: int, rmin: float,
                          nstep: int) -> tuple[np.ndarray, ...]:
    """Shared Q4_K/Q5_K superblock assembly around the qkx2 search. x: (nb,
    8, 32). Returns (d, dmin, sc, m, scale_eff, min_eff): the per-sub-block
    scale and min as dequantization sees them (fp16-rounded supers)."""
    nb = x.shape[0]
    # ggml's weighting: av_x + |x| with av_x the group RMS
    av_x = np.sqrt((x.astype(np.float64) ** 2).sum(axis=2) / 32.0).astype(np.float32)
    weights = av_x[:, :, None] + np.abs(x)
    scales, mins = _make_qkx2_quants(x.reshape(nb * 8, 32), qmax, weights.reshape(nb * 8, 32),
                                     rmin, 0.1, nstep, False)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = np.maximum(scales.max(axis=1), 0.0)
    max_min = np.maximum(mins.max(axis=1), 0.0)
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale > 0, max_scale, 1.0), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min > 0, max_min, 1.0), 0.0)
    sc = np.clip(_nearest(inv_scale[:, None] * scales), 0, 63).astype(np.uint8)
    m = np.clip(_nearest(inv_min[:, None] * mins), 0, 63).astype(np.uint8)
    d = _f16(_to_f16_bytes((max_scale / 63.0).astype(np.float32)))
    dmin = _f16(_to_f16_bytes((max_min / 63.0).astype(np.float32)))
    scale_eff = d[:, None] * sc.astype(np.float32)
    min_eff = dmin[:, None] * m.astype(np.float32)
    return d, dmin, sc, m, scale_eff, min_eff


def _q_q4_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 8, 32)
    d, dmin, sc, m, scale_eff, min_eff = _kquant_search_scales(xg, 15, -1.0, 20)
    q = np.where(
        scale_eff[:, :, None] > 0,
        np.clip(_nearest(_safe_div(xg + min_eff[:, :, None], scale_eff[:, :, None])), 0, 15),
        0.0,
    ).astype(np.uint8)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = pack_kscales(sc, m)
    out[:, 16:144] = _q4k_pack_nibbles(q.reshape(nb, 256))
    return out


def _q_q5_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 8, 32)
    d, dmin, sc, m, scale_eff, min_eff = _kquant_search_scales(xg, 31, -0.5, 15)
    q = np.where(
        scale_eff[:, :, None] > 0,
        np.clip(_nearest(_safe_div(xg + min_eff[:, :, None], scale_eff[:, :, None])), 0, 31),
        0.0,
    ).astype(np.uint8).reshape(nb, 256)
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = pack_kscales(sc, m)
    hb = (q >> 4).astype(np.uint8)  # (nb, 256) in {0,1}
    qh = np.zeros((nb, 32), np.uint8)
    for bit in range(8):
        qh |= (hb[:, bit * 32:(bit + 1) * 32] << bit).astype(np.uint8)
    out[:, 16:48] = qh
    out[:, 48:176] = _q4k_pack_nibbles(q & 0xF)
    return out


# ---------------------------------------------------------------------------
# Q6_K  (256-element superblocks, 16 int8 sub-block scales, 6-bit values)
# ---------------------------------------------------------------------------


def _q_q6_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales = _make_qx_quants(xg.reshape(nb * 16, 16), 32).reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]  # signed value of largest |scale|
    dead = np.abs(max_scale) < _GROUP_MAX_EPS
    iscale = -128.0 / np.where(dead, 1.0, max_scale)
    d = _f16(_to_f16_bytes((1.0 / iscale).astype(np.float32)))
    d = np.where(dead, np.float32(0.0), d)
    sc = np.clip(np.minimum(127, _nearest(iscale[:, None] * scales)), -128, 127).astype(np.int8)
    sc = np.where(dead[:, None], np.int8(0), sc)
    eff = d[:, None] * sc.astype(np.float32)
    q = np.where(
        eff[:, :, None] != 0,
        np.clip(_nearest(_safe_div(xg, eff[:, :, None])), -32, 31),
        0.0,
    ).astype(np.int16)
    q = (q.reshape(nb, 256) + 32).astype(np.uint8)  # 6-bit biased
    q = np.where(dead[:, None], np.uint8(0), q)  # dead block: all-zero bytes
    out = np.zeros((nb, 210), np.uint8)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    rows = np.arange(nb)[:, None]
    np.bitwise_or.at(ql, (rows, _Q6K_QL_IDX[None, :]), ((q & 0xF) << _Q6K_QL_SHIFT))
    np.bitwise_or.at(qh, (rows, _Q6K_QH_IDX[None, :]), ((q >> 4) << _Q6K_QH_SHIFT))
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = _to_f16_bytes(d)
    return out


# ---------------------------------------------------------------------------
# Q2_K (2-bit, 16 sub-blocks with 4-bit scale + 4-bit min)
# ---------------------------------------------------------------------------


def _q_q2_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales, mins = _make_qkx2_quants(xg.reshape(nb * 16, 16), 3,
                                     np.abs(xg).reshape(nb * 16, 16), -0.5, 0.1, 15, True)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    max_scale = np.maximum(scales.max(axis=1), 0.0)
    max_min = np.maximum(mins.max(axis=1), 0.0)
    inv_scale = np.where(max_scale > 0, 15.0 / np.where(max_scale > 0, max_scale, 1.0), 0.0)
    inv_min = np.where(max_min > 0, 15.0 / np.where(max_min > 0, max_min, 1.0), 0.0)
    sc = np.clip(_nearest(inv_scale[:, None] * scales), 0, 15).astype(np.uint8)
    m = np.clip(_nearest(inv_min[:, None] * mins), 0, 15).astype(np.uint8)
    d = np.where(max_scale > 0, _f16(_to_f16_bytes((max_scale / 15.0).astype(np.float32))),
                 np.float32(0.0)).astype(np.float32)
    dmin = np.where(max_min > 0, _f16(_to_f16_bytes((max_min / 15.0).astype(np.float32))),
                    np.float32(0.0)).astype(np.float32)
    eff_s = d[:, None] * sc.astype(np.float32)
    eff_m = dmin[:, None] * m.astype(np.float32)
    q = np.where(
        eff_s[:, :, None] > 0,
        np.clip(_nearest(_safe_div(xg + eff_m[:, :, None], eff_s[:, :, None])), 0, 3),
        0.0,
    ).astype(np.uint8).reshape(nb, 256)
    out = np.zeros((nb, 84), np.uint8)
    out[:, 0:16] = sc | (m << 4)
    qs = np.zeros((nb, 64), np.uint8)
    np.bitwise_or.at(qs, (np.arange(nb)[:, None], _Q2K_Q_IDX[None, :]), (q << _Q2K_Q_SHIFT))
    out[:, 16:80] = qs
    out[:, 80:82] = _to_f16_bytes(d)
    out[:, 82:84] = _to_f16_bytes(dmin)
    return out


# ---------------------------------------------------------------------------
# Q3_K (3-bit: 2-bit qs + 1-bit hmask, 16 6-bit signed sub-block scales)
# ---------------------------------------------------------------------------


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """(nb, 16) values in [-32, 31] -> (nb, 12), the inverse of
    ``repack._unpack_q3k_scales``."""
    b = (sc.astype(np.int16) + 32).astype(np.uint8)  # 6-bit
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (b[..., 0:4] & 0xF) | ((b[..., 8:12] & 0xF) << 4)
    out[..., 4:8] = (b[..., 4:8] & 0xF) | ((b[..., 12:16] & 0xF) << 4)
    out[..., 8:12] = ((b[..., 0:4] >> 4) | ((b[..., 4:8] >> 4) << 2)
                      | ((b[..., 8:12] >> 4) << 4) | ((b[..., 12:16] >> 4) << 6))
    return out


def _q_q3_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales = _make_q3_quants(xg.reshape(nb * 16, 16), 4).reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]  # signed value of largest |scale|
    dead = np.abs(max_scale) < _GROUP_MAX_EPS
    iscale = -32.0 / np.where(dead, 1.0, max_scale)
    d = _f16(_to_f16_bytes((1.0 / iscale).astype(np.float32)))
    d = np.where(dead, np.float32(0.0), d)
    sc = np.clip(_nearest(iscale[:, None] * scales), -32, 31).astype(np.int16)
    sc = np.where(dead[:, None], np.int16(0), sc)
    eff = d[:, None] * sc.astype(np.float32)
    q = np.where(
        eff[:, :, None] != 0,
        np.clip(_nearest(_safe_div(xg, eff[:, :, None])), -4, 3),
        0.0,
    ).astype(np.int16).reshape(nb, 256)
    qp4 = (q + 4).astype(np.uint8)  # [0, 7]: bit 2 -> hmask, bits 0-1 -> qs
    out = np.zeros((nb, 110), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    rows = np.arange(nb)[:, None]
    np.bitwise_or.at(qs, (rows, _Q2K_Q_IDX[None, :]), ((qp4 & 3) << _Q2K_Q_SHIFT))
    hval = (qp4 >> 2) & 1  # 1 means q >= 0 region (no -4), hmask bit SET
    np.bitwise_or.at(hmask, (rows, _Q3K_H_IDX[None, :]), (hval << _Q3K_H_BIT))
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3k_scales(sc)
    out[:, 108:110] = _to_f16_bytes(d)
    return out


# ---------------------------------------------------------------------------
# Q8_K (activation format: fp32 d, 256 int8, 16 int16 group sums)
# ---------------------------------------------------------------------------


def _q_q8_k(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    bsums = q.astype(np.int16).reshape(-1, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((x.shape[0], 292), np.uint8)
    out[:, 0:4] = d.astype("<f4")[:, None].view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums[:, :, None].view(np.uint8).reshape(-1, 32)
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_QUANT = {
    GGMLType.Q4_0: _q_q4_0,
    GGMLType.Q4_1: _q_q4_1,
    GGMLType.Q5_0: _q_q5_0,
    GGMLType.Q5_1: _q_q5_1,
    GGMLType.Q8_0: _q_q8_0,
    GGMLType.Q8_1: _q_q8_1,
    GGMLType.Q2_K: _q_q2_k,
    GGMLType.Q3_K: _q_q3_k,
    GGMLType.Q4_K: _q_q4_k,
    GGMLType.Q5_K: _q_q5_k,
    GGMLType.Q6_K: _q_q6_k,
    GGMLType.Q8_K: _q_q8_k,
}

# the types the CUDA kernels of ops/quantize.py encode
DEVICE_TYPES = (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0)


def _on_card(x, device) -> bool:
    if device is not None:
        return str(device).startswith("cuda")
    return getattr(x, "is_cuda", False)


def quantize(x, ggml_type: GGMLType, device=None, seconds: dict | None = None) -> np.ndarray:
    """Encode float values (a numpy array or a torch tensor) into raw ggml
    bytes: a flat uint8 numpy array, in row-major element order.

    Q4_K, Q6_K and Q8_0 run on the card's kernels (``ops/quantize.py``) when
    ``x`` is a CUDA tensor or ``device`` is a CUDA device; the bytes are the
    NumPy code's. Everything else is host NumPy. With ``seconds``, the time
    taken is added to its "copies" and "quantize_card" (the kernel,
    synchronised on either side) or to its "quantize_host"."""
    t = GGMLType(ggml_type)
    t0 = time.perf_counter()
    if _on_card(x, device) and t in DEVICE_TYPES:
        import torch

        from tpu_kquant_torch.ops import quantize as qops

        dev = torch.device(device) if device is not None else x.device
        xt = torch.as_tensor(x).to(device=dev, dtype=torch.float32).reshape(-1)
        if seconds is None:
            return qops.QUANTIZERS[t](xt).cpu().numpy()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out = qops.QUANTIZERS[t](xt)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        raw = out.cpu().numpy()
        seconds["copies"] += (t1 - t0) + (time.perf_counter() - t2)
        seconds["quantize_card"] += t2 - t1
        return raw
    raw = _quantize_host(x, t)
    if seconds is not None:
        seconds["quantize_host"] += time.perf_counter() - t0
    return raw


def _quantize_host(x, t: GGMLType) -> np.ndarray:
    if not isinstance(x, np.ndarray):
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    x = np.asarray(x, np.float32)
    n = x.size
    if t == GGMLType.F32:
        return x.astype("<f4").reshape(-1).view(np.uint8)
    if t == GGMLType.F16:
        return x.astype("<f2").reshape(-1).view(np.uint8)
    if t == GGMLType.BF16:
        u32 = x.reshape(-1).view(np.uint32)
        # round-to-nearest-even bf16
        rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype("<u2")
        return rounded.view(np.uint8)
    bs = block_size(t)
    if n % bs != 0:
        raise ValueError(f"{n} elements not a multiple of block size {bs} ({t.name})")
    return _QUANT[t](x.reshape(n // bs, bs)).reshape(-1)
