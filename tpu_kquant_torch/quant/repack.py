"""Host-side repack: ggml block formats -> the packed layouts the kernels read.

The port's own copy of the Q4_K / Q6_K / Q8_0 / float paths of
``tpu_kquant.quant.repack``, byte for byte the same output:

  kind  codes                      side arrays            group  source
  ----  -------------------------  ---------------------  -----  ------
  q4    qs   u8[K/2, N] (4-bit)    scales, mins [K/32,N]    32   Q4_K
  q6    qs   u8[K/2, N] + qh2[K/4] scales, mins [K/16,N]    16   Q6_K
  q6w   qs   i8[K, N] (q - 32)     scales       [K/16,N]    16   widen_q6(q6)
  q8    qs   i8[K, N]              scales       [K/32,N]    32   Q8_0
  dense w    f32[N, K]             --                       --   F32/F16/BF16

Dequant is ``w[k, n] = scales[k//g, n] * q[k, n] - mins[k//g, n]``.
Bit packing: byte (k, n) of a 4-bit fold holds code(k) | code(k + K/2) << 4;
a 2-bit high plane holds element k + j*K/4 in bits [2j, 2j+1].

``scale_dtype='bf16'`` packs the side arrays into bf16 pairs in an f32
container: ``sm`` (scale, min) for q4 and ``sp`` (even group, odd group) for
q6w and q8. The bf16 rounding is torch's (round to nearest even), the same rounding
as the reference's ml_dtypes cast.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_kquant_torch.gguf.constants import GGMLType, block_size, type_size
from tpu_kquant_torch.quant.qtensor import QTensor

GROUP_SIZE = {"q4": 32, "q6": 16, "q6w": 16, "q8": 32}


# ---------------------------------------------------------------------------
# ggml block decoders (bit-exact to the GGUF format)
# ---------------------------------------------------------------------------


def _f16(b: np.ndarray) -> np.ndarray:
    """Little-endian byte pairs (..., 2) -> fp16 values as fp32."""
    return np.ascontiguousarray(b).view("<f2").astype(np.float32)[..., 0]


def unpack_kscales(s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte 6-bit Q4_K scale/min field (nb, 12) -> (sc, m), each (nb, 8)."""
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 63
    m[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0xF) | ((s[..., 0:4] >> 6) << 4)
    m[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, m


def _q4k_nibbles(qs: np.ndarray) -> np.ndarray:
    """(nb, 128) packed nibbles -> (nb, 256) element-ordered 4-bit codes:
    chunk c (bytes 32c..32c+31) holds elements 64c..64c+31 in its low
    nibbles and 64c+32..64c+63 in its high nibbles."""
    nb = qs.shape[0]
    c = qs.reshape(nb, 4, 32)
    out = np.empty((nb, 4, 2, 32), np.uint8)
    out[:, :, 0, :] = c & 0xF
    out[:, :, 1, :] = c >> 4
    return out.reshape(nb, 256)


def _q6k_elem_tables():
    """Per-element (ql_idx, ql_shift, qh_idx, qh_shift) of the Q6_K layout."""
    e = np.arange(256)
    n, r = e // 128, e % 128
    k, lane = r // 32, r % 32
    return (64 * n + lane + 32 * (k % 2), 4 * (k // 2), 32 * n + lane, 2 * k)


_Q6K_QL_IDX, _Q6K_QL_SHIFT, _Q6K_QH_IDX, _Q6K_QH_SHIFT = _q6k_elem_tables()


def _decode_q4_k(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_kscales(blocks[:, 4:16])
    q = _q4k_nibbles(blocks[:, 16:144])
    return q, d[:, None] * sc, dmin[:, None] * m, 32


def _decode_q6_k(blocks: np.ndarray):
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210])
    q4 = (ql[:, _Q6K_QL_IDX] >> _Q6K_QL_SHIFT) & 0xF
    q2 = (qh[:, _Q6K_QH_IDX] >> _Q6K_QH_SHIFT) & 3
    q = (q4 | (q2 << 4)).astype(np.uint8)  # biased [0, 63], value q - 32
    scale = d[:, None] * sc
    return q, scale, 32.0 * scale, 16


def _decode_q8_0(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    return blocks[:, 2:34].view(np.int8), d[:, None], None, 32


_DECODERS = {
    GGMLType.Q4_K: ("q4", _decode_q4_k),
    GGMLType.Q6_K: ("q6", _decode_q6_k),
    GGMLType.Q8_0: ("q8", _decode_q8_0),
}


def dequantize(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Raw tensor bytes -> float32 of ``shape`` (float, Q4_K, Q6_K, Q8_0)."""
    t = GGMLType(ggml_type)
    n = int(np.prod(shape))
    if t == GGMLType.F32:
        return np.ascontiguousarray(data[: n * 4]).view("<f4").reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return np.ascontiguousarray(data[: n * 2]).view("<f2").reshape(shape).astype(np.float32)
    if t == GGMLType.BF16:
        u32 = np.ascontiguousarray(data[: n * 2]).view("<u2").astype(np.uint32) << 16
        return u32.view(np.float32).reshape(shape)
    if t not in _DECODERS:
        raise NotImplementedError(f"ggml type {t.name} is not supported by this port")
    bs, ts = block_size(t), type_size(t)
    blocks = np.ascontiguousarray(data[: n // bs * ts]).reshape(n // bs, ts)
    q, s, m, g = _DECODERS[t][1](blocks)
    w = q.reshape(-1, s.shape[1], g).astype(np.float32) * s[:, :, None]
    if m is not None:
        w = w - m[:, :, None]
    return w.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# canonical packing
# ---------------------------------------------------------------------------


def _pack_bits_kmajor(codes_T: np.ndarray, kind: str) -> dict[str, np.ndarray]:
    """codes_T: (K, N) unsigned codes -> packed arrays per the conventions."""
    K = codes_T.shape[0]
    if kind == "q8":
        return {"qs": codes_T.astype(np.int8)}
    lo4 = codes_T & 0xF
    out = {"qs": lo4[: K // 2] | (lo4[K // 2:] << 4)}
    if kind == "q6":
        h = (codes_T >> 4) & 3
        s = K // 4
        out["qh"] = sum((h[j * s: (j + 1) * s] << (2 * j))
                        for j in range(4)).astype(np.uint8)
    return out


def widen_q6(qt: QTensor) -> QTensor:
    """q6 kmajor -> 'q6w': codes widened to signed int8 (q - 32), per-16
    scales, no mins. Bit-exact: s*q - 32s = s*(q - 32), and q - 32 fits int8."""
    if qt.kind != "q6" or qt.layout != "kmajor":
        return qt
    qs = np.asarray(qt.arrays["qs"])
    qh = np.asarray(qt.arrays["qh"])
    K = 2 * qs.shape[-2]
    K4 = K // 4
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=-2)  # [..., K, N]
    k = np.arange(K)
    hi = (np.take(qh, k % K4, axis=-2) >> (2 * (k // K4))[:, None]) & 3
    codes = (lo | (hi << 4)).astype(np.int16) - 32
    return QTensor("q6w", "kmajor", qt.shape, {
        "qs": codes.astype(np.int8),
        "scales": np.asarray(qt.arrays["scales"]),
    })


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (round to nearest even) as uint32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits.astype(np.uint32)


def pack_scale_pairs(qt: QTensor) -> QTensor:
    """Pack per-group (scale, min) into one f32-container array ``sm``:
    low 16 bits = bf16(scale), high 16 bits = bf16(min)."""
    if "mins" not in qt.arrays or "scales" not in qt.arrays:
        return qt
    sb = _bf16_bits(np.asarray(qt.arrays["scales"], np.float32))
    mb = _bf16_bits(np.asarray(qt.arrays["mins"], np.float32))
    arrays = {k: v for k, v in qt.arrays.items() if k not in ("scales", "mins")}
    arrays["sm"] = (sb | (mb << 16)).view(np.float32)
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def pack_scale_kpairs(qt: QTensor) -> QTensor:
    """Flat-kind (q6w, q8) per-group scales -> ``sp``: adjacent-group bf16 scale
    pairs in one f32 container (low 16 bits = bf16(scales[2j]), high 16 =
    bf16(scales[2j + 1]))."""
    if qt.kind not in ("q6w", "q8") or "scales" not in qt.arrays:
        return qt
    s = np.asarray(qt.arrays["scales"], np.float32)
    if s.shape[-2] % 2:
        return qt
    sb = _bf16_bits(s)
    sp = (sb[..., 0::2, :] | (sb[..., 1::2, :] << 16)).view(np.float32)
    arrays = {k: v for k, v in qt.arrays.items() if k != "scales"}
    arrays["sp"] = sp
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def repack(
    raw: np.ndarray,
    ggml_type: GGMLType,
    shape: tuple[int, ...],
    layout: str = "kmajor",
    scale_dtype=np.float32,
) -> QTensor:
    """Repack raw ggml tensor bytes into a QTensor of numpy arrays.

    ``shape`` is the logical (numpy) shape; for 2-D weights it is (N, K) with
    K contiguous on disk. Float types (and 1-D tensors) become dense f32."""
    t = GGMLType(ggml_type)
    if t not in _DECODERS or len(shape) < 2 or layout == "dense":
        w = dequantize(raw, t, shape)
        dt = np.float32 if len(shape) == 1 else scale_dtype
        return QTensor("dense", "dense", tuple(shape), {"w": w.astype(dt)})

    kind, decoder = _DECODERS[t]
    N = int(np.prod(shape[:-1]))
    K = shape[-1]
    bs, ts = block_size(t), type_size(t)
    blocks = np.ascontiguousarray(raw[: N * K // bs * ts]).reshape(-1, ts)
    codes, scale_eff, min_eff, group = decoder(blocks)
    codes = codes.reshape(N, K)
    scales = scale_eff.reshape(N, K // group).astype(scale_dtype)
    mins = None if min_eff is None else np.broadcast_to(
        min_eff, scale_eff.shape).reshape(N, K // group).astype(scale_dtype)

    if layout == "rowmajor":
        # keep rows intact for the gather: fold along K within each row
        arrays = {k: v.T for k, v in _pack_bits_kmajor(codes.T, kind).items()}
        arrays["scales"] = scales
        if mins is not None:
            arrays["mins"] = mins
    else:
        arrays = _pack_bits_kmajor(codes.T, kind)
        arrays["scales"] = scales.T.copy()
        if mins is not None:
            arrays["mins"] = mins.T.copy()
    return QTensor(kind, layout, tuple(shape), arrays)
