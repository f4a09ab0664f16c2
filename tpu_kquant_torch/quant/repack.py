"""Host-side repack: ggml block formats -> the packed layouts the kernels read.

The port's own copy of ``tpu_kquant.quant.repack`` (and of the block
decoders of ``tpu_kquant.quant.numpy_codecs`` it uses), byte for byte the
same output, for every GGML type the reference loads:

  kind  codes                      side arrays            group  source
  ----  -------------------------  ---------------------  -----  ------------------
  q2    qs   u8[K/4, N] (2-bit)    scales, mins [K/16,N]    16   Q2_K
  q3    qs   u8[K/4, N] + qh[K/8]  scales, mins [K/16,N]    16   Q3_K
  q4    qs   u8[K/2, N] (4-bit)    scales, mins [K/32,N]    32   Q4_K, Q4_1, Q4_0
  q5    qs   u8[K/2, N] + qh[K/8]  scales, mins [K/32,N]    32   Q5_K, Q5_1, Q5_0
  q6    qs   u8[K/2, N] + qh2[K/4] scales, mins [K/16,N]    16   Q6_K
  q6w   qs   i8[K, N] (q - 32)     scales       [K/16,N]    16   widen_q6(q6)
  q8    qs   i8[K, N]              scales       [K/32,N]    32   Q8_0
  dense w    f32[N, K]             --                       --   F32/F16/BF16, rest

Dequant is ``w[k, n] = scales[k//g, n] * q[k, n] - mins[k//g, n]`` with q the
unsigned code: offsets such as Q4_0's -8, Q3_K's -4 or Q6_K's -32 are folded
into ``mins`` as offset * scale.
Bit packing (kmajor, axis 0 is packed K):
  - 4-bit fold: byte (k, n) holds code(k) | code(k + K/2) << 4;
  - 1-bit high plane (q5, q3): byte (k, n) bit j is element k + j*K/8;
  - 2-bit (q2 / q3 codes, q6's high plane): byte (k, n) bits [2j, 2j+1] are
    element k + j*K/4.

``scale_dtype='bf16'`` packs the side arrays into bf16 pairs in an f32
container: ``sm`` (scale, min) for every kind with mins and ``sp`` (even
group, odd group) for q6w and q8. The bf16 rounding is torch's (round to
nearest even), the same rounding as the reference's ml_dtypes cast.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_kquant_torch.gguf.constants import GGMLType, block_size, type_size
from tpu_kquant_torch.quant.qtensor import QTensor

GROUP_SIZE = {"q2": 16, "q3": 16, "q4": 32, "q5": 32, "q6": 16, "q8": 32, "q6w": 16}


# ---------------------------------------------------------------------------
# ggml block helpers (bit-exact to the GGUF format)
# ---------------------------------------------------------------------------


def _f16(b: np.ndarray) -> np.ndarray:
    """Little-endian byte pairs (..., 2) -> fp16 values as fp32."""
    return np.ascontiguousarray(b).view("<f2").astype(np.float32)[..., 0]


def unpack_kscales(s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte 6-bit Q4_K / Q5_K scale/min field (nb, 12) -> (sc, m), each (nb, 8)."""
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


def _qh_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) uint8 -> (nb, 32) single bits (little-endian u32 bit order)."""
    return np.unpackbits(qh_bytes, axis=1, bitorder="little")


def _q6k_elem_tables():
    """Per-element (ql_idx, ql_shift, qh_idx, qh_shift) of the Q6_K layout."""
    e = np.arange(256)
    n, r = e // 128, e % 128
    k, lane = r // 32, r % 32
    return (64 * n + lane + 32 * (k % 2), 4 * (k // 2), 32 * n + lane, 2 * k)


_Q6K_QL_IDX, _Q6K_QL_SHIFT, _Q6K_QH_IDX, _Q6K_QH_SHIFT = _q6k_elem_tables()


def _q2k_elem_tables():
    """Element e: half n = e//128, j = (e%128)//32, sub = (e%32)//16, l = e%16:
    its 2 bits sit in q byte 32n + 16sub + l at shift 2j."""
    e = np.arange(256)
    n, j, sub, lane = e // 128, (e % 128) // 32, (e % 32) // 16, e % 16
    return 32 * n + 16 * sub + lane, 2 * j


_Q2K_Q_IDX, _Q2K_Q_SHIFT = _q2k_elem_tables()
# element e's sub-block scale index (Q2_K and Q3_K): 8n + 2j + sub
_Q2K_SCALE_IDX = (8 * (np.arange(256) // 128) + 2 * ((np.arange(256) % 128) // 32)
                  + (np.arange(256) % 32) // 16)
# Q3_K hmask: element e -> byte 16*sub + l (0..31), bit 4n + j
_Q3K_H_IDX = 16 * ((np.arange(256) % 32) // 16) + np.arange(256) % 16
_Q3K_H_BIT = 4 * (np.arange(256) // 128) + ((np.arange(256) % 128) // 32)


def _unpack_q3k_scales(s: np.ndarray) -> np.ndarray:
    """(nb, 12) -> (nb, 16) int16 scales in [-32, 31] (stored 6-bit biased)."""
    out = np.empty(s.shape[:-1] + (16,), np.uint8)
    out[..., 0:4] = (s[..., 0:4] & 0xF) | (((s[..., 8:12] >> 0) & 3) << 4)
    out[..., 4:8] = (s[..., 4:8] & 0xF) | (((s[..., 8:12] >> 2) & 3) << 4)
    out[..., 8:12] = (s[..., 0:4] >> 4) | (((s[..., 8:12] >> 4) & 3) << 4)
    out[..., 12:16] = (s[..., 4:8] >> 4) | (((s[..., 8:12] >> 6) & 3) << 4)
    return out.astype(np.int16) - 32


# ---------------------------------------------------------------------------
# per-format decode to (codes, scale_eff, min_eff, group); codes (nb, 256 or
# 32) unsigned (Q8_0: int8), scale/min_eff (nb, groups per block) float32
# ---------------------------------------------------------------------------


def _decode_q4_k(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_kscales(blocks[:, 4:16])
    q = _q4k_nibbles(blocks[:, 16:144])
    return q, d[:, None] * sc, dmin[:, None] * m, 32


# The decoders below gather codes with reshapes and uint8 shifts, where the
# reference indexes element tables (int64 intermediates); the codes are the
# same, and loading a 1.1B-weight model takes a fraction of the time.


def _bits_by_element(h: np.ndarray) -> np.ndarray:
    """(nb, 32) bytes -> (nb, 256) bits: element e is bit e // 32 of byte
    e % 32 (the Q5_K qh and Q3_K hmask layouts)."""
    return np.unpackbits(h[:, None, :], axis=1, bitorder="little").reshape(h.shape[0], 256)


def _q2k_codes(qs: np.ndarray) -> np.ndarray:
    """(nb, 64) Q2_K / Q3_K qs -> (nb, 256) 2-bit codes: element
    128n + 32j + m sits in byte 32n + m at shift 2j."""
    a = qs.reshape(qs.shape[0], 2, 1, 32)
    return np.concatenate([(a >> (2 * j)) & 3 for j in range(4)], axis=2).reshape(-1, 256)


def _decode_q5_k(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_kscales(blocks[:, 4:16])
    hbit = _bits_by_element(blocks[:, 16:48])
    q4 = _q4k_nibbles(blocks[:, 48:176])
    return q4 | (hbit << 4), d[:, None] * sc, dmin[:, None] * m, 32


def _decode_q6_k(blocks: np.ndarray):
    nb = blocks.shape[0]
    # element 128n + 32k + l: the low nibble of ql[64n + 32(k % 2) + l] for
    # k < 2, its high nibble for k >= 2; bits [2k, 2k+1] of qh[32n + l]
    ql = blocks[:, 0:128].reshape(nb, 2, 1, 2, 32)
    q4 = np.concatenate([ql & 0xF, ql >> 4], axis=2).reshape(nb, 256)
    qh = blocks[:, 128:192].reshape(nb, 2, 1, 32)
    q2 = np.concatenate([(qh >> (2 * k)) & 3 for k in range(4)], axis=2).reshape(nb, 256)
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210])
    q = q4 | (q2 << 4)  # biased [0, 63], value q - 32
    scale = d[:, None] * sc
    return q, scale, 32.0 * scale, 16


def _decode_q2_k(blocks: np.ndarray):
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82])
    dmin = _f16(blocks[:, 82:84])
    q = _q2k_codes(qs)
    sc = (scales & 0xF).astype(np.float32)
    m = (scales >> 4).astype(np.float32)
    gidx = _Q2K_SCALE_IDX[::16]  # group g (elements 16g..16g+15)
    return q, d[:, None] * sc[:, gidx], dmin[:, None] * m[:, gidx], 16


def _decode_q3_k(blocks: np.ndarray):
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = _unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)
    d = _f16(blocks[:, 108:110])
    q = _q2k_codes(qs) | (_bits_by_element(hmask) << 2)  # biased [0, 7], value q - 4
    scale = d[:, None] * scales[:, _Q2K_SCALE_IDX[::16]]
    return q, scale, 4.0 * scale, 16


def _decode_q4_0(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], 8.0 * d[:, None], 32


def _decode_q4_1(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    m = _f16(blocks[:, 2:4])
    qs = blocks[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], -m[:, None], 32


def _decode_q5_0(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    qh = _qh_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)
    return q, d[:, None], 16.0 * d[:, None], 32


def _decode_q5_1(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    m = _f16(blocks[:, 2:4])
    qh = _qh_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)
    return q, d[:, None], -m[:, None], 32


def _decode_q8_0(blocks: np.ndarray):
    d = _f16(blocks[:, 0:2])
    return blocks[:, 2:34].view(np.int8), d[:, None], None, 32


_DECODERS = {
    GGMLType.Q2_K: ("q2", _decode_q2_k),
    GGMLType.Q3_K: ("q3", _decode_q3_k),
    GGMLType.Q4_K: ("q4", _decode_q4_k),
    GGMLType.Q4_0: ("q4", _decode_q4_0),
    GGMLType.Q4_1: ("q4", _decode_q4_1),
    GGMLType.Q5_K: ("q5", _decode_q5_k),
    GGMLType.Q5_0: ("q5", _decode_q5_0),
    GGMLType.Q5_1: ("q5", _decode_q5_1),
    GGMLType.Q6_K: ("q6", _decode_q6_k),
    GGMLType.Q8_0: ("q8", _decode_q8_0),
}


# ---------------------------------------------------------------------------
# dequantize: the reference's own arithmetic per type (numpy_codecs._DEQUANT),
# so the floats are equal bit for bit
# ---------------------------------------------------------------------------


def _deq_q4_0(blocks):
    d = _f16(blocks[:, 0:2])[:, None]
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int8) - 8
    return d * q.astype(np.float32)


def _deq_q4_1(blocks):
    d = _f16(blocks[:, 0:2])[:, None]
    m = _f16(blocks[:, 2:4])[:, None]
    qs = blocks[:, 4:20]
    return d * np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32) + m


def _deq_q5_0(blocks):
    d = _f16(blocks[:, 0:2])[:, None]
    qh = _qh_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    q = (np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)).astype(np.int16) - 16
    return d * q.astype(np.float32)


def _deq_q5_1(blocks):
    d = _f16(blocks[:, 0:2])[:, None]
    m = _f16(blocks[:, 2:4])[:, None]
    qh = _qh_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    q = (np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)).astype(np.float32)
    return d * q + m


def _deq_q8_0(blocks):
    return _f16(blocks[:, 0:2])[:, None] * blocks[:, 2:34].view(np.int8).astype(np.float32)


def _deq_q8_1(blocks):
    return _f16(blocks[:, 0:2])[:, None] * blocks[:, 4:36].view(np.int8).astype(np.float32)


def _deq_kquant(decoder):
    """Q4_K / Q5_K: scale * q - min per 32-element sub-block, in f32."""
    def deq(blocks):
        q, s, m, _ = decoder(blocks)
        q = q.reshape(-1, 8, 32).astype(np.float32)
        return (s[:, :, None] * q - m[:, :, None]).reshape(-1, 256)
    return deq


def _deq_q6_k(blocks):
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210])[:, None]
    q4 = (ql[:, _Q6K_QL_IDX] >> _Q6K_QL_SHIFT) & 0xF
    q2 = (qh[:, _Q6K_QH_IDX] >> _Q6K_QH_SHIFT) & 3
    q = (q4 | (q2 << 4)).astype(np.int16) - 32
    return d * np.repeat(sc, 16, axis=1) * q.astype(np.float32)


def _deq_q2_k(blocks):
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82])[:, None]
    dmin = _f16(blocks[:, 82:84])[:, None]
    q = ((qs[:, _Q2K_Q_IDX] >> _Q2K_Q_SHIFT) & 3).astype(np.float32)
    sc = (scales[:, _Q2K_SCALE_IDX] & 0xF).astype(np.float32)
    m = (scales[:, _Q2K_SCALE_IDX] >> 4).astype(np.float32)
    return d * sc * q - dmin * m


def _deq_q3_k(blocks):
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = _unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)
    d = _f16(blocks[:, 108:110])[:, None]
    q2 = ((qs[:, _Q2K_Q_IDX] >> _Q2K_Q_SHIFT) & 3).astype(np.int16)
    hbit = (hmask[:, _Q3K_H_IDX] >> _Q3K_H_BIT) & 1
    q = (q2 - np.where(hbit == 0, 4, 0)).astype(np.float32)  # [-4, 3]
    return d * scales[:, _Q2K_SCALE_IDX] * q


def _deq_q8_k(blocks):
    d = np.ascontiguousarray(blocks[:, 0:4]).view("<f4").astype(np.float32)
    return d * blocks[:, 4:260].view(np.int8).astype(np.float32)


_DEQUANT = {
    GGMLType.Q4_0: _deq_q4_0,
    GGMLType.Q4_1: _deq_q4_1,
    GGMLType.Q5_0: _deq_q5_0,
    GGMLType.Q5_1: _deq_q5_1,
    GGMLType.Q8_0: _deq_q8_0,
    GGMLType.Q8_1: _deq_q8_1,
    GGMLType.Q2_K: _deq_q2_k,
    GGMLType.Q3_K: _deq_q3_k,
    GGMLType.Q4_K: _deq_kquant(_decode_q4_k),
    GGMLType.Q5_K: _deq_kquant(_decode_q5_k),
    GGMLType.Q6_K: _deq_q6_k,
    GGMLType.Q8_K: _deq_q8_k,
}
_INT_TYPES = {GGMLType.I8: "i1", GGMLType.I16: "<i2", GGMLType.I32: "<i4",
              GGMLType.I64: "<i8", GGMLType.F64: "<f8"}


def dequantize(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Raw tensor bytes -> float32 of ``shape``, for every type the reference
    decodes (the float and integer types, and every block format)."""
    t = GGMLType(ggml_type)
    n = int(np.prod(shape))
    if t == GGMLType.F32:
        return np.ascontiguousarray(data[: n * 4]).view("<f4").reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return np.ascontiguousarray(data[: n * 2]).view("<f2").reshape(shape).astype(np.float32)
    if t == GGMLType.BF16:
        u32 = np.ascontiguousarray(data[: n * 2]).view("<u2").astype(np.uint32) << 16
        return u32.view(np.float32).reshape(shape)
    if t in _INT_TYPES:
        dt = np.dtype(_INT_TYPES[t])
        return np.ascontiguousarray(data[: n * dt.itemsize]).view(dt).reshape(shape).astype(
            np.float32)
    bs, ts = block_size(t), type_size(t)
    if n % bs:
        raise ValueError(f"{n} elements not a multiple of block size {bs} ({t.name})")
    blocks = np.ascontiguousarray(data[: n // bs * ts]).reshape(n // bs, ts)
    return _DEQUANT[t](blocks).reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# canonical packing
# ---------------------------------------------------------------------------


def _pack_bits_kmajor(codes_T: np.ndarray, kind: str) -> dict[str, np.ndarray]:
    """codes_T: (K, N) unsigned codes -> packed arrays per the conventions."""
    K = codes_T.shape[0]

    def planes(bits: np.ndarray, n: int, width: int) -> np.ndarray:
        s = K // n
        return sum((bits[j * s:(j + 1) * s] << (width * j)) for j in range(n)).astype(np.uint8)

    if kind == "q8":
        return {"qs": codes_T.astype(np.int8)}
    out: dict[str, np.ndarray] = {}
    if kind in ("q4", "q5", "q6"):
        lo4 = codes_T & 0xF
        out["qs"] = lo4[: K // 2] | (lo4[K // 2:] << 4)
    if kind == "q5":
        out["qh"] = planes((codes_T >> 4) & 1, 8, 1)
    if kind == "q6":
        out["qh"] = planes((codes_T >> 4) & 3, 4, 2)
    if kind in ("q2", "q3"):
        out["qs"] = planes(codes_T & 3, 4, 2)
    if kind == "q3":
        out["qh"] = planes((codes_T >> 2) & 1, 8, 1)
    return out


def widen_q6(qt: QTensor) -> QTensor:
    """q6 kmajor -> 'q6w': codes widened to signed int8 (q - 32), per-16
    scales, no mins. Bit-exact: s*q - 32s = s*(q - 32), and q - 32 fits int8."""
    if qt.kind != "q6" or qt.layout != "kmajor":
        return qt
    qs = np.asarray(qt.arrays["qs"])
    qh = np.asarray(qt.arrays["qh"])
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=-2)  # [..., K, N]
    hi = np.concatenate([(qh >> (2 * j)) & 3 for j in range(4)], axis=-2)
    codes = (lo | (hi << 4)) - np.uint8(32)  # q - 32 modulo 256: its int8 bytes
    return QTensor("q6w", "kmajor", qt.shape, {
        "qs": codes.view(np.int8),
        "scales": np.asarray(qt.arrays["scales"]),
    })


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (round to nearest even) as uint32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits.astype(np.uint32)


def pack_scale_pairs(qt: QTensor) -> QTensor:
    """Pack per-group (scale, min) into one f32-container array ``sm``:
    low 16 bits = bf16(scale), high 16 bits = bf16(min). Every kind with
    mins (q2, q3, q4, q5 and unwidened q6) takes it; q6w and q8 have none."""
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
    K contiguous on disk. Formats without a decoder (and 1-D tensors) become
    dense f32."""
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
