"""GGUF container + GGML tensor-type constants (the port's own copy of
``tpu_kquant.gguf.constants``; numeric ids follow the public GGUF v3 spec)."""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    """Typed KV metadata value types of the GGUF container."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes (the subset that appears in GGUF files).

    Ids match ggml's public enum so tensor-info blocks in real files decode.
    """

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3, removed upstream
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


QK_K = 256  # super-block size of all K-quants
K_SCALE_SIZE = 12  # packed 6-bit scales+mins bytes in Q4_K/Q5_K (8 sub-blocks)


# (block_size_elements, block_size_bytes) per type.
# Q4_K superblock: 256 elems = 144 B  (2 d + 2 dmin + 12 scales + 128 qs)
#   -- matches the 0x90 stride evidenced in the reference README:611.
# Q8_K: 256 elems = 292 B (4 d + 256 qs + 16*2 bsums) -- stride 0x124, README:610.
GGML_TYPE_TRAITS: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q8_1: (32, 36),
    GGMLType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),  # 84
    GGMLType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),  # 110
    GGMLType.Q4_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),  # 144
    GGMLType.Q5_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),  # 176
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),  # 210
    GGMLType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),  # 292
}


def block_size(t: GGMLType) -> int:
    """Elements per quantization block (1 for plain dtypes)."""
    return GGML_TYPE_TRAITS[t][0]


def type_size(t: GGMLType) -> int:
    """Bytes per quantization block."""
    return GGML_TYPE_TRAITS[t][1]


def row_size(t: GGMLType, n_elements: int) -> int:
    """Bytes of one row of ``n_elements`` (ggml_row_size equivalent)."""
    bs, ts = GGML_TYPE_TRAITS[t]
    if n_elements % bs != 0:
        raise ValueError(f"{n_elements} not a multiple of block size {bs} for {t.name}")
    return n_elements // bs * ts


def is_quantized(t: GGMLType) -> bool:
    return block_size(t) > 1
