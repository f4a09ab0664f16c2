"""GGUF v3 writer (the port's counterpart of ``tpu_kquant.gguf.writer``).

Tensors are added as raw ggml bytes, or as a zero-argument callable that
returns them; ``write`` streams each tensor to the file in turn, so a model
of a billion parameters never has to sit in host memory twice.
``add_values`` adds float values that are quantized only when the file is
written (on the card for Q4_K, Q6_K and Q8_0 when ``device`` is CUDA).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Callable, Union

import numpy as np

from tpu_kquant_torch.gguf.constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    row_size,
)

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}

RawBytes = Union[np.ndarray, Callable[[], np.ndarray]]


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        if v < 0:
            return GGUFValueType.INT64
        return GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(v)
    if vtype == GGUFValueType.ARRAY:
        if isinstance(v, np.ndarray):
            item_t = _NP_VTYPE[v.dtype]
            fmt = _SCALAR_PACK[item_t].lstrip("<")
            return struct.pack("<IQ", item_t, v.size) + v.astype(f"<{fmt}").tobytes()
        if len(v) == 0:
            return struct.pack("<IQ", GGUFValueType.INT32, 0)
        item_t = _infer_vtype(v[0])
        if item_t in (GGUFValueType.UINT32, GGUFValueType.UINT64) and any(
            isinstance(x, int) and x < 0 for x in v
        ):
            item_t = GGUFValueType.INT64
        out = struct.pack("<IQ", item_t, len(v))
        return out + b"".join(_pack_value(x, item_t) for x in v)
    return struct.pack(_SCALAR_PACK[vtype], v)


class GGUFWriter:
    """Accumulates metadata and tensor entries, then streams a GGUF v3 file."""

    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, RawBytes]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, vtype or _infer_vtype(value)))

    def add_tensor(self, name: str, shape: tuple[int, ...], ggml_type: GGMLType,
                   raw: RawBytes) -> None:
        """``shape`` is numpy row-major order (stored reversed on disk, ggml
        ne[] order); ``raw`` is the encoded bytes or a callable making them."""
        self._tensors.append((name, tuple(int(d) for d in shape),
                              GGMLType(ggml_type), raw))

    def add_float(self, name: str, array: np.ndarray) -> None:
        """An F32 tensor from float values."""
        a = np.ascontiguousarray(array, "<f4")
        self.add_tensor(name, a.shape, GGMLType.F32, a.reshape(-1).view(np.uint8))

    def n_bytes(self, name: str) -> int:
        """The encoded size of tensor ``name``, from its shape and type."""
        _, shape, ggml_type, _ = next(t for t in self._tensors if t[0] == name)
        return row_size(ggml_type, int(np.prod(shape)))

    def add_values(self, name: str, values: np.ndarray, ggml_type: GGMLType,
                   device=None) -> None:
        """A tensor of float ``values`` encoded as ``ggml_type`` by
        ``quant.numpy_codecs.quantize`` (on ``device``) when the file is
        written: the reference writer's ``add_tensor(name, array,
        ggml_type)``."""
        from tpu_kquant_torch.quant.numpy_codecs import quantize

        self.add_tensor(name, values.shape, ggml_type,
                        lambda: quantize(values, ggml_type, device))

    def write(self) -> Path:
        head = bytearray(struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION,
                                     len(self._tensors), len(self._kv)))
        for key, value, vtype in self._kv:
            head += _pack_string(key) + struct.pack("<I", vtype)
            head += _pack_value(value, vtype)
        offsets = []
        offset = 0
        for name, shape, ggml_type, _ in self._tensors:
            n_bytes = row_size(ggml_type, int(np.prod(shape)))
            head += _pack_string(name) + struct.pack("<I", len(shape))
            for d in reversed(shape):
                head += struct.pack("<Q", d)
            head += struct.pack("<IQ", ggml_type, offset)
            offsets.append((offset, n_bytes))
            offset += n_bytes + (-n_bytes % self.alignment)
        head += b"\x00" * (-len(head) % self.alignment)
        with open(self.path, "wb") as f:
            f.write(head)
            pos = 0
            for (off, n_bytes), (name, _, _, raw) in zip(offsets, self._tensors):
                data = raw() if callable(raw) else raw
                data = np.ascontiguousarray(data, np.uint8).reshape(-1)
                if data.size != n_bytes:
                    raise ValueError(f"{name}: {data.size} bytes, expected {n_bytes}")
                f.write(b"\x00" * (off - pos))
                f.write(data.tobytes())
                pos = off + n_bytes
            f.write(b"\x00" * (offset - pos))
        return self.path
