"""GGUF container I/O: mmap reader (zero-copy views) and streaming v3 writer."""

from tpu_kquant_torch.gguf.constants import (  # noqa: F401
    GGMLType,
    GGUFValueType,
    QK_K,
    block_size,
    is_quantized,
    row_size,
    type_size,
)
from tpu_kquant_torch.gguf.reader import GGUFReader, TensorInfo  # noqa: F401
from tpu_kquant_torch.gguf.writer import GGUFWriter  # noqa: F401
