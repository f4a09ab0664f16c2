"""Tokenizer layer: SPM + byte-level BPE built from GGUF metadata."""

from tpu_kquant_torch.tokenizer.tokenizer import Tokenizer, from_gguf_metadata  # noqa: F401
