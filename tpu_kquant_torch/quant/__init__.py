"""Quantization layer: QTensor container (qtensor), host repack (repack),
torch dequant (codecs)."""
