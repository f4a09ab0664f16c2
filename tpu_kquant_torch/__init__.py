"""tpu_kquant_torch: the PyTorch/CUDA port of tpu_kquant.

Quantized GGUF (K-quant) llama inference on an NVIDIA Hopper card: packed
weights stay packed on the device and hand-written CUDA kernels dequantize
them inside the matmuls. The JAX package ``tpu_kquant`` is the reference this
port is tested against; nothing here imports it.
"""
