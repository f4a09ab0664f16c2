"""Serving layer: continuous batching over the inference engine."""

from tpu_kquant_torch.serving.scheduler import ContinuousBatcher, Request  # noqa: F401
