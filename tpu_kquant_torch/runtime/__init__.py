"""Loader, KV cache and inference engine."""
