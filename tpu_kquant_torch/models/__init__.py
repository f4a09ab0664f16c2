"""Model configuration, fixtures and the llama forward."""
