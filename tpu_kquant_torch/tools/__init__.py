"""Command-line tools of the port (run as ``python -m tpu_kquant_torch.tools.<name>``)."""
