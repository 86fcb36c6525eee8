"""Runnable examples of the port (``python -m rust_pathtracer_tpu_torch.examples.<name>``)."""
