"""Measurement scripts of the port (``python -m fedmlp_tpu_torch.tools.<name>``)."""
