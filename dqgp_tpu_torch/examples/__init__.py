"""Runnable examples of the port (``python -m dqgp_tpu_torch.examples.<name>``)."""
